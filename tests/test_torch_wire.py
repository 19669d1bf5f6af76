"""Port's wires (asr_study_torch/data/wire.py) against the JAX module: the
host packers of pcm16, mulaw and dpack byte for byte, the device
unpackers value for value (mulaw within 1e-6), the guards, the codec
choice, and the parity oracle's features through the pcm16 and dpack
wires."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_study_torch.data import wire
from asr_study_torch.features import audio
from asr_study_torch.features.select import featurizer
from asr_study_tpu.data import wire as jwire


def _wavs(seed, lengths, as_int16=False):
    rng = np.random.RandomState(seed)
    out = []
    for n in lengths:
        w = np.clip(0.4 * rng.randn(n), -1.2, 1.2).astype(np.float32)
        out.append(jwire.quantize_pcm16(w) if as_int16 else w)
    return out


@pytest.mark.parametrize("lengths,batch,as_int16", [
    ((5000, 3100, 4321), None, False),
    ((5000, 3100, 4321), 5, False),        # header padded to 5 rows
    ((7, 1, 40000), None, True),
    ((33000,), 2, True),                   # length above 2^15: both halves
    ((0, 17), None, False),
])
def test_pack_audio_byte_equal(lengths, batch, as_int16):
    wavs = _wavs(0, lengths, as_int16)
    b = batch or len(wavs)
    cap = jwire.wire_cap(b, sum(lengths), align=256)
    assert wire.wire_cap(b, sum(lengths), align=256) == cap
    want = jwire.pack_audio(wavs, cap, batch=batch)
    got = wire.pack_audio(wavs, cap, batch=batch)
    assert got.dtype == want.dtype == np.int16
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("lengths,n_pad", [
    ((5000, 3100, 4321), 6144),
    ((5000, 3100, 4321), 4096),            # rows longer than n_pad clip
    ((33000, 12), 34816),
])
def test_unpack_audio_matches_jax(lengths, n_pad):
    wavs = _wavs(1, lengths)
    b = len(wavs)
    cap = jwire.wire_cap(b, sum(lengths), align=256)
    flat = jwire.pack_audio(wavs, cap)
    w_j, l_j = jwire.unpack_audio(jnp.asarray(flat), b, n_pad)
    w_p, l_p = wire.unpack_audio(torch.from_numpy(flat), b, n_pad)
    assert w_p.dtype == torch.float32 and w_p.shape == (b, n_pad)
    np.testing.assert_array_equal(l_p.numpy(), np.asarray(l_j))
    np.testing.assert_array_equal(w_p.numpy(), np.asarray(w_j))


def test_unknown_codec_raises():
    with pytest.raises(ValueError, match="unknown wire codec"):
        wire.pack_audio([np.zeros(4, np.float32)], 256, codec="flac")
    with pytest.raises(ValueError, match="unknown wire codec"):
        wire.unpack_audio(torch.zeros(256, dtype=torch.int16), 1, 16,
                          codec="flac")
    with pytest.raises(ValueError, match="unknown wire codec"):
        wire.wire_cap(1, 16, codec="flac")


def test_pack_overflow_raises():
    with pytest.raises(ValueError, match="overflow"):
        wire.pack_audio([np.zeros(300, np.float32)], 256)


# (lengths, batch, as_int16): float and int16, empty utterances, lengths
# around the 4096-sample dpack block, a partial batch (header padded) and
# lengths above 2^15
CASES = [
    ((5000, 3100, 4321), None, False),
    ((4095, 4096, 4097), None, True),
    ((0, 17, 0), None, False),
    ((4097, 1), 5, False),
    ((33000, 12), 3, True),
    ((), 2, False),
]


@pytest.mark.parametrize("lengths,batch,as_int16", CASES)
def test_mulaw_pack_byte_equal(lengths, batch, as_int16):
    wavs = _wavs(2, lengths, as_int16)
    b = batch or len(wavs)
    cap = jwire.wire_cap(b, sum(lengths), align=256, codec="mulaw")
    assert wire.wire_cap(b, sum(lengths), align=256, codec="mulaw") == cap
    want = jwire.pack_audio(wavs, cap, batch=batch, codec="mulaw")
    got = wire.pack_audio(wavs, cap, batch=batch, codec="mulaw")
    assert got.dtype == want.dtype == np.int16
    assert got.tobytes() == want.tobytes()


def test_mulaw_encode_equal():
    x = np.concatenate([np.linspace(-1.3, 1.3, 4001),
                        _wavs(3, (3000,))[0]])
    got, want = wire.mulaw_encode(x), jwire.mulaw_encode(x)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    q = np.linspace(-1.2, 1.2, 999).astype(np.float32)
    np.testing.assert_array_equal(wire.quantize_pcm16(q),
                                  jwire.quantize_pcm16(q))


@pytest.mark.parametrize("lengths,batch,as_int16", CASES)
def test_dpack_encode_and_pack_byte_equal(lengths, batch, as_int16):
    wavs = _wavs(4, lengths, as_int16)
    got = wire.dpack_encode(wavs)
    for use_native in (False, True):
        want = jwire.dpack_encode(wavs, use_native=use_native)
        assert got[0] == want[0] and got[3] == want[3]
        for g, w in zip(got[1:3], want[1:3]):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    b = batch or len(wavs)
    cap, scap = jwire.dpack_measure([wavs], b, align=256)
    assert wire.dpack_measure([wavs], b, align=256) == (cap, scap)
    want = jwire.pack_audio(wavs, cap, batch=batch, codec="dpack",
                            scap=scap)
    assert wire.pack_audio(wavs, cap, batch=batch, codec="dpack",
                           scap=scap).tobytes() == want.tobytes()
    assert wire.dpack_pack(wavs, cap, scap, batch=batch,
                           enc=got).tobytes() == want.tobytes()


def test_dpack_measure_over_groups_equal():
    groups = [_wavs(5, (9000, 300)), _wavs(6, (100,)), _wavs(7, (4096,) * 3)]
    assert wire.dpack_measure(groups, 3) == jwire.dpack_measure(groups, 3)


@pytest.mark.parametrize("lengths,n_pad", [
    ((5000, 3101, 4321), 6144),
    ((5001, 3100, 4321), 4096),            # rows longer than n_pad clip
    ((33001, 12, 0), 34816),
])
def test_unpack_mulaw_matches_jax(lengths, n_pad):
    wavs = _wavs(8, lengths)
    b = len(wavs)
    cap = jwire.wire_cap(b, sum(lengths), align=256, codec="mulaw")
    flat = jwire.pack_audio(wavs, cap, codec="mulaw")
    w_j, l_j = jwire.unpack_audio(jnp.asarray(flat), b, n_pad,
                                  codec="mulaw")
    w_p, l_p = wire.unpack_audio(torch.from_numpy(flat), b, n_pad,
                                 codec="mulaw")
    assert w_p.dtype == torch.float32 and w_p.shape == (b, n_pad)
    np.testing.assert_array_equal(l_p.numpy(), np.asarray(l_j))
    # expm1 may differ by an ulp between the two libraries
    np.testing.assert_allclose(w_p.numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-6)
    for i, n in enumerate(lengths):
        assert not w_p[i, n:].any()


def test_guards_raise_as_jax():
    wavs = _wavs(9, (5000, 300))
    cap, scap = jwire.dpack_measure([wavs], 2)
    for mod in (wire, jwire):
        with pytest.raises(ValueError, match="multiple of 4096"):
            mod.dpack_pack(wavs, cap, scap + 100)
        with pytest.raises(ValueError, match="dpack overflow"):
            mod.dpack_pack(wavs, cap, 4096)
        with pytest.raises(ValueError, match="wire overflow"):
            mod.dpack_pack(wavs, 64, scap)
        with pytest.raises(ValueError, match="needs scap"):
            mod.pack_audio(wavs, cap, codec="dpack")
        with pytest.raises(ValueError, match="wire overflow"):
            mod.pack_audio(wavs, 256, codec="mulaw")
        for codec in ("pcm16", "mulaw", "dpack"):
            with pytest.raises(ValueError, match="wavs > batch"):
                mod.pack_audio(wavs, cap, batch=1, codec=codec, scap=scap)
    flat = jwire.pack_audio(wavs, cap, codec="dpack", scap=scap)
    with pytest.raises(ValueError, match="multiple of 4096"):
        jwire.dpack_unpack(jnp.asarray(flat), 2, 5120, scap + 100)
    with pytest.raises(ValueError, match="multiple of 4096"):
        wire.unpack_audio(torch.from_numpy(flat), 2, 5120, codec="dpack",
                          scap=scap + 100)
    with pytest.raises(ValueError, match="needs scap"):
        wire.unpack_audio(torch.from_numpy(flat), 2, 5120, codec="dpack")


def test_choose_codec_policy():
    for bw in (10.0, 1e5):
        assert wire.choose_codec(bw) == jwire.choose_codec(bw)
    assert wire.choose_codec(10.0) == "dpack"
    assert wire.choose_codec(1e5) == "pcm16"
    bw = wire.probe_link("cpu", size_mb=1.0)
    assert isinstance(bw, float) and bw > 0


@pytest.fixture(scope="module")
def oracle():
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "parity", "oracle_v1.npz")
    d = np.load(path)
    names = sorted(k.split("/", 1)[1] for k in d.files
                   if k.startswith("pcm16/"))
    assert len(names) == 8
    return d, names


# BENCHMARKS.md "Parity": device features against the f64 NumPy oracle
# hold to 4e-5 absolute plus 2e-3 of the value in the log domain, except
# where the oracle's power falls below float32 eps: there every f32 path
# floors it (features/device.py) and the f64 oracle does not
ORACLE_ATOL, ORACLE_RTOL = 4e-5, 2e-3


@pytest.mark.parametrize("config,kind,kw,cls", [
    ("mfcc_ref", "mfcc", {}, audio.MFCC),
    ("logfbank_ref", "logfbank", {"d": True, "dd": True}, audio.LogFbank),
])
def test_oracle_features_through_pcm16_and_dpack(oracle, config, kind, kw,
                                                 cls):
    """parity/oracle_v1.npz's eight pcm16 waveforms through the pcm16 and
    the dpack wire and the device featurizer (the plain path): both wires
    give the same features bit for bit; they hold the stored oracle
    features on every entry the float32 floor leaves alone, and the
    oracle floored at float32 eps (as the device floors) everywhere."""
    d, names = oracle
    wavs = [d[f"pcm16/{n}"] for n in names]
    b = len(wavs)
    n_pad = -(-max(len(w) for w in wavs) // 2048) * 2048
    pcm = wire.pack_audio(wavs, wire.wire_cap(b, sum(map(len, wavs))))
    cap, scap = wire.dpack_measure([wavs], b)
    dp = wire.pack_audio(wavs, cap, codec="dpack", scap=scap)
    w_p, l_p = wire.unpack_audio(torch.from_numpy(pcm), b, n_pad)
    w_d, l_d = wire.unpack_audio(torch.from_numpy(dp), b, n_pad,
                                 codec="dpack", scap=scap)
    assert torch.equal(w_p, w_d) and torch.equal(l_p, l_d)
    feat = featurizer(kind, "cpu", **kw)
    f_p, fl_p = feat(w_p, l_p)
    f_d, fl_d = feat(w_d, l_d)
    assert torch.equal(f_p, f_d) and torch.equal(fl_p, fl_d)
    eps32 = float(np.finfo(np.float32).eps)
    held = 0
    for i, n in enumerate(names):
        want = d[f"feat/{config}/{n}"]
        got = f_p[i, : int(fl_p[i])].numpy()
        assert got.shape == want.shape
        x = wavs[i].astype(np.float64) / 32768.0
        floored = cls(log_floor=eps32, **kw)(x)
        np.testing.assert_allclose(got, floored, rtol=ORACLE_RTOL,
                                   atol=ORACLE_ATOL)
        free = floored == cls(**kw)(x)      # the floor changed nothing
        np.testing.assert_allclose(got[free], want[free], rtol=ORACLE_RTOL,
                                   atol=ORACLE_ATOL)
        held += int(free.sum())
    assert held > 0
