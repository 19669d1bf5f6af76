"""The port's native host library (``asr_study_torch/native/asr_native.cc``
through ``utils/native.py``) against its plain twins in the port and the
JAX package's NumPy and Python paths (``use_native=False``, or the JAX
native loader patched to report no library: the JAX library itself is
never loaded here).  The dpack encode byte for byte; the wav reader
exactly on mono PCM16 and within 1e-6 on PCM32, float32 and stereo (the
C++ downmix sums in another order than NumPy's mean); the batch packer
and Levenshtein exactly; six processes building into one fresh root at
once."""

import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from asr_study_torch._build import BUILD_ROOT
from asr_study_torch.data import wire
from asr_study_torch.features import wav
from asr_study_torch.ops import metrics
from asr_study_torch.utils import native
from asr_study_tpu.data import wire as jwire
from asr_study_tpu.features import wav as jwav
from asr_study_tpu.ops import metrics as jmetrics
from asr_study_tpu.utils import native as jnative

ROOT = Path(__file__).resolve().parent.parent
WAV_ATOL = 1e-6


def _int16_wavs(seed, lengths):
    rng = np.random.RandomState(seed)
    return [np.clip(np.round(rng.randn(n) * 3000), -32768,
                    32767).astype(np.int16) for n in lengths]


def _dpack_cases():
    rng = np.random.RandomState(3)
    full = np.tile(np.array([32767, -32768], np.int16), 4100)
    return {
        "empty": [np.zeros(0, np.float32)],
        "no utterances": [],
        "one sample": [np.array([0.25], np.float32)],
        "4095": _int16_wavs(0, (4095,)),
        "4096": _int16_wavs(1, (4096,)),
        "4097": _int16_wavs(2, (4097,)),
        "all-zero blocks": [np.zeros(3 * 4096 + 5, np.int16),
                            _int16_wavs(4, (100,))[0]],
        "full-range wraparound": [full, full[::-1].copy()],
        "several utterances": [
            (0.3 * rng.randn(n)).astype(np.float32)
            for n in (16000, 7, 4096, 33333, 1)],
    }


@pytest.mark.parametrize("case", list(_dpack_cases()))
def test_dpack_encode_byte_equal(case):
    wavs = _dpack_cases()[case]
    got = wire.dpack_encode(wavs)
    plain = wire.dpack_encode(wavs, use_native=False)
    want = jwire.dpack_encode(wavs, use_native=False)
    for other in (plain, want):
        assert got[0] == other[0] and got[3] == other[3]
        for g, w in zip(got[1:3], other[1:3]):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()


def _write_wav(path, data: bytes, tag: int, channels: int, sr: int,
               bits: int, data_size: int | None = None) -> str:
    """A RIFF/WAVE file of one fmt chunk (format ``tag``) and one data
    chunk; ``data_size`` overrides the data chunk's declared size."""
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", tag, channels, sr, sr * block, block, bits)
    size = len(data) if data_size is None else data_size
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", size) + data)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return str(path)


def _signal(seed, n, channels=1):
    rng = np.random.RandomState(seed)
    return np.clip(0.4 * rng.randn(n, channels), -1.0, 0.999)


def _pcm16(x):
    return (x * 32767).astype("<i2").tobytes()


def _jax_plain_read(monkeypatch, path, sr=None):
    """The JAX package's Python reader (its native one reported absent)."""
    monkeypatch.setattr(jnative, "read_wav", lambda *a, **k: None)
    return jwav.read_wav(path, sr=sr)


def test_read_wav_pcm16_mono_exact(tmp_path, monkeypatch):
    path = _write_wav(tmp_path / "m16.wav", _pcm16(_signal(0, 23001)), 1, 1,
                      16000, 16)
    got, sr = wav.read_wav(path, sr=None)
    for want, wsr in (wav.read_wav_plain(path, sr=None),
                      _jax_plain_read(monkeypatch, path)):
        assert sr == wsr == 16000 and got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    # resampled to 16 kHz from 8 kHz: the same samples into the resampler
    path8 = _write_wav(tmp_path / "m8k.wav", _pcm16(_signal(1, 8000)), 1, 1,
                       8000, 16)
    got, sr = wav.read_wav(path8)
    want, wsr = wav.read_wav_plain(path8)
    assert sr == wsr == 16000
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["pcm32", "float32", "stereo16",
                                  "stereo32", "float32x3"])
def test_read_wav_other_encodings(tmp_path, monkeypatch, kind):
    channels = {"stereo16": 2, "stereo32": 2, "float32x3": 3}.get(kind, 1)
    x = _signal(sum(map(ord, kind)), 9001, channels)
    if kind.startswith("float32"):
        data, tag, bits = x.astype("<f4").tobytes(), 3, 32
    elif kind in ("pcm32", "stereo32"):
        data, tag, bits = (x * 2**31).astype("<i4").tobytes(), 1, 32
    else:
        data, tag, bits = _pcm16(x), 1, 16
    path = _write_wav(tmp_path / f"{kind}.wav", data, tag, channels, 22050,
                      bits)
    got, sr = wav.read_wav(path, sr=None)
    for want, wsr in (wav.read_wav_plain(path, sr=None),
                      _jax_plain_read(monkeypatch, path)):
        assert sr == wsr == 22050 and got.shape == want.shape == (9001,)
        np.testing.assert_allclose(got, want, rtol=0, atol=WAV_ATOL)


def _riff(path, chunks) -> str:
    body = b"WAVE" + b"".join(
        cid + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)
        for cid, data in chunks)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return str(path)


@pytest.mark.parametrize("kind", ["pcm8", "pcm8x2", "pcm24", "pcm24x2",
                                  "float64", "truncated", "data_first",
                                  "extensible", "odd_chunk", "no_channels"])
def test_read_wav_every_encoding_of_the_plain_parser(tmp_path, kind):
    """8- and 24-bit PCM, float64, a data chunk declared past the file's
    end, the data chunk before the fmt chunk, the extensible format tag,
    an odd-sized chunk's pad byte and a channel count of 0 (read as mono):
    the native reader decodes each as the plain parser does, exactly in
    mono, within WAV_ATOL in stereo."""
    channels = 2 if kind.endswith("x2") else 1
    x = _signal(7, 3001, channels)
    tag, bits = 1, 16
    data = _pcm16(x)
    if kind.startswith("pcm8"):
        data, bits = (x * 127 + 128).astype(np.uint8).tobytes(), 8
    elif kind.startswith("pcm24"):
        v = (x.reshape(-1) * 2**23).astype("<i4").view(np.uint8)
        data, bits = v.reshape(-1, 4)[:, :3].tobytes(), 24
    elif kind == "float64":
        data, tag, bits = x.astype("<f8").tobytes(), 3, 64
    fmt_ch = 0 if kind == "no_channels" else channels
    block = max(fmt_ch, 1) * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if kind == "extensible" else tag,
                      fmt_ch, 16000, 16000 * block, block, bits)
    if kind == "extensible":
        fmt += struct.pack("<HHIH", 22, bits, 0, tag) + bytes(14)
    chunks = [(b"fmt ", fmt), (b"data", data)]
    if kind == "data_first":
        chunks = chunks[::-1]
    if kind == "odd_chunk":
        chunks.insert(0, (b"LIST", b"abc"))
    path = _riff(tmp_path / f"{kind}.wav", chunks)
    if kind == "truncated":
        path = _write_wav(tmp_path / f"{kind}.wav", data, tag, 1, 16000,
                          bits, data_size=len(data) * 8)
    got, sr = wav.read_wav(path)
    want, wsr = wav.read_wav_plain(path)
    assert sr == wsr == 16000 and got.shape == want.shape == (3001,)
    if channels == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=WAV_ATOL)


@pytest.mark.parametrize("kind", ["pcm24", "float64x3", "big_list"])
def test_read_wav_past_one_block(tmp_path, kind):
    """Files longer than the reader's 120 KiB block: 24-bit frames that
    straddle a block's end, 3-channel float64, and a data chunk behind a
    200 KB chunk of another kind."""
    channels = 3 if kind.endswith("x3") else 1
    x = _signal(9, 70001, channels)
    fmt_tag, bits, data = 1, 16, _pcm16(x)
    if kind == "pcm24":
        v = (x.reshape(-1) * 2**23).astype("<i4").view(np.uint8)
        bits, data = 24, v.reshape(-1, 4)[:, :3].tobytes()
    elif kind == "float64x3":
        fmt_tag, bits, data = 3, 64, x.astype("<f8").tobytes()
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", fmt_tag, channels, 16000, 16000 * block,
                      block, bits)
    chunks = [(b"fmt ", fmt), (b"data", data)]
    if kind == "big_list":
        chunks.insert(1, (b"LIST", bytes(200_001)))
    path = _riff(tmp_path / f"{kind}.wav", chunks)
    got, sr = wav.read_wav(path)
    want, wsr = wav.read_wav_plain(path)
    assert sr == wsr == 16000 and got.shape == want.shape == (70001,)
    if channels == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=WAV_ATOL)


def test_read_wav_errors_as_the_plain_parser(tmp_path):
    with pytest.raises(FileNotFoundError):
        wav.read_wav(str(tmp_path / "missing.wav"))
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFX" + bytes(40))
    fmt = struct.pack("<HHIIHH", 1, 1, 16000, 32000, 2, 16)
    cases = {
        str(bad): "not a RIFF/WAVE file",
        _riff(tmp_path / "nodata.wav", [(b"fmt ", fmt)]):
            "missing fmt/data chunk",
        _riff(tmp_path / "nofmt.wav", [(b"data", bytes(8))]):
            "missing fmt/data chunk",
        _riff(tmp_path / "adpcm.wav", [(b"fmt ", struct.pack(
            "<HHIIHH", 2, 1, 16000, 8000, 256, 4)), (b"data", bytes(8))]):
            "unsupported WAV format tag 2",
        _riff(tmp_path / "pcm12.wav", [(b"fmt ", struct.pack(
            "<HHIIHH", 1, 1, 16000, 32000, 2, 12)), (b"data", bytes(8))]):
            "unsupported PCM bit depth: 12",
    }
    for path, msg in cases.items():
        for read in (wav.read_wav, wav.read_wav_plain):
            with pytest.raises(ValueError, match=msg):
                read(path)


def test_read_wav_longer_than_600_s_at_48k(tmp_path):
    """Past the JAX wrapper's 600 s x 48 kHz buffer (and the reader's
    scratch): the port reads again into a buffer of the size the reader
    reports, and reads the whole recording natively; a data chunk declared
    at 4 GB reads the samples the file holds."""
    n = 601 * 48000 + 17
    rng = np.random.RandomState(5)
    pcm = rng.randint(-32768, 32768, n).astype("<i2")
    want = pcm.astype(np.float32) / 32768.0
    for name, size in (("long.wav", None), ("streamed.wav", 0xFFFFFFFE)):
        path = _write_wav(tmp_path / name, pcm.tobytes(), 1, 1, 48000, 16,
                          data_size=size)
        sig, sr = native.read_wav(path)
        assert sr == 48000 and sig.shape == (n,)
        np.testing.assert_array_equal(sig, want)
        np.testing.assert_array_equal(wav.read_wav(path, sr=None)[0],
                                      wav.read_wav_plain(path, sr=None)[0])


def _numpy_pack(rows, out_shape):
    out = np.zeros(out_shape, np.float32)
    for j, r in enumerate(rows):
        t = min(r.shape[0], out_shape[1])
        out[j, :t] = r[:t]
    return out


@pytest.mark.parametrize("lens,out_rows,t_pad", [
    ((5, 9, 1), 3, 9), ((5, 12, 0, 3), 6, 8), ((1,), 4, 1), ((), 2, 5)])
def test_pack_batch_full_against_numpy(lens, out_rows, t_pad):
    rng = np.random.RandomState(sum(lens) + out_rows)
    rows = [rng.randn(n, 3).astype(np.float32) for n in lens]
    src = (np.concatenate(rows) if rows else np.zeros((0, 3), np.float32))
    lens_a = np.array(lens, np.int64)
    out = np.full((out_rows, t_pad, 3), np.nan, np.float32)
    native.pack_batch_into(src, np.cumsum(lens_a) - lens_a, lens_a, out)
    np.testing.assert_array_equal(out, _numpy_pack(rows, out.shape))
    with pytest.raises(ValueError, match="C-contiguous float32"):
        native.pack_batch_into(src, lens_a, lens_a,
                               np.zeros((out_rows, t_pad, 3)))


def test_levenshtein_against_the_python_dp(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    rng = np.random.RandomState(11)
    for _ in range(60):
        a = rng.randint(0, 6, rng.randint(0, 25)).tolist()
        b = rng.randint(0, 6, rng.randint(0, 25)).tolist()
        d = metrics.levenshtein(a, b)
        assert d == metrics._levenshtein_py(a, b)
        assert d == jmetrics._levenshtein_py(a, b)
        assert d == native.levenshtein(a, b)
    words = ["o", "gato", "subiu", "no", "telhado"]
    assert metrics.levenshtein(words, words[::-1]) == \
        metrics._levenshtein_py(words, words[::-1]) == 4
    hyps, refs = ["o gato subiu", "ab c", ""], ["o gato subiu no", "abc", "x"]
    assert metrics.wer(hyps, refs) == jmetrics.wer(hyps, refs)
    assert metrics.cer(hyps, refs) == jmetrics.cer(hyps, refs)


_RACE = r"""
import sys
from pathlib import Path
import numpy as np
from asr_study_torch.utils import native
path = native.build(Path(sys.argv[1]))
dll = native.load(path)
a = np.arange(50, dtype=np.int32) % 7
b = a[::-1].copy()
d = dll.asr_levenshtein(a.ctypes.data, 50, b.ctypes.data, 50)
print(path, d)
"""


def test_six_processes_build_one_library_race_free(tmp_path):
    root = tmp_path / "fresh_build_root"
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, str(root)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    lines = {o.strip() for o, _ in outs}
    assert len(lines) == 1, lines
    lib_path = Path(lines.pop().split()[0])
    assert lib_path == native.build_dir(root) / native.LIB_NAME
    # the private build directories are gone; one library is left
    assert sorted(p.name for p in lib_path.parent.iterdir()) == \
        [native.LIB_NAME]


def test_library_is_the_ports_own_under_build_native():
    path = Path(native.lib()._name)
    assert path == native.build() == native.build_dir() / native.LIB_NAME
    assert path.parent.parent == BUILD_ROOT
    assert path.parent.name.startswith("native-")
    assert path.parent.name == f"native-{native.source_hash()}"
    assert path.resolve() != (ROOT / "native" / "libasrnative.so").resolve()
