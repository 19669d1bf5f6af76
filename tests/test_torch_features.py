"""Port's featurizer (asr_study_torch/features) against the JAX featurizers
on the CPU: the plain chain against the Pallas kernel in interpret mode and
against the XLA path, plus its plain helpers one by one.  On the CPU the
kernel wrapper ``fbank`` takes its plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_study_torch.features import device as tdev
from asr_study_torch.features.device import DeviceFeaturizer
from asr_study_torch.features.fbank import (FFT_SIZES, SMEM_LIMIT,
                                            KernelFeaturizer, chain_design,
                                            fbank, fbank_design, fft_smem)
from asr_study_torch.features.select import featurizer
from asr_study_tpu.features import device as jdev
from asr_study_tpu.features.device import DeviceFeaturizer as JaxFeaturizer
from asr_study_tpu.features.pallas_fbank import PallasFeaturizer
from tests.test_features_device import _rand_wavs

TOL = dict(rtol=1e-4, atol=1e-4)    # tests/test_pallas_fbank.py's contract


def _port(kind, kw, cls=DeviceFeaturizer):
    wavs, lengths = _rand_wavs(batch=2, n=7000)
    feats, fl = cls(kind=kind, device="cpu", **kw)(
        torch.from_numpy(wavs), torch.from_numpy(lengths))
    return wavs, lengths, feats.numpy(), fl.numpy()


@pytest.mark.parametrize("kw", [{}, {"convention": "librosa"}],
                         ids=["default", "librosa"])
@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_mfcc_matches_jax(ref, kw):
    wavs, lengths, got, fl = _port("mfcc", kw)
    jax_cls = (lambda **k: PallasFeaturizer(interpret=True, **k)) \
        if ref == "pallas" else JaxFeaturizer
    want, want_fl = jax_cls(kind="mfcc", **kw)(wavs, lengths)
    np.testing.assert_array_equal(fl, np.asarray(want_fl))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("kind,kw", [
    ("logfbank", {"append_energy": True, "d": True, "dd": True}),
    ("fbank", {}),
    ("mfcc", {"mean_norm": True, "var_norm": True}),
    ("mfcc", {"append_energy": False, "d": False, "dd": False}),
    ("raw", {"mean_norm": True}),
    ("mfcc", {"convention": "librosa", "pad_mode": "constant"}),
])
def test_other_kinds_match_xla(kind, kw):
    wavs, lengths, got, fl = _port(kind, kw, KernelFeaturizer)
    want, want_fl = JaxFeaturizer(kind=kind, **kw)(wavs, lengths)
    np.testing.assert_array_equal(fl, np.asarray(want_fl))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_device_num_frames_matches_jax():
    lengths = np.array([0, 1, 399, 400, 401, 560, 16000, 2**24 + 7,
                        2**30], np.int32)
    for center in (False, True):
        want = jdev.device_num_frames(jnp.asarray(lengths), 400, 160,
                                      center=center)
        got = tdev.device_num_frames(torch.from_numpy(lengths), 400, 160,
                                     center=center)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_delta_matches_jax():
    rng = np.random.RandomState(3)
    feat = rng.randn(3, 11, 5).astype(np.float32)
    lengths = np.array([11, 6, 1], np.int32)
    want = jdev._delta_device(jnp.asarray(feat), jnp.asarray(lengths))
    got = tdev._delta_device(torch.from_numpy(feat),
                             torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_center_pad_matches_jax():
    rng = np.random.RandomState(4)
    pre = rng.randn(3, 900).astype(np.float32)
    lengths = np.array([900, 450, 150], np.int32)
    pre[1, 450:] = 0.0
    pre[2, 150:] = 0.0
    want = jdev._center_pad_batch(jnp.asarray(pre), jnp.asarray(lengths),
                                  200, "reflect")
    got = tdev._center_pad_batch(torch.from_numpy(pre),
                                 torch.from_numpy(lengths), 200, "reflect")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dft_tables_match_jax():
    for a, b in zip(tdev._dft_matrices(400, 512),
                    jdev._dft_matrices(400, 512)):
        np.testing.assert_array_equal(a, b)


def test_select_picks_plain_on_cpu():
    """(The CUDA choice is checked in tests/test_torch_gpu.py.)"""
    feat = featurizer("mfcc", "cpu")
    assert type(feat) is DeviceFeaturizer
    assert feat.num_feats == 39 and feat.chain.num_out == 13


def test_fbank_wrapper_takes_plain_on_cpu():
    """On the CPU the wrapper runs the plain version and counts no launch,
    of either design."""
    feat = DeviceFeaturizer(kind="mfcc", device="cpu")
    wavs, lengths = _rand_wavs(batch=2, n=4000)
    pre, t_out, _ = feat._prep(torch.from_numpy(wavs),
                               torch.from_numpy(lengths))
    before, by_design = fbank.launches, dict(fbank.by_design)
    got = fbank(feat.chain, pre, t_out)
    assert fbank.launches == before and fbank.by_design == by_design
    want = tdev.spectral_plain(feat.chain, pre, t_out)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("nfft,frame_len,smem,want", [
    (512, 400, 0, "fft"), (256, 200, 0, "fft"), (1024, 1024, 0, "fft"),
    (400, 400, 0, "dft"), (512, 600, 0, "dft"),
    (2048, 2048, SMEM_LIMIT, "fft"), (2048, 2048, SMEM_LIMIT + 4, "dft")])
def test_fbank_design(nfft, frame_len, smem, want):
    """The size rule: the FFT design for a power-of-two nfft in
    FFT_SIZES that holds the frame and whose CTA fits in the shared memory
    a CTA may opt in to, the DFT design otherwise."""
    assert fbank_design(nfft, frame_len, smem) == want


@pytest.mark.parametrize("kw,smem,want", [
    ({}, 54256, "fft"),
    ({"nfft": 2048, "win_len": 0.128}, 183968, "fft"),
    ({"nfft": 2048, "win_len": 0.128, "win_step": 0.03}, 203168, "fft"),
    ({"nfft": 2048, "win_len": 0.128, "win_step": 0.064}, 235808, "dft")],
    ids=["serving", "nfft 2048", "hop 480", "hop 1024"])
def test_chain_design_counts_shared_memory(kw, smem, want):
    """The wrapper's design for a chain: csrc/fbank_fft.cu's Layout, in
    bytes, decides it once nfft and frame_len allow the FFT design (a
    2048-sample frame with a hop of 1024 makes a tile's span of 17,408
    samples, past the 227 KB a CTA may hold)."""
    chain = DeviceFeaturizer(kind="mfcc", device="cpu", **kw).chain
    assert fft_smem(chain) == smem
    assert chain_design(chain) == want


@pytest.mark.parametrize("nfft", FFT_SIZES)
def test_fft_twiddles_within_one_ulp(nfft):
    """The FFT design's table against float64 cos and -sin of 2 pi k /
    nfft: within one fp32 ulp of each entry."""
    got = DeviceFeaturizer(kind="mfcc", nfft=nfft, win_len=0.016,
                           device="cpu").chain.twiddle.numpy()
    ang = 2.0 * np.pi * np.arange(nfft) / nfft
    want = np.stack([np.cos(ang), -np.sin(ang)], axis=1)
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert got.shape == (nfft, 2) and got.dtype == np.float32
    assert (np.abs(got.astype(np.float64) - want) <= ulp).all()


@pytest.mark.parametrize("kw", [
    {}, {"htk": True}, {"convention": "librosa"},
    {"filterbank": "librosa", "fb_norm": "slaney", "htk": False}],
    ids=["default", "htk", "librosa", "slaney"])
def test_mel_bands_cover_the_filterbank(kw):
    """Each filter's band holds every nonzero of its column of chain.mel,
    from its first to its last; the packed weights are those bands; and
    the banded product equals the dense one exactly on random
    non-negative spectra (fp32, the sum in ascending bin order)."""
    chain = DeviceFeaturizer(kind="mfcc", device="cpu", **kw).chain
    mel = chain.mel.numpy()
    bands, packed = chain.mel_bands.numpy(), chain.mel_packed.numpy()
    assert bands.dtype == np.int32 and bands.shape == (mel.shape[1], 2)
    off = 0
    for m, (lo, hi) in enumerate(bands):
        nz = np.flatnonzero(mel[:, m])
        assert (lo, hi) == ((nz[0], nz[-1]) if nz.size else (0, -1))
        width = max(0, hi - lo + 1)
        np.testing.assert_array_equal(packed[off: off + width],
                                      mel[lo: hi + 1, m])
        off += width
    assert off == packed.size
    p = np.random.RandomState(5).rand(16, mel.shape[0]).astype(np.float32)
    dense = np.zeros((16, mel.shape[1]), np.float32)
    banded = np.zeros_like(dense)
    for k in range(mel.shape[0]):
        dense = dense + p[:, k, None] * mel[k]
        inband = (bands[:, 0] <= k) & (k <= bands[:, 1])
        banded = np.where(inband, banded + p[:, k, None] * mel[k], banded)
    np.testing.assert_array_equal(banded, dense)


def _fft_model(x, tw):
    """csrc/fbank_fft.cu's real FFT in NumPy complex64: the nfft-point real
    frame as an M = nfft/2 point complex FFT of x[2n] + i x[2n+1] in the
    kernel's Stockham passes (radix 8 while it divides and M/32 >= 8, then
    4, then 2), then the split step into M+1 bins, with the kernel's
    twiddle table tw [nfft, 2] -> (re, im) [M+1]."""
    nfft = x.shape[0]
    m = nfft // 2
    w = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    z = (x[0::2] + 1j * x[1::2]).astype(np.complex64)
    ns = 1
    while ns < m:
        r = (8 if (m // ns) % 8 == 0 and m // 32 >= 8 else
             4 if (m // ns) % 4 == 0 and m // 32 >= 4 else 2)
        j = np.arange(m // r)
        v = np.stack([z[j + q * (m // r)] for q in range(r)])
        e = np.arange(r)[:, None] * (j % ns)[None, :] * (m // (ns * r))
        v = v * w[2 * e]
        k = np.arange(r)
        v = (np.exp(-2j * np.pi * np.outer(k, k) / r).astype(np.complex64)
             @ v)
        out = np.empty_like(z)
        for q in range(r):
            out[(j // ns) * ns * r + j % ns + q * ns] = v[q]
        z, ns = out, ns * r
    k = np.arange(m + 1)
    a, b = z[k % m].real, z[k % m].imag
    c, d = z[(m - k) % m].real, z[(m - k) % m].imag
    wr, wi = tw[: m + 1, 0], tw[: m + 1, 1]
    return (np.float32(0.5) * ((a + c) + wr * (b + d) + wi * (a - c)),
            np.float32(0.5) * ((b - d) + wi * (b + d) - wr * (a - c)))


@pytest.mark.parametrize("nfft", [256, 512, 1024])
def test_fft_model_matches_rfft(nfft):
    """The FFT design's passes and split step, with its twiddles, against
    np.fft.rfft in float64 on a windowed 400-sample frame (zeros past the
    frame, as the kernel never loads them)."""
    chain = DeviceFeaturizer(kind="mfcc", nfft=nfft, win_len=min(
        0.025, nfft / 16000), device="cpu").chain
    rng = np.random.RandomState(nfft)
    x = np.zeros(nfft, np.float32)
    x[: chain.frame_len] = rng.randn(chain.frame_len) * chain.window.numpy()
    re, im = _fft_model(x, chain.twiddle.numpy())
    want = np.fft.rfft(x.astype(np.float64))
    scale = np.abs(want).max()
    np.testing.assert_allclose(re, want.real, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(im, want.imag, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("bad", ["dtype", "rank", "device"])
def test_fbank_wrapper_rejects(bad):
    feat = DeviceFeaturizer(kind="mfcc", device="cpu")
    pre = torch.zeros(2, 4000)
    if bad == "dtype":
        pre = pre.double()
    elif bad == "rank":
        pre = pre[None]
    else:
        pre = pre.to("meta")
    with pytest.raises(ValueError):
        fbank(feat.chain, pre, 24)
