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
from asr_study_torch.features.fbank import KernelFeaturizer, fbank
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
    """On the CPU the wrapper runs the plain version and counts no launch."""
    feat = DeviceFeaturizer(kind="mfcc", device="cpu")
    wavs, lengths = _rand_wavs(batch=2, n=4000)
    pre, t_out, _ = feat._prep(torch.from_numpy(wavs),
                               torch.from_numpy(lengths))
    before = fbank.launches
    got = fbank(feat.chain, pre, t_out)
    assert fbank.launches == before
    want = tdev.spectral_plain(feat.chain, pre, t_out)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


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
