"""The port's SpecAugment and WavAugment (``features/augment.py``) against
the JAX package's on the CPU.

JAX's RNG is not reproduced: each case draws with ``jax.random`` exactly
as the JAX transform does (the same key splits and shapes) and feeds those
draws to the port's pure ``apply``.  Masks are held exactly, gain and
noise to 1e-6.  Padding stays out of the masks and padding samples stay
exactly 0; the parsers and their validation errors are the JAX ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_study_torch.features import augment as paug
from asr_study_tpu.features import augment as jaug

LENGTHS = [50, 33, 1, 0, 64]


def _feats(seed, b=5, t=64, f=13):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, f).astype(np.float32) + 3.0   # no exact zeros
    lens = np.array(LENGTHS[:b], np.int32)
    return x, lens


def _t(a):
    return torch.from_numpy(np.array(a))


SPEC_CASES = [
    {},
    {"freq_masks": 3, "freq_width": 20, "time_masks": 0},
    {"freq_masks": 0, "time_masks": 4, "time_ratio": 1.0},
    {"freq_masks": 1, "freq_width": 0, "time_masks": 2, "time_ratio": 0.3},
]


@pytest.mark.parametrize("kw", SPEC_CASES)
@pytest.mark.parametrize("seed", [0, 7])
def test_spec_augment_from_jax_draws(kw, seed):
    x, lens = _feats(seed)
    rng = jax.random.PRNGKey(seed)
    want = np.asarray(jaug.SpecAugment(**kw)(rng, jnp.asarray(x),
                                             jnp.asarray(lens)))
    port = paug.SpecAugment(**kw)
    b = x.shape[0]
    k_f, k_t = jax.random.split(rng)
    u_f = (_t(jax.random.uniform(k_f, (b, port.freq_masks, 2)))
           if port.freq_masks and port.freq_width else None)
    u_t = (_t(jax.random.uniform(k_t, (b, port.time_masks, 2)))
           if port.time_masks and port.time_ratio > 0 else None)
    got = port.apply(_t(x), _t(lens), u_f, u_t).numpy()
    np.testing.assert_array_equal(got, want)
    if u_f is not None or u_t is not None:
        assert (got == 0).any()


WAV_CASES = [
    {"gain_db": 6.0},
    {"noise_snr_min": 5.0, "noise_snr_max": 20.0},
    {"gain_db": 3.0, "noise_snr_min": 20.0, "noise_snr_max": 50.0},
]


def _wavs(seed, b=4, n=3000):
    rng = np.random.RandomState(seed)
    lens = np.array([n, 2047, 1, 0][:b], np.int32)
    w = (0.2 * rng.randn(b, n)).astype(np.float32)
    w[np.arange(n)[None, :] >= lens[:, None]] = 0.0
    return w, lens


@pytest.mark.parametrize("kw", WAV_CASES)
def test_wav_augment_from_jax_draws(kw):
    w, lens = _wavs(1)
    rng = jax.random.PRNGKey(3)
    ja = jaug.WavAugment(**kw)
    want = np.asarray(ja(rng, jnp.asarray(w), jnp.asarray(lens)))
    b, n = w.shape
    k_g, k_s, k_n = jax.random.split(rng, 3)
    db = snr = noise = None
    if ja.gain_db > 0:
        db = _t(jax.random.uniform(k_g, (b, 1), minval=-ja.gain_db,
                                   maxval=ja.gain_db))
    if ja.noise_snr_max > 0:
        snr = _t(jax.random.uniform(k_s, (b, 1), minval=ja.noise_snr_min,
                                    maxval=ja.noise_snr_max))
        noise = _t(jax.random.normal(k_n, (b, n)))
    got = paug.WavAugment(**kw).apply(_t(w), _t(lens), db, snr, noise)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    pad = np.arange(n)[None, :] >= lens[:, None]
    assert (got.numpy()[pad] == 0).all()
    assert not np.array_equal(got.numpy(), w)


def test_padding_invariance():
    """More padding changes nothing in the real frames or samples: the
    same draws give the same output on them, the padding stays 0."""
    gen = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    x, lens = _feats(2)
    x[np.arange(64)[None, :] >= lens[:, None]] = 0.0
    spec = paug.SpecAugment(freq_masks=2, time_masks=3, time_ratio=0.5)
    short = spec(_t(x), _t(lens), gen()).numpy()
    longer = spec(_t(np.pad(x, ((0, 0), (0, 40), (0, 0)))), _t(lens),
                  gen()).numpy()
    np.testing.assert_array_equal(longer[:, :64], short)
    assert (longer[:, 64:] == 0).all()
    w, wl = _wavs(4)
    wav = paug.WavAugment(gain_db=6, noise_snr_min=0, noise_snr_max=10)
    a = wav(_t(w), _t(wl), gen())
    db, snr, noise = wav.draws(4, 3000, gen(), torch.device("cpu"))
    b = wav.apply(_t(np.pad(w, ((0, 0), (0, 500)))), _t(wl), db, snr,
                  torch.nn.functional.pad(noise, (0, 500), value=9.0))
    np.testing.assert_array_equal(b.numpy()[:, :3000], a.numpy())
    assert (b.numpy()[:, 3000:] == 0).all()
    assert (a.numpy()[np.arange(3000)[None, :] >= wl[:, None]] == 0).all()


def test_draws_repeat_under_one_seed():
    spec = paug.SpecAugment()
    wav = paug.WavAugment(gain_db=3, noise_snr_min=1, noise_snr_max=2)
    x, lens = _feats(5)
    w, wl = _wavs(5)
    outs = [(spec(_t(x), _t(lens), torch.Generator().manual_seed(s)),
             wav(_t(w), _t(wl), torch.Generator().manual_seed(s)))
            for s in (1, 1, 2)]
    for i in range(2):
        torch.testing.assert_close(outs[0][i], outs[1][i], rtol=0, atol=0)
        assert not torch.equal(outs[0][i], outs[2][i])


@pytest.mark.parametrize("spec", [
    "", "freq_masks=1", "time_ratio=0.2,time_masks=5", "freq_width=0"])
def test_parse_spec_augment_matches_jax(spec):
    assert repr(paug.parse_spec_augment(spec)) == \
        repr(jaug.parse_spec_augment(spec))


@pytest.mark.parametrize("spec", [
    "", "gain_db=6", "noise_snr_max=0", "noise_snr_min=1,noise_snr_max=4",
    "gain_db=0,noise_snr_max=30"])
def test_parse_wav_augment_matches_jax(spec):
    assert repr(paug.parse_wav_augment(spec)) == \
        repr(jaug.parse_wav_augment(spec))


@pytest.mark.parametrize("which,spec", [
    ("spec", "freq_masks"), ("spec", "nosuch=1"), ("spec", "freq_masks=-1"),
    ("spec", "freq_width=-2"), ("spec", "time_ratio=1.5"),
    ("wav", "gain_db=-1"), ("wav", "noise_snr_min=5"),
    ("wav", "noise_snr_min=9,noise_snr_max=4"), ("wav", "bad"),
])
def test_validation_matches_jax(which, spec):
    fn = "parse_spec_augment" if which == "spec" else "parse_wav_augment"
    with pytest.raises(ValueError) as want:
        getattr(jaug, fn)(spec)
    with pytest.raises(ValueError) as got:
        getattr(paug, fn)(spec)
    assert str(got.value) == str(want.value)
