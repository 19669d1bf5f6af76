"""The port's serving slice against the JAX reference on the CPU:
pcm16 wire -> features -> deep_blstm -> greedy decode, with the JAX
model's own initial weights carried over by the weight bridge.

On the CPU the JAX recurrence takes its ``lax.scan`` path; that is the
semantics contract the port is held to."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_study_torch.cli.predict import pack_batches, serve_batch
from asr_study_torch.features.select import featurizer
from asr_study_torch.models.zoo import build_model, deep_blstm
from asr_study_torch.ops.ctc import greedy_decode
from asr_study_torch.utils.weights import flat_from_params, params_from_flat
from asr_study_tpu.data import wire as jwire
from asr_study_tpu.features.device import DeviceFeaturizer as JaxFeaturizer
from asr_study_tpu.models.zoo import deep_blstm as jax_deep_blstm
from asr_study_tpu.ops.ctc import greedy_decode as jax_greedy_decode
# the exporter's own flattening: JAX tree -> tree-path keyed arrays
from extras.export_weights import _flatten as flatten_params


def _utterances(seed=0, lengths=(5000, 3100, 4321, 2600)):
    rng = np.random.RandomState(seed)
    wavs = []
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16000.0
        w = 0.4 * np.sin(2 * np.pi * 150 * (i + 1) * t) + 0.05 * rng.randn(n)
        wavs.append(w.astype(np.float32))
    return wavs


HP = "num_hiddens=16,num_layers=2"


@pytest.fixture(scope="module")
def models():
    jm = jax_deep_blstm(HP, num_classes=27)
    params = jm.init(jax.random.PRNGKey(0), 39)
    pm = deep_blstm(HP, num_classes=27)
    pm.load_state_dict(params_from_flat(flatten_params(params)))
    return jm, params, pm


@pytest.mark.parametrize("batch", [4, 3])
def test_slice_logits_and_decode_match_jax(models, batch):
    jm, params, pm = models
    wavs = _utterances()
    chunk, cap, n_pad = pack_batches(wavs, batch)
    feat = featurizer("mfcc", "cpu")
    jfeat = JaxFeaturizer(kind="mfcc")
    for off in range(0, chunk.shape[0], cap):
        flat = chunk[off: off + cap]
        w, lens = jwire.unpack_audio(jnp.asarray(flat), batch, n_pad)
        jf, jfl = jfeat(w, lens)
        want = np.array(jm.apply(params, jf, jfl, train=False))
        got = serve_batch(pm, feat, torch.from_numpy(flat), batch, n_pad)
        np.testing.assert_array_equal(got.feat_lengths.numpy(),
                                      np.asarray(jfl))
        assert got.logits.shape == want.shape == (batch, jf.shape[1], 28)
        np.testing.assert_allclose(got.logits.numpy(), want, rtol=1e-4,
                                   atol=1e-4)
        # greedy decode: exactly equal on the same (JAX) logits
        jd, jl = jax_greedy_decode(jnp.asarray(want), jfl, blank_id=27)
        pd, pl = greedy_decode(torch.from_numpy(want),
                               torch.from_numpy(np.array(jfl)),
                               blank_id=27)
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
        assert pd.dtype == torch.int32 and pl.dtype == torch.int32
        assert (got.lengths <= got.feat_lengths).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_decode_equal_with_ties(seed):
    """Integer-valued logits make ties common: both take the first index."""
    rng = np.random.RandomState(seed)
    logits = rng.randint(0, 3, size=(5, 17, 6)).astype(np.float32)
    lengths = np.array([17, 0, 9, 1, 16], np.int32)
    jd, jl = jax_greedy_decode(jnp.asarray(logits), jnp.asarray(lengths))
    pd, pl = greedy_decode(torch.from_numpy(logits),
                           torch.from_numpy(lengths))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))


def test_weight_bridge_round_trip(models):
    jm, params, pm = models
    flat = flatten_params(params)
    back = flat_from_params(pm.state_dict())
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_weight_bridge_rejects_mismatch(models):
    _, params, pm = models
    flat = flatten_params(params)
    flat.pop("out/b")
    with pytest.raises(RuntimeError, match="out.b"):
        pm.load_state_dict(params_from_flat(flat))
    flat = flatten_params(params)
    flat["out/b"] = flat["out/b"].astype(np.float64)
    with pytest.raises(ValueError, match="float32"):
        params_from_flat(flat)


def test_graves2006_shapes():
    g = torch.Generator().manual_seed(0)
    m = build_model("graves2006", None, num_classes=27, generator=g)
    assert m.rnn.layers[0].rnn.fw.wh.shape == (100, 400)
    x = torch.zeros(2, 5, 39)
    with torch.no_grad():
        assert m(x, torch.tensor([5, 3])).shape == (2, 5, 28)


@pytest.mark.parametrize("name,err,match", [
    ("zoneout_blstm", NotImplementedError, "B9-B10"),
    ("mi_blstm", NotImplementedError, "B11-B12"),
    ("nosuch", KeyError, "ln_blstm"),
])
def test_build_model_refuses(name, err, match):
    with pytest.raises(err, match=match):
        build_model(name)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_build_model_ln_blstm_runs(bidirectional):
    """ln_blstm builds (it was refused before its kernels were ported) and
    serves a small batch: finite logits, zero-padded frames held."""
    m = build_model("ln_blstm", f"num_hiddens=6,num_layers=2,bidirectional="
                    f"{str(bidirectional).lower()}", num_classes=27,
                    generator=torch.Generator().manual_seed(0))
    assert m.rnn.layers[1].rnn.fw.ln_h["g"].shape == (24,)
    x = torch.randn(2, 7, 39, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = m(x, torch.tensor([7, 4]))
    assert out.shape == (2, 7, 28) and bool(torch.isfinite(out).all())
