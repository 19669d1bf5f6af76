"""Port's BLSTM recurrence (asr_study_torch/ops/bilstm.py) against the JAX
fused kernel ``pallas_bilstm`` in interpret mode, and the layer, cell and
dense pieces around it.  On the CPU the wrapper ``bilstm`` takes its plain
version, a Python loop on ``lstm_step``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_study_torch.models.cells import LSTMCell
from asr_study_torch.models.nn import dense_apply, dense_init
from asr_study_torch.models.rnn import RNNLayer
from asr_study_torch.ops.bilstm import bilstm, bilstm_plain
from asr_study_tpu.models import nn as jnn
from asr_study_tpu.models.cells import LSTMCell as JaxLSTMCell
from asr_study_tpu.models.rnn import RNNLayer as JaxRNNLayer
from asr_study_tpu.ops import pallas_bilstm as jbi

TOL = dict(rtol=1e-5, atol=1e-5)    # tests/test_pallas_bilstm.py's contract


def _inputs(seed, t, b, h, full_mask=False):
    """Seeded numpy inputs: xp_f, xp_b [T,B,4H], ragged mask [T,B,1],
    wh_f, wh_b [H,4H] (orthogonal-like scale)."""
    rng = np.random.RandomState(seed)
    xp_f = rng.randn(t, b, 4 * h).astype(np.float32)
    xp_b = rng.randn(t, b, 4 * h).astype(np.float32)
    lengths = np.full(b, t) if full_mask else rng.randint(t // 2, t + 1, b)
    lengths[0] = t
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    wh_f = (rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)
    wh_b = (rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)
    return xp_f, xp_b, mask[..., None], wh_f, wh_b


@pytest.mark.parametrize("h", [8, 100])
@pytest.mark.parametrize("full_mask", [False, True],
                         ids=["ragged", "full"])
def test_plain_matches_pallas_bilstm(h, full_mask):
    t, b = 12, 4
    args = _inputs(h, t, b, h, full_mask)
    want = jbi._bifwd_call(*map(jnp.asarray, args), h, interpret=True)
    got = bilstm(*map(torch.from_numpy, args))
    names = ("h_f", "c_f", "h_b", "c_b")
    for name, g, w in zip(names, got, want):
        assert g.shape == (t, b, h), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:t], **TOL,
                                   err_msg=name)
    # the public JAX op returns the h pair only: same numbers
    h_f, h_b = jbi.pallas_bilstm(*map(jnp.asarray, args), h, interpret=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(h_f), **TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(h_b), **TOL)


def test_wrapper_takes_plain_on_cpu():
    args = [torch.from_numpy(a) for a in _inputs(0, 6, 3, 5)]
    before = bilstm.launches
    got = bilstm(*args)
    assert bilstm.launches == before
    for g, w in zip(got, bilstm_plain(*args)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["shape", "dtype", "mask", "device"])
def test_wrapper_rejects(bad):
    xp_f, xp_b, mask, wh_f, wh_b = [torch.from_numpy(a)
                                    for a in _inputs(0, 6, 3, 5)]
    if bad == "shape":
        wh_b = wh_b[:, :-4]
    elif bad == "dtype":
        xp_b = xp_b.double()
    elif bad == "mask":
        mask = mask[..., 0]
    else:
        xp_f, xp_b, mask, wh_f, wh_b = [a.to("meta") for a in
                                        (xp_f, xp_b, mask, wh_f, wh_b)]
    with pytest.raises(ValueError):
        bilstm(xp_f, xp_b, mask, wh_f, wh_b)


def _load_cell(cell, p):
    with torch.no_grad():
        for k in ("wx", "wh", "b"):
            getattr(cell, k).copy_(torch.from_numpy(np.array(p[k])))


@pytest.mark.parametrize("h", [8, 100])
def test_rnn_layer_matches_jax_scan(h):
    """RNNLayer (input projection + fused recurrence + mask) against the
    JAX layer on its CPU scan path."""
    t, b, f = 10, 3, 6
    jl = JaxRNNLayer("lstm", h)
    params = jl.init(jax.random.PRNGKey(h), f)
    rng = np.random.RandomState(h)
    x = rng.randn(t, b, f).astype(np.float32)
    lengths = np.array([t, 7, 4])
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(
        np.float32)[..., None]
    want = jl.apply(params, jnp.asarray(x), jnp.asarray(mask))
    layer = RNNLayer("lstm", f, h)
    _load_cell(layer.fw, params["fw"])
    _load_cell(layer.bw, params["bw"])
    with torch.no_grad():
        got = layer(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cell_step_matches_jax():
    cell_j = JaxLSTMCell(7)
    p = cell_j.init(jax.random.PRNGKey(1), 5)
    rng = np.random.RandomState(2)
    x = rng.randn(3, 5).astype(np.float32)
    h0 = rng.randn(3, 7).astype(np.float32)
    c0 = rng.randn(3, 7).astype(np.float32)
    m = np.array([[1.0], [0.0], [1.0]], np.float32)
    (hj, cj), _ = cell_j.step(p, (jnp.asarray(h0), jnp.asarray(c0)),
                              cell_j.input_proj(p, jnp.asarray(x)),
                              jnp.asarray(m))
    cell = LSTMCell(5, 7)
    _load_cell(cell, p)
    with torch.no_grad():
        (hp, cp), out = cell.step(
            (torch.from_numpy(h0), torch.from_numpy(c0)),
            cell.input_proj(torch.from_numpy(x)), torch.from_numpy(m))
    np.testing.assert_allclose(hp.numpy(), np.asarray(hj), **TOL)
    np.testing.assert_allclose(cp.numpy(), np.asarray(cj), **TOL)
    # the masked row holds its state exactly
    np.testing.assert_array_equal(hp[1].numpy(), h0[1])


def test_cell_init_layout():
    g = torch.Generator().manual_seed(0)
    cell = LSTMCell(5, 7, generator=g)
    assert cell.wx.shape == (5, 28) and cell.wh.shape == (7, 28)
    np.testing.assert_array_equal(cell.b[7:14].detach().numpy(), 1.0)
    # per-gate orthogonal blocks
    for k in range(4):
        blk = cell.wh[:, 7 * k: 7 * (k + 1)].detach()
        torch.testing.assert_close(blk.T @ blk, torch.eye(7), atol=1e-5,
                                   rtol=0)


def test_dense_matches_jax():
    p = jnn.dense_init(jax.random.PRNGKey(0), 6, 4)
    x = np.random.RandomState(0).randn(2, 3, 6).astype(np.float32)
    want = jnn.dense_apply(p, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    got = dense_apply(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    q = dense_init(6, 4, torch.Generator().manual_seed(0))
    assert q["w"].shape == (6, 4) and float(q["b"].abs().sum()) == 0.0
    assert float(q["w"].abs().max()) <= np.sqrt(6.0 / 10)
