"""Port's BLSTM recurrence (asr_study_torch/ops/bilstm.py) against the JAX
fused kernel ``pallas_bilstm`` in interpret mode, forward and backward
(its custom VJP), and the layer, cell and dense pieces around it.  On the
CPU the wrappers ``bilstm`` and ``bilstm_bwd`` take their plain versions,
Python loops over time."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_study_torch.models.cells import LSTMCell
from asr_study_torch.models.nn import dense_apply, dense_init
from asr_study_torch.models.rnn import RNNLayer
from asr_study_torch.ops.bilstm import (BiLSTMFunction, bilstm, bilstm_bwd,
                                        bilstm_bwd_plain, bilstm_plain)
from asr_study_tpu.models import nn as jnn
from asr_study_tpu.models.cells import LSTMCell as JaxLSTMCell
from asr_study_tpu.models.rnn import RNNLayer as JaxRNNLayer
from asr_study_tpu.ops import pallas_bilstm as jbi

TOL = dict(rtol=1e-5, atol=1e-5)    # tests/test_pallas_bilstm.py's contract
# gradients: tests/test_pallas_lstm.py's contract for the backward kernels
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


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


def _cotangents(seed, t, b, h):
    rng = np.random.RandomState(seed)
    return (rng.randn(t, b, h).astype(np.float32),
            rng.randn(t, b, h).astype(np.float32))


def _function_grads(args, loss_of, through=None):
    """d loss_of(h_f, h_b) / d (xp_f, xp_b, wh_f, wh_b) by torch autograd,
    through BiLSTMFunction (or ``through``, same arguments -> (h_f,
    h_b))."""
    xp_f, xp_b, mask, wh_f, wh_b = [torch.from_numpy(a) for a in args]
    leaves = [a.clone().requires_grad_() for a in (xp_f, xp_b, wh_f, wh_b)]
    fn = through or BiLSTMFunction.apply
    h_f, h_b = fn(leaves[0], leaves[1], mask, leaves[2], leaves[3])
    loss_of(h_f, h_b).backward()
    return [np.zeros(leaf.shape, np.float32) if leaf.grad is None
            else leaf.grad.numpy() for leaf in leaves]


def _jax_grads(args, loss_of, h):
    """The same gradients through the JAX ``pallas_bilstm`` custom VJP in
    interpret mode."""
    mask = jnp.asarray(args[2])

    def loss(xf, xb, wf, wb):
        return loss_of(*jbi.pallas_bilstm(xf, xb, mask, wf, wb, h,
                                          interpret=True))

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (args[0], args[1], args[3], args[4])))]


GRAD_NAMES = ("dxp_f", "dxp_b", "dwh_f", "dwh_b")


@pytest.mark.parametrize("h", [8, 100])
@pytest.mark.parametrize("full_mask", [False, True],
                         ids=["ragged", "full"])
def test_bwd_matches_pallas_vjp(h, full_mask):
    """bilstm_bwd_plain and BiLSTMFunction's gradients against jax.vjp of
    pallas_bilstm: cotangents on every output frame."""
    t, b = 12, 4
    args = _inputs(h + 1, t, b, h, full_mask)
    dh_f, dh_b = _cotangents(h + 2, t, b, h)
    want = _jax_grads(args, lambda hf, hb: jnp.sum(hf * dh_f)
                      + jnp.sum(hb * dh_b), h)
    targs = [torch.from_numpy(a) for a in args]
    dxp = bilstm_bwd_plain(*targs, *bilstm_plain(*targs),
                           torch.from_numpy(dh_f), torch.from_numpy(dh_b))
    for name, g, w in zip(GRAD_NAMES, dxp, want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL, err_msg=name)
    got = _function_grads(args, lambda hf, hb: (
        (hf * torch.from_numpy(dh_f)).sum()
        + (hb * torch.from_numpy(dh_b)).sum()))
    for name, g, w in zip(GRAD_NAMES, got, want):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=name)


def test_bwd_held_frames_match_pallas():
    """A loss that reads the padded outputs, where h and c are held: their
    cotangents must pass straight back to the last real frame
    (tests/test_pallas_lstm.py's unmasked-loss case)."""
    t, b, h = 10, 4, 8
    args = _inputs(5, t, b, h)
    args[2][:, 1:] = (np.arange(t)[:, None] < np.array([3, 6, 9])[None, :]
                      )[..., None]
    want = _jax_grads(args, lambda hf, hb: jnp.sum(hf ** 2)
                      + jnp.sum(hb ** 2), h)
    got = _function_grads(args, lambda hf, hb: (hf ** 2).sum()
                          + (hb ** 2).sum())
    for name, g, w in zip(GRAD_NAMES, got, want):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=name)
    # the held frames' own pre-activations get nothing
    held = args[2][..., 0] == 0
    assert np.abs(got[0][held]).max() == 0.0
    assert np.abs(got[1][held]).max() == 0.0


@pytest.mark.parametrize("h", [8, 100])
@pytest.mark.parametrize("outputs", ["both", "h_f"])
def test_function_matches_autograd_through_plain(h, outputs):
    """BiLSTMFunction against torch autograd through the plain loop; with
    ``h_f`` only the backward direction gets no cotangent at all."""
    t, b = 9, 3
    args = _inputs(h + 3, t, b, h)
    dh_f, dh_b = (torch.from_numpy(a) for a in _cotangents(h + 4, t, b, h))

    def loss_of(hf, hb):
        out = (hf * dh_f).sum()
        return out + (hb * dh_b).sum() if outputs == "both" else out

    def plain(*a):
        h_f, _, h_b, _ = bilstm_plain(*a)
        return h_f, h_b

    got = _function_grads(args, loss_of)
    want = _function_grads(args, loss_of, through=plain)
    for name, g, w in zip(GRAD_NAMES, got, want):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=name)
    if outputs == "h_f":
        assert np.abs(got[1]).max() == 0.0 and np.abs(got[3]).max() == 0.0


def test_bwd_wrapper_takes_plain_on_cpu_and_checks():
    args = [torch.from_numpy(a) for a in _inputs(1, 6, 3, 5)]
    dh = [torch.from_numpy(a) for a in _cotangents(2, 6, 3, 5)]
    res = bilstm(*args)
    before = bilstm_bwd.launches
    got = bilstm_bwd(*args, *res, *dh)
    assert bilstm_bwd.launches == before
    for g, w in zip(got, bilstm_bwd_plain(*args, *res, *dh)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="dh_b"):
        bilstm_bwd(*args, *res, dh[0], dh[1][:-1])


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
