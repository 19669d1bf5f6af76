"""bf16 compute of the zoneout and MI LSTMs (``train --bf16 --model
zoneout_blstm | mi_blstm``) on the CPU, held against the JAX package:
``BiZoneoutLSTMFunction`` / ``ZoneoutLSTMFunction`` and ``BiMILSTMFunction``
/ ``MILSTMFunction`` with a bfloat16 ``wh`` (the plain twins of the
kernels' bfloat16-weight forms) against ``pallas_bi_zoneout_lstm`` /
``pallas_zoneout_lstm`` and ``pallas_bi_mi_lstm`` / ``pallas_mi_lstm`` with
one in interpret mode; the twins against the rounding rule written out
(h_prev rounded only where it enters ``h_prev @ wh``, the zoneout mix and
the holds taking it unrounded; ``dpre`` / the MI ``dhp`` rounded only for
``@ wh^T``; MI's ``dir_grads`` on the unrounded h_prev, as the JAX
``dir_grads`` promotes it); the float32 recurrences unchanged bit for bit;
``Trainer(compute_dtype=torch.bfloat16)`` steps of zoneout_blstm and
mi_blstm against the JAX ``Trainer(compute_dtype=jnp.bfloat16)`` on its
Pallas route (``RNN_BACKEND = "pallas"``, as ``tests/test_torch_bf16.py``
runs the LSTM's), zoneout at rate 0 and at 0.1 with one mix handed to both
sides; and the float32 eval step.  The shapes that go to the stream design
(the stream forms' twins against the JAX kernels, and train steps at
B=50 and B=97): ``tests/test_torch_bf16_zm_stream.py``."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_study_torch.models.cells import ZoneoutLSTMCell
from asr_study_torch.models.zoo import build_model
from asr_study_torch.ops import mi_lstm as M
from asr_study_torch.ops import zoneout_lstm as Z
from asr_study_torch.ops.bilstm import _dwh
from asr_study_torch.ops.recurrence import prev
from asr_study_torch.train.trainer import Trainer, make_optimizer
from asr_study_torch.utils.weights import params_from_flat
from asr_study_tpu.models import rnn as jrnn
from asr_study_tpu.models import zoo as jzoo
from asr_study_tpu.ops import pallas_bi_mi_lstm as jbmi
from asr_study_tpu.ops import pallas_bi_zoneout_lstm as jbzo
from asr_study_tpu.ops import pallas_mi_lstm as jmi
from asr_study_tpu.ops import pallas_zoneout_lstm as jzo
from asr_study_tpu.train import trainer as jtrainer
from extras.export_weights import _flatten as flatten_params
from tests.test_torch_bf16 import (CLASSES, FEATS, GRAD_FRAC, LOSS_RTOL,
                                   _batch, _bf16_exact, _close_frac,
                                   _close_with_flips)

BF16 = torch.bfloat16
# Tolerances, as tests/test_torch_bf16_gru.py states them: h, c and dxp /
# dpre within 1e-3 + 1e-5 * |want| with at most 5% of the elements beyond
# VALUE_TOL (1e-5 + 1e-5 * |want|: the packages sum h_prev @ wh in other
# orders, so an h_prev within a float32 ulp of a bfloat16 rounding
# boundary may round apart, and the recurrence carries that for a few
# steps); dwh (bfloat16) and the MI vectors' gradients within GRAD_FRAC
# (1e-2) of their max abs.  A rounding in the wrong place (h_prev rounded
# in the mix, a hold or dir_grads, dpre or dhp left unrounded) moves most
# elements by about 1e-3.
# The twins against the rule written out: the same products in the same
# order, so within float32 summation order
TWIN_TOL = dict(rtol=1e-5, atol=1e-5)


def _rnd(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16, held as float32."""
    return t.to(BF16).float()


def _mask(t, b):
    lengths = np.array([t, t - 3, t // 2][:b])
    return (np.arange(t)[:, None] < lengths[None, :]).astype(
        np.float32)[..., None]


def _zo_inputs(seed, t, b, h):
    """xp_f, xp_b [T,B,4H], mask [T,B,1] with held frames, zh_f, zh_b, zc_f,
    zc_b [T,B,H] Bernoulli(0.8) mix weights, wh_f, wh_b [H,4H] float32, and
    the cotangents dh_f, dh_b."""
    rng = np.random.RandomState(seed)
    xp_f, xp_b = (rng.randn(t, b, 4 * h).astype(np.float32)
                  for _ in range(2))
    z = [(rng.rand(t, b, h) < 0.8).astype(np.float32) for _ in range(4)]
    wh_f, wh_b = ((rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)
                  for _ in range(2))
    dh_f, dh_b = (rng.randn(t, b, h).astype(np.float32) for _ in range(2))
    return (xp_f, xp_b, _mask(t, b), *z, wh_f, wh_b), (dh_f, dh_b)


def _mi_inputs(seed, t, b, h):
    """xp_f, xp_b raw [T,B,4H], mask [T,B,1], wh_f, wh_b [H,4H] float32,
    alpha, beta1, beta2 (near 1) and b (near 0) [4H] of each direction in
    the port's order (alpha_f, alpha_b, beta1_f, ...), and dh_f, dh_b."""
    rng = np.random.RandomState(seed)
    xp_f, xp_b = (rng.randn(t, b, 4 * h).astype(np.float32)
                  for _ in range(2))
    wh_f, wh_b = ((rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)
                  for _ in range(2))
    vecs = [(c + 0.3 * rng.randn(4 * h)).astype(np.float32)
            for c in (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0)]
    dh_f, dh_b = (rng.randn(t, b, h).astype(np.float32) for _ in range(2))
    return (xp_f, xp_b, _mask(t, b), wh_f, wh_b, *vecs), (dh_f, dh_b)


def _check_values(got, want, what):
    assert got.dtype == torch.float32, what
    _close_with_flips(got.detach().numpy(), want, what)


def _check_weight(got, want, what):
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16, what
    _close_frac(got.float().numpy(), want.astype(jnp.float32),
                frac=GRAD_FRAC, what=what)


# -- (a) the Functions against the JAX Pallas ops ---------------------------

def check_zoneout_parity(ndir, h, args, dh):
    """h, dxp and dwh (bfloat16) of BiZoneoutLSTMFunction /
    ZoneoutLSTMFunction with a bfloat16 wh against pallas_bi_zoneout_lstm
    / pallas_zoneout_lstm with one and the same mix, in interpret mode:
    ``args`` and ``dh`` as _zo_inputs gives them."""
    xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f, wh_b = args
    dh_f, dh_b = dh
    J = jnp.asarray

    def jax_loss(xf, xb, wf, wb):
        if ndir == 2:
            hf, hb = jbzo.pallas_bi_zoneout_lstm(
                xf, xb, J(mask), J(zh_f), J(zc_f), J(zh_b), J(zc_b), wf, wb,
                h, interpret=True)
            return jnp.sum(hf * J(dh_f)) + jnp.sum(hb * J(dh_b)), (hf, hb)
        hf = jzo.pallas_zoneout_lstm(xf, J(mask), J(zh_f), J(zc_f), wf, h,
                                     interpret=True)
        return jnp.sum(hf * J(dh_f)), (hf,)

    (_, hs_j), g_j = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3),
                                        has_aux=True)(
        J(xp_f), J(xp_b), J(wh_f).astype(jnp.bfloat16),
        J(wh_b).astype(jnp.bfloat16))
    T = torch.from_numpy
    xf, xb = T(xp_f).requires_grad_(), T(xp_b).requires_grad_()
    wf = T(wh_f).to(BF16).requires_grad_()
    wb = T(wh_b).to(BF16).requires_grad_()
    if ndir == 2:
        hs = Z.BiZoneoutLSTMFunction.apply(xf, xb, T(mask), T(zh_f), T(zh_b),
                                           T(zc_f), T(zc_b), wf, wb)
        loss = (hs[0] * T(dh_f)).sum() + (hs[1] * T(dh_b)).sum()
        pairs = ((xf, g_j[0]), (xb, g_j[1]))
        weights = ((wf, g_j[2]), (wb, g_j[3]))
    else:
        hs = (Z.ZoneoutLSTMFunction.apply(xf, T(mask), T(zh_f), T(zc_f),
                                          wf),)
        loss = (hs[0] * T(dh_f)).sum()
        pairs, weights = ((xf, g_j[0]),), ((wf, g_j[2]),)
    loss.backward()
    for got, want in zip(hs, hs_j):
        _check_values(got, want, "h")
    for xt, g in pairs:
        _check_values(xt.grad, g, "dxp")
    for wt, g in weights:
        _check_weight(wt.grad, g, "dwh")


def check_mi_parity(ndir, h, args, dh):
    """h and every gradient of BiMILSTMFunction / MILSTMFunction with a
    bfloat16 wh (dxp; dwh in bfloat16; dalpha, dbeta1, dbeta2, db of the
    float32 vectors) against pallas_bi_mi_lstm / pallas_mi_lstm with one,
    in interpret mode: ``args`` and ``dh`` as _mi_inputs gives them."""
    xp_f, xp_b, mask, wh_f, wh_b = args[:5]
    vecs = args[5:]
    dh_f, dh_b = dh
    J = jnp.asarray
    n_vec = 4 * ndir

    def jax_loss(xf, xb, wf, wb, *v):
        if ndir == 2:
            hf, hb = jbmi.pallas_bi_mi_lstm(xf, xb, J(mask), wf, wb,
                                            *v[0::2], *v[1::2], h,
                                            interpret=True)
            return jnp.sum(hf * J(dh_f)) + jnp.sum(hb * J(dh_b)), (hf, hb)
        hf = jmi.pallas_mi_lstm(xf, J(mask), wf, *v, h, interpret=True)
        return jnp.sum(hf * J(dh_f)), (hf,)

    jv = [J(v) for v in (vecs if ndir == 2 else vecs[0::2])]
    (_, hs_j), g_j = jax.value_and_grad(
        jax_loss, argnums=tuple(range(4 + n_vec)), has_aux=True)(
        J(xp_f), J(xp_b), J(wh_f).astype(jnp.bfloat16),
        J(wh_b).astype(jnp.bfloat16), *jv)
    T = torch.from_numpy
    xf, xb = T(xp_f).requires_grad_(), T(xp_b).requires_grad_()
    wf = T(wh_f).to(BF16).requires_grad_()
    wb = T(wh_b).to(BF16).requires_grad_()
    tv = [T(v).requires_grad_() for v in vecs]
    if ndir == 2:
        hs = M.BiMILSTMFunction.apply(xf, xb, T(mask), wf, wb, *tv)
        loss = (hs[0] * T(dh_f)).sum() + (hs[1] * T(dh_b)).sum()
        pairs = ((xf, g_j[0]), (xb, g_j[1]))
        weights = ((wf, g_j[2]), (wb, g_j[3]))
        leaves = tv
    else:
        leaves = tv[0::2]
        hs = (M.MILSTMFunction.apply(xf, T(mask), wf, *leaves),)
        loss = (hs[0] * T(dh_f)).sum()
        pairs, weights = ((xf, g_j[0]),), ((wf, g_j[2]),)
    loss.backward()
    for got, want in zip(hs, hs_j):
        _check_values(got, want, "h")
    for xt, g in pairs:
        _check_values(xt.grad, g, "dxp")
    for wt, g in weights:
        _check_weight(wt.grad, g, "dwh")
    for i, (leaf, g) in enumerate(zip(leaves, g_j[4:])):
        assert leaf.grad.dtype == torch.float32
        _close_frac(leaf.grad.numpy(), g, frac=GRAD_FRAC, what=f"vec {i}")


@pytest.mark.parametrize("h", [8, 16])
@pytest.mark.parametrize("ndir", [2, 1], ids=["bi", "uni"])
def test_zoneout_with_bf16_wh_matches_pallas(ndir, h):
    """check_zoneout_parity with a non-zero mix at T=12, B=3 with held
    frames (the cluster design)."""
    check_zoneout_parity(ndir, h, *_zo_inputs(h + 2, 12, 3, h))


@pytest.mark.parametrize("h", [8, 16])
@pytest.mark.parametrize("ndir", [2, 1], ids=["bi", "uni"])
def test_mi_with_bf16_wh_matches_pallas(ndir, h):
    """check_mi_parity at T=12, B=3 with held frames (the cluster
    design)."""
    check_mi_parity(ndir, h, *_mi_inputs(h + 3, 12, 3, h))


# -- (b) the twins against the rounding rule written out ----------------------

def _zo_reference(xp, mask, zh, zc, wh, dh, rounded, reverse=False):
    """One direction's zoneout recurrence and cotangent walk written out
    step by step -> (h, c, dxp); with ``rounded`` the products take
    ``bf16(h_prev) @ bf16(wh)`` and ``bf16(dpre) @ bf16(wh)^T`` while the
    mix, the holds and dxp stay unrounded, else plain ``@`` (the float32
    maths before bfloat16 weights), in the twins' order of operations."""
    rnd = _rnd if rounded else (lambda t: t)
    w = rnd(wh)
    t_steps, batch, gh = xp.shape
    order = list(reversed(range(t_steps))) if reverse else list(range(
        t_steps))
    h = torch.zeros(batch, gh // 4)
    c = torch.zeros(batch, gh // 4)
    hs, cs = [None] * t_steps, [None] * t_steps
    for t in order:
        i, f, g, o = (xp[t] + torch.matmul(rnd(h), w)).chunk(4, -1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        h_mix = zh[t] * h_new + (1.0 - zh[t]) * h
        c_mix = zc[t] * c_new + (1.0 - zc[t]) * c
        h = torch.where(mask[t] > 0, h_mix, h)
        c = torch.where(mask[t] > 0, c_mix, c)
        hs[t], cs[t] = h, c
    hseq, cseq = torch.stack(hs), torch.stack(cs)
    hp, cp = prev(hseq, reverse), prev(cseq, reverse)
    dxp = torch.zeros_like(xp)
    dh_next = torch.zeros(batch, gh // 4)
    dc_next = torch.zeros(batch, gh // 4)
    for t in reversed(order):
        m = mask[t] > 0
        i, f, g, o = (xp[t] + torch.matmul(rnd(hp[t]), w)).chunk(4, -1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        tc = torch.tanh(f * cp[t] + i * g)
        d = dh[t] + dh_next
        d_new = d * zh[t]
        dc = dc_next * zc[t] + d_new * o * (1.0 - tc * tc)
        dpre = torch.where(m, torch.cat([dc * g * i * (1.0 - i),
                                         dc * cp[t] * f * (1.0 - f),
                                         dc * i * (1.0 - g * g),
                                         d_new * tc * o * (1.0 - o)], -1),
                           0.0)
        dxp[t] = dpre
        dh_next = (torch.matmul(rnd(dpre), w.t())
                   + torch.where(m, d * (1.0 - zh[t]), d))
        dc_next = torch.where(m, dc * f + dc_next * (1.0 - zc[t]), dc_next)
    return hseq, cseq, dxp


def _mi_reference(xp, mask, wh, al, b1, b2, b, dh, rounded, reverse=False):
    """One direction's MI recurrence and cotangent walk written out step by
    step -> (h, c, dpre); with ``rounded`` hp takes ``bf16(h_prev) @
    bf16(wh)`` and the chain ``bf16(dhp) @ bf16(wh)^T`` while the hold and
    dpre stay unrounded, else plain ``@``, in the twins' order of
    operations."""
    rnd = _rnd if rounded else (lambda t: t)
    w = rnd(wh)
    t_steps, batch, gh = xp.shape
    order = list(reversed(range(t_steps))) if reverse else list(range(
        t_steps))
    h = torch.zeros(batch, gh // 4)
    c = torch.zeros(batch, gh // 4)
    hs, cs = [None] * t_steps, [None] * t_steps
    for t in order:
        hp = torch.matmul(rnd(h), w)
        i, f, g, o = (al * xp[t] * hp + b1 * xp[t] + b2 * hp + b).chunk(4,
                                                                      -1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        h = torch.where(mask[t] > 0, h_new, h)
        c = torch.where(mask[t] > 0, c_new, c)
        hs[t], cs[t] = h, c
    hseq, cseq = torch.stack(hs), torch.stack(cs)
    hps, cps = prev(hseq, reverse), prev(cseq, reverse)
    dpre_seq = torch.zeros_like(xp)
    dh_next = torch.zeros(batch, gh // 4)
    dc_next = torch.zeros(batch, gh // 4)
    for t in reversed(order):
        m = mask[t] > 0
        hp = torch.matmul(rnd(hps[t]), w)
        i, f, g, o = (al * xp[t] * hp + b1 * xp[t] + b2 * hp + b).chunk(4,
                                                                      -1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        d = dh[t] + dh_next
        tc = torch.tanh(cseq[t])
        dc = dc_next + d * o * (1.0 - tc * tc)
        dpre = torch.where(m, torch.cat([dc * g * i * (1.0 - i),
                                         dc * cps[t] * f * (1.0 - f),
                                         dc * i * (1.0 - g * g),
                                         d * tc * o * (1.0 - o)], -1), 0.0)
        dpre_seq[t] = dpre
        dhp = dpre * (al * xp[t] + b2)
        dh_next = torch.matmul(rnd(dhp), w.t()) + torch.where(m, 0.0, d)
        dc_next = torch.where(m, dc * f, dc_next)
    return hseq, cseq, dpre_seq


def _counts(*wrappers):
    return [(w.launches, dict(w.by_design)) for w in wrappers]


def test_bf16_zoneout_twins_round_where_the_kernels_do():
    """On the CPU the zoneout wrappers take their plain twins with a
    bfloat16 wh (no launch counted): h, c and dxp equal to the rounding rule
    written out step by step, to float32 summation order, in both walk
    directions."""
    t, b, h = 7, 3, 8
    (xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f, wh_b), dh = \
        _zo_inputs(11, t, b, h)
    T = torch.from_numpy
    xs, zhs, zcs = (T(xp_f), T(xp_b)), (T(zh_f), T(zh_b)), (T(zc_f),
                                                            T(zc_b))
    whs = (T(wh_f).to(BF16), T(wh_b).to(BF16))
    m, dhs = T(mask), (T(dh[0]), T(dh[1]))
    wrappers = (Z.bi_zoneout_lstm, Z.bi_zoneout_lstm_bwd, Z.zoneout_lstm,
                Z.zoneout_lstm_bwd)
    before = _counts(*wrappers)
    hc = Z.bi_zoneout_lstm(xs[0], xs[1], m, zhs[0], zhs[1], zcs[0], zcs[1],
                           *whs)
    d = Z.bi_zoneout_lstm_bwd(xs[0], xs[1], m, zhs[0], zhs[1], zcs[0],
                              zcs[1], *whs, *hc, *dhs)
    h_u, c_u = Z.zoneout_lstm(xs[0], m, zhs[0], zcs[0], whs[0])
    d_u = Z.zoneout_lstm_bwd(xs[0], m, zhs[0], zcs[0], whs[0], h_u, c_u,
                             dhs[0])
    assert _counts(*wrappers) == before
    for i in range(2):
        want = _zo_reference(xs[i], m, zhs[i], zcs[i], whs[i].float(),
                             dhs[i], True, reverse=i == 1)
        for got, ref, name in zip((hc[2 * i], hc[2 * i + 1], d[i]), want,
                                  ("h", "c", "dxp")):
            assert got.dtype == torch.float32, name
            torch.testing.assert_close(got, ref, **TWIN_TOL, msg=name)
        if i == 0:
            for got, ref in zip((h_u, c_u, d_u), want):
                torch.testing.assert_close(got, ref, **TWIN_TOL)
        # dwh: the float32 product of the unrounded h_prev and dxp, cast
        hp = prev(want[0], i == 1).reshape(-1, h)
        assert torch.equal(_dwh(hc[2 * i], d[i], i == 1, whs[i]),
                           (hp.t() @ d[i].reshape(-1, 4 * h)).to(BF16))


def test_bf16_mi_twins_round_where_the_kernels_do():
    """On the CPU the MI wrappers take their plain twins with a bfloat16 wh
    (no launch counted): h, c and dpre equal to the rounding rule written
    out step by step, to float32 summation order, in both walk
    directions."""
    t, b, h = 7, 3, 8
    args, dh = _mi_inputs(12, t, b, h)
    a = [torch.from_numpy(x) for x in args]
    a[3], a[4] = a[3].to(BF16), a[4].to(BF16)
    m, dhs = a[2], [torch.from_numpy(x) for x in dh]
    wrappers = (M.bi_mi_lstm, M.bi_mi_lstm_bwd, M.mi_lstm, M.mi_lstm_bwd)
    before = _counts(*wrappers)
    hc = M.bi_mi_lstm(*a)
    d = M.bi_mi_lstm_bwd(*a, *hc, *dhs)
    uni = [a[k] for k in (0, 2, 3, 5, 7, 9, 11)]
    h_u, c_u = M.mi_lstm(*uni)
    d_u = M.mi_lstm_bwd(*uni, h_u, c_u, dhs[0])
    assert _counts(*wrappers) == before
    for i in range(2):
        vec = [a[5 + i], a[7 + i], a[9 + i], a[11 + i]]
        want = _mi_reference(a[i], m, a[3 + i].float(), *vec, dhs[i], True,
                             reverse=i == 1)
        for got, ref, name in zip((hc[2 * i], hc[2 * i + 1], d[i]), want,
                                  ("h", "c", "dpre")):
            assert got.dtype == torch.float32, name
            torch.testing.assert_close(got, ref, **TWIN_TOL, msg=name)
        if i == 0:
            for got, ref in zip((h_u, c_u, d_u), want):
                torch.testing.assert_close(got, ref, **TWIN_TOL)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_bf16_mi_dir_grads_match_jax(reverse):
    """dir_grads with a bfloat16 wh against the JAX dir_grads with one: the
    hp of dxp and of the vectors' sums is the float32 product of the
    UNROUNDED h_prev and wh's bfloat16 values (the JAX einsum promotes),
    dwh comes back bfloat16; dxp and the sums to float32 summation order,
    dwh within GRAD_FRAC of its max."""
    t, b, h = 9, 3, 8
    args, _ = _mi_inputs(13, t, b, h)
    rng = np.random.RandomState(14)
    dpre = rng.randn(t, b, 4 * h).astype(np.float32)
    hs = rng.randn(t, b, h).astype(np.float32)
    xp, wh, al, b1, b2 = args[0], args[3], args[5], args[7], args[9]
    zero = np.zeros((1, b, h), np.float32)
    h_prev = (np.concatenate([hs[1:], zero]) if reverse
              else np.concatenate([zero, hs[:-1]]))
    J = jnp.asarray
    want = jmi.dir_grads(J(dpre), J(xp), J(h_prev),
                         J(wh).astype(jnp.bfloat16), J(al), J(b1), J(b2))
    T = torch.from_numpy
    got = M.dir_grads(T(dpre), T(xp), T(hs), T(wh).to(BF16), T(al), T(b1),
                      T(b2), reverse)
    names = ("dxp", "dwh", "dalpha", "dbeta1", "dbeta2", "db")
    for name, g, w in zip(names, got, want):
        if name == "dwh":
            _check_weight(g, w, name)
            continue
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


# -- (c) float32 unchanged ----------------------------------------------------

@pytest.mark.parametrize("ndir", [2, 1], ids=["bi", "uni"])
def test_float32_zoneout_unchanged(ndir):
    """With float32 weights the zoneout wrappers' maths is the parent's bit
    for bit: h, c, dxp and dwh against the products written as ``@``."""
    t, b, h = 9, 3, 8
    (xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f, wh_b), dh = \
        _zo_inputs(15, t, b, h)
    T = torch.from_numpy
    xs, zhs, zcs = [T(xp_f), T(xp_b)], [T(zh_f), T(zh_b)], [T(zc_f),
                                                            T(zc_b)]
    ws, dhs, m = [T(wh_f), T(wh_b)], [T(dh[0]), T(dh[1])], T(mask)
    if ndir == 2:
        hc = Z.bi_zoneout_lstm(*xs, m, *zhs, *zcs, *ws)
        ds = Z.bi_zoneout_lstm_bwd(*xs, m, *zhs, *zcs, *ws, *hc, *dhs)
    else:
        hc = Z.zoneout_lstm(xs[0], m, zhs[0], zcs[0], ws[0])
        ds = (Z.zoneout_lstm_bwd(xs[0], m, zhs[0], zcs[0], ws[0], *hc,
                                 dhs[0]),)
    for i in range(ndir):
        want = _zo_reference(xs[i], m, zhs[i], zcs[i], ws[i], dhs[i], False,
                             reverse=i == 1)
        for got, ref in zip((hc[2 * i], hc[2 * i + 1], ds[i]), want):
            assert torch.equal(got, ref)
        hp = prev(want[0], i == 1)
        assert torch.equal(_dwh(want[0], want[2], i == 1, ws[i]),
                           hp.reshape(-1, h).t() @ want[2].reshape(-1,
                                                                   4 * h))


@pytest.mark.parametrize("ndir", [2, 1], ids=["bi", "uni"])
def test_float32_mi_unchanged(ndir):
    """With float32 weights the MI wrappers' maths is the parent's bit for
    bit: h, c, dpre and dir_grads' dwh against the products written as
    ``@``."""
    t, b, h = 9, 3, 8
    args, dh = _mi_inputs(16, t, b, h)
    a = [torch.from_numpy(x) for x in args]
    m, dhs = a[2], [torch.from_numpy(x) for x in dh]
    if ndir == 2:
        hc = M.bi_mi_lstm(*a)
        ds = M.bi_mi_lstm_bwd(*a, *hc, *dhs)
    else:
        uni = [a[k] for k in (0, 2, 3, 5, 7, 9, 11)]
        hc = M.mi_lstm(*uni)
        ds = (M.mi_lstm_bwd(*uni, *hc, dhs[0]),)
    for i in range(ndir):
        vec = [a[5 + i], a[7 + i], a[9 + i], a[11 + i]]
        want = _mi_reference(a[i], m, a[3 + i], *vec, dhs[i], False,
                             reverse=i == 1)
        for got, ref in zip((hc[2 * i], hc[2 * i + 1], ds[i]), want):
            assert torch.equal(got, ref)
        h_prev = prev(want[0], i == 1).reshape(-1, h)
        dwh = M.dir_grads(want[2], a[i], want[0], a[3 + i], vec[0], vec[1],
                          vec[2], i == 1)[1]
        dhp = want[2].reshape(-1, 4 * h) * (
            vec[0] * a[i].reshape(-1, 4 * h) + vec[2])
        assert torch.equal(dwh, h_prev.t() @ dhp)


# -- (d) the train step -------------------------------------------------------

ZM_STEP_CASES = {
    "zoneout_blstm": ("zoneout_blstm", "num_hiddens=8,num_layers=2,"
                      "dropout=0.0,zoneout_h=0.0,zoneout_c=0.0"),
    "zoneout_blstm_uni": ("zoneout_blstm", "num_hiddens=8,num_layers=1,"
                          "dropout=0.0,zoneout_h=0.0,zoneout_c=0.0,"
                          "bidirectional=false"),
    "zoneout_blstm_rate": ("zoneout_blstm", "num_hiddens=8,num_layers=2,"
                           "dropout=0.0,zoneout_h=0.1,zoneout_c=0.1"),
    "mi_blstm": ("mi_blstm", "num_hiddens=8,num_layers=2,dropout=0.0"),
    "mi_blstm_uni": ("mi_blstm", "num_hiddens=8,num_layers=1,dropout=0.0,"
                     "bidirectional=false"),
}


class _MixFeed:
    """One sequence of zoneout mix weights handed to both packages: the
    k-th draw of a forward (a layer's forward direction, then its backward
    one) is the k-th pair of Bernoulli(0.9) [T, B, 128] arrays (the JAX
    route's width, padded to 128 lanes; the port takes the first H)."""

    def __init__(self, seed, t, b, n):
        rng = np.random.RandomState(seed)
        self.pairs = [tuple((rng.rand(t, b, 128) < 0.9).astype(np.float32)
                            for _ in range(2)) for _ in range(n)]
        self.k = 0

    def jax_mix(self, cell, key, train, t_steps, batch, h_eff,
                flip_keys=False):
        assert train and (t_steps, batch, h_eff) == self.pairs[0][0].shape
        pair = self.pairs[self.k % len(self.pairs)]
        self.k += 1
        return jnp.asarray(pair[0]), jnp.asarray(pair[1])

    def port_mix(self):
        feed = self

        def mix(cell, t_steps, batch, train=False, generator=None,
                device=None):
            assert train and (t_steps, batch) == feed.pairs[0][0].shape[:2]
            pair = feed.pairs[feed.k % len(feed.pairs)]
            feed.k += 1
            return tuple(torch.from_numpy(z[..., :cell.hidden]).to(device)
                         for z in pair)
        return mix


def check_train_step(monkeypatch, model, hp, b=3, feed=None):
    """One sgd step (momentum 0.9 from zeros: the JAX gradient is (p0 - p1)
    / lr) of ``model`` with ``hp`` on ``b`` rows, bfloat16 compute on the
    port and on the JAX Pallas route, from the same weights (with
    ``feed``, one zoneout mix handed to both): the loss within LOSS_RTOL,
    every parameter's gradient (the cast's autograd hands the float32
    master a bfloat16-representable gradient of the loss sum, divided by
    the weight sum after it) within GRAD_FRAC of its max, float32 masters
    and optimizer state afterwards."""
    monkeypatch.setattr(jrnn, "RNN_BACKEND", "pallas")
    batch = _batch(b=b)
    lr = 0.1
    spec = ("sgd", lr, 400.0)
    jm = getattr(jzoo, model)(hp, num_classes=CLASSES)
    jt = jtrainer.Trainer(jm, jtrainer.make_optimizer(*spec),
                          donate_state=False, compute_dtype=jnp.bfloat16)
    js = jt.init_state(jax.random.PRNGKey(0), FEATS)
    p0 = flatten_params(js.params)
    pm = build_model(model, hp, num_classes=CLASSES, input_dim=FEATS,
                     generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(params_from_flat(p0))
    trainer = Trainer(pm, make_optimizer(*spec), compute_dtype=BF16)
    state = trainer.init_state()
    probe = Trainer(copy.deepcopy(pm), make_optimizer(*spec),
                    compute_dtype=BF16)
    tb = list(map(torch.from_numpy, batch))
    if feed is not None:
        feed.k = 0
    logits = probe._forward_cast(probe.model, tb[0], tb[1],
                                 torch.Generator().manual_seed(1))
    loss_sum, w_sum = probe._loss_sum(logits, *tb[1:])
    loss_sum.backward()
    sum_grads = dict(probe.model.named_parameters())
    if feed is not None:
        feed.k = 0
    js1, jmet = jt.train_step(js, *map(jnp.asarray, batch),
                              jax.random.PRNGKey(1))
    if feed is not None:
        assert feed.k == 4          # two layers, two directions, one trace
        feed.k = 0
    state, met = trainer.train_step(state, *map(torch.from_numpy, batch),
                                    torch.Generator().manual_seed(1))
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]),
                                               rel=LOSS_RTOL)
    p1 = flatten_params(js1.params)
    named = dict(pm.named_parameters())
    assert {k.replace("/", ".") for k in p0} == set(named)
    for k in p0:
        p = named[k.replace("/", ".")]
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        g_sum = sum_grads[k.replace("/", ".")].grad
        assert _bf16_exact(g_sum), k
        assert torch.equal(p.grad, g_sum / w_sum), k
        want = (np.asarray(p0[k], np.float32)
                - np.asarray(p1[k], np.float32)) / lr
        _close_frac(p.grad.numpy(), want, what=k)
    for buf in state.optimizer.state.values():
        assert all(v.dtype == torch.float32 for v in buf.values()
                   if torch.is_tensor(v))


@pytest.mark.parametrize("case", list(ZM_STEP_CASES))
def test_bf16_zoneout_mi_train_step_matches_jax(monkeypatch, case):
    """check_train_step of zoneout_blstm (rate 0, and rate 0.1 with one mix
    handed to both packages by patching their draws) and mi_blstm at B=3
    (the cluster design)."""
    model, hp = ZM_STEP_CASES[case]
    feed = None
    if case == "zoneout_blstm_rate":
        batch = _batch()
        feed = _MixFeed(17, batch[0].shape[1], batch[0].shape[0], 4)
        monkeypatch.setattr(jrnn, "_zoneout_mix", feed.jax_mix)
        monkeypatch.setattr(ZoneoutLSTMCell, "mix", feed.port_mix())
    check_train_step(monkeypatch, model, hp, feed=feed)


# -- (e) the eval step --------------------------------------------------------

@pytest.mark.parametrize("model", ["zoneout_blstm", "mi_blstm"])
def test_bf16_zoneout_mi_eval_step_is_float32(model):
    """The eval step does not cast: a bfloat16 trainer's eval equals a
    float32 trainer's on the same weights, bit for bit."""
    pm = build_model(model, "num_hiddens=8,num_layers=2,dropout=0.0",
                     num_classes=CLASSES, input_dim=FEATS,
                     generator=torch.Generator().manual_seed(0))
    batch = list(map(torch.from_numpy, _batch(1)))
    outs = []
    for dtype in (BF16, None):
        tr = Trainer(pm, make_optimizer(), compute_dtype=dtype)
        outs.append(tr.eval_step(tr.init_state(), *batch))
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k
