"""bf16 compute of the layer-norm LSTM (``train --bf16 --model ln_blstm``)
on the CPU, held against the JAX package: ``BiLNLSTMFunction`` /
``LNLSTMFunction`` with a bfloat16 ``wh`` (the plain twins of the kernels'
bfloat16-weight forms) against ``pallas_bi_ln_lstm`` / ``pallas_ln_lstm``
with one in interpret mode; the twins against the rounding rule written
out (h_prev rounded only where it enters ``h_prev @ wh``, the statistics
of that product, c, the cell LN and the hold float32 and the hold taking
h_prev unrounded; ``dhp`` rounded only for ``@ wh^T``; ``_ln_param_grads``
on the unrounded h_prev, as the JAX ``_ln_param_grads`` promotes it); the
float32 recurrences unchanged bit for bit; ``Trainer(compute_dtype=
torch.bfloat16)`` steps of ln_blstm, bi and uni, against the JAX
``Trainer(compute_dtype=jnp.bfloat16)`` on its Pallas route
(``RNN_BACKEND = "pallas"``, as ``tests/test_torch_bf16.py`` runs the
LSTM's); the float32 eval step; ``train --bf16 --model ln_blstm`` against
the JAX CLI; and the bfloat16 calls at the shapes that go to the stream
design, the Functions against the JAX Pallas ops there too (their train
steps: ``tests/test_torch_bf16_ln_stream.py``)."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_study_torch.cli import make_dataset as port_make_dataset
from asr_study_torch.cli import train as port_train
from asr_study_torch.models.cells import LN_EPS
from asr_study_torch.models.zoo import build_model
from asr_study_torch.ops import ln_lstm as LN
from asr_study_torch.ops.recurrence import prev
from asr_study_torch.train.checkpoint import CheckpointManager
from asr_study_torch.train.trainer import Trainer, make_optimizer
from asr_study_torch.utils.weights import params_from_flat
from asr_study_tpu.cli import train as jax_train
from asr_study_tpu.models import rnn as jrnn
from asr_study_tpu.models import zoo as jzoo
from asr_study_tpu.ops import pallas_bi_ln_lstm as jbi
from asr_study_tpu.ops import pallas_ln_lstm as jln
from asr_study_tpu.train import trainer as jtrainer
from extras.export_weights import _flatten as flatten_params
from tests.test_torch_bf16 import (CLASSES, FEATS, GRAD_FRAC, LOSS_RTOL,
                                   _batch, _bf16_exact, _close_frac)

BF16 = torch.bfloat16
# Tolerances.  h and dpre (the gradient of xpn): every element within
# FLIP_FRAC of the max abs, and all but FLIP_SHARE of them within VALUE_TOL
# (1e-5 + 1e-5 * |want|).  The packages' h and c differ in the last
# float32 bits (other summation orders), and an operand within such a
# difference of a bfloat16 rounding boundary rounds apart: h_prev in the
# forward, as for the GRU (tests/test_torch_bf16_gru.py), and in the
# backward dhp, which the LN backward scales by the rstd of a gate block of
# h_prev @ wh, so one bfloat16 ulp of it moves the next dh by up to 1e-2
# (measured: a difference of 2.4e-7 in one c moved dpre by 3.8e-3, 2.3e-4
# of its max abs 16.6, at bi H=8; the backward fed the same h and c agrees
# to 2.5e-6).  dwh (bfloat16) and the gains' and bias's gradients within
# GRAD_FRAC (1e-2) of their max abs.  A rounding in the wrong place (h_prev
# rounded in the hold or in _ln_param_grads, dhp left unrounded) moves most
# elements beyond VALUE_TOL.
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
FLIP_FRAC = 1e-3
FLIP_SHARE = 0.05
# The twins against the rule written out: the same products in the same
# order, so within float32 summation order
TWIN_TOL = dict(rtol=1e-5, atol=1e-5)
# T of the cases that run the JAX backward kernels: a prime above 16, so
# they walk one frame a grid step (their chunk divides T and is at most
# 16; at T=12 they unroll 12 frames a step, which takes far longer to
# trace)
T_JAX = 17


def _rnd(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16, held as float32."""
    return t.to(BF16).float()


def _inputs(seed, t, b, h):
    """xpn_f, xpn_b [T,B,4H], a mask [T,B,1] with held frames, wh_f, wh_b
    [H,4H] float32, gh_f, gh_b [4H], gc_f, gc_b, bc_f, bc_b [H] (gains
    near 1, biases near 0), and the cotangents dh_f, dh_b."""
    rng = np.random.RandomState(seed)

    def near(n, centre):
        return (centre + 0.3 * rng.randn(n)).astype(np.float32)

    xpn = [rng.randn(t, b, 4 * h).astype(np.float32) for _ in range(2)]
    wh = [(rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)
          for _ in range(2)]
    vecs = [near(4 * h, 1.0), near(4 * h, 1.0), near(h, 1.0), near(h, 1.0),
            near(h, 0.0), near(h, 0.0)]
    lengths = np.array([t, t - 3, t // 2][:b])
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    dh = [rng.randn(t, b, h).astype(np.float32) for _ in range(2)]
    return (xpn[0], xpn[1], mask[..., None], wh[0], wh[1], *vecs), dh


def _close_scaled(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want)
    scale = float(np.abs(want).max())
    assert err.max() <= FLIP_FRAC * scale, (
        f"{what}: max err {err.max():.3e} > {FLIP_FRAC} * {scale:.3e}")
    share = float((err > VALUE_TOL["atol"]
                   + VALUE_TOL["rtol"] * np.abs(want)).mean())
    assert share <= FLIP_SHARE, f"{what}: {share:.3f} of the elements " \
                                f"beyond VALUE_TOL (max err {err.max():.3e})"


def _uni(args):
    """The forward direction's arguments: (xpn, mask, wh, gh, gc, bc)."""
    return tuple(args[i] for i in (0, 2, 3, 5, 7, 9))


# -- (a) the Functions against the JAX Pallas ops ---------------------------

def _close_walk_start(got, want, reverse, what):
    """dpre of one direction at T=2 and H up to 512 (the stream design's
    shapes): every element within FLIP_FRAC of the max abs, and the
    VALUE_TOL share on the frame its cotangent walk takes first, which no
    rounded dhp has reached.  At the walk's second frame one dhp rounding
    that flips moves the whole row (4H elements, a sixth of a T=2, B=3
    tensor): measured at H=512, B=3 in two directions, the JAX op against
    itself with xpn scaled by 1 + 1e-7 noise moves 11% of a direction's
    second frame beyond VALUE_TOL, max 5.5e-4, as the port against JAX
    moves 13%, max 5.9e-4 of a max abs of 6.6."""
    _close_frac(got, want, frac=FLIP_FRAC, what=what)
    first = 0 if reverse else -1
    _close_scaled(got[first], want[first], f"{what} (walk's first frame)")


def check_ln_parity(ndir, h, args, dh, walk_start=False):
    """h and every gradient of BiLNLSTMFunction / LNLSTMFunction with a
    bfloat16 wh (dpre; dwh in bfloat16; dgh, dgc, dbc of the float32
    vectors) against pallas_bi_ln_lstm / pallas_ln_lstm with one, in
    interpret mode: ``args`` and ``dh`` as _inputs gives them.  With
    ``walk_start``, dpre as _close_walk_start holds it."""
    if ndir == 1:
        args = _uni(args)
    n_x = ndir
    xs, mask = args[:n_x], args[n_x]
    ws, vecs = args[n_x + 1: 2 * n_x + 1], args[2 * n_x + 1:]
    J = jnp.asarray

    def jax_loss(*a):
        x, w, v = a[:n_x], a[n_x: 2 * n_x], a[2 * n_x:]
        if ndir == 2:
            hf, hb = jbi.pallas_bi_ln_lstm(*x, J(mask), *w, *v, h, h, True)
            return jnp.sum(hf * J(dh[0])) + jnp.sum(hb * J(dh[1])), (hf, hb)
        hf = jln.pallas_ln_lstm(*x, J(mask), *w, *v, h, h, True)
        return jnp.sum(hf * J(dh[0])), (hf,)

    (_, hs_j), g_j = jax.value_and_grad(
        jax_loss, argnums=tuple(range(2 * n_x + len(vecs))), has_aux=True)(
        *map(J, xs), *(J(w).astype(jnp.bfloat16) for w in ws),
        *map(J, vecs))
    T = torch.from_numpy
    tx = [T(x).requires_grad_() for x in xs]
    tw = [T(w).to(BF16).requires_grad_() for w in ws]
    tv = [T(v).requires_grad_() for v in vecs]
    fn = LN.BiLNLSTMFunction if ndir == 2 else LN.LNLSTMFunction
    hs = fn.apply(*tx, T(mask), *tw, *tv)
    hs = hs if ndir == 2 else (hs,)
    sum(((o * T(d)).sum() for o, d in zip(hs, dh)), torch.zeros(())
        ).backward()
    for got, want in zip(hs, hs_j):
        assert got.dtype == torch.float32
        _close_scaled(got.detach().numpy(), want, "h")
    for i, (x, g) in enumerate(zip(tx, g_j)):
        assert x.grad.dtype == torch.float32
        if walk_start:
            _close_walk_start(x.grad.numpy(), np.asarray(g), i == 1, "dpre")
        else:
            _close_scaled(x.grad.numpy(), g, "dpre")
    for w, g in zip(tw, g_j[n_x:]):
        assert w.grad.dtype == BF16 and g.dtype == jnp.bfloat16
        _close_frac(w.grad.float().numpy(), g.astype(jnp.float32),
                    frac=GRAD_FRAC, what="dwh")
    for i, (v, g) in enumerate(zip(tv, g_j[2 * n_x:])):
        assert v.grad.dtype == torch.float32
        _close_frac(v.grad.numpy(), g, frac=GRAD_FRAC, what=f"vec {i}")


@pytest.mark.parametrize("h", [8, 16])
@pytest.mark.parametrize("ndir", [2, 1], ids=["bi", "uni"])
def test_ln_with_bf16_wh_matches_pallas(ndir, h):
    """check_ln_parity at T=17, B=3 with held frames (the cluster
    design)."""
    check_ln_parity(ndir, h, *_inputs(h + 5, T_JAX, 3, h))


# -- (b) the twins against the rounding rule written out ----------------------

def _stats(x):
    """LayerNorm statistics over the last dim -> (xhat, rstd)."""
    d = x - x.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((d * d).mean(dim=-1, keepdim=True) + LN_EPS)
    return d * rstd, rstd


def _ln_back(dy_g, xhat, rstd):
    return rstd * (dy_g - dy_g.mean(dim=-1, keepdim=True)
                   - xhat * (dy_g * xhat).mean(dim=-1, keepdim=True))


def _ln_reference(xpn, mask, wh, gh, gc, bc, dh, rounded, reverse=False):
    """One direction's LN recurrence and cotangent walk written out step by
    step -> (h, c, dpre, dcn); with ``rounded`` hp takes ``bf16(h_prev) @
    bf16(wh)`` and the chain ``bf16(dhp) @ bf16(wh)^T`` while the
    statistics, the hold, dpre and dcn stay unrounded, else plain ``@``,
    in the twins' order of operations."""
    rnd = _rnd if rounded else (lambda t: t)
    w = rnd(wh)
    t_steps, batch, g4 = xpn.shape
    hid = g4 // 4
    order = list(reversed(range(t_steps))) if reverse else list(range(
        t_steps))
    h = torch.zeros(batch, hid)
    c = torch.zeros(batch, hid)
    ghb = gh.view(4, hid)
    hs, cs = [None] * t_steps, [None] * t_steps
    for t in order:
        xhat, _ = _stats(torch.matmul(rnd(h), w).view(batch, 4, hid))
        i, f, g, o = (xpn[t] + (xhat * ghb).view(batch, g4)).chunk(4, -1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        chat, _ = _stats(c_new)
        h_new = torch.sigmoid(o) * torch.tanh(chat * gc + bc)
        h = torch.where(mask[t] > 0, h_new, h)
        c = torch.where(mask[t] > 0, c_new, c)
        hs[t], cs[t] = h, c
    hseq, cseq = torch.stack(hs), torch.stack(cs)
    hps, cps = prev(hseq, reverse), prev(cseq, reverse)
    dpre_seq, dcn_seq = torch.zeros_like(xpn), torch.zeros_like(hseq)
    dh_next = torch.zeros(batch, hid)
    dc_next = torch.zeros(batch, hid)
    for t in reversed(order):
        m = mask[t] > 0
        xhat, rstd = _stats(torch.matmul(rnd(hps[t]), w).view(batch, 4, hid))
        i, f, g, o = (xpn[t] + (xhat * ghb).view(batch, g4)).chunk(4, -1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        chat, rstd_c = _stats(cseq[t])
        tc = torch.tanh(chat * gc + bc)
        d = dh[t] + dh_next
        dcn = d * o * (1.0 - tc * tc)
        dc = dc_next + _ln_back(dcn * gc, chat, rstd_c)
        dpre = torch.where(m, torch.cat([dc * g * i * (1.0 - i),
                                         dc * cps[t] * f * (1.0 - f),
                                         dc * i * (1.0 - g * g),
                                         d * tc * o * (1.0 - o)], -1), 0.0)
        dpre_seq[t] = dpre
        dcn_seq[t] = torch.where(m, dcn, 0.0)
        dhp = _ln_back(dpre.view(batch, 4, hid) * ghb, xhat, rstd)
        dh_next = (torch.matmul(rnd(dhp.view(batch, g4)), w.t())
                   + torch.where(m, 0.0, d))
        dc_next = torch.where(m, dc * f, dc_next)
    return hseq, cseq, dpre_seq, dcn_seq


def _counts(*wrappers):
    return [(w.launches, dict(w.by_design)) for w in wrappers]


def test_bf16_ln_twins_round_where_the_kernels_do():
    """On the CPU the LN wrappers take their plain twins with a bfloat16 wh
    (no launch counted): h, c, dpre and dcn equal to the rounding rule
    written out step by step, to float32 summation order, in both walk
    directions."""
    t, b, h = 7, 3, 8
    args, dh = _inputs(11, t, b, h)
    a = [torch.from_numpy(x) for x in args]
    a[3], a[4] = a[3].to(BF16), a[4].to(BF16)
    dhs = [torch.from_numpy(x) for x in dh]
    wrappers = (LN.bi_ln_lstm, LN.bi_ln_lstm_bwd, LN.ln_lstm, LN.ln_lstm_bwd)
    before = _counts(*wrappers)
    hc = LN.bi_ln_lstm(*a)
    d = LN.bi_ln_lstm_bwd(*a, *hc, *dhs)
    uni = _uni(a)
    h_u, c_u = LN.ln_lstm(*uni)
    d_u = LN.ln_lstm_bwd(*uni, h_u, c_u, dhs[0])
    assert _counts(*wrappers) == before
    for i in range(2):
        want = _ln_reference(a[i], a[2], a[3 + i].float(), a[5 + i],
                             a[7 + i], a[9 + i], dhs[i], True,
                             reverse=i == 1)
        got = (hc[2 * i], hc[2 * i + 1], d[2 * i], d[2 * i + 1])
        for g, ref, name in zip(got, want, ("h", "c", "dpre", "dcn")):
            assert g.dtype == torch.float32, name
            torch.testing.assert_close(g, ref, **TWIN_TOL, msg=name)
        if i == 0:
            for g, ref in zip((h_u, c_u, *d_u), want):
                torch.testing.assert_close(g, ref, **TWIN_TOL)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_bf16_ln_param_grads_match_jax(reverse):
    """_ln_param_grads with a bfloat16 wh against the JAX _ln_param_grads
    with one: the hp of the h side's statistics is the float32 product of
    the UNROUNDED h_prev and wh's bfloat16 values (the JAX einsum
    promotes), dwh comes back bfloat16; dgh, dgc and dbc to float32
    summation order, dwh within GRAD_FRAC of its max; and the hp written
    out: float32 h_prev @ bf16(wh) (never bf16(h_prev))."""
    t, b, h = 9, 3, 8
    args, _ = _inputs(13, t, b, h)
    rng = np.random.RandomState(14)
    dpre = rng.randn(t, b, 4 * h).astype(np.float32)
    dcn = rng.randn(t, b, h).astype(np.float32)
    hs = rng.randn(t, b, h).astype(np.float32)
    cs = rng.randn(t, b, h).astype(np.float32)
    wh, gh = args[3], args[5]
    zero = np.zeros((1, b, h), np.float32)
    h_prev = (np.concatenate([hs[1:], zero]) if reverse
              else np.concatenate([zero, hs[:-1]]))
    J = jnp.asarray
    want = jln._ln_param_grads(J(dpre), J(dcn), J(h_prev), J(cs),
                               J(wh).astype(jnp.bfloat16), J(gh), h, h)
    T = torch.from_numpy
    w16 = T(wh).to(BF16)
    got = LN._ln_param_grads(T(dpre), T(dcn), T(hs), T(cs), w16, T(gh),
                             reverse)
    for name, g, w in zip(("dwh", "dgh", "dgc", "dbc"), got, want):
        if name == "dwh":
            assert g.dtype == BF16 and w.dtype == jnp.bfloat16
            _close_frac(g.float().numpy(), w.astype(jnp.float32),
                        frac=GRAD_FRAC, what=name)
            continue
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # dgh written out from the unrounded h_prev
    hp = (T(h_prev).reshape(-1, h) @ w16.float()).view(-1, 4, h)
    xhat, _ = _stats(hp)
    dgh = (T(dpre).reshape(-1, 4, h) * xhat).sum(dim=0).reshape(4 * h)
    torch.testing.assert_close(got[1], dgh, **TWIN_TOL)


def _gpu_case(t, b, h, seed):
    """tests/test_torch_gpu.py's _ln_case on the CPU (its draws in its
    order), wh bfloat16: the LN op's arguments and the cotangents."""
    g = torch.Generator().manual_seed(seed)

    def near(n, centre):
        return centre + 0.3 * torch.randn(n, generator=g)

    xpn = [torch.randn(t, b, 4 * h, generator=g) for _ in range(2)]
    wh = [torch.randn(h, 4 * h, generator=g) / h ** 0.5 for _ in range(2)]
    gh = [near(4 * h, 1.0) for _ in range(2)]
    gc = [near(h, 1.0) for _ in range(2)]
    bc = [near(h, 0.0) for _ in range(2)]
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[0] = t
    mask = (torch.arange(t)[:, None] < lengths[None, :]).float()[..., None]
    dh = [torch.randn(t, b, h, generator=g) for _ in range(2)]
    return ([xpn[0], xpn[1], mask, wh[0].to(BF16), wh[1].to(BF16), gh[0],
             gh[1], gc[0], gc[1], bc[0], bc[1]], dh)


@pytest.mark.parametrize("seed", [3, 4])
def test_ln_bf16_backward_spread_is_within_the_card_tolerances(monkeypatch,
                                                               seed):
    """The card holds the LN bf16 backward against its twin per (frame,
    row) of a chain's first LN_CHECK_T steps within LN_BF16_ROW_RTOL of the
    row's norm and dwh within LN_BF16_DWH_FRAC of its max (chip_smoke.py,
    tests/test_torch_gpu.py), not at BF16_RTOL: the twin itself, its
    products summed in float64 parts (another summation order), moves by
    more than BF16_RTOL there, from bfloat16 roundings of dhp that flip,
    and by less than those tolerances.  At the card's check shapes H=256,
    B=32, T=LN_CHECK_T, both directions."""
    from chip_smoke import (BF16_RTOL, LN_BF16_DWH_FRAC, LN_BF16_ROW_RTOL,
                            LN_CHECK_T)

    args, dh = _gpu_case(LN_CHECK_T, 32, 256, seed)
    hc = LN.bi_ln_lstm_plain(*args)
    want = LN.bi_ln_lstm_bwd_plain(*args, *hc, *dh)
    matmul = torch.matmul
    monkeypatch.setattr(torch, "matmul", lambda x, y: matmul(
        x.double(), y.double()).float())
    got = LN.bi_ln_lstm_bwd_plain(*args, *hc, *dh)
    monkeypatch.undo()
    rows = max(float(((k - p).norm(dim=-1) / p.norm(dim=-1).clamp(
        min=1e-30)).max()) for k, p in zip(got, want))
    assert BF16_RTOL < rows < LN_BF16_ROW_RTOL
    for i in range(2):
        k, p = (LN._ln_param_grads(d[2 * i], d[2 * i + 1], hc[2 * i],
                                   hc[2 * i + 1], args[3 + i], args[5 + i],
                                   i == 1)[0].float() for d in (got, want))
        assert float((k - p).abs().max()) < LN_BF16_DWH_FRAC * float(
            p.abs().max())


# -- (c) float32 unchanged ----------------------------------------------------

@pytest.mark.parametrize("ndir", [2, 1], ids=["bi", "uni"])
def test_float32_ln_unchanged(ndir):
    """With float32 weights the LN wrappers' maths is the parent's bit for
    bit: h, c, dpre, dcn and _ln_param_grads' dwh against the products
    written as ``@``."""
    t, b, h = 9, 3, 8
    args, dh = _inputs(16, t, b, h)
    a = [torch.from_numpy(x) for x in args]
    dhs = [torch.from_numpy(x) for x in dh]
    if ndir == 2:
        hc = LN.bi_ln_lstm(*a)
        ds = LN.bi_ln_lstm_bwd(*a, *hc, *dhs)
    else:
        hc = LN.ln_lstm(*_uni(a))
        ds = LN.ln_lstm_bwd(*_uni(a), *hc, dhs[0])
    for i in range(ndir):
        want = _ln_reference(a[i], a[2], a[3 + i], a[5 + i], a[7 + i],
                             a[9 + i], dhs[i], False, reverse=i == 1)
        got = (hc[2 * i], hc[2 * i + 1], ds[2 * i], ds[2 * i + 1])
        for g, ref in zip(got, want):
            assert torch.equal(g, ref)
        dwh = LN._ln_param_grads(want[2], want[3], want[0], want[1],
                                 a[3 + i], a[5 + i], i == 1)[0]
        h_prev = prev(want[0], i == 1).reshape(-1, h)
        xhat, rstd = _stats((h_prev @ a[3 + i]).view(-1, 4, h))
        dhp = LN._ln_bwd(want[2].reshape(-1, 4, h) * a[5 + i].view(4, h),
                         xhat, rstd)
        assert dwh.dtype == torch.float32
        assert torch.equal(dwh, h_prev.t() @ dhp.reshape(-1, 4 * h))


# -- (d) the train step -------------------------------------------------------

LN_STEP_CASES = {
    "ln_blstm": "num_hiddens=8,num_layers=2,dropout=0.0",
    "ln_blstm_uni": "num_hiddens=8,num_layers=1,dropout=0.0,"
                    "bidirectional=false",
}


def check_ln_train_step(monkeypatch, hp, b=3):
    """One sgd step (momentum 0.9 from zeros: the JAX gradient is (p0 - p1)
    / lr) of ln_blstm with ``hp`` on ``b`` rows of T=17 from the same
    weights against the JAX bf16 Trainer on its Pallas route: the loss
    within LOSS_RTOL, every parameter's gradient (the cast's autograd hands
    the float32 master a bfloat16-representable gradient of the loss sum,
    divided by the weight sum after it) within GRAD_FRAC of its max,
    float32 masters and optimizer state afterwards."""
    monkeypatch.setattr(jrnn, "RNN_BACKEND", "pallas")
    batch = _batch(b=b, t=T_JAX)
    lr = 0.1
    spec = ("sgd", lr, 400.0)
    jm = jzoo.ln_blstm(hp, num_classes=CLASSES)
    jt = jtrainer.Trainer(jm, jtrainer.make_optimizer(*spec),
                          donate_state=False, compute_dtype=jnp.bfloat16)
    js = jt.init_state(jax.random.PRNGKey(0), FEATS)
    p0 = flatten_params(js.params)
    pm = build_model("ln_blstm", hp, num_classes=CLASSES, input_dim=FEATS,
                     generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(params_from_flat(p0))
    trainer = Trainer(pm, make_optimizer(*spec), compute_dtype=BF16)
    state = trainer.init_state()
    probe = Trainer(copy.deepcopy(pm), make_optimizer(*spec),
                    compute_dtype=BF16)
    tb = list(map(torch.from_numpy, batch))
    logits = probe._forward_cast(probe.model, tb[0], tb[1],
                                 torch.Generator().manual_seed(1))
    loss_sum, w_sum = probe._loss_sum(logits, *tb[1:])
    loss_sum.backward()
    sum_grads = dict(probe.model.named_parameters())
    js1, jmet = jt.train_step(js, *map(jnp.asarray, batch),
                              jax.random.PRNGKey(1))
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


@pytest.mark.parametrize("case", list(LN_STEP_CASES))
def test_bf16_ln_train_step_matches_jax(monkeypatch, case):
    """check_ln_train_step of ln_blstm, bi and uni, at B=3 (the cluster
    design)."""
    check_ln_train_step(monkeypatch, LN_STEP_CASES[case])


# -- (e) the eval step --------------------------------------------------------

def test_bf16_ln_eval_step_is_float32():
    """The eval step does not cast: a bfloat16 trainer's eval equals a
    float32 trainer's on the same weights, bit for bit."""
    pm = build_model("ln_blstm", "num_hiddens=8,num_layers=2,dropout=0.0",
                     num_classes=CLASSES, input_dim=FEATS,
                     generator=torch.Generator().manual_seed(0))
    batch = list(map(torch.from_numpy, _batch(1)))
    outs = []
    for dtype in (BF16, None):
        tr = Trainer(pm, make_optimizer(), compute_dtype=dtype)
        outs.append(tr.eval_step(tr.init_state(), *batch))
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


# -- (f) the CLI --------------------------------------------------------------

@pytest.fixture(scope="module")
def dummy(tmp_path_factory):
    """A manifest of the dummy corpus (16 utterances of 0.5-0.8 s: T of 50
    to 80 frames, where the LN recurrence's drift stays small, ROADMAP
    C2)."""
    d = tmp_path_factory.mktemp("dummy")
    m = str(d / "m.json")
    assert port_make_dataset.main(["--parser", "dummy", "--dataset_dir",
                                   str(d / "corpus"), "--to_json", m]) == 0
    return m


def _losses(run):
    with open(os.path.join(run, "train_metrics.csv")) as f:
        rows = [line.split(",") for line in f.read().splitlines()]
    col = rows[0].index("loss")
    with open(os.path.join(run, "meta.json")) as f:
        assert json.load(f)["hparams"]["bf16"] is True
    return [float(r[col]) for r in rows[1:] if r[col]]


def test_train_bf16_ln_matches_jax_losses(tmp_path, monkeypatch, dummy):
    """train --bf16 --model ln_blstm (no longer refused) on the dummy
    corpus, a small ln_blstm from the JAX CLI's initial weights
    (--init_from a port run holding them), gives the JAX CLI's per-step
    --bf16 losses, the JAX side on its Pallas route."""
    monkeypatch.setattr(jrnn, "RNN_BACKEND", "pallas")
    hp = "num_hiddens=8,num_layers=2,dropout=0.0"
    argv = ["--dataset", dummy, "--model", "ln_blstm", "--params", hp,
            "--batch_size", "8", "--num_devices", "1", "--log_every", "1",
            "--epochs", "1", "--bf16"]
    jrun = str(tmp_path / "jax")
    assert jax_train.main([*argv, "--platform", "cpu", "--save", jrun]) == 0
    params = jzoo.ln_blstm(hp, num_classes=27).init(jax.random.PRNGKey(0),
                                                    39)
    pm = build_model("ln_blstm", hp, num_classes=27, input_dim=39)
    pm.load_state_dict(params_from_flat(flatten_params(params)))
    init = str(tmp_path / "init")
    CheckpointManager(init).save(Trainer(pm, make_optimizer()).init_state())
    prun = str(tmp_path / "port")
    assert port_train.main([*argv, "--device", "cpu", "--save", prun,
                            "--init_from", init]) == 0
    got, want = _losses(prun), _losses(jrun)
    assert len(want) == 2
    # the first step's loss (a forward from the same weights) at rtol 1e-4,
    # as test_train_bf16_matches_jax_losses holds the other cells' runs;
    # the second at LOSS_RTOL: the LN backward's bfloat16 rounding flips
    # (see FLIP_FRAC), which this recurrence amplifies (ROADMAP C2), leave
    # the two packages' first gradients about 1e-2 of their max apart here
    # (measured 2.2e-4 on the second loss)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


# -- (g) the stream design ----------------------------------------------------

def _stream_inputs(seed, t, b, h):
    """What _inputs gives, for any B: the mask holds the last row after its
    first frame."""
    args, dh = _inputs(seed, t, 1, h)
    rng = np.random.RandomState(seed + 1)
    xpn = [rng.randn(t, b, 4 * h).astype(np.float32) for _ in range(2)]
    lengths = np.full(b, t)
    lengths[-1] = 1
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(
        np.float32)[..., None]
    dh = [rng.randn(t, b, h).astype(np.float32) for _ in range(2)]
    return (xpn[0], xpn[1], mask, *args[3:]), dh


def _ln_counts():
    return [(op.launches, dict(op.by_design))
            for op in (LN.bi_ln_lstm, LN.ln_lstm, LN.bi_ln_lstm_bwd,
                       LN.ln_lstm_bwd)]


@pytest.mark.parametrize("hidden,batch,ndir", [(300, 2, 1), (512, 3, 2),
                                               (100, 49, 2)])
def test_ln_stream_design_refuses_bf16(hidden, batch, ndir):
    """At a shape that ln_geometry sends to the stream design (H > 256, or
    a batch past the cluster budget) a bfloat16 call runs, forward and
    backward: on the CPU the plain twin of the stream design's bfloat16
    forms, no launch counted, nothing refused and no float32 form taken.
    check_ln_parity there: h and every gradient of the Functions against
    the JAX Pallas ops with a bfloat16 wh in interpret mode, at T=2 with a
    held frame, dpre as _close_walk_start holds it."""
    assert LN.ln_geometry(hidden, batch, ndir).design == "stream"
    before = _ln_counts()
    check_ln_parity(ndir, hidden,
                    *_stream_inputs(hidden + batch + ndir, 2, batch, hidden),
                    walk_start=True)
    assert _ln_counts() == before
