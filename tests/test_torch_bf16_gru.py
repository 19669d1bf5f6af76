"""bf16 compute of the GRU (``train --bf16 --model deep_gru``) on the CPU,
held against the JAX package: ``BiGRUFunction`` and ``GRUFunction`` with a
bfloat16 ``wh`` (the plain twins of the GRU kernels' bfloat16-weight
forms) against ``pallas_bigru`` / ``pallas_gru`` with one in interpret
mode, at the cluster, wide and stream designs' shapes,
``Trainer(compute_dtype=torch.bfloat16)`` steps of ``deep_gru`` against the
JAX ``Trainer(compute_dtype=jnp.bfloat16)`` on its Pallas route
(``RNN_BACKEND = "pallas"``, as ``tests/test_torch_bf16.py`` runs the
LSTM's), at batches of the cluster and stream designs, and the float32
recurrence unchanged bit for bit."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_study_torch.models.zoo import build_model
from asr_study_torch.ops import gru as G
from asr_study_torch.ops.recurrence import prev
from asr_study_torch.train.trainer import Trainer, make_optimizer
from asr_study_torch.utils.weights import params_from_flat
from asr_study_tpu.models import rnn as jrnn
from asr_study_tpu.models import zoo as jzoo
from asr_study_tpu.ops import pallas_bigru as jbi
from asr_study_tpu.ops import pallas_gru as jg
from asr_study_tpu.train import trainer as jtrainer
from extras.export_weights import _flatten as flatten_params
from tests.test_torch_bf16 import (CLASSES, FEATS, GRAD_FRAC, LOSS_RTOL,
                                   _batch, _bf16_exact, _close_frac,
                                   _close_with_flips, _stream_inputs)

BF16 = torch.bfloat16
def _gru_inputs(seed, t, b, h):
    """xp_f, xp_b [T,B,3H], a mask with held frames [T,B,1], wh_f, wh_b
    [H,3H] float32, and the cotangents of h_f, h_b."""
    rng = np.random.RandomState(seed)
    xp_f, xp_b = (rng.randn(t, b, 3 * h).astype(np.float32)
                  for _ in range(2))
    lengths = np.array([t, t - 3, t // 2][:b])
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    wh_f, wh_b = ((rng.randn(h, 3 * h) / np.sqrt(h)).astype(np.float32)
                  for _ in range(2))
    dh_f, dh_b = (rng.randn(t, b, h).astype(np.float32) for _ in range(2))
    return xp_f, xp_b, mask[..., None], wh_f, wh_b, dh_f, dh_b


@pytest.mark.parametrize("h", [8, 16])
@pytest.mark.parametrize("ndir", [2, 1], ids=["bi", "uni"])
def test_gru_with_bf16_wh_matches_pallas(ndir, h):
    """h, dxp and dwh (bfloat16, as the JAX VJP's ``astype(wh.dtype)``) of
    BiGRUFunction / GRUFunction with a bfloat16 wh against pallas_bigru /
    pallas_gru with one, in interpret mode, at T=12, B=3 with held frames;
    dxp float32."""
    t, b = 12, 3
    xp_f, xp_b, mask, wh_f, wh_b, dh_f, dh_b = _gru_inputs(h + 1, t, b, h)
    J = jnp.asarray

    def jax_loss(xf, xb, wf, wb):
        if ndir == 2:
            hf, hb = jbi.pallas_bigru(xf, xb, J(mask), wf, wb, h,
                                      interpret=True)
            return jnp.sum(hf * J(dh_f)) + jnp.sum(hb * J(dh_b)), (hf, hb)
        hf = jg.pallas_gru(xf, J(mask), wf, h, interpret=True)
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
        hs = G.BiGRUFunction.apply(xf, xb, T(mask), wf, wb)
        loss = (hs[0] * T(dh_f)).sum() + (hs[1] * T(dh_b)).sum()
        pairs = ((xf, g_j[0]), (xb, g_j[1]))
        weights = ((wf, g_j[2]), (wb, g_j[3]))
    else:
        hs = (G.GRUFunction.apply(xf, T(mask), wf),)
        loss = (hs[0] * T(dh_f)).sum()
        pairs, weights = ((xf, g_j[0]),), ((wf, g_j[2]),)
    loss.backward()
    for got, want in zip(hs, hs_j):
        assert got.dtype == torch.float32
        _close_with_flips(got.detach().numpy(), want, "h")
    for xt, g in pairs:
        assert xt.grad.dtype == torch.float32
        _close_with_flips(xt.grad.numpy(), g, "dxp")
    for wt, g in weights:
        assert wt.grad.dtype == BF16 and g.dtype == jnp.bfloat16
        _close_frac(wt.grad.float().numpy(), g.astype(jnp.float32),
                    frac=GRAD_FRAC, what="dwh")


def _reference(xp, mask, wh, dh, rounded, reverse=False):
    """One direction's recurrence and cotangent walk written out step by
    step -> (h, dxp, dhp); with ``rounded`` the products take
    ``bf16(h_prev) @ bf16(wh)`` and ``bf16(dhp) @ bf16(wh)^T`` while the
    cell's ``z * h_prev`` and the walk's dhp stay unrounded, else plain
    ``@`` (the float32 maths before bfloat16 weights)."""
    rnd = ((lambda t: t.to(BF16).float()) if rounded
           else (lambda t: t))
    w = rnd(wh)
    t_steps, batch, gh = xp.shape
    order = list(reversed(range(t_steps))) if reverse else list(range(
        t_steps))
    h = torch.zeros(batch, gh // 3)
    hs = [None] * t_steps
    for t in order:
        hr, hz, hn = (rnd(h) @ w).chunk(3, -1)
        xr, xz, xn = xp[t].chunk(3, -1)
        r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = torch.where(mask[t] > 0, (1.0 - z) * n + z * h, h)
        hs[t] = h
    hseq = torch.stack(hs)
    hp = prev(hseq, reverse)
    dxp, dhp = torch.zeros_like(xp), torch.zeros_like(xp)
    dh_next = torch.zeros(batch, gh // 3)
    for t in reversed(order):
        m = mask[t] > 0
        hr, hz, hn = (rnd(hp[t]) @ w).chunk(3, -1)
        xr, xz, xn = xp[t].chunk(3, -1)
        r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        d = dh[t] + dh_next
        dpre_n = d * (1.0 - z) * (1.0 - n * n)
        dpre_r = dpre_n * hn * r * (1.0 - r)
        dpre_z = d * (hp[t] - n) * z * (1.0 - z)
        dxp[t] = torch.where(m, torch.cat([dpre_r, dpre_z, dpre_n], -1), 0.0)
        dhp[t] = torch.where(m, torch.cat([dpre_r, dpre_z, dpre_n * r], -1),
                             0.0)
        dh_next = rnd(dhp[t]) @ w.t() + torch.where(m, d * z, d)
    return hseq, dxp, dhp


@pytest.mark.parametrize("hidden", [8, 300], ids=["cluster", "wide"])
def test_bf16_gru_twins_round_where_the_kernels_do(hidden):
    """On the CPU the wrappers take their plain twins with a bfloat16 wh (no
    launch counted), in the cluster and in the wide design's wiring (the
    backward from the forward's kept h side): h, dxp and dhp equal to the
    rounding rule written out step by step, to float32 summation order."""
    t, b = 6, 3
    xp_f, _, mask, wh_f, _, dh_f, _ = _gru_inputs(4, t, b, hidden)
    xp, m, dh = map(torch.from_numpy, (xp_f, mask, dh_f))
    wh = torch.from_numpy(wh_f).to(BF16)
    geo = G.gru_geometry(hidden, b, 1)
    assert geo.design == ("cluster" if hidden == 8 else "wide")
    before = (G.gru.launches, dict(G.gru.by_design), G.gru_bwd.launches)
    h, res = G.gru(xp, m, wh, residual=True)
    dxp, dhp = G.gru_bwd(xp, m, wh, h, dh, res)
    assert (G.gru.launches, G.gru.by_design, G.gru_bwd.launches) == before
    assert len(res) == (1 if geo.design == "wide" else 0)
    want = _reference(xp, m, wh.float(), dh, rounded=True)
    for got, ref, name in zip((h, dxp, dhp), want, ("h", "dxp", "dhp")):
        assert got.dtype == torch.float32, name
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5,
                                   msg=name)


@pytest.mark.parametrize("ndir", [2, 1], ids=["bi", "uni"])
def test_float32_gru_unchanged(ndir):
    """With float32 weights the GRU wrappers' maths is the parent's bit for
    bit: h, dxp, dhp and dwh against the products written as ``@``."""
    t, b, h = 9, 3, 8
    xp_f, xp_b, mask, wh_f, wh_b, dh_f, dh_b = _gru_inputs(7, t, b, h)
    T = torch.from_numpy
    xs, ws, dhs = ([T(xp_f), T(xp_b)][:ndir], [T(wh_f), T(wh_b)][:ndir],
                   [T(dh_f), T(dh_b)][:ndir])
    m = T(mask)
    if ndir == 2:
        hs = G.bigru(*xs, m, *ws)
        ds = G.bigru_bwd(*xs, m, *ws, *hs, *dhs)
    else:
        hs = (G.gru(xs[0], m, ws[0]),)
        ds = G.gru_bwd(xs[0], m, ws[0], hs[0], dhs[0])
    for i in range(ndir):
        want = _reference(xs[i], m, ws[i], dhs[i], rounded=False,
                          reverse=i == 1)
        for got, ref in zip((hs[i], ds[2 * i], ds[2 * i + 1]), want):
            assert torch.equal(got, ref)
        hp = prev(want[0], i == 1)
        assert torch.equal(G._dwh(want[0], want[2], i == 1, ws[i]),
                           hp.reshape(-1, h).t() @ want[2].reshape(-1, 3 * h))


# -- the train step ----------------------------------------------------------

# (hparams, batch): the cluster design's batch (B=3), and B=50 in two
# directions, the stream design's
GRU_STEP_CASES = {
    "deep_gru": ("num_hiddens=8,num_layers=2,dropout=0.0", 3),
    "deep_gru_uni": ("num_hiddens=8,num_layers=1,dropout=0.0,"
                     "bidirectional=false", 3),
    "deep_gru_b50": ("num_hiddens=8,num_layers=2,dropout=0.0", 50),
}


@pytest.mark.parametrize("case", list(GRU_STEP_CASES))
def test_bf16_gru_train_step_matches_jax(monkeypatch, case):
    """One sgd step of deep_gru (momentum 0.9 from zeros: the JAX gradient
    is (p0 - p1) / lr) from the same weights: the loss, every parameter's
    gradient (the cast's autograd hands the float32 master a bfloat16-
    representable gradient of the loss sum, divided by the weight sum
    after it), float32 masters and optimizer state afterwards."""
    monkeypatch.setattr(jrnn, "RNN_BACKEND", "pallas")
    hp, b = GRU_STEP_CASES[case]
    lr = 0.1
    spec = ("sgd", lr, 400.0)
    jm = jzoo.deep_gru(hp, num_classes=CLASSES)
    jt = jtrainer.Trainer(jm, jtrainer.make_optimizer(*spec),
                          donate_state=False, compute_dtype=jnp.bfloat16)
    js = jt.init_state(jax.random.PRNGKey(0), FEATS)
    p0 = flatten_params(js.params)
    pm = build_model("deep_gru", hp, num_classes=CLASSES, input_dim=FEATS,
                     generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(params_from_flat(p0))
    trainer = Trainer(pm, make_optimizer(*spec), compute_dtype=BF16)
    state = trainer.init_state()
    batch = _batch(b=b)
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


def test_bf16_gru_eval_step_is_float32():
    """The eval step does not cast: a bfloat16 deep_gru trainer's eval
    equals a float32 trainer's on the same weights, bit for bit."""
    pm = build_model("deep_gru", GRU_STEP_CASES["deep_gru"][0],
                     num_classes=CLASSES, input_dim=FEATS,
                     generator=torch.Generator().manual_seed(0))
    batch = list(map(torch.from_numpy, _batch(1)))
    outs = []
    for dtype in (BF16, None):
        tr = Trainer(pm, make_optimizer(), compute_dtype=dtype)
        outs.append(tr.eval_step(tr.init_state(), *batch))
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


# -- the stream design -------------------------------------------------------

@pytest.mark.parametrize("hidden,batch,ndir", [(520, 2, 1), (512, 97, 1),
                                               (512, 49, 2)])
def test_gru_stream_design_refuses_bf16(hidden, batch, ndir):
    """At a shape that gru_geometry sends to the stream design a bfloat16
    GRU call runs (on the CPU the plain twin of the stream design's
    bfloat16 forms, no launch counted; nothing refuses or takes float32):
    h, dxp and dwh of BiGRUFunction / GRUFunction against pallas_bigru /
    pallas_gru with a bfloat16 wh in interpret mode, at T=4 with held
    frames."""
    assert G.gru_geometry(hidden, batch, ndir).design == "stream"
    t = 4
    xp_f, xp_b, mask, wh_f, wh_b, dh_f, dh_b = _stream_inputs(
        hidden + batch + 1, t, batch, hidden, 3)
    J = jnp.asarray

    def jax_loss(xf, xb, wf, wb):
        if ndir == 2:
            hf, hb = jbi.pallas_bigru(xf, xb, J(mask), wf, wb, hidden,
                                      interpret=True)
            return jnp.sum(hf * J(dh_f)) + jnp.sum(hb * J(dh_b)), (hf, hb)
        hf = jg.pallas_gru(xf, J(mask), wf, hidden, interpret=True)
        return jnp.sum(hf * J(dh_f)), (hf,)

    (_, hs_j), g_j = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3),
                                        has_aux=True)(
        J(xp_f), J(xp_b), J(wh_f).astype(jnp.bfloat16),
        J(wh_b).astype(jnp.bfloat16))
    T = torch.from_numpy
    xf, xb = T(xp_f).requires_grad_(), T(xp_b).requires_grad_()
    wf = T(wh_f).to(BF16).requires_grad_()
    wb = T(wh_b).to(BF16).requires_grad_()
    ops = (G.bigru, G.bigru_bwd, G.gru, G.gru_bwd)
    before = [(op.launches, dict(op.by_design)) for op in ops]
    if ndir == 2:
        hs = G.BiGRUFunction.apply(xf, xb, T(mask), wf, wb)
        loss = (hs[0] * T(dh_f)).sum() + (hs[1] * T(dh_b)).sum()
        pairs, weights = ((xf, g_j[0]), (xb, g_j[1])), ((wf, g_j[2]),
                                                        (wb, g_j[3]))
    else:
        hs = (G.GRUFunction.apply(xf, T(mask), wf),)
        loss = (hs[0] * T(dh_f)).sum()
        pairs, weights = ((xf, g_j[0]),), ((wf, g_j[2]),)
    loss.backward()
    assert [(op.launches, op.by_design) for op in ops] == before
    for got, want in zip(hs, hs_j):
        assert got.dtype == torch.float32
        _close_with_flips(got.detach().numpy(), want, "h")
    for xt, g in pairs:
        assert xt.grad.dtype == torch.float32
        _close_with_flips(xt.grad.numpy(), g, "dxp")
    for wt, g in weights:
        assert wt.grad.dtype == BF16 and g.dtype == jnp.bfloat16
        _close_frac(wt.grad.float().numpy(), g.astype(jnp.float32),
                    frac=GRAD_FRAC, what="dwh")
