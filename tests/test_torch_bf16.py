"""bf16 compute (``train --bf16``, the JAX trainer's ``compute_dtype``) of
the port on the CPU, held against the JAX package: ``models.nn.dot`` and
``dense_apply`` against ``cells._dot`` and ``nn.dense_apply`` under the
cast, the LSTM recurrence with bfloat16 ``wh`` (``BiLSTMFunction``,
``LSTMFunction``: the plain twins of the kernels' bfloat16-weight forms)
against ``pallas_bilstm`` / ``pallas_lstm`` with a bfloat16 ``wh`` in
interpret mode, at the cluster design's shapes and at the stream
design's, and ``Trainer(compute_dtype=torch.bfloat16)`` steps against the
JAX ``Trainer(compute_dtype=jnp.bfloat16)`` on the Pallas route, at
batches of both designs; the refusals of the layer-norm LSTM's stream
design, which has no bfloat16 kernels, and of a cell outside the
Trainer's BF16_CELLS (the GRU's bfloat16 forms:
``tests/test_torch_bf16_gru.py``; the zoneout and MI LSTMs':
``tests/test_torch_bf16_zoneout_mi.py``; the layer-norm LSTM's:
``tests/test_torch_bf16_ln.py``).

The JAX ``lax.scan`` default rounds the recurrent cotangent after its
product where the Pallas backward rounds ``dpre`` before it; the TPU runs
the Pallas kernels, so the port follows them and the JAX side here runs
with ``RNN_BACKEND = "pallas"`` (read at call time)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_study_torch.models.cells import (GRUCell, LayerNormLSTMCell,
                                          LSTMCell, MILSTMCell,
                                          ZoneoutLSTMCell)
from asr_study_torch.models.nn import dense_apply, dot
from asr_study_torch.models.zoo import CELL_KINDS, build_model
from asr_study_torch.ops import bilstm as B
from asr_study_torch.ops.ln_lstm import bi_ln_lstm, ln_lstm
from asr_study_torch.train.trainer import Trainer, make_optimizer
from asr_study_torch.utils.weights import params_from_flat
from asr_study_tpu.models import cells as jcells
from asr_study_tpu.models import nn as jnn
from asr_study_tpu.models import rnn as jrnn
from asr_study_tpu.models import zoo as jzoo
from asr_study_tpu.ops import pallas_bilstm as jbi
from asr_study_tpu.ops import pallas_lstm as jl
from asr_study_tpu.train import trainer as jtrainer
from extras.export_weights import _flatten as flatten_params

BF16 = torch.bfloat16
# values of float32 results from bfloat16 operands: the same products,
# summed in another order (measured max 2.4e-7 at these sizes)
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
# a gradient that reaches a bfloat16 weight is rounded to bfloat16 after a
# float32 sum whose order differs between the packages, so an element may
# sit one bfloat16 ulp (2^-8 relative) apart: held within 1e-2 of the
# tensor's max abs (measured max 5.3e-3)
GRAD_FRAC = 1e-2
# one train step's loss (measured: equal to the last bit)
LOSS_RTOL = 1e-3
# The packages sum h_prev @ wh in other orders, so an h_prev within a
# float32 ulp of a bfloat16 rounding boundary may round apart: one product
# then moves by a bfloat16 ulp of its operand and the recurrence carries
# the difference for a few steps (measured for the GRU at bi H=16, where
# one such flip gives 1.9e-5 on h and 1.4e-4 on dxp, |dxp| up to 3.5;
# 1.5e-7 and 4.8e-7, VALUE_TOL's order, in the other cases; for the LSTM
# at H=512, B=97, T=4, 0.09% of h beyond VALUE_TOL, by up to 1.9e-4).  So
# at the stream design's shapes, and for the GRU everywhere, every element
# is held within FLIP_ATOL + VALUE_TOL's rtol, and all but FLIP_SHARE of
# them within VALUE_TOL: a rounding in the wrong place (h_prev rounded in
# the state update or the GRU's z * h_prev, dpre or dhp not rounded before
# its product) moves most elements by about 1e-3.
FLIP_ATOL = 1e-3
FLIP_SHARE = 0.05


def _close_with_flips(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want)
    tight = VALUE_TOL["atol"] + VALUE_TOL["rtol"] * np.abs(want)
    assert (err <= FLIP_ATOL + VALUE_TOL["rtol"] * np.abs(want)).all(), (
        f"{what}: max err {err.max():.3e}")
    share = float((err > tight).mean())
    assert share <= FLIP_SHARE, f"{what}: {share:.3f} of the elements " \
                                f"beyond VALUE_TOL (max err {err.max():.3e})"


def _bf16_exact(t: torch.Tensor) -> bool:
    """Every element is representable in bfloat16."""
    return torch.equal(t.to(BF16).float(), t.float())


def _close_frac(got, want, frac=GRAD_FRAC, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= frac * scale, f"{what}: {err:.3e} > {frac} * {scale:.3e}"


# -- dot and dense_apply -----------------------------------------------------

@pytest.mark.parametrize("kind", ["dot", "dense_apply"])
def test_dot_and_dense_match_jax_under_the_cast(kind):
    rng = np.random.RandomState(3)
    x = rng.randn(4, 3, 10).astype(np.float32)
    w = rng.randn(10, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    cot = rng.randn(4, 3, 6).astype(np.float32)

    def jax_fn(x_, w_, b_):
        wb, bb = w_.astype(jnp.bfloat16), b_.astype(jnp.bfloat16)
        y = (jcells._dot(x_, wb) if kind == "dot"
             else jnn.dense_apply({"w": wb, "b": bb}, x_))
        return jnp.sum(y * jnp.asarray(cot)), y

    (_, y_j), g_j = jax.value_and_grad(jax_fn, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = (dot(xt, wt.to(BF16)) if kind == "dot"
         else dense_apply({"w": wt.to(BF16), "b": bt.to(BF16)}, xt))
    (y * torch.from_numpy(cot)).sum().backward()
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               **VALUE_TOL)
    for name, t, g in (("x", xt, g_j[0]), ("w", wt, g_j[1]),
                       ("b", bt, g_j[2])):
        if kind == "dot" and name == "b":
            assert t.grad is None
            continue
        assert t.grad.dtype == torch.float32 and _bf16_exact(t.grad), name
        _close_frac(t.grad.numpy(), g, what=name)
    # float32 weights: plain x @ w, bit for bit
    x32, w32 = torch.from_numpy(x), torch.from_numpy(w)
    assert torch.equal(dot(x32, w32), x32 @ w32)


# -- the recurrence with bfloat16 wh -----------------------------------------

def _rnn_inputs(seed, t, b, h):
    """xp_f, xp_b [T,B,4H], a mask with held frames [T,B,1], wh_f, wh_b
    [H,4H] float32, and the cotangents of h_f, h_b."""
    rng = np.random.RandomState(seed)
    xp_f, xp_b = (rng.randn(t, b, 4 * h).astype(np.float32)
                  for _ in range(2))
    lengths = np.array([t, t - 3, t // 2][:b])
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    wh_f, wh_b = ((rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)
                  for _ in range(2))
    dh_f, dh_b = (rng.randn(t, b, h).astype(np.float32) for _ in range(2))
    return xp_f, xp_b, mask[..., None], wh_f, wh_b, dh_f, dh_b


@pytest.mark.parametrize("h", [8, 16])
@pytest.mark.parametrize("ndir", [2, 1], ids=["bi", "uni"])
def test_recurrence_with_bf16_wh_matches_pallas(ndir, h):
    """h, dxp and dwh (bfloat16, as the JAX VJP's ``astype(wh.dtype)``) of
    the port's Functions with a bfloat16 wh against the Pallas kernels with
    one, in interpret mode, at T=12, B=3 with held frames."""
    t, b = 12, 3
    xp_f, xp_b, mask, wh_f, wh_b, dh_f, dh_b = _rnn_inputs(h, t, b, h)
    J = jnp.asarray

    def jax_loss(xf, xb, wf, wb):
        if ndir == 2:
            hf, hb = jbi.pallas_bilstm(xf, xb, J(mask), wf, wb, h,
                                       interpret=True)
            return jnp.sum(hf * J(dh_f)) + jnp.sum(hb * J(dh_b)), (hf, hb)
        hf = jl.pallas_lstm(xf, J(mask), wf, h, interpret=True)
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
        hs = B.BiLSTMFunction.apply(xf, xb, T(mask), wf, wb)
        loss = (hs[0] * T(dh_f)).sum() + (hs[1] * T(dh_b)).sum()
        pairs = ((xf, g_j[0]), (xb, g_j[1]))
        weights = ((wf, g_j[2]), (wb, g_j[3]))
    else:
        hs = (B.LSTMFunction.apply(xf, T(mask), wf),)
        loss = (hs[0] * T(dh_f)).sum()
        pairs, weights = ((xf, g_j[0]),), ((wf, g_j[2]),)
    loss.backward()
    for got, want in zip(hs, hs_j):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **VALUE_TOL)
    for xt, g in pairs:
        assert xt.grad.dtype == torch.float32
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g),
                                   **VALUE_TOL)
    for wt, g in weights:
        assert wt.grad.dtype == BF16 and g.dtype == jnp.bfloat16
        _close_frac(wt.grad.float().numpy(), g.astype(jnp.float32),
                    what="dwh")


def test_bf16_wrappers_plain_on_cpu_and_forward_rounding():
    """On the CPU the wrappers take their plain twins with a bfloat16 wh
    (no launch counted), and the twin's forward rounds h_prev: equal to
    the float32 recurrence run on ``wh`` and each step's h_prev rounded."""
    xp_f, xp_b, mask, wh_f, wh_b, _, _ = _rnn_inputs(0, 7, 3, 8)
    T = torch.from_numpy
    args = (T(xp_f), T(xp_b), T(mask), T(wh_f).to(BF16), T(wh_b).to(BF16))
    before = (B.bilstm.launches, dict(B.bilstm.by_design))
    got = B.bilstm(*args)
    assert (B.bilstm.launches, B.bilstm.by_design) == before
    for g, w in zip(got, B.bilstm_plain(*args)):
        assert torch.equal(g, w)
    h = torch.zeros(3, 8)
    c = torch.zeros(3, 8)
    wf = T(wh_f).to(BF16).float()
    for t in range(7):
        pre = T(xp_f)[t] + h.to(BF16).float() @ wf
        i, f, g, o = pre.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = T(mask)[t] > 0
        h, c = torch.where(m, h_new, h), torch.where(m, c_new, c)
        torch.testing.assert_close(got[0][t], h, rtol=1e-6, atol=1e-6)


# -- the train step ----------------------------------------------------------

FEATS, CLASSES = 5, 4
_DEEP_SPEECH = ("num_hiddens=16,input_dense=16,input_layers=2,dropout=0.0,"
                "input_dropout=0.0")
# (model, hparams, batch): the LSTM zoo models at small widths, bi and
# uni, at batches of the cluster design (B=3) and of the stream design
# (B=50 in two directions, B=97 in one)
STEP_CASES = {
    "graves2006": ("graves2006", "num_hiddens=8", 3),
    "deep_speech": ("deep_speech", _DEEP_SPEECH, 3),
    "deep_blstm_uni": ("deep_blstm", "num_hiddens=8,num_layers=2,"
                       "dropout=0.0,bidirectional=false", 3),
    "deep_blstm_b50": ("deep_blstm", "num_hiddens=8,num_layers=2,"
                       "dropout=0.0", 50),
    "deep_speech_b50": ("deep_speech", _DEEP_SPEECH, 50),
    "deep_blstm_uni_b97": ("deep_blstm", "num_hiddens=8,num_layers=2,"
                           "dropout=0.0,bidirectional=false", 97),
}


def _batch(seed=0, b=3, t=12, l=3):
    """A batch of ``b`` rows: lengths t, 9, 7 and label lengths 3, 2, 1
    in turn."""
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, FEATS).astype(np.float32),
            np.resize(np.array([t, 9, 7], np.int32), b),
            rng.randint(0, CLASSES, (b, l)).astype(np.int32),
            np.resize(np.array([3, 2, 1], np.int32), b),
            np.ones(b, np.float32))


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_bf16_train_step_matches_jax(monkeypatch, case):
    """One sgd step (momentum 0.9 from zeros: the update is -lr * grad, so
    the JAX gradient is (p0 - p1) / lr) from the same weights: the loss,
    every parameter's gradient (the gradient of the weighted loss sum,
    which the cast's autograd hands the float32 master bfloat16-
    representable, divided by max(sum w, 1) after it, in the JAX step's
    order), and float32 masters and optimizer state afterwards."""
    monkeypatch.setattr(jrnn, "RNN_BACKEND", "pallas")
    model, hp, b = STEP_CASES[case]
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
    batch = _batch(b=b)
    # the masters' gradients of the loss sum, the step's own pieces
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


def test_bf16_eval_step_is_float32():
    """The eval step does not cast: a bfloat16 trainer's eval equals a
    float32 trainer's on the same weights, bit for bit."""
    model, hp, _ = STEP_CASES["graves2006"]
    pm = build_model(model, hp, num_classes=CLASSES, input_dim=FEATS,
                     generator=torch.Generator().manual_seed(0))
    batch = list(map(torch.from_numpy, _batch(1)))
    outs = []
    for dtype in (BF16, None):
        tr = Trainer(pm, make_optimizer(), compute_dtype=dtype)
        outs.append(tr.eval_step(tr.init_state(), *batch))
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


# -- refusals ----------------------------------------------------------------

def _op_args(op, t=5, b=2, h=8):
    """The layer-norm op's arguments at a small shape, its recurrent
    weights bfloat16."""
    g = torch.Generator().manual_seed(0)
    xp = torch.randn(t, b, 4 * h, generator=g)
    mask = torch.ones(t, b, 1)
    wh = torch.randn(h, 4 * h, generator=g).to(BF16)
    rest = [torch.ones(4 * h), torch.ones(h), torch.ones(h)]
    if op is ln_lstm:
        return [xp, mask, wh, *rest]
    return [xp, xp, mask, wh, wh, *(a for r in rest for a in (r, r))]


@pytest.mark.parametrize("op", [ln_lstm, bi_ln_lstm],
                         ids=lambda f: f.__name__)
def test_other_cells_refuse_bf16(op):
    """The layer-norm LSTM has bfloat16-weight kernels in both designs: its
    ops run a bfloat16 wh (the plain twin here, float32 h and c of the
    shape) at a cluster shape and at one that goes to the stream design
    (H=300), refusing neither."""
    for h in (8, 300):
        out = op(*_op_args(op, h=h))
        assert all(o.dtype == torch.float32 and o.shape == (5, 2, h)
                   for o in out)


@pytest.mark.parametrize("model", ["ln_blstm"])
def test_trainer_refuses_bf16_for_other_cells(model):
    """The Trainer takes compute_dtype=torch.bfloat16 for ln_blstm, whose
    cells have bfloat16-weight kernels, and still refuses float16; a model
    holding a subclass of LSTMCell outside BF16_CELLS refuses bfloat16: a
    cell the port has no bfloat16 kernels for."""
    pm = build_model(model, "num_hiddens=8,num_layers=1", num_classes=4,
                     input_dim=5)
    assert Trainer(pm, make_optimizer(),
                   compute_dtype=BF16).compute_dtype == BF16
    with pytest.raises(ValueError, match="compute_dtype"):
        Trainer(pm, make_optimizer(), compute_dtype=torch.float16)

    class OtherCell(LSTMCell):
        pass

    other = torch.nn.Sequential(OtherCell(5, 8))
    with pytest.raises(ValueError, match="OtherCell, a cell with no "
                                         "bfloat16 kernels"):
        Trainer(other, make_optimizer(), compute_dtype=BF16)


def _stream_inputs(seed, t, b, h, gates):
    """xp_f, xp_b [T,B,G*H], a mask [T,B,1] whose rows end at random
    lengths (the first row whole), wh_f, wh_b [H,G*H] float32, and the
    cotangents of h_f, h_b: a shape that goes to the stream design."""
    rng = np.random.RandomState(seed)
    xp_f, xp_b = (rng.randn(t, b, gates * h).astype(np.float32)
                  for _ in range(2))
    lengths = rng.randint(1, t + 1, b)
    lengths[0] = t
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    wh_f, wh_b = ((rng.randn(h, gates * h) / np.sqrt(h)).astype(np.float32)
                  for _ in range(2))
    dh_f, dh_b = (rng.randn(t, b, h).astype(np.float32) for _ in range(2))
    return xp_f, xp_b, mask[..., None], wh_f, wh_b, dh_f, dh_b


@pytest.mark.parametrize("hidden,batch,ndir", [(520, 2, 1), (256, 49, 2),
                                               (512, 97, 1)])
def test_stream_design_refuses_bf16(hidden, batch, ndir):
    """At a shape that lstm_geometry sends to the stream design a bfloat16
    call runs (on the CPU the plain twin of the stream design's bfloat16
    forms, no launch counted; nothing refuses or takes float32): h, dxp
    and dwh of BiLSTMFunction / LSTMFunction against pallas_bilstm /
    pallas_lstm with a bfloat16 wh in interpret mode, at T=4 with held
    frames."""
    assert B.lstm_geometry(hidden, batch, ndir).design == "stream"
    t = 4
    xp_f, xp_b, mask, wh_f, wh_b, dh_f, dh_b = _stream_inputs(
        hidden + batch, t, batch, hidden, 4)
    J = jnp.asarray

    def jax_loss(xf, xb, wf, wb):
        if ndir == 2:
            hf, hb = jbi.pallas_bilstm(xf, xb, J(mask), wf, wb, hidden,
                                       interpret=True)
            return jnp.sum(hf * J(dh_f)) + jnp.sum(hb * J(dh_b)), (hf, hb)
        hf = jl.pallas_lstm(xf, J(mask), wf, hidden, interpret=True)
        return jnp.sum(hf * J(dh_f)), (hf,)

    (_, hs_j), g_j = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3),
                                        has_aux=True)(
        J(xp_f), J(xp_b), J(wh_f).astype(jnp.bfloat16),
        J(wh_b).astype(jnp.bfloat16))
    T = torch.from_numpy
    xf, xb = T(xp_f).requires_grad_(), T(xp_b).requires_grad_()
    wf = T(wh_f).to(BF16).requires_grad_()
    wb = T(wh_b).to(BF16).requires_grad_()
    ops = (B.bilstm, B.bilstm_bwd, B.lstm, B.lstm_bwd)
    before = [(op.launches, dict(op.by_design)) for op in ops]
    if ndir == 2:
        hs = B.BiLSTMFunction.apply(xf, xb, T(mask), wf, wb)
        loss = (hs[0] * T(dh_f)).sum() + (hs[1] * T(dh_b)).sum()
        pairs, weights = ((xf, g_j[0]), (xb, g_j[1])), ((wf, g_j[2]),
                                                        (wb, g_j[3]))
    else:
        hs = (B.LSTMFunction.apply(xf, T(mask), wf),)
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
                    what="dwh")


def test_mixed_dtype_weights_are_refused():
    xp_f, xp_b, mask, wh_f, wh_b, _, _ = _rnn_inputs(0, 4, 2, 8)
    T = torch.from_numpy
    with pytest.raises(ValueError, match="share one dtype"):
        B.bilstm(T(xp_f), T(xp_b), T(mask), T(wh_f).to(BF16), T(wh_b))
    with pytest.raises(ValueError, match="must be float32"):
        B.bilstm(T(xp_f).to(BF16), T(xp_b), T(mask), T(wh_f).to(BF16),
                 T(wh_b).to(BF16))


_CELLS = {"lstm": LSTMCell, "gru": GRUCell, "ln_lstm": LayerNormLSTMCell,
          "mi_lstm": MILSTMCell, "zoneout_lstm": ZoneoutLSTMCell}


@pytest.mark.parametrize("model", sorted(CELL_KINDS))
def test_cell_kinds_name_the_models_cells(model):
    """CELL_KINDS says which cell each zoo model is built from."""
    hp = "num_hiddens=8,num_layers=1" + (",input_dense=8,input_layers=1"
                                         if model == "deep_speech" else "")
    pm = build_model(model, hp, num_classes=4, input_dim=5)
    cells = {type(m) for m in pm.modules()
             if isinstance(m, (LSTMCell, GRUCell))}
    assert cells == {_CELLS[CELL_KINDS[model]]}
