"""The wide design of the port's LSTM recurrence (asr_study_torch/ops/
bilstm.py at 256 < H <= 512, csrc/lstm_wide_{fwd,bwd}.cu on the card) on
the CPU, where the wrappers take their plain versions in the same wiring:
the forward keeps the activated gates of every frame, and the backward
reads them in place of recomputing them.  Both against the JAX kernels
``pallas_bilstm`` / ``pallas_lstm`` in interpret mode at H=512 with held
frames, the Functions' gradients against their VJPs, and deep_speech at
its 512-unit width against the JAX model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import asr_study_torch.ops.bilstm as ops
from asr_study_torch.models.zoo import build_model
from asr_study_torch.ops.bilstm import (BiLSTMFunction, LSTMFunction, bilstm,
                                        bilstm_bwd, bilstm_bwd_gates_plain,
                                        bilstm_bwd_plain, bilstm_plain, lstm,
                                        lstm_bwd, lstm_bwd_gates_plain,
                                        lstm_geometry, lstm_plain,
                                        stream_smem, wide_smem)
from asr_study_torch.ops.recurrence import (SMEM_LIMIT, WIDE_BUDGET,
                                            WIDE_UNITS)
from asr_study_torch.utils.weights import params_from_flat
from asr_study_tpu.models import zoo as jzoo
from asr_study_tpu.ops import pallas_bilstm as jbi
from asr_study_tpu.ops import pallas_lstm as jl
from extras.export_weights import _flatten as flatten_params

H = 512
TOL = dict(rtol=1e-5, atol=1e-5)       # tests/test_pallas_bilstm.py's
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_pallas_lstm.py's VJPs
DIRS = pytest.mark.parametrize("ndir", [2, 1], ids=["bi", "uni"])
MASKS = pytest.mark.parametrize("full_mask", [False, True],
                                ids=["held", "full"])


def _inputs(seed, t=8, b=3, h=H, full_mask=False):
    """Seeded numpy inputs: xp_f, xp_b [T,B,4H], a mask [T,B,1] whose rows
    after the first end early (held frames), wh_f, wh_b [H,4H]."""
    rng = np.random.RandomState(seed)
    xp = [rng.randn(t, b, 4 * h).astype(np.float32) for _ in range(2)]
    lengths = np.full(b, t) if full_mask else np.array(
        [t] + [max(1, t - 2 - 3 * i) for i in range(b - 1)])
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    wh = [(rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)
          for _ in range(2)]
    return xp[0], xp[1], mask[..., None], wh[0], wh[1]


def _jax_gates(xp, h_seq, wh, reverse):
    """The activated gates of every frame from the JAX kernel's h: sigmoid
    i, f, o and tanh g of xp + h_prev @ wh (``_lstm_cell_math``)."""
    h = h_seq[: xp.shape[0]]
    zero = jnp.zeros_like(h[:1])
    hp = jnp.concatenate([h[1:], zero]) if reverse else jnp.concatenate(
        [zero, h[:-1]])
    pre = xp + jnp.einsum("tbh,hg->tbg", hp, wh,
                          precision=jax.lax.Precision.HIGHEST)
    i, f, g, o = jnp.split(pre, 4, axis=-1)
    return np.asarray(jnp.concatenate(
        [jax.nn.sigmoid(i), jax.nn.sigmoid(f), jnp.tanh(g),
         jax.nn.sigmoid(o)], axis=-1))


def _jax_fwd(args, ndir):
    """-> per direction (h, c, gates) from the JAX kernel call."""
    xp_f, xp_b, mask, wh_f, wh_b = map(jnp.asarray, args)
    t = xp_f.shape[0]
    if ndir == 2:
        h_f, c_f, h_b, c_b = jbi._bifwd_call(xp_f, xp_b, mask, wh_f, wh_b, H,
                                             interpret=True)
        return [(h_f, c_f, _jax_gates(xp_f, h_f, wh_f, False)),
                (h_b, c_b, _jax_gates(xp_b, h_b, wh_b, True))], t
    h, c = jl._fwd_call(xp_f, mask, wh_f, H, interpret=True)
    return [(h, c, _jax_gates(xp_f, h, wh_f, False))], t


@DIRS
@MASKS
def test_wide_forward_gates_match_pallas(ndir, full_mask):
    """The wrapper at H=512 on the CPU (the wide design's plain version)
    with residual, whose res holds the gates: h and c against the JAX kernel call, the gates against
    the JAX cell maths on the kernel's own h, at 1e-5."""
    args = _inputs(3 + ndir, full_mask=full_mask)
    targs = [torch.from_numpy(a) for a in args]
    assert lstm_geometry(H, 3, ndir).design == "wide"
    if ndir == 2:
        h_f, c_f, h_b, c_b, (g_f, g_b) = bilstm(*targs, residual=True)
        got = [(h_f, c_f, g_f), (h_b, c_b, g_b)]
        plain = bilstm_plain(*targs)
    else:
        h, c, (g,) = lstm(targs[0], targs[2], targs[3], residual=True)
        got = [(h, c, g)]
        plain = lstm_plain(targs[0], targs[2], targs[3])
    want, t = _jax_fwd(args, ndir)
    for d, (mine, ref) in enumerate(zip(got, want)):
        for name, g_, w_ in zip(("h", "c", "gates"), mine, ref):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_)[:t], **TOL,
                                       err_msg=f"{name} dir {d}")
        assert mine[2].shape == (t, 3, 4 * H)
    # keeping the gates leaves h and c as they were
    for g_, w_ in zip([x for pair in got for x in pair[:2]], plain):
        assert torch.equal(g_, w_)


@DIRS
@MASKS
def test_wide_bwd_from_gates_matches_pallas(ndir, full_mask):
    """The backward from saved gates (the plain version with the kernel's
    arguments, and the wrapper on the CPU) against the JAX kernel call's
    dxp, from the same forward states, at the VJP tolerance."""
    args = _inputs(7 + ndir, full_mask=full_mask)
    rng = np.random.RandomState(11)
    dh = [rng.randn(8, 3, H).astype(np.float32) for _ in range(2)]
    targs = [torch.from_numpy(a) for a in args]
    tdh = [torch.from_numpy(a) for a in dh]
    xp_f, xp_b, mask, wh_f, wh_b = map(jnp.asarray, args)
    if ndir == 2:
        h_f, c_f, h_b, c_b, res = bilstm(*targs, residual=True)
        got = bilstm_bwd_gates_plain(*res, targs[2], targs[3], targs[4],
                                     c_f, c_b, *tdh)
        via = bilstm_bwd(*targs, h_f, c_f, h_b, c_b, *tdh, res)
        jh = jbi._bifwd_call(xp_f, xp_b, mask, wh_f, wh_b, H, interpret=True)
        want = jbi._bibwd_call(xp_f, xp_b, mask, *jh, *map(jnp.asarray, dh),
                               wh_f, wh_b, H, interpret=True)[:2]
    else:
        h, c, res = lstm(targs[0], targs[2], targs[3], residual=True)
        got = (lstm_bwd_gates_plain(*res, targs[2], targs[3], c, tdh[0]),)
        via = (lstm_bwd(targs[0], targs[2], targs[3], h, c, tdh[0], res),)
        jh, jc = jl._fwd_call(xp_f, mask, wh_f, H, interpret=True)
        want = jl._bwd_call(xp_f, mask, jh, jc, jnp.asarray(dh[0]), wh_f, H,
                            interpret=True)[:1]
    for name, g_, v_, w_ in zip(("dxp_f", "dxp_b"), got, via, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **GRAD_TOL,
                                   err_msg=name)
        assert torch.equal(g_, v_)
        # held frames' own pre-activations get nothing
        held = torch.from_numpy(args[2][..., 0] == 0)
        assert not g_[held].any()


@pytest.mark.parametrize("h", [8, 100, 300])
def test_gates_walk_equals_recompute(h):
    """The backward from the forward's gates equals the one that recomputes
    them from h (the same arithmetic on the same values), in both
    directions, at the cluster widths and at a wide one."""
    args = [torch.from_numpy(a) for a in _inputs(h, t=9, b=4, h=h)]
    dh = [torch.randn(9, 4, h, generator=torch.Generator().manual_seed(h))
          for _ in range(2)]
    h_f, c_f, h_b, c_b, g_f, g_b = bilstm_plain(*args, keep_gates=True)
    got = bilstm_bwd_gates_plain(g_f, g_b, args[2], args[3], args[4], c_f,
                                 c_b, *dh)
    want = bilstm_bwd_plain(*args, h_f, c_f, h_b, c_b, *dh)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=0, atol=1e-6)


def _grads(fn, args, loss_of):
    """d loss_of(outputs) / d (xp..., wh...) by torch autograd through
    ``fn(xp_f, xp_b, mask, wh_f, wh_b)`` (uni: ``fn(xp, mask, wh)``)."""
    t = [torch.from_numpy(a) for a in args]
    if fn == LSTMFunction.apply:
        leaves = [t[0].clone().requires_grad_(), t[3].clone().requires_grad_()]
        out = (fn(leaves[0], t[2], leaves[1]),)
    else:
        leaves = [a.clone().requires_grad_() for a in (t[0], t[1], t[3], t[4])]
        out = fn(leaves[0], leaves[1], t[2], leaves[2], leaves[3])
    loss_of(*out).backward()
    return [leaf.grad.numpy() for leaf in leaves]


def _jax_vjp_grads(args, ndir, loss_of):
    mask = jnp.asarray(args[2])
    if ndir == 2:
        def loss(xf, xb, wf, wb):
            return loss_of(*jbi.pallas_bilstm(xf, xb, mask, wf, wb, H,
                                              interpret=True))
        leaves = (args[0], args[1], args[3], args[4])
    else:
        def loss(x, w):
            return loss_of(jl.pallas_lstm(x, mask, w, H, interpret=True))
        leaves = (args[0], args[3])
    return [np.asarray(g) for g in jax.grad(
        loss, argnums=tuple(range(len(leaves))))(*map(jnp.asarray, leaves))]


@DIRS
@pytest.mark.parametrize("loss", ["cotangent", "held"])
def test_wide_function_grads_match_pallas_vjp(ndir, loss, monkeypatch):
    """BiLSTMFunction / LSTMFunction at H=512 on the CPU, which save the
    gates and take the backward from them, against jax.grad through
    pallas_bilstm / pallas_lstm: dxp and dwh at the VJP tolerance.
    "cotangent" puts seeded cotangents on every frame, "held" squares the
    outputs, padded frames included, whose cotangents pass straight back
    to the last real frame."""
    args = _inputs(21 + ndir)
    rng = np.random.RandomState(23)
    dh = [rng.randn(8, 3, H).astype(np.float32) for _ in range(ndir)]
    calls = []
    for name in ("bilstm_bwd_gates_plain", "lstm_bwd_gates_plain"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _f=real: (
            calls.append(1), _f(*a))[1])
    if loss == "held":
        want = _jax_vjp_grads(args, ndir,
                              lambda *hs: sum(jnp.sum(x ** 2) for x in hs))
        def port_loss(*hs):
            return sum((x ** 2).sum() for x in hs)
    else:
        want = _jax_vjp_grads(args, ndir, lambda *hs: sum(
            jnp.sum(x * d) for x, d in zip(hs, dh)))
        def port_loss(*hs):
            return sum((x * torch.from_numpy(d)).sum() for x, d in zip(hs, dh))
    fn = BiLSTMFunction.apply if ndir == 2 else LSTMFunction.apply
    got = _grads(fn, args, port_loss)
    assert calls == [1]
    names = (("dxp_f", "dxp_b", "dwh_f", "dwh_b") if ndir == 2
             else ("dxp", "dwh"))
    for name, g_, w_ in zip(names, got, want):
        np.testing.assert_allclose(g_, w_, **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("hidden,batch,ndir,design,ctas,rows", [
    (512, 32, 2, "wide", 16, 16), (512, 32, 1, "wide", 16, 8),
    (512, 48, 2, "wide", 16, 16), (512, 49, 2, "stream", 1, 4),
    (512, 96, 1, "wide", 16, 16), (512, 200, 1, "stream", 1, 4),
    (300, 5, 2, "wide", 10, 4), (257, 9, 1, "wide", 9, 4),
    (256, 32, 2, "cluster", 8, 8)])
def test_wide_geometry_bounds(hidden, batch, ndir, design, ctas, rows):
    """Where the wide design starts and stops: over H=256, within
    WIDE_BUDGET clusters (the least row count of WIDE_ROWS that fits), 32
    units a CTA in ceil(H / 32) CTAs, shared memory within the H100's
    limit; beyond the budget the stream design, in blocks of 4 rows."""
    geo = lstm_geometry(hidden, batch, ndir)
    assert (geo.design, geo.ctas, geo.rows) == (design, ctas, rows)
    if design == "wide":
        assert geo.units == WIDE_UNITS and geo.grid[0] == ctas
        assert geo.grid[1] * geo.grid[2] <= WIDE_BUDGET
        assert (geo.smem_fwd, geo.smem_bwd) == wide_smem(rows, ctas)
        assert max(geo.smem_fwd, geo.smem_bwd) <= SMEM_LIMIT
    elif design == "stream":
        assert geo.grid == (1, -(-batch // rows), ndir)
        assert (geo.smem_fwd, geo.smem_bwd) == stream_smem(hidden)


def test_wide_smem_layout():
    """wide_smem against the kernels' layouts written out: the forward's
    rows 256..511 of the slice, two h buffers of 512 rows, xp and partial
    sums of 128 columns, the mask; the backward's transposed rows, dpre and
    the partials of C senders, at R=16 and C=16 (deep_speech's BLSTM)."""
    fwd, bwd = wide_smem(16, 16)
    assert fwd == 4 * (256 * 128 + 2 * 16 * 512 + 2 * 16 * 128 + 32
                       + 2 * 16 * 128) == 229_504
    assert bwd == 4 * (128 * 256 + 128 * 16 + 2 * 16 * 32 * 16) == 204_800


def test_gates_contract():
    """The forward's res is what the backward of the same design reads:
    the gates of each direction at a wide width, nothing at a cluster or
    stream one; a backward given another res, none where the wide design
    runs, or a misshapen pair, refuses to run; serving returns no res."""
    small = [torch.from_numpy(a) for a in _inputs(1, t=4, b=2, h=8)]
    *out, res = bilstm(*small, residual=True)
    assert res == () and lstm(small[0], small[2], small[3],
                              residual=True)[2] == ()
    dh = [torch.zeros_like(out[0])] * 2
    with pytest.raises(ValueError, match="res holds 2 tensors"):
        bilstm_bwd(*small, *out, *dh, (small[0], small[1]))
    streamed = [torch.from_numpy(a) for a in _inputs(4, t=2, b=49)]
    assert lstm_geometry(H, 49, 2).design == "stream"
    assert bilstm(*streamed, residual=True)[4] == ()
    wide = [torch.from_numpy(a) for a in _inputs(2, t=3, b=2)]
    h_f, c_f, h_b, c_b, (g_f, g_b) = bilstm(*wide, residual=True)
    assert g_f.shape == g_b.shape == wide[0].shape
    dh = [torch.zeros_like(h_f)] * 2
    with pytest.raises(ValueError, match="res holds 0 tensors"):
        bilstm_bwd(*wide, h_f, c_f, h_b, c_b, *dh)
    with pytest.raises(ValueError, match="g_b"):
        bilstm_bwd(*wide, h_f, c_f, h_b, c_b, *dh, (g_f, g_b[:-1]))
    with pytest.raises(ValueError, match="res holds 0 tensors"):
        lstm_bwd(wide[0], wide[2], wide[3], h_f, c_f, dh[0])
    # serving keeps nothing: four outputs
    assert len(bilstm(*wide)) == 4
    assert len(lstm(wide[0], wide[2], wide[3])) == 2


@DIRS
def test_deep_speech_512_matches_jax(ndir):
    """deep_speech at its own 512-unit recurrent width (a narrow front end)
    from JAX weights through the weight bridge: logits against the JAX CPU
    scan path, and the gradient of a fixed linear function of the logits
    with respect to every weight against jax.grad (the Functions' saved
    gates on the port's side)."""
    hp = (f"num_hiddens={H},input_dense=16,input_layers=2,"
          f"bidirectional={str(ndir == 2).lower()}")
    jm = jzoo.deep_speech(hp, num_classes=27)
    params = jm.init(jax.random.PRNGKey(8), 39)
    rng = np.random.RandomState(9)
    params = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(0.1 * rng.randn(*a.shape), a.dtype), params)
    flat = flatten_params(params)
    pm = build_model("deep_speech", hp, num_classes=27).eval()
    pm.load_state_dict(params_from_flat(flat))
    x = (3.0 * rng.randn(3, 10, 39)).astype(np.float32)
    lengths = np.array([10, 7, 4], np.int32)
    probe = rng.randn(3, 10, 28).astype(np.float32)

    def jloss(p):
        return jnp.sum(jm.apply(p, jnp.asarray(x), jnp.asarray(lengths),
                                train=False) * probe)

    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(lengths),
                               train=False))
    want_grads = flatten_params(jax.grad(jloss)(params))
    got = pm(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    (got * torch.from_numpy(probe)).sum().backward()
    for name, p in pm.named_parameters():
        key = name.replace(".", "/")
        w = np.asarray(want_grads[key])
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(p.grad.numpy() / scale, w / scale,
                                   rtol=0, atol=1e-4, err_msg=key)
