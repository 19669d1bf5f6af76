"""The wide design of the port's GRU recurrence (asr_study_torch/ops/gru.py
at 256 < H <= 512, csrc/gru_wide_{fwd,bwd}.cu on the card) on the CPU,
where the wrappers take their plain versions in the same wiring: the
forward keeps the h side of every frame's pre-activations ``h_prev @ wh``,
and the backward reads it in place of recomputing the product.  Both
against the JAX kernels ``pallas_bigru`` / ``pallas_gru`` in interpret mode
at H=512 with held frames, the Functions' gradients against their VJPs,
and deep_gru at 3x512 against the JAX model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import asr_study_torch.ops.gru as ops
from asr_study_torch.models.zoo import build_model
from asr_study_torch.ops.gru import (GRU_WIDE_SPLIT, BiGRUFunction,
                                     GRUFunction, bigru, bigru_bwd,
                                     bigru_bwd_plain, bigru_bwd_res_plain,
                                     bigru_plain, gru, gru_bwd,
                                     gru_bwd_plain, gru_bwd_res_plain,
                                     gru_geometry, gru_plain,
                                     gru_stream_smem, gru_wide_smem)
from asr_study_torch.ops.recurrence import (SMEM_LIMIT, WIDE_BUDGET,
                                            WIDE_UNITS)
from asr_study_torch.utils.weights import params_from_flat
from asr_study_tpu.models import zoo as jzoo
from asr_study_tpu.ops import pallas_bigru as jbg
from asr_study_tpu.ops import pallas_gru as jg
from extras.export_weights import _flatten as flatten_params

H = 512
TOL = dict(rtol=1e-5, atol=1e-5)       # tests/test_pallas_bigru.py's
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_pallas_gru.py's VJPs
DIRS = pytest.mark.parametrize("ndir", [2, 1], ids=["bi", "uni"])
MASKS = pytest.mark.parametrize("full_mask", [False, True],
                                ids=["held", "full"])


def _inputs(seed, t=8, b=3, h=H, full_mask=False):
    """Seeded numpy inputs: xp_f, xp_b [T,B,3H], a mask [T,B,1] whose rows
    after the first end early (held frames), wh_f, wh_b [H,3H]."""
    rng = np.random.RandomState(seed)
    xp = [rng.randn(t, b, 3 * h).astype(np.float32) for _ in range(2)]
    lengths = np.full(b, t) if full_mask else np.array(
        [t] + [max(1, t - 2 - 3 * i) for i in range(b - 1)])
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    wh = [(rng.randn(h, 3 * h) / np.sqrt(h)).astype(np.float32)
          for _ in range(2)]
    return xp[0], xp[1], mask[..., None], wh[0], wh[1]


def _jax_hg(h_seq, wh, t, reverse):
    """The h side of every frame's pre-activations from the JAX kernel's h:
    h_prev @ wh, h_prev the scan-previous h (zero past the end)."""
    h = h_seq[:t]
    zero = jnp.zeros_like(h[:1])
    hp = jnp.concatenate([h[1:], zero]) if reverse else jnp.concatenate(
        [zero, h[:-1]])
    return np.asarray(jnp.einsum("tbh,hg->tbg", hp, wh,
                                 precision=jax.lax.Precision.HIGHEST))


def _jax_fwd(args, ndir):
    """-> per direction (h, hg) from the JAX kernel call, padded h."""
    xp_f, xp_b, mask, wh_f, wh_b = map(jnp.asarray, args)
    t = xp_f.shape[0]
    if ndir == 2:
        h_f, h_b = jbg._bifwd_call(xp_f, xp_b, mask, wh_f, wh_b, H,
                                   interpret=True)
        return [(h_f, _jax_hg(h_f, wh_f, t, False)),
                (h_b, _jax_hg(h_b, wh_b, t, True))], t
    h = jg._fwd_call(xp_f, mask, wh_f, H, interpret=True)
    return [(h, _jax_hg(h, wh_f, t, False))], t


@DIRS
@MASKS
def test_wide_forward_hg_matches_pallas(ndir, full_mask):
    """The wrapper at H=512 on the CPU (the wide design's plain version)
    with residual, whose res holds the h side of the pre-activations: h
    against the JAX kernel call, hg against h_prev @ wh from the kernel's
    own h, at 1e-5; keeping hg leaves h as it was."""
    args = _inputs(3 + ndir, full_mask=full_mask)
    targs = [torch.from_numpy(a) for a in args]
    assert gru_geometry(H, 3, ndir).design == "wide"
    if ndir == 2:
        h_f, h_b, (hg_f, hg_b) = bigru(*targs, residual=True)
        got = [(h_f, hg_f), (h_b, hg_b)]
        plain = bigru_plain(*targs)
    else:
        h, (hg,) = gru(targs[0], targs[2], targs[3], residual=True)
        got = [(h, hg)]
        plain = (gru_plain(targs[0], targs[2], targs[3]),)
    want, t = _jax_fwd(args, ndir)
    for d, (mine, ref) in enumerate(zip(got, want)):
        for name, g_, w_ in zip(("h", "hg"), mine, ref):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_)[:t], **TOL,
                                       err_msg=f"{name} dir {d}")
        assert mine[1].shape == (t, 3, 3 * H)
    for (h_, _), p_ in zip(got, plain):
        assert torch.equal(h_, p_)


@DIRS
@MASKS
def test_wide_bwd_from_res_matches_pallas(ndir, full_mask):
    """The backward from the saved hg (the plain version with the kernel's
    arguments, and the wrapper on the CPU) against the JAX kernel call's
    dxp and dhp, from the same forward states, at the VJP tolerance; held
    frames get nothing."""
    args = _inputs(7 + ndir, full_mask=full_mask)
    rng = np.random.RandomState(11)
    dh = [rng.randn(8, 3, H).astype(np.float32) for _ in range(2)]
    targs = [torch.from_numpy(a) for a in args]
    tdh = [torch.from_numpy(a) for a in dh]
    xp_f, xp_b, mask, wh_f, wh_b = map(jnp.asarray, args)
    if ndir == 2:
        h_f, h_b, res = bigru(*targs, residual=True)
        got = bigru_bwd_res_plain(targs[0], targs[1], *res, *targs[2:], h_f,
                                  h_b, *tdh)
        via = bigru_bwd(*targs, h_f, h_b, *tdh, res)
        jh = jbg._bifwd_call(xp_f, xp_b, mask, wh_f, wh_b, H, interpret=True)
        pad = ((0, jh[0].shape[0] - 8), (0, 0), (0, 0))
        want = jbg._bibwd_call(xp_f, xp_b, mask, *jh,
                               *(jnp.pad(d, pad) for d in dh), wh_f, wh_b, H,
                               interpret=True)[:4]
        names = ("dxp_f", "dhp_f", "dxp_b", "dhp_b")
    else:
        h, res = gru(targs[0], targs[2], targs[3], residual=True)
        got = gru_bwd_res_plain(targs[0], *res, targs[2], targs[3], h, tdh[0])
        via = gru_bwd(targs[0], targs[2], targs[3], h, tdh[0], res)
        jh = jg._fwd_call(xp_f, mask, wh_f, H, interpret=True)
        pad = ((0, jh.shape[0] - 8), (0, 0), (0, 0))
        want = jg._bwd_call(xp_f, mask, jh, jnp.pad(dh[0], pad), wh_f, H,
                            interpret=True)[:2]
        names = ("dxp", "dhp")
    held = torch.from_numpy(args[2][..., 0] == 0)
    for name, g_, v_, w_ in zip(names, got, via, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **GRAD_TOL,
                                   err_msg=name)
        assert torch.equal(g_, v_)
        # held frames' own pre-activations get nothing
        assert not g_[held].any()


@pytest.mark.parametrize("h", [8, 100, 300])
def test_res_walk_equals_recompute(h):
    """The backward from the forward's hg equals the one that recomputes
    h_prev @ wh (the same arithmetic on the same values), in both
    directions and in one, at the cluster widths and at a wide one."""
    args = [torch.from_numpy(a) for a in _inputs(h, t=9, b=4, h=h)]
    dh = [torch.randn(9, 4, h, generator=torch.Generator().manual_seed(h))
          for _ in range(2)]
    h_f, h_b, hg_f, hg_b = bigru_plain(*args, keep_hg=True)
    got = bigru_bwd_res_plain(args[0], args[1], hg_f, hg_b, *args[2:], h_f,
                              h_b, *dh)
    want = bigru_bwd_plain(*args, h_f, h_b, *dh)
    h_u, hg_u = gru_plain(args[0], args[2], args[3], keep_hg=True)
    got += gru_bwd_res_plain(args[0], hg_u, args[2], args[3], h_u, dh[0])
    want += gru_bwd_plain(args[0], args[2], args[3], h_u, dh[0])
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=0, atol=1e-6)


def _grads(fn, args, loss_of):
    """d loss_of(outputs) / d (xp..., wh...) by torch autograd through
    ``fn(xp_f, xp_b, mask, wh_f, wh_b)`` (uni: ``fn(xp, mask, wh)``)."""
    t = [torch.from_numpy(a) for a in args]
    if fn == GRUFunction.apply:
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
            return loss_of(*jbg.pallas_bigru(xf, xb, mask, wf, wb, H,
                                             interpret=True))
        leaves = (args[0], args[1], args[3], args[4])
    else:
        def loss(x, w):
            return loss_of(jg.pallas_gru(x, mask, w, H, interpret=True))
        leaves = (args[0], args[3])
    return [np.asarray(g) for g in jax.grad(
        loss, argnums=tuple(range(len(leaves))))(*map(jnp.asarray, leaves))]


@DIRS
@pytest.mark.parametrize("loss", ["cotangent", "held"])
def test_wide_function_grads_match_pallas_vjp(ndir, loss, monkeypatch):
    """BiGRUFunction / GRUFunction at H=512 on the CPU, which save hg and
    take the backward from it, against jax.grad through pallas_bigru /
    pallas_gru: dxp and dwh at the VJP tolerance.  "cotangent" puts seeded
    cotangents on every frame, "held" squares the outputs, padded frames
    included, whose cotangents pass straight back to the last real
    frame."""
    args = _inputs(21 + ndir)
    rng = np.random.RandomState(23)
    dh = [rng.randn(8, 3, H).astype(np.float32) for _ in range(ndir)]
    calls = []
    for name in ("bigru_bwd_res_plain", "gru_bwd_res_plain"):
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
    fn = BiGRUFunction.apply if ndir == 2 else GRUFunction.apply
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
    (513, 4, 1, "stream", 1, 4), (256, 32, 2, "cluster", 8, 8)])
def test_gru_wide_geometry_bounds(hidden, batch, ndir, design, ctas, rows):
    """Where the GRU's wide design starts and stops: over H=256 and up to
    H=512, within WIDE_BUDGET clusters (the least row count of WIDE_ROWS
    that fits), 32 units a CTA in ceil(H / 32) CTAs, shared memory within
    the H100's limit; beyond the budget or the width the stream design, in
    blocks of 4 rows."""
    geo = gru_geometry(hidden, batch, ndir)
    assert (geo.design, geo.ctas, geo.rows) == (design, ctas, rows)
    if design == "wide":
        assert geo.units == WIDE_UNITS and geo.grid[0] == ctas
        assert geo.grid[1] * geo.grid[2] <= WIDE_BUDGET
        assert (geo.smem_fwd, geo.smem_bwd) == gru_wide_smem(rows, ctas)
        assert max(geo.smem_fwd, geo.smem_bwd) <= SMEM_LIMIT
    elif design == "stream":
        assert geo.grid == (1, -(-batch // rows), ndir)
        assert (geo.smem_fwd, geo.smem_bwd) == gru_stream_smem(hidden)


def test_gru_wide_smem_layout():
    """gru_wide_smem against the kernels' layouts written out at R=16 and
    C=16: the forward's shared rows 256..511 of the slice (192 threads of
    two 128-row parts a column), two h buffers of 512 rows, xp of 96
    columns, the mask and the two parts' partial sums; the backward's
    transposed rows 256..511, dhp and the partials of C senders."""
    assert GRU_WIDE_SPLIT == 2
    fwd, bwd = gru_wide_smem(16, 16)
    assert fwd == 4 * (256 * 96 + 2 * 16 * 512 + 2 * 16 * 96 + 32
                       + 2 * 16 * 96) == 188_544
    assert bwd == 4 * (96 * 256 + 96 * 16 + 2 * 16 * 32 * 16) == 169_984


def test_gru_res_contract():
    """The forward's res is what the backward of the same design reads: the
    h side of each direction at a wide width, nothing at a cluster or
    stream one; a backward given another res, none where the wide design
    runs, or a misshapen pair, refuses to run; serving returns no res."""
    small = [torch.from_numpy(a) for a in _inputs(1, t=4, b=2, h=8)]
    h_f, h_b, res = bigru(*small, residual=True)
    assert res == () and gru(small[0], small[2], small[3],
                             residual=True)[1] == ()
    dh = [torch.zeros_like(h_f)] * 2
    with pytest.raises(ValueError, match="res holds 2 tensors"):
        bigru_bwd(*small, h_f, h_b, *dh, (small[0], small[1]))
    streamed = [torch.from_numpy(a) for a in _inputs(4, t=2, b=49)]
    assert gru_geometry(H, 49, 2).design == "stream"
    assert bigru(*streamed, residual=True)[2] == ()
    wide = [torch.from_numpy(a) for a in _inputs(2, t=3, b=2)]
    h_f, h_b, (hg_f, hg_b) = bigru(*wide, residual=True)
    assert hg_f.shape == hg_b.shape == wide[0].shape
    dh = [torch.zeros_like(h_f)] * 2
    with pytest.raises(ValueError, match="res holds 0 tensors"):
        bigru_bwd(*wide, h_f, h_b, *dh)
    with pytest.raises(ValueError, match="hg_b"):
        bigru_bwd(*wide, h_f, h_b, *dh, (hg_f, hg_b[:-1]))
    with pytest.raises(ValueError, match="res holds 0 tensors"):
        gru_bwd(wide[0], wide[2], wide[3], h_f, dh[0])
    # serving keeps nothing
    assert len(bigru(*wide)) == 2
    assert torch.equal(gru(wide[0], wide[2], wide[3]), h_f)


@DIRS
def test_deep_gru_512_matches_jax(ndir):
    """deep_gru at 3x512 from JAX weights through the weight bridge: logits
    against the JAX CPU scan path, and the gradient of a fixed linear
    function of the logits with respect to every weight against jax.grad
    (the Functions' saved hg on the port's side)."""
    hp = (f"num_hiddens={H},num_layers=3,dropout=0.0,"
          f"bidirectional={str(ndir == 2).lower()}")
    jm = jzoo.deep_gru(hp, num_classes=27)
    params = jm.init(jax.random.PRNGKey(12), 39)
    flat = flatten_params(params)
    pm = build_model("deep_gru", hp, num_classes=27).eval()
    pm.load_state_dict(params_from_flat(flat))
    assert gru_geometry(H, 3, ndir).design == "wide"
    rng = np.random.RandomState(13)
    x = rng.randn(3, 10, 39).astype(np.float32)
    lengths = np.array([10, 7, 4], np.int32)
    probe = rng.randn(3, 10, 28).astype(np.float32)

    def jloss(p):
        return jnp.sum(jm.apply(p, jnp.asarray(x), jnp.asarray(lengths),
                                train=False) * probe)

    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(lengths),
                               train=False))
    want_grads = flatten_params(jax.grad(jloss)(params))
    got = pm(torch.from_numpy(x), torch.from_numpy(lengths))
    assert got.shape == want.shape == (3, 10, 28)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    (got * torch.from_numpy(probe)).sum().backward()
    for name, p in pm.named_parameters():
        key = name.replace(".", "/")
        w = np.asarray(want_grads[key])
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(p.grad.numpy() / scale, w / scale,
                                   rtol=0, atol=1e-4, err_msg=key)
