"""Port's layer-norm LSTM (asr_study_torch/ops/ln_lstm.py ``bi_ln_lstm``,
``ln_lstm``, their backwards, ``BiLNLSTMFunction``, ``LNLSTMFunction``;
``LayerNormLSTMCell``; ``ln_blstm``) against the JAX package: the kernel
calls of ``pallas_ln_lstm`` and ``pallas_bi_ln_lstm`` in interpret mode at
``h_real = H`` (forward h and c, backward dpre and dcn), the VJPs of both
ops, autodiff of the hold-state scan of the JAX cell on held frames, and the
JAX layer and model on their CPU scan paths from the same weights.  On the
CPU the wrappers take their plain versions, Python loops over time."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_study_torch.models.cells import LayerNormLSTMCell
from asr_study_torch.models.nn import layer_norm_apply
from asr_study_torch.models.rnn import RNNLayer
from asr_study_torch.models.zoo import build_model
from asr_study_torch.ops.bilstm import CLUSTER_SLICE, CLUSTER_THREADS
from asr_study_torch.ops.ln_lstm import (BiLNLSTMFunction, LNLSTMFunction,
                                         bi_ln_lstm, bi_ln_lstm_bwd,
                                         bi_ln_lstm_plain, ln_cluster_smem,
                                         ln_geometry, ln_lstm, ln_lstm_bwd,
                                         ln_lstm_bwd_plain, ln_lstm_plain,
                                         ln_stream_smem)
from asr_study_torch.ops.recurrence import (CLUSTER_BUDGET, CLUSTER_CTAS,
                                            CLUSTER_ROWS, SMEM_LIMIT)
from asr_study_torch.utils.weights import flat_from_params, params_from_flat
from asr_study_tpu.models import nn as jnn
from asr_study_tpu.models import zoo as jzoo
from asr_study_tpu.models.cells import LayerNormLSTMCell as JaxLNCell
from asr_study_tpu.models.rnn import RNNLayer as JaxRNNLayer
from asr_study_tpu.ops import pallas_bi_ln_lstm as jbi
from asr_study_tpu.ops import pallas_ln_lstm as jln
# the exporter's own flattening: JAX tree -> tree-path keyed arrays
from extras.export_weights import _flatten as flatten_params

TOL = dict(rtol=1e-5, atol=1e-5)
# tests/test_pallas_ln_lstm.py's gradient contract
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)

SIZES = [(12, 4, 8), (17, 3, 20)]
# the backward cases at a prime T above 16: the JAX backward kernels then
# walk one frame a grid step (their chunk divides T and is at most 16), where
# T=12 unrolls 12 frames a step and takes 15 s to trace
BWD_SIZES = [(19, 4, 8), (17, 3, 20)]
MASKS = pytest.mark.parametrize("full_mask", [False, True],
                                ids=["ragged", "full"])


def _inputs(seed, t, b, h, full_mask=False):
    """Seeded numpy arguments of both directions -> (xpn_f, xpn_b, mask,
    wh_f, wh_b, gh_f, gh_b, gc_f, gc_b, bc_f, bc_b): gains about 1 and
    biases about 0, none exactly; a ragged mask [T, B, 1]."""
    rng = np.random.RandomState(seed)

    def near(n, centre):
        return (centre + 0.3 * rng.randn(n)).astype(np.float32)

    xpn = [rng.randn(t, b, 4 * h).astype(np.float32) for _ in range(2)]
    wh = [(rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)
          for _ in range(2)]
    gh = [near(4 * h, 1.0) for _ in range(2)]
    gc = [near(h, 1.0) for _ in range(2)]
    bc = [near(h, 0.0) for _ in range(2)]
    lengths = np.full(b, t) if full_mask else rng.randint(t // 2, t + 1, b)
    lengths[0] = t
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    return (xpn[0], xpn[1], mask[..., None], wh[0], wh[1], gh[0], gh[1],
            gc[0], gc[1], bc[0], bc[1])


def _uni(args):
    """The forward direction's arguments: (xpn, mask, wh, gh, gc, bc)."""
    return tuple(args[i] for i in (0, 2, 3, 5, 7, 9))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _cotangents(seed, t, b, h):
    rng = np.random.RandomState(seed)
    return [rng.randn(t, b, h).astype(np.float32) for _ in range(2)]


def test_layer_norm_apply_matches_jax():
    rng = np.random.RandomState(0)
    x = (3.0 + 2.0 * rng.randn(5, 7, 24)).astype(np.float32)
    params = {"g": (1.0 + 0.3 * rng.randn(24)).astype(np.float32),
              "b": (0.3 * rng.randn(24)).astype(np.float32)}
    want = jnn.layer_norm_apply({k: jnp.asarray(v) for k, v in
                                 params.items()}, jnp.asarray(x))
    got = layer_norm_apply({k: torch.from_numpy(v) for k, v in
                            params.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t,b,h", SIZES)
@MASKS
def test_fwd_matches_pallas_kernel_calls(t, b, h, full_mask):
    """h and raw c of both directions (bi_ln_lstm) and of one (ln_lstm)
    against _bifwd_call and _ln_fwd_call; held frames repeat the state of
    the last real one."""
    args = _inputs(h, t, b, h, full_mask)
    jargs = list(map(jnp.asarray, args))
    want = jbi._bifwd_call(*jargs, h, h, True)
    got = bi_ln_lstm(*_t(args))
    for name, g, w in zip(("h_f", "c_f", "h_b", "c_b"), got, want):
        assert g.shape == (t, b, h), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:t], **TOL,
                                   err_msg=name)
    want_uni = jln._ln_fwd_call(*map(jnp.asarray, _uni(args)), h, h, True)
    got_uni = ln_lstm(*_t(_uni(args)))
    for name, g, w in zip(("h", "c"), got_uni, want_uni):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:t], **TOL,
                                   err_msg=name)
    lengths = args[2][..., 0].sum(0).astype(int)
    for i, n in enumerate(lengths):
        assert torch.equal(got_uni[0][n:, i],
                           got_uni[0][n - 1, i].expand(t - n, h))
        assert torch.equal(got[2][n:, i], torch.zeros(t - n, h))


@pytest.mark.parametrize("t,b,h", BWD_SIZES)
@MASKS
def test_bwd_matches_pallas_kernel_calls(t, b, h, full_mask):
    """dpre and dcn of both directions (bi_ln_lstm_bwd) and of one
    (ln_lstm_bwd) against _bibwd_call and _ln_bwd_call, fed the JAX
    forward's h and c and cotangents on every frame."""
    args = _inputs(h + 1, t, b, h, full_mask)
    dh = _cotangents(h + 2, t, b, h)
    jargs = list(map(jnp.asarray, args))
    jxf, jxb, jmask = jargs[:3]
    jvecs = jargs[3:]
    hf, cf, hb, cb = jbi._bifwd_call(*jargs, h, h, True)
    want = jbi._bibwd_call(jxf, jxb, jmask, hf, cf, hb, cb,
                           *map(jnp.asarray, dh), *jvecs, h, h, True)[:4]
    hc = [torch.tensor(np.asarray(a)[:t]) for a in (hf, cf, hb, cb)]
    got = bi_ln_lstm_bwd(*_t(args), *hc, *_t(dh))
    for name, g, w in zip(("dpre_f", "dcn_f", "dpre_b", "dcn_b"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)

    xpn, mask, wh, gh, gc, bc = map(jnp.asarray, _uni(args))
    jh, jc = jln._ln_fwd_call(xpn, mask, wh, gh, gc, bc, h, h, True)
    want = jln._ln_bwd_call(xpn, mask, jh, jc, jnp.asarray(dh[0]), wh, gh,
                            gc, bc, h, h, True)[:2]
    got = ln_lstm_bwd(*_t(_uni(args)), torch.tensor(np.asarray(jh)[:t]),
                      torch.tensor(np.asarray(jc)[:t]),
                      torch.from_numpy(dh[0]))
    for name, g, w in zip(("dpre", "dcn"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


def _port_grads(fn, arrays, cots):
    leaves = [torch.from_numpy(a).clone().requires_grad_() for a in arrays]
    outs = fn(*leaves)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cots])
    return [leaf.grad.numpy() for leaf in leaves]


@pytest.mark.parametrize("t,b,h", BWD_SIZES)
def test_functions_match_pallas_vjp(t, b, h):
    """Every gradient of BiLNLSTMFunction (xpn, wh, gh, gc, bc of both
    directions) and of LNLSTMFunction against jax.vjp of pallas_bi_ln_lstm
    and pallas_ln_lstm in interpret mode."""
    args = _inputs(h + 3, t, b, h)
    dh = _cotangents(h + 4, t, b, h)
    diff = [a for i, a in enumerate(args) if i != 2]
    mask = args[2]
    jmask, tmask = jnp.asarray(mask), torch.from_numpy(mask)

    _, vjp = jax.vjp(lambda *a: jbi.pallas_bi_ln_lstm(
        a[0], a[1], jmask, *a[2:], h, h, True), *map(jnp.asarray, diff))
    want = vjp(tuple(map(jnp.asarray, dh)))
    got = _port_grads(lambda *a: BiLNLSTMFunction.apply(a[0], a[1], tmask,
                                                        *a[2:]), diff, dh)
    names = ("dxpn_f", "dxpn_b", "dwh_f", "dwh_b", "dgh_f", "dgh_b",
             "dgc_f", "dgc_b", "dbc_f", "dbc_b")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL,
                                   err_msg=name)

    uni = diff[0::2]
    _, vjp = jax.vjp(lambda x, w, g1, g2, b1: jln.pallas_ln_lstm(
        x, jmask, w, g1, g2, b1, h, h, True), *map(jnp.asarray, uni))
    want = vjp(jnp.asarray(dh[0]))
    got = _port_grads(lambda x, w, g1, g2, b1: LNLSTMFunction.apply(
        x, tmask, w, g1, g2, b1), uni, dh[:1])
    for name, g, w in zip(names[0::2], got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


def test_held_frames_match_autodiff_of_scan():
    """A loss over all frames, padded ones included, where h and c are held:
    their cotangents must pass straight back to the last real frame, with
    dc_prev = dc_next there (tests/test_pallas_ln_lstm.py's unmasked-loss
    case).  LNLSTMFunction from the input projections (with the cell's xpn
    prep) against jax.grad through lax.scan of the JAX LayerNormLSTMCell's
    step."""
    t, b, f, h = 11, 3, 5, 8
    cell = JaxLNCell(h)
    params = cell.init(jax.random.PRNGKey(0), f)
    rng = np.random.RandomState(9)
    params = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(0.3 * rng.randn(*a.shape), a.dtype), params)
    x = jnp.asarray(rng.randn(t, b, f).astype(np.float32))
    mask = (np.arange(t)[:, None] < np.array([11, 7, 5])[None, :]).astype(
        np.float32)[..., None]
    jmask = jnp.asarray(mask)
    xp = cell.input_proj(params, x)

    def scan_loss(xp_in, wh):
        p = dict(params, wh=wh)
        _, outs = jax.lax.scan(lambda carry, inp: cell.step(p, carry, *inp),
                               cell.init_carry(b), (xp_in, jmask))
        return jnp.sum(outs ** 2)

    port = LayerNormLSTMCell(f, h)
    port.load_state_dict(params_from_flat(flatten_params(params)))
    tmask = torch.from_numpy(mask)
    leaves = [torch.tensor(np.asarray(a)).requires_grad_()
              for a in (xp, params["wh"])]
    xpn = (port._blockwise_ln(port.ln_x, leaves[0]) + port.b
           + port.ln_h["b"]).contiguous()
    out = LNLSTMFunction.apply(xpn, tmask, leaves[1], port.ln_h["g"],
                               port.ln_c["g"], port.ln_c["b"])
    (out ** 2).sum().backward()
    got = [leaf.grad.numpy() for leaf in leaves]
    want = jax.grad(scan_loss, argnums=(0, 1))(xp, params["wh"])
    for name, g, w in zip(("dxp", "dwh"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL, err_msg=name)
    # the held frames' own pre-activations get nothing
    assert np.abs(got[0][mask[..., 0] == 0]).max() == 0.0


def _perturbed(params, seed):
    """The JAX initial weights plus seeded noise: no gain is 1, no bias 0."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(0.3 * rng.randn(*a.shape), a.dtype),
        params)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_layer_matches_jax(bidirectional):
    """RNNLayer('ln_lstm') against the JAX layer on its CPU scan path, from
    perturbed weights loaded strictly."""
    t, b, f, h = 10, 3, 6, 8
    jlayer = JaxRNNLayer("ln_lstm", h, bidirectional=bidirectional)
    params = _perturbed(jlayer.init(jax.random.PRNGKey(3), f), 4)
    flat = flatten_params(params)
    assert all(np.all(v != 1.0) and np.all(v != 0.0) for v in flat.values())
    rng = np.random.RandomState(5)
    x = rng.randn(t, b, f).astype(np.float32)
    mask = (np.arange(t)[:, None] < np.array([t, 7, 4])[None, :]).astype(
        np.float32)[..., None]
    want = jlayer.apply(params, jnp.asarray(x), jnp.asarray(mask))
    layer = RNNLayer("ln_lstm", f, h, bidirectional)
    layer.load_state_dict(params_from_flat(flat))           # strict
    with torch.no_grad():
        got = layer(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.shape == (t, b, layer.output_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_ln_blstm_logits_match_jax(bidirectional):
    """The whole model: JAX weights carried across by the weight bridge
    (strict load, the same key set both ways), logits against the JAX CPU
    scan path."""
    hp = ("num_hiddens=8,num_layers=2,bidirectional="
          f"{str(bidirectional).lower()}")
    jm = jzoo.ln_blstm(hp, num_classes=27)
    params = _perturbed(jm.init(jax.random.PRNGKey(4), 39), 5)
    flat = flatten_params(params)
    pm = build_model("ln_blstm", hp, num_classes=27)
    pm.load_state_dict(params_from_flat(flat))
    assert sorted(flat_from_params(pm.state_dict())) == sorted(flat)
    assert any("/ln_c/" in k for k in flat)
    assert any("/bw/" in k for k in flat) == bidirectional
    rng = np.random.RandomState(6)
    x = rng.randn(3, 14, 39).astype(np.float32)
    lengths = np.array([14, 9, 5], np.int32)
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(lengths),
                               train=False))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(lengths))
    assert got.shape == want.shape == (3, 14, 28)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_ln_blstm_default_structure_matches_jax(bidirectional):
    """At the default size (3x256): the port's state_dict holds the JAX
    tree's keys and shapes exactly, ln_x/ln_h/ln_c included."""
    hp = f"bidirectional={str(bidirectional).lower()}"
    jm = jzoo.ln_blstm(hp, num_classes=27)
    shapes = jax.eval_shape(lambda k: jm.init(k, 39), jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten_params(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               shapes)).items()}
    pm = build_model("ln_blstm", hp, num_classes=27,
                     generator=torch.Generator().manual_seed(0))
    got = {k.replace(".", "/"): tuple(v.shape)
           for k, v in pm.state_dict().items()}
    assert got == want
    assert got["rnn/layers/2/rnn/fw/ln_h/g"] == (1024,)
    assert got["rnn/layers/0/rnn/fw/ln_c/b"] == (256,)


def test_wrappers_take_plain_on_cpu_and_check():
    args = _t(_inputs(1, 6, 3, 5))
    uni = _t(_uni(_inputs(1, 6, 3, 5)))
    dh = torch.from_numpy(_cotangents(2, 6, 3, 5)[0])
    counts = [f.launches for f in (bi_ln_lstm, ln_lstm, bi_ln_lstm_bwd,
                                   ln_lstm_bwd)]
    h, c = ln_lstm(*uni)
    h_f, c_f, _, _ = bi_ln_lstm(*args)
    torch.testing.assert_close(h, h_f, rtol=0, atol=0)
    torch.testing.assert_close(c, c_f, rtol=0, atol=0)
    torch.testing.assert_close((h, c), ln_lstm_plain(*uni), rtol=0, atol=0)
    torch.testing.assert_close(bi_ln_lstm_plain(*args)[:2], (h_f, c_f),
                               rtol=0, atol=0)
    got = ln_lstm_bwd(*uni, h, c, dh)
    torch.testing.assert_close(got, ln_lstm_bwd_plain(*uni, h, c, dh),
                               rtol=0, atol=0)
    assert counts == [f.launches for f in (bi_ln_lstm, ln_lstm,
                                           bi_ln_lstm_bwd, ln_lstm_bwd)]
    xpn, mask, wh, gh, gc, bc = uni
    with pytest.raises(ValueError, match="gh"):
        ln_lstm(xpn, mask, wh, gh[:-1], gc, bc)
    with pytest.raises(ValueError, match="bc"):
        ln_lstm(xpn, mask, wh, gh, gc, bc[None])
    with pytest.raises(ValueError, match="dh"):
        ln_lstm_bwd(*uni, h, c, dh[:-1])
    with pytest.raises(ValueError, match="float32"):
        ln_lstm(xpn, mask, wh, gh, gc.double(), bc)
    with pytest.raises(ValueError, match="device"):
        ln_lstm(*(a.to("meta") for a in uni))


@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("hidden", [100, 256, 300, 512])
def test_ln_geometry(hidden, ndir):
    """The size rule of the LN-LSTM kernels at B=32: H=100 and H=256 take the
    cluster design (every hidden unit owned by exactly one CTA with its four
    gate columns, no CTA empty, a warp a batch row and a lane a unit, every
    row group within the launch and the launch within the budget of
    resident clusters; H=256 in 8 clusters of R=4 rows in one direction and
    R=8 in two; H=100 in CTAs of 13 units, the last 9), H=300 and H=512 the
    stream design; shared memory within the H100's limit and equal to the
    kernels' layouts."""
    batch = 32
    geo = ln_geometry(hidden, batch, ndir)
    assert max(geo.smem_fwd, geo.smem_bwd) <= SMEM_LIMIT
    assert geo.grid[2] == ndir
    assert geo.grid[1] * geo.rows >= batch > (geo.grid[1] - 1) * geo.rows
    if hidden in (300, 512):
        assert geo.design == "stream"
        assert (geo.ctas, geo.units) == (1, hidden)
        assert (geo.smem_fwd, geo.smem_bwd) == ln_stream_smem(hidden)
        return
    assert geo.design == "cluster"
    assert geo.ctas <= CLUSTER_CTAS and geo.rows in CLUSTER_ROWS
    assert geo.grid[0] == geo.ctas
    assert geo.grid[1] * geo.grid[2] <= CLUSTER_BUDGET
    # the slice in registers: CLUSTER_SLICE rows of one gate column a thread
    assert 4 * geo.units * -(-hidden // CLUSTER_SLICE) <= CLUSTER_THREADS
    # the cell: a warp a row, a lane a unit
    assert geo.units <= 32 and geo.rows <= CLUSTER_THREADS // 32
    assert (geo.smem_fwd, geo.smem_bwd) == ln_cluster_smem(
        hidden, geo.units, geo.rows, geo.ctas)
    if hidden == 256:
        assert (geo.units, geo.rows) == (32, 4 * ndir)
        assert geo.grid[1] * geo.grid[2] == 8
    else:
        assert (geo.ctas, geo.units, hidden - 7 * geo.units) == (8, 13, 9)
    owner = {}
    for k in range(geo.ctas):
        units = range(k * geo.units, min(hidden, (k + 1) * geo.units))
        assert len(units) > 0
        for q in range(4):
            for u in units:
                col = q * hidden + u
                assert col not in owner
                owner[col] = k
    assert sorted(owner) == list(range(4 * hidden))


def test_jax_ln_blstm_float32_holds_float64_at_t64(monkeypatch):
    """ROADMAP C2 pinned: the JAX ln_blstm at its default 3x256 on its CPU
    scan path, run in float32 and in float64 from the same initial weights
    and inputs (cells._dot and nn.dense_apply, which force float32
    results, patched in this process only), agree to 1e-3 at T=64.  The
    drift past that at full length (2.32 at T=805 in the measurement C2
    records) is the float32 recurrence's own, so it is no sign of a fault
    in the port's LN kernels or streaming."""
    from asr_study_tpu.models import cells as jcells

    monkeypatch.setattr(jcells, "_dot", lambda x, w: jnp.dot(
        x.astype(w.dtype), w))
    monkeypatch.setattr(jnn, "dense_apply", lambda p, x, precision=None: (
        jnp.dot(x.astype(p["w"].dtype), p["w"], precision=precision)
        + p["b"]))
    jm = jzoo.ln_blstm("", num_classes=27)
    params = jm.init(jax.random.PRNGKey(0), 39)
    x = np.random.RandomState(0).randn(4, 64, 39).astype(np.float32)
    lengths = jnp.full((4,), 64, jnp.int32)
    y32 = np.asarray(jm.apply(params, jnp.asarray(x), lengths, train=False))
    for layer in jm.rnn.layers:
        monkeypatch.setattr(layer.cell, "dtype", jnp.float64)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), params)
        y64 = np.asarray(jm.apply(p64, jnp.asarray(x.astype(np.float64)),
                                  lengths, train=False))
    assert y32.dtype == np.float32 and y64.dtype == np.float64
    assert y32.shape == y64.shape == (4, 64, 28)
    np.testing.assert_allclose(y32, y64, rtol=0, atol=1e-3)
