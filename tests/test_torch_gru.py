"""Port's GRU recurrence (asr_study_torch/ops/gru.py) against the JAX
kernels ``pallas_bigru`` and ``pallas_gru`` in interpret mode, forward and
backward (their custom VJPs and the kernel calls' own dxp/dhp outputs),
against autodiff of the hold-state scan on held frames, against ``nn.GRU``,
and the GRU cell, layer and ``deep_gru`` model against the JAX scan path.
On the CPU the wrappers take their plain versions, Python loops over
time."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_study_torch.models.cells import GRUCell, gru_step
from asr_study_torch.models.rnn import RNNLayer
from asr_study_torch.models.zoo import build_model, deep_gru
from asr_study_torch.ops.gru import (BiGRUFunction, GRUFunction, bigru,
                                     bigru_bwd, bigru_bwd_plain, bigru_plain,
                                     GRU_SLICE, GRU_THREADS, gru, gru_bwd,
                                     gru_bwd_plain, gru_cluster_smem,
                                     gru_geometry, gru_plain,
                                     gru_wide_smem)
from asr_study_torch.ops.recurrence import (CLUSTER_BUDGET, CLUSTER_CTAS,
                                            CLUSTER_ROWS, WIDE_BUDGET,
                                            WIDE_UNITS)
from asr_study_torch.utils.weights import flat_from_params, params_from_flat
from asr_study_tpu.models.cells import GRUCell as JaxGRUCell
from asr_study_tpu.models.rnn import RNNLayer as JaxRNNLayer
from asr_study_tpu.models.zoo import deep_gru as jax_deep_gru
from asr_study_tpu.ops import pallas_bigru as jbg
from asr_study_tpu.ops import pallas_gru as jg
# the exporter's own flattening: JAX tree -> tree-path keyed arrays
from extras.export_weights import _flatten as flatten_params

TOL = dict(rtol=1e-5, atol=1e-5)    # tests/test_pallas_bigru.py's contract
# gradients: tests/test_pallas_gru.py's contract for the backward kernels
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(seed, t, b, h, full_mask=False):
    """Seeded numpy inputs: xp_f, xp_b [T,B,3H], ragged mask [T,B,1],
    wh_f, wh_b [H,3H] (orthogonal-like scale)."""
    rng = np.random.RandomState(seed)
    xp_f = rng.randn(t, b, 3 * h).astype(np.float32)
    xp_b = rng.randn(t, b, 3 * h).astype(np.float32)
    lengths = np.full(b, t) if full_mask else rng.randint(t // 2, t + 1, b)
    lengths[0] = t
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    wh_f = (rng.randn(h, 3 * h) / np.sqrt(h)).astype(np.float32)
    wh_b = (rng.randn(h, 3 * h) / np.sqrt(h)).astype(np.float32)
    return xp_f, xp_b, mask[..., None], wh_f, wh_b


def _cotangents(seed, t, b, h):
    rng = np.random.RandomState(seed)
    return (rng.randn(t, b, h).astype(np.float32),
            rng.randn(t, b, h).astype(np.float32))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


SIZES = [(12, 4, 8), (17, 3, 20)]
MASKS = pytest.mark.parametrize("full_mask", [False, True],
                                ids=["ragged", "full"])


@pytest.mark.parametrize("t,b,h", SIZES)
@MASKS
def test_bigru_plain_matches_pallas_bigru(t, b, h, full_mask):
    args = _inputs(h, t, b, h, full_mask)
    want = jbg.pallas_bigru(*map(jnp.asarray, args), h, interpret=True)
    got = bigru(*_t(args))
    for name, g, w in zip(("h_f", "h_b"), got, want):
        assert g.shape == (t, b, h), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("t,b,h", SIZES)
@MASKS
def test_gru_plain_matches_pallas_gru(t, b, h, full_mask):
    xp, _, mask, wh, _ = _inputs(h + 1, t, b, h, full_mask)
    want = jg.pallas_gru(*map(jnp.asarray, (xp, mask, wh)), h,
                         interpret=True)
    got = gru(*_t((xp, mask, wh)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t,b,h", SIZES)
@MASKS
def test_bigru_bwd_matches_pallas(t, b, h, full_mask):
    """bigru_bwd_plain's four outputs against the JAX kernel call's, and
    BiGRUFunction's gradients against jax.vjp of pallas_bigru, with
    cotangents on every output frame."""
    args = _inputs(h + 2, t, b, h, full_mask)
    dh_f, dh_b = _cotangents(h + 3, t, b, h)
    jargs = list(map(jnp.asarray, args))
    jh_f, jh_b = jbg._bifwd_call(*jargs, h, interpret=True)
    t_pad = jh_f.shape[0]
    pad = ((0, t_pad - t), (0, 0), (0, 0))
    want = jbg._bibwd_call(jargs[0], jargs[1], jargs[2], jh_f, jh_b,
                           jnp.pad(dh_f, pad), jnp.pad(dh_b, pad), jargs[3],
                           jargs[4], h, interpret=True)[:4]
    targs = _t(args)
    got = bigru_bwd_plain(*targs, *bigru_plain(*targs),
                          *_t((dh_f, dh_b)))
    for name, g, w in zip(("dxp_f", "dhp_f", "dxp_b", "dhp_b"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)

    def loss(xf, xb, wf, wb):
        hf, hb = jbg.pallas_bigru(xf, xb, jargs[2], wf, wb, h,
                                  interpret=True)
        return jnp.sum(hf * dh_f) + jnp.sum(hb * dh_b)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(jargs[0], jargs[1],
                                                jargs[3], jargs[4])
    leaves = [a.clone().requires_grad_() for a in
              (targs[0], targs[1], targs[3], targs[4])]
    hf, hb = BiGRUFunction.apply(leaves[0], leaves[1], targs[2], leaves[2],
                                 leaves[3])
    ((hf * torch.from_numpy(dh_f)).sum()
     + (hb * torch.from_numpy(dh_b)).sum()).backward()
    for name, leaf, w in zip(("dxp_f", "dxp_b", "dwh_f", "dwh_b"), leaves,
                             want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("t,b,h", SIZES)
@MASKS
def test_gru_bwd_matches_pallas(t, b, h, full_mask):
    xp, _, mask, wh, _ = _inputs(h + 4, t, b, h, full_mask)
    dh, _ = _cotangents(h + 5, t, b, h)
    jxp, jmask, jwh = map(jnp.asarray, (xp, mask, wh))
    jh = jg._fwd_call(jxp, jmask, jwh, h, interpret=True)
    dh_pad = jnp.pad(dh, ((0, jh.shape[0] - t), (0, 0), (0, 0)))
    want = jg._bwd_call(jxp, jmask, jh, dh_pad, jwh, h, interpret=True)[:2]
    txp, tmask, twh = _t((xp, mask, wh))
    got = gru_bwd_plain(txp, tmask, twh, gru_plain(txp, tmask, twh),
                        torch.from_numpy(dh))
    for name, g, w in zip(("dxp", "dhp"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)
    want = jax.grad(lambda x, w: jnp.sum(
        jg.pallas_gru(x, jmask, w, h, interpret=True) * dh),
        argnums=(0, 1))(jxp, jwh)
    leaves = [a.clone().requires_grad_() for a in (txp, twh)]
    (GRUFunction.apply(leaves[0], tmask, leaves[1])
     * torch.from_numpy(dh)).sum().backward()
    for name, leaf, w in zip(("dxp", "dwh"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   **GRAD_TOL, err_msg=name)


def _jax_scan_h(cell, wh, b, xp, mask, reverse):
    """h of one direction by lax.scan of the JAX GRUCell.step (bias 0
    here: xp carries it), in forward time order."""
    p = {"wh": wh, "b": b}
    xs = (xp[::-1], mask[::-1]) if reverse else (xp, mask)

    def body(carry, inp):
        return cell.step(p, carry, *inp)

    _, outs = jax.lax.scan(body, cell.init_carry(xp.shape[1]), xs)
    return outs[::-1] if reverse else outs


@pytest.mark.parametrize("kind", ["bi", "uni"])
def test_held_frames_match_autodiff_of_scan(kind):
    """A loss over all frames, padded ones included, where h is held: the
    cotangents that reach held frames must pass straight back to the last
    real frame.  The port's Function against torch autograd through a
    gru_step loop and against jax.grad through lax.scan of GRUCell.step
    (the JAX GRU backward has no held-frame test of its own)."""
    t, b, h = 10, 4, 8
    xp_f, xp_b, mask, wh_f, wh_b = _inputs(7, t, b, h)
    mask[:, 1:] = (np.arange(t)[:, None] < np.array([3, 6, 9])[None, :]
                   )[..., None]
    dirs = [(xp_f, wh_f, False)] + ([(xp_b, wh_b, True)]
                                    if kind == "bi" else [])
    tmask = torch.from_numpy(mask)

    def port(fn):
        leaves = [torch.from_numpy(a).clone().requires_grad_()
                  for xp, wh, _ in dirs for a in (xp, wh)]
        xps, whs = leaves[0::2], leaves[1::2]
        outs = fn(xps, whs)
        sum((o ** 2).sum() for o in outs).backward()
        return [leaf.grad.numpy() for leaf in leaves]

    def through_function(xps, whs):
        if kind == "bi":
            return BiGRUFunction.apply(xps[0], xps[1], tmask, whs[0], whs[1])
        return [GRUFunction.apply(xps[0], tmask, whs[0])]

    def through_steps(xps, whs):
        outs = []
        for xp, wh, (_, _, rev) in zip(xps, whs, dirs):
            hcur = xp.new_zeros((b, h))
            hs = [None] * t
            for s in (reversed(range(t)) if rev else range(t)):
                hcur = gru_step(hcur, xp[s], tmask[s], wh)
                hs[s] = hcur
            outs.append(torch.stack(hs))
        return outs

    cell = JaxGRUCell(h)
    zero_b = jnp.zeros((3 * h,), jnp.float32)

    def jloss(*flat):
        return sum(jnp.sum(_jax_scan_h(cell, wh, zero_b, xp, mask, rev) ** 2)
                   for xp, wh, (_, _, rev) in zip(flat[0::2], flat[1::2],
                                                  dirs))

    flat = [jnp.asarray(a) for xp, wh, _ in dirs for a in (xp, wh)]
    want = jax.grad(jloss, argnums=tuple(range(len(flat))))(*flat)
    got = port(through_function)
    for i, (g, s, w) in enumerate(zip(got, port(through_steps), want)):
        np.testing.assert_allclose(g, s, **GRAD_TOL, err_msg=str(i))
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL,
                                   err_msg=str(i))
    # the held frames' own pre-activations get nothing
    held = mask[..., 0] == 0
    for g in got[0::2]:
        assert np.abs(g[held]).max() == 0.0


@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bi", "uni"])
def test_layer_matches_nn_gru(bidirectional):
    """RNNLayer('gru') against torch's nn.GRU on a packed batch, with
    ``bias_hh`` zero (nn.GRU adds b_hn inside r * (...), the JAX cell
    outside it) and ``weight_hh = wh^T``."""
    t, b, f, h = 9, 3, 5, 6
    layer = RNNLayer("gru", f, h, bidirectional,
                     generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for cell in ([layer.fw, layer.bw] if bidirectional else [layer.fw]):
            cell.b.copy_(torch.from_numpy(rng.randn(3 * h).astype(
                np.float32)))
    x = torch.from_numpy(rng.randn(t, b, f).astype(np.float32))
    lengths = torch.tensor([t, 6, 2])
    mask = (torch.arange(t)[:, None] < lengths[None, :]).float()[..., None]
    ref = torch.nn.GRU(f, h, bidirectional=bidirectional)
    with torch.no_grad():
        for sfx, cell in (("", layer.fw), ("_reverse", getattr(
                layer, "bw", None))):
            if cell is None:
                continue
            getattr(ref, "weight_ih_l0" + sfx).copy_(cell.wx.t())
            getattr(ref, "weight_hh_l0" + sfx).copy_(cell.wh.t())
            getattr(ref, "bias_ih_l0" + sfx).copy_(cell.b)
            getattr(ref, "bias_hh_l0" + sfx).zero_()
        packed = torch.nn.utils.rnn.pack_padded_sequence(x, lengths)
        want, _ = torch.nn.utils.rnn.pad_packed_sequence(ref(packed)[0],
                                                         total_length=t)
        got = layer(x, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_wrappers_take_plain_on_cpu_and_check():
    xp_f, xp_b, mask, wh_f, wh_b = _t(_inputs(1, 6, 3, 5))
    dh_f, dh_b = _t(_cotangents(2, 6, 3, 5))
    counts = [f.launches for f in (bigru, gru, bigru_bwd, gru_bwd)]
    h_f, h_b = bigru(xp_f, xp_b, mask, wh_f, wh_b)
    h = gru(xp_f, mask, wh_f)
    torch.testing.assert_close(h, h_f, rtol=0, atol=0)
    got = bigru_bwd(xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b, dh_f, dh_b)
    for g, w in zip(got, bigru_bwd_plain(xp_f, xp_b, mask, wh_f, wh_b, h_f,
                                         h_b, dh_f, dh_b)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for g, w in zip(gru_bwd(xp_f, mask, wh_f, h, dh_f), got[:2]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert counts == [f.launches for f in (bigru, gru, bigru_bwd, gru_bwd)]
    with pytest.raises(ValueError, match="dh_b"):
        bigru_bwd(xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b, dh_f, dh_b[:-1])
    with pytest.raises(ValueError, match="3H"):
        gru(xp_f[..., :-1], mask, wh_f)
    with pytest.raises(ValueError, match="float32"):
        gru(xp_f, mask, wh_f.double())
    with pytest.raises(ValueError, match="mask"):
        bigru(xp_f, xp_b, mask[..., 0], wh_f, wh_b)
    with pytest.raises(ValueError, match="device"):
        gru(*(a.to("meta") for a in (xp_f, mask, wh_f)))


@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("batch", [1, 5, 9, 32])
@pytest.mark.parametrize("hidden", [8, 100, 256, 512])
def test_gru_geometry(hidden, batch, ndir):
    """The fit rule of the GRU kernels: every hidden unit owned by exactly
    one CTA of a cluster, with its three gate columns (the kernels' slice
    mapping: CTA k holds wh[:, q*H + u] for its units u, q = r, z, n); no
    CTA empty; every row group within the launch; shared memory within the
    H100's 232,448 B a block and equal to the kernels' layouts; the launch
    within the budget of resident clusters; H=512 on the wide design (16
    CTAs of 32 units, R=16 rows a cluster in two directions and R=8 in one
    at B=32), the rest on the cluster design, H=256 at B=32 in 8 clusters
    of R=4 rows (one direction) or R=8 (two)."""
    geo = gru_geometry(hidden, batch, ndir)
    assert max(geo.smem_fwd, geo.smem_bwd) <= 232_448
    assert geo.grid[0] % geo.ctas == 0 and geo.grid[2] == ndir
    assert geo.grid[1] * geo.rows >= batch > (geo.grid[1] - 1) * geo.rows
    if hidden == 512:
        assert geo.design == "wide"
        assert (geo.ctas, geo.units) == (16, WIDE_UNITS)
        assert geo.grid[1] * geo.grid[2] <= WIDE_BUDGET
        assert (geo.smem_fwd, geo.smem_bwd) == gru_wide_smem(geo.rows,
                                                             geo.ctas)
        if batch == 32:
            assert geo.rows == 8 * ndir
        return
    assert geo.design == "cluster"
    assert geo.ctas <= CLUSTER_CTAS and geo.rows in CLUSTER_ROWS
    assert geo.grid[1] * geo.grid[2] <= CLUSTER_BUDGET
    # every thread holds GRU_SLICE rows of one gate column
    assert 3 * geo.units * -(-hidden // GRU_SLICE) <= GRU_THREADS
    assert (geo.smem_fwd, geo.smem_bwd) == gru_cluster_smem(
        hidden, geo.units, geo.rows, geo.ctas)
    if (hidden, batch) == (256, 32):
        assert (geo.units, geo.rows) == (32, 4 * ndir)
        assert geo.grid[1] * geo.grid[2] == 8
    owner = {}
    for k in range(geo.ctas):
        units = range(k * geo.units, min(hidden, (k + 1) * geo.units))
        assert len(units) > 0
        for q in range(3):
            for u in units:
                col = q * hidden + u
                assert col not in owner
                owner[col] = k
    assert sorted(owner) == list(range(3 * hidden))
    assert all(len({owner[q * hidden + u] for q in range(3)}) == 1
               for u in range(hidden))


def _load_cell(cell, p):
    with torch.no_grad():
        for k in ("wx", "wh", "b"):
            getattr(cell, k).copy_(torch.from_numpy(np.array(p[k])))


@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bi", "uni"])
def test_rnn_layer_matches_jax_scan(bidirectional):
    t, b, f, h = 10, 3, 6, 8
    jl = JaxRNNLayer("gru", h, bidirectional)
    params = jl.init(jax.random.PRNGKey(3), f)
    rng = np.random.RandomState(3)
    for p in params.values():   # nonzero biases: the folding must hold
        p["b"] = jnp.asarray(rng.randn(3 * h).astype(np.float32))
    x = rng.randn(t, b, f).astype(np.float32)
    mask = (np.arange(t)[:, None] < np.array([t, 7, 4])[None, :]).astype(
        np.float32)[..., None]
    want = jl.apply(params, jnp.asarray(x), jnp.asarray(mask))
    layer = RNNLayer("gru", f, h, bidirectional)
    for name, p in params.items():
        _load_cell(getattr(layer, name), p)
    with torch.no_grad():
        got = layer(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.shape == (t, b, layer.output_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gru_cell_step_and_init_match_jax():
    cell_j = JaxGRUCell(7)
    p = cell_j.init(jax.random.PRNGKey(1), 5)
    p["b"] = jnp.linspace(-1.0, 1.0, 21)
    rng = np.random.RandomState(2)
    x = rng.randn(3, 5).astype(np.float32)
    h0 = rng.randn(3, 7).astype(np.float32)
    m = np.array([[1.0], [0.0], [1.0]], np.float32)
    (hj,), _ = cell_j.step(p, (jnp.asarray(h0),),
                           cell_j.input_proj(p, jnp.asarray(x)),
                           jnp.asarray(m))
    cell = GRUCell(5, 7, generator=torch.Generator().manual_seed(0))
    assert cell.wx.shape == (5, 21) and cell.wh.shape == (7, 21)
    assert float(cell.b.detach().abs().sum()) == 0.0
    for k in range(3):              # per-gate orthogonal blocks
        blk = cell.wh[:, 7 * k: 7 * (k + 1)].detach()
        torch.testing.assert_close(blk.T @ blk, torch.eye(7), atol=1e-5,
                                   rtol=0)
    _load_cell(cell, p)
    with torch.no_grad():
        (hp,), out = cell.step((torch.from_numpy(h0),),
                               cell.input_proj(torch.from_numpy(x)),
                               torch.from_numpy(m))
    np.testing.assert_allclose(hp.numpy(), np.asarray(hj), **TOL)
    np.testing.assert_array_equal(hp[1].numpy(), h0[1])   # held row


@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bi", "uni"])
def test_deep_gru_logits_match_jax(bidirectional):
    """The whole model: JAX deep_gru's initial weights carried across by the
    weight bridge (strict load), logits against the JAX CPU scan path."""
    hp = (f"num_hiddens=12,num_layers=2,dropout=0.0,"
          f"bidirectional={str(bidirectional).lower()}")
    jm = jax_deep_gru(hp, num_classes=27)
    params = jm.init(jax.random.PRNGKey(4), 39)
    flat = flatten_params(params)
    pm = build_model("deep_gru", hp, num_classes=27)
    pm.load_state_dict(params_from_flat(flat))          # strict
    back = flat_from_params(pm.state_dict())
    assert sorted(back) == sorted(flat)
    assert any("/bw/" in k for k in flat) == bidirectional
    rng = np.random.RandomState(5)
    x = rng.randn(3, 14, 39).astype(np.float32)
    lengths = np.array([14, 9, 5], np.int32)
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(lengths),
                               train=False))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(lengths))
    assert got.shape == want.shape == (3, 14, 28)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # the default constructor is the 3x256 bidirectional model
    m = deep_gru(generator=torch.Generator().manual_seed(0))
    assert len(m.rnn.layers) == 3 and m.rnn.output_dim == 512
    assert m.rnn.layers[0].rnn.fw.wh.shape == (256, 768)
