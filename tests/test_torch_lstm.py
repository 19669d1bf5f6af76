"""Port's unidirectional LSTM (asr_study_torch/ops/bilstm.py ``lstm``,
``lstm_bwd``, ``LSTMFunction``) against the JAX kernel ``pallas_lstm`` in
interpret mode, forward and backward (its custom VJP and the kernel call's
own dxp), against autodiff of the hold-state scan on held frames and against
``nn.LSTM``; and the plain-LSTM zoo (uni- and bidirectional layers, the
residual and highway skips, the Deep Speech front end) against the JAX scan
path from the same weights.  On the CPU the wrappers take their plain
versions, Python loops over time."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_study_torch.models.cells import lstm_step
from asr_study_torch.models.rnn import RNNLayer, StackedRNN
from asr_study_torch.models.zoo import build_model
from asr_study_torch.ops.bilstm import (CLUSTER_SLICE, CLUSTER_THREADS,
                                        LSTMFunction, bilstm, bilstm_bwd,
                                        cluster_smem, lstm, lstm_bwd,
                                        lstm_bwd_plain, lstm_geometry,
                                        lstm_plain, wide_smem)
from asr_study_torch.ops.recurrence import (CLUSTER_BUDGET, CLUSTER_CTAS,
                                            CLUSTER_ROWS, WIDE_BUDGET,
                                            WIDE_MAX_HIDDEN, WIDE_ROWS,
                                            WIDE_UNITS)
from asr_study_torch.utils.weights import flat_from_params, params_from_flat
from asr_study_tpu.models import zoo as jzoo
from asr_study_tpu.models.cells import LSTMCell as JaxLSTMCell
from asr_study_tpu.models.rnn import RNNLayer as JaxRNNLayer
from asr_study_tpu.ops import pallas_lstm as jl
# the exporter's own flattening: JAX tree -> tree-path keyed arrays
from extras.export_weights import _flatten as flatten_params

TOL = dict(rtol=1e-5, atol=1e-5)    # tests/test_pallas_lstm.py's contract
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(seed, t, b, h, full_mask=False):
    """Seeded numpy inputs: xp [T,B,4H], ragged mask [T,B,1], wh [H,4H]
    (orthogonal-like scale)."""
    rng = np.random.RandomState(seed)
    xp = rng.randn(t, b, 4 * h).astype(np.float32)
    lengths = np.full(b, t) if full_mask else rng.randint(t // 2, t + 1, b)
    lengths[0] = t
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    wh = (rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)
    return xp, mask[..., None], wh


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


SIZES = [(12, 4, 8), (17, 3, 20)]
MASKS = pytest.mark.parametrize("full_mask", [False, True],
                                ids=["ragged", "full"])


@pytest.mark.parametrize("t,b,h", SIZES)
@MASKS
def test_lstm_plain_matches_pallas_lstm(t, b, h, full_mask):
    """h and c against the JAX kernel call, h against the public op; held
    frames repeat the state of the last real one."""
    args = _inputs(h, t, b, h, full_mask)
    jargs = list(map(jnp.asarray, args))
    want_h, want_c = jl._fwd_call(*jargs, h, interpret=True)
    got_h, got_c = lstm(*_t(args))
    for name, g, w in (("h", got_h, want_h), ("c", got_c, want_c)):
        assert g.shape == (t, b, h), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:t], **TOL,
                                   err_msg=name)
    np.testing.assert_allclose(
        got_h.numpy(), np.asarray(jl.pallas_lstm(*jargs, h, interpret=True)),
        **TOL)
    lengths = args[1][..., 0].sum(0).astype(int)
    for i, n in enumerate(lengths):
        assert torch.equal(got_h[n:, i], got_h[n - 1, i].expand(t - n, h))


@pytest.mark.parametrize("t,b,h", SIZES)
@MASKS
def test_lstm_bwd_matches_pallas(t, b, h, full_mask):
    """lstm_bwd_plain's dxp against the JAX kernel call's, and
    LSTMFunction's dxp and dwh against jax.vjp of pallas_lstm, with
    cotangents on every output frame."""
    xp, mask, wh = _inputs(h + 1, t, b, h, full_mask)
    dh = np.random.RandomState(h + 2).randn(t, b, h).astype(np.float32)
    jxp, jmask, jwh = map(jnp.asarray, (xp, mask, wh))
    jh, jc = jl._fwd_call(jxp, jmask, jwh, h, interpret=True)
    want = jl._bwd_call(jxp, jmask, jh, jc, jnp.asarray(dh), jwh, h,
                        interpret=True)[0]
    txp, tmask, twh = _t((xp, mask, wh))
    got = lstm_bwd_plain(txp, tmask, twh, *lstm_plain(txp, tmask, twh),
                         torch.from_numpy(dh))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)

    _, vjp = jax.vjp(lambda x, w: jl.pallas_lstm(x, jmask, w, h,
                                                 interpret=True), jxp, jwh)
    want = vjp(jnp.asarray(dh))
    leaves = [a.clone().requires_grad_() for a in (txp, twh)]
    (LSTMFunction.apply(leaves[0], tmask, leaves[1])
     * torch.from_numpy(dh)).sum().backward()
    for name, leaf, w in zip(("dxp", "dwh"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   **GRAD_TOL, err_msg=name)


def test_held_frames_match_autodiff_of_scan():
    """A loss over all frames, padded ones included, where h and c are held:
    their cotangents must pass straight back to the last real frame, with
    dc_prev = dc_next there (tests/test_pallas_lstm.py's unmasked-loss
    case).  LSTMFunction against torch autograd through an lstm_step loop,
    jax.grad through lax.scan of the JAX LSTMCell.step, and jax.grad
    through pallas_lstm in interpret mode."""
    t, b, h = 10, 4, 8
    xp, mask, wh = _inputs(7, t, b, h)
    mask[:, 1:] = (np.arange(t)[:, None] < np.array([3, 6, 9])[None, :]
                   )[..., None]
    tmask = torch.from_numpy(mask)

    def port(fn):
        leaves = [torch.from_numpy(a).clone().requires_grad_()
                  for a in (xp, wh)]
        (fn(*leaves) ** 2).sum().backward()
        return [leaf.grad.numpy() for leaf in leaves]

    def through_steps(x, w):
        hc = (x.new_zeros((b, h)), x.new_zeros((b, h)))
        hs = []
        for s in range(t):
            hc = lstm_step(*hc, x[s], tmask[s], w)
            hs.append(hc[0])
        return torch.stack(hs)

    cell = JaxLSTMCell(h)
    p0 = {"b": jnp.zeros((4 * h,), jnp.float32)}
    jmask = jnp.asarray(mask)

    def scan_loss(x, w):
        _, outs = jax.lax.scan(
            lambda carry, inp: cell.step(dict(p0, wh=w), carry, *inp),
            cell.init_carry(b), (x, jmask))
        return jnp.sum(outs ** 2)

    def pallas_loss(x, w):
        return jnp.sum(jl.pallas_lstm(x, jmask, w, h, interpret=True) ** 2)

    got = port(lambda x, w: LSTMFunction.apply(x, tmask, w))
    for ref in (port(through_steps),
                jax.grad(scan_loss, argnums=(0, 1))(jnp.asarray(xp),
                                                    jnp.asarray(wh)),
                jax.grad(pallas_loss, argnums=(0, 1))(jnp.asarray(xp),
                                                      jnp.asarray(wh))):
        for name, g, w in zip(("dxp", "dwh"), got, ref):
            np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL,
                                       err_msg=name)
    # the held frames' own pre-activations get nothing
    assert np.abs(got[0][mask[..., 0] == 0]).max() == 0.0


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_layer_matches_nn_lstm(bidirectional):
    """RNNLayer('lstm') against torch's nn.LSTM on a packed batch, with
    ``bias_hh`` zero (the port folds every bias into ``x @ wx + b``) and
    ``weight_hh = wh^T``; the same gate order i, f, g, o."""
    t, b, f, h = 9, 3, 5, 6
    layer = RNNLayer("lstm", f, h, bidirectional,
                     generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    cells = [layer.fw, layer.bw] if bidirectional else [layer.fw]
    with torch.no_grad():
        for cell in cells:
            cell.b.copy_(torch.from_numpy(rng.randn(4 * h).astype(
                np.float32)))
    x = torch.from_numpy(rng.randn(t, b, f).astype(np.float32))
    lengths = torch.tensor([t, 6, 2])
    mask = (torch.arange(t)[:, None] < lengths[None, :]).float()[..., None]
    ref = torch.nn.LSTM(f, h, bidirectional=bidirectional)
    with torch.no_grad():
        for sfx, cell in zip(("", "_reverse"), cells):
            getattr(ref, "weight_ih_l0" + sfx).copy_(cell.wx.t())
            getattr(ref, "weight_hh_l0" + sfx).copy_(cell.wh.t())
            getattr(ref, "bias_ih_l0" + sfx).copy_(cell.b)
            getattr(ref, "bias_hh_l0" + sfx).zero_()
        packed = torch.nn.utils.rnn.pack_padded_sequence(x, lengths)
        want, _ = torch.nn.utils.rnn.pad_packed_sequence(ref(packed)[0],
                                                         total_length=t)
        got = layer(x, mask)
    assert got.shape == (t, b, layer.output_dim)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_uni_layer_matches_jax_scan():
    """A unidirectional RNNLayer('lstm') against the JAX layer on its CPU
    scan path, nonzero biases."""
    t, b, f, h = 10, 3, 6, 8
    jlayer = JaxRNNLayer("lstm", h, bidirectional=False)
    params = jlayer.init(jax.random.PRNGKey(3), f)
    rng = np.random.RandomState(3)
    params["fw"]["b"] = jnp.asarray(rng.randn(4 * h).astype(np.float32))
    x = rng.randn(t, b, f).astype(np.float32)
    mask = (np.arange(t)[:, None] < np.array([t, 7, 4])[None, :]).astype(
        np.float32)[..., None]
    want = jlayer.apply(params, jnp.asarray(x), jnp.asarray(mask))
    layer = RNNLayer("lstm", f, h, bidirectional=False)
    with torch.no_grad():
        for k in ("wx", "wh", "b"):
            getattr(layer.fw, k).copy_(torch.from_numpy(np.array(
                params["fw"][k])))
        got = layer(torch.from_numpy(x), torch.from_numpy(mask))
    assert not hasattr(layer, "bw")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrappers_take_plain_on_cpu_and_check():
    xp, mask, wh = _t(_inputs(1, 6, 3, 5))
    dh = torch.from_numpy(
        np.random.RandomState(2).randn(6, 3, 5).astype(np.float32))
    counts = [f.launches for f in (bilstm, lstm, bilstm_bwd, lstm_bwd)]
    h, c = lstm(xp, mask, wh)
    h_f, c_f, _, _ = bilstm(xp, xp, mask, wh, wh)
    torch.testing.assert_close(h, h_f, rtol=0, atol=0)
    torch.testing.assert_close(c, c_f, rtol=0, atol=0)
    dxp = lstm_bwd(xp, mask, wh, h, c, dh)
    torch.testing.assert_close(dxp, lstm_bwd_plain(xp, mask, wh, h, c, dh),
                               rtol=0, atol=0)
    assert counts == [f.launches for f in (bilstm, lstm, bilstm_bwd,
                                           lstm_bwd)]
    with pytest.raises(ValueError, match="dh"):
        lstm_bwd(xp, mask, wh, h, c, dh[:-1])
    with pytest.raises(ValueError, match="4H"):
        lstm(xp[..., :-1], mask, wh)
    with pytest.raises(ValueError, match="float32"):
        lstm(xp, mask, wh.double())
    with pytest.raises(ValueError, match="mask"):
        lstm(xp, mask[..., 0], wh)
    with pytest.raises(ValueError, match="device"):
        lstm(*(a.to("meta") for a in (xp, mask, wh)))


@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("batch", [1, 5, 9, 32])
@pytest.mark.parametrize("hidden", [8, 100, 256, 512])
def test_lstm_geometry(hidden, batch, ndir):
    """The fit rule of the LSTM kernels: every hidden unit owned by exactly
    one CTA of a cluster, with its four gate columns (the kernels' slice
    mapping: CTA k holds wh[:, q*H + u] for its units u, q = i, f, g, o);
    no CTA empty; every row group within the launch; shared memory within
    the H100's 232,448 B a block; the grid a whole number of clusters; the
    launch within the budget of resident clusters; H=512 on the wide design
    (16 CTAs of 32 units, each thread's 128 register rows and 128 shared
    rows of one column covering the 512 rows), the rest on the cluster
    design."""
    geo = lstm_geometry(hidden, batch, ndir)
    assert max(geo.smem_fwd, geo.smem_bwd) <= 232_448
    assert geo.grid[0] % geo.ctas == 0 and geo.grid[2] == ndir
    assert geo.grid[1] * geo.rows >= batch > (geo.grid[1] - 1) * geo.rows
    if hidden == 512:
        assert geo.design == "wide"
        assert (geo.ctas, geo.units) == (16, 32) == (WIDE_MAX_HIDDEN // 32,
                                                      WIDE_UNITS)
        assert geo.rows in WIDE_ROWS
        assert geo.grid[1] * geo.grid[2] <= WIDE_BUDGET
        assert (geo.smem_fwd, geo.smem_bwd) == wide_smem(geo.rows, geo.ctas)
        # 2 threads a gate column, each 128 rows in registers + 128 shared
        assert 2 * 4 * geo.units == CLUSTER_THREADS
        assert 2 * 2 * CLUSTER_SLICE >= hidden
    else:
        assert geo.design == "cluster"
        assert geo.ctas <= CLUSTER_CTAS and geo.rows in CLUSTER_ROWS
        assert geo.grid[1] * geo.grid[2] <= CLUSTER_BUDGET
        # every thread holds CLUSTER_SLICE rows of one gate column
        assert 4 * geo.units * -(-hidden // CLUSTER_SLICE) <= CLUSTER_THREADS
        assert (geo.smem_fwd, geo.smem_bwd) == cluster_smem(
            hidden, geo.units, geo.rows, geo.ctas)
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
    assert all(len({owner[q * hidden + u] for q in range(4)}) == 1
               for u in range(hidden))


def test_stack_refuses_unknown_skip():
    with pytest.raises(ValueError, match="skip"):
        StackedRNN(5, skip="dense")


# name -> JAX constructor; every constructor on the plain LSTMCell
JAX_ZOO = {"graves2006": jzoo.graves2006, "deep_blstm": jzoo.deep_blstm,
           "highway_blstm": jzoo.highway_blstm,
           "residual_blstm": jzoo.residual_blstm,
           "deep_speech": jzoo.deep_speech}
SMALL = "num_hiddens=8,num_layers=2,input_dense=16"


def _perturbed(params, seed):
    """The JAX initial weights plus seeded noise, so that every bias
    (forget, proj, gate, front) is nonzero."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(0.3 * rng.randn(*a.shape), a.dtype),
        params)


@pytest.mark.parametrize("name,bidirectional", [
    ("graves2006", False), ("deep_blstm", False),
    ("highway_blstm", True), ("highway_blstm", False),
    ("residual_blstm", True), ("residual_blstm", False),
    ("deep_speech", True), ("deep_speech", False),
])
def test_zoo_logits_match_jax(name, bidirectional):
    """The whole model: JAX weights carried across by the weight bridge
    (strict load, the same key set both ways), logits against the JAX CPU
    scan path.  The deep_speech inputs are scaled so that the front end's
    ReLU clip at 20 fires."""
    hp = f"{SMALL},bidirectional={str(bidirectional).lower()}"
    jm = JAX_ZOO[name](hp, num_classes=27)
    params = _perturbed(jm.init(jax.random.PRNGKey(4), 39), 5)
    flat = flatten_params(params)
    pm = build_model(name, hp, num_classes=27)
    pm.load_state_dict(params_from_flat(flat))          # strict
    assert sorted(flat_from_params(pm.state_dict())) == sorted(flat)
    assert any("/bw/" in k for k in flat) == bidirectional
    rng = np.random.RandomState(6)
    x = rng.randn(3, 14, 39).astype(np.float32)
    if name == "deep_speech":
        x *= 25.0
        first = np.maximum(x @ flat["front/0/w"] + flat["front/0/b"], 0)
        assert (first > 20.0).any() and (first == 0.0).any()
    lengths = np.array([14, 9, 5], np.int32)
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(lengths),
                               train=False))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(lengths))
    assert got.shape == want.shape == (3, 14, 28)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(JAX_ZOO))
@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_zoo_default_structure_matches_jax(name, bidirectional):
    """At each constructor's default size: the port's state_dict holds the
    JAX tree's keys and shapes exactly (proj only where a layer changes the
    width, a gate in every highway layer, the front end's dense layers)."""
    hp = f"bidirectional={str(bidirectional).lower()}"
    jm = JAX_ZOO[name](hp, num_classes=27)
    shapes = jax.eval_shape(lambda k: jm.init(k, 39), jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten_params(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               shapes)).items()}
    pm = build_model(name, hp, num_classes=27,
                     generator=torch.Generator().manual_seed(0))
    got = {k.replace(".", "/"): tuple(v.shape)
           for k, v in pm.state_dict().items()}
    assert got == want
    assert pm.input_dim == 39
