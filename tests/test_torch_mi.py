"""Port's multiplicative-integration LSTM (asr_study_torch/ops/mi_lstm.py
``bi_mi_lstm``, ``mi_lstm``, their backwards, ``dir_grads``,
``BiMILSTMFunction``, ``MILSTMFunction``; ``MILSTMCell``; ``mi_blstm``)
against the JAX package: the kernel calls of ``pallas_mi_lstm`` and
``pallas_bi_mi_lstm`` in interpret mode (forward h and c, backward dpre),
the VJPs of both ops, autodiff of the hold-state scan of the JAX cell on
held frames, and the JAX layer and model on their CPU scan paths from the
same weights.  On the CPU the wrappers take their plain versions, Python
loops over time."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_study_torch.models.cells import MILSTMCell
from asr_study_torch.models.rnn import RNNLayer
from asr_study_torch.models.zoo import build_model
from asr_study_torch.ops.mi_lstm import (BiMILSTMFunction, MILSTMFunction,
                                         bi_mi_lstm, bi_mi_lstm_bwd,
                                         bi_mi_lstm_bwd_plain,
                                         bi_mi_lstm_plain, dir_grads,
                                         mi_lstm, mi_lstm_bwd,
                                         mi_lstm_bwd_plain, mi_lstm_plain)
from asr_study_torch.utils.weights import (flat_from_params, load_npz,
                                           params_from_flat)
from asr_study_tpu.models import zoo as jzoo
from asr_study_tpu.models.cells import MILSTMCell as JaxMICell
from asr_study_tpu.models.rnn import RNNLayer as JaxRNNLayer
from asr_study_tpu.ops import pallas_bi_mi_lstm as jbi
from asr_study_tpu.ops import pallas_mi_lstm as jmi
# the exporter's own flattening: JAX tree -> tree-path keyed arrays
from extras.export_weights import _flatten as flatten_params

TOL = dict(rtol=1e-5, atol=1e-5)
# tests/test_pallas_mi_zoneout.py's gradient contract
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

SIZES = [(12, 4, 8), (17, 3, 16)]
# the backward cases at a prime T above 16: the JAX backward kernels then
# walk one frame a grid step (their chunk divides T), which traces fast
BWD_SIZES = [(19, 3, 8), (17, 2, 16)]
MASKS = pytest.mark.parametrize("full_mask", [False, True],
                                ids=["ragged", "full"])


def _inputs(seed, t, b, h, full_mask=False):
    """Seeded numpy arguments of both directions in the port's order ->
    (xp_f, xp_b, mask, wh_f, wh_b, alpha_f, alpha_b, beta1_f, beta1_b,
    beta2_f, beta2_b, b_f, b_b): the scales about 1 and b about 0, none
    exactly; a ragged mask [T, B, 1]."""
    rng = np.random.RandomState(seed)

    def near(centre):
        return (centre + 0.3 * rng.randn(4 * h)).astype(np.float32)

    xp = [rng.randn(t, b, 4 * h).astype(np.float32) for _ in range(2)]
    wh = [(rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)
          for _ in range(2)]
    vecs = [near(c) for c in (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0)]
    lengths = np.full(b, t) if full_mask else rng.randint(t // 2, t + 1, b)
    lengths[0] = t
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    return (xp[0], xp[1], mask[..., None], wh[0], wh[1], *vecs)


def _vecs(args, d):
    """Direction d's (alpha, beta1, beta2, b)."""
    return tuple(args[5 + 2 * k + d] for k in range(4))


def _uni(args):
    """The forward direction's arguments: (xp, mask, wh, alpha, beta1,
    beta2, b)."""
    return (args[0], args[2], args[3], *_vecs(args, 0))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _cotangents(seed, t, b, h):
    rng = np.random.RandomState(seed)
    return [rng.randn(t, b, h).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("t,b,h", SIZES)
@MASKS
def test_fwd_matches_pallas_kernel_calls(t, b, h, full_mask):
    """h and c of both directions (bi_mi_lstm) and of one (mi_lstm) against
    _bifwd_call and _fwd_call; held frames repeat the state of the last
    real one."""
    args = _inputs(h + t, t, b, h, full_mask)
    want = jbi._bifwd_call(*_j(args[:5]), _j(_vecs(args, 0)),
                           _j(_vecs(args, 1)), h, True)
    got = bi_mi_lstm(*_t(args))
    for name, g, w in zip(("h_f", "c_f", "h_b", "c_b"), got, want):
        assert g.shape == (t, b, h), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:t], **TOL,
                                   err_msg=name)
    want_uni = jmi._fwd_call(*_j(_uni(args)), h, True)
    got_uni = mi_lstm(*_t(_uni(args)))
    for name, g, w in zip(("h", "c"), got_uni, want_uni):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:t], **TOL,
                                   err_msg=name)
    lengths = args[2][..., 0].sum(0).astype(int)
    for i, n in enumerate(lengths):
        assert torch.equal(got_uni[1][n:, i],
                           got_uni[1][n - 1, i].expand(t - n, h))
        assert torch.equal(got[3][n:, i], torch.zeros(t - n, h))


@pytest.mark.parametrize("t,b,h", BWD_SIZES)
@MASKS
def test_bwd_matches_pallas_kernel_calls(t, b, h, full_mask):
    """dpre of both directions (bi_mi_lstm_bwd) and of one (mi_lstm_bwd)
    against _bibwd_call and _bwd_call, fed the JAX forward's h and c and
    cotangents on every frame."""
    args = _inputs(h + 1, t, b, h, full_mask)
    dh = _cotangents(h + 2, t, b, h)
    xf, xb, mask, whf, whb = _j(args[:5])
    vf, vb = _j(_vecs(args, 0)), _j(_vecs(args, 1))
    hf, cf, hb, cb = jbi._bifwd_call(xf, xb, mask, whf, whb, vf, vb, h, True)
    want = jbi._bibwd_call(xf, xb, mask, hf, cf, hb, cb, *_j(dh), whf, whb,
                           vf, vb, h, True)[:2]
    hc = [torch.tensor(np.asarray(a)[:t]) for a in (hf, cf, hb, cb)]
    got = bi_mi_lstm_bwd(*_t(args), *hc, *_t(dh))
    for name, g, w in zip(("dpre_f", "dpre_b"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)

    xp, jmask, wh, *vecs = _j(_uni(args))
    jh, jc = jmi._fwd_call(xp, jmask, wh, *vecs, h, True)
    want = jmi._bwd_call(xp, jmask, jh, jc, jnp.asarray(dh[0]), wh, *vecs,
                         h, True)[0]
    got = mi_lstm_bwd(*_t(_uni(args)), torch.tensor(np.asarray(jh)[:t]),
                      torch.tensor(np.asarray(jc)[:t]),
                      torch.from_numpy(dh[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dir_grads_match_jax():
    """dir_grads (dxp, dwh, dalpha, dbeta1, dbeta2, db from dpre) against
    the JAX package's, for both walk directions."""
    t, b, h = 9, 3, 8
    args = _inputs(4, t, b, h)
    rng = np.random.RandomState(5)
    dpre = rng.randn(t, b, 4 * h).astype(np.float32)
    hs = rng.randn(t, b, h).astype(np.float32)
    xp, _, wh, al, b1, b2, _ = _uni(args)
    zero = np.zeros((1, b, h), np.float32)
    for reverse, h_prev in ((False, np.concatenate([zero, hs[:-1]])),
                            (True, np.concatenate([hs[1:], zero]))):
        want = jmi.dir_grads(*_j((dpre, xp, h_prev, wh, al, b1, b2)))
        got = dir_grads(*_t((dpre, xp, hs, wh, al, b1, b2)), reverse)
        for name, g, w in zip(("dxp", "dwh", "dalpha", "dbeta1", "dbeta2",
                               "db"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=2e-5, err_msg=name)


def _port_grads(fn, arrays, cots):
    leaves = [torch.from_numpy(a).clone().requires_grad_() for a in arrays]
    outs = fn(*leaves)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cots])
    return [leaf.grad.numpy() for leaf in leaves]


@pytest.mark.parametrize("t,b,h", BWD_SIZES)
def test_functions_match_pallas_vjp(t, b, h):
    """Every gradient of BiMILSTMFunction (xp, wh, alpha, beta1, beta2 and
    b of both directions) and of MILSTMFunction against jax.vjp of
    pallas_bi_mi_lstm and pallas_mi_lstm in interpret mode."""
    args = _inputs(h + 3, t, b, h)
    dh = _cotangents(h + 4, t, b, h)
    diff = [a for i, a in enumerate(args) if i != 2]
    mask = args[2]
    jmask, tmask = jnp.asarray(mask), torch.from_numpy(mask)

    def jax_bi(xf, xb, whf, whb, *v):
        # port order: alpha_f, alpha_b, beta1_f, ... -> the JAX vecs
        return jbi.pallas_bi_mi_lstm(xf, xb, jmask, whf, whb, *v[0::2],
                                     *v[1::2], h, True)

    _, vjp = jax.vjp(jax_bi, *_j(diff))
    want = vjp(tuple(_j(dh)))
    got = _port_grads(lambda *a: BiMILSTMFunction.apply(a[0], a[1], tmask,
                                                        *a[2:]), diff, dh)
    names = ("dxp_f", "dxp_b", "dwh_f", "dwh_b", "dalpha_f", "dalpha_b",
             "dbeta1_f", "dbeta1_b", "dbeta2_f", "dbeta2_b", "db_f", "db_b")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL,
                                   err_msg=name)

    uni = diff[0::2]
    _, vjp = jax.vjp(lambda x, w, *v: jmi.pallas_mi_lstm(
        x, jmask, w, *v, h, True), *_j(uni))
    want = vjp(jnp.asarray(dh[0]))
    got = _port_grads(lambda x, w, *v: MILSTMFunction.apply(
        x, tmask, w, *v), uni, dh[:1])
    for name, g, w in zip(names[0::2], got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


def _perturbed(params, seed):
    """The JAX initial weights plus seeded noise: no scale is 1, no bias
    0."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(0.3 * rng.randn(*a.shape), a.dtype),
        params)


def test_held_frames_match_autodiff_of_scan():
    """A loss over all frames, padded ones included, where h and c are held:
    their cotangents must pass straight back to the last real frame, with
    dc_prev = dc_next there (tests/test_pallas_mi_zoneout.py's
    unmasked-loss case).  MILSTMFunction against jax.grad through lax.scan
    of the JAX MILSTMCell's step, for the input projection, wh and the four
    vectors."""
    t, b, f, h = 11, 3, 5, 8
    cell = JaxMICell(h)
    params = _perturbed(cell.init(jax.random.PRNGKey(0), f), 8)
    rng = np.random.RandomState(9)
    x = jnp.asarray(rng.randn(t, b, f).astype(np.float32))
    mask = (np.arange(t)[:, None] < np.array([11, 7, 5])[None, :]).astype(
        np.float32)[..., None]
    jmask = jnp.asarray(mask)
    xp = cell.input_proj(params, x)
    names = ("wh", "alpha", "beta1", "beta2", "b")

    def scan_loss(xp_in, *vals):
        p = dict(params, **dict(zip(names, vals)))
        _, outs = jax.lax.scan(lambda carry, inp: cell.step(p, carry, *inp),
                               cell.init_carry(b), (xp_in, jmask))
        return jnp.sum(outs ** 2)

    leaves = [torch.tensor(np.asarray(a)).requires_grad_()
              for a in (xp, *(params[k] for k in names))]
    out = MILSTMFunction.apply(leaves[0], torch.from_numpy(mask), *leaves[1:])
    (out ** 2).sum().backward()
    got = [leaf.grad.numpy() for leaf in leaves]
    want = jax.grad(scan_loss, argnums=tuple(range(6)))(
        xp, *(params[k] for k in names))
    for name, g, w in zip(("dxp",) + names, got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL, err_msg=name)
    # the held frames' own pre-activations get nothing
    assert np.abs(got[0][mask[..., 0] == 0]).max() == 0.0


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_layer_matches_jax(bidirectional):
    """RNNLayer('mi_lstm') against the JAX layer on its CPU scan path, from
    perturbed weights loaded strictly."""
    t, b, f, h = 10, 3, 6, 8
    jlayer = JaxRNNLayer("mi_lstm", h, bidirectional=bidirectional)
    params = _perturbed(jlayer.init(jax.random.PRNGKey(3), f), 4)
    flat = flatten_params(params)
    assert all(np.all(v != 1.0) and np.all(v != 0.0) for v in flat.values())
    rng = np.random.RandomState(5)
    x = rng.randn(t, b, f).astype(np.float32)
    mask = (np.arange(t)[:, None] < np.array([t, 7, 4])[None, :]).astype(
        np.float32)[..., None]
    want = jlayer.apply(params, jnp.asarray(x), jnp.asarray(mask))
    layer = RNNLayer("mi_lstm", f, h, bidirectional)
    layer.load_state_dict(params_from_flat(flat))           # strict
    with torch.no_grad():
        got = layer(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.shape == (t, b, layer.output_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_mi_blstm_logits_match_jax(bidirectional, tmp_path):
    """The whole model: JAX weights carried across by an export_weights
    style .npz (load_npz, then a strict load; the same key set both ways,
    alpha, beta1 and beta2 included), logits against the JAX CPU scan
    path."""
    hp = ("num_hiddens=8,num_layers=2,bidirectional="
          f"{str(bidirectional).lower()}")
    jm = jzoo.mi_blstm(hp, num_classes=27)
    params = _perturbed(jm.init(jax.random.PRNGKey(4), 39), 5)
    npz = str(tmp_path / "mi.npz")
    np.savez(npz, __meta__='{"model": "mi_blstm"}', **flatten_params(params))
    flat, meta = load_npz(npz)
    assert meta["model"] == "mi_blstm"
    pm = build_model("mi_blstm", hp, num_classes=27)
    pm.load_state_dict(params_from_flat(flat))
    assert sorted(flat_from_params(pm.state_dict())) == sorted(flat)
    assert any(k.endswith("/fw/beta2") for k in flat)
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
    # strict: a file without the MI vectors does not load
    del flat["rnn/layers/0/rnn/fw/alpha"]
    with pytest.raises(RuntimeError, match="alpha"):
        pm.load_state_dict(params_from_flat(flat))


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_mi_blstm_default_structure_matches_jax(bidirectional):
    """At the default size (3x256): the port's state_dict holds the JAX
    tree's keys and shapes exactly, alpha, beta1 and beta2 included."""
    hp = f"bidirectional={str(bidirectional).lower()}"
    jm = jzoo.mi_blstm(hp, num_classes=27)
    shapes = jax.eval_shape(lambda k: jm.init(k, 39), jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten_params(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               shapes)).items()}
    pm = build_model("mi_blstm", hp, num_classes=27,
                     generator=torch.Generator().manual_seed(0))
    got = {k.replace(".", "/"): tuple(v.shape)
           for k, v in pm.state_dict().items()}
    assert got == want
    assert got["rnn/layers/2/rnn/fw/alpha"] == (1024,)


def test_cell_step_matches_jax_step():
    """MILSTMCell.step against the JAX cell's step on one frame with a held
    row."""
    b, f, h = 3, 5, 6
    jcell = JaxMICell(h)
    params = _perturbed(jcell.init(jax.random.PRNGKey(1), f), 2)
    cell = MILSTMCell(f, h)
    cell.load_state_dict(params_from_flat(flatten_params(params)))
    rng = np.random.RandomState(3)
    h0, c0 = [rng.randn(b, h).astype(np.float32) for _ in range(2)]
    xp_t = rng.randn(b, 4 * h).astype(np.float32)
    m = np.array([[1.0], [0.0], [1.0]], np.float32)
    (hj, cj), _ = jcell.step(params, (jnp.asarray(h0), jnp.asarray(c0)),
                             jnp.asarray(xp_t), jnp.asarray(m))
    with torch.no_grad():
        (hp, cp), out = cell.step((torch.from_numpy(h0), torch.from_numpy(c0)),
                                  torch.from_numpy(xp_t), torch.from_numpy(m))
    np.testing.assert_allclose(hp.numpy(), np.asarray(hj), **TOL)
    np.testing.assert_allclose(cp.numpy(), np.asarray(cj), **TOL)
    assert torch.equal(out, hp)


def test_wrappers_take_plain_on_cpu_and_check():
    args = _t(_inputs(1, 6, 3, 5))
    uni = _t(_uni(_inputs(1, 6, 3, 5)))
    dh = torch.from_numpy(_cotangents(2, 6, 3, 5)[0])
    counts = [f.launches for f in (bi_mi_lstm, mi_lstm, bi_mi_lstm_bwd,
                                   mi_lstm_bwd)]
    h, c = mi_lstm(*uni)
    h_f, c_f, h_b, c_b = bi_mi_lstm(*args)
    assert torch.equal(h, h_f) and torch.equal(c, c_f)
    torch.testing.assert_close((h, c), mi_lstm_plain(*uni), rtol=0, atol=0)
    torch.testing.assert_close(bi_mi_lstm_plain(*args), (h_f, c_f, h_b, c_b),
                               rtol=0, atol=0)
    got = mi_lstm_bwd(*uni, h, c, dh)
    torch.testing.assert_close(got, mi_lstm_bwd_plain(*uni, h, c, dh),
                               rtol=0, atol=0)
    got_bi = bi_mi_lstm_bwd(*args, h_f, c_f, h_b, c_b, dh, dh)
    torch.testing.assert_close(got_bi, bi_mi_lstm_bwd_plain(
        *args, h_f, c_f, h_b, c_b, dh, dh), rtol=0, atol=0)
    assert counts == [f.launches for f in (bi_mi_lstm, mi_lstm,
                                           bi_mi_lstm_bwd, mi_lstm_bwd)]
    xp, mask, wh, al, b1, b2, b = uni
    with pytest.raises(ValueError, match="alpha"):
        mi_lstm(xp, mask, wh, al[:-1], b1, b2, b)
    with pytest.raises(ValueError, match="beta2"):
        mi_lstm(xp, mask, wh, al, b1, b2.double(), b)
    with pytest.raises(ValueError, match="dh"):
        mi_lstm_bwd(*uni, h, c, dh[:-1])
    with pytest.raises(ValueError, match="device"):
        mi_lstm(*(a.to("meta") for a in uni))
