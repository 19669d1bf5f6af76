"""Port's zoneout LSTM (asr_study_torch/ops/zoneout_lstm.py
``bi_zoneout_lstm``, ``zoneout_lstm``, their backwards,
``BiZoneoutLSTMFunction``, ``ZoneoutLSTMFunction``; ``ZoneoutLSTMCell``,
``zoneout_mix``; ``zoneout_blstm``) against the JAX package: the kernel
calls of ``pallas_zoneout_lstm`` and ``pallas_bi_zoneout_lstm`` in interpret
mode with the same mix weights (Bernoulli samples and the eval constant),
the VJPs of both ops, autodiff of a scan of ``_zo_cell_math`` on held
frames, and the JAX layer and model on their CPU scan paths in eval mode
from the same weights.  On the CPU the wrappers take their plain versions,
Python loops over time."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_study_torch.models.cells import ZoneoutLSTMCell, zoneout_mix
from asr_study_torch.models.rnn import RNNLayer
from asr_study_torch.models.zoo import build_model
from asr_study_torch.ops.bilstm import bilstm_plain
from asr_study_torch.ops.zoneout_lstm import (BiZoneoutLSTMFunction,
                                              ZoneoutLSTMFunction,
                                              bi_zoneout_lstm,
                                              bi_zoneout_lstm_bwd,
                                              bi_zoneout_lstm_bwd_plain,
                                              bi_zoneout_lstm_plain,
                                              zoneout_lstm, zoneout_lstm_bwd,
                                              zoneout_lstm_bwd_plain,
                                              zoneout_lstm_plain)
from asr_study_torch.utils.weights import flat_from_params, params_from_flat
from asr_study_tpu.models import zoo as jzoo
from asr_study_tpu.models.rnn import RNNLayer as JaxRNNLayer
from asr_study_tpu.ops import pallas_bi_zoneout_lstm as jbi
from asr_study_tpu.ops import pallas_zoneout_lstm as jzo
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
# mix weights: Bernoulli(0.9) samples (train) or the constant 0.9 (eval)
MIXES = pytest.mark.parametrize("mix", ["bernoulli", "constant"])


def _inputs(seed, t, b, h, full_mask=False, mix="bernoulli"):
    """Seeded numpy arguments of both directions in the port's order ->
    (xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f, wh_b); a ragged mask
    [T, B, 1]; the mix weights [T, B, H] in forward time order."""
    rng = np.random.RandomState(seed)
    xp = [rng.randn(t, b, 4 * h).astype(np.float32) for _ in range(2)]
    wh = [(rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)
          for _ in range(2)]
    if mix == "bernoulli":
        z = [(rng.rand(t, b, h) < 0.9).astype(np.float32) for _ in range(4)]
        assert all(0.0 < a.mean() < 1.0 for a in z)
    else:
        z = [np.full((t, b, h), 0.9, np.float32) for _ in range(4)]
    lengths = np.full(b, t) if full_mask else rng.randint(t // 2, t + 1, b)
    lengths[0] = t
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    return (xp[0], xp[1], mask[..., None], z[0], z[1], z[2], z[3], wh[0],
            wh[1])


def _jax_order(args):
    """The port's argument order -> pallas_bi_zoneout_lstm's (xp_f, xp_b,
    mask, zh_f, zc_f, zh_b, zc_b, wh_f, wh_b)."""
    return tuple(args[i] for i in (0, 1, 2, 3, 5, 4, 6, 7, 8))


def _uni(args):
    """The forward direction's arguments: (xp, mask, zh, zc, wh)."""
    return tuple(args[i] for i in (0, 2, 3, 5, 7))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _cotangents(seed, t, b, h):
    rng = np.random.RandomState(seed)
    return [rng.randn(t, b, h).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("t,b,h", SIZES)
@MASKS
@MIXES
def test_fwd_matches_pallas_kernel_calls(t, b, h, full_mask, mix):
    """Mixed h and c of both directions (bi_zoneout_lstm) and of one
    (zoneout_lstm) against _bifwd_call and _fwd_call with the same mix
    weights; held frames repeat the state of the last real one."""
    args = _inputs(h + t, t, b, h, full_mask, mix)
    want = jbi._bifwd_call(*map(jnp.asarray, _jax_order(args)), h, True)
    got = bi_zoneout_lstm(*_t(args))
    for name, g, w in zip(("h_f", "c_f", "h_b", "c_b"), got, want):
        assert g.shape == (t, b, h), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:t], **TOL,
                                   err_msg=name)
    want_uni = jzo._fwd_call(*map(jnp.asarray, _uni(args)), h, True)
    got_uni = zoneout_lstm(*_t(_uni(args)))
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
@MIXES
def test_bwd_matches_pallas_kernel_calls(t, b, h, full_mask, mix):
    """dxp of both directions (bi_zoneout_lstm_bwd) and of one
    (zoneout_lstm_bwd) against _bibwd_call and _bwd_call, fed the JAX
    forward's mixed h and c and cotangents on every frame."""
    args = _inputs(h + 1, t, b, h, full_mask, mix)
    dh = _cotangents(h + 2, t, b, h)
    xf, xb, mask, zhf, zcf, zhb, zcb, whf, whb = map(jnp.asarray,
                                                     _jax_order(args))
    hf, cf, hb, cb = jbi._bifwd_call(xf, xb, mask, zhf, zcf, zhb, zcb, whf,
                                     whb, h, True)
    want = jbi._bibwd_call(xf, xb, mask, zhf, zcf, zhb, zcb, hf, cf, hb, cb,
                           *map(jnp.asarray, dh), whf, whb, h, True)[:2]
    hc = [torch.tensor(np.asarray(a)[:t]) for a in (hf, cf, hb, cb)]
    got = bi_zoneout_lstm_bwd(*_t(args), *hc, *_t(dh))
    for name, g, w in zip(("dxp_f", "dxp_b"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)

    xp, jmask, zh, zc, wh = map(jnp.asarray, _uni(args))
    jh, jc = jzo._fwd_call(xp, jmask, zh, zc, wh, h, True)
    want = jzo._bwd_call(xp, jmask, zh, zc, jh, jc, jnp.asarray(dh[0]), wh,
                         h, True)[0]
    got = zoneout_lstm_bwd(*_t(_uni(args)), torch.tensor(np.asarray(jh)[:t]),
                           torch.tensor(np.asarray(jc)[:t]),
                           torch.from_numpy(dh[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _port_grads(fn, arrays, cots):
    leaves = [torch.from_numpy(a).clone().requires_grad_() for a in arrays]
    outs = fn(*leaves)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cots])
    return [leaf.grad.numpy() for leaf in leaves]


@pytest.mark.parametrize("t,b,h", BWD_SIZES)
@MIXES
def test_functions_match_pallas_vjp(t, b, h, mix):
    """Every gradient of BiZoneoutLSTMFunction (xp and wh of both
    directions) and of ZoneoutLSTMFunction against jax.vjp of
    pallas_bi_zoneout_lstm and pallas_zoneout_lstm in interpret mode, with
    the same mix weights; the mix weights get none."""
    args = _inputs(h + 3, t, b, h, mix=mix)
    dh = _cotangents(h + 4, t, b, h)
    xf, xb, mask, zhf, zhb, zcf, zcb, whf, whb = args
    jz = [jnp.asarray(a) for a in (zhf, zcf, zhb, zcb)]
    jmask = jnp.asarray(mask)
    tz = _t((zhf, zhb, zcf, zcb))
    tmask = torch.from_numpy(mask)

    _, vjp = jax.vjp(lambda a, b_, c, d: jbi.pallas_bi_zoneout_lstm(
        a, b_, jmask, *jz, c, d, h, True), *map(jnp.asarray,
                                                 (xf, xb, whf, whb)))
    want = vjp(tuple(map(jnp.asarray, dh)))
    got = _port_grads(lambda a, b_, c, d: BiZoneoutLSTMFunction.apply(
        a, b_, tmask, *tz, c, d), (xf, xb, whf, whb), dh)
    for name, g, w in zip(("dxp_f", "dxp_b", "dwh_f", "dwh_b"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL,
                                   err_msg=name)

    _, vjp = jax.vjp(lambda x, w: jzo.pallas_zoneout_lstm(
        x, jmask, jz[0], jz[1], w, h, True), jnp.asarray(xf),
        jnp.asarray(whf))
    want = vjp(jnp.asarray(dh[0]))
    got = _port_grads(lambda x, w: ZoneoutLSTMFunction.apply(
        x, tmask, tz[0], tz[2], w), (xf, whf), dh[:1])
    for name, g, w in zip(("dxp", "dwh"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL,
                                   err_msg=name)

    zs = [torch.from_numpy(a).requires_grad_() for a in (zhf, zcf)]
    out = ZoneoutLSTMFunction.apply(torch.from_numpy(xf), tmask, *zs,
                                    torch.from_numpy(whf))
    out.sum().backward()
    assert all(z.grad is None for z in zs)


def test_held_frames_match_autodiff_of_scan():
    """A loss over all frames, padded ones included, where h and c are held:
    their cotangents must pass straight back to the last real frame, and a
    real frame passes dh * (1 - zh) and dc * (1 - zc) past the cell
    (tests/test_pallas_mi_zoneout.py's unmasked-loss case).
    ZoneoutLSTMFunction against jax.grad through lax.scan of the JAX
    package's _zo_cell_math with the same Bernoulli mix weights."""
    t, b, h = 11, 3, 8
    rng = np.random.RandomState(9)
    xp = rng.randn(t, b, 4 * h).astype(np.float32)
    wh = (rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)
    zh, zc = [(rng.rand(t, b, h) < 0.7).astype(np.float32)
              for _ in range(2)]
    mask = (np.arange(t)[:, None] < np.array([11, 7, 5])[None, :]).astype(
        np.float32)[..., None]

    def scan_loss(xp_in, w):
        def body(carry, inp):
            x_t, zh_t, zc_t, m_t = inp
            h_new, c_new = jzo._zo_cell_math(x_t, zh_t, zc_t, *carry, m_t,
                                             w, h)
            return (h_new, c_new), h_new

        zero = jnp.zeros((b, h), jnp.float32)
        _, outs = jax.lax.scan(body, (zero, zero),
                               (xp_in, jnp.asarray(zh), jnp.asarray(zc),
                                jnp.asarray(mask)))
        return jnp.sum(outs ** 2)

    leaves = [torch.from_numpy(a).clone().requires_grad_() for a in (xp, wh)]
    out = ZoneoutLSTMFunction.apply(leaves[0], torch.from_numpy(mask),
                                    torch.from_numpy(zh),
                                    torch.from_numpy(zc), leaves[1])
    (out ** 2).sum().backward()
    got = [leaf.grad.numpy() for leaf in leaves]
    want = jax.grad(scan_loss, argnums=(0, 1))(jnp.asarray(xp),
                                                 jnp.asarray(wh))
    for name, g, w in zip(("dxp", "dwh"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL, err_msg=name)
    # the held frames' own pre-activations get nothing
    assert np.abs(got[0][mask[..., 0] == 0]).max() == 0.0


def test_rate_zero_is_the_lstm():
    """zh = zc = 1 takes the new state everywhere: the zoneout recurrence
    is then the LSTM's, bit for bit on the CPU."""
    args = _t(_inputs(5, 9, 3, 8, mix="constant"))
    ones = torch.ones_like(args[3])
    got = bi_zoneout_lstm(*args[:3], ones, ones, ones, ones, *args[7:])
    want = bilstm_plain(*args[:3], *args[7:])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _perturbed(params, seed):
    """The JAX initial weights plus seeded noise."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(0.3 * rng.randn(*a.shape), a.dtype),
        params)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_layer_matches_jax_in_eval_mode(bidirectional):
    """RNNLayer('zoneout_lstm') in eval mode (mix weights 1 - rate) against
    the JAX layer on its CPU scan path (the deterministic interpolation),
    from perturbed weights loaded strictly, at rates 0.1 and 0.3."""
    t, b, f, h = 10, 3, 6, 8
    jlayer = JaxRNNLayer("zoneout_lstm", h, bidirectional=bidirectional,
                         zoneout_h=0.1, zoneout_c=0.3)
    params = _perturbed(jlayer.init(jax.random.PRNGKey(3), f), 4)
    rng = np.random.RandomState(5)
    x = rng.randn(t, b, f).astype(np.float32)
    mask = (np.arange(t)[:, None] < np.array([t, 7, 4])[None, :]).astype(
        np.float32)[..., None]
    want = jlayer.apply(params, jnp.asarray(x), jnp.asarray(mask))
    layer = RNNLayer("zoneout_lstm", f, h, bidirectional, zoneout_h=0.1,
                     zoneout_c=0.3)
    layer.load_state_dict(params_from_flat(flatten_params(params)))
    with torch.no_grad():
        got = layer(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.shape == (t, b, layer.output_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_zoneout_blstm_logits_match_jax(bidirectional):
    """The whole model in eval mode at rate 0.1: JAX weights carried across
    by the weight bridge (strict load, the same key set both ways), logits
    against the JAX CPU scan path."""
    hp = ("num_hiddens=8,num_layers=2,bidirectional="
          f"{str(bidirectional).lower()}")
    jm = jzoo.zoneout_blstm(hp, num_classes=27)
    params = _perturbed(jm.init(jax.random.PRNGKey(4), 39), 5)
    flat = flatten_params(params)
    pm = build_model("zoneout_blstm", hp, num_classes=27).eval()
    pm.load_state_dict(params_from_flat(flat))
    assert sorted(flat_from_params(pm.state_dict())) == sorted(flat)
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
def test_zoneout_blstm_default_structure_matches_jax(bidirectional):
    """At the default size (3x256): the port's state_dict holds the JAX
    tree's keys and shapes exactly."""
    hp = f"bidirectional={str(bidirectional).lower()}"
    jm = jzoo.zoneout_blstm(hp, num_classes=27)
    shapes = jax.eval_shape(lambda k: jm.init(k, 39), jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten_params(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               shapes)).items()}
    pm = build_model("zoneout_blstm", hp, num_classes=27,
                     generator=torch.Generator().manual_seed(0))
    got = {k.replace(".", "/"): tuple(v.shape)
           for k, v in pm.state_dict().items()}
    assert got == want
    assert got["rnn/layers/2/rnn/fw/wh"] == (256, 1024)


def test_mix_in_train_mode_draws_seeded_bernoulli():
    """Train mode at rate 0.1: values in {0, 1} with mean about 0.9, drawn
    from the generator (the same seed gives the same weights, another seed
    other ones); train mode without a generator refuses, as dropout does."""
    shape = (50, 8, 64)
    a = zoneout_mix(0.1, True, torch.Generator().manual_seed(3), shape)
    b = zoneout_mix(0.1, True, torch.Generator().manual_seed(3), shape)
    c = zoneout_mix(0.1, True, torch.Generator().manual_seed(4), shape)
    assert a.dtype == torch.float32 and a.shape == shape
    assert set(torch.unique(a).tolist()) == {0.0, 1.0}
    assert abs(float(a.mean()) - 0.9) < 0.01
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        zoneout_mix(0.1, True, None, shape)


@pytest.mark.parametrize("rate,want", [(0.1, 0.9), (0.25, 0.75), (0.0, 1.0)])
def test_mix_in_eval_mode_is_constant_without_draws(rate, want):
    """Eval mode (and train mode at rate 0) gives the constant 1 - rate and
    draws nothing from the generator."""
    g = torch.Generator().manual_seed(7)
    before = g.get_state()
    for train in (False, rate == 0.0):
        z = zoneout_mix(rate, train, g, (4, 3, 5))
        assert torch.equal(z, torch.full((4, 3, 5), want))
    assert torch.equal(g.get_state(), before)


def test_layer_draws_fw_then_bw_zh_then_zc():
    """A train-mode bidirectional layer draws, from the caller's generator,
    the forward cell's zh, its zc, then the backward cell's zh and zc, in
    forward time order; the same seed gives the same layer output."""
    t, b, f, h = 6, 2, 4, 5
    layer = RNNLayer("zoneout_lstm", f, h, True, zoneout_h=0.2,
                     zoneout_c=0.4,
                     generator=torch.Generator().manual_seed(0))
    x = torch.randn(t, b, f, generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(11)
    _, (zh_f, zc_f, _) = layer.fw.prepare(x, True, g)
    _, (zh_b, zc_b, _) = layer.bw.prepare(x, True, g)
    ref = torch.Generator().manual_seed(11)
    for z, rate in ((zh_f, 0.2), (zc_f, 0.4), (zh_b, 0.2), (zc_b, 0.4)):
        u = torch.rand((t, b, h), generator=ref)
        assert torch.equal(z, (u < 1.0 - rate).float())
    mask = torch.ones(t, b, 1)
    outs = [layer(x, mask, True, torch.Generator().manual_seed(s))
            for s in (2, 2, 3)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])


def test_cell_step_matches_jax_eval_step():
    """ZoneoutLSTMCell.step in eval mode against the JAX cell's step (the
    interpolation, then the hold) on one frame with a held row."""
    b, f, h = 3, 5, 6
    jlayer = JaxRNNLayer("zoneout_lstm", h, bidirectional=False,
                         zoneout_h=0.2, zoneout_c=0.3)
    params = _perturbed(jlayer.init(jax.random.PRNGKey(1), f), 2)
    cell = ZoneoutLSTMCell(f, h, zoneout_h=0.2, zoneout_c=0.3)
    cell.load_state_dict(params_from_flat(
        {k[3:]: v for k, v in flatten_params(params).items()}))
    rng = np.random.RandomState(3)
    h0, c0 = [rng.randn(b, h).astype(np.float32) for _ in range(2)]
    xp_t = rng.randn(b, 4 * h).astype(np.float32)
    m = np.array([[1.0], [0.0], [1.0]], np.float32)
    (hj, cj), _ = jlayer.cell.step(params["fw"], (jnp.asarray(h0),
                                                  jnp.asarray(c0)),
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
    counts = [f.launches for f in (bi_zoneout_lstm, zoneout_lstm,
                                   bi_zoneout_lstm_bwd, zoneout_lstm_bwd)]
    h, c = zoneout_lstm(*uni)
    h_f, c_f, h_b, c_b = bi_zoneout_lstm(*args)
    assert torch.equal(h, h_f) and torch.equal(c, c_f)
    torch.testing.assert_close((h, c), zoneout_lstm_plain(*uni), rtol=0,
                               atol=0)
    torch.testing.assert_close(bi_zoneout_lstm_plain(*args),
                               (h_f, c_f, h_b, c_b), rtol=0, atol=0)
    got = zoneout_lstm_bwd(*uni, h, c, dh)
    torch.testing.assert_close(got, zoneout_lstm_bwd_plain(*uni, h, c, dh),
                               rtol=0, atol=0)
    got_bi = bi_zoneout_lstm_bwd(*args, h_f, c_f, h_b, c_b, dh, dh)
    torch.testing.assert_close(got_bi, bi_zoneout_lstm_bwd_plain(
        *args, h_f, c_f, h_b, c_b, dh, dh), rtol=0, atol=0)
    assert counts == [f.launches for f in (bi_zoneout_lstm, zoneout_lstm,
                                           bi_zoneout_lstm_bwd,
                                           zoneout_lstm_bwd)]
    xp, mask, zh, zc, wh = uni
    with pytest.raises(ValueError, match="zh"):
        zoneout_lstm(xp, mask, zh[:-1], zc, wh)
    with pytest.raises(ValueError, match="zc"):
        zoneout_lstm(xp, mask, zh, zc.double(), wh)
    with pytest.raises(ValueError, match="dh"):
        zoneout_lstm_bwd(*uni, h, c, dh[:-1])
    with pytest.raises(ValueError, match="device"):
        zoneout_lstm(*(a.to("meta") for a in uni))
