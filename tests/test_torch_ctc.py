"""The port's CTC loss (asr_study_torch/ops/ctc.py) against the JAX
reference: ``asr_study_tpu.ops.ctc.ctc_loss`` on its scan backend and on
its Pallas backend in interpret mode, the Pallas recursions
``pallas_ctc._fwd_call`` / ``_bwd_call`` themselves, and
``torch.nn.functional.ctc_loss`` as an independent oracle.  On the CPU the
port's kernel wrappers take their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_study_torch.ops import ctc as pc
from asr_study_tpu.ops import ctc as jc
from asr_study_tpu.ops import pallas_ctc as jpc

# tests/test_pallas_ctc.py's contract: loss 1e-5, gradients 1e-4 / 1e-5
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _rand_case(seed, b=4, t=14, v=6, l_max=4):
    """tests/test_pallas_ctc.py's generator: repeated labels included."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, t, v)).astype(np.float32)
    lengths = rng.integers(t // 2, t + 1, size=(b,)).astype(np.int32)
    labels = rng.integers(0, v - 1, size=(b, l_max)).astype(np.int32)
    lab_lens = rng.integers(1, l_max + 1, size=(b,)).astype(np.int32)
    return logits, lengths, labels, lab_lens


def _port_loss_and_grad(logits, lengths, labels, lab_lens, weights=None):
    lg = torch.from_numpy(logits).requires_grad_()
    per = pc.ctc_loss(lg, *map(torch.from_numpy, (lengths, labels,
                                                  lab_lens)))
    w = torch.ones_like(per) if weights is None else torch.from_numpy(
        weights)
    (per * w).sum().backward()
    return per.detach().numpy(), lg.grad.numpy()


def _jax_loss_and_grad(backend, logits, lengths, labels, lab_lens,
                       weights=None):
    args = tuple(map(jnp.asarray, (lengths, labels, lab_lens)))
    w = jnp.ones(logits.shape[0]) if weights is None else jnp.asarray(
        weights)
    per = jc.ctc_loss(jnp.asarray(logits), *args, backend=backend)
    grad = jax.grad(lambda lg: jnp.sum(
        jc.ctc_loss(lg, *args, backend=backend) * w))(jnp.asarray(logits))
    return np.asarray(per), np.asarray(grad)


@pytest.mark.parametrize("backend", ["scan", "pallas"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loss_and_grad_match_jax(seed, backend):
    case = _rand_case(seed)
    loss, grad = _port_loss_and_grad(*case)
    j_loss, j_grad = _jax_loss_and_grad(backend, *case)
    np.testing.assert_allclose(loss, j_loss, **LOSS_TOL)
    np.testing.assert_allclose(grad, j_grad, **GRAD_TOL)


def _jax_lattice(lp_ext, skip, s_pad=128):
    """The JAX side's 128-lane padding of the port's lattice inputs."""
    t, b, s = lp_ext.shape
    lp_p = np.full((t, b, s_pad), pc.LOG_EPS, np.float32)
    lp_p[..., :s] = lp_ext
    skip_p = np.full((b, s_pad), pc.LOG_EPS, np.float32)
    skip_p[:, :s] = skip
    return lp_p, skip_p


@pytest.mark.parametrize("seed", [3, 4])
def test_recursions_match_pallas_calls(seed):
    """ctc_alpha_plain / ctc_beta_plain against the Pallas kernels
    (interpret mode), the JAX side's lane padding sliced off."""
    logits, lengths, labels, lab_lens = _rand_case(seed, t=11, l_max=5)
    lp_ext, valid, skip, end, ll = (
        x.detach() for x in pc.lattice(
            torch.from_numpy(logits),
            *map(torch.from_numpy, (lengths, labels, lab_lens))))
    t, b, s = lp_ext.shape
    alpha = pc.ctc_alpha_plain(lp_ext, valid, skip)
    skip2 = pc.skip_from_source(skip)
    end_ind = pc.end_indicator(end, ll, s)
    gamma = pc.ctc_beta_plain(lp_ext, valid, alpha, skip2, end_ind)

    lp_p, skip_p = _jax_lattice(lp_ext.numpy(), skip.numpy())
    valid_j = jnp.asarray(valid.numpy()[..., None])
    j_alpha = jpc._fwd_call(jnp.asarray(lp_p), valid_j, jnp.asarray(skip_p),
                            interpret=True)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(j_alpha)[:t, :, :s],
                               **LOSS_TOL)
    ids = np.arange(lp_p.shape[2])[None, :]
    skip2_p = np.where(ids < s - 2, np.roll(skip_p, -2, axis=1), pc.LOG_EPS)
    end_p = np.full((b, lp_p.shape[2]), pc.LOG_EPS, np.float32)
    end_p[:, :s] = end_ind.numpy()
    j_gamma = jpc._bwd_call(jnp.asarray(lp_p), valid_j, j_alpha,
                            jnp.asarray(skip2_p.astype(np.float32)),
                            jnp.asarray(end_p), s, interpret=True)
    np.testing.assert_allclose(gamma.numpy(), np.asarray(j_gamma)[:, :, :s],
                               **LOSS_TOL)
    # the floor entries are exactly the floor on both sides
    np.testing.assert_array_equal(gamma.numpy() <= -5e29,
                                  np.asarray(j_gamma)[:, :, :s] <= -5e29)


def test_weighted_mean_and_repeats():
    """ctc_loss_mean with a zero-weight row and heavy label repeats (the
    skip rule off), tests/test_pallas_ctc.py's case."""
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(4, 16, 5)).astype(np.float32)
    lengths = np.array([16, 12, 14, 9], np.int32)
    labels = np.array([[1, 1, 1, 2, 2], [0, 0, 3, 3, 0], [2, 2, 2, 2, 2],
                       [1, 2, 3, 0, 1]], np.int32)
    lab_lens = np.array([5, 5, 5, 4], np.int32)
    weights = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    lg = torch.from_numpy(logits).requires_grad_()
    loss = pc.ctc_loss_mean(lg, *map(torch.from_numpy,
                                     (lengths, labels, lab_lens)),
                            weights=torch.from_numpy(weights))
    loss.backward()
    args = tuple(map(jnp.asarray, (lengths, labels, lab_lens)))
    j_loss, j_grad = jax.value_and_grad(lambda x: jc.ctc_loss_mean(
        x, *args, weights=jnp.asarray(weights)))(jnp.asarray(logits))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(j_grad),
                               **GRAD_TOL)
    # the zero-weight row's gradient is exactly zero
    assert np.abs(lg.grad.numpy()[2]).max() == 0.0
    # unweighted: the plain mean
    plain = pc.ctc_loss_mean(lg.detach(), *map(torch.from_numpy, (
        lengths, labels, lab_lens)))
    per = pc.ctc_loss(lg.detach(), *map(torch.from_numpy, (
        lengths, labels, lab_lens)))
    assert float(plain) == pytest.approx(float(per.mean()), rel=1e-6)


def test_empty_and_infeasible_labels():
    """An L=0 row and an infeasible row (repeats need more frames than
    T): loss parity, finite gradients, the infeasible row's zeroed."""
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(3, 6, 4)).astype(np.float32)
    lengths = np.array([6, 6, 4], np.int32)
    labels = np.array([[0, 0, 0], [1, 2, 1], [2, 2, 2]], np.int32)
    lab_lens = np.array([0, 3, 3], np.int32)
    case = (logits, lengths, labels, lab_lens)
    loss, grad = _port_loss_and_grad(*case)
    for backend in ("scan", "pallas"):
        j_loss, _ = _jax_loss_and_grad(backend, *case)
        np.testing.assert_allclose(loss, j_loss, rtol=1e-5, atol=1e-2)
    assert loss[2] == pytest.approx(-pc.LOG_EPS)
    assert np.all(np.isfinite(grad))
    assert np.abs(grad[2]).max() == 0.0


@pytest.mark.parametrize("seed", [5, 6])
def test_matches_torch_ctc_loss(seed):
    """Feasible sequences against torch.nn.functional.ctc_loss, an
    implementation independent of both packages."""
    logits, lengths, labels, lab_lens = _rand_case(seed, b=4, t=16, v=7,
                                                   l_max=5)
    loss, grad = _port_loss_and_grad(logits, lengths, labels, lab_lens)
    lg = torch.from_numpy(logits).requires_grad_()
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(lg, -1).transpose(0, 1),
        torch.from_numpy(labels).long(), torch.from_numpy(lengths).long(),
        torch.from_numpy(lab_lens).long(), blank=logits.shape[2] - 1,
        reduction="none")
    ref.sum().backward()
    np.testing.assert_allclose(loss, ref.detach().numpy(), **LOSS_TOL)
    np.testing.assert_allclose(grad, lg.grad.numpy(), **GRAD_TOL)


def test_full_length_and_padded_label_ids():
    """All frames valid and the last state at S-1; label padding beyond
    the lengths (here out of the vocabulary) does not change the loss."""
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(2, 8, 4)).astype(np.float32)
    lengths = np.full(2, 8, np.int32)
    labels = np.array([[0, 1, 2, 0], [2, 1, 9, 9]], np.int32)
    lab_lens = np.array([4, 2], np.int32)
    loss, grad = _port_loss_and_grad(logits, lengths, labels, lab_lens)
    clean = labels.copy()
    clean[1, 2:] = 0
    j_loss, j_grad = _jax_loss_and_grad("scan", logits, lengths, clean,
                                        lab_lens)
    np.testing.assert_allclose(loss, j_loss, **LOSS_TOL)
    np.testing.assert_allclose(grad, j_grad, **GRAD_TOL)


def test_wrappers_take_plain_on_cpu():
    lp_ext, valid, skip, end, ll = (x.detach() for x in pc.lattice(
        *map(torch.from_numpy, _rand_case(8))))
    a0, b0 = pc.ctc_alpha.launches, pc.ctc_beta.launches
    alpha = pc.ctc_alpha(lp_ext, valid, skip)
    skip2 = pc.skip_from_source(skip)
    end_ind = pc.end_indicator(end, ll, lp_ext.shape[2])
    gamma = pc.ctc_beta(lp_ext, valid, alpha, skip2, end_ind)
    assert (pc.ctc_alpha.launches, pc.ctc_beta.launches) == (a0, b0)
    torch.testing.assert_close(alpha, pc.ctc_alpha_plain(lp_ext, valid,
                                                         skip),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        gamma, pc.ctc_beta_plain(lp_ext, valid, alpha, skip2, end_ind),
        rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["shape", "dtype", "device"])
def test_wrappers_reject(bad):
    lp_ext, valid, skip, _, _ = (x.detach() for x in pc.lattice(
        *map(torch.from_numpy, _rand_case(8))))
    if bad == "shape":
        skip = skip[:, :-1]
    elif bad == "dtype":
        valid = valid.double()
    else:
        lp_ext, valid, skip = (a.to("meta") for a in (lp_ext, valid, skip))
    with pytest.raises(ValueError):
        pc.ctc_alpha(lp_ext, valid, skip)


def test_extend_labels_and_skip_mask():
    labels = torch.tensor([[3, 3, 1]])
    ext = pc.extend_labels(labels, blank_id=5)
    assert ext.tolist() == [[5, 3, 5, 3, 5, 1, 5]]
    j_ext = jc.extend_labels(jnp.asarray(labels.numpy()), 5)
    np.testing.assert_array_equal(ext.numpy(), np.asarray(j_ext))
    _, _, skip, _, _ = pc.lattice(torch.zeros(1, 7, 6), torch.tensor([7]),
                                  labels, torch.tensor([3]))
    # only the label differing from the one two states back may skip
    assert (skip[0] == 0).tolist() == [False, True, False, False, False,
                                       True, False]


def test_lattice_gather_sums_each_class_in_a_fixed_order():
    """LatticeGather: the forward is the per-state gather; the backward is
    the one-hot product of the JAX package's ctc_loss (its VJP through the
    einsum), equal to the gather's own autograd backward, with the blank
    class taking the sum of its L+1 lattice states."""
    rng = np.random.RandomState(3)
    b, t, v, l_max = 3, 7, 6, 4
    lp = rng.randn(b, t, v).astype(np.float32)
    ext = pc.extend_labels(torch.from_numpy(
        rng.randint(0, v - 1, (b, l_max))), v - 1)
    d_lp = rng.randn(t, b, ext.shape[1]).astype(np.float32)
    leaf = torch.from_numpy(lp).requires_grad_()
    out = pc.LatticeGather.apply(leaf, ext)
    idx = ext[:, None, :].expand(b, t, ext.shape[1])
    ref_leaf = torch.from_numpy(lp).requires_grad_()
    ref = torch.gather(ref_leaf, 2, idx).transpose(0, 1)
    assert torch.equal(out, ref)
    out.backward(torch.from_numpy(d_lp))
    ref.backward(torch.from_numpy(d_lp))
    torch.testing.assert_close(leaf.grad, ref_leaf.grad, rtol=1e-6,
                               atol=1e-6)
    sel = jax.nn.one_hot(jnp.asarray(ext.numpy()), v, dtype=jnp.float32)
    _, vjp = jax.vjp(lambda x: jnp.einsum(
        "bsv,btv->tbs", sel, x, precision=jax.lax.Precision.HIGHEST),
        jnp.asarray(lp))
    np.testing.assert_allclose(leaf.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(d_lp))[0]),
                               rtol=1e-6, atol=1e-6)
    blank = d_lp.sum(axis=2, where=(ext.numpy() == v - 1)[None])
    np.testing.assert_allclose(leaf.grad[..., v - 1].numpy(), blank.T,
                               rtol=1e-6, atol=1e-6)
