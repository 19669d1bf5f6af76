"""Data parallelism of the port on the CPU: ``Trainer(group=)`` in 2 and 4
gloo ranks (``parallel.dp.launch``) against the JAX ``Trainer(mesh=
make_mesh(2|4))`` on conftest's virtual devices, from the same initial
weights (carried across by ``utils/weights.py``), and against the port's
own one-device step; ragged weights that leave a rank only padding,
gradient accumulation, reduce-on-plateau, a bf16 step (JAX on its Pallas
route), deep_blstm with the JAX Pallas backend in interpret mode, the eval
step, the ranks' dropout masks, a resume across topologies, and a failing
rank.

The ranks run ``tests/dp_ranks.py`` (no JAX in them), once a world size in
a module-scoped fixture, every case in one launch with a join timeout;
each test asserts on its part of the results.

Tolerances: DP against one device, loss rtol 1e-5 and the parameters after
an Adam step rtol 1e-4 / atol 1e-5 (the JAX package's own DP test); the
port against JAX, loss rel 1e-4, gradients within 1e-5 of their max abs
and the parameters after one SGD step rtol 1e-4 (Adam's first update turns
a near-zero gradient's rounding into a sign, ROADMAP C); bf16 as
tests/test_torch_bf16.py holds it (loss rel 1e-3, gradients 1e-2 of their
max abs)."""

import concurrent.futures
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import dp_ranks as R
from asr_study_torch.parallel import dp
from asr_study_tpu.models import rnn as jrnn
from asr_study_tpu.models import zoo as jzoo
from asr_study_tpu.train import trainer as jtrainer
from extras.export_weights import _flatten as flatten_params

GRAVES = ("graves2006", "num_hiddens=8")
DEEP = ("deep_blstm", "num_hiddens=16,num_layers=2,dropout=0.0")
DROPOUT = ("deep_blstm", "num_hiddens=16,num_layers=2,dropout=0.5")
ADAM = ("adam", 5e-3, 10.0)
SGD_LR = 0.1
SGD = ("sgd", SGD_LR, 400.0)
# a spawn's bound: a hung rank fails its test instead of eating the clock
JOIN_S = 240
LOSS_RTOL, PARAM_TOL = 1e-5, dict(rtol=1e-4, atol=1e-5)
JAX_LOSS_RTOL, JAX_GRAD_FRAC, JAX_PARAM_RTOL = 1e-4, 1e-5, 1e-4
BF16_LOSS_RTOL, BF16_GRAD_FRAC = 1e-3, 1e-2


def _case(model, spec, batches, flat=None, **kw):
    return dict(model=model[0], hp=model[1], spec=spec, batches=batches,
                flat=flat, **kw)


@pytest.fixture(scope="module")
def init():
    """The JAX models' initial weights (PRNGKey(0)) as flat arrays."""
    return {m: flatten_params(getattr(jzoo, m[0])(m[1], num_classes=R.CLASSES)
                              .init(jax.random.PRNGKey(0), R.FEATS))
            for m in (GRAVES, DEEP)}


def _cases(world: int, init: dict, tmp) -> dict:
    one = [(1, None)]
    cases = {
        "adam": _case(GRAVES, ADAM, one, init[GRAVES]),
        "sgd": _case(GRAVES, SGD, one, init[GRAVES], eval=True, masks=True),
        "ragged": _case(GRAVES, SGD, [(1, R.RAGGED)], init[GRAVES]),
        "ragged_adam": _case(GRAVES, ADAM, [(1, R.RAGGED)] * 2,
                             init[GRAVES]),
    }
    if world == 2:
        cases.update({
            "deep_pallas": _case(DEEP, SGD, one, init[DEEP]),
            "accum": _case(GRAVES, (*ADAM, 0.0, 0.0, 0, 2),
                           [(1, None), (2, R.RAGGED)], init[GRAVES]),
            "plateau": _case(GRAVES, (*ADAM, 0.0, 0.0, 0, 1, 0.5, 1, 1),
                             [(1, None), (2, None), (1, None)],
                             init[GRAVES]),
            "bf16": _case(GRAVES, SGD, one, init[GRAVES], bf16=True),
            "dropout_a": _case(DROPOUT, ADAM, [(1, None)] * 2, masks=True),
            "dropout_b": _case(DROPOUT, ADAM, [(1, None)] * 2, masks=True),
            "save_dp": _case(GRAVES, ADAM, [(1, None)] * 2, init[GRAVES],
                             save=str(tmp / "dp_run")),
            "resume_dp": _case(GRAVES, ADAM, [(1, None)] * 2, init[GRAVES],
                               resume=str(tmp / "single_run")),
        })
    return cases


def _jax_refs(world: int) -> dict:
    """The JAX Trainer's results on make_mesh(world) for the cases held to
    it: SGD steps (deep_blstm and bf16 on the Pallas route), the eval
    step."""
    refs = _jax_graves_refs(world)
    if world == 2:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jrnn, "RNN_BACKEND", "pallas")
            refs["deep_pallas"] = _jax_sgd_step(DEEP, 2)[1]
            refs["bf16"] = _jax_sgd_step(GRAVES, 2, bf16=True)[1]
    return refs


@pytest.fixture(scope="module")
def launched(init, tmp_path_factory):
    """Both world sizes' ranks run every case (spawned together) while this
    process computes the JAX references -> {world: (cases, each rank's
    results, the references)} and the world-2 run's directory."""
    tmp = tmp_path_factory.mktemp("dp")
    R.run_case(_case(GRAVES, ADAM, [(1, None)] * 2, init[GRAVES],
                     save=str(tmp / "single_run")))
    cases = {n: _cases(n, init, tmp) for n in (2, 4)}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ranks = {n: pool.submit(dp.launch, R.rank_main, ["cpu"] * n,
                                args=(cases[n],), join_timeout=JOIN_S)
                 for n in (2, 4)}
        refs = {n: _jax_refs(n) for n in (2, 4)}
        return {n: (cases[n], ranks[n].result(), refs[n])
                for n in (2, 4)}, tmp


@pytest.fixture(scope="module")
def straight(init):
    """The one-device run the resume cases are held to: 4 Adam steps."""
    return R.run_case(_case(GRAVES, ADAM, [(1, None)] * 4, init[GRAVES]))


@pytest.fixture(scope="module")
def world2(launched):
    return (*launched[0][2], launched[1])


@pytest.fixture(scope="module")
def world4(launched):
    return launched[0][4]


@pytest.fixture(params=[2, 4], ids=["world2", "world4"])
def world(request):
    return request.getfixturevalue(f"world{request.param}")[:3]


def _same_on_every_rank(ranks, name):
    """Every rank ends a step with the same weights, bit for bit."""
    for r in ranks[1:]:
        for k, v in ranks[0][name]["params"].items():
            np.testing.assert_array_equal(r[name]["params"][k], v,
                                          err_msg=f"{name} {k}")


def _recorder():
    """An optax transform that passes the updates on and keeps them as its
    state: the gradients the step hands the optimizer, exactly."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _arrays(batch):
    return [jnp.asarray(a) for a in (batch.inputs, batch.input_lengths,
                                     batch.labels, batch.label_lengths,
                                     batch.weights)]


def _jax_sgd_step(model, n, bf16=False, batch=None):
    """One JAX SGD step on the mesh of ``n`` devices (the factory's chain,
    clip then SGD, with the recorder between them) from PRNGKey(0)'s
    weights, on ``batch`` (host_batch(1)) -> (the trainer and its state
    after the step, (loss, grad norm, gradients, params after))."""
    jm = getattr(jzoo, model[0])(model[1], num_classes=R.CLASSES)
    name, lr, clipnorm = SGD
    tx = optax.chain(optax.clip_by_global_norm(clipnorm), _recorder(),
                     optax.sgd(lr, momentum=0.9))
    jt = jtrainer.Trainer(jm, tx, mesh=jtrainer.make_mesh(n),
                          donate_state=False,
                          compute_dtype=jnp.bfloat16 if bf16 else None)
    js = jt.init_state(jax.random.PRNGKey(0), R.FEATS)
    js1, m = jt.train_step(js, *_arrays(batch or R.host_batch(1)),
                           jax.random.PRNGKey(1))
    return (jt, js, js1), (
        float(m["loss"]), float(m["grad_norm"]),
        flatten_params(js1.opt_state[1]), flatten_params(js1.params))


def _jax_graves_refs(n):
    """graves2006 on make_mesh(n), one compiled step for both: the SGD
    step on the full and on the ragged batch; the eval step after the
    former."""
    (jt, js0, js1), full = _jax_sgd_step(GRAVES, n)
    js2, m = jt.train_step(js0, *_arrays(R.host_batch(1, R.RAGGED)),
                           jax.random.PRNGKey(1))
    ragged = (float(m["loss"]), float(m["grad_norm"]),
              flatten_params(js2.opt_state[1]), flatten_params(js2.params))
    ev = jt.eval_step(js1, *_arrays(R.host_batch(1)))
    return {"sgd": full, "ragged": ragged,
            "eval": {k: float(v) for k, v in ev.items()}}


def _close_frac(got, want, frac, what):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= frac * scale, f"{what}: {err:.3e} > {frac} * {scale:.3e}"


def _against_jax(got, want, loss_rtol, grad_frac, param_rtol):
    loss, gnorm, grads, params = want
    assert got["losses"][0] == pytest.approx(loss, rel=loss_rtol)
    assert got["grad_norms"][0] == pytest.approx(gnorm, rel=loss_rtol)
    assert sorted(got["grads"]) == sorted(grads)
    for k in grads:
        _close_frac(got["grads"][k], grads[k], grad_frac, k)
        if param_rtol is not None:
            np.testing.assert_allclose(got["params"][k], params[k],
                                       rtol=param_rtol, atol=1e-7,
                                       err_msg=k)


# -- DP against the port's one-device step -----------------------------------

@pytest.mark.parametrize("name", ["adam", "sgd", "ragged", "ragged_adam"])
def test_dp_step_matches_one_device(world, name):
    """The step on N ranks is the step on the whole batch: the loss (the
    mean over the global batch, on every rank), and the weights after it
    (5 real rows of 8 in the ragged cases: on 4 ranks the last holds only
    padding)."""
    cases, ranks, _ = world
    single = R.run_case(cases[name])
    for r in ranks:
        np.testing.assert_allclose(r[name]["losses"], single["losses"],
                                   rtol=LOSS_RTOL)
        for k, v in single["params"].items():
            np.testing.assert_allclose(r[name]["params"][k], v,
                                       **PARAM_TOL, err_msg=k)
    _same_on_every_rank(ranks, name)


@pytest.mark.parametrize("name", ["accum", "plateau"])
def test_dp_accumulation_and_plateau_match_one_device(world2, name):
    """accum_steps=2 (a full batch, then a ragged one) and reduce-on-plateau
    (patience 1, window 1: the plateau sees the global loss) on 2 ranks,
    each step's loss and the final weights."""
    cases, ranks, _, _ = world2
    single = R.run_case(cases[name])
    assert ranks[0][name]["step"] == single["step"] == len(
        cases[name]["batches"])
    for r in ranks:
        np.testing.assert_allclose(r[name]["losses"], single["losses"],
                                   rtol=LOSS_RTOL)
        for k, v in single["params"].items():
            np.testing.assert_allclose(r[name]["params"][k], v,
                                       **PARAM_TOL, err_msg=k)
    _same_on_every_rank(ranks, name)


# -- DP against the JAX Trainer on a mesh ------------------------------------

@pytest.mark.parametrize("name", ["sgd", "ragged"])
def test_dp_step_matches_jax_mesh(world, name):
    """One SGD step on N ranks against the JAX Trainer's on make_mesh(N):
    the loss, the grad norm, each gradient and the weights."""
    _, ranks, refs = world
    for r in ranks:
        _against_jax(r[name], refs[name], JAX_LOSS_RTOL, JAX_GRAD_FRAC,
                     JAX_PARAM_RTOL)


def test_dp_deep_blstm_matches_jax_pallas_mesh(world2):
    """deep_blstm 2x16 on 2 ranks against the JAX Trainer on make_mesh(2)
    with its Pallas recurrence (interpret mode on the CPU)."""
    _, ranks, refs, _ = world2
    _against_jax(ranks[0]["deep_pallas"], refs["deep_pallas"],
                 JAX_LOSS_RTOL, JAX_GRAD_FRAC, JAX_PARAM_RTOL)
    _same_on_every_rank(ranks, "deep_pallas")


def test_dp_bf16_step_matches_jax_mesh(world2):
    """A bf16 SGD step on 2 ranks against the JAX Trainer(mesh=make_mesh(2),
    compute_dtype=bfloat16) on its Pallas route, at test_torch_bf16.py's
    tolerances; the masters stay float32."""
    _, ranks, refs, _ = world2
    for r in ranks:
        _against_jax(r["bf16"], refs["bf16"], BF16_LOSS_RTOL,
                     BF16_GRAD_FRAC, None)
        assert all(v.dtype == np.float32 for v in r["bf16"]["params"].values())
    _same_on_every_rank(ranks, "bf16")


# -- eval ----------------------------------------------------------------------

def test_dp_eval_matches_one_device_and_jax_mesh(world):
    """The eval step's sums over the ranks equal the one-device step's and
    the JAX eval step's on the mesh; run_eval over two batches equals the
    one-device run_eval."""
    cases, ranks, refs = world
    single = R.run_case(cases["sgd"])
    want = refs["eval"]
    for r in ranks:
        got = r["sgd"]["eval"]
        for k, v in single["eval"].items():
            assert got[k] == pytest.approx(v, rel=LOSS_RTOL), k
        assert got["loss"] == pytest.approx(want["loss"], rel=JAX_LOSS_RTOL)
        for k in ("edit_dist", "label_chars", "num_seqs"):
            assert got[k] == want[k], k
        for k, v in single["run_eval"].items():
            assert r["sgd"]["run_eval"][k] == pytest.approx(
                v, rel=LOSS_RTOL), k


# -- dropout masks -------------------------------------------------------------

def test_dp_dropout_masks_differ_across_ranks_and_repeat(world2, world4):
    """The ranks draw different dropout masks, each a function of (seed,
    step, rank): equal in two runs and on the same rank of another world
    size; two identical DP steps with dropout give the same weights bit
    for bit."""
    ranks2, ranks4 = world2[1], world4[1]
    masks = [r["dropout_a"]["mask"] for r in ranks2]
    assert not np.array_equal(masks[0], masks[1])
    masks4 = [r["sgd"]["mask"] for r in ranks4]
    assert all(not np.array_equal(a, b) for i, a in enumerate(masks4)
               for b in masks4[i + 1:])
    for a, b in zip(masks, masks4):
        np.testing.assert_array_equal(a, b)
    for r, m in zip(ranks2, masks):
        np.testing.assert_array_equal(r["dropout_b"]["mask"], m)
        assert r["dropout_a"]["losses"] == r["dropout_b"]["losses"]
        for k, v in r["dropout_a"]["params"].items():
            np.testing.assert_array_equal(r["dropout_b"]["params"][k], v)
    # the same draws as a one-device run's for rank 0
    single = R.run_case(world2[0]["dropout_a"])
    np.testing.assert_array_equal(single["mask"], masks[0])
    _same_on_every_rank(ranks2, "dropout_a")


# -- resume across topologies ------------------------------------------------

def test_dp_resume_across_topologies(world2, straight):
    """Saved after 2 steps on 2 ranks and resumed on one device, and saved
    after 2 one-device steps and resumed on 2 ranks: 2 more steps land on
    the uninterrupted one-device run's weights and losses."""
    from asr_study_torch.train.checkpoint import CheckpointManager

    cases, ranks, _, tmp = world2
    dp_dir = str(tmp / "dp_run")
    assert CheckpointManager(dp_dir).latest_step == 2
    resumed_single = R.run_case(dict(cases["save_dp"], save=None,
                                     resume=dp_dir))
    resumed_dp = ranks[0]["resume_dp"]
    for got in (resumed_single, resumed_dp):
        assert got["step"] == 4
        np.testing.assert_allclose(got["losses"], straight["losses"][2:],
                                   rtol=LOSS_RTOL)
        for k, v in straight["params"].items():
            np.testing.assert_allclose(got["params"][k], v, **PARAM_TOL,
                                       err_msg=k)
    _same_on_every_rank(ranks, "resume_dp")


# -- launch --------------------------------------------------------------------

def test_shard_rows_takes_contiguous_rows():
    b = R.host_batch(3)
    parts = [dp.shard_rows(b, r, 4) for r in range(4)]
    for f in ("inputs", "input_lengths", "labels", "label_lengths",
              "weights"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(p, f) for p in parts]), getattr(b, f))
        assert getattr(parts[1], f).shape[0] == 2
    assert parts[0].texts is None
    with pytest.raises(ValueError, match="does not split among 3 ranks"):
        dp.shard_rows(b, 0, 3)


def test_a_failing_rank_ends_the_launch():
    """Rank 1 raises while rank 0 waits for it in a collective: the launch
    ends well inside its join timeout with rank 1's error."""
    t0 = time.perf_counter()
    with pytest.raises(dp.RankError, match="rank 1 of 2 failed") as e:
        dp.launch(R.raise_on_rank_one, ["cpu", "cpu"], join_timeout=JOIN_S)
    assert "rank one gives up" in str(e.value)
    assert time.perf_counter() - t0 < JOIN_S / 2
