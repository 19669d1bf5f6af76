"""Tensor parallelism of the port on the CPU (``parallel/tp.py``; the
mirror of tests/test_tp.py): gloo ranks in ``(data, model)`` layouts of
(1, 2) and (2, 2) (``parallel.dp.launch(..., tp=2)``), each case held
against the JAX ``Trainer(mesh=make_mesh(d, model_devices=m))`` on
conftest's virtual devices and against the port's own one-process step,
from the same initial weights (carried across by ``utils/weights.py``).

The ranks run ``tests/tp_ranks.py`` (no JAX in them), once a layout in a
module-scoped fixture, every case in one launch with a join timeout.

What the JAX side gives and what it is held to (ROADMAP C8): the JAX TP
step's loss and eval are one device's, but its gradient of every
recurrent weight is n_model times one device's (its all-gather's
transpose sums a cotangent that is already whole on every shard;
tests/test_tp.py does not see it, Adam's update being nearly invariant to
the scale), and it cannot take a bfloat16 step (its scan carry starts in
bfloat16 and leaves float32).  So the port's TP step is held to the JAX
mesh's loss and eval, and its gradients to the JAX one-device step's;
its bf16 step to the JAX one-device bf16 step (the scan route, whose
autodiff rounds the recurrent cotangent as the port's TP autograd does).

Tolerances: against JAX, loss rel 1e-4 and gradients within 1e-5 of their
max abs (tests/test_torch_dp.py's); TP against one process, loss rtol
1e-5 and gradients 1e-5 of their max; bf16 as tests/test_torch_bf16.py
holds it (loss rel 1e-3, gradients 1e-2 of their max abs)."""

import concurrent.futures
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dp_ranks as R
import tp_ranks as TR
from asr_study_torch.cli import train as port_train
from asr_study_torch.models.cells import GRUCell, LSTMCell
from asr_study_torch.models.zoo import build_model
from asr_study_torch.parallel import dp
from asr_study_torch.parallel.tp import tp_scan, validate_tp
from asr_study_tpu.models import zoo as jzoo
from asr_study_tpu.train import trainer as jtrainer
from extras.export_weights import _flatten as flatten_params

BLSTM = ("deep_blstm", "num_hiddens=8,num_layers=2,dropout=0.0")
GRU = ("deep_gru", "num_hiddens=8,num_layers=1,dropout=0.0")
BLSTM1 = ("deep_blstm", "num_hiddens=8,num_layers=1,dropout=0.0")
SGD = ("sgd", 0.1, 400.0)
LAYOUTS = {"1x2": (1, 2), "2x2": (2, 2)}
# a spawn's bound: a hung rank fails its test instead of eating the clock
JOIN_S = 240
JAX_LOSS_RTOL, GRAD_FRAC = 1e-4, 1e-5
TP_LOSS_RTOL = 1e-5
BF16_LOSS_RTOL, BF16_GRAD_FRAC = 1e-3, 1e-2


@pytest.fixture(scope="module")
def init():
    """The JAX models' initial weights (PRNGKey(0)) as flat arrays."""
    return {m: flatten_params(getattr(jzoo, m[0])(m[1], num_classes=R.CLASSES)
                              .init(jax.random.PRNGKey(0), R.FEATS))
            for m in (BLSTM, GRU, BLSTM1)}


def _step(model, init, **kw):
    return dict(kind="step", model=model[0], hp=model[1], spec=SGD,
                batches=[(1, None)], flat=init[model], **kw)


def _cases(init) -> dict:
    return {
        "slice": dict(kind="slice"),
        "fwd_blstm": dict(kind="forward", model=BLSTM[0], hp=BLSTM[1],
                          flat=init[BLSTM], seed=3),
        "fwd_gru": dict(kind="forward", model=GRU[0], hp=GRU[1],
                        flat=init[GRU], seed=3),
        "blstm": _step(BLSTM, init),
        "gru": _step(GRU, init),
        "eval_blstm": dict(_step(BLSTM, init), kind="eval", seed=1),
        "eval_gru": dict(_step(GRU, init), kind="eval", seed=1),
        "bf16": _step(BLSTM1, init, bf16=True),
    }


def _recorder():
    """An optax transform that passes the updates on and keeps them as its
    state: the gradients the step hands the optimizer, exactly."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _jax_step(model, mesh, bf16=False, eval_too=False) -> dict:
    """One JAX SGD step (clip, the recorder, SGD) from PRNGKey(0)'s weights
    on host_batch(1) on ``mesh`` (None: one device) -> loss, grads and,
    with ``eval_too``, the eval step from the same weights."""
    jm = getattr(jzoo, model[0])(model[1], num_classes=R.CLASSES)
    _, lr, clipnorm = SGD
    tx = optax.chain(optax.clip_by_global_norm(clipnorm), _recorder(),
                     optax.sgd(lr, momentum=0.9))
    jt = jtrainer.Trainer(jm, tx, mesh=mesh, donate_state=False,
                          compute_dtype=jnp.bfloat16 if bf16 else None)
    js = jt.init_state(jax.random.PRNGKey(0), R.FEATS)
    b = R.host_batch(1)
    arrays = [jnp.asarray(a) for a in (b.inputs, b.input_lengths, b.labels,
                                       b.label_lengths, b.weights)]
    js1, m = jt.train_step(js, *arrays, jax.random.PRNGKey(1))
    out = {"loss": float(m["loss"]),
           "grads": flatten_params(js1.opt_state[1])}
    if eval_too:
        out["eval"] = {k: float(v)
                       for k, v in jt.eval_step(js, *arrays).items()}
    return out


def _jax_refs() -> dict:
    refs = {"one": {m: _jax_step(m, None) for m in (BLSTM, GRU)},
            "bf16": _jax_step(BLSTM1, None, bf16=True)}
    for name, (d, m) in LAYOUTS.items():
        mesh = jtrainer.make_mesh(d, model_devices=m)
        refs[name] = {BLSTM: _jax_step(BLSTM, mesh, eval_too=True)}
        if name == "2x2":
            refs[name][GRU] = _jax_step(GRU, mesh, eval_too=True)
    return refs


@pytest.fixture(scope="module")
def launched(init):
    """Both layouts' ranks run every case (spawned together) while this
    process computes the JAX references -> ({layout: each rank's results},
    the references, the cases)."""
    cases = _cases(init)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ranks = {name: pool.submit(dp.launch, TR.rank_main,
                                   ["cpu"] * (d * m), args=(cases,),
                                   join_timeout=JOIN_S, tp=m)
                 for name, (d, m) in LAYOUTS.items()}
        refs = _jax_refs()
        return {k: v.result() for k, v in ranks.items()}, refs, cases


@pytest.fixture(params=list(LAYOUTS))
def layout(request, launched):
    ranks, refs, cases = launched
    return request.param, ranks[request.param], refs, cases


def _close_frac(got, want, frac, what):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= frac * scale, f"{what}: {err:.3e} > {frac} * {scale:.3e}"


def _grads_close(got, want, frac):
    assert sorted(got) == sorted(want)
    for k in want:
        _close_frac(got[k], want[k], frac, k)


def test_tp_slice_grad_reassembles(layout):
    """tp_slice's backward all-reduces the shards' cotangents into the FULL
    weight gradient, 2 w, identical on every model rank."""
    _, ranks, _, _ = layout
    for r in ranks:
        got = r["slice"]
        assert got["loc_shape"] == (3, 4)
        np.testing.assert_allclose(got["grad"], 2 * got["w"], rtol=1e-6)


@pytest.mark.parametrize("name,model", [("fwd_blstm", BLSTM),
                                        ("fwd_gru", GRU)])
def test_tp_forward_matches_single_device(layout, name, model):
    """The model's forward under a model group of 2 equals the one-process
    forward and the JAX model's (atol 1e-5, tests/test_tp.py's)."""
    _, ranks, _, cases = layout
    case = cases[name]
    single = TR.forward(case)
    jm = getattr(jzoo, model[0])(model[1], num_classes=R.CLASSES)
    b = R.host_batch(case["seed"])
    ref = np.asarray(jm.apply(jm.init(jax.random.PRNGKey(0), R.FEATS),
                              jnp.asarray(b.inputs),
                              jnp.asarray(b.input_lengths), train=False))
    for r in ranks:
        np.testing.assert_allclose(r[name], single, atol=1e-5)
        np.testing.assert_allclose(r[name], ref, atol=1e-5)


@pytest.mark.parametrize("name,model", [("blstm", BLSTM), ("gru", GRU)])
def test_tp_train_and_eval_step_match_jax(layout, name, model):
    """One SGD step of deep_blstm (2 layers) and deep_gru on the layout:
    the loss against the JAX Trainer's on the same (data, model) mesh and
    the one-process step's, every gradient against the JAX one-device
    step's and the one-process step's, identical on every rank; the eval
    step from the same weights against the JAX mesh's (loss rel 1e-4, the
    counts exactly) and the one-process eval."""
    lay, ranks, refs, cases = layout
    single = R.run_case(cases[name])
    single_eval = TR.evaluate(cases[f"eval_{name}"])
    jax_mesh = refs[lay].get(model)
    for r in ranks:
        got, got_eval = r[name], r[f"eval_{name}"]
        assert got["losses"][0] == pytest.approx(single["losses"][0],
                                                 rel=TP_LOSS_RTOL)
        _grads_close(got["grads"], single["grads"], GRAD_FRAC)
        _grads_close(got["grads"], refs["one"][model]["grads"], GRAD_FRAC)
        for k, v in single_eval.items():
            assert got_eval[k] == pytest.approx(v, rel=TP_LOSS_RTOL), k
        if jax_mesh is not None:
            assert got["losses"][0] == pytest.approx(jax_mesh["loss"],
                                                     rel=JAX_LOSS_RTOL)
            want = jax_mesh["eval"]
            assert got_eval["loss"] == pytest.approx(want["loss"],
                                                     rel=JAX_LOSS_RTOL)
            for k in ("edit_dist", "label_chars", "num_seqs"):
                assert got_eval[k] == want[k], k
        for k, v in ranks[0][name]["params"].items():
            np.testing.assert_array_equal(got["params"][k], v, err_msg=k)


def test_tp_bf16_step_matches_jax(layout):
    """A bf16 SGD step of deep_blstm on the layout against the JAX
    one-device Trainer(compute_dtype=bfloat16) and the port's one-process
    bf16 step: the loss within 1e-3, every gradient within 1e-2 of its
    max; the masters stay float32."""
    _, ranks, refs, cases = layout
    single = R.run_case(cases["bf16"])
    for r in ranks:
        got = r["bf16"]
        for want in (single["losses"][0], refs["bf16"]["loss"]):
            assert got["losses"][0] == pytest.approx(want,
                                                     rel=BF16_LOSS_RTOL)
        _grads_close(got["grads"], single["grads"], BF16_GRAD_FRAC)
        _grads_close(got["grads"], refs["bf16"]["grads"], BF16_GRAD_FRAC)
        assert all(v.dtype == np.float32 for v in got["params"].values())


def test_jax_tp_gradients_are_n_model_times_one_devices(launched):
    """ROADMAP C8, pinned: on make_mesh(1, model_devices=2) the JAX step's
    loss is one device's and every gradient outside the recurrent layers
    too, while each recurrent weight's gradient is twice one device's."""
    _, refs, _ = launched
    mesh, one = refs["1x2"][BLSTM], refs["one"][BLSTM]
    assert mesh["loss"] == pytest.approx(one["loss"], rel=JAX_LOSS_RTOL)
    for k, g in one["grads"].items():
        factor = 2.0 if k.startswith("rnn/") else 1.0
        _close_frac(mesh["grads"][k], factor * g, GRAD_FRAC, k)


def test_tp_refuses_unsupported_cell_and_indivisible_hidden():
    """validate_tp and tp_scan refuse, with the JAX messages, a cell that is
    not exactly LSTMCell or GRUCell (ln_blstm, mi_blstm, zoneout_blstm)
    and a hidden width the shard count does not divide; one shard is no
    TP and passes."""
    x, mask = torch.zeros(4, 2, 5), torch.ones(4, 2, 1)
    for name in ("ln_blstm", "mi_blstm", "zoneout_blstm"):
        bad = build_model(name, "num_hiddens=8,num_layers=1",
                          num_classes=4, input_dim=5)
        validate_tp(bad, 1)
        with pytest.raises(ValueError, match="lstm/gru"):
            validate_tp(bad, 2)
        with pytest.raises(ValueError, match="lstm/gru"):
            tp_scan(bad.rnn.layers[0].rnn.fw, x, mask, None, 2)
    for name in ("deep_blstm", "deep_gru"):
        validate_tp(build_model(name, "num_hiddens=8", num_classes=4,
                                input_dim=5), 2)
        with pytest.raises(ValueError, match="divisible"):
            validate_tp(build_model(name, "num_hiddens=9", num_classes=4,
                                    input_dim=5), 2)
    with pytest.raises(ValueError, match="hidden=10 not divisible by 4"):
        tp_scan(LSTMCell(5, 10), x, mask, None, 4)
    with pytest.raises(ValueError, match="divisible"):
        tp_scan(GRUCell(5, 10), x, mask, None, 4)


# -- the CLI -------------------------------------------------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A SynthWords manifest of 16 utterances."""
    from asr_study_torch.cli import make_dataset as port_make_dataset

    d = tmp_path_factory.mktemp("tp_synth")
    m = str(d / "m.json")
    assert port_make_dataset.main([
        "--parser", "synthwords", "--dataset_dir", str(d / "corpus"),
        "--corpus_params", json.dumps({"n": 16, "seed": 0}),
        "--to_json", m]) == 0
    return m


def _losses(run):
    with open(os.path.join(run, "train_metrics.csv")) as f:
        rows = [line.split(",") for line in f.read().splitlines()]
    col = rows[0].index("loss")
    return [float(r[col]) for r in rows[1:] if r[col]]


def test_train_cli_tp_devices_runs_on_cpu(tmp_path, synth):
    """train --device cpu --tp_devices 2 runs two gloo ranks, records
    tp_devices 2 in meta.json, and gives the one-process run's losses."""
    argv = ["--dataset", synth, "--model", "deep_gru", "--params",
            "num_hiddens=8,num_layers=1", "--batch_size", "4", "--epochs",
            "1", "--log_every", "1", "--device", "cpu"]
    runs = {k: str(tmp_path / k) for k in ("tp", "one")}
    assert port_train.main([*argv, "--tp_devices", "2",
                            "--save", runs["tp"]]) == 0
    assert port_train.main([*argv, "--save", runs["one"]]) == 0
    with open(os.path.join(runs["tp"], "meta.json")) as f:
        hp = json.load(f)["hparams"]
    assert hp["tp_devices"] == 2 and hp["num_devices"] == 1
    got, want = _losses(runs["tp"]), _losses(runs["one"])
    assert len(got) == len(want) >= 2
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("argv,says", [
    (["--model", "ln_blstm", "--params", "num_hiddens=8",
      "--tp_devices", "2", "--device", "cpu"],
     "--tp_devices 2: tensor parallelism supports lstm/gru cells, got "
     "LayerNormLSTMCell"),
    (["--model", "deep_blstm", "--params", "num_hiddens=9",
      "--tp_devices", "2", "--device", "cpu"],
     "--tp_devices 2: hidden=9 not divisible by 2 model shards"),
    (["--model", "deep_blstm", "--params", "num_hiddens=8",
      "--tp_devices", "2", "--device", "cuda"],
     "--num_devices 1 x --tp_devices 2 but only 1 device(s) available"),
    (["--model", "deep_blstm", "--params", "num_hiddens=8",
      "--tp_devices", "2", "--num_devices", "3", "--batch_size", "8",
      "--device", "cpu"],
     "--batch_size 8 not divisible by 3 devices"),
])
def test_train_cli_tp_refusals_at_startup(tmp_path, monkeypatch, argv,
                                          says):
    """The JAX CLI's start-up refusals, before any data is read: a cell
    that is not lstm/gru, an indivisible width, more ranks than cards
    (the card count monkeypatched to 1), a batch the data ranks do not
    split."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as e:
        port_train.main(["--dataset", "missing.json", *argv])
    assert says in str(e.value.code)
    assert os.listdir(tmp_path) == []
