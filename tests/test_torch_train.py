"""The port's training path on the CPU: ``train.trainer`` against the JAX
``Trainer`` from the same initial weights (loaded through the weight
bridge), eval and edit distance against the JAX functions, the numpy batch
generator against the JAX one, dropout, and the port's own checkpoints and
fit loop.

On the CPU the JAX recurrence and CTC take their scan paths and the port's
kernel wrappers their plain versions."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asr_study_torch.data.generator import DatasetGenerator
from asr_study_torch.models.nn import dropout
from asr_study_torch.models.zoo import build_model, deep_blstm
from asr_study_torch.ops.metrics import edit_distance, ler
from asr_study_torch.train.checkpoint import CheckpointManager
from asr_study_torch.train.loop import fit, step_generator
from asr_study_torch.train.trainer import (Trainer, global_norm,
                                           make_optimizer)
from asr_study_torch.utils.weights import flat_from_params, params_from_flat
from asr_study_tpu.data.generator import DatasetGenerator as JaxGenerator
from asr_study_tpu.ops import ctc as jctc
from asr_study_tpu.ops import metrics as jmetrics
from asr_study_tpu.train import trainer as jtrainer
from asr_study_tpu.models import zoo as jzoo
# the exporter's own flattening: JAX tree -> tree-path keyed arrays
from extras.export_weights import _flatten as flatten_params

FEATS, CLASSES = 5, 4
HP = "num_hiddens=8,num_layers=1,dropout=0.0"
# a train step's loss and grad norm: 1e-4 relative; the
# gradients: tests/test_pallas_lstm.py's 1e-4 / 1e-5
STEP_RTOL = 1e-4
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _batch(seed, b=4, t=12, l=3):
    """Seeded numpy batch: ragged frames and labels, one zero-weight row."""
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, FEATS).astype(np.float32),
            np.array([t, 9, 11, 7][:b], np.int32),
            rng.randint(0, CLASSES, (b, l)).astype(np.int32),
            np.array([3, 2, 3, 1][:b], np.int32),
            np.array([1.0, 1.0, 0.0, 1.0][:b], np.float32))


def _port_model(hp=HP, seed=0):
    return deep_blstm(hp, num_classes=CLASSES, input_dim=FEATS,
                      generator=torch.Generator().manual_seed(seed))


JAX_MODELS = {name: getattr(jzoo, name) for name in (
    "deep_blstm", "deep_gru", "highway_blstm", "residual_blstm",
    "deep_speech", "ln_blstm", "zoneout_blstm", "mi_blstm")}


def _pair(spec_args, hp=HP, model="deep_blstm"):
    """A JAX trainer and state, and the port's trainer and state on the
    same initial weights."""
    jm = JAX_MODELS[model](hp, num_classes=CLASSES)
    jt = jtrainer.Trainer(jm, jtrainer.make_optimizer(*spec_args),
                          donate_state=False)
    jstate = jt.init_state(jax.random.PRNGKey(0), FEATS)
    pm = build_model(model, hp, num_classes=CLASSES, input_dim=FEATS,
                     generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(params_from_flat(flatten_params(jstate.params)))
    trainer = Trainer(pm, make_optimizer(*spec_args))
    return jm, jt, jstate, trainer, trainer.init_state()


def _jax_grads(jm, params, batch):
    """The JAX train step's gradient (before the clip): d (weighted loss
    sum / max(sum w, 1)) / d params."""
    inputs, in_lens, labels, lab_lens, w = map(jnp.asarray, batch)

    def loss(p):
        logits = jm.apply(p, inputs, in_lens, train=True,
                          rng=jax.random.PRNGKey(1))
        per = jctc.ctc_loss(logits, in_lens, labels, lab_lens,
                            blank_id=jm.blank_id)
        return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1.0)

    return jax.grad(loss)(params)


@pytest.mark.parametrize("spec_args,model,hp", [
    (("adam", 5e-3, 400.0), "deep_blstm", HP),
    (("adam", 5e-3, 0.5), "deep_blstm", HP),
    (("adam", 2e-2, 400.0, 0.0, 0.5, 1), "deep_blstm", HP),
    (("adam", 5e-3, 400.0), "deep_gru", "num_hiddens=8,num_layers=2,"
     "dropout=0.0,bidirectional=true"),
    (("adam", 5e-3, 0.5), "deep_gru", "num_hiddens=8,num_layers=2,"
     "dropout=0.0,bidirectional=false"),
    (("adam", 5e-3, 400.0), "deep_blstm", "num_hiddens=8,num_layers=2,"
     "dropout=0.0,bidirectional=false"),
    (("adam", 5e-3, 0.5), "highway_blstm", "num_hiddens=8,num_layers=2,"
     "dropout=0.0"),
    (("adam", 5e-3, 400.0), "residual_blstm", "num_hiddens=8,num_layers=2,"
     "dropout=0.0,bidirectional=false"),
    (("adam", 5e-3, 400.0), "deep_speech", "num_hiddens=8,input_dense=16,"
     "input_layers=2,dropout=0.0,input_dropout=0.0"),
    # rate 1e-3: at 5e-3 the LN model's third step is ill-conditioned
    # enough that float rounding alone parts the two trainers beyond 1e-4
    (("adam", 1e-3, 0.5), "ln_blstm", "num_hiddens=8,num_layers=2,"
     "dropout=0.0"),
    (("adam", 5e-3, 400.0), "ln_blstm", "num_hiddens=8,num_layers=2,"
     "dropout=0.0,bidirectional=false"),
    # zoneout at rate 0 in train mode: no draw, the mix takes the new state
    (("adam", 5e-3, 400.0), "zoneout_blstm", "num_hiddens=8,num_layers=2,"
     "dropout=0.0,zoneout_h=0.0,zoneout_c=0.0"),
    (("adam", 5e-3, 0.5), "zoneout_blstm", "num_hiddens=8,num_layers=2,"
     "dropout=0.0,zoneout_h=0.0,zoneout_c=0.0,bidirectional=false"),
    (("adam", 5e-3, 0.5), "mi_blstm", "num_hiddens=8,num_layers=2,"
     "dropout=0.0"),
    (("adam", 5e-3, 400.0), "mi_blstm", "num_hiddens=8,num_layers=2,"
     "dropout=0.0,bidirectional=false"),
], ids=["no_clip", "clip", "lr_decay", "gru_bi", "gru_uni_clip", "lstm_uni",
        "highway", "residual", "deep_speech", "ln_bi_clip", "ln_uni",
        "zoneout_bi", "zoneout_uni_clip", "mi_bi_clip", "mi_uni"])
def test_train_steps_match_jax(spec_args, model, hp):
    """Three train steps from the same weights on the same batch: each
    step's loss and grad norm, the first step's gradients key by key (after
    the clip, which optax's clip_by_global_norm decides), and the weights
    after the third update."""
    jm, jt, jstate, trainer, state = _pair(spec_args, hp, model)
    batch = _batch(0)
    tbatch = [torch.from_numpy(a) for a in batch]
    j_grads = _jax_grads(jm, jstate.params, batch)
    clipnorm = spec_args[2]
    j_clipped = optax.clip_by_global_norm(clipnorm).update(j_grads, None)[0]
    jbatch = tuple(map(jnp.asarray, batch))
    for k in range(3):
        jstate, jm_out = jt.train_step(jstate, *jbatch,
                                       jax.random.PRNGKey(1))
        state, m = trainer.train_step(state, *tbatch)
        np.testing.assert_allclose(float(m["loss"]), float(jm_out["loss"]),
                                   rtol=STEP_RTOL, err_msg=f"step {k}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm_out["grad_norm"]),
                                   rtol=STEP_RTOL, err_msg=f"step {k}")
        if k == 0:
            if clipnorm < 1.0:        # the clip fires
                assert float(m["grad_norm"]) > clipnorm
            got = flat_from_params({n: p.grad for n, p in
                                    trainer.model.named_parameters()})
            want = flatten_params(j_clipped)
            assert sorted(got) == sorted(want)
            for key in want:
                np.testing.assert_allclose(got[key], want[key], **GRAD_TOL,
                                           err_msg=key)
    assert state.step == int(jstate.step) == 3
    got = flat_from_params(trainer.model.state_dict())
    for key, want in flatten_params(jstate.params).items():
        np.testing.assert_allclose(got[key], want, rtol=1e-4, atol=1e-5,
                                   err_msg=key)


def test_clip_matches_optax_without_epsilon():
    """The clip is g * clipnorm / norm exactly where norm >= clipnorm, and
    the identity below (no 1e-6 as clip_grad_norm_ adds)."""
    trainer = Trainer(_port_model(), make_optimizer("adam", 1e-3, 2.0))
    state = trainer.init_state()
    rng = np.random.RandomState(3)
    for scale in (0.1, 10.0):
        grads = [rng.randn(*p.shape).astype(np.float32) * scale
                 for p in state.model.parameters()]
        for p, g in zip(state.model.parameters(), grads):
            p.grad = torch.from_numpy(g.copy())
        before = [p.detach().clone() for p in state.model.parameters()]
        norm = float(trainer.apply_gradients(state))
        want = optax.clip_by_global_norm(2.0).update(
            [jnp.asarray(g) for g in grads], None)[0]
        np.testing.assert_allclose(norm, float(optax.global_norm(grads)),
                                   rtol=1e-6)
        for p, w in zip(state.model.parameters(), want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=0)
        # the weights moved
        assert any(not torch.equal(a, b) for a, b in
                   zip(before, state.model.parameters()))
    assert state.step == 2


def test_lr_decay_staircase_matches_optax():
    spec = make_optimizer("adam", 1e-2, 0.0, lr_decay=0.5, decay_steps=2)
    trainer = Trainer(_port_model(), spec)
    state = trainer.init_state()
    sched = optax.exponential_decay(1e-2, transition_steps=2, decay_rate=0.5,
                                    staircase=True)
    batch = [torch.from_numpy(a) for a in _batch(1)]
    for k in range(5):
        assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
            float(sched(k)), rel=1e-6), k
        trainer.train_step(state, *batch)


@pytest.mark.parametrize("kwargs,err", [
    (dict(name="sgd"), NotImplementedError),
    (dict(name="adamw", weight_decay=1e-2), NotImplementedError),
    (dict(accum_steps=2), NotImplementedError),
    (dict(plateau_factor=0.5, plateau_patience=2), NotImplementedError),
    (dict(accum_steps=0), ValueError),
    (dict(lr_decay=1.5, decay_steps=2), ValueError),
    (dict(lr_decay=0.5), ValueError),
])
def test_make_optimizer_refuses(kwargs, err):
    with pytest.raises(err):
        make_optimizer(**kwargs)


def test_eval_step_and_run_eval_match_jax():
    jm, jt, jstate, trainer, state = _pair(("adam", 1e-3, 400.0))
    batch = _batch(2)
    got = trainer.eval_step(state, *map(torch.from_numpy, batch))
    want = jt.eval_step(jstate, *map(jnp.asarray, batch))
    for key in ("loss", "edit_dist", "label_chars", "num_seqs"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    # over host batches: the same generator output on both sides
    rng = np.random.RandomState(5)
    feats = [rng.randn(rng.randint(8, 30), FEATS).astype(np.float32)
             for _ in range(5)]
    labs = [rng.randint(0, CLASSES, rng.randint(1, 5)).astype(np.int32)
            for _ in range(5)]
    kw = dict(batch_size=3, time_multiple=32, min_time=32, label_multiple=8)
    got = trainer.run_eval(state, DatasetGenerator(**kw).flow(
        feats, labs).epoch())
    want = jt.run_eval(jstate, JaxGenerator(**kw).flow(feats, labs).epoch())
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=key)
    assert trainer.run_eval(state, []) == {"loss": 0.0, "ler": 0.0,
                                           "num_seqs": 0.0}


def test_edit_distance_matches_jax_and_host():
    rng = np.random.RandomState(3)
    b, h_max, r_max = 24, 9, 7
    hyp = rng.randint(0, 4, (b, h_max)).astype(np.int32)
    ref = rng.randint(0, 4, (b, r_max)).astype(np.int32)
    h_len = rng.randint(0, h_max + 1, b).astype(np.int32)
    r_len = rng.randint(0, r_max + 1, b).astype(np.int32)
    h_len[0], r_len[1] = 0, 0
    got = edit_distance(*map(torch.from_numpy, (hyp, h_len, ref, r_len)))
    assert got.dtype == torch.int32
    want = jmetrics.edit_distance(*map(jnp.asarray, (hyp, h_len, ref,
                                                     r_len)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    host = [jmetrics._levenshtein_py(list(hyp[i, :h_len[i]]),
                                     list(ref[i, :r_len[i]]))
            for i in range(b)]
    np.testing.assert_array_equal(got.numpy(), host)
    np.testing.assert_allclose(
        ler(*map(torch.from_numpy, (hyp, h_len, ref, r_len))).numpy(),
        np.asarray(jmetrics.ler(*map(jnp.asarray, (hyp, h_len, ref,
                                                    r_len)))), rtol=1e-6)


def test_batches_match_jax_generator():
    """Batch order, padding, weights, uids and texts are the JAX
    generator's for the same seeds, ragged last batch included."""
    rng = np.random.RandomState(4)
    n = 11
    feats = [rng.randn(rng.randint(20, 150), FEATS).astype(np.float32)
             for _ in range(n)]
    labs = [rng.randint(0, CLASSES, rng.randint(1, 20)).astype(np.int32)
            for _ in range(n)]
    texts = [f"utt {i}" for i in range(n)]
    for kw in (dict(batch_size=4), dict(batch_size=3, shuffle=False,
                                        sort_by_duration=False)):
        port = DatasetGenerator(**kw).flow(feats, labs, texts)
        ref = JaxGenerator(**kw).flow(feats, labs, texts)
        assert port.steps_per_epoch == ref.steps_per_epoch
        assert port.num_feats == ref.num_feats
        for seed, ordered in ((0, False), (1, False), (None, True)):
            got = list(port.epoch(seed=seed, ordered=ordered))
            want = list(ref.epoch(seed=seed, ordered=ordered))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for field in ("inputs", "input_lengths", "labels",
                              "label_lengths", "weights", "uids"):
                    a, b = getattr(g, field), getattr(w, field)
                    assert a.dtype == b.dtype, field
                    np.testing.assert_array_equal(a, b, err_msg=field)
                assert g.texts == w.texts and g.size == w.size
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        DatasetGenerator().flow_from_h5("x.h5", "train")
    with pytest.raises(ValueError):
        DatasetGenerator().flow([], [])


def test_dropout_semantics():
    x = torch.full((4000,), 3.0)
    y = dropout(x, 0.25, True, torch.Generator().manual_seed(0))
    kept = y != 0
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 4.0))
    assert 0.72 < float(kept.float().mean()) < 0.78
    # reproducible from the generator's seed, fresh draws otherwise
    g = torch.Generator().manual_seed(0)
    assert torch.equal(dropout(x, 0.25, True, g), y)
    assert not torch.equal(dropout(x, 0.25, True, g), y)
    # the identity in eval mode or at rate 0
    assert dropout(x, 0.25, False, g) is x
    assert dropout(x, 0.0, True, g) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.25, True, None)


def test_front_end_dropout_in_train_only():
    """deep_speech's input dropout draws from the step's generator in train
    mode; one recurrent layer, so the stack adds no dropout of its own."""
    x = torch.from_numpy(_batch(6)[0])
    lens = torch.tensor([12, 9, 11, 7])
    m = build_model("deep_speech", "num_hiddens=8,input_dense=16,"
                    "input_layers=2,dropout=0.5,input_dropout=0.5",
                    num_classes=CLASSES, input_dim=FEATS,
                    generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ev = m(x, lens)
        tr = m(x, lens, train=True,
               generator=torch.Generator().manual_seed(3))
        tr2 = m(x, lens, train=True,
                generator=torch.Generator().manual_seed(3))
        assert not torch.allclose(ev, tr)
        assert torch.equal(tr, tr2)
        with pytest.raises(ValueError, match="Generator"):
            m(x, lens, train=True)
        m.input_dropout = 0.0
        torch.testing.assert_close(
            m(x, lens, train=True,
              generator=torch.Generator().manual_seed(3)), ev, rtol=0, atol=0)


def test_stack_dropout_between_layers_in_train_only():
    x = torch.from_numpy(_batch(6)[0])
    lens = torch.tensor([12, 9, 11, 7])
    two = _port_model("num_hiddens=8,num_layers=2,dropout=0.5")
    with torch.no_grad():
        ev = two(x, lens)
        tr = two(x, lens, train=True,
                 generator=torch.Generator().manual_seed(3))
        tr2 = two(x, lens, train=True,
                  generator=torch.Generator().manual_seed(3))
        assert not torch.allclose(ev, tr)
        assert torch.equal(tr, tr2)
        # one layer: no dropout after the last layer, so train == eval
        one = _port_model("num_hiddens=8,num_layers=1,dropout=0.5")
        torch.testing.assert_close(
            one(x, lens, train=True,
                generator=torch.Generator().manual_seed(3)),
            one(x, lens), rtol=0, atol=0)


def _run_steps(trainer, state, batch, n, seed=0):
    for _ in range(n):
        trainer.train_step(state, *batch,
                           step_generator(torch.device("cpu"), seed,
                                          state.step))
    return state


def test_checkpoint_resume_equals_uninterrupted(tmp_path):
    """Save after two steps, restore into a model of other weights, two
    more steps: the weights, Adam's moments, the rate schedule and the
    step count of four uninterrupted steps, dropout on (its masks follow
    the step)."""
    hp = "num_hiddens=8,num_layers=2,dropout=0.3"
    spec = make_optimizer("adam", 1e-2, 1.0, lr_decay=0.5, decay_steps=1)
    batch = [torch.from_numpy(a) for a in _batch(7)]
    a = Trainer(_port_model(hp), spec)
    a_state = _run_steps(a, a.init_state(), batch, 4)

    b = Trainer(_port_model(hp), spec)
    b_state = _run_steps(b, b.init_state(), batch, 2)
    ckpt = CheckpointManager(str(tmp_path / "run"))
    ckpt.save(b_state, {"val_loss": 1.0}, hparams={"model": "deep_blstm"})
    c = Trainer(_port_model(hp, seed=9), spec)
    c_state = ckpt.restore(c.init_state())
    assert c_state.step == 2
    c_state = _run_steps(c, c_state, batch, 2)
    assert c_state.step == a_state.step == 4
    for (k, v), w in zip(a_state.model.state_dict().items(),
                         c_state.model.state_dict().values()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)
    assert (c_state.optimizer.param_groups[0]["lr"]
            == a_state.optimizer.param_groups[0]["lr"] == 1e-2 * 0.5 ** 4)
    for sa, sc in zip(a_state.optimizer.state.values(),
                      c_state.optimizer.state.values()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(sa[key], sc[key], rtol=0, atol=0)


@pytest.mark.parametrize("mode,best", [("min", 2), ("max", 1)])
def test_checkpoint_retention(tmp_path, mode, best):
    """latest keeps the newest max_to_keep; best keeps one by best_metric,
    in its own domain; restore(best=True), restore_params and meta.json."""
    trainer = Trainer(_port_model(), make_optimizer("adam", 1e-2, 400.0))
    state = trainer.init_state()
    batch = [torch.from_numpy(a) for a in _batch(8)]
    ckpt = CheckpointManager(str(tmp_path / "run"), max_to_keep=2,
                             mode=mode)
    saved = {}
    for val in (3.0, 2.0, 2.5):
        _run_steps(trainer, state, batch, 1)
        ckpt.save(state, {"val_loss": val, "val_ler": 0.5},
                  hparams={"model": "deep_blstm", "params": HP})
        saved[state.step] = {k: v.clone()
                             for k, v in state.model.state_dict().items()}
    ckpt.save(state, {"train_loss": 1.0})       # no best_metric: latest only
    assert ckpt.latest_step == 3 and ckpt.best_step == best
    assert sorted(os.listdir(tmp_path / "run" / "ckpt")) == ["2", "3"]
    # a fresh manager reads the same directories
    again = CheckpointManager(str(tmp_path / "run"), mode=mode)
    assert again.best_step == best
    assert again.meta["hparams"] == {"model": "deep_blstm", "params": HP}
    assert [h["step"] for h in again.meta["history"]] == [1, 2, 3, 3]
    fresh = Trainer(_port_model(seed=4), make_optimizer("adam", 1e-2, 400.0))
    restored = again.restore(fresh.init_state(), best=True)
    assert restored.step == best
    for k, v in restored.model.state_dict().items():
        torch.testing.assert_close(v, saved[best][k], rtol=0, atol=0)
    params = again.restore_params(_port_model(seed=5).state_dict())
    for k, v in params.items():
        torch.testing.assert_close(v, saved[3][k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="mismatch"):
        again.restore_params(_port_model("num_hiddens=6").state_dict())
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(
            fresh.init_state())
    with pytest.raises(ValueError, match="mode"):
        CheckpointManager(str(tmp_path / "x"), mode="lowest")


def _corpus(seed, n=7):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(rng.randint(10, 40), FEATS).astype(np.float32)
             for _ in range(n)]
    labs = [rng.randint(0, CLASSES, rng.randint(1, 5)).astype(np.int32)
            for _ in range(n)]
    gen = DatasetGenerator(batch_size=3, time_multiple=16, min_time=16,
                           label_multiple=4)
    return gen.flow(feats, labs), gen.flow(feats[:3], labs[:3])


def test_fit_resume_continues(tmp_path):
    """fit for two epochs against one epoch, a restore into other weights,
    and one more epoch at the next epoch's seed: the same weights and step
    count; per-epoch checkpoints, history and the metrics CSV."""
    train_iter, valid_iter = _corpus(0)
    spec = make_optimizer("adam", 1e-2, 400.0)
    steps = train_iter.steps_per_epoch
    a = Trainer(_port_model(), spec)
    a_state = fit(a, a.init_state(), train_iter, valid_iter, epochs=2,
                  seed=3, ckpt=CheckpointManager(str(tmp_path / "a")),
                  log_dir=str(tmp_path / "logs_a"), log_every=2)
    assert a_state.step == 2 * steps

    b = Trainer(_port_model(), spec)
    ckpt = CheckpointManager(str(tmp_path / "b"))
    b_state = fit(b, b.init_state(), train_iter, valid_iter, epochs=1,
                  seed=3, ckpt=ckpt)
    assert ckpt.latest_step == steps
    c = Trainer(_port_model(seed=8), spec)
    c_state = fit(c, ckpt.restore(c.init_state()), train_iter, valid_iter,
                  epochs=1, seed=4, ckpt=ckpt)
    assert c_state.step == 2 * steps and ckpt.latest_step == 2 * steps
    for (k, v), w in zip(a_state.model.state_dict().items(),
                         c_state.model.state_dict().values()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)
    hist = CheckpointManager(str(tmp_path / "a")).meta["history"]
    assert [h["step"] for h in hist] == [steps, 2 * steps]
    assert all(np.isfinite([h["train_loss"], h["val_loss"], h["val_ler"]])
               .all() for h in hist)
    with open(tmp_path / "logs_a" / "train_metrics.csv") as f:
        rows = f.read().splitlines()
    assert rows[0].startswith("step,") and len(rows) > 2
    del b_state


def test_fit_early_stop_and_refusals(tmp_path):
    """At rate 0 the validation loss never improves: patience 1 stops
    after the second epoch of five."""
    train_iter, valid_iter = _corpus(1)
    trainer = Trainer(_port_model(), make_optimizer("adam", 0.0, 400.0))
    state = fit(trainer, trainer.init_state(), train_iter, valid_iter,
                epochs=5, early_stop_patience=1, sortagrad=True)
    assert state.step == 2 * train_iter.steps_per_epoch
    with pytest.raises(ValueError, match="validation"):
        fit(trainer, state, train_iter, None, early_stop_patience=1)
    with pytest.raises(NotImplementedError):
        fit(trainer, state, train_iter, profile=True)


def test_front_end_dropout_through_train_step_and_fit():
    """Trainer.train_step and fit hand train=True and the step's generator
    to deep_speech's input dropout: one seed gives one step and another
    seed another, a step without a generator refuses, and fit's updates
    repeat at one seed and change when the input dropout is turned off."""
    hp = "num_hiddens=8,input_dense=16,input_layers=2,dropout=0.0"
    spec = make_optimizer("adam", 1e-2, 400.0)

    def make(rate):
        return build_model("deep_speech", f"{hp},input_dropout={rate}",
                           num_classes=CLASSES, input_dim=FEATS,
                           generator=torch.Generator().manual_seed(0))

    batch = [torch.from_numpy(a) for a in _batch(9)]
    losses = []
    for seed in (5, 5, 6):
        trainer = Trainer(make(0.5), spec)
        _, m = trainer.train_step(trainer.init_state(), *batch,
                                  torch.Generator().manual_seed(seed))
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1] != losses[2]
    with pytest.raises(ValueError, match="Generator"):
        trainer.train_step(trainer.init_state(), *batch)

    train_iter, _ = _corpus(2)
    weights = []
    for rate in (0.5, 0.5, 0.0):
        trainer = Trainer(make(rate), spec)
        state = fit(trainer, trainer.init_state(), train_iter, epochs=1,
                    seed=3)
        weights.append(state.model.state_dict())
    for k, v in weights[0].items():
        torch.testing.assert_close(v, weights[1][k], rtol=0, atol=0, msg=k)
    assert not torch.equal(weights[0]["front.0.w"], weights[2]["front.0.w"])


def test_global_norm():
    ts = [torch.tensor([3.0]), torch.tensor([[4.0, 0.0]])]
    assert float(global_norm(ts)) == pytest.approx(5.0)
