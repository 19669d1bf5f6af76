"""The port's make_dataset, train, train_lm and eval CLIs on the CPU, held
against the JAX CLIs: the same manifest, the same run-dir name and
meta.json hparams, a resumed run that continues its step count, the same
LM table and report from train_lm, and eval on weights trained by the JAX
CLI giving the same loss and transcripts, greedy and by beam search (with
an LM, blank collapse and pruning); every option the port does not have
yet refused with its ROADMAP item before any data is read, and each option
of the HDF5 and device-feature path run on a small dataset."""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from asr_study_torch.cli import data_flow
from asr_study_torch.cli import eval as port_eval
from asr_study_torch.cli import make_dataset as port_make_dataset
from asr_study_torch.cli import train as port_train
from asr_study_torch.cli import train_lm as port_train_lm
from asr_study_torch.data.dataset_parser import read_h5
from asr_study_torch.models.zoo import build_model
from asr_study_torch.train.checkpoint import CheckpointManager
from asr_study_torch.train.trainer import Trainer, make_optimizer
from asr_study_torch.utils.weights import load_npz, params_from_flat
from asr_study_tpu.cli import eval as jax_eval
from asr_study_tpu.cli import make_dataset as jax_make_dataset
from asr_study_tpu.cli import train as jax_train
from asr_study_tpu.cli import train_lm as jax_train_lm
from asr_study_tpu.models import rnn as jax_rnn
from asr_study_tpu.models import zoo as jax_zoo
from extras.export_weights import _flatten as flatten_params

SYNTH = '{"n": 20, "seed": 0}'
TRAIN_ARGS = ["--model", "graves2006", "--params", "num_hiddens=16",
              "--batch_size", "8", "--num_devices", "1", "--log_every", "1"]


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    m = str(d / "m.json")
    assert port_make_dataset.main(["--parser", "synthwords", "--dataset_dir",
                                   str(d / "corpus"), "--corpus_params", SYNTH,
                                   "--to_json", m]) == 0
    return m


# -- make_dataset ------------------------------------------------------------

def test_make_dataset_writes_the_jax_manifest(tmp_path, capsys):
    """--to_json: the port's manifest equals the JAX CLI's line for line
    (the corpus directories apart)."""
    lines = {}
    for side, main, extra in (
            ("port", port_make_dataset.main, []),
            ("jax", jax_make_dataset.main,
             ["--output", str(tmp_path / "jax.h5")])):
        root = str(tmp_path / side)
        assert main(["--parser", "synthwords", "--dataset_dir", root,
                     "--corpus_params", '{"n": 12, "seed": 2}', "--to_json",
                     str(tmp_path / f"{side}.json"), *extra]) == 0
        with open(tmp_path / f"{side}.json") as f:
            lines[side] = [l.replace(root, "<root>") for l in f]
    assert lines["port"] == lines["jax"] and len(lines["port"]) == 12
    assert "wrote 12 utterances" in capsys.readouterr().out


# -- refusals, each before the dataset is read -------------------------------

MISSING = "missing.json"


# the JAX CLIs' messages for more data-parallel devices than there are
# (asr_study_tpu/cli/train.py and cli/eval.py)
_TOO_MANY_TRAIN = ("--num_devices 2 x --tp_devices 1 but only 1 device(s) "
                   "available")
_TOO_MANY_EVAL = "--num_devices 2 but only 1 device(s) available"

# (id, cli, argv, what the refusal says: since data parallelism (item 12)
# and tensor parallelism (item 13) were ported, the JAX CLI's message for
# more devices than the card count, here monkeypatched to 1)
_REFUSED = [
    ("train-argv12-item 12", "train", ["--device", "cuda", "--num_devices",
                                       "2"], _TOO_MANY_TRAIN),
    ("train-argv13-item 13", "train", ["--device", "cuda", "--tp_devices",
                                       "2"],
     "--num_devices 1 x --tp_devices 2 but only 1 device(s) available"),
    ("eval-argv21-item 12", "eval", ["--device", "cuda", "--num_devices",
                                     "2"], _TOO_MANY_EVAL),
    ("eval-argv22-item 12", "eval", ["--device", "cuda", "--num_devices",
                                     "2", "--beam_width", "8", "--lm",
                                     "lm.npz"], _TOO_MANY_EVAL),
]


# the ids the cases had when this list also held the options of items 5,
# 7, 9 and 11
@pytest.mark.parametrize("cli,argv,says", [
    pytest.param(cli, argv, says, id=name)
    for name, cli, argv, says in _REFUSED])
def test_unported_options_are_refused(tmp_path, monkeypatch, cli, argv,
                                      says):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    base = {"train": ["--dataset", MISSING, "--device", "cpu"],
            "eval": ["--dataset", MISSING, "--save", "run", "--device",
                     "cpu"]}[cli]
    main = {"train": port_train.main, "eval": port_eval.main}[cli]
    with pytest.raises(SystemExit) as e:
        main(base + argv)
    assert says in str(e.value.code)
    assert os.listdir(tmp_path) == []          # nothing read or written


@pytest.mark.parametrize("cli,argv,why", [
    ("make_dataset", ["--output", "d.h5", "--device",
                      "--device_wire_codec", "mulaw"], "mulaw is lossy"),
    ("train", ["--wav_augment"], "needs --device_features"),
    ("train", ["--wav_augment", "gain_db=3", "--spec_augment"],
     "needs --device_features"),
    # the JAX CLIs' messages
    ("train", ["--num_devices", "3", "--batch_size", "8"],
     "--batch_size 8 not divisible by 3 devices"),
    ("eval", ["--num_devices", "3", "--batch_size", "8"],
     "--batch_size 8 not divisible by 3 devices"),
])
def test_invalid_combinations_are_refused(tmp_path, monkeypatch, cli, argv,
                                          why):
    """What the JAX CLIs refuse too, refused before any data is read."""
    monkeypatch.chdir(tmp_path)
    base = {"make_dataset": ["--parser", "dummy", "--dataset_dir", "c",
                             "--platform", "cpu"],
            "train": ["--dataset", MISSING, "--device", "cpu"],
            "eval": ["--dataset", MISSING, "--save", "run", "--device",
                     "cpu"]}[cli]
    main = {"make_dataset": port_make_dataset.main,
            "train": port_train.main, "eval": port_eval.main}[cli]
    with pytest.raises(SystemExit, match=why):
        main(base + argv)
    assert os.listdir(tmp_path) == []


@pytest.fixture(scope="module")
def small_h5(tmp_path_factory):
    """A Dummy corpus, its MFCC and raw HDF5 datasets and a run trained on
    the MFCC one, all by the port's CLIs."""
    d = tmp_path_factory.mktemp("h5cli")
    paths = {"CORPUS": str(d / "corpus"), "FEATS": str(d / "feats.h5"),
             "RAW": str(d / "raw.h5"), "RUN": str(d / "run")}
    for out, extra in (("FEATS", []), ("RAW", ["--input_parser", "raw"])):
        assert port_make_dataset.main([
            "--parser", "dummy", "--dataset_dir", paths["CORPUS"],
            "--output", paths[out], *extra]) == 0
    assert port_train.main(["--dataset", paths["FEATS"], "--device", "cpu",
                            "--epochs", "1", "--save", paths["RUN"],
                            *TRAIN_ARGS]) == 0
    return paths


# the options once refused with ROADMAP items 7, 9 and 11, each run:
# ``expect`` is the dataset's or the run's feature count, eval's utterance
# count or train_lm's sequence count
@pytest.mark.parametrize("cli,argv,expect", [
    ("make_dataset", ["--output", "d.h5", "--to_json", "m.json"], 39),
    ("make_dataset", ["--output", "d.h5", "--device"], 39),
    ("make_dataset", ["--output", "d.h5", "--device", "--device_batch", "8"],
     39),
    ("make_dataset", ["--output", "d.h5", "--device", "--device_wire_codec",
                      "dpack"], 39),
    ("make_dataset", ["--output", "d.h5", "--input_parser", "raw"], 1),
    ("make_dataset", ["--output", "d.h5", "--input_parser", "fbank"], 40),
    ("make_dataset", ["--output", "d.h5", "--input_params",
                      '{"d": false}'], 26),
    ("make_dataset", ["--output", "d.h5", "--vocab", "pt_br_apostrophe"],
     39),
    ("train", ["--dataset", "FEATS"], 39),
    ("train", ["--dataset", "RAW", "--device_features"], 39),
    ("train", ["--dataset", "FEATS", "--spec_augment"], 39),
    ("train", ["--dataset", "RAW", "--device_features", "logfbank",
               "--wav_augment", "gain_db=3"], 40),
    ("eval", ["--dataset", "FEATS", "--save", "RUN"], 3),
    ("train_lm", ["--dataset", "FEATS"], 10),
    ("train_lm", ["--dataset", "FEATS", "--splits", "train", "valid"], 13),
    # the options once refused with ROADMAP item 5
    ("train", ["--dataset", "FEATS", "--opt", "sgd"], 39),
    ("train", ["--dataset", "FEATS", "--opt", "adamw"], 39),
    ("train", ["--dataset", "FEATS", "--opt", "rmsprop"], 39),
    ("train", ["--dataset", "FEATS", "--accum_steps", "2"], 39),
    ("train", ["--dataset", "FEATS", "--lr_plateau", "0.5"], 39),
    ("train", ["--dataset", "FEATS", "--profile"], 39),
    ("train", ["--dataset", "FEATS", "--check_nans"], 39),
])
def test_ported_options_work(tmp_path, monkeypatch, capsys, small_h5, cli,
                             argv, expect):
    monkeypatch.chdir(tmp_path)
    argv = [small_h5.get(a, a) for a in argv]
    base = {"make_dataset": ["--parser", "dummy", "--dataset_dir",
                             small_h5["CORPUS"], "--platform", "cpu"],
            "train": ["--device", "cpu", "--epochs", "1", "--save", "r",
                      *TRAIN_ARGS],
            "eval": ["--device", "cpu", "--split", "test"],
            "train_lm": ["--output", "lm.npz"]}[cli]
    main = {"make_dataset": port_make_dataset.main, "train": port_train.main,
            "eval": port_eval.main, "train_lm": port_train_lm.main}[cli]
    assert main(base + argv) == 0
    out = capsys.readouterr().out
    if cli == "make_dataset":
        feats, labels, texts, _ = read_h5("d.h5", "train")
        assert feats[0].shape[1] == expect and len(labels) == 10
        assert all(texts)
        if "--to_json" in argv:
            with open("m.json") as f:
                assert len(f.readlines()) == 16
        if "--vocab" in argv:
            assert data_flow.dataset_vocab("d.h5").endswith("'")
    elif cli == "train":
        meta = CheckpointManager("r").meta
        assert meta["hparams"]["num_feats"] == expect
        assert np.isfinite(meta["history"][0]["train_loss"])
    else:
        res = _last_json(out)
        key = "num_utts" if cli == "eval" else "num_sequences"
        assert res[key] == expect


def test_device_and_run_checks(tmp_path, synth):
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            data_flow.resolve_device("cuda")
    assert data_flow.resolve_device("cpu").type == "cpu"
    with pytest.raises(SystemExit, match="--to_json"):
        port_make_dataset.main(["--parser", "dummy", "--dataset_dir",
                                str(tmp_path / "c")])
    with pytest.raises(SystemExit, match="fbank"):
        data_flow.host_feature("nosuch")
    # --early_stop needs a valid split; the manifest's train lines only
    train_only = str(tmp_path / "train_only.json")
    with open(synth) as src, open(train_only, "w") as dst:
        dst.writelines(l for l in src if '"split": "train"' in l)
    with pytest.raises(SystemExit, match="early_stop"):
        port_train.main(["--dataset", train_only, "--device", "cpu",
                         "--early_stop", "2", "--save",
                         str(tmp_path / "r"), *TRAIN_ARGS])


# -- train -------------------------------------------------------------------

def test_train_resume_and_hparams_match_jax(tmp_path, monkeypatch, synth,
                                            capsys):
    """Two epochs, then one more with --resume: the step continues and
    every loss is finite; the run dir's name and meta.json hparams are the
    JAX CLI's for the same argv."""
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", synth, *TRAIN_ARGS]
    assert port_train.main([*argv, "--device", "cpu", "--epochs", "2"]) == 0
    name = os.path.join("runs", "graves2006_params=num_hiddens=16_"
                                "batch_size=8")
    assert f"run dir: {name}" in capsys.readouterr().err
    with open(os.path.join(name, "meta.json")) as f:
        meta = json.load(f)
    spe = 2                                   # 16 train utterances / 8
    assert meta["last_step"] == 2 * spe
    assert [h["step"] for h in meta["history"]] == [spe, 2 * spe]
    assert port_train.main([*argv, "--device", "cpu", "--epochs", "1",
                            "--resume"]) == 0
    assert f"resumed from step {2 * spe}" in capsys.readouterr().err
    ckpt = CheckpointManager(name)
    assert ckpt.latest_step == 3 * spe
    hist = ckpt.meta["history"]
    assert len(hist) == 3 and all(
        np.isfinite(h[k]) for h in hist for k in ("train_loss", "val_loss"))
    with open(os.path.join(name, "train_metrics.csv")) as f:
        rows = [l.split(",") for l in f.read().splitlines()]
    loss_col = rows[0].index("loss")
    losses = [float(r[loss_col]) for r in rows[1:] if r[loss_col]]
    assert len(losses) == 3 * spe and np.isfinite(losses).all()

    # the JAX CLI on the same argv, its fit replaced by a capture
    seen = {}
    monkeypatch.setattr(jax_train, "fit",
                        lambda *a, **kw: seen.update(kw["hparams"]))
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    monkeypatch.chdir(jax_dir)
    assert jax_train.main([*argv, "--platform", "cpu", "--epochs", "2"]) == 0
    assert f"run dir: {name}" in capsys.readouterr().err
    assert os.path.isdir(name)
    assert meta["hparams"] == seen
    assert seen["num_devices"] == 1 and seen["tp_devices"] == 1


def test_train_bf16_matches_jax_losses(tmp_path, monkeypatch, synth):
    """train --bf16 on a small deep_blstm, deep_gru, zoneout_blstm (rate 0:
    the two CLIs draw no mix) and mi_blstm, each from the JAX CLI's
    initial weights (--init_from a port run holding them), gives the JAX
    CLI's per-step --bf16 losses, the JAX side on its Pallas route (the
    TPU's, whose rounding the port's kernels follow)."""
    monkeypatch.setattr(jax_rnn, "RNN_BACKEND", "pallas")
    base = "num_hiddens=8,num_layers=2,dropout=0.0"
    for model, hp in (("deep_blstm", base), ("deep_gru", base),
                      ("zoneout_blstm", base + ",zoneout_h=0.0,zoneout_c=0.0"),
                      ("mi_blstm", base)):
        out = tmp_path / model
        argv = ["--dataset", synth, "--model", model, "--params", hp,
                "--batch_size", "8", "--num_devices", "1", "--log_every",
                "1", "--epochs", "1", "--bf16"]
        jrun = str(out / "jax")
        assert jax_train.main([*argv, "--platform", "cpu", "--save",
                               jrun]) == 0
        params = getattr(jax_zoo, model)(hp, num_classes=27).init(
            jax.random.PRNGKey(0), 39)
        pm = build_model(model, hp, num_classes=27, input_dim=39)
        pm.load_state_dict(params_from_flat(flatten_params(params)))
        init = str(out / "init")
        CheckpointManager(init).save(
            Trainer(pm, make_optimizer()).init_state())
        prun = str(out / "port")
        assert port_train.main([*argv, "--device", "cpu", "--save", prun,
                                "--init_from", init]) == 0
        losses = {}
        for side, run in (("port", prun), ("jax", jrun)):
            with open(os.path.join(run, "train_metrics.csv")) as f:
                rows = [l.split(",") for l in f.read().splitlines()]
            col = rows[0].index("loss")
            losses[side] = [float(r[col]) for r in rows[1:] if r[col]]
            with open(os.path.join(run, "meta.json")) as f:
                assert json.load(f)["hparams"]["bf16"] is True
        assert len(losses["jax"]) == 2, model
        # equal to the printed digits here (measured); rtol 1e-4 leaves
        # room for Adam's normalised update of gradients a bfloat16 ulp
        # apart
        np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-4,
                                   err_msg=model)


def _logged_losses(run):
    with open(os.path.join(run, "train_metrics.csv")) as f:
        rows = [l.split(",") for l in f.read().splitlines()]
    col = rows[0].index("loss")
    return [float(r[col]) for r in rows[1:] if r[col]]


def _jax_init_run(tmp_path, hp, num_classes=27):
    """A port run dir holding the JAX CLI's initial weights (PRNGKey(0))
    of graves2006 with ``hp``, for --init_from."""
    params = jax_zoo.graves2006(hp, num_classes=num_classes).init(
        jax.random.PRNGKey(0), 39)
    pm = build_model("graves2006", hp, num_classes=num_classes,
                     input_dim=39)
    pm.load_state_dict(params_from_flat(flatten_params(params)))
    init = str(tmp_path / "init")
    CheckpointManager(init).save(Trainer(pm, make_optimizer()).init_state())
    return init


def test_train_data_parallel_matches_jax_losses(tmp_path, synth):
    """train --device cpu --num_devices 2 (two gloo ranks) from the JAX
    CLI's initial weights gives the JAX CLI's --num_devices 2 per-step
    losses (rtol 1e-4) and validation loss; rank 0 wrote the run dir, its
    hparams recording the two devices."""
    argv = ["--dataset", synth, *TRAIN_ARGS, "--num_devices", "2",
            "--epochs", "1"]
    jrun, prun = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_train.main([*argv, "--platform", "cpu", "--save", jrun]) == 0
    init = _jax_init_run(tmp_path, "num_hiddens=16")
    assert port_train.main([*argv, "--device", "cpu", "--save", prun,
                            "--init_from", init]) == 0
    want = _logged_losses(jrun)
    assert len(want) == 2
    np.testing.assert_allclose(_logged_losses(prun), want, rtol=1e-4)
    meta = {}
    for side, run in (("port", prun), ("jax", jrun)):
        with open(os.path.join(run, "meta.json")) as f:
            meta[side] = json.load(f)
    assert meta["port"]["hparams"]["num_devices"] == \
        meta["jax"]["hparams"]["num_devices"] == 2
    assert meta["port"]["last_step"] == meta["jax"]["last_step"] == 2
    assert meta["port"]["history"][0]["val_loss"] == pytest.approx(
        meta["jax"]["history"][0]["val_loss"], rel=1e-4)


def test_train_with_a_failing_rank_exits_nonzero(tmp_path, synth):
    """Ranks that raise (here: --init_from a run of another width) end
    train --num_devices 2 with their error well inside the launch's
    collective timeout."""
    init = _jax_init_run(tmp_path, "num_hiddens=8")
    t0 = time.perf_counter()
    with pytest.raises(SystemExit) as e:
        port_train.main(["--dataset", synth, *TRAIN_ARGS, "--num_devices",
                         "2", "--device", "cpu", "--epochs", "1", "--save",
                         str(tmp_path / "run"), "--init_from", init])
    msg = str(e.value.code)
    assert "train --num_devices 2: rank" in msg
    assert "param shape mismatch" in msg
    assert time.perf_counter() - t0 < 120


class _Named(Exception):
    """Stops the JAX train CLI once it has named its run dir."""


@pytest.mark.parametrize("extra", [
    [], ["--clipnorm", "0"], ["--lr", "3e-4", "--bf16"],
    ["--params", "num_hiddens=8,bidirectional=false", "--lr_decay", "0.9",
     "--early_stop", "3"]])
def test_run_dir_names_match_jax(monkeypatch, capsys, extra):
    """The port's run-dir name is the one the JAX train CLI prints for the
    same argv (the JAX CLI stopped before it reads the dataset)."""
    from asr_study_tpu.cli import data_flow as jax_data_flow

    def named(*args, **kwargs):
        raise _Named

    monkeypatch.setattr(jax_data_flow, "parser_for_training", named)
    argv = ["--dataset", "m.json", "--model", "deep_blstm", *extra]
    with pytest.raises(_Named):
        jax_train.main([*argv, "--platform", "cpu", "--num_devices", "1"])
    printed = [l for l in capsys.readouterr().err.splitlines()
               if l.startswith("run dir: ")]
    pargs = port_train.build_argparser().parse_args(argv)
    assert printed == [f"run dir: {port_train.run_dir(pargs)}"]


# -- train_lm ----------------------------------------------------------------

def test_train_lm_matches_jax(tmp_path, capsys, synth):
    """The same table, order, space id and vocabulary in the .npz, and the
    same report, from the port's and the JAX train_lm on one manifest;
    each package's LM loads in the other."""
    from asr_study_torch.text.lm import CharNGramLM
    from asr_study_tpu.text.lm import CharNGramLM as JaxCharNGramLM

    reports, paths = {}, {}
    for side, main in (("port", port_train_lm.main),
                       ("jax", jax_train_lm.main)):
        paths[side] = str(tmp_path / f"{side}.npz")
        assert main(["--dataset", synth, "--splits", "train", "valid",
                     "--order", "3", "--held_out", "test", "--output",
                     paths[side]]) == 0
        reports[side] = _last_json(capsys.readouterr().out)
        reports[side].pop("output")
    assert reports["port"] == reports["jax"]
    assert reports["port"]["num_sequences"] == 18
    for z_port, z_jax in ((CharNGramLM.load(paths["port"]),
                           JaxCharNGramLM.load(paths["jax"])),
                          (JaxCharNGramLM.load(paths["port"]),
                           CharNGramLM.load(paths["jax"]))):
        np.testing.assert_array_equal(z_port.logp, z_jax.logp)
        assert (z_port.order, z_port.space_id, z_port.vocab) == (
            z_jax.order, z_jax.space_id, z_jax.vocab)
    # plain-text input, the JAX CLI's other source
    text = tmp_path / "lines.txt"
    text.write_text("ola mundo\n\ncasa de papel\n")
    out = {}
    for side, main in (("port", port_train_lm.main),
                       ("jax", jax_train_lm.main)):
        assert main(["--text", str(text), "--order", "2", "--output",
                     str(tmp_path / f"t_{side}.npz")]) == 0
        out[side] = _last_json(capsys.readouterr().out)
        out[side].pop("output")
    assert out["port"] == out["jax"] and out["port"]["num_sequences"] == 2


# -- eval on weights the JAX CLI trained --------------------------------------

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX run trained for one epoch on a Dummy manifest, exported, and
    loaded into a run dir of the port."""
    from extras.export_weights import main as export_main

    d = tmp_path_factory.mktemp("jaxrun")
    manifest = str(d / "dummy.json")
    assert port_make_dataset.main(["--parser", "dummy", "--dataset_dir",
                                   str(d / "corpus"), "--to_json",
                                   manifest]) == 0
    jdir = str(d / "jax_run")
    assert jax_train.main([
        "--platform", "cpu", "--dataset", manifest, "--model", "graves2006",
        "--params", "num_hiddens=8", "--epochs", "1", "--batch_size", "16",
        "--num_devices", "1", "--lr", "0.01", "--save", jdir]) == 0
    npz = str(d / "w.npz")
    assert export_main(["--save", jdir, "--output", npz, "--latest"]) == 0
    flat, meta = load_npz(npz)
    with open(os.path.join(jdir, "meta.json")) as f:
        jmeta = json.load(f)
    model = build_model(meta["model"], meta["params"],
                        num_classes=meta["num_classes"],
                        input_dim=meta["num_feats"])
    model.load_state_dict(params_from_flat(flat))
    state = Trainer(model, make_optimizer()).init_state()
    state.step = jmeta["last_step"]
    pdir = str(d / "port_run")
    CheckpointManager(pdir).save(state, hparams=jmeta["hparams"])
    return manifest, jdir, pdir


@pytest.mark.parametrize("split", ["train", "test"])
def test_eval_matches_jax_eval(tmp_path, capsys, jax_run, split):
    manifest, jdir, pdir = jax_run
    dumps = {k: str(tmp_path / f"{k}.jsonl") for k in ("port", "jax")}
    assert port_eval.main(["--dataset", manifest, "--split", split, "--save",
                           pdir, "--device", "cpu", "--batch_size", "4",
                           "--dump", dumps["port"]]) == 0
    got = _last_json(capsys.readouterr().out)
    assert jax_eval.main(["--dataset", manifest, "--split", split, "--save",
                          jdir, "--platform", "cpu", "--batch_size", "4",
                          "--dump", dumps["jax"]]) == 0
    want = _last_json(capsys.readouterr().out)
    assert set(got) == set(want)
    assert got["split"] == want["split"] and got["decoder"] == "greedy"
    assert got["num_utts"] == want["num_utts"] > 0
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
    with open(dumps["port"]) as a, open(dumps["jax"]) as b:
        hyps = [json.loads(l) for l in a]
        assert hyps == [json.loads(l) for l in b]
    assert any(h["hyp"] for h in hyps)        # not all empty
    assert got["cer"] == want["cer"] and got["wer"] == want["wer"]


def test_eval_refuses_a_jax_run_dir(jax_run):
    manifest, jdir, _ = jax_run
    with pytest.raises(SystemExit, match="export_weights"):
        port_eval.main(["--dataset", manifest, "--save", jdir, "--device",
                        "cpu"])


# eval by beam search: the JAX eval in the gather form of its beam
@pytest.mark.parametrize("extra", [
    ["--beam_width", "4"],
    ["--beam_width", "4", "--lm", "LM", "--lm_alpha", "0.5",
     "--lm_beta", "0.2"],
    ["--beam_width", "4", "--blank_collapse", "0.5", "--keep_ratio", "0.3",
     "--beam_prune", "3"],
], ids=["beam4", "beam4_lm", "beam4_collapse_prune"])
def test_eval_beam_matches_jax_eval(tmp_path, capsys, monkeypatch, jax_run,
                                    extra):
    manifest, jdir, pdir = jax_run
    monkeypatch.setenv("ASR_BEAM_SELECT", "gather")
    if "LM" in extra:
        lm = str(tmp_path / "lm.npz")
        assert port_train_lm.main(["--dataset", manifest, "--output",
                                   lm]) == 0
        capsys.readouterr()
        extra = [lm if a == "LM" else a for a in extra]
    dumps = {k: str(tmp_path / f"{k}.jsonl") for k in ("port", "jax")}
    common = ["--dataset", manifest, "--split", "test", "--batch_size", "4",
              *extra]
    assert port_eval.main([*common, "--save", pdir, "--device", "cpu",
                           "--dump", dumps["port"]]) == 0
    got = _last_json(capsys.readouterr().out)
    assert jax_eval.main([*common, "--save", jdir, "--platform", "cpu",
                          "--dump", dumps["jax"]]) == 0
    want = _last_json(capsys.readouterr().out)
    assert set(got) == set(want)
    assert got["decoder"] == want["decoder"]
    assert got["decoder"] == "beam4" + ("+lm" if "--lm" in extra else "")
    if "--lm" in extra:
        assert got["lm"] == want["lm"] and got["lm"]["order"] == 3
    if "--blank_collapse" in extra:
        assert got["blank_collapse_overflow_utts"] == \
            want["blank_collapse_overflow_utts"]
    assert got["num_utts"] == want["num_utts"] > 0
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["cer"] == want["cer"] and got["wer"] == want["wer"]
    with open(dumps["port"]) as a, open(dumps["jax"]) as b:
        assert [json.loads(l) for l in a] == [json.loads(l) for l in b]


@pytest.mark.parametrize("extra", [
    [], ["--beam_width", "4"],
    ["--beam_width", "4", "--blank_collapse", "0.5", "--keep_ratio", "0.3"],
], ids=["greedy", "beam4", "beam4_collapse"])
def test_eval_data_parallel_matches_jax_and_one_device(
        tmp_path, capsys, monkeypatch, jax_run, extra):
    """eval --num_devices 2 (two gloo ranks, each decoding its rows; batch
    4 of a 3-utterance split, so rank 1 holds a padding row): the record
    and the dump equal the port's one-device eval's and the JAX CLI's
    --num_devices 2."""
    manifest, jdir, pdir = jax_run
    monkeypatch.setenv("ASR_BEAM_SELECT", "gather")
    common = ["--dataset", manifest, "--split", "test", "--batch_size", "4",
              *extra]
    got, dumps = {}, {}
    for side, argv in (
            ("one", ["--save", pdir, "--device", "cpu"]),
            ("dp", ["--save", pdir, "--device", "cpu", "--num_devices",
                    "2"]),
            ("jax", ["--save", jdir, "--platform", "cpu", "--num_devices",
                     "2"])):
        dumps[side] = str(tmp_path / f"{side}.jsonl")
        main = jax_eval.main if side == "jax" else port_eval.main
        assert main([*common, *argv, "--dump", dumps[side]]) == 0
        got[side] = _last_json(capsys.readouterr().out)
        with open(dumps[side]) as f:
            dumps[side] = [json.loads(l) for l in f]
    dp, one, jx = got["dp"], got["one"], got["jax"]
    assert dp["num_utts"] == one["num_utts"] == jx["num_utts"] == 3
    assert dp["loss"] == pytest.approx(one["loss"], rel=1e-5)
    assert dp["loss"] == pytest.approx(jx["loss"], rel=1e-4)
    for k in ("split", "decoder", "cer", "wer"):
        assert dp[k] == one[k] == jx[k], k
    if "--blank_collapse" in extra:
        assert dp["blank_collapse_overflow_utts"] == \
            one["blank_collapse_overflow_utts"] == \
            jx["blank_collapse_overflow_utts"]
    assert dumps["dp"] == dumps["one"] == dumps["jax"]
    assert any(d["hyp"] for d in dumps["dp"])


def test_eval_lm_needs_a_beam(jax_run, tmp_path):
    manifest, _, pdir = jax_run
    with pytest.raises(SystemExit, match="--lm requires --beam_width"):
        port_eval.main(["--dataset", manifest, "--save", pdir, "--device",
                        "cpu", "--lm", str(tmp_path / "lm.npz")])
