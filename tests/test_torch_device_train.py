"""In-step device features and the HDF5 CLIs of the port on the CPU, held
against the JAX package.

- ``Trainer(featurizer=...)``: a train step and an eval step on raw padded
  waveforms against the JAX ``Trainer(featurizer=DeviceFeaturizer)`` from
  the same weights (loss and parameters rel 1e-4; augmentation off, its
  draws are held in tests/test_torch_augment.py).
- ``make_dataset --output``, host and ``--device`` (the plain path on the
  CPU), against the JAX CLI: the same splits, labels and texts, features
  within 1e-4; ``--device`` over pcm16 and dpack bit-equal.
- ``train`` on an ``.h5`` against the JAX CLI's per-step losses from the
  same initial weights; ``eval`` and ``predict`` of a run trained by the
  JAX CLI with ``--device_features`` against the JAX CLIs."""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asr_study_torch.cli import eval as port_eval
from asr_study_torch.cli import make_dataset as port_make_dataset
from asr_study_torch.cli import predict as port_predict
from asr_study_torch.cli import train as port_train
from asr_study_torch.data.dataset_parser import read_h5
from asr_study_torch.features.augment import SpecAugment, WavAugment
from asr_study_torch.features.device import DeviceFeaturizer
from asr_study_torch.models.zoo import build_model
from asr_study_torch.train.checkpoint import CheckpointManager
from asr_study_torch.train.trainer import Trainer, make_optimizer
from asr_study_torch.utils.weights import load_npz, params_from_flat
from asr_study_tpu.cli import eval as jax_eval
from asr_study_tpu.cli import make_dataset as jax_make_dataset
from asr_study_tpu.cli import predict as jax_predict
from asr_study_tpu.cli import train as jax_train
from asr_study_tpu.data.dataset_parser import read_h5 as jax_read_h5
from asr_study_tpu.features.device import DeviceFeaturizer as JaxFeaturizer
from asr_study_tpu.models import zoo as jzoo
from asr_study_tpu.ops import ctc as jctc
from asr_study_tpu.train import trainer as jtrainer
from extras.export_weights import _flatten as flatten_params
from extras.export_weights import main as export_main

HP = "num_hiddens=8"
NO_DELTAS = '{"d": false, "dd": false}'
# Dummy's four tones leave most mel channels near 1e-9 of the peak, where
# any two float32 chains part by ~1e-3 after the log; the power floor that
# the JAX extractor names for tight parity keeps them comparable at 1e-4
DEVICE_ARGS = ["--device", "--device_batch", "8", "--input_params",
               '{"log_floor": 1e-2}']
TRAIN_ARGS = ["--model", "graves2006", "--params", HP, "--epochs", "1",
              "--batch_size", "8", "--num_devices", "1", "--log_every", "1"]


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def _wav_batch(seed, b=4, n=6144):
    rng = np.random.RandomState(seed)
    lens = np.array([n, n - 511, 4096, 2048][:b], np.int32)
    wavs = (0.1 * rng.randn(b, n)).astype(np.float32)
    wavs[np.arange(n)[None, :] >= lens[:, None]] = 0.0
    labels = rng.randint(0, 4, (b, 3)).astype(np.int32)
    return (wavs[..., None], lens, labels, np.full(b, 3, np.int32),
            np.array([1, 1, 0, 1][:b], np.float32))


class _Replay:
    """A featurizer that returns the JAX featurizer's output for the
    batch, so the trainer paths meet identical features."""

    def __init__(self, jfeat):
        self.fn = jax.jit(jfeat._transform)

    def _transform(self, wavs, lens):
        f, fl = self.fn(wavs.numpy(), lens.numpy())
        return torch.from_numpy(np.array(f)), torch.from_numpy(np.array(fl))


def test_featurized_steps_match_jax():
    """An eval step and a train step on raw waveforms from the same weights:
    the metrics, the loss and the grad norm, with the port's featurizer.
    Its features differ from JAX's by float32 rounding (1.4e-4 of values
    up to 53 here), so the clipped gradients (rel 1e-4, abs 1e-5) and the
    updated parameters are held with the JAX features replayed into the
    port's step, which holds the step's own path (featurize, model, CTC,
    backward, clip, Adam).  Adam's first update is lr * g / (|g| + eps),
    which float rounding flips where g is near 0: a small lr keeps those
    entries inside 1e-5."""
    jm = jzoo.graves2006(HP, num_classes=4)
    spec = ("adam", 1e-4, 10.0)
    jfeat = JaxFeaturizer(kind="mfcc")
    jt = jtrainer.Trainer(jm, jtrainer.make_optimizer(*spec),
                          donate_state=False, featurizer=jfeat)
    jstate = jt.init_state(jax.random.PRNGKey(0), 39)
    batch = _wav_batch(1)
    tb = [torch.from_numpy(a) for a in batch]
    jeval = jt.eval_step(jstate, *batch)
    jnew, jm_out = jt.train_step(jstate, *batch, jax.random.PRNGKey(2))

    replay = _Replay(jfeat)
    for feat in (DeviceFeaturizer(kind="mfcc", device="cpu"), replay):
        pm = build_model("graves2006", HP, num_classes=4, input_dim=39)
        pm.load_state_dict(params_from_flat(flatten_params(jstate.params)))
        trainer = Trainer(pm, make_optimizer(*spec), featurizer=feat)
        state = trainer.init_state()
        peval = trainer.eval_step(state, *tb)
        for k in ("loss", "edit_dist", "label_chars", "num_seqs"):
            np.testing.assert_allclose(float(peval[k]), float(jeval[k]),
                                       rtol=1e-4, err_msg=k)
        state, pm_out = trainer.train_step(state, *tb)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(pm_out[k]), float(jm_out[k]),
                                       rtol=1e-4, err_msg=k)

    jx, jl = replay.fn(batch[0][..., 0], batch[1])

    def loss_sum(params):
        logits = jm.apply(params, jx, jl, train=False)
        per = jctc.ctc_loss(logits, jl, batch[2], batch[3],
                            blank_id=jm.blank_id)
        return jnp.sum(per * batch[4]) / max(batch[4].sum(), 1.0)

    jgrads = optax.clip_by_global_norm(spec[2]).update(
        jax.jit(jax.grad(loss_sum))(jstate.params), None)[0]
    got = {k.replace(".", "/"): p.grad.numpy()
           for k, p in pm.named_parameters()}
    for k, g in flatten_params(jgrads).items():
        np.testing.assert_allclose(got[k], g, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    want = flatten_params(jnew.params)
    got = {k.replace(".", "/"): v.detach().numpy()
           for k, v in pm.state_dict().items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_augmented_step_runs_and_wav_augment_needs_a_featurizer():
    pm = build_model("graves2006", HP, num_classes=4, input_dim=39,
                     generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="needs featurizer"):
        Trainer(pm, make_optimizer(), wav_augment=WavAugment(gain_db=3))
    with pytest.raises(ValueError, match="needs featurizer"):
        jtrainer.Trainer(jzoo.graves2006(HP, num_classes=4),
                         jtrainer.make_optimizer(),
                         wav_augment=object())
    trainer = Trainer(pm, make_optimizer(),
                      augment=SpecAugment(freq_masks=2, time_masks=2),
                      featurizer=DeviceFeaturizer(kind="mfcc", device="cpu"),
                      wav_augment=WavAugment(3.0, 20.0, 50.0))
    state = trainer.init_state()
    tb = [torch.from_numpy(a) for a in _wav_batch(3)]
    _, m = trainer.train_step(state, *tb,
                              augment_generator=torch.Generator()
                              .manual_seed(1))
    assert np.isfinite(float(m["loss"])) and state.step == 1


# -- the CLIs ----------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A Dummy corpus (16 utterances) and the JAX CLI's datasets of it:
    host MFCC, raw, and MFCC extracted on the device."""
    d = tmp_path_factory.mktemp("dev")
    root = str(d / "corpus")
    files = {}
    for name, extra in (("feats", []), ("raw", ["--input_parser", "raw"]),
                        ("dev", DEVICE_ARGS)):
        files[name] = str(d / f"jax_{name}.h5")
        assert jax_make_dataset.main([
            "--parser", "dummy", "--dataset_dir", root, "--platform", "cpu",
            "--output", files[name], *extra]) == 0
    return d, root, files


@pytest.mark.parametrize("name,extra", [
    ("feats", []),
    ("raw", ["--input_parser", "raw"]),
    ("packed", ["--layout", "packed"]),
    ("dev", DEVICE_ARGS),
])
def test_make_dataset_matches_jax(corpus, capsys, name, extra):
    d, root, files = corpus
    out = str(d / f"port_{name}.h5")
    assert port_make_dataset.main([
        "--parser", "dummy", "--dataset_dir", root, "--platform", "cpu",
        "--output", out, *extra]) == 0
    assert "'train': 10, 'valid': 3, 'test': 3" in capsys.readouterr().out
    ref = files.get(name, files["feats"])
    for split in ("train", "valid", "test"):
        got, want = read_h5(out, split), jax_read_h5(ref, split)
        if name == "packed":      # the same rows, in duration order
            order = [int(i) for i in np.argsort(want[3], kind="stable")]
            want = tuple([w[i] for i in order] for w in want[:3]) + (
                want[3][order],)
        assert got[2] == want[2]
        for a, b in zip(got[1], want[1]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got[3], want[3])
        for a, b in zip(got[0], want[0]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_device_extraction_dpack_equals_pcm16(corpus):
    d, root, _ = corpus
    outs = []
    for codec in ("pcm16", "dpack"):
        outs.append(str(d / f"dev_{codec}.h5"))
        assert port_make_dataset.main([
            "--parser", "dummy", "--dataset_dir", root, "--platform", "cpu",
            "--output", outs[-1], "--device", "--device_batch", "5",
            "--device_wire_codec", codec]) == 0
    for split in ("train", "test"):
        a, b = read_h5(outs[0], split), read_h5(outs[1], split)
        for x, y in zip(a[0], b[0]):
            np.testing.assert_array_equal(x, y)


def _jax_losses(run):
    with open(os.path.join(run, "train_metrics.csv")) as f:
        return [float(r["loss"]) for r in csv.DictReader(f) if r["loss"]]


def test_train_on_h5_matches_jax_losses(corpus, tmp_path):
    """The port's train CLI from the JAX CLI's initial weights (``--init_from``
    a port run holding them) gives the JAX CLI's per-step losses."""
    _, _, files = corpus
    jrun = str(tmp_path / "jax_run")
    assert jax_train.main(["--dataset", files["feats"], "--platform", "cpu",
                           "--save", jrun, *TRAIN_ARGS]) == 0
    jm = jzoo.graves2006(HP, num_classes=27)
    params = jm.init(jax.random.PRNGKey(0), 39)
    pm = build_model("graves2006", HP, num_classes=27, input_dim=39)
    pm.load_state_dict(params_from_flat(flatten_params(params)))
    init = str(tmp_path / "init")
    CheckpointManager(init).save(Trainer(pm, make_optimizer()).init_state())
    prun = str(tmp_path / "port_run")
    assert port_train.main(["--dataset", files["feats"], "--device", "cpu",
                            "--save", prun, "--init_from", init,
                            *TRAIN_ARGS]) == 0
    want = _jax_losses(jrun)
    assert len(want) == 2
    np.testing.assert_allclose(_jax_losses(prun), want, rtol=1e-4)
    with open(os.path.join(prun, "meta.json")) as f:
        hp = json.load(f)["hparams"]
    assert hp["num_feats"] == 39 and hp["vocab"].startswith("abc")


@pytest.fixture(scope="module")
def raw_runs(corpus, tmp_path_factory):
    """A run the JAX CLI trained with --device_features on the raw
    dataset, and a port run dir holding its weights and hparams."""
    _, _, files = corpus
    d = tmp_path_factory.mktemp("rawrun")
    jrun = str(d / "jax")
    assert jax_train.main(["--dataset", files["raw"], "--platform", "cpu",
                           "--save", jrun, "--device_features", "mfcc",
                           "--device_feature_params", NO_DELTAS,
                           *TRAIN_ARGS]) == 0
    npz = str(d / "w.npz")
    assert export_main(["--save", jrun, "--output", npz, "--latest"]) == 0
    flat, meta = load_npz(npz)
    with open(os.path.join(jrun, "meta.json")) as f:
        jmeta = json.load(f)
    assert jmeta["hparams"]["num_feats"] == 13
    model = build_model(meta["model"], meta["params"],
                        num_classes=meta["num_classes"], input_dim=13)
    model.load_state_dict(params_from_flat(flat))
    state = Trainer(model, make_optimizer()).init_state()
    state.step = jmeta["last_step"]
    prun = str(d / "port")
    CheckpointManager(prun).save(state, hparams=jmeta["hparams"])
    return jrun, prun


def test_eval_of_a_device_feature_run_matches_jax(corpus, raw_runs,
                                                  tmp_path, capsys):
    _, _, files = corpus
    jrun, prun = raw_runs
    dumps = {k: str(tmp_path / f"{k}.jsonl") for k in ("port", "jax")}
    common = ["--dataset", files["raw"], "--split", "test"]
    assert port_eval.main([*common, "--save", prun, "--device", "cpu",
                           "--dump", dumps["port"]]) == 0
    got = _last_json(capsys.readouterr().out)
    assert jax_eval.main([*common, "--save", jrun, "--platform", "cpu",
                          "--dump", dumps["jax"]]) == 0
    want = _last_json(capsys.readouterr().out)
    assert got["num_utts"] == want["num_utts"] == 3
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
    assert got["cer"] == want["cer"] and got["wer"] == want["wer"]
    with open(dumps["port"]) as a, open(dumps["jax"]) as b:
        assert [json.loads(l) for l in a] == [json.loads(l) for l in b]
    # a feature dataset given to a raw run is refused, as in JAX
    with pytest.raises(SystemExit, match="raw-waveform"):
        port_eval.main(["--dataset", files["feats"], "--save", prun,
                        "--device", "cpu"])


def test_eval_data_parallel_of_a_device_feature_run(corpus, raw_runs,
                                                   tmp_path, capsys):
    """eval --num_devices 2 of a --device_features run: each gloo rank
    featurizes and decodes its rows; the record and the dump equal the
    one-device eval's and the JAX CLI's --num_devices 2 (as
    tests/test_device_train.py holds the JAX CLI's to its one-device
    run)."""
    _, _, files = corpus
    jrun, prun = raw_runs
    common = ["--dataset", files["raw"], "--split", "test", "--batch_size",
              "4"]
    got, dumps = {}, {}
    for side, argv in (
            ("one", ["--save", prun, "--device", "cpu"]),
            ("dp", ["--save", prun, "--device", "cpu", "--num_devices",
                    "2"]),
            ("jax", ["--save", jrun, "--platform", "cpu", "--num_devices",
                     "2"])):
        dumps[side] = str(tmp_path / f"{side}.jsonl")
        main = jax_eval.main if side == "jax" else port_eval.main
        assert main([*common, *argv, "--dump", dumps[side]]) == 0
        got[side] = _last_json(capsys.readouterr().out)
        with open(dumps[side]) as f:
            dumps[side] = [json.loads(l) for l in f]
    assert got["dp"]["num_utts"] == got["one"]["num_utts"] == 3
    assert got["dp"]["loss"] == pytest.approx(got["one"]["loss"], rel=1e-5)
    assert got["dp"]["loss"] == pytest.approx(got["jax"]["loss"], rel=1e-4)
    for k in ("cer", "wer", "decoder"):
        assert got["dp"][k] == got["one"][k] == got["jax"][k], k
    assert dumps["dp"] == dumps["one"] == dumps["jax"]


def test_predict_of_a_device_feature_run_matches_jax(corpus, raw_runs,
                                                     capsys):
    _, root, _ = corpus
    jrun, prun = raw_runs
    wavs = sorted(os.path.join(root, f) for f in os.listdir(root)
                  if f.endswith(".wav"))[:3]
    outs = {}
    for side, argv in (
            ("port", ["--save", prun, "--device", "cpu"]),
            ("port_dev", ["--save", prun, "--device", "cpu", "--on_device"]),
            ("port_explicit", ["--save", prun, "--device", "cpu",
                               "--input_parser", "mfcc", "--input_params",
                               NO_DELTAS]),
            ("jax", ["--save", jrun, "--platform", "cpu"])):
        main = jax_predict.main if side == "jax" else port_predict.main
        assert main([*argv, *wavs]) == 0
        outs[side] = [json.loads(l) for l in
                      capsys.readouterr().out.strip().splitlines()]
    assert len(outs["jax"]) == 3
    assert outs["port"] == outs["jax"] == outs["port_explicit"]
    assert [o["file"] for o in outs["port_dev"]] == wavs
    # an explicit parser drops the recorded params: 39 MFCCs for 13 inputs
    with pytest.raises(SystemExit, match="gives 39 features"):
        port_predict.main(["--save", prun, "--device", "cpu",
                           "--input_parser", "mfcc", *wavs])
