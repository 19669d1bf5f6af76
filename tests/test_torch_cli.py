"""The port's predict CLI on the CPU: two wavs and an ``export_weights``
artifact in, one JSON line per file out, with the transcripts the JAX
pipeline gives for the same weights, greedy and by beam search with an
LM."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_study_torch.cli import predict
from asr_study_tpu.data import wire as jwire
from asr_study_tpu.features import audio
from asr_study_tpu.features.device import DeviceFeaturizer as JaxFeaturizer
from asr_study_tpu.features.wav import read_wav, write_wav
from asr_study_tpu.models import zoo as jzoo
from asr_study_tpu.models.zoo import deep_gru, graves2006
from asr_study_tpu.ops import beam_search_decode as jax_beam_search_decode
from asr_study_tpu.ops.ctc import greedy_decode as jax_greedy_decode
from asr_study_tpu.text.lm import fit_ngram_lm as jax_fit_ngram_lm
from asr_study_tpu.text.parser import CharParser
from extras.export_weights import _flatten as flatten_params

HP = "num_hiddens=12"


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    paths = []
    for i, n in enumerate((6000, 3500)):
        t = np.arange(n) / 16000.0
        w = 0.4 * np.sin(2 * np.pi * 200 * (i + 1) * t) + 0.05 * rng.randn(n)
        p = str(d / f"utt{i}.wav")
        write_wav(p, w)
        paths.append(p)
    model = graves2006(HP, num_classes=27)
    params = model.init(jax.random.PRNGKey(1), 39)
    meta = {"model": "graves2006", "params": HP, "num_feats": 39,
            "num_classes": 27, "vocab": CharParser().vocab, "blank_id": 27}
    npz = str(d / "model.npz")
    np.savez(npz, __meta__=json.dumps(meta), **flatten_params(params))
    return npz, paths, model, params


def _jax_transcripts(model, params, paths, on_device, beam=None):
    """The JAX pipeline's transcripts: greedy, or with ``beam`` (kwargs of
    its beam_search_decode) the best beam."""
    parser = CharParser()
    wavs = [read_wav(p)[0] for p in paths]
    if on_device:
        n_pad = -(-max(len(w) for w in wavs) // 2048) * 2048
        cap = jwire.wire_cap(len(wavs), sum(map(len, wavs)), align=256)
        w, lens = jwire.unpack_audio(
            jnp.asarray(jwire.pack_audio(wavs, cap)), len(wavs), n_pad)
        feats, fl = JaxFeaturizer(kind="mfcc")(w, lens)
    else:
        fs = [audio.MFCC()(w) for w in wavs]
        t_max = max(f.shape[0] for f in fs)
        feats = np.zeros((len(fs), t_max, 39), np.float32)
        for i, f in enumerate(fs):
            feats[i, : len(f)] = f
        fl = jnp.asarray([len(f) for f in fs], jnp.int32)
    logits = model.apply(params, jnp.asarray(feats), fl, train=False)
    if beam:
        dec, lens, _ = jax_beam_search_decode(logits, fl, blank_id=27,
                                              **beam)
        dec, lens = dec[:, 0], lens[:, 0]
    else:
        dec, lens = jax_greedy_decode(logits, fl, blank_id=27)
    dec, lens = np.asarray(dec), np.asarray(lens)
    return [parser.imap(dec[i, : lens[i]]) for i in range(len(paths))]


@pytest.mark.parametrize("on_device", [True, False],
                         ids=["on_device", "host_features"])
def test_predict_prints_json_lines(artifact, capsys, on_device):
    npz, paths, model, params = artifact
    argv = ["--weights", npz, "--device", "cpu", "--batch_size", "2", *paths]
    if on_device:
        argv.insert(0, "--on_device")
    assert predict.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(line) for line in lines]
    assert [r["file"] for r in rows] == paths
    want = _jax_transcripts(model, params, paths, on_device)
    assert [r["transcript"] for r in rows] == want


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_predict_serves_exported_deep_gru(artifact, tmp_path, capsys,
                                          bidirectional):
    """An exported JAX deep_gru .npz served on the CPU, with the
    transcripts of the JAX pipeline for the same weights."""
    _, paths, _, _ = artifact
    hp = (f"num_hiddens=12,num_layers=2,"
          f"bidirectional={str(bidirectional).lower()}")
    model = deep_gru(hp, num_classes=27)
    params = model.init(jax.random.PRNGKey(2), 39)
    meta = {"model": "deep_gru", "params": hp, "num_feats": 39,
            "num_classes": 27, "vocab": CharParser().vocab, "blank_id": 27}
    npz = str(tmp_path / "gru.npz")
    np.savez(npz, __meta__=json.dumps(meta), **flatten_params(params))
    assert predict.main(["--on_device", "--weights", npz, "--device", "cpu",
                         "--batch_size", "2", *paths]) == 0
    rows = [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["file"] for r in rows] == paths
    want = _jax_transcripts(model, params, paths, on_device=True)
    assert [r["transcript"] for r in rows] == want


@pytest.mark.parametrize("name,hp", [
    ("deep_blstm", "num_hiddens=12,num_layers=2,bidirectional=false"),
    ("highway_blstm", "num_hiddens=12,num_layers=2"),
    ("residual_blstm", "num_hiddens=12,num_layers=2"),
    ("deep_speech", "num_hiddens=12,input_dense=16"),
    ("ln_blstm", "num_hiddens=12,num_layers=2"),
    ("zoneout_blstm", "num_hiddens=12,num_layers=2"),
    ("mi_blstm", "num_hiddens=12,num_layers=2"),
])
def test_predict_serves_exported_lstm_zoo(artifact, tmp_path, capsys, name,
                                          hp):
    """An exported JAX .npz of each LSTM model the port added after
    deep_blstm (the unidirectional deep_blstm, the highway and residual
    stacks, the Deep Speech front end, the layer-norm, zoneout and MI
    BLSTMs) served on the CPU, with the transcripts of the JAX pipeline for
    the same weights."""
    _, paths, _, _ = artifact
    model = getattr(jzoo, name)(hp, num_classes=27)
    params = model.init(jax.random.PRNGKey(3), 39)
    meta = {"model": name, "params": hp, "num_feats": 39,
            "num_classes": 27, "vocab": CharParser().vocab, "blank_id": 27}
    npz = str(tmp_path / f"{name}.npz")
    np.savez(npz, __meta__=json.dumps(meta), **flatten_params(params))
    assert predict.main(["--on_device", "--weights", npz, "--device", "cpu",
                         "--batch_size", "2", *paths]) == 0
    rows = [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["file"] for r in rows] == paths
    want = _jax_transcripts(model, params, paths, on_device=True)
    assert [r["transcript"] for r in rows] == want


@pytest.mark.parametrize("flag", [
    ["--stream"], ["--stream", "--beam_width", "4"],
])
def test_unported_options_refused(artifact, flag):
    npz, paths, _, _ = artifact
    with pytest.raises(SystemExit, match="--stream is host-featurized "
                       "decoding; it excludes --on_device"):
        predict.main(["--weights", npz, "--device", "cpu", "--on_device",
                      *flag, *paths])


@pytest.mark.parametrize("on_device", [True, False],
                         ids=["on_device", "host_features"])
def test_predict_beam_with_lm_matches_jax(artifact, tmp_path, capsys,
                                          monkeypatch, on_device):
    """--beam_width 4 --lm: the best beam with the LM fused, as the JAX
    decoder (its gather form) gives it on the JAX pipeline's logits, over
    both serving paths."""
    npz, paths, model, params = artifact
    monkeypatch.setenv("ASR_BEAM_SELECT", "gather")
    parser = CharParser()
    lm = jax_fit_ngram_lm(
        [parser(t) for t in ("ola mundo", "a casa de papel", "mundo novo")],
        order=3, n_char=parser.num_classes, space_id=parser.char_to_id[" "],
        vocab=parser.vocab)
    lm_path = str(tmp_path / "lm3.npz")
    lm.save(lm_path)
    argv = ["--weights", npz, "--device", "cpu", "--batch_size", "2",
            "--beam_width", "4", "--lm", lm_path, "--lm_alpha", "0.6",
            "--lm_beta", "0.4", *paths]
    if on_device:
        argv.insert(0, "--on_device")
    assert predict.main(argv) == 0
    rows = [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["file"] for r in rows] == paths
    want = _jax_transcripts(model, params, paths, on_device, beam=dict(
        beam_width=4, lm=lm, lm_alpha=0.6, lm_beta=0.4))
    assert [r["transcript"] for r in rows] == want


def test_predict_lm_needs_a_beam(artifact, tmp_path):
    npz, paths, _, _ = artifact
    with pytest.raises(SystemExit, match="--lm requires --beam_width"):
        predict.main(["--weights", npz, "--device", "cpu", "--lm",
                      str(tmp_path / "lm.npz"), *paths])


def test_wrong_feature_width_refused(artifact):
    npz, paths, _, _ = artifact
    with pytest.raises(SystemExit, match="features"):
        predict.main(["--weights", npz, "--device", "cpu", "--on_device",
                      "--input_parser", "logfbank", *paths])


def _rows(capsys):
    captured = capsys.readouterr()
    return ([json.loads(line) for line in captured.out.strip().splitlines()],
            captured.err)


@pytest.mark.parametrize("codec", ["dpack", "mulaw", "auto"])
def test_predict_over_each_wire_codec(artifact, capsys, codec):
    """--wire_codec dpack transcribes exactly as pcm16 and as the JAX
    pipeline do; mulaw (lossy) completes with one JSON line a file; auto
    prints the codec it chose to stderr and transcribes."""
    npz, paths, model, params = artifact
    argv = ["--on_device", "--weights", npz, "--device", "cpu",
            "--batch_size", "2", *paths]
    assert predict.main(argv) == 0
    pcm16, _ = _rows(capsys)
    assert predict.main(["--wire_codec", codec, *argv]) == 0
    rows, err = _rows(capsys)
    assert [r["file"] for r in rows] == paths
    if codec == "mulaw":
        return
    if codec == "auto":
        assert "wire_codec auto:" in err
        assert err.strip().split()[-1] in ("pcm16", "dpack")
    assert [r["transcript"] for r in rows] == \
        [r["transcript"] for r in pcm16]
    want = _jax_transcripts(model, params, paths, on_device=True)
    assert [r["transcript"] for r in rows] == want


def test_unknown_wire_codec_refused(artifact, capsys):
    npz, paths, _, _ = artifact
    with pytest.raises(SystemExit):
        predict.main(["--on_device", "--weights", npz, "--device", "cpu",
                      "--wire_codec", "flac", *paths])
    assert "invalid choice" in capsys.readouterr().err
