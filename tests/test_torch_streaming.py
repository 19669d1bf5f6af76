"""Streaming inference in the port (asr_study_torch/streaming.py, the
models' apply_streaming, ops/beam.py's stream form, predict --stream)
against the JAX package's (asr_study_tpu/streaming.py) on the CPU, at a
small size: H=16, two layers, a few classes, under 2 s of audio.  Every
cell kind streams: the LSTM, GRU, layer-norm, MI and zoneout LSTMs (the
last with its eval-mode mix), unidirectional."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_study_torch import streaming
from asr_study_torch.cli import predict as port_predict
from asr_study_torch.features import audio
from asr_study_torch.models.zoo import build_model
from asr_study_torch.ops import beam
from asr_study_torch.text.lm import fit_ngram_lm
from asr_study_torch.utils.weights import (flat_from_params,
                                           params_from_flat)
from asr_study_tpu import streaming as jstreaming
from asr_study_tpu.cli import predict as jax_predict
from asr_study_tpu.features import audio as jaudio
from asr_study_tpu.features.wav import write_wav
from asr_study_tpu.models import zoo as jzoo
from asr_study_tpu.ops import beam as jbeam
from asr_study_tpu.text.lm import fit_ngram_lm as jax_fit_ngram_lm
from asr_study_tpu.text.parser import CharParser
from asr_study_tpu.train.checkpoint import CheckpointManager
from asr_study_tpu.train.trainer import Trainer, make_optimizer
from extras.export_weights import _flatten as flatten_params

UNI = "num_hiddens=16,num_layers=2,bidirectional=false,dropout=0.0"
STREAM_MODELS = {
    "deep_gru": UNI,
    "deep_blstm": UNI,
    "highway_blstm": UNI,
    "deep_speech": "num_hiddens=16,input_dense=16,bidirectional=false,"
                   "dropout=0.0,input_dropout=0.0",
    # the layer-norm, MI and zoneout LSTMs (zoneout with its eval mix)
    "ln_blstm": UNI,
    "mi_blstm": UNI,
    "zoneout_blstm": UNI + ",zoneout_h=0.2,zoneout_c=0.3",
}
CELL_MODELS = ("ln_blstm", "mi_blstm", "zoneout_blstm")


def _wav(seconds=1.7, seed=0, sr=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    sig = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(
        len(t))
    return sig.astype(np.float32)


def _chunks(x, sizes):
    out, i, k = [], 0, 0
    while i < len(x):
        n = sizes[k % len(sizes)]
        out.append(x[i: i + n])
        i += n
        k += 1
    return out


def _models(name, hp, num_classes=5, input_dim=7, seed=0):
    """The JAX model and params, and the port model with the same weights
    through the weight bridge."""
    jm = jzoo.build_model(name, hp, num_classes=num_classes)
    params = jm.init(jax.random.PRNGKey(seed), input_dim)
    pm = build_model(name, hp, num_classes=num_classes, input_dim=input_dim)
    pm.load_state_dict(params_from_flat(flatten_params(params)))
    return jm, params, pm.eval()


FEATURES = {
    "mfcc_d_dd": dict(kind="MFCC", d=True, dd=True),
    "mfcc_dd_only": dict(kind="MFCC", d=False, dd=True),
    "logfbank_energy": dict(kind="LogFbank", d=True, append_energy=True),
    "fbank": dict(kind="FBank"),
    "mfcc_hann": dict(kind="MFCC", window="hann"),
}


@pytest.mark.parametrize("sizes", [(100,), (1600,), (333, 7000, 1)],
                         ids=["sub_frame", "hop_aligned", "mixed"])
@pytest.mark.parametrize("feature", list(FEATURES))
def test_featurizer_matches_jax_and_oracle(feature, sizes):
    """Every chunk's rows equal the JAX featurizer's exactly (float32), and
    the rows together the port's full-utterance oracle to 1e-12."""
    kw = dict(FEATURES[feature])
    kind = kw.pop("kind")
    wav = _wav()
    port = streaming.StreamingFeaturizer(getattr(audio, kind)(**kw))
    jax_ = jstreaming.StreamingFeaturizer(getattr(jaudio, kind)(**kw))
    got = []
    for c in [*_chunks(wav, sizes), None]:
        a = port.push(c) if c is not None else port.finish()
        b = jax_.push(c) if c is not None else jax_.finish()
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        got.append(a)
    got = np.vstack([g for g in got if len(g)])
    ref = getattr(audio, kind)(**kw)(wav)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("feature,match", [
    (dict(kind="MFCC", mean_norm=True), "CMVN"),
    (dict(kind="Raw"), "unsupported"),
    (dict(kind="MFCC", convention="librosa"), "center"),
], ids=["cmvn", "raw", "center"])
def test_featurizer_refusals(feature, match):
    kw = dict(feature)
    with pytest.raises(ValueError, match=match):
        streaming.StreamingFeaturizer(getattr(audio, kw.pop("kind"))(**kw))


@pytest.mark.parametrize("name", list(STREAM_MODELS))
def test_apply_streaming_matches_jax_and_forward(name):
    """Chunks of 10 frames with a ragged tail (and a batch row with fewer
    frames, whose carry holds): logits and carries against JAX
    apply_streaming, and the logits against the port's own forward, atol
    1e-5."""
    jm, params, pm = _models(name, STREAM_MODELS[name])
    rng = np.random.RandomState(1)
    t = 37
    x = rng.randn(2, t, 7).astype(np.float32)
    lengths = np.array([t, 23], np.int32)
    jc, pc = jm.init_stream_carries(2), pm.init_stream_carries(2)
    j_step = jax.jit(jm.apply_streaming)
    got, want = [], []
    for lo in range(0, t, 10):
        chunk = np.zeros((2, 10, 7), np.float32)
        n = min(10, t - lo)
        chunk[:, :n] = x[:, lo: lo + n]
        valid = np.clip(lengths - lo, 0, 10).astype(np.int32)
        j_logits, jc = j_step(params, jnp.asarray(chunk), jnp.asarray(valid),
                              jc)
        p_logits, pc = pm.apply_streaming(torch.from_numpy(chunk),
                                          torch.from_numpy(valid), pc)
        want.append(np.asarray(j_logits)[:, :n])
        got.append(p_logits.numpy()[:, :n])
        for jl, pl in zip(jc, pc):
            assert len(jl) == len(pl)
            for a, b in zip(jl, pl):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           atol=1e-5, rtol=0)
    got, want = np.concatenate(got, 1), np.concatenate(want, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with torch.no_grad():
        whole = pm(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    mask = (np.arange(t)[None, :] < lengths[:, None])[..., None]
    np.testing.assert_allclose(got * mask, whole * mask, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name,hp,match", [
    ("deep_gru", "num_hiddens=16,num_layers=2", "unidirectional"),
], ids=["bidirectional"])
def test_streaming_refusals(name, hp, match):
    """A bidirectional model cannot stream (the JAX message)."""
    model = build_model(name, hp, num_classes=5, input_dim=13)
    with pytest.raises(ValueError, match=match):
        model.init_stream_carries(1)
    with pytest.raises(ValueError, match=match):
        streaming.StreamingRecognizer(model, audio.MFCC(d=False, dd=False))
    with pytest.raises(ValueError, match=match):
        streaming.MultiStreamRecognizer(model, audio.MFCC(d=False, dd=False),
                                        n_streams=2)


@pytest.mark.parametrize("name", CELL_MODELS, ids=["ln", "mi", "zoneout"])
def test_cell_recognizers_match_jax(name, monkeypatch):
    """StreamingRecognizer (greedy and by beam) and MultiStreamRecognizer
    on the layer-norm, MI and zoneout LSTMs: the JAX recognizers' ids."""
    monkeypatch.setenv("ASR_BEAM_SELECT", "gather")
    jm, params, pm = _models(name, STREAM_MODELS[name], input_dim=13, seed=3)
    feature = dict(d=False, dd=False)
    wavs = [_wav(s, seed=20 + i) for i, s in enumerate((1.1, 0.7))]
    for kw in ({}, dict(beam_width=4)):
        port = streaming.StreamingRecognizer(pm, audio.MFCC(**feature),
                                             chunk_frames=16, **kw)
        jax_ = jstreaming.StreamingRecognizer(jm, params,
                                              jaudio.MFCC(**feature),
                                              chunk_frames=16, **kw)
        for c in _chunks(wavs[0], (2500, 700, 4100)):
            port.push(c)
            jax_.push(c)
        assert port.finish() == jax_.finish()
    port = streaming.MultiStreamRecognizer(pm, audio.MFCC(**feature), 2,
                                           chunk_frames=16)
    jax_ = jstreaming.MultiStreamRecognizer(jm, params,
                                            jaudio.MFCC(**feature), 2,
                                            chunk_frames=16)
    for i, w in enumerate(wavs):
        port.push(i, w)
        jax_.push(i, w)
    port.tick()
    jax_.tick()
    assert [port.finish(i) for i in (1, 0)] == [jax_.finish(i)
                                                 for i in (1, 0)]


def _beam_case(seed=0, t_max=45, n_char=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(t_max, n_char + 1).astype(np.float32) * 2
    x[:, -1] += np.where(rng.rand(t_max) < 0.5, 3.0, -3.0)
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    seqs = [rng.randint(0, n_char, size=rng.randint(1, 12))
            for _ in range(40)]
    return lp.astype(np.float32), seqs


@pytest.mark.parametrize("chunk", [7, 16, 45], ids=["c7", "c16", "c45"])
@pytest.mark.parametrize("with_lm", [False, True], ids=["nolm", "lm3"])
def test_beam_stream_chunk_matches_jax(monkeypatch, with_lm, chunk):
    """beam_stream_chunk chunk by chunk against the JAX one (its gather
    form): prefixes, emits and start slots exactly, the state's integers
    exactly and its scores at rtol 1e-5; the last chunk ragged."""
    monkeypatch.setenv("ASR_BEAM_SELECT", "gather")
    lp, seqs = _beam_case()
    width, n_char = 8, lp.shape[1] - 1
    kw, jkw = {}, {}
    if with_lm:
        kw = dict(lm=fit_ngram_lm(seqs, 3, n_char, 0), lm_alpha=0.7,
                  lm_beta=0.2)
        jkw = dict(kw, lm=jax_fit_ngram_lm(seqs, 3, n_char, 0))
    lm0 = kw["lm"].init_state() if with_lm else 0
    state, jstate = beam.beam_stream_init(width, lm0), \
        jbeam.beam_stream_init(width, lm0)
    j_chunk = jax.jit(lambda x, v, st: jbeam.beam_stream_chunk(
        x, v, st, width, n_char, **jkw))
    for lo in range(0, len(lp), chunk):
        part = lp[lo: lo + chunk]
        padded = np.zeros((chunk, lp.shape[1]), np.float32)
        padded[: len(part)] = part
        valid = np.arange(chunk) < len(part)
        state, pref, emits, start, scores = beam.beam_stream_chunk(
            torch.from_numpy(padded), torch.from_numpy(valid), state, width,
            n_char, **kw)
        jstate, jpref, jemits, jstart, jscores = j_chunk(
            jnp.asarray(padded), jnp.asarray(valid), jstate)
        np.testing.assert_array_equal(pref.numpy(), np.asarray(jpref))
        np.testing.assert_array_equal(emits.numpy(), np.asarray(jemits))
        np.testing.assert_array_equal(start.numpy(), np.asarray(jstart))
        np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                                   rtol=1e-5)
        for name, got, want in zip(beam.BeamState._fields, state, jstate):
            want = np.asarray(want)
            if name.startswith("p_"):
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
            else:
                np.testing.assert_array_equal(got.numpy(),
                                              want.view(np.int32))


def test_beam_tail_frames_do_not_move_the_beam():
    """Frames past the valid count change nothing: the same chunk with
    random tail frames and cut to its valid frames give the same state
    and the same prefixes; a chunk of no valid frames leaves the state and
    emits nothing, each slot starting from itself."""
    lp, _ = _beam_case(seed=3)
    width, n_char = 6, lp.shape[1] - 1
    state = beam.beam_stream_init(width)
    state = beam.beam_stream_chunk(torch.from_numpy(lp[:20]), 20, state,
                                   width, n_char)[0]
    cut = beam.beam_stream_chunk(torch.from_numpy(lp[20:31]), 11, state,
                                 width, n_char)
    tail = beam.beam_stream_chunk(torch.from_numpy(lp[20:45]), 11, state,
                                  width, n_char)
    for a, b in zip(cut[0], tail[0]):
        assert torch.equal(a, b)
    assert torch.equal(tail[1][:, :11], cut[1])
    assert bool((tail[1][:, 11:] == -1).all())
    for a, b in zip(cut[2:], tail[2:]):
        assert torch.equal(a, b)
    held = beam.beam_stream_chunk(torch.from_numpy(lp[:9]), 0, state, width,
                                  n_char)
    for a, b in zip(held[0], state):
        assert torch.equal(a, b)
    assert bool((held[2] == 0).all())
    assert torch.equal(held[3], torch.arange(width, dtype=torch.int32))
    with pytest.raises(ValueError, match="leading frames"):
        beam.beam_stream_chunk(torch.from_numpy(lp[:4]),
                               torch.tensor([True, False, True, False]),
                               state, width, n_char)


def test_greedy_stream_matches_jax():
    """Random logits in uneven chunks (a numpy array and a tensor each):
    the same ids as the JAX GreedyStream, repeats collapsed across chunk
    boundaries."""
    rng = np.random.RandomState(2)
    logits = rng.randn(60, 6).astype(np.float32)
    logits[10:14, 3] += 9.0      # a run of one id across a boundary
    port, port_t, jax_ = (streaming.GreedyStream(5),
                          streaming.GreedyStream(5),
                          jstreaming.GreedyStream(5))
    for lo, hi in ((0, 12), (12, 13), (13, 40), (40, 60)):
        port.push(logits[lo:hi])
        port_t.push(torch.from_numpy(logits[lo:hi]))
        jax_.push(logits[lo:hi])
    assert port.ids == port_t.ids == jax_.ids and len(jax_.ids) > 5


@pytest.fixture(scope="module")
def gru_uni():
    """deep_gru 2x16 unidirectional over 13 MFCCs and 5 classes."""
    return _models("deep_gru", UNI, input_dim=13, seed=7)


@pytest.mark.parametrize("decoder", ["greedy", "beam4", "beam4_lm"])
def test_recognizer_matches_jax(gru_uni, monkeypatch, decoder):
    """StreamingRecognizer (chunk_frames 16, uneven pushes) against the JAX
    one on the same weights: the same ids, greedy and by beam (with an
    LM: the same table fit by each package)."""
    monkeypatch.setenv("ASR_BEAM_SELECT", "gather")
    jm, params, pm = gru_uni
    kw = {}
    if decoder != "greedy":
        kw = dict(beam_width=4)
    jkw = dict(kw)
    if decoder == "beam4_lm":
        seqs = _beam_case()[1]
        kw.update(lm=fit_ngram_lm(seqs, 3, 5, 0), lm_alpha=0.5)
        jkw.update(lm=jax_fit_ngram_lm(seqs, 3, 5, 0), lm_alpha=0.5)
    feature = dict(d=False, dd=False)
    port = streaming.StreamingRecognizer(pm, audio.MFCC(**feature),
                                         chunk_frames=16, **kw)
    jax_ = jstreaming.StreamingRecognizer(jm, params, jaudio.MFCC(**feature),
                                          chunk_frames=16, **jkw)
    for c in _chunks(_wav(1.3, seed=4), (2500, 700, 4100)):
        port.push(c)
        jax_.push(c)
    got, want = port.finish(), jax_.finish()
    assert got == want


def test_multistream_matches_jax(gru_uni):
    """Three streams of different lengths pushed in turns, ticks between,
    one finished out of order: each stream's ids equal the JAX
    MultiStreamRecognizer's and its own StreamingRecognizer's."""
    jm, params, pm = gru_uni
    feature = dict(d=False, dd=False)
    wavs = [_wav(s, seed=i) for i, s in enumerate((1.1, 0.6, 1.5))]
    port = streaming.MultiStreamRecognizer(pm, audio.MFCC(**feature), 3,
                                           chunk_frames=16)
    jax_ = jstreaming.MultiStreamRecognizer(jm, params,
                                            jaudio.MFCC(**feature), 3,
                                            chunk_frames=16)
    step = 3000
    for lo in range(0, max(map(len, wavs)), step):
        for i, w in enumerate(wavs):
            if lo < len(w):
                port.push(i, w[lo: lo + step])
                jax_.push(i, w[lo: lo + step])
        port.tick()
        jax_.tick()
    got, want = {}, {}
    for i in (1, 0, 2):
        got[i], want[i] = port.finish(i), jax_.finish(i)
    assert got == want
    for i, w in enumerate(wavs):
        rec = streaming.StreamingRecognizer(pm, audio.MFCC(**feature),
                                            chunk_frames=16)
        rec.push(w)
        assert rec.finish() == got[i]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """A JAX run dir and the port's .npz of the same deep_gru 2x16
    unidirectional weights over the default vocabulary, two wavs, an LM."""
    d = tmp_path_factory.mktemp("stream_cli")
    parser = CharParser()
    hp = {"model": "deep_gru", "params": UNI, "num_classes": 27,
          "num_feats": 39, "vocab": parser.vocab}
    jm = jzoo.build_model("deep_gru", UNI, num_classes=27)
    state = Trainer(jm, make_optimizer()).init_state(jax.random.PRNGKey(0),
                                                     39)
    ckpt = CheckpointManager(str(d / "jax_run"))
    ckpt.save(state, hparams=hp)
    ckpt.wait()
    ckpt.close()
    meta = {"model": "deep_gru", "params": UNI, "num_feats": 39,
            "num_classes": 27, "vocab": parser.vocab, "blank_id": 27}
    npz = str(d / "uni.npz")
    np.savez(npz, __meta__=json.dumps(meta),
             **flatten_params(state.params))
    paths = []
    for i, s in enumerate((1.2, 0.7)):
        paths.append(str(d / f"u{i}.wav"))
        write_wav(paths[-1], _wav(s, seed=10 + i))
    lm = jax_fit_ngram_lm([parser(t) for t in ("ola mundo", "a casa",
                                                "mundo novo")],
                          order=3, n_char=parser.num_classes,
                          space_id=parser.char_to_id[" "],
                          vocab=parser.vocab)
    lm_path = str(d / "lm3.npz")
    lm.save(lm_path)
    return str(d / "jax_run"), npz, paths, lm_path


@pytest.mark.parametrize("extra", [[], ["--beam_width", "4", "--lm", None]],
                         ids=["greedy_multistream", "beam4_lm"])
def test_predict_stream_matches_jax_cli(cli_runs, capsys, monkeypatch,
                                        extra):
    """predict --stream --device cpu against the JAX CLI's --stream on the
    same weights: the same JSON lines (two wavs: greedy as concurrent
    streams, by beam one recognizer each)."""
    monkeypatch.setenv("ASR_BEAM_SELECT", "gather")
    jrun, npz, paths, lm_path = cli_runs
    extra = [lm_path if a is None else a for a in extra]
    common = ["--stream", "--chunk_seconds", "0.3", *extra, *paths]
    assert port_predict.main(["--weights", npz, "--device", "cpu",
                              *common]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    assert jax_predict.main(["--save", jrun, "--platform", "cpu",
                             *common]) == 0
    want = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(g) for g in got] == [json.loads(w) for w in want]
    assert [json.loads(g)["file"] for g in got] == paths


@pytest.mark.parametrize("name", CELL_MODELS, ids=["ln", "mi", "zoneout"])
def test_predict_stream_cells_match_jax_cli(cli_runs, tmp_path, capsys,
                                            name):
    """predict --stream on the layer-norm, MI and zoneout LSTMs: the JAX
    CLI's JSON lines from a JAX run of the same weights (two wavs as
    concurrent streams, then one by beam)."""
    _, _, paths, _ = cli_runs
    hp = STREAM_MODELS[name]
    parser = CharParser()
    jm = jzoo.build_model(name, hp, num_classes=27)
    state = Trainer(jm, make_optimizer()).init_state(jax.random.PRNGKey(5),
                                                     39)
    jrun = str(tmp_path / "jax_run")
    ckpt = CheckpointManager(jrun)
    ckpt.save(state, hparams={"model": name, "params": hp,
                              "num_classes": 27, "num_feats": 39,
                              "vocab": parser.vocab})
    ckpt.wait()
    ckpt.close()
    npz = str(tmp_path / "m.npz")
    np.savez(npz, __meta__=json.dumps(
        {"model": name, "params": hp, "num_feats": 39, "num_classes": 27,
         "vocab": parser.vocab, "blank_id": 27}),
        **flatten_params(state.params))
    for extra, wavs in (([], paths), (["--beam_width", "4"], paths[:1])):
        common = ["--stream", "--chunk_seconds", "0.3", *extra, *wavs]
        assert port_predict.main(["--weights", npz, "--device", "cpu",
                                  *common]) == 0
        got = capsys.readouterr().out.strip().splitlines()
        assert jax_predict.main(["--save", jrun, "--platform", "cpu",
                                 *common]) == 0
        want = capsys.readouterr().out.strip().splitlines()
        assert [json.loads(g) for g in got] == [json.loads(w) for w in want]
        assert len(got) == len(wavs)


@pytest.mark.parametrize("name,hp,match", [
    ("deep_gru", "num_hiddens=12,num_layers=1", "unidirectional"),
], ids=["bidirectional"])
def test_predict_stream_refuses_what_cannot_stream(cli_runs, tmp_path, name,
                                                   hp, match):
    _, _, paths, _ = cli_runs
    model = build_model(name, hp, num_classes=27, input_dim=39)
    meta = {"model": name, "params": hp, "num_feats": 39, "num_classes": 27}
    npz = str(tmp_path / "m.npz")
    np.savez(npz, __meta__=json.dumps(meta),
             **flat_from_params(model.state_dict()))
    with pytest.raises(SystemExit, match=match):
        port_predict.main(["--weights", npz, "--device", "cpu", "--stream",
                           *paths])

