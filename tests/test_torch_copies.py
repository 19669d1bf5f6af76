"""The port's copies of the JAX package's host modules (features/audio.py,
features/wav.py, text/parser.py, utils/hparams.py, utils/metrics_writer.py)
give what their originals give on the same inputs."""

import csv
import os

import numpy as np
import pytest
from scipy.signal import resample_poly as scipy_resample_poly

from asr_study_torch.features import audio, wav
from asr_study_torch.text.parser import CharParser
from asr_study_torch.utils.hparams import HParams
from asr_study_torch.utils.metrics_writer import MetricWriter
from asr_study_tpu.features import audio as jaudio
from asr_study_tpu.features import wav as jwav
from asr_study_tpu.text.parser import CharParser as JaxCharParser
from asr_study_tpu.utils.hparams import HParams as JaxHParams
from asr_study_tpu.utils.metrics_writer import MetricWriter as JaxMetricWriter


@pytest.fixture(scope="module")
def seeded_wav(tmp_path_factory):
    rng = np.random.RandomState(0)
    n = 23000
    t = np.arange(n) / 16000.0
    sig = 0.4 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.randn(n)
    path = str(tmp_path_factory.mktemp("copies") / "utt.wav")
    jwav.write_wav(path, sig)
    return path


@pytest.mark.parametrize("kind", ["MFCC", "LogFbank", "FBank"])
def test_features_equal_the_original(seeded_wav, kind):
    """The wav as both read_wavs decode it, and its features from both
    classes, bit for bit."""
    sig, sr = wav.read_wav(seeded_wav)
    jsig, jsr = jwav.read_wav(seeded_wav)
    assert sr == jsr == 16000
    np.testing.assert_array_equal(sig, jsig)
    got = getattr(audio, kind)()(sig)
    want = getattr(jaudio, kind)()(jsig)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_feature_helpers_equal_the_original():
    """The helpers the device featurizer builds its tables from."""
    assert audio.EPS == jaudio.EPS
    assert audio.num_frames(16000, 400, 160) == jaudio.num_frames(16000, 400,
                                                                  160)
    assert audio.num_frames(16000, 400, 160, center=True) == \
        jaudio.num_frames(16000, 400, 160, center=True)
    for conv in ("reference", "librosa"):
        htk, window, _, construction, norm = audio.resolve_convention(conv)
        assert (htk, window, _, construction, norm) == \
            jaudio.resolve_convention(conv)
        np.testing.assert_array_equal(audio.get_window(window)(400),
                                      jaudio.get_window(window)(400))
        kw = dict(htk=htk, construction=construction, norm=norm)
        np.testing.assert_array_equal(
            audio.mel_filterbank(40, 512, 16000, **kw),
            jaudio.mel_filterbank(40, 512, 16000, **kw))
    np.testing.assert_array_equal(audio.dct2_ortho_matrix(40, 13),
                                  jaudio.dct2_ortho_matrix(40, 13))
    x = np.random.RandomState(1).randn(30, 13).astype(np.float32)
    np.testing.assert_array_equal(audio.delta(x, 2), jaudio.delta(x, 2))


@pytest.mark.parametrize("file_sr", [8000, 22050, 44100])
def test_resampled_read_matches_scipy(tmp_path, file_sr):
    """A wav at another rate: the copy's numpy polyphase resampler against
    scipy.signal.resample_poly, which the original calls."""
    rng = np.random.RandomState(file_sr)
    sig = 0.3 * rng.randn(file_sr // 3)
    path = str(tmp_path / "other_rate.wav")
    wav.write_wav(path, sig, sr=file_sr)
    got, sr = wav.read_wav(path)
    raw, raw_sr = wav.read_wav(path, sr=None)
    assert (sr, raw_sr) == (16000, file_sr)
    g = np.gcd(16000, file_sr)
    want = scipy_resample_poly(raw, 16000 // g, file_sr // g)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_char_parser_round_trip_equals_the_original():
    sentence = "Olá, mundo! Ação é ótima"
    p, jp = CharParser(), JaxCharParser()
    assert p.vocab == jp.vocab
    ids = p.map(sentence)
    assert list(ids) == list(jp.map(sentence))
    assert p.imap(ids) == jp.imap(ids) == "ola mundo acao e otima"


def test_hparams_parse_equals_the_original():
    defaults = dict(num_hiddens=256, num_layers=3, bidirectional=True,
                    dropout=0.2, cell="gru")
    for spec in ("num_hiddens=12,bidirectional=false,dropout=0",
                 '{"num_layers": 5, "cell": "lstm"}', None):
        got = HParams(**defaults).parse(spec)
        want = JaxHParams(**defaults).parse(spec)
        assert {k: getattr(got, k) for k in defaults} == {
            k: getattr(want, k) for k in defaults}
    assert HParams(num_layers=3).parse("num_layers=2").num_layers == 2


def test_metric_writer_csv_equals_the_original(tmp_path):
    """The same rows through both writers, a widening header included; the
    wall-clock column aside, the CSVs are equal."""
    rows = []
    for name, cls in (("port", MetricWriter), ("jax", JaxMetricWriter)):
        d = str(tmp_path / name)
        w = cls(d, name="train")
        w.write(1, {"loss": 2.5})
        w.write(2, {"loss": 2.0, "val_ler": 0.75})
        w.close()
        with open(os.path.join(d, "train_metrics.csv"), newline="") as f:
            rows.append([{k: v for k, v in r.items() if k != "wall_s"}
                         for r in csv.DictReader(f)])
    assert rows[0] == rows[1]
    assert rows[0][1] == {"step": "2", "loss": "2.0", "val_ler": "0.75"}
