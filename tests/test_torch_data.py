"""The port's data layer against the JAX package's on the CPU: the corpus
parsers (wav bytes, transcripts, utterance dicts and manifests), the
JSON-manifest batches and the host WER/CER."""

import json
import os

import numpy as np
import pytest

from asr_study_torch.data import corpora
from asr_study_torch.data.dataset_parser import (DatasetParser, read_h5,
                                                 write_h5)
from asr_study_torch.data.generator import DatasetGenerator
from asr_study_torch.features.audio import MFCC, LogFbank
from asr_study_torch.ops.metrics import cer, wer
from asr_study_torch.text.parser import CharParser
from asr_study_tpu.data import corpora as jcorpora
from asr_study_tpu.data.dataset_parser import read_h5 as jax_read_h5
from asr_study_tpu.data.generator import DatasetGenerator as JaxGenerator
from asr_study_tpu.features.audio import MFCC as JaxMFCC
from asr_study_tpu.features.audio import LogFbank as JaxLogFbank
from asr_study_tpu.ops.metrics import cer as jax_cer
from asr_study_tpu.ops.metrics import wer as jax_wer
from asr_study_tpu.text.parser import CharParser as JaxCharParser

BATCH_FIELDS = ("input_lengths", "labels", "label_lengths", "weights", "uids")


def _manifest_lines(path, root):
    """A manifest's utterances with the corpus directory cut from the
    audio paths."""
    out = []
    with open(path) as f:
        for line in f:
            utt = json.loads(line)
            utt["audio"] = os.path.relpath(utt["audio"], root)
            out.append(utt)
    return out


# -- the synthetic corpora ---------------------------------------------------

@pytest.mark.parametrize("name,kw", [("SynthWords", {"n": 12, "seed": 2}),
                                     ("Dummy", {"n": 6})])
def test_synthetic_corpus_bytes_and_manifest(tmp_path, name, kw):
    """The same seed writes the same wav bytes and transcripts, and the
    manifests agree line for line."""
    roots = {}
    for side, mod in (("port", corpora), ("jax", jcorpora)):
        root = str(tmp_path / side / "corpus")
        getattr(mod, name)(root, **kw).to_json(str(tmp_path / side / "m.json"))
        roots[side] = root
    files = sorted(os.listdir(roots["jax"]))
    assert sorted(os.listdir(roots["port"])) == files
    assert sum(f.endswith(".wav") for f in files) == kw["n"]
    for fname in files:
        with open(os.path.join(roots["port"], fname), "rb") as a, \
                open(os.path.join(roots["jax"], fname), "rb") as b:
            assert a.read() == b.read(), fname
    got = _manifest_lines(tmp_path / "port" / "m.json", roots["port"])
    want = _manifest_lines(tmp_path / "jax" / "m.json", roots["jax"])
    assert got == want and len(got) == kw["n"]
    assert {u["split"] for u in got} == {"train", "valid", "test"}


def test_synthwords_guards_its_directory(tmp_path):
    """An existing SynthWords dir made with other parameters is refused
    by both, with the same message; the same parameters reparse it."""
    root = str(tmp_path / "corpus")
    list(corpora.SynthWords(root, n=4, seed=1)._iter())
    errors = []
    for cls in (corpora.SynthWords, jcorpora.SynthWords):
        with pytest.raises(ValueError) as e:
            list(cls(root, n=5, seed=1)._iter())
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "n" in errors[0]
    assert list(corpora.SynthWords(root, n=4, seed=1)._iter()) == \
        list(jcorpora.SynthWords(root, n=4, seed=1)._iter())


def test_corpus_table_and_hash_split(tmp_path):
    assert corpora.corpus("SynthWords") is corpora.SynthWords
    assert sorted(corpora.CORPORA) == ["brsd", "cslu", "dummy", "lapsbm",
                                       "sid", "synthwords", "voxforge"]
    with pytest.raises(KeyError, match="available"):
        corpora.corpus("nosuch")
    for key in ("spk0", "M001", "LapsBM-F004", "anonymous", "x" * 40):
        assert corpora._hash_split(key) == jcorpora._hash_split(key)
    # to_h5 against the JAX to_h5 on one corpus
    port, jax = str(tmp_path / "p.h5"), str(tmp_path / "j.h5")
    root = str(tmp_path / "c")
    counts = corpora.Dummy(root, n=5).to_h5(port, MFCC(), CharParser())
    assert counts == jcorpora.Dummy(root, n=5).to_h5(jax, JaxMFCC(),
                                                     JaxCharParser())
    for split in counts:
        got, want = read_h5(port, split), jax_read_h5(jax, split)
        assert got[2] == want[2]
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError):
        DatasetParser("d").to_h5("d.h5", MFCC())


# -- the real-corpus layouts (the trees of tests/test_corpora_layouts.py) ----

def _wav(path, n=800):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t = np.arange(n) / 16000.0
    from asr_study_torch.features.wav import write_wav
    write_wav(path, (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32))


def _write(path, text, encoding="utf-8", newline="\n"):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(text.replace("\n", newline).encode(encoding))


def _lapsbm_standard(r):
    for spk, i in (("LapsBM-F004", 1), ("LapsBM-M001", 2)):
        _wav(f"{r}/{spk}/LapsBM_{i:04d}.wav")
        _write(f"{r}/{spk}/LapsBM_{i:04d}.txt", f"frase {i}")


def _lapsbm_nested(r):
    _wav(f"{r}/LapsBM1.4/LapsBM-F004/LapsBM_0001.wav")
    _write(f"{r}/LapsBM1.4/LapsBM-F004/LapsBM_0001.txt", "olá você")
    _wav(f"{r}/LapsBM1.4/LapsBM-F005/LapsBM_0002.wav")


def _lapsbm_crlf(r):
    for i in range(4):
        spk = f"LapsBM-M{i:03d}"
        _wav(f"{r}/{spk}/LapsBM_{i:04d}.wav")
        _write(f"{r}/{spk}/LapsBM_{i:04d}.txt", f"texto {i}\n",
               newline="\r\n")


def _voxforge_paths(r):
    name = "anonymous-20080623-lkj"
    _write(f"{r}/{name}/etc/PROMPTS",
           f"/home/x/voxforge/{name}/mfc/pt-001 bom dia\n"
           f"/home/x/voxforge/{name}/mfc/pt-002 boa noite\n")
    for i in ("pt-001", "pt-002"):
        _wav(f"{r}/{name}/wav/{i}.wav")


def _voxforge_latin1(r):
    name = "joão-20090101-xyz"
    _write(f"{r}/{name}/etc/prompts-original",
           "pt-001 não sei\npt-002 café com pão\n", encoding="latin-1",
           newline="\r\n")
    for i in ("pt-001", "pt-002"):
        _wav(f"{r}/{name}/wav/{i}.wav")


def _voxforge_messy(r):
    _write(f"{r}/spk-20100101-abc/etc/prompts.txt",
           "\npt-001 um dois tres\nsolo\npt-404 fantasma\n")
    _wav(f"{r}/spk-20100101-abc/wav/pt-001.wav")
    _write(f"{r}/README", "not a submission")


def _sid_equals(r):
    _write(f"{r}/M001/prompts.txt", "001=primeira frase\n002=segunda frase\n")
    _wav(f"{r}/M001/M001_001.wav")
    _wav(f"{r}/M001/M001_002.wav")


def _sid_latin1(r):
    _write(f"{r}/F002/PROMPTS", "001 informação pública\n",
           encoding="latin-1")
    _wav(f"{r}/F002/sid001.wav")


def _sid_unmatched(r):
    _write(f"{r}/M003/prompts.txt", "001=apenas uma\n")
    _wav(f"{r}/M003/M003_001.wav")
    _wav(f"{r}/M003/M003_099.wav")
    _wav(f"{r}/M004/M004_001.wav")


def _cslu_mirror(r):
    _wav(f"{r}/speech/g1/SPK01/utt001.wav")
    _write(f"{r}/trans/g1/SPK01/utt001.txt", "ola mundo")
    _wav(f"{r}/speech/g2/SPK02/utt002.wav")
    _write(f"{r}/trans/g2/SPK02/utt002.txt", "tudo bem")


def _cslu_sibling(r):
    _wav(f"{r}/SPK03/a.wav")
    _write(f"{r}/SPK03/a.txt", "sem espelho")


def _cslu_deep(r):
    _wav(f"{r}/speech/a/b/c/SPK04/u1.wav")
    _write(f"{r}/trans/a/b/c/SPK04/u1.txt", "oração final",
           encoding="latin-1")
    _wav(f"{r}/speech/a/b/c/SPK04/u2.wav")


def _brsd(r):
    _lapsbm_standard(f"{r}/lapsbm")
    _voxforge_paths(f"{r}/voxforge")
    _sid_equals(f"{r}/sid")
    _cslu_mirror(f"{r}/cslu")


@pytest.mark.parametrize("name,kw,tree", [
    ("LapsBM", {}, _lapsbm_standard),
    ("LapsBM", {}, _lapsbm_nested),
    ("LapsBM", {"split": "by_speaker"}, _lapsbm_crlf),
    ("VoxForge", {}, _voxforge_paths),
    ("VoxForge", {}, _voxforge_latin1),
    ("VoxForge", {}, _voxforge_messy),
    ("Sid", {}, _sid_equals),
    ("Sid", {}, _sid_latin1),
    ("Sid", {}, _sid_unmatched),
    ("CSLU", {}, _cslu_mirror),
    ("CSLU", {}, _cslu_sibling),
    ("CSLU", {}, _cslu_deep),
    ("BRSD", {}, _brsd),
], ids=lambda v: getattr(v, "__name__", None))
def test_corpus_layouts_match_jax(tmp_path, name, kw, tree):
    """The same utterance dicts, in the same order, durations included."""
    root = str(tmp_path / "root")
    tree(root)
    got = list(getattr(corpora, name)(root, **kw).iter_utterances())
    want = list(getattr(jcorpora, name)(root, **kw).iter_utterances())
    assert got == want and len(got) >= 1


# -- JSON-manifest batches ---------------------------------------------------

@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    d = tmp_path_factory.mktemp("manifest")
    path = str(d / "m.json")
    corpora.SynthWords(str(d / "corpus"), n=20, seed=3).to_json(path)
    return path


@pytest.mark.parametrize("split,feature", [
    ("train", "mfcc"), ("valid", "mfcc"), (None, "logfbank")])
def test_flow_from_json_matches_jax(manifest, split, feature):
    """Per seed, the same batches in the same order: features within 1e-5,
    everything else exactly."""
    port_feat, jax_feat = (
        (MFCC(), JaxMFCC()) if feature == "mfcc"
        else (LogFbank(d=True), JaxLogFbank(d=True)))
    port = DatasetGenerator(batch_size=4).flow_from_json(
        manifest, port_feat, CharParser(), split=split)
    ref = JaxGenerator(batch_size=4).flow_from_json(
        manifest, jax_feat, JaxCharParser(), split=split)
    assert port.num_samples == ref.num_samples
    assert port.num_feats == ref.num_feats
    assert port.steps_per_epoch == ref.steps_per_epoch
    assert port.padded_shapes() == ref.padded_shapes()
    for seed, ordered in ((0, False), (7, False), (None, True)):
        got = list(port.epoch(seed=seed, ordered=ordered))
        want = list(ref.epoch(seed=seed, ordered=ordered))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.inputs.shape == w.inputs.shape
            np.testing.assert_allclose(g.inputs, w.inputs, rtol=0, atol=1e-5)
            for field in BATCH_FIELDS:
                a, b = getattr(g, field), getattr(w, field)
                assert a.dtype == b.dtype, field
                np.testing.assert_array_equal(a, b, err_msg=field)
            assert g.texts == w.texts


def test_flow_from_json_empty_split_and_hdf5(manifest, tmp_path):
    gen = DatasetGenerator(batch_size=4)
    with pytest.raises(ValueError, match="empty dataset"):
        gen.flow_from_json(manifest, MFCC(), CharParser(), split="nosuch")
    # the manifest's valid split written to HDF5 and read back: the
    # batches flow_from_json makes of it, and a missing split refused
    with open(manifest) as f:
        utts = [u for u in map(json.loads, f) if u["split"] == "valid"]
    path = str(tmp_path / "valid.h5")
    write_h5(path, {"valid": utts}, MFCC(), CharParser())
    got = list(gen.flow_from_h5(path, "valid").epoch(seed=1))
    want = list(gen.flow_from_json(manifest, MFCC(), CharParser(),
                                   split="valid").epoch(seed=1))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for field in ("inputs",) + BATCH_FIELDS:
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(w, field), err_msg=field)
        assert g.texts == w.texts
    with pytest.raises(KeyError, match="no split 'train'"):
        gen.flow_from_h5(path, "train")


# -- WER / CER ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wer_cer_match_jax(seed):
    rng = np.random.RandomState(seed)
    words = ["a", "de", "casa", "sol", "mar", "verde"]

    def sentence():
        return " ".join(rng.choice(words, rng.randint(0, 7)))

    hyps = [sentence() for _ in range(30)]
    refs = [sentence() for _ in range(30)]
    refs[0] = ""                      # an empty reference
    hyps[1] = ""
    assert wer(hyps, refs) == jax_wer(hyps, refs)
    assert cer(hyps, refs) == jax_cer(hyps, refs)
    assert wer([""], [""]) == jax_wer([""], [""]) == 0.0
    assert cer(["ab"], [""]) == jax_cer(["ab"], [""]) == 2.0
