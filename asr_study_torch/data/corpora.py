"""Corpus parsers (copy of ``asr_study_tpu/data/corpora.py``): LapsBM,
VoxForge, Sid, CSLU Spoltech, the BRSD combination, and the synthetic
SynthWords and Dummy corpora.

The JAX package registers each parser with ``@register("corpus")``; here
the module-level ``CORPORA`` dict maps the same names to the classes.  The
synthetic corpora write their wavs through the port's ``write_wav``, byte
for byte what the JAX package writes for the same seed.

Directory layouts follow the public corpus distributions as described in the
reference [ref: datasets/lapsbm.py, datasets/voxforge.py, datasets/sid.py,
datasets/cslu.py, datasets/brsd.py]; parsers are written tolerantly (transcript
file variants, nested dirs) since layouts drift between corpus versions.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import sys
from typing import Dict, Iterator, List

import numpy as np

from asr_study_torch.data.dataset_parser import DatasetParser
from asr_study_torch.features.wav import write_wav


def _hash_split(key: str, valid_frac: float = 0.05, test_frac: float = 0.05) -> str:
    """Deterministic speaker-level split by hash."""
    h = int(hashlib.md5(key.encode()).hexdigest(), 16) % 1000 / 1000.0
    if h < test_frac:
        return "test"
    if h < test_frac + valid_frac:
        return "valid"
    return "train"


def _guard_generated_dir(dataset_dir: str, manifest: dict, n: int,
                         cls_name: str) -> None:
    """An existing generated-corpus dir must match the constructor's
    parameters — silently reusing wavs generated with another n/seed
    would make --corpus_params changes no-ops.  Dirs from
    before the manifest existed are adopted when their wav count matches
    n (the seed can't be verified after the fact; the manifest they
    lacked gets written), and rejected otherwise with a message naming
    the real problem."""
    mpath = os.path.join(dataset_dir, "_manifest.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            have = json.load(f)
        if have != manifest:
            raise ValueError(
                f"{cls_name} dir {dataset_dir!r} holds a corpus "
                f"generated with {have} but the parser was built with "
                f"{manifest}; point at a fresh directory or match the "
                "parameters"
            )
    else:
        n_wav = sum(1 for f in os.listdir(dataset_dir)
                    if f.endswith(".wav"))
        if n_wav != n:
            raise ValueError(
                f"{cls_name} dir {dataset_dir!r} has no _manifest.json "
                f"and holds {n_wav} wavs but the parser was built with "
                f"n={n}; point at a fresh directory or match the "
                "parameters"
            )
        with open(mpath, "w") as f:
            json.dump(manifest, f)


def _read_decoded(path: str) -> str:
    """Read a transcript/prompt file, tolerating the encodings found in
    the real corpus distributions: UTF-8 first, ISO-8859-1 (Latin-1)
    fallback — VoxForge/Sid PT-BR prompt files are frequently Latin-1,
    and a replacement-char decode would silently fail ``is_valid`` and
    DROP the utterance at dataset build."""
    with open(path, "rb") as f:
        raw = f.read()
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError:
        return raw.decode("latin-1")


def _read_text(path: str) -> str:
    return _read_decoded(path).strip()


def _read_lines(path: str):
    return _read_decoded(path).splitlines()


class LapsBM(DatasetParser):
    """LapsBM 1.4 (UFPA FalaBrasil): ~700 utterances, 35 speakers; the
    benchmark corpus (BASELINE metric: RTF on LapsBM) [ref: datasets/lapsbm.py].

    Layout: ``<root>/LapsBM-F004/LapsBM_0001.wav`` + same-basename ``.txt``.
    Speaker = subdirectory name.  ``split`` selects the standalone behaviour:
    'test' (reference BRSD role: LapsBM is the held-out test set) or
    'by_speaker' (hash speakers into train/valid/test).
    """

    name = "lapsbm"

    def __init__(self, dataset_dir: str, split: str = "test"):
        super().__init__(dataset_dir)
        self.split = split

    def _iter(self) -> Iterator[dict]:
        for root, _dirs, files in sorted(os.walk(self.dataset_dir)):
            speaker = os.path.basename(root)
            for fname in sorted(files):
                if not fname.lower().endswith(".wav"):
                    continue
                wav = os.path.join(root, fname)
                txt = os.path.splitext(wav)[0] + ".txt"
                if not os.path.exists(txt):
                    continue
                split = (
                    _hash_split(speaker) if self.split == "by_speaker" else self.split
                )
                yield {
                    "audio": wav,
                    "label": _read_text(txt),
                    "speaker": speaker,
                    "split": split,
                }


class VoxForge(DatasetParser):
    """Brazilian-Portuguese VoxForge submissions [ref: datasets/voxforge.py].

    Layout: ``<root>/<submission>/etc/PROMPTS`` (or ``prompts-original``) with
    lines ``<path-or-id> <transcript...>``; audio at
    ``<submission>/wav/<id>.wav``.  Speaker = submission prefix before the
    first '-'.
    """

    name = "voxforge"

    def _iter(self) -> Iterator[dict]:
        for sub in sorted(os.listdir(self.dataset_dir)):
            sub_dir = os.path.join(self.dataset_dir, sub)
            if not os.path.isdir(sub_dir):
                continue
            prompts = None
            for cand in ("PROMPTS", "prompts-original", "prompts.txt", "PROMPTS.txt"):
                p = os.path.join(sub_dir, "etc", cand)
                if os.path.exists(p):
                    prompts = p
                    break
            if prompts is None:
                continue
            speaker = sub.split("-")[0]
            for line in _read_lines(prompts):
                parts = line.strip().split(None, 1)
                if len(parts) != 2:
                    continue
                utt_id = parts[0].rsplit("/", 1)[-1]
                wav = os.path.join(sub_dir, "wav", utt_id + ".wav")
                if not os.path.exists(wav):
                    continue
                yield {
                    "audio": wav,
                    "label": parts[1],
                    "speaker": speaker,
                    "split": "train",
                }


class Sid(DatasetParser):
    """Sid PT-BR corpus [ref: datasets/sid.py].

    Layout: per-speaker directories containing ``*.wav`` plus a prompt file
    (``prompts.txt``/``PROMPTS``) with lines ``<idx>=<text>`` or
    ``<idx> <text>``; wavs are matched by their trailing utterance number.
    """

    name = "sid"
    _IDX_RE = re.compile(r"(\d+)\s*[=:\s]\s*(.+)")

    def _iter(self) -> Iterator[dict]:
        for spk in sorted(os.listdir(self.dataset_dir)):
            spk_dir = os.path.join(self.dataset_dir, spk)
            if not os.path.isdir(spk_dir):
                continue
            prompts: Dict[int, str] = {}
            for cand in ("prompts.txt", "PROMPTS", "prompts"):
                p = os.path.join(spk_dir, cand)
                if os.path.exists(p):
                    for line in _read_lines(p):
                        m = self._IDX_RE.match(line.strip())
                        if m:
                            prompts[int(m.group(1))] = m.group(2)
                    break
            for fname in sorted(os.listdir(spk_dir)):
                if not fname.lower().endswith(".wav"):
                    continue
                m = re.search(r"(\d+)\.wav$", fname, re.IGNORECASE)
                if not m or int(m.group(1)) not in prompts:
                    continue
                yield {
                    "audio": os.path.join(spk_dir, fname),
                    "label": prompts[int(m.group(1))],
                    "speaker": spk,
                    "split": _hash_split(spk),
                }


class CSLU(DatasetParser):
    """CSLU Spoltech Port (LDC2006S16) PT-BR corpus [ref: datasets/cslu.py].

    Layout: ``speech/**/<utt>.wav`` with the transcript at the parallel
    ``trans/**/<utt>.txt`` path (or a sibling ``.txt``).
    """

    name = "cslu"

    def _iter(self) -> Iterator[dict]:
        speech_root = os.path.join(self.dataset_dir, "speech")
        walk_root = speech_root if os.path.isdir(speech_root) else self.dataset_dir
        for root, _dirs, files in sorted(os.walk(walk_root)):
            for fname in sorted(files):
                if not fname.lower().endswith(".wav"):
                    continue
                wav = os.path.join(root, fname)
                txt = os.path.splitext(wav)[0] + ".txt"
                if not os.path.exists(txt) and os.path.isdir(speech_root):
                    txt = os.path.splitext(
                        wav.replace(os.sep + "speech" + os.sep, os.sep + "trans" + os.sep)
                    )[0] + ".txt"
                if not os.path.exists(txt):
                    continue
                speaker = os.path.basename(root)
                yield {
                    "audio": wav,
                    "label": _read_text(txt),
                    "speaker": speaker,
                    "split": _hash_split(speaker),
                }


class BRSD(DatasetParser):
    """Brazilian Speech Dataset: the reference's combined training corpus
    [ref: datasets/brsd.py] — VoxForge + Sid + CSLU for train/valid, LapsBM
    as the held-out test set.

    ``dataset_dir`` is a root containing subdirectories named ``lapsbm``,
    ``voxforge``, ``sid``, ``cslu`` (any subset; missing ones are skipped).
    """

    name = "brsd"
    _PARTS = {"voxforge": VoxForge, "sid": Sid, "cslu": CSLU}

    def _iter(self) -> Iterator[dict]:
        laps_dir = os.path.join(self.dataset_dir, "lapsbm")
        if os.path.isdir(laps_dir):
            yield from LapsBM(laps_dir, split="test")._iter()
        for name, cls in self._PARTS.items():
            part_dir = os.path.join(self.dataset_dir, name)
            if os.path.isdir(part_dir):
                for utt in cls(part_dir)._iter():
                    # LapsBM owns 'test'; everything else trains/validates
                    if utt["split"] == "test":
                        utt["split"] = "valid"
                    yield utt


class SynthWords(DatasetParser):
    """Structured synthetic corpus whose val/test splits SHARE the train
    distribution — unlike ``Dummy``'s random-word transcripts (where val
    diverges by construction), this makes held-out generalization
    measurable: val CER can decrease, beam search can beat greedy, an LM
    trained on the train transcripts carries real information, and
    augmentation can narrow the train/val gap.  Beyond-reference
    component; the reference's equivalent evidence comes from real
    corpora [ref: eval.py].

    Construction (deterministic per seed):
    - transcripts: words drawn Zipf-weighted from a fixed 40-word PT-BR
      list, 3-8 words per utterance.  Splits are by utterance index
      (8:1:1 round-robin), so train/valid/test share words and word
      frequencies but not word sequences.
    - audio: each CHARACTER has a fixed acoustic signature (a ~90 ms
      two-harmonic tone complex at a character-specific f0, with a short
      amplitude ramp against clicks); words are their characters back to
      back, separated by ~60 ms silences (the acoustic cue for the space
      label).  CTC can therefore learn character-level alignments that
      transfer to unseen word orders.
    - per-utterance nuisance variation (speaker pitch factor, gain, white
      noise at 8-20 dB SNR) keeps the task imperfect so decoder/LM/
      augmentation effects are visible above a 0% error floor.
    """

    name = "synthwords"
    _WORDS = (
        "a de que o para com uma casa bola gato agua terra fogo vento "
        "sol lua mar rio dia noite fala mundo brasil teste peixe verde "
        "azul forte livro porta janela cidade campo norte sul leste "
        "oeste tempo vida som"
    ).split()

    def __init__(self, dataset_dir: str, n: int = 400, seed: int = 0,
                 sr: int = 16000):
        super().__init__(dataset_dir)
        self.n = int(n)
        self.seed = int(seed)
        self.sr = int(sr)

    _CHAR_MS = 90.0
    _GAP_MS = 60.0

    def _char_wave(self, ch: str, pitch: float) -> np.ndarray:
        n = int(self.sr * self._CHAR_MS / 1000.0)
        idx = ord(ch) - ord("a")
        f0 = (140.0 + 34.0 * idx) * pitch
        t = np.arange(n) / self.sr
        sig = np.sin(2 * np.pi * f0 * t) + 0.5 * np.sin(
            2 * np.pi * 2.0 * f0 * t + 0.7 * idx
        )
        ramp = min(int(0.005 * self.sr), n // 4)
        env = np.ones(n)
        env[:ramp] = np.linspace(0.0, 1.0, ramp)
        env[-ramp:] = np.linspace(1.0, 0.0, ramp)
        return sig * env

    def _synth(self, text: str, rng: np.random.Generator) -> np.ndarray:
        pitch = float(rng.uniform(0.9, 1.1))
        gain = float(rng.uniform(0.3, 0.7))
        snr_db = float(rng.uniform(8.0, 20.0))
        gap = np.zeros(int(self.sr * self._GAP_MS / 1000.0))
        parts = [gap]
        for word in text.split():
            for ch in word:
                parts.append(self._char_wave(ch, pitch))
            parts.append(gap)
        sig = np.concatenate(parts)
        sig = sig / max(1.0, np.abs(sig).max() * 1.05) * gain
        rms = float(np.sqrt(np.mean(sig**2)) + 1e-12)
        noise_rms = rms / (10.0 ** (snr_db / 20.0))
        sig = sig + noise_rms * rng.standard_normal(len(sig))
        return np.clip(sig, -1.0, 1.0).astype(np.float32)

    def _sample_text(self, rng: np.random.Generator) -> str:
        ranks = np.arange(1, len(self._WORDS) + 1, dtype=np.float64)
        p = 1.0 / ranks
        p /= p.sum()
        n_words = int(rng.integers(3, 9))
        return " ".join(rng.choice(self._WORDS, size=n_words, p=p))

    def _manifest(self) -> dict:
        return {"n": self.n, "seed": self.seed, "sr": self.sr}

    def generate(self) -> "List[dict]":
        os.makedirs(self.dataset_dir, exist_ok=True)
        utts = []
        splits = ("train",) * 8 + ("valid",) + ("test",)
        for i in range(self.n):
            # one independent stream per utterance: corpora of different
            # sizes share every prefix (a 400-utt corpus is the first 400
            # of a 4000-utt one)
            rng = np.random.default_rng((self.seed, i))
            text = self._sample_text(rng)
            sig = self._synth(text, rng)
            wav = os.path.join(self.dataset_dir, f"synth_{i:05d}.wav")
            write_wav(wav, sig, self.sr)
            with open(os.path.splitext(wav)[0] + ".txt", "w") as f:
                f.write(text)
            utts.append({
                "audio": wav,
                "label": text,
                "speaker": f"spk{i % 16}",
                "split": splits[i % len(splits)],
                "duration": len(sig) / self.sr,
            })
        with open(os.path.join(self.dataset_dir, "_manifest.json"),
                  "w") as f:
            json.dump(self._manifest(), f)
        return utts

    def _iter(self) -> Iterator[dict]:
        if not os.path.isdir(self.dataset_dir) or not any(
            f.endswith(".wav") for f in os.listdir(self.dataset_dir)
        ):
            self.generate()
        else:
            _guard_generated_dir(self.dataset_dir, self._manifest(),
                                 self.n, "SynthWords")
        files = sorted(
            f for f in os.listdir(self.dataset_dir) if f.endswith(".wav")
        )
        splits = ("train",) * 8 + ("valid",) + ("test",)
        for i, fname in enumerate(files):
            wav = os.path.join(self.dataset_dir, fname)
            yield {
                "audio": wav,
                "label": _read_text(os.path.splitext(wav)[0] + ".txt"),
                "speaker": f"spk{i % 16}",
                "split": splits[i % len(splits)],
            }


class Dummy(DatasetParser):
    """Synthetic miniature corpus for smoke-testing the full pipeline without
    real data [ref: datasets/dummy.py].

    ``generate()`` writes ``n`` short sine-mixture wavs (deterministic per
    seed) whose transcripts come from a small PT-BR word list; utterances are
    assigned round-robin to train/valid/test.
    """

    name = "dummy"
    _WORDS = (
        "ola mundo fala brasil teste um dois tres quatro casa bola gato "
        "dia noite agua terra fogo vento sol lua mar rio"
    ).split()

    def __init__(self, dataset_dir: str, n: int = 16, seed: int = 0, sr: int = 16000):
        super().__init__(dataset_dir)
        self.n = n
        self.seed = seed
        self.sr = sr

    def generate(self) -> "List[dict]":
        os.makedirs(self.dataset_dir, exist_ok=True)
        rng = np.random.default_rng(self.seed)
        utts = []
        splits = ("train",) * 3 + ("valid",) + ("test",)
        for i in range(self.n):
            n_words = int(rng.integers(2, 5))
            text = " ".join(rng.choice(self._WORDS, size=n_words))
            dur = 0.3 + 0.1 * n_words
            t = np.arange(int(self.sr * dur)) / self.sr
            sig = np.zeros_like(t, dtype=np.float64)
            for f in rng.uniform(80, 4000, size=4):
                sig += rng.uniform(0.05, 0.2) * np.sin(2 * np.pi * f * t)
            sig += 0.01 * rng.standard_normal(len(t))
            sig /= max(1.0, np.abs(sig).max() * 1.1)
            wav = os.path.join(self.dataset_dir, f"dummy_{i:04d}.wav")
            write_wav(wav, sig.astype(np.float32), self.sr)
            with open(os.path.splitext(wav)[0] + ".txt", "w") as f:
                f.write(text)
            utts.append(
                {
                    "audio": wav,
                    "label": text,
                    "speaker": f"spk{i % 4}",
                    "split": splits[i % len(splits)],
                    "duration": dur,
                }
            )
        return utts

    def _iter(self) -> Iterator[dict]:
        if not os.path.isdir(self.dataset_dir) or not any(
            f.endswith(".wav") for f in os.listdir(self.dataset_dir)
        ):
            self.generate()
        else:
            # an existing dir is parsed as-is — the smoke corpus' contract
            # is "generate once, optionally hand-edit, reparse" (several
            # CLI round-trip tests edit transcripts in place), so unlike
            # SynthWords (strict: experiment results depend on n/seed)
            # a size mismatch only WARNS that the generation params were
            # ignored rather than rejecting the directory
            n_wav = sum(1 for f in os.listdir(self.dataset_dir)
                        if f.endswith(".wav"))
            if n_wav != self.n:
                print(
                    f"Dummy: parsing existing {self.dataset_dir!r} with "
                    f"{n_wav} wavs (constructor n={self.n} applies only "
                    "when generating)",
                    file=sys.stderr,
                )
        files = sorted(
            f for f in os.listdir(self.dataset_dir) if f.endswith(".wav")
        )
        splits = ("train",) * 3 + ("valid",) + ("test",)
        for i, fname in enumerate(files):
            wav = os.path.join(self.dataset_dir, fname)
            yield {
                "audio": wav,
                "label": _read_text(os.path.splitext(wav)[0] + ".txt"),
                "speaker": f"spk{i % 4}",
                "split": splits[i % len(splits)],
            }


CORPORA = {cls.name: cls for cls in (LapsBM, VoxForge, Sid, CSLU, BRSD,
                                     SynthWords, Dummy)}


def corpus(name: str):
    """The parser class registered under ``name`` (``--parser``)."""
    try:
        return CORPORA[name.lower()]
    except KeyError:
        raise KeyError(f"unknown corpus {name!r}; available: "
                       f"{', '.join(sorted(CORPORA))}") from None
