"""Corpus ingestion base class and the HDF5 dataset format (port of
``asr_study_tpu/data/dataset_parser.py``, over ``data/h5.py`` in place of
h5py, which the machine with the card does not have).

Subclasses implement ``_iter()`` yielding utterance dicts ``{audio, label,
speaker, duration?, split?}``; the base class fills in missing durations
from the wav and writes the JSON-lines manifest that
``DatasetGenerator.flow_from_json`` streams, or the HDF5 dataset that
``DatasetGenerator.flow_from_h5`` streams.

HDF5 layout (one group per split: train/valid/test), as the JAX package
writes it and reads it:
    inputs     vlen float32   flattened [T*F] feature rows
    shapes     int32 [N, 2]   (T, F) per row
    labels     vlen int32     label id sequences
    texts      vlen utf-8     normalized transcripts
    durations  float32 [N]    seconds
  group attrs: num_feats, feature (its str), vocab, layout

Packed layout (``layout="packed"``): ``inputs`` is replaced by one feature
matrix, rows back to back in duration-sorted order:
    inputs_flat  float32 [sum_T, F]   (the JAX writer chunks it; this
                                       writer writes it contiguous)
    offsets      int64  [N + 1]       row i is inputs_flat[offsets[i]:
                                       offsets[i+1]]
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from asr_study_torch.data import h5
from asr_study_torch.features.wav import read_wav

log = logging.getLogger(__name__)

SPLITS = ("train", "valid", "test")


class DatasetParser:
    """Walks a corpus directory and yields utterance dicts.

    Subclasses set ``name`` and implement ``_iter()``.  An utterance dict has
    keys: ``audio`` (wav path), ``label`` (transcript string), ``speaker``
    (id string), and optionally ``duration`` (seconds) and ``split``.
    """

    name = "base"
    default_split: Optional[Callable[[dict], str]] = None

    def __init__(self, dataset_dir: str):
        self.dataset_dir = dataset_dir

    def _iter(self) -> Iterator[dict]:
        raise NotImplementedError

    @staticmethod
    def _duration(wav_path: str) -> float:
        sig, sr = read_wav(wav_path, sr=None)
        return len(sig) / float(sr)

    def iter_utterances(self, with_duration: bool = True) -> Iterator[dict]:
        for utt in self._iter():
            if with_duration and "duration" not in utt:
                try:
                    utt["duration"] = self._duration(utt["audio"])
                except Exception as exc:  # unreadable file: skip, don't die
                    log.warning("skipping %s: %s", utt.get("audio"), exc)
                    continue
            yield utt

    def to_json(self, json_path: str) -> int:
        """Write a JSON-lines manifest; returns the utterance count."""
        os.makedirs(os.path.dirname(os.path.abspath(json_path)), exist_ok=True)
        n = 0
        with open(json_path, "w") as f:
            for utt in self.iter_utterances():
                f.write(json.dumps(utt) + "\n")
                n += 1
        return n

    def to_h5(
        self,
        h5_path: str,
        input_parser,
        label_parser=None,
        split_fn: Optional[Callable[[dict], str]] = None,
        min_duration: float = 0.0,
        max_duration: float = float("inf"),
        layout: str = "vlen",
    ) -> Dict[str, int]:
        """Extract features for every utterance and write the HDF5 dataset
        -> {split: utterance count}.

        ``split_fn(utt) -> 'train'|'valid'|'test'`` assigns splits; defaults
        to the utterance's own ``split`` key, the subclass's
        ``default_split``, then 'train'."""
        from asr_study_torch.text.parser import CharParser

        label_parser = label_parser or CharParser()
        rows: Dict[str, List[dict]] = {s: [] for s in SPLITS}
        for utt in self.iter_utterances():
            dur = utt.get("duration", 0.0)
            if not (min_duration <= dur <= max_duration):
                continue
            if not label_parser.is_valid(utt["label"]):
                log.warning("invalid transcript, skipping: %r", utt["label"])
                continue
            split = utt.get("split")
            if split is None and split_fn is not None:
                split = split_fn(utt)
            if split is None and self.default_split is not None:
                split = self.default_split(utt)
            rows[split or "train"].append(utt)
        write_h5(h5_path, rows, input_parser, label_parser, layout=layout)
        return {s: len(u) for s, u in rows.items() if u}

    def __str__(self) -> str:
        return self.name


def write_split(grp: h5.GroupWriter, utts, input_parser, label_parser,
                chunk: int = 256, layout: str = "vlen") -> None:
    """Extract and write one split into ``grp``.

    A feature extractor with ``extract_batch`` (the device one,
    ``features/batch_extract.py``) goes ``chunk`` utterances at a time; a
    host one an utterance at a time.  Each chunk's rows go to disk before
    the next is extracted, so host memory holds one chunk of features;
    shapes, labels, texts and durations are kept until the split ends."""
    if layout not in ("vlen", "packed"):
        raise ValueError(f"layout must be 'vlen' or 'packed', got {layout!r}")
    if layout == "packed":
        # duration order makes the generator's stable length sort the
        # identity permutation: every batch is one contiguous read
        utts = sorted(utts, key=lambda u: float(u.get("duration", 0.0)))
    n = len(utts)
    shapes = np.zeros((n, 2), np.int32)
    durations = np.zeros((n,), np.float32)
    labels, texts = [], []
    offsets = np.zeros((n + 1,), np.int64)
    rows = flat = None
    batched = hasattr(input_parser, "extract_batch")
    step = chunk if batched else 1
    for c0 in range(0, n, step):
        group = utts[c0: c0 + step]
        if batched:
            feats_list = input_parser.extract_batch([u["audio"] for u in group])
        else:
            feats_list = [input_parser(group[0]["audio"])]
        for j, (utt, feats) in enumerate(zip(group, feats_list)):
            i = c0 + j
            feats = np.asarray(feats, np.float32)
            if layout == "packed":
                if flat is None:
                    flat = grp.stream_dataset("inputs_flat", np.float32,
                                              feats.shape[1:])
                flat.append(feats)
                offsets[i + 1] = offsets[i] + feats.shape[0]
            else:
                if rows is None:
                    rows = grp.vlen_dataset("inputs", np.float32)
                rows.append(feats.reshape(-1))
            shapes[i] = feats.shape
            text = label_parser._clean(utt["label"])
            labels.append(label_parser.map(text))
            texts.append(text)
            durations[i] = utt.get("duration", 0.0)
    if layout == "packed":
        grp.create_dataset("offsets", offsets)
    grp.create_dataset("shapes", shapes)
    d_labels = grp.vlen_dataset("labels", np.int32)
    d_texts = grp.vlen_dataset("texts")
    for lab, text in zip(labels, texts):
        d_labels.append(np.asarray(lab, np.int32))
        d_texts.append(text)
    grp.create_dataset("durations", durations)
    grp.attrs["num_feats"] = np.int64(shapes[-1, 1] if n else 0)
    grp.attrs["feature"] = str(input_parser)
    grp.attrs["vocab"] = label_parser.vocab
    grp.attrs["layout"] = layout


def write_h5(h5_path, split_rows, input_parser, label_parser,
             layout: str = "vlen") -> None:
    """Write pre-collected ``{split: [utt, ...]}`` rows."""
    with h5.Writer(h5_path) as w:
        for split, utts in split_rows.items():
            if utts:
                write_split(w.group(split), utts, input_parser, label_parser,
                            layout=layout)


def _split_group(f: h5.File, h5_path: str, split: str) -> h5.Group:
    if split not in f:
        raise KeyError(f"{h5_path} has no split {split!r}; has {list(f)}")
    return f[split]


def _read_inputs(grp: h5.Group, shapes) -> List[np.ndarray]:
    """Every feature row of a split group (either layout) as [T, F]
    float32 arrays."""
    if "inputs_flat" in grp:
        flat = grp["inputs_flat"][:]
        offs = grp["offsets"][:]
        return [flat[offs[i]: offs[i + 1]] for i in range(len(shapes))]
    return [x.reshape(tuple(s)) for x, s in zip(grp["inputs"][:], shapes)]


def _read_meta(grp: h5.Group):
    labels = [np.asarray(l, dtype=np.int32) for l in grp["labels"][:]]
    texts = list(grp["texts"][:])
    durations = grp["durations"][:]
    return labels, texts, durations


def read_h5(h5_path: str, split: str):
    """Load one split into memory -> (list of [T, F] arrays, list of [L]
    label arrays, list of str, durations [N])."""
    with h5.File(h5_path) as f:
        grp = _split_group(f, h5_path, split)
        shapes = grp["shapes"][:]
        inputs = _read_inputs(grp, shapes)
        labels, texts, durations = _read_meta(grp)
    return inputs, labels, texts, durations


def read_h5_inputs(h5_path: str, split: str, shapes) -> List[np.ndarray]:
    """Only the feature rows of a split (the metadata came from
    :func:`read_h5_meta`)."""
    with h5.File(h5_path) as f:
        return _read_inputs(_split_group(f, h5_path, split), shapes)


def read_h5_meta(h5_path: str, split: str):
    """Only the per-utterance metadata of a split -> (shapes, labels,
    texts, durations): the feature payload stays on disk."""
    with h5.File(h5_path) as f:
        grp = _split_group(f, h5_path, split)
        shapes = grp["shapes"][:]
        labels, texts, durations = _read_meta(grp)
    return shapes, labels, texts, durations


class H5FeatureRows:
    """Lazy per-row access to one split's feature rows, for splits larger
    than host memory: only the [N, 2] shapes table (and the packed
    layout's offsets) stay in memory; a batch's rows are read when it is
    packed.  Safe to share between threads (the reads are ``pread``s; the
    lock guards opening the file)."""

    def __init__(self, h5_path: str, split: str, shapes=None):
        self.h5_path = h5_path
        self.split = split
        self._offsets = None  # packed layout: int64 [N+1] frame offsets
        with h5.File(h5_path) as f:
            grp = _split_group(f, h5_path, split)
            if shapes is None:
                shapes = grp["shapes"][:]
            if "inputs_flat" in grp:
                self._offsets = grp["offsets"][:]
        self.shapes = shapes
        self._lock = threading.Lock()
        self._file = None
        self._dset = None

    def __len__(self) -> int:
        return len(self.shapes)

    def row_length(self, i: int) -> int:
        return int(self.shapes[i, 0])

    @property
    def num_feats(self) -> int:
        return int(self.shapes[0, 1]) if len(self.shapes) else 0

    @property
    def nbytes(self) -> int:
        """The feature payload (float32 bytes) if fully read."""
        return int(np.sum(self.shapes[:, 0].astype(np.int64)
                          * self.shapes[:, 1]) * 4)

    def _rows(self) -> h5.Dataset:
        with self._lock:
            if self._dset is None:
                self._file = h5.File(self.h5_path)
                self._dset = self._file[self.split][
                    "inputs_flat" if self._offsets is not None else "inputs"]
            return self._dset

    def __getitem__(self, i: int) -> np.ndarray:
        i = int(i)
        dset = self._rows()
        if self._offsets is not None:
            return dset[self._offsets[i]: self._offsets[i + 1]]
        return dset[i].reshape(tuple(self.shapes[i]))

    def _read_runs(self, idx: np.ndarray
                   ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Rows ``idx`` (any order) -> ([n, F] arrays, each row's first row
        in their concatenation).  The packed layout reads each run of
        consecutive indices in one go; the vlen layout gives an array a
        row."""
        dset = self._rows()
        starts = np.zeros(len(idx), np.int64)
        if self._offsets is None:
            f_dim = self.num_feats
            runs = [r.reshape(-1, f_dim) for r in dset.rows(idx)]
            lens = np.array([r.shape[0] for r in runs], np.int64)
            np.cumsum(lens[:-1], out=starts[1:])
            return runs, starts
        offs = self._offsets
        order = np.argsort(idx, kind="stable")
        runs = []
        base = k = 0
        while k < len(order):
            e = k
            while e + 1 < len(order) and idx[order[e + 1]] <= \
                    idx[order[e]] + 1:
                e += 1
            a, b = int(idx[order[k]]), int(idx[order[e]])
            pos = order[k: e + 1]
            runs.append(dset.read(int(offs[a]), int(offs[b + 1])))
            starts[pos] = offs[idx[pos]] - offs[a] + base
            base += runs[-1].shape[0]
            k = e + 1
        return runs, starts

    def pack_into(self, idx, out: np.ndarray) -> None:
        """Read rows ``idx`` and pack them into ``out`` [B, t_pad, F]
        (float32) with the native packer (``asr_pack_batch_full``); the
        padded tails and the rows past ``len(idx)`` are zeroed, so ``out``
        may come uninitialized.  A batch of one run of the packed layout
        (every batch of the duration-sorted generator over a file written
        in duration order) is packed straight from its one read; several
        runs, or vlen rows, are joined first, as the JAX path does."""
        from asr_study_torch.utils import native

        idx = np.asarray(idx, np.int64)
        runs, starts = self._read_runs(idx)
        if len(runs) == 1:
            src = runs[0]
        elif runs:
            src = np.concatenate(runs)
        else:
            src = np.zeros((0, out.shape[2]), np.float32)
        native.pack_batch_into(src, starts, self.shapes[idx, 0], out)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = self._dset = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
