"""Length-bucketed, padded batches (numpy copy of
``asr_study_tpu/data/generator.py`` ``Batch``, ``DatasetGenerator`` and
``DatasetIterator``).

A copy because importing any ``asr_study_tpu.data`` module runs that
package's ``__init__``, which imports ``h5py``, absent on the machine with
the card.  Batch order, padding and weights are the JAX generator's for the
same seed: rows are duration-sorted into fixed buckets, the time and label
axes are rounded up to multiples, a ragged last batch is padded with
zero-weight rows that still hold a valid CTC problem, and each epoch
shuffles the bucket order with ``np.random.default_rng(seed)``.

``flow_from_json`` streams a JSON-lines manifest (``DatasetParser.to_json``)
and extracts each utterance's features on the host, as the JAX generator
does.  ``flow_from_h5`` reads an HDF5 split (``data/h5.py``): into memory
when its features fit in ``max_in_memory_bytes``, else a batch's rows at a
time from disk (``H5FeatureRows``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterator, List, Optional, Sequence

import numpy as np

from asr_study_torch.data.dataset_parser import (
    H5FeatureRows, read_h5, read_h5_inputs, read_h5_meta)


def _round_up(x: int, multiple: int) -> int:
    return ((max(int(x), 1) + multiple - 1) // multiple) * multiple


@dataclasses.dataclass
class Batch:
    """One padded batch of host numpy arrays."""

    inputs: np.ndarray          # [B, T, F] float32
    input_lengths: np.ndarray   # [B] int32, true frame counts
    labels: np.ndarray          # [B, L] int32, padded with 0
    label_lengths: np.ndarray   # [B] int32, true label counts
    weights: np.ndarray         # [B] float32, 0.0 for padding rows
    texts: Optional[List[str]] = None  # host-only, for eval
    uids: Optional[np.ndarray] = None  # row indices into the source split

    @property
    def size(self) -> int:
        return self.inputs.shape[0]


class DatasetGenerator:
    """Makes a :class:`DatasetIterator` over rows in memory or on disk::

        train = DatasetGenerator(batch_size=32).flow_from_h5("d.h5", "train")
        for batch in train.epoch(seed=epoch_seed):
            ...
    """

    def __init__(
        self,
        batch_size: int = 32,
        sort_by_duration: bool = True,
        shuffle: bool = True,
        time_multiple: int = 64,
        label_multiple: int = 16,
        min_time: int = 64,
        max_in_memory_bytes: int = 512 << 20,
    ):
        self.batch_size = batch_size
        self.sort_by_duration = sort_by_duration
        self.shuffle = shuffle
        self.time_multiple = time_multiple
        self.label_multiple = label_multiple
        self.min_time = min_time
        self.max_in_memory_bytes = max_in_memory_bytes

    def flow(self, inputs, labels: Sequence[np.ndarray],
             texts: Optional[Sequence[str]] = None) -> "DatasetIterator":
        """inputs: [T_i, F] float32 rows, or a lazy row source
        (:class:`H5FeatureRows`); labels: int id rows."""
        if not hasattr(inputs, "row_length"):
            inputs = list(inputs)
        return DatasetIterator(self, inputs, list(labels), texts)

    def flow_from_h5(self, h5_path: str, split: str,
                     lazy: Optional[bool] = None) -> "DatasetIterator":
        """One split of an HDF5 dataset.  ``lazy=None`` reads the split
        into memory when its features fit in ``max_in_memory_bytes`` and
        streams it a batch at a time from disk otherwise; True or False
        forces one or the other."""
        if lazy is None or lazy:
            shapes, labels, texts, _ = read_h5_meta(h5_path, split)
            nbytes = int(np.sum(shapes[:, 0].astype(np.int64)
                                * shapes[:, 1]) * 4)
            if lazy or nbytes > self.max_in_memory_bytes:
                return self.flow(H5FeatureRows(h5_path, split, shapes=shapes),
                                 labels, texts)
            return self.flow(read_h5_inputs(h5_path, split, shapes), labels,
                             texts)
        inputs, labels, texts, _ = read_h5(h5_path, split)
        return self.flow(inputs, labels, texts)

    def flow_from_json(self, json_path: str, input_parser, label_parser,
                       split: Optional[str] = None) -> "DatasetIterator":
        """Stream a JSON-lines manifest, extracting features on the host.
        ``split=None`` takes every utterance; otherwise filter by the
        manifest's ``split`` field (missing fields count as 'train').
        Transcripts ``label_parser`` rejects are skipped."""
        inputs, labels, texts = [], [], []
        with open(json_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                utt = json.loads(line)
                if split and utt.get("split", "train") != split:
                    continue
                if not label_parser.is_valid(utt["label"]):
                    continue
                inputs.append(np.ascontiguousarray(input_parser(utt["audio"]),
                                                   dtype=np.float32))
                ids = np.asarray(label_parser(utt["label"]), np.int32)
                labels.append(ids)
                texts.append(label_parser.imap(ids))
        return self.flow(inputs, labels, texts)


class DatasetIterator:
    def __init__(self, gen: DatasetGenerator, inputs,
                 labels: List[np.ndarray], texts=None):
        if len(inputs) == 0:
            raise ValueError("empty dataset")
        if len(inputs) != len(labels):
            raise ValueError("inputs/labels length mismatch")
        self.gen = gen
        self.inputs = inputs
        self.labels = labels
        self.texts = list(texts) if texts is not None else None
        self._lazy = hasattr(inputs, "row_length")
        if self._lazy:
            self._row_lengths = inputs.shapes[:, 0].astype(np.int64)
        else:
            self._row_lengths = np.array([x.shape[0] for x in inputs],
                                         np.int64)
        order = np.arange(len(inputs))
        if gen.sort_by_duration:
            order = order[np.argsort(self._row_lengths, kind="stable")]
        self._batches = [
            order[i: i + gen.batch_size]
            for i in range(0, len(order), gen.batch_size)
        ]

    @property
    def num_samples(self) -> int:
        return len(self.inputs)

    @property
    def num_feats(self) -> int:
        return (self.inputs.num_feats if self._lazy
                else self.inputs[0].shape[1])

    @property
    def steps_per_epoch(self) -> int:
        return len(self._batches)

    def _make_batch(self, idx: np.ndarray) -> Batch:
        gen = self.gen
        row_lens = [int(self._row_lengths[i]) for i in idx]
        labs = [self.labels[i] for i in idx]
        b = gen.batch_size
        t = max(gen.min_time, _round_up(max(row_lens), gen.time_multiple))
        l = _round_up(max(len(x) for x in labs), gen.label_multiple)

        input_lengths = np.zeros((b,), dtype=np.int32)
        labels = np.zeros((b, l), dtype=np.int32)
        label_lengths = np.zeros((b,), dtype=np.int32)
        weights = np.zeros((b,), dtype=np.float32)
        uids = np.full((b,), -1, dtype=np.int32)
        if self._lazy:
            # the batch's rows read from disk; pack_into defines every entry
            inputs = np.empty((b, t, self.num_feats), dtype=np.float32)
            self.inputs.pack_into(idx, inputs)
        else:
            inputs = np.zeros((b, t, self.num_feats), dtype=np.float32)
            for j, i in enumerate(idx):
                inputs[j, : row_lens[j]] = self.inputs[i]
        for j, (i, tl, y) in enumerate(zip(idx, row_lens, labs)):
            input_lengths[j] = tl
            labels[j, : len(y)] = y
            label_lengths[j] = len(y)
            weights[j] = 1.0
            uids[j] = i
        # zero-weight padding rows still need a valid CTC problem
        # (input_len >= label_len >= 1) so the masked loss stays finite
        n_real = len(idx)
        if n_real < b:
            input_lengths[n_real:] = t
            label_lengths[n_real:] = 1
        texts = (
            [self.texts[i] for i in idx] + [""] * (b - n_real)
            if self.texts is not None else None
        )
        return Batch(inputs, input_lengths, labels, label_lengths, weights,
                     texts, uids)

    def epoch(self, seed: Optional[int] = None,
              ordered: bool = False) -> Iterator[Batch]:
        """One pass; the bucket order is shuffled per epoch (fixed bucket
        composition), or ascending-duration with ``ordered=True`` (the
        SortaGrad first epoch)."""
        batches = list(self._batches)
        if self.gen.shuffle and not ordered:
            np.random.default_rng(seed).shuffle(batches)
        for idx in batches:
            yield self._make_batch(idx)

    def __iter__(self) -> Iterator[Batch]:
        return self.epoch()

    def padded_shapes(self) -> "set[tuple[int, int]]":
        """The (T, L) padded shapes this iterator's batches take."""
        gen = self.gen
        shapes = set()
        for idx in self._batches:
            t = max(gen.min_time,
                    _round_up(max(self._row_lengths[i] for i in idx),
                              gen.time_multiple))
            l = _round_up(max(len(self.labels[i]) for i in idx),
                          gen.label_multiple)
            shapes.add((t, l))
        return shapes
