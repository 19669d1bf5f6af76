"""Length-bucketed, padded batches (numpy copy of
``asr_study_tpu/data/generator.py`` ``Batch``, ``DatasetGenerator.flow`` and
``DatasetIterator``).

A copy because importing any ``asr_study_tpu.data`` module runs that
package's ``__init__``, which imports ``h5py``, absent on the machine with
the card.  Batch order, padding and weights are the JAX generator's for the
same seed: rows are duration-sorted into fixed buckets, the time and label
axes are rounded up to multiples, a ragged last batch is padded with
zero-weight rows that still hold a valid CTC problem, and each epoch
shuffles the bucket order with ``np.random.default_rng(seed)``.

The HDF5 and JSON-manifest sources (``flow_from_h5``, ``flow_from_json``)
come with the data layer, ROADMAP queue A item 7.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np


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
    """Makes a :class:`DatasetIterator` over in-memory rows::

        train = DatasetGenerator(batch_size=32).flow(features, labels)
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
    ):
        self.batch_size = batch_size
        self.sort_by_duration = sort_by_duration
        self.shuffle = shuffle
        self.time_multiple = time_multiple
        self.label_multiple = label_multiple
        self.min_time = min_time

    def flow(self, inputs: Sequence[np.ndarray],
             labels: Sequence[np.ndarray],
             texts: Optional[Sequence[str]] = None) -> "DatasetIterator":
        """inputs: [T_i, F] float32 rows; labels: int id rows."""
        return DatasetIterator(self, list(inputs), list(labels), texts)

    def flow_from_h5(self, *args, **kwargs) -> "DatasetIterator":
        raise NotImplementedError(
            "HDF5 datasets come with the port's data layer (ROADMAP queue A "
            "item 7)")

    def flow_from_json(self, *args, **kwargs) -> "DatasetIterator":
        raise NotImplementedError(
            "JSON-manifest datasets come with the port's data layer "
            "(ROADMAP queue A item 7)")


class DatasetIterator:
    def __init__(self, gen: DatasetGenerator, inputs: List[np.ndarray],
                 labels: List[np.ndarray], texts=None):
        if len(inputs) == 0:
            raise ValueError("empty dataset")
        if len(inputs) != len(labels):
            raise ValueError("inputs/labels length mismatch")
        self.gen = gen
        self.inputs = inputs
        self.labels = labels
        self.texts = list(texts) if texts is not None else None
        self._row_lengths = np.array([x.shape[0] for x in inputs], np.int64)
        order = np.arange(len(inputs))
        if gen.sort_by_duration:
            order = order[np.argsort(self._row_lengths, kind="stable")]
        self._batches = [
            order[i: i + gen.batch_size]
            for i in range(0, len(order), gen.batch_size)
        ]

    @property
    def num_feats(self) -> int:
        return self.inputs[0].shape[1]

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

        inputs = np.zeros((b, t, self.num_feats), dtype=np.float32)
        input_lengths = np.zeros((b,), dtype=np.int32)
        labels = np.zeros((b, l), dtype=np.int32)
        label_lengths = np.zeros((b,), dtype=np.int32)
        weights = np.zeros((b,), dtype=np.float32)
        uids = np.full((b,), -1, dtype=np.int32)
        for j, (i, tl, y) in enumerate(zip(idx, row_lens, labs)):
            inputs[j, :tl] = self.inputs[i]
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
