"""Corpus ingestion base class (copy of
``asr_study_tpu/data/dataset_parser.py`` ``SPLITS`` and ``DatasetParser``
without the HDF5 writer and readers).

Subclasses implement ``_iter()`` yielding utterance dicts ``{audio, label,
speaker, duration?, split?}``; the base class fills in missing durations
from the wav and writes the JSON-lines manifest that
``DatasetGenerator.flow_from_json`` streams.  The HDF5 dataset
(``to_h5``) is ROADMAP queue A item 7's HDF5 part: the machine with the
card has no ``h5py``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Iterator, Optional

from asr_study_torch.features.wav import read_wav

log = logging.getLogger(__name__)

SPLITS = ("train", "valid", "test")

HDF5_ITEM = ("HDF5 datasets are not ported to asr_study_torch yet (ROADMAP "
             "queue A item 7, HDF5); write a JSON-lines manifest with "
             "--to_json and train from it")


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

    def to_h5(self, *args, **kwargs):
        raise NotImplementedError(HDF5_ITEM)

    def __str__(self) -> str:
        return self.name
