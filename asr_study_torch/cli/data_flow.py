"""Shared CLI helpers (port of ``asr_study_tpu/cli/data_flow.py``): resolve
``--dataset`` into a DatasetIterator, reconstruct the vocabulary of a
dataset or run, pick the torch device, build the host feature extractor
and the in-step device featurizer.

Both on-disk formats of the data layer: HDF5 datasets (``make_dataset
--output``, read by ``data/h5.py``) and JSON-lines manifests
(``DatasetParser.to_json``) with the features extracted on the host.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from asr_study_torch.data import h5
from asr_study_torch.data.generator import DatasetGenerator, DatasetIterator
from asr_study_torch.features.audio import FEATURES
from asr_study_torch.features.select import featurizer
from asr_study_torch.text.parser import CharParser, resolve_vocab


def is_manifest(dataset: str) -> bool:
    return dataset.endswith(".json") or dataset.endswith(".jsonl")


def resolve_device(name: str) -> torch.device:
    """``--device`` -> torch.device; a CUDA device needs CUDA (no quiet
    fall back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: torch.cuda.is_available() is "
                         "false; pass --device cpu to run on the CPU")
    return device


def data_parallel_devices(num_devices: int, device: str, batch_size: int,
                          what: str, tp_devices: int = 1) -> list[str]:
    """``--num_devices N`` (x ``--tp_devices M``) -> the devices of its N * M
    ranks (``cuda:0`` to ``cuda:N*M-1``; N * M times ``cpu``), or [] for
    one device (N of 0 or 1, M of 1), checked as the JAX CLIs check their
    mesh and with their messages (``what`` opens the device count's):
    never more ranks than cards, and a batch the N data ranks split
    evenly."""
    n = max(1, num_devices)
    ranks = n * max(1, tp_devices)
    if ranks == 1:
        return []
    if torch.device(device).type == "cuda":
        avail = torch.cuda.device_count()
        if ranks > avail:
            raise SystemExit(f"{what} but only {avail} device(s) available")
        devices = [f"cuda:{i}" for i in range(ranks)]
    else:
        devices = ["cpu"] * ranks
    if batch_size % n:
        raise SystemExit(f"--batch_size {batch_size} not divisible by {n} "
                         "devices")
    return devices


def dataset_vocab(dataset: str) -> Optional[str]:
    """The vocabulary an HDF5 dataset was built with (the first split
    group's ``vocab`` attribute, in name order); None for a manifest or a
    dataset without the attribute."""
    if is_manifest(dataset):
        return None
    with h5.File(dataset) as f:
        for split in f:
            v = f[split].attrs.get("vocab")
            if v is not None:
                return v if isinstance(v, str) else v.decode()
    return None


def parser_for_training(dataset: str, vocab_arg: Optional[str] = None
                        ) -> CharParser:
    """Label parser for a training run: an HDF5 dataset's stored
    vocabulary (its label ids were minted with it); an explicit
    ``--vocab`` must match it.  A manifest stores none: ``--vocab`` if
    given, else the default."""
    stored = dataset_vocab(dataset)
    if vocab_arg:
        requested = resolve_vocab(vocab_arg)
        if stored is not None and requested != stored:
            raise SystemExit(
                f"--vocab {vocab_arg!r} resolves to {requested!r} but the "
                f"dataset was built with {stored!r}; rebuild the dataset "
                "or drop --vocab (the stored vocabulary is used "
                "automatically)")
        return CharParser(requested)
    return CharParser(stored) if stored is not None else CharParser()


def parser_from_run(save_dir: str, dataset: Optional[str] = None
                    ) -> CharParser:
    """Label parser for eval: the run's recorded vocabulary (meta.json
    hparams), else the dataset's stored one, else the default."""
    meta_path = os.path.join(save_dir, "meta.json")
    vocab = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            vocab = json.load(f).get("hparams", {}).get("vocab")
    if vocab is None and dataset:
        vocab = dataset_vocab(dataset)
    return CharParser(vocab) if vocab else CharParser()


def require_port_run(save_dir: str) -> None:
    """Refuse a run directory written by the JAX package: its ``ckpt/``
    steps are Orbax directories, which the port does not read."""
    for sub in ("ckpt", "best"):
        root = os.path.join(save_dir, sub)
        if not os.path.isdir(root):
            continue
        for step in os.listdir(root):
            if step.isdigit() and not os.path.exists(
                    os.path.join(root, step, "state.pt")):
                raise SystemExit(
                    f"{save_dir} holds an Orbax checkpoint of the JAX "
                    "package, which asr_study_torch does not read; export "
                    "its weights with extras/export_weights.py and serve "
                    "them with python -m asr_study_torch.cli.predict "
                    "--weights")


def host_feature(name: str, params_json: Optional[str] = None):
    """``--input_parser`` / ``--input_params`` -> a host feature
    extractor."""
    if name not in FEATURES:
        raise SystemExit(f"unknown --input_parser {name!r}; have "
                         f"{sorted(FEATURES)}")
    kw = json.loads(params_json) if params_json else {}
    return FEATURES[name](**kw)


# raw-sample rows bucket at 2048 samples (128 ms at 16 kHz): the default
# 64-row multiple would make a distinct padded length every 4 ms
RAW_GEN_KW = dict(time_multiple=2048, min_time=2048)


def device_featurizer_for(kind: str, params_json: Optional[str], it,
                          dataset: str, context: str,
                          device: torch.device | str):
    """The in-step feature chain for a raw-waveform iterator: one policy
    for train (``--device_features``) and eval (the run's recorded
    hparams), so the two cannot drift.  The kernel featurizer on a CUDA
    device, the plain one on the CPU; there is no probe (a kernel that
    fails raises)."""
    if it.num_feats != 1:
        raise SystemExit(
            f"{context} needs a raw-waveform dataset "
            f"(make_dataset --input_parser raw); {dataset} stores "
            f"{it.num_feats}-dim features")
    kw = json.loads(params_json) if params_json else {}
    return featurizer(kind, device, **kw)


def flow_from_arg(gen: DatasetGenerator, dataset: str, split: Optional[str],
                  label_parser, input_parser_name: str = "mfcc",
                  input_params: Optional[str] = None) -> DatasetIterator:
    if is_manifest(dataset):
        return gen.flow_from_json(dataset,
                                  host_feature(input_parser_name,
                                               input_params),
                                  label_parser, split=split)
    return gen.flow_from_h5(dataset, split)
