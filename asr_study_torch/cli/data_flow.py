"""Shared CLI helpers (port of ``asr_study_tpu/cli/data_flow.py``): resolve
``--dataset`` into a DatasetIterator, reconstruct the vocabulary of a
run, pick the torch device, build the host feature extractor.

The port reads JSON-lines manifests (``DatasetParser.to_json``) with the
features extracted on the host; HDF5 datasets and in-step device features
are refused with the ROADMAP item that brings them.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from asr_study_torch.data.dataset_parser import HDF5_ITEM
from asr_study_torch.data.generator import DatasetGenerator, DatasetIterator
from asr_study_torch.features.audio import FEATURES
from asr_study_torch.text.parser import CharParser, resolve_vocab

DEVICE_FEATURES_ITEM = ("ROADMAP queue A item 7, device features: it needs "
                        "the raw-waveform feature and the in-step "
                        "featurizer")


def is_manifest(dataset: str) -> bool:
    return dataset.endswith(".json") or dataset.endswith(".jsonl")


def require_manifest(dataset: str) -> None:
    if not is_manifest(dataset):
        raise SystemExit(f"--dataset {dataset!r}: {HDF5_ITEM}")


def resolve_device(name: str) -> torch.device:
    """``--device`` -> torch.device; a CUDA device needs CUDA (no quiet
    fall back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: torch.cuda.is_available() is "
                         "false; pass --device cpu to run on the CPU")
    return device


def parser_for_training(dataset: str, vocab_arg: Optional[str] = None
                        ) -> CharParser:
    """Label parser for a training run: ``--vocab`` if given, else the
    default (a manifest stores no vocabulary; its labels are parsed on the
    fly)."""
    require_manifest(dataset)
    return CharParser(resolve_vocab(vocab_arg))


def parser_from_run(save_dir: str) -> CharParser:
    """Label parser for eval: the run's recorded vocabulary (meta.json
    hparams), else the default."""
    meta_path = os.path.join(save_dir, "meta.json")
    vocab = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            vocab = json.load(f).get("hparams", {}).get("vocab")
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
    if name == "raw":
        raise SystemExit(f"--input_parser raw: raw-waveform datasets are not "
                         f"ported to asr_study_torch yet "
                         f"({DEVICE_FEATURES_ITEM})")
    if name not in FEATURES:
        raise SystemExit(f"unknown --input_parser {name!r}; have "
                         f"{sorted(FEATURES)}")
    kw = json.loads(params_json) if params_json else {}
    return FEATURES[name](**kw)


def flow_from_arg(gen: DatasetGenerator, dataset: str, split: Optional[str],
                  label_parser, input_parser_name: str = "mfcc",
                  input_params: Optional[str] = None) -> DatasetIterator:
    require_manifest(dataset)
    return gen.flow_from_json(dataset,
                              host_feature(input_parser_name, input_params),
                              label_parser, split=split)
