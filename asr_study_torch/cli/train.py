"""Training CLI (port of ``asr_study_tpu/cli/train.py``).

    python -m asr_study_torch.cli.train --dataset d.h5 --model deep_blstm \\
        --epochs 20 --save runs/exp1

    python -m asr_study_torch.cli.train --dataset raw.h5 \\
        --device_features mfcc --spec_augment --wav_augment gain_db=3

The dataset is an HDF5 file of ``make_dataset --output`` or a JSON-lines
manifest.  With ``--device_features`` (a raw dataset, ``make_dataset
--input_parser raw``) each step featurizes its waveforms on the device
(the fbank kernel on the card), after ``--wav_augment`` and before
``--spec_augment``.  The JAX CLI's flags keep their names; ``--platform``
is ``--device`` (a torch device, ``cuda`` unless asked for the CPU).  The
run directory, its automatic name, its ``meta.json`` hparams and the
training semantics (train and valid splits, early stop, the staircase
decay, resume, warm start, SortaGrad, the optimizers, gradient
accumulation, reduce-on-plateau, ``--profile`` and ``--check_nans``) are
the JAX CLI's, and so are its refusals of invalid combinations, made
before the dataset is read.

``--num_devices N`` (N > 1) trains data-parallel, as the JAX CLI's ``data``
mesh: N ranks (``parallel.dp.launch``), over NCCL on ``cuda:0`` to
``cuda:N-1`` (never more ranks than cards) or over gloo on the CPU (each
rank ``cores // N`` threads), each stepping on its rows of every global
batch of ``--batch_size``, which N must divide; rank 0 writes the run
directory and prints.  A rank that fails ends the run with its error.

``--tp_devices M`` (M > 1) adds the JAX CLI's ``model`` mesh axis: N x M
ranks (N of 1 where ``--num_devices`` is 0 or 1), M shards of each plain
LSTM or GRU layer's gate dimension a data rank (``parallel/tp.py``).  A
model ``validate_tp`` refuses, and more ranks than cards, stop at start-up
with the JAX CLI's messages; on the CPU the ranks are gloo processes.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import torch

from asr_study_torch.cli.data_flow import (
    RAW_GEN_KW, data_parallel_devices, device_featurizer_for, flow_from_arg,
    parser_for_training, require_port_run, resolve_device)
from asr_study_torch.data.generator import DatasetGenerator
from asr_study_torch.features.augment import (
    parse_spec_augment, parse_wav_augment)
from asr_study_torch.models.zoo import build_model
from asr_study_torch.parallel import dp
from asr_study_torch.parallel.tp import validate_tp
from asr_study_torch.train.checkpoint import CheckpointManager
from asr_study_torch.train.loop import fit
from asr_study_torch.train.trainer import Trainer, make_optimizer

# run-dir tags, in the JAX CLI's order
_NAME_TAGS = ("params", "batch_size", "opt", "lr", "clipnorm", "bf16",
              "lr_decay", "early_stop", "accum_steps", "lr_plateau")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a CTC acoustic model")
    p.add_argument("--dataset", required=True,
                   help="HDF5 dataset path, or a .json / .jsonl manifest "
                        "(features extracted on the host with "
                        "--input_parser)")
    p.add_argument("--input_parser", default="mfcc",
                   help="feature extractor for manifests "
                        "(fbank|logfbank|mfcc|raw)")
    p.add_argument("--input_params", default=None,
                   help="feature kwargs as JSON for manifests")
    p.add_argument("--model", default="graves2006")
    p.add_argument("--params", default=None,
                   help='hparam overrides, e.g. '
                        '"num_hiddens=256,num_layers=3"')
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--opt", default="adam")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--clipnorm", type=float, default=400.0)
    p.add_argument("--lr_decay", type=float, default=0.0,
                   help="staircase LR decay per epoch, e.g. 0.95 "
                        "(0 = constant lr)")
    p.add_argument("--lr_plateau", type=float, default=0.0)
    p.add_argument("--lr_patience", type=int, default=3)
    p.add_argument("--accum_steps", type=int, default=1)
    p.add_argument("--early_stop", type=int, default=0,
                   help="stop when --monitor has not improved for N "
                        "epochs (0 = off)")
    p.add_argument("--monitor", default="val_loss",
                   choices=["val_loss", "val_ler"],
                   help="validation metric driving the 'best' checkpoint "
                        "and --early_stop (lower is better)")
    p.add_argument("--save", default=None,
                   help="checkpoint/log dir (default: runs/<name> from the "
                        "model and the non-default args)")
    p.add_argument("--resume", nargs="?", const="latest", default="",
                   choices=["", "latest", "auto"],
                   help="resume from the latest checkpoint in --save: "
                        "'latest' (bare --resume; errors if none exists) or "
                        "'auto' (resume when one exists, else start fresh)")
    p.add_argument("--init_from", default=None,
                   help="warm-start the weights from another run dir of "
                        "the port (its best checkpoint if kept, else "
                        "latest); the optimizer starts fresh at step 0")
    p.add_argument("--num_devices", type=int, default=0,
                   help="data-parallel ranks, one a device (0 or 1: one "
                        "device; on cuda at most the card count)")
    p.add_argument("--tp_devices", type=int, default=1,
                   help="tensor-parallel model shards per data rank "
                        "(lstm/gru cells only; total ranks = num_devices "
                        "x tp_devices)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true",
                   help="trace steps 10-20 with torch.profiler into "
                        "<run>/trace")
    p.add_argument("--tensorboard", action="store_true",
                   help="also write TensorBoard event files to <run>/tb")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda)")
    p.add_argument("--check_nans", action="store_true",
                   help="stop with FloatingPointError at the first step "
                        "whose loss or gradient norm is not finite")
    p.add_argument("--bf16", action="store_true",
                   help="mixed precision: bfloat16 compute, float32 master "
                        "weights and optimizer state (every zoo model)")
    p.add_argument("--vocab", default=None,
                   help="label vocabulary: preset name (pt_br, "
                        "pt_br_apostrophe) or literal characters; default "
                        "= an HDF5 dataset's stored vocabulary, which it "
                        "must match")
    p.add_argument("--device_features", nargs="?", const="mfcc",
                   default=None, choices=["fbank", "logfbank", "mfcc"],
                   help="train from a raw-waveform dataset (make_dataset "
                        "--input_parser raw), featurizing each batch of "
                        "this kind on the device inside the step (bare "
                        "flag = mfcc)")
    p.add_argument("--device_feature_params", default=None,
                   help='feature kwargs as JSON for --device_features, '
                        'e.g. \'{"nfilt": 80, "d": true}\'')
    p.add_argument("--sortagrad", action="store_true",
                   help="first epoch in ascending-duration batch order")
    p.add_argument("--wav_augment", nargs="?", const="", default=None,
                   help="raw-waveform augmentation in training (needs "
                        "--device_features): random gain and white noise; "
                        "optionally 'gain_db=3,noise_snr_min=20,"
                        "noise_snr_max=50' (bare flag = those defaults; "
                        "setting one group, gain or noise, keeps the "
                        "other's default)")
    p.add_argument("--spec_augment", nargs="?", const="", default=None,
                   help="SpecAugment feature masking in training; "
                        "optionally 'freq_masks=2,freq_width=8,"
                        "time_masks=2,time_ratio=0.05' (bare flag = those "
                        "defaults)")
    return p


def run_dir(args) -> str:
    """``runs/<model>_<k=v of each non-default tag>``, as the JAX CLI
    names it."""
    defaults = build_argparser().parse_args(["--dataset", args.dataset])
    tags = [args.model]
    for k in _NAME_TAGS:
        v = getattr(args, k)
        # `is not False`, not `not in (None, False)`: 0 == False, and a
        # zero override (--clipnorm 0) must still tag the run dir
        if v != getattr(defaults, k) and v is not None and v is not False:
            tags.append(f"{k}={v}")
    safe = "".join(c if c.isalnum() or c in "=._-" else "_"
                   for c in "_".join(tags))
    return os.path.join("runs", safe)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.wav_augment is not None and not args.device_features:
        raise SystemExit("--wav_augment operates on raw waveforms and "
                         "needs --device_features")
    tp = max(1, args.tp_devices)
    if tp > 1:
        # the cells and widths only: a model on no memory
        model = build_model(args.model, args.params, num_classes=1,
                            input_dim=1, device="meta")
        try:
            validate_tp(model, tp)
        except ValueError as e:
            raise SystemExit(f"--tp_devices {tp}: {e}") from None
    devices = data_parallel_devices(
        args.num_devices, args.device, args.batch_size,
        f"--num_devices {max(1, args.num_devices)} x --tp_devices {tp}", tp)
    device = None if devices else resolve_device(args.device)
    if args.save is None:
        args.save = run_dir(args)
        print(f"run dir: {args.save}", file=sys.stderr)
    for d in (args.save, args.init_from):
        if d:
            require_port_run(d)
    if args.init_from and args.resume:
        raise SystemExit("--init_from and --resume are exclusive")
    if not devices:
        return train(args, device)
    try:
        dp.launch(_train_rank, devices, args=(args,), tp=tp)
    except dp.RankError as e:
        layout = f"--num_devices {len(devices) // tp}" + (
            f" x --tp_devices {tp}" if tp > 1 else "")
        raise SystemExit(f"train {layout}: {e}") from None
    return 0


def _train_rank(group: dp.DataGroup, args) -> int:
    return train(args, group.device, group)


def train(args, device: torch.device,
          group: Optional[dp.DataGroup] = None) -> int:
    """Train as ``args`` says on ``device``, as one rank of ``group`` where
    there is one."""
    lead = group is None or group.lead

    def say(msg: str) -> None:
        if lead:
            print(msg, file=sys.stderr)

    label_parser = parser_for_training(args.dataset, args.vocab)
    gen = DatasetGenerator(batch_size=args.batch_size,
                           **(RAW_GEN_KW if args.device_features else {}))
    train_it = flow_from_arg(gen, args.dataset, "train", label_parser,
                             args.input_parser, args.input_params)
    try:
        valid_it = flow_from_arg(gen, args.dataset, "valid", label_parser,
                                 args.input_parser, args.input_params)
    except KeyError:
        valid_it = None     # the HDF5 dataset has no 'valid' split
    except ValueError as e:
        # only the generator's "no usable valid data" means training
        # without validation; anything else must surface
        if "empty dataset" not in str(e):
            raise
        valid_it = None
    if args.early_stop and valid_it is None:
        raise SystemExit(
            "--early_stop requires a 'valid' split in the dataset "
            "(val_loss drives the stopping decision)")

    # the decay and the plateau window count optimizer updates, which
    # accumulation makes 1/accum_steps as frequent: per-epoch semantics
    updates_per_epoch = max(1, train_it.steps_per_epoch // args.accum_steps)
    spec = make_optimizer(
        args.opt, args.lr, args.clipnorm, lr_decay=args.lr_decay,
        decay_steps=updates_per_epoch if args.lr_decay else 0,
        accum_steps=args.accum_steps, plateau_factor=args.lr_plateau,
        plateau_patience=args.lr_patience if args.lr_plateau else 0,
        plateau_window=updates_per_epoch)
    augment = featurizer = wav_augment = None
    if args.spec_augment is not None:
        augment = parse_spec_augment(args.spec_augment)
        say(f"training with {augment}")
    if args.device_features:
        featurizer = device_featurizer_for(
            args.device_features, args.device_feature_params, train_it,
            args.dataset, "--device_features", device)
        say(f"on-device features: {args.device_features} "
            f"({type(featurizer).__name__}, {featurizer.num_feats} dims)")
    if args.wav_augment is not None:
        wav_augment = parse_wav_augment(args.wav_augment)
        say(f"training with {wav_augment}")
    num_feats = featurizer.num_feats if featurizer else train_it.num_feats
    model = build_model(args.model, args.params,
                        num_classes=label_parser.num_classes,
                        input_dim=num_feats,
                        generator=torch.Generator().manual_seed(args.seed),
                        device=device)
    trainer = Trainer(model, spec, augment=augment, featurizer=featurizer,
                      wav_augment=wav_augment, check_nans=args.check_nans,
                      compute_dtype=torch.bfloat16 if args.bf16 else None,
                      group=group)
    state = trainer.init_state()
    n_params = sum(p.numel() for p in model.parameters())
    tp = group.model.world if group is not None and group.model else 1
    say(f"{args.model}: {n_params:,} parameters on {device}"
        + (f" and {group.world * tp - 1} more rank(s) ({group.backend}"
           + (f", {tp} model shards a data rank" if tp > 1 else "") + ")"
           if group is not None else ""))
    if args.init_from:
        src = CheckpointManager(args.init_from)
        # the best checkpoint if the source run kept one, else latest
        use_best = src.best_step is not None
        model.load_state_dict(src.restore_params(model.state_dict(),
                                                 best=use_best))
        say(f"warm-started weights from {args.init_from} "
            f"({'best' if use_best else 'latest'} checkpoint)")
    ckpt = CheckpointManager(args.save, best_metric=args.monitor,
                             group=group)
    if args.resume:
        if ckpt.latest_step is not None:
            state = ckpt.restore(state)
            say(f"resumed from step {state.step}")
        elif args.resume == "latest":
            raise SystemExit(
                f"--resume: no checkpoint found in {args.save} "
                "(use '--resume auto' to start fresh when none exists)")

    hparams = {
        "model": args.model, "params": args.params,
        "batch_size": args.batch_size, "opt": args.opt, "lr": args.lr,
        "clipnorm": args.clipnorm,
        "num_devices": group.world if group is not None else 1,
        "tp_devices": tp,
        "bf16": args.bf16, "lr_decay": args.lr_decay,
        "early_stop": args.early_stop, "accum_steps": args.accum_steps,
        "lr_plateau": args.lr_plateau,
        "monitor": args.monitor,
        "spec_augment": args.spec_augment,
        "wav_augment": args.wav_augment,
        "sortagrad": args.sortagrad,
        "device_features": args.device_features,
        "device_feature_params": args.device_feature_params,
        "num_feats": num_feats,
        "num_classes": label_parser.num_classes,
        "vocab": label_parser.vocab,
    }
    fit(trainer, state, train_it, valid_it, epochs=args.epochs,
        seed=args.seed, ckpt=ckpt, hparams=hparams, log_dir=args.save,
        log_every=args.log_every, profile=args.profile,
        tensorboard=args.tensorboard,
        early_stop_patience=args.early_stop, sortagrad=args.sortagrad,
        monitor=args.monitor)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
