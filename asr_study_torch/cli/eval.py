"""Evaluation CLI (port of ``asr_study_tpu/cli/eval.py``): checkpoint ->
decode a split -> loss, CER and WER.

    python -m asr_study_torch.cli.eval --dataset m.json --split test \\
        --save runs/exp1

Per batch, on ``--device``: the model in eval mode, the per-sequence CTC
loss weighted over ``max(sum(w), 1)`` and the greedy decode
(:func:`eval_batch`); the transcripts are scored on the host.  The last
line of standard output is the JAX CLI's JSON record (``split``,
``num_utts``, ``loss``, ``cer``, ``wer``, ``decoder``).  Beam search, the
LM, blank collapse and data-parallel eval are refused with the ROADMAP
items that bring them, as is a run trained with in-step device features
or written by the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from asr_study_torch.cli.data_flow import (
    DEVICE_FEATURES_ITEM, flow_from_arg, parser_from_run, require_manifest,
    require_port_run, resolve_device)
from asr_study_torch.data.generator import DatasetGenerator
from asr_study_torch.models.zoo import AcousticModel, build_model
from asr_study_torch.ops.ctc import ctc_loss, greedy_decode
from asr_study_torch.ops.metrics import cer, wer
from asr_study_torch.text.parser import CharParser
from asr_study_torch.train.checkpoint import CheckpointManager
from asr_study_torch.train.trainer import device_batch


def load_run(save_dir: str, label_parser: CharParser, best: bool = True,
             device: torch.device | str = "cuda"
             ) -> tuple[AcousticModel, dict]:
    """Rebuild the model of a training run dir from its ``meta.json``
    hparams and load its weights (only those: the optimizer state is not
    read) -> (model in eval mode, hparams)."""
    require_port_run(save_dir)
    with open(os.path.join(save_dir, "meta.json")) as f:
        hp = json.load(f).get("hparams", {})
    if hp.get("device_features"):
        raise SystemExit(
            f"run {save_dir} was trained with on-device features, which "
            f"are not ported to asr_study_torch yet ({DEVICE_FEATURES_ITEM})")
    model = build_model(
        hp.get("model", "graves2006"), hp.get("params"),
        num_classes=hp.get("num_classes", label_parser.num_classes),
        input_dim=int(hp.get("num_feats", 39)), device=device)
    ckpt = CheckpointManager(save_dir)
    model.load_state_dict(ckpt.restore_params(model.state_dict(), best=best))
    return model.eval(), hp


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate a trained model")
    p.add_argument("--dataset", required=True,
                   help="a .json / .jsonl manifest")
    p.add_argument("--input_parser", default="mfcc",
                   help="feature extractor (fbank|logfbank|mfcc)")
    p.add_argument("--input_params", default=None)
    p.add_argument("--split", default="test")
    p.add_argument("--save", required=True, help="training run directory")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--beam_width", type=int, default=0,
                   help="0 = greedy decode (beam search: not ported, "
                        "ROADMAP queue A item 8)")
    p.add_argument("--beam_prune", type=int, default=0)
    p.add_argument("--blank_collapse", type=float, default=0.0)
    p.add_argument("--keep_ratio", type=float, default=0.6)
    p.add_argument("--lm", default=None)
    p.add_argument("--lm_alpha", type=float, default=0.8)
    p.add_argument("--lm_beta", type=float, default=0.0)
    p.add_argument("--num_devices", type=int, default=0,
                   help="0 or 1: one device")
    p.add_argument("--best", action="store_true",
                   help="use the best (val_loss) checkpoint instead of latest")
    p.add_argument("--dump", default=None,
                   help="write per-utterance transcripts to this file")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (default cuda)")
    return p


def _refuse_unported(args) -> None:
    a8 = "is not ported to asr_study_torch yet (ROADMAP queue A item 8)"
    refusals = [
        (args.beam_width > 0, f"--beam_width > 0: beam search {a8}"),
        (args.beam_prune > 0, f"--beam_prune: beam search {a8}"),
        (args.blank_collapse > 0, f"--blank_collapse {a8}"),
        (args.lm is not None, f"--lm {a8}"),
        (args.num_devices > 1,
         "--num_devices > 1: data-parallel eval is not ported to "
         "asr_study_torch yet (ROADMAP queue A item 12)"),
    ]
    for refused, why in refusals:
        if refused:
            raise SystemExit(why)
    require_manifest(args.dataset)


@torch.inference_mode()
def eval_batch(model: AcousticModel, inputs: torch.Tensor,
               input_lengths: torch.Tensor, labels: torch.Tensor,
               label_lengths: torch.Tensor, weights: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One batch on the device -> (weighted mean loss, decoded ids [B, T]
    padded with -1, decoded lengths [B])."""
    logits = model(inputs, input_lengths, train=False)
    per_seq = ctc_loss(logits, input_lengths, labels, label_lengths,
                       blank_id=model.blank_id)
    w = weights.to(torch.float32)
    loss = (per_seq * w).sum() / torch.clamp(w.sum(), min=1.0)
    decoded, lengths = greedy_decode(logits, input_lengths,
                                     blank_id=model.blank_id)
    return loss, decoded, lengths


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    _refuse_unported(args)
    device = resolve_device(args.device)
    label_parser = parser_from_run(args.save)
    model, _ = load_run(args.save, label_parser, best=args.best,
                        device=device)
    gen = DatasetGenerator(batch_size=args.batch_size, shuffle=False)
    it = flow_from_arg(gen, args.dataset, args.split, label_parser,
                       args.input_parser, args.input_params)

    hyps, refs = [], []
    tot_loss, tot_n = 0.0, 0
    for b in it.epoch():
        loss, dec, lens = eval_batch(model, *device_batch(b, device))
        dec, lens = dec.cpu().numpy(), lens.cpu().numpy()
        n = int(b.weights.sum())
        tot_loss += float(loss) * n
        tot_n += n
        for i in range(b.size):
            if b.weights[i] == 0:
                continue
            hyps.append(label_parser.imap(dec[i, : lens[i]]))
            refs.append(
                b.texts[i] if b.texts
                else label_parser.imap(b.labels[i, : b.label_lengths[i]]))

    results = {
        "split": args.split,
        "num_utts": tot_n,
        "loss": tot_loss / max(tot_n, 1),
        "cer": cer(hyps, refs),
        "wer": wer(hyps, refs),
        "decoder": "greedy",
    }
    if args.dump:
        with open(args.dump, "w") as f:
            for h, r in zip(hyps, refs):
                f.write(json.dumps({"hyp": h, "ref": r}) + "\n")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
