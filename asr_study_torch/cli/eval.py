"""Evaluation CLI (port of ``asr_study_tpu/cli/eval.py``): checkpoint ->
decode a split -> loss, CER and WER.

    python -m asr_study_torch.cli.eval --dataset d.h5 --split test \\
        --save runs/exp1

    python -m asr_study_torch.cli.eval --dataset m.json --split test \\
        --save runs/exp1 --beam_width 16 --lm lm3.npz [--blank_collapse 0.99]

Per batch, on ``--device``: the model in eval mode, the per-sequence CTC
loss weighted over ``max(sum(w), 1)`` and the decode (:func:`eval_batch`):
greedy, or with ``--beam_width`` the best path of the prefix beam search
(on the card one launch of ``csrc/ctc_beam.cu`` a batch), optionally after
``--blank_collapse`` and with a char n-gram LM fused in (``--lm``, from
``cli.train_lm``).  The transcripts are scored on the host.  The last line
of standard output is the JAX CLI's JSON record (``split``, ``num_utts``,
``loss``, ``cer``, ``wer``, ``decoder``; with ``--lm`` also ``lm``, with
``--blank_collapse`` ``blank_collapse_overflow_utts``).  A run trained
with in-step device features (``train --device_features``) is evaluated
on a raw dataset, featurized on the device by the chain its hparams
record.  A run written by the JAX package is refused.

``--num_devices N`` (N > 1) evaluates data-parallel, as the JAX CLI's
``shard_map``: N ranks (``parallel.dp.launch``; NCCL on ``cuda:0`` to
``cuda:N-1``, gloo on the CPU) each decode their rows of every batch, the
loss and weight sums are all-reduced and the decoded ids, lengths and
dropped frames gathered to rank 0 in global row order, so the record and
the ``--dump`` file are the one-device run's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from asr_study_torch.cli.data_flow import (
    RAW_GEN_KW, data_parallel_devices, device_featurizer_for, flow_from_arg,
    parser_from_run, require_port_run, resolve_device)
from asr_study_torch.data.generator import DatasetGenerator
from asr_study_torch.models.zoo import AcousticModel, build_model
from asr_study_torch.ops.beam import BeamConfig, decode
from asr_study_torch.ops.ctc import blank_collapse, ctc_loss
from asr_study_torch.ops.metrics import cer, wer
from asr_study_torch.parallel import dp
from asr_study_torch.text.lm import CharNGramLM, check_lm_vocab
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
                   help="HDF5 dataset path or .json / .jsonl manifest")
    p.add_argument("--input_parser", default="mfcc",
                   help="feature extractor for manifests "
                        "(fbank|logfbank|mfcc|raw)")
    p.add_argument("--input_params", default=None)
    p.add_argument("--split", default="test")
    p.add_argument("--save", required=True, help="training run directory")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--beam_width", type=int, default=0,
                   help="0 = greedy decode, >0 = prefix beam search")
    p.add_argument("--beam_prune", type=int, default=0,
                   help="expand only the per-frame top-K chars (0 = exact)")
    p.add_argument("--blank_collapse", type=float, default=0.0,
                   help="collapse blank runs with posterior >= this "
                        "threshold before beam decoding (0 = off)")
    p.add_argument("--keep_ratio", type=float, default=0.6,
                   help="static frame budget for --blank_collapse as a "
                        "fraction of T; overflowing utterances are reported")
    p.add_argument("--lm", default=None,
                   help="char n-gram LM (.npz from train_lm) for "
                        "shallow fusion; needs --beam_width > 0")
    p.add_argument("--lm_alpha", type=float, default=0.8,
                   help="LM weight in the fused beam score")
    p.add_argument("--lm_beta", type=float, default=0.0,
                   help="per-character insertion bonus with --lm")
    p.add_argument("--num_devices", type=int, default=0,
                   help="data-parallel ranks, one a device (0 or 1: one "
                        "device; on cuda at most the card count)")
    p.add_argument("--best", action="store_true",
                   help="use the best (val_loss) checkpoint instead of latest")
    p.add_argument("--dump", default=None,
                   help="write per-utterance transcripts to this file")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (default cuda)")
    return p


@torch.inference_mode()
def eval_batch(model: AcousticModel, inputs: torch.Tensor,
               input_lengths: torch.Tensor, labels: torch.Tensor,
               label_lengths: torch.Tensor, weights: torch.Tensor,
               beam: BeamConfig | None = None, collapse: float = 0.0,
               keep_ratio: float = 0.6, featurizer=None,
               group: dp.DataGroup | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """One batch on the device -> (weighted mean loss, decoded ids [B, T']
    padded with -1, decoded lengths [B], frames dropped [B]); with a data
    ``group``, of this rank's rows, the loss the mean over every rank's
    (one all-reduce of the loss and weight sums).

    With ``featurizer`` the inputs are raw padded waveforms [B, N, 1],
    featurized first.  Greedy decode; with ``beam`` the best beam, after
    ``blank_collapse`` at threshold ``collapse`` when that is > 0
    (``dropped``: the frames each utterance lost to the ``keep_ratio``
    budget, else 0)."""
    if featurizer is not None:
        inputs, input_lengths = featurizer._transform(inputs[..., 0],
                                                      input_lengths)
    logits = model(inputs, input_lengths, train=False)
    per_seq = ctc_loss(logits, input_lengths, labels, label_lengths,
                       blank_id=model.blank_id)
    w = weights.to(torch.float32)
    sums = torch.stack([(per_seq * w).sum(), w.sum()])
    if group is not None:
        dp.all_reduce_sum(group, sums)
    loss = sums[0] / torch.clamp(sums[1], min=1.0)
    dropped = torch.zeros_like(input_lengths)
    dec_logits, dec_lengths = logits, input_lengths
    if beam is not None and beam.width > 0 and collapse > 0:
        dec_logits, dec_lengths, dropped = blank_collapse(
            logits, input_lengths, blank_id=model.blank_id,
            threshold=collapse, keep_ratio=keep_ratio)
    decoded, lengths = decode(dec_logits, dec_lengths, model.blank_id, beam)
    return loss, decoded, lengths, dropped


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    devices = data_parallel_devices(args.num_devices, args.device,
                                    args.batch_size,
                                    f"--num_devices {args.num_devices}")
    device = None if devices else resolve_device(args.device)
    if args.lm and args.beam_width <= 0:
        raise SystemExit("--lm requires --beam_width > 0")
    if not devices:
        results, pairs = evaluate(args, device)
    else:
        try:
            results, pairs = dp.launch(_eval_rank, devices, args=(args,))[0]
        except dp.RankError as e:
            raise SystemExit(
                f"eval --num_devices {len(devices)}: {e}") from None
    if args.dump:
        with open(args.dump, "w") as f:
            for h, r in pairs:
                f.write(json.dumps({"hyp": h, "ref": r}) + "\n")
    print(json.dumps(results))
    return 0


def _eval_rank(group: dp.DataGroup, args):
    return evaluate(args, group.device, group)


def evaluate(args, device: torch.device, group: dp.DataGroup | None = None
             ) -> tuple[dict, list] | None:
    """Evaluate as ``args`` says on ``device``, as one rank of ``group``
    where there is one -> (the JSON record, the (hypothesis, reference)
    pairs) on rank 0, None on the others."""
    lead = group is None or group.lead
    label_parser = parser_from_run(args.save, args.dataset)
    lm = None
    if args.lm:
        lm = CharNGramLM.load(args.lm)
        check_lm_vocab(lm, label_parser.vocab)
    beam = BeamConfig(args.beam_width, args.beam_prune, lm, args.lm_alpha,
                      args.lm_beta) if args.beam_width > 0 else None
    model, hp = load_run(args.save, label_parser, best=args.best,
                         device=device)
    gen = DatasetGenerator(batch_size=args.batch_size, shuffle=False,
                           **(RAW_GEN_KW if hp.get("device_features")
                              else {}))
    it = flow_from_arg(gen, args.dataset, args.split, label_parser,
                       args.input_parser, args.input_params)
    feat = None
    if hp.get("device_features"):
        # the run trained on raw waveforms with in-step features: the same
        # chain, rebuilt from its recorded hparams, on a raw dataset
        feat = device_featurizer_for(
            hp["device_features"], hp.get("device_feature_params"), it,
            args.dataset,
            f"run {args.save} (trained with on-device features)", device)

    hyps, refs = [], []
    tot_loss, tot_n = 0.0, 0
    overflow_utts = 0
    for b in it.epoch():
        rows = (dp.shard_rows(b, group.rank, group.world) if group is not None
                else b)
        loss, dec, lens, dropped = eval_batch(
            model, *device_batch(rows, device), beam=beam,
            collapse=args.blank_collapse, keep_ratio=args.keep_ratio,
            featurizer=feat, group=group)
        if group is not None:
            # the ranks' rows back in global order: one gather of
            # [ids | length | dropped] rows
            out = dp.all_gather_rows(group, torch.cat(
                [dec.long(), lens.long()[:, None], dropped.long()[:, None]],
                dim=1))
            dec, lens, dropped = out[:, :-2], out[:, -2], out[:, -1]
        if not lead:
            continue
        dec, lens = dec.cpu().numpy(), lens.cpu().numpy()
        n = int(b.weights.sum())
        tot_loss += float(loss) * n
        tot_n += n
        n_over = int(((dropped.cpu().numpy() > 0) & (b.weights > 0)).sum())
        if n_over:
            overflow_utts += n_over
            print(f"warning: blank_collapse dropped frames on {n_over} "
                  f"utterance(s) in this batch — raise --keep_ratio "
                  f"(currently {args.keep_ratio})", file=sys.stderr)
        for i in range(b.size):
            if b.weights[i] == 0:
                continue
            hyps.append(label_parser.imap(dec[i, : lens[i]]))
            refs.append(
                b.texts[i] if b.texts
                else label_parser.imap(b.labels[i, : b.label_lengths[i]]))
    if not lead:
        return None
    results = {
        "split": args.split,
        "num_utts": tot_n,
        "loss": tot_loss / max(tot_n, 1),
        "cer": cer(hyps, refs),
        "wer": wer(hyps, refs),
        "decoder": (f"beam{args.beam_width}" + ("+lm" if lm else ""))
        if args.beam_width else "greedy",
    }
    if lm is not None:
        results["lm"] = {"path": args.lm, "order": lm.order,
                         "alpha": args.lm_alpha, "beta": args.lm_beta}
    if args.blank_collapse > 0:
        results["blank_collapse_overflow_utts"] = overflow_utts
    return results, list(zip(hyps, refs))


if __name__ == "__main__":
    raise SystemExit(main())
