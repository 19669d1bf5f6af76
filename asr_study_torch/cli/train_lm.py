"""Fit a character n-gram LM for beam-search shallow fusion (port of
``asr_study_tpu/cli/train_lm.py``).

    python -m asr_study_torch.cli.train_lm --dataset d.h5 \\
        --splits train valid --order 3 --output lm3.npz

Fits on the transcripts of a dataset's splits (the HDF5 dataset or
JSON-lines manifest the acoustic model trains on) or on a text file, one
sentence a line, and writes the dense ``.npz`` table that ``cli.eval
--lm`` and ``cli.predict --lm`` read (``text/lm.py``; the JAX package
reads it too).  An HDF5 dataset's stored vocabulary is the LM's.  The last
line of standard output is the JAX CLI's JSON report.
"""

from __future__ import annotations

import argparse
import json
import sys

from asr_study_torch.cli.data_flow import dataset_vocab, is_manifest
from asr_study_torch.data import h5
from asr_study_torch.text.lm import fit_ngram_lm
from asr_study_torch.text.parser import CharParser


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Fit a char n-gram LM")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--dataset",
                     help="HDF5 dataset path or .json / .jsonl manifest; "
                          "transcripts come from the chosen splits")
    src.add_argument("--text",
                     help="plain text file, one sentence per line")
    p.add_argument("--splits", nargs="+", default=["train"],
                   help="dataset splits to fit on (default: train)")
    p.add_argument("--order", type=int, default=3,
                   help="n-gram order (context = order-1 chars)")
    p.add_argument("--delta", type=float, default=1.0,
                   help="interpolated add-delta smoothing strength")
    p.add_argument("--output", required=True, help="output .npz path")
    p.add_argument("--held_out", default=None,
                   help="optional split (with --dataset) or text file to "
                        "report perplexity on")
    return p


def _dataset_texts(path: str, splits, parser: CharParser):
    """Transcripts of a dataset's ``splits``, as id sequences: an HDF5
    split's ``texts`` (its ``labels`` where it has none), or a manifest's
    lines (a line without a ``split`` counts as train)."""
    if not is_manifest(path):
        with h5.File(path) as f:
            for split in splits:
                if split not in f:
                    raise SystemExit(f"split '{split}' not in {path} "
                                     f"(has: {', '.join(f.keys())})")
                g = f[split]
                if "texts" in g:
                    yield from (parser(t) for t in g["texts"][:])
                else:
                    yield from g["labels"][:]
        return
    wanted = set(splits)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            entry = json.loads(line)
            if (entry.get("split", "train") in wanted
                    and parser.is_valid(entry["label"])):
                yield parser(entry["label"])


def _text_file_ids(path: str, parser: CharParser):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and parser.is_valid(line):
                yield parser(line)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    parser = CharParser()
    if args.dataset:
        # an HDF5 dataset's stored vocabulary (its label ids were minted
        # with it); a manifest stores none and takes the default
        stored = dataset_vocab(args.dataset)
        if stored is not None:
            parser = CharParser(stored)
        seqs = list(_dataset_texts(args.dataset, args.splits, parser))
    else:
        seqs = list(_text_file_ids(args.text, parser))
    if not seqs:
        raise SystemExit("no transcripts found to fit on")
    lm = fit_ngram_lm(seqs, order=args.order, n_char=parser.num_classes,
                      space_id=parser.char_to_id[" "], delta=args.delta,
                      vocab=parser.vocab)
    lm.save(args.output)
    report = {
        "output": args.output,
        "order": args.order,
        "num_sequences": len(seqs),
        "num_chars": int(sum(len(s) for s in seqs)),
        "train_perplexity": lm.perplexity(seqs),
    }
    if args.held_out:
        if args.dataset:
            held = list(_dataset_texts(args.dataset, [args.held_out],
                                       parser))
        else:
            held = list(_text_file_ids(args.held_out, parser))
        if held:
            report["held_out_perplexity"] = lm.perplexity(held)
        else:
            print("warning: empty held-out set", file=sys.stderr)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
