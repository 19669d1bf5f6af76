"""Dataset build CLI (port of ``asr_study_tpu/cli/make_dataset.py``): corpus
dir -> JSON-lines manifest.

    python -m asr_study_torch.cli.make_dataset --parser synthwords \\
        --dataset_dir corpus --corpus_params '{"n": 800}' --to_json m.json

The manifest is the one the JAX CLI writes for ``--to_json``: one
``{audio, label, speaker, split, duration}`` line per utterance, features
extracted later by ``train`` and ``eval``.  The JAX CLI's HDF5 output
(``--output``) and its accelerator extraction (``--device``) are refused
with the ROADMAP items that bring them.  ``--input_parser``,
``--input_params`` and ``--vocab`` are stored in the HDF5 dataset only, so
anything but their defaults is refused with the HDF5 item (``train`` and
``eval`` take them for a manifest); ``--layout`` too shapes only the HDF5
dataset and does not change the manifest.
"""

from __future__ import annotations

import argparse
import json

from asr_study_torch.data.corpora import corpus
from asr_study_torch.data.dataset_parser import HDF5_ITEM

DEVICE_EXTRACT_ITEM = ("accelerator feature extraction is not ported to "
                       "asr_study_torch yet (ROADMAP queue A item 11)")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Build a JSON-lines manifest")
    p.add_argument("--parser", required=True,
                   help="corpus name (lapsbm|voxforge|sid|cslu|brsd|"
                        "synthwords|dummy)")
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--output", default=None,
                   help="output .h5 path (not ported: ROADMAP queue A "
                        "item 7, HDF5)")
    p.add_argument("--corpus_params", default=None,
                   help="corpus-parser kwargs as JSON, e.g. "
                        '\'{"n": 400, "seed": 1}\' for the synthetic '
                        "parsers (dummy, synthwords)")
    p.add_argument("--input_parser", default="mfcc",
                   help="feature extractor stored in the HDF5 dataset (not "
                        "ported: ROADMAP queue A item 7, HDF5)")
    p.add_argument("--input_params", default=None,
                   help="feature kwargs stored in the HDF5 dataset (not "
                        "ported: ROADMAP queue A item 7, HDF5)")
    p.add_argument("--to_json", default=None,
                   help="write a JSON-lines manifest to this path")
    p.add_argument("--device", action="store_true",
                   help="accelerator extraction (not ported: ROADMAP queue "
                        "A item 11)")
    p.add_argument("--device_batch", type=int, default=32)
    p.add_argument("--device_wire_codec", default="pcm16",
                   choices=("pcm16", "dpack"))
    p.add_argument("--vocab", default=None,
                   help="label vocabulary stored in the HDF5 dataset (not "
                        "ported: ROADMAP queue A item 7, HDF5)")
    p.add_argument("--layout", default="vlen", choices=("vlen", "packed"),
                   help="HDF5 feature layout")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if (args.device or args.device_batch != 32
            or args.device_wire_codec != "pcm16"):
        raise SystemExit(f"--device, --device_batch, --device_wire_codec: "
                         f"{DEVICE_EXTRACT_ITEM}")
    if args.output:
        raise SystemExit(f"--output {args.output!r}: {HDF5_ITEM}")
    if (args.input_parser != "mfcc" or args.input_params is not None
            or args.vocab is not None):
        raise SystemExit(f"--input_parser, --input_params, --vocab: "
                         f"{HDF5_ITEM}; train and eval take the features, "
                         f"train the vocabulary")
    if not args.to_json:
        raise SystemExit("nothing to write: give --to_json")
    corpus_kw = json.loads(args.corpus_params) if args.corpus_params else {}
    parser = corpus(args.parser)(args.dataset_dir, **corpus_kw)
    n = parser.to_json(args.to_json)
    print(f"wrote {n} utterances to {args.to_json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
