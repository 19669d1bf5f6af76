"""Dataset build CLI (port of ``asr_study_tpu/cli/make_dataset.py``): corpus
dir -> HDF5 dataset and/or JSON-lines manifest.

    python -m asr_study_torch.cli.make_dataset --parser synthwords \\
        --dataset_dir corpus --corpus_params '{"n": 800}' --output d.h5

    python -m asr_study_torch.cli.make_dataset --parser synthwords \\
        --dataset_dir corpus --output d.h5 --device --device_wire_codec dpack

``--output`` writes the HDF5 dataset the JAX CLI writes (``data/h5.py``
in place of h5py; ``--layout vlen`` or ``packed``), with features of
``--input_parser`` (``raw`` keeps the waveform, for ``train
--device_features``) extracted on the host, or with ``--device`` on the
device in batches of ``--device_batch`` over the pcm16 or dpack wire
(``features/batch_extract.py``; on the card the dpack and fbank kernels).
``--to_json`` writes the manifest of the JAX CLI, whose features ``train``
and ``eval`` extract later; the port takes either or both.
"""

from __future__ import annotations

import argparse
import json

from asr_study_torch.cli.data_flow import host_feature, resolve_device
from asr_study_torch.data.corpora import corpus
from asr_study_torch.text.parser import CharParser, resolve_vocab


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Build an HDF5 dataset")
    p.add_argument("--parser", required=True,
                   help="corpus name (lapsbm|voxforge|sid|cslu|brsd|"
                        "synthwords|dummy)")
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--output", default=None, help="output .h5 path")
    p.add_argument("--corpus_params", default=None,
                   help="corpus-parser kwargs as JSON, e.g. "
                        '\'{"n": 400, "seed": 1}\' for the synthetic '
                        "parsers (dummy, synthwords)")
    p.add_argument("--input_parser", default="mfcc",
                   help="feature extractor (fbank|logfbank|mfcc|raw)")
    p.add_argument("--input_params", default=None,
                   help='feature kwargs as JSON, e.g. \'{"d": true}\'')
    p.add_argument("--to_json", default=None,
                   help="write a JSON-lines manifest to this path")
    p.add_argument("--device", action="store_true",
                   help="extract the features on the device in length-"
                        "sorted batches (features/batch_extract.py)")
    p.add_argument("--device_batch", type=int, default=32,
                   help="utterances per device batch with --device")
    p.add_argument("--device_wire_codec", default="pcm16",
                   choices=("pcm16", "dpack", "mulaw"),
                   help="--device wire encoding: pcm16 (raw) or dpack "
                        "(lossless compression); mulaw is refused")
    p.add_argument("--platform", default="cuda",
                   help="torch device of the --device extraction (default "
                        "cuda)")
    p.add_argument("--vocab", default=None,
                   help="label vocabulary: preset name (pt_br, "
                        "pt_br_apostrophe) or literal characters (default "
                        "pt_br: a-z + space); stored in the dataset")
    p.add_argument("--layout", default="vlen", choices=("vlen", "packed"),
                   help="HDF5 feature layout: 'vlen' (one vlen row per "
                        "utterance) or 'packed' (one duration-sorted "
                        "[sum_T, F] matrix + offsets)")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if not (args.output or args.to_json):
        raise SystemExit("nothing to write: give --output and/or --to_json")
    feat_kw = json.loads(args.input_params) if args.input_params else {}
    if args.device:
        from asr_study_torch.features.batch_extract import (
            DeviceFeatureExtractor)

        try:
            input_parser = DeviceFeatureExtractor(
                kind=args.input_parser, batch=args.device_batch,
                wire_codec=args.device_wire_codec,
                device=resolve_device(args.platform), **feat_kw)
        except ValueError as e:
            raise SystemExit(f"--device: {e}") from None
    else:
        input_parser = host_feature(args.input_parser, args.input_params)
    label_parser = CharParser(resolve_vocab(args.vocab))
    corpus_kw = json.loads(args.corpus_params) if args.corpus_params else {}
    parser = corpus(args.parser)(args.dataset_dir, **corpus_kw)
    if args.to_json:
        n = parser.to_json(args.to_json)
        print(f"wrote {n} utterances to {args.to_json}")
    if args.output:
        counts = parser.to_h5(args.output, input_parser, label_parser,
                              layout=args.layout)
        print(f"wrote {counts} utterances to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
