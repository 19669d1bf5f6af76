"""Prediction CLI (port of ``asr_study_tpu/cli/predict.py``): wav files ->
JSON transcripts, one line per file.

    python -m asr_study_torch.cli.predict --weights model.npz --on_device \\
        [--batch_size N] [--beam_width 16 [--lm lm3.npz]] a.wav b.wav ...

    python -m asr_study_torch.cli.predict --save runs/exp1 a.wav

    python -m asr_study_torch.cli.predict --weights uni.npz --stream \
        [--chunk_seconds 10] [--beam_width 16 [--lm lm3.npz]] a.wav b.wav

``--weights`` takes the ``.npz`` that ``extras/export_weights.py`` writes
from a JAX training run, ``--save`` a run directory of the port's
``train``.  ``--input_parser`` defaults to the run's recorded
``--device_features`` chain and its parameters, else mfcc; an explicit
parser drops the recorded parameters.  Two serving paths, as in the JAX
CLI:

- ``--on_device``: the utterances cross to the device as wire buffers
  (``--wire_codec`` pcm16, dpack, mulaw, or auto: probe the link), one per
  batch, all in one host->device copy; each batch is unpacked (for dpack
  by the dpack kernel), featurized (fbank kernel), run through the model
  (one recurrence kernel per layer) and decoded on the device
  (:func:`serve_batch`).
- default: features from the NumPy oracle on the host, then the same model
  and decode on ``--device``.

The decode is greedy, or with ``--beam_width`` the best path of the prefix
beam search (``ops/beam.py``; on the card one launch of
``csrc/ctc_beam.cu`` a batch), with ``--lm`` a char n-gram LM fused in.

``--stream`` (a unidirectional recurrent model) decodes each wav in
chunks of ``--chunk_seconds`` of audio at bounded memory, as the JAX CLI
does (``streaming.py``): features from the host oracle chunk by chunk, the
model's recurrent state carried on ``--device`` from chunk to chunk (one
forward kernel launch a layer and chunk on the card), greedy or by beam
(one beam kernel launch a chunk).  Several wavs decoded greedily run as
concurrent streams of one ``MultiStreamRecognizer``; otherwise each wav has
its own ``StreamingRecognizer``.  It excludes ``--on_device``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import NamedTuple, Sequence

import numpy as np
import torch

from asr_study_torch.cli.data_flow import parser_from_run
from asr_study_torch.cli.eval import load_run
from asr_study_torch.data import wire
from asr_study_torch.features import audio
from asr_study_torch.features.device import DeviceFeaturizer
from asr_study_torch.features.select import featurizer
from asr_study_torch.features.wav import read_wav
from asr_study_torch.models.zoo import AcousticModel, build_model
from asr_study_torch.ops.beam import BeamConfig, decode
from asr_study_torch.text.lm import CharNGramLM, check_lm_vocab
from asr_study_torch.text.parser import CharParser
from asr_study_torch.utils.weights import load_npz, params_from_flat


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Transcribe wav files")
    p.add_argument("wavs", nargs="+", help="wav file paths")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights",
                     help=".npz written by extras/export_weights.py")
    src.add_argument("--save", help="a training run directory of the port")
    p.add_argument("--best", action="store_true",
                   help="with --save: the best checkpoint, not the latest")
    p.add_argument("--input_parser", default=None,
                   help="feature extractor name (fbank|logfbank|mfcc); "
                        "default = the run's recorded --device_features "
                        "chain when present, else mfcc")
    p.add_argument("--input_params", default=None,
                   help='feature kwargs as JSON, e.g. \'{"d": true}\'')
    p.add_argument("--on_device", action="store_true",
                   help="wire -> features -> model -> decode on the device")
    p.add_argument("--batch_size", type=int, default=8,
                   help="utterances per device batch with --on_device")
    p.add_argument("--wire_codec", default="pcm16",
                   choices=("pcm16", "dpack", "mulaw", "auto"),
                   help="--on_device wire encoding: pcm16 (raw), dpack "
                        "(lossless delta + bit-packing, bit-identical to "
                        "pcm16), mulaw (8-bit companded, lossy, half the "
                        "bytes), or auto (probe the link to --device: "
                        "dpack below 1000 MB/s, else pcm16)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda)")
    p.add_argument("--beam_width", type=int, default=0,
                   help="0 = greedy decode, >0 = prefix beam search")
    p.add_argument("--lm", default=None,
                   help="char n-gram LM (.npz from train_lm) for "
                        "shallow fusion; needs --beam_width > 0")
    p.add_argument("--lm_alpha", type=float, default=0.8)
    p.add_argument("--lm_beta", type=float, default=0.0)
    p.add_argument("--stream", action="store_true",
                   help="chunked streaming decode with carried recurrent "
                        "state: unbounded-length audio at bounded memory "
                        "(unidirectional models only)")
    p.add_argument("--chunk_seconds", type=float, default=10.0,
                   help="audio chunk size for --stream")
    return p


def load_model(path: str, device: torch.device | str
               ) -> tuple[AcousticModel, dict]:
    """Rebuild the exported model on ``device`` -> (model, meta)."""
    flat, meta = load_npz(path)
    vocab = meta.get("vocab")
    num_classes = meta.get("num_classes") or (
        len(vocab) if vocab else CharParser().num_classes)
    model = build_model(meta.get("model") or "graves2006", meta.get("params"),
                        num_classes=num_classes,
                        input_dim=int(meta.get("num_feats") or 39),
                        device=device)
    model.load_state_dict(params_from_flat(flat, device))
    return model.eval(), meta


class Served(NamedTuple):
    logits: torch.Tensor         # [B, T, V+1]
    feat_lengths: torch.Tensor   # [B]
    decoded: torch.Tensor        # [B, T] int32, padded with -1
    lengths: torch.Tensor        # [B]


@torch.inference_mode()
def serve_batch(model: AcousticModel, feat: DeviceFeaturizer,
                flat: torch.Tensor, batch: int, n_pad: int,
                codec: str = "pcm16", scap: int | None = None,
                beam: BeamConfig | None = None) -> Served:
    """One wire buffer -> logits and transcripts (greedy, or the best
    beam with ``beam``), all on the wire tensor's device.  dpack needs the
    ``scap`` it was packed with."""
    wavs, lens = wire.unpack_audio(flat, batch, n_pad, codec=codec,
                                   scap=scap)
    feats, feat_lengths = feat(wavs, lens)
    logits = model(feats, feat_lengths)
    decoded, lengths = decode(logits, feat_lengths, model.blank_id, beam)
    return Served(logits, feat_lengths, decoded, lengths)


class Packed(NamedTuple):
    chunk: np.ndarray            # the wire buffers end to end, int16
    cap: int                     # words a buffer
    n_pad: int                   # samples a row after unpacking
    scap: int | None             # dpack's sample capacity, else None


def pack_batches(wavs: Sequence[np.ndarray], batch: int,
                 codec: str = "pcm16") -> Packed:
    """Pack ``wavs`` into equal-size wire buffers of ``batch`` rows, laid
    end to end for one host->device copy.  For dpack each group is
    encoded once; the groups share the largest group's ``scap``."""
    n_pad = -(-max(len(w) for w in wavs) // 2048) * 2048
    groups = [wavs[i: i + batch] for i in range(0, len(wavs), batch)]
    if codec == "dpack":
        encs = [wire.dpack_encode(g) for g in groups]
        scap = max(4096, max(-(-n // 4096) * 4096 for *_, n in encs))
        cap = max(-(-(2 * batch + scap // 4096 + payload.shape[0]) // 256)
                  * 256 for _, _, payload, _ in encs)
        bufs = [wire.dpack_pack(g, cap, scap, batch=batch, enc=e)
                for g, e in zip(groups, encs)]
        return Packed(np.concatenate(bufs), cap, n_pad, scap)
    cap = max(wire.wire_cap(batch, sum(len(w) for w in g), align=256,
                            codec=codec) for g in groups)
    chunk = np.concatenate([wire.pack_audio(g, cap, batch=batch, codec=codec)
                            for g in groups])
    return Packed(chunk, cap, n_pad, None)


def predict_on_device(model: AcousticModel, feat: DeviceFeaturizer,
                      wavs: Sequence[np.ndarray], batch_size: int,
                      codec: str = "pcm16",
                      beam: BeamConfig | None = None) -> list[np.ndarray]:
    """Transcribe ``wavs`` in batches through :func:`serve_batch`
    -> one label-id array per utterance."""
    batch = max(1, min(batch_size, len(wavs)))
    chunk, cap, n_pad, scap = pack_batches(wavs, batch, codec)
    dev_chunk = torch.from_numpy(chunk).to(feat.device)
    out = []
    for off in range(0, chunk.shape[0], cap):
        s = serve_batch(model, feat, dev_chunk[off: off + cap], batch, n_pad,
                        codec, scap, beam)
        dec, lens = s.decoded.cpu().numpy(), s.lengths.cpu().numpy()
        out += [dec[i, : lens[i]] for i in range(dec.shape[0])]
    return out[: len(wavs)]


@torch.inference_mode()
def predict_host_features(model: AcousticModel, feature, paths: Sequence[str],
                          device: torch.device,
                          beam: BeamConfig | None = None
                          ) -> list[np.ndarray]:
    """NumPy-oracle features on the host, then model and decode."""
    feats = [feature(p).astype(np.float32) for p in paths]
    t_max = max(f.shape[0] for f in feats)
    x = np.zeros((len(feats), t_max, feats[0].shape[1]), np.float32)
    lengths = np.array([f.shape[0] for f in feats], np.int32)
    for i, f in enumerate(feats):
        x[i, : f.shape[0]] = f
    lengths_t = torch.from_numpy(lengths).to(device)
    logits = model(torch.from_numpy(x).to(device), lengths_t)
    dec, lens = decode(logits, lengths_t, model.blank_id, beam)
    dec, lens = dec.cpu().numpy(), lens.cpu().numpy()
    return [dec[i, : lens[i]] for i in range(len(paths))]


def _check_feats(name: str, num_feats: int, model: AcousticModel) -> None:
    if num_feats != model.input_dim:
        raise SystemExit(f"--input_parser {name} gives {num_feats} features;"
                         f" the model takes {model.input_dim}")


def _host_feature(name: str, feat_kw: dict, model: AcousticModel):
    """The host oracle feature ``name`` built with ``feat_kw``, checked
    against the model's input width."""
    if name not in audio.FEATURES:
        raise SystemExit(f"unknown --input_parser {name!r}; "
                         f"have {sorted(audio.FEATURES)}")
    feature = audio.FEATURES[name](**feat_kw)
    _check_feats(name, feature.num_feats, model)
    return feature


def predict_streaming(model: AcousticModel, feature, paths: Sequence[str],
                      chunk_seconds: float = 10.0,
                      beam: BeamConfig | None = None) -> list[np.ndarray]:
    """Each wav pushed ``chunk_seconds`` of audio at a time through the
    streaming recognizers on the model's device (the JAX CLI's
    ``_predict_streaming``) -> one id array per file.  Raises ValueError for
    a model or feature that cannot stream."""
    from asr_study_torch.streaming import (MultiStreamRecognizer,
                                           StreamingRecognizer)

    step = max(1, int(chunk_seconds * feature.fs))
    if len(paths) > 1 and beam is None:
        # many files: decode them as concurrent streams, one model step
        # per tick over the whole batch (the serving shape)
        wavs = [read_wav(p, sr=feature.fs)[0] for p in paths]
        multi = MultiStreamRecognizer(model, feature, n_streams=len(wavs))
        offs = [0] * len(wavs)
        while any(o < len(w) for o, w in zip(offs, wavs)):
            for i, w in enumerate(wavs):
                if offs[i] < len(w):
                    multi.push(i, w[offs[i]: offs[i] + step])
                    offs[i] += step
            multi.tick()
        return [np.asarray(multi.finish(i), np.int32)
                for i in range(len(paths))]
    kw = {} if beam is None else dict(
        beam_width=beam.width, prune=beam.prune, lm=beam.lm,
        lm_alpha=beam.lm_alpha, lm_beta=beam.lm_beta)
    out = []
    for path in paths:
        wav, _sr = read_wav(path, sr=feature.fs)
        rec = StreamingRecognizer(model, feature, **kw)
        for lo in range(0, max(len(wav), 1), step):
            rec.push(wav[lo: lo + step])
        out.append(np.asarray(rec.finish(), np.int32))
    return out


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    device = torch.device(args.device)
    if args.save:
        label_parser = parser_from_run(args.save)
        model, meta = load_run(args.save, label_parser, best=args.best,
                               device=device)
    else:
        model, meta = load_model(args.weights, device)
        label_parser = CharParser(meta["vocab"]) if meta.get("vocab") \
            else CharParser()
    if args.input_parser is None:
        # a run trained with in-step features records its chain: the
        # default; an explicit parser drops the recorded params (they
        # belong to the recorded parser)
        args.input_parser = meta.get("device_features") or "mfcc"
        if args.input_params is None and meta.get("device_features"):
            args.input_params = meta.get("device_feature_params")
    lm = None
    if args.lm:
        if args.beam_width <= 0:
            raise SystemExit("--lm requires --beam_width > 0")
        lm = CharNGramLM.load(args.lm)
        check_lm_vocab(lm, label_parser.vocab)
    beam = BeamConfig(args.beam_width, 0, lm, args.lm_alpha,
                      args.lm_beta) if args.beam_width > 0 else None
    feat_kw = json.loads(args.input_params) if args.input_params else {}
    if args.stream:
        if args.on_device:
            raise SystemExit("--stream is host-featurized decoding; it "
                             "excludes --on_device")
        feature = _host_feature(args.input_parser, feat_kw, model)
        try:
            ids = predict_streaming(model, feature, args.wavs,
                                    args.chunk_seconds, beam)
        except ValueError as e:
            raise SystemExit(f"--stream: {e}") from e
    elif args.on_device:
        feat = featurizer(args.input_parser, device, **feat_kw)
        _check_feats(args.input_parser, feat.num_feats, model)
        codec = args.wire_codec
        if codec == "auto":
            bw = wire.probe_link(device)
            codec = wire.choose_codec(bw)
            print(f"wire_codec auto: measured link ~{bw:.0f} MB/s -> "
                  f"{codec}", file=sys.stderr)
        # resample to the featurizer's rate, like the JAX CLI
        wavs = [read_wav(p, sr=feat.fs)[0] for p in args.wavs]
        ids = predict_on_device(model, feat, wavs, args.batch_size, codec,
                                beam)
    else:
        feature = _host_feature(args.input_parser, feat_kw, model)
        ids = predict_host_features(model, feature, args.wavs, device, beam)
    for path, seq in zip(args.wavs, ids):
        print(json.dumps({"file": path,
                          "transcript": label_parser.imap(seq)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
