"""Batched feature extraction on the device for dataset building (port of
``asr_study_tpu/features/batch_extract.py``).

``DeviceFeatureExtractor`` runs the feature chain of ``features/device.py``
on a torch device in length-sorted batches: each batch of waveforms is
packed on the host into one wire buffer (``data/wire.py``: pcm16, or the
lossless dpack), copied to the device, unpacked (for dpack by the dpack
kernel on the card) and featurized (the fbank kernel on the card); the
features come back in one host copy a batch, trimmed to each utterance's
frame count, in the original order.  A kernel that fails raises: there is
no fall back to another implementation.

Parity note: the chain is float32, near the float64 NumPy oracle of the
host features but not bit-equal to it (``tests/test_torch_features.py``).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from asr_study_torch.data import wire
from asr_study_torch.features.device import device_num_frames
from asr_study_torch.features.select import featurizer
from asr_study_torch.features.wav import read_wav


class DeviceFeatureExtractor:
    """A stand-in for a host feature class in dataset building
    (``DatasetParser.to_h5`` calls :meth:`extract_batch` a chunk at a
    time); ``kind`` and ``**kw`` are the device featurizer's."""

    def __init__(self, kind: str = "mfcc", fs: int = 16000,
                 batch: int = 32, align: int = 16384,
                 wire_codec: str = "pcm16",
                 device: torch.device | str = "cuda", **kw):
        if wire_codec not in ("pcm16", "dpack"):
            raise ValueError(
                f"wire_codec {wire_codec!r}: dataset builds support pcm16 "
                "(default) or dpack (lossless compression, ~25% fewer "
                "wire bytes on speech) — mulaw is lossy and would bake "
                "its quantization into the dataset"
            )
        self.kind = kind
        self.fs = fs
        self.batch = int(batch)
        self.align = int(align)
        self.wire_codec = wire_codec
        self.device = torch.device(device)
        self._featurizer = featurizer(kind, self.device, fs=fs, **kw)

    @property
    def num_feats(self) -> int:
        return self._featurizer.num_feats

    def _load(self, audio) -> np.ndarray:
        if isinstance(audio, (str, bytes)):
            return read_wav(audio, sr=self.fs)[0]
        return np.asarray(audio, np.float32)

    def _pack(self, group: List[np.ndarray]):
        """One wire buffer for ``group`` -> (int16 buffer, scap or None)."""
        total = sum(len(w) for w in group)
        if self.wire_codec == "dpack":
            # scap in steps of 16 blocks, as the JAX extractor sizes it
            grain = 16 * 4096
            scap = max(grain, -(-total // grain) * grain)
            enc = wire.dpack_encode(group)
            need = 2 * self.batch + scap // 4096 + enc[2].shape[0]
            cap = -(-need // self.align) * self.align
            return wire.dpack_pack(group, cap, scap, batch=self.batch,
                                   enc=enc), scap
        cap = wire.wire_cap(self.batch, total, self.align)
        return wire.pack_audio(group, cap, batch=self.batch,
                               codec=self.wire_codec), None

    @torch.inference_mode()
    def extract_batch(self, audios: Sequence) -> List[np.ndarray]:
        """-> per-utterance [T_i, F] float32 arrays, in the input order."""
        wavs = [self._load(a) for a in audios]
        order = sorted(range(len(wavs)), key=lambda i: len(wavs[i]))
        out: List[np.ndarray] = [None] * len(wavs)  # type: ignore
        feat = self._featurizer
        for start in range(0, len(order), self.batch):
            idxs = order[start: start + self.batch]
            group = [wavs[i] for i in idxs]
            n_pad = -(-max(len(w) for w in group) // self.align) * self.align
            flat, scap = self._pack(group)
            dev_flat = torch.from_numpy(flat).to(self.device)
            w, lens = wire.unpack_audio(dev_flat, self.batch, n_pad,
                                        codec=self.wire_codec, scap=scap)
            feats, _ = feat._transform(w, lens)
            feats = feats.cpu().numpy()              # the one copy back
            n_frames = device_num_frames(
                torch.tensor([len(x) for x in group], dtype=torch.int32),
                feat.frame_len, feat.frame_step, center=feat.center,
            ).tolist() if feat.kind != "raw" else [len(x) for x in group]
            for r, i in enumerate(idxs):
                out[i] = np.ascontiguousarray(feats[r, : n_frames[r]],
                                              np.float32)
        return out

    def __call__(self, audio) -> np.ndarray:
        return self.extract_batch([audio])[0]

    def __str__(self) -> str:
        # datasets stamp str(parser) into attrs["feature"]: the kind name,
        # so eval and predict pick the matching host parser
        return self.kind
