"""pcm16 wire format for batches of variable-length audio (port of
``asr_study_tpu/data/wire.py``).

A batch crosses to the device as ONE flat int16 buffer::

    [ 2*B-word length header | utt0 samples | utt1 samples | ... ]

- header word 2i   = lengths[i] & 0x7fff      (15-bit low half)
- header word 2i+1 = lengths[i] >> 15         (high half; < 2^30 samples)
- offsets are not sent: they are the exclusive cumsum of the lengths.

The host half (``wire_cap``, ``pack_audio``) is a numpy copy of the JAX
module's pcm16 branch, byte for byte: that module imports jax at its top,
so it cannot be shared.  The device half (``unpack_audio``) is torch.
The mulaw and dpack codecs are not ported yet (ROADMAP A4, B15).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_LOW_BITS = 15
_LOW_MASK = (1 << _LOW_BITS) - 1

CODECS = ("pcm16",)


def _check_codec(codec: str) -> None:
    if codec in ("mulaw", "dpack"):
        raise NotImplementedError(
            f"wire codec {codec!r} is not ported to asr_study_torch yet "
            "(ROADMAP queue A item 4; dpack's kernel is queue B item 15)"
        )
    if codec not in CODECS:
        raise ValueError(f"unknown wire codec {codec!r}")


def wire_cap(batch: int, total_samples: int, align: int = 2048,
             codec: str = "pcm16") -> int:
    """Buffer length for ``batch`` utterances totalling ``total_samples``
    samples, rounded up to ``align`` words."""
    _check_codec(codec)
    cap = 2 * batch + total_samples
    return -(-cap // align) * align


def pack_audio(wavs: Sequence[np.ndarray], cap: int,
               batch: int | None = None, codec: str = "pcm16") -> np.ndarray:
    """Pack int16/float waveforms into one flat int16 wire buffer.

    Float inputs are quantized with round(x * 32768) saturated to
    [-32768, 32767], the exact inverse of the k/32768 normalization of
    ``read_wav`` and ``unpack_audio``; int16 passes through.  ``batch``
    pads the header to a fixed batch size (missing rows get length 0)."""
    _check_codec(codec)
    b = batch if batch is not None else len(wavs)
    if len(wavs) > b:
        raise ValueError(f"{len(wavs)} wavs > batch {b}")
    flat = np.zeros((cap,), np.int16)
    pos = 2 * b
    for i, w in enumerate(wavs):
        w = np.asarray(w)
        n = w.shape[0]
        if n >= 1 << 30:
            raise ValueError(f"utterance {i} too long for wire: {n}")
        if pos + n > cap:
            raise ValueError(
                f"wire overflow: need {pos + n}, cap {cap} "
                "(recompute wire_cap for this batch)"
            )
        flat[2 * i] = n & _LOW_MASK
        flat[2 * i + 1] = n >> _LOW_BITS
        if w.dtype != np.int16:
            w = np.clip(
                np.round(w.astype(np.float64) * 32768.0), -32768, 32767
            ).astype(np.int16)
        flat[pos: pos + n] = w
        pos += n
    return flat


def unpack_audio(flat: torch.Tensor, batch: int, n_pad: int,
                 codec: str = "pcm16"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """flat int16 wire [cap] -> (float32 [batch, n_pad] wavs, int32 lengths).

    Row i holds samples k/32768 of utterance i and zeros beyond its
    length.  Each row reads ``n_pad`` words from its offset, the start
    clamped so the read stays inside the zero-padded buffer (the JAX
    ``dynamic_slice`` semantics)."""
    _check_codec(codec)
    if flat.dtype != torch.int16 or flat.dim() != 1:
        raise ValueError(f"wire must be a 1-D int16 tensor, got "
                         f"{flat.dtype} {tuple(flat.shape)}")
    hdr = 2 * batch
    lo = flat[0:hdr:2].to(torch.int32)
    hi = flat[1:hdr:2].to(torch.int32)
    lengths = lo + (hi << _LOW_BITS)
    offsets = hdr + torch.cumsum(lengths, 0, dtype=torch.int32) - lengths
    padded = torch.cat([flat, flat.new_zeros(n_pad)])
    start = offsets.clamp(0, padded.shape[0] - n_pad).to(torch.int64)
    t = torch.arange(n_pad, device=flat.device)
    # every window of n_pad words as a view; indexing copies the B rows
    seg = padded.unfold(0, n_pad, 1)[start]
    wavs = torch.where(
        t[None, :] < lengths[:, None],
        seg.to(torch.float32) * (1.0 / 32768.0),
        0.0,
    )
    return wavs, lengths
