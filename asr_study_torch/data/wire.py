"""Wire formats for batches of variable-length audio (port of
``asr_study_tpu/data/wire.py``).

A batch crosses to the device as ONE flat int16 buffer::

    [ 2*B-word length header | payload ]

- header word 2i   = lengths[i] & 0x7fff      (15-bit low half)
- header word 2i+1 = lengths[i] >> 15         (high half; < 2^30 samples)
- offsets are not sent: they are the exclusive cumsum of the lengths.

Three codecs; both ends must agree on it:

- ``pcm16``: one 16-bit sample per word, lossless for PCM16.
- ``mulaw``: 8-bit mu-law companding (mu=255), two codes per word, low
  byte first, each utterance word-aligned: half the bytes, lossy.
- ``dpack``: lossless delta + per-block bit-packing.  The batch's samples
  ride as one zigzagged delta stream over the concatenated utterances,
  split into 4096-sample blocks, each stored as ``w_j`` bit planes of 256
  words (plane p, word m, bit i = bit p of block sample 256*i + m).  After
  the header come ``scap // 4096`` width words, then the planes of every
  block back to back.  ``scap``, the sample capacity, is shared by both
  ends.  Decoding is :func:`asr_study_torch.ops.dpack.dpack_decode`.

The host half (``wire_cap``, ``pack_audio``, the ``dpack_*`` encoders) is a
NumPy copy of the JAX module's, byte for byte: that module imports jax at
its top, so it cannot be shared.  The dpack encode runs, as in the JAX
module, through the port's native host library (``utils/native.py``), the
NumPy encoder its plain twin.  The device half (``unpack_audio``,
``dpack_unpack``) is torch.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from asr_study_torch.ops.dpack import BLOCK as _DPACK_BLOCK
from asr_study_torch.ops.dpack import dpack_decode

_LOW_BITS = 15
_LOW_MASK = (1 << _LOW_BITS) - 1

_MU = 255.0
_LOG1P_MU = float(np.log1p(_MU))

_DPACK_GROUP = 16                            # samples per word-aligned group
_DPACK_GPB = _DPACK_BLOCK // _DPACK_GROUP    # 256 words per plane

CODECS = ("pcm16", "mulaw", "dpack")


def _check_codec(codec: str) -> None:
    if codec not in CODECS:
        raise ValueError(f"unknown wire codec {codec!r}")


def mulaw_encode(x: np.ndarray) -> np.ndarray:
    """float waveform [-1, 1] -> int8 mu-law codes [-127, 127] (copy of
    ``asr_study_tpu.data.wire.mulaw_encode``)."""
    x = np.clip(np.asarray(x, np.float64), -1.0, 1.0)
    y = np.sign(x) * np.log1p(_MU * np.abs(x)) / _LOG1P_MU
    return np.round(y * 127.0).astype(np.int8)


def mulaw_decode(codes: torch.Tensor) -> torch.Tensor:
    """int mu-law codes -> float32 waveform (port of
    ``mulaw_decode_device``, in the same float order)."""
    y = codes.to(torch.float32) * (1.0 / 127.0)
    return torch.sign(y) * (torch.expm1(y.abs() * _LOG1P_MU) / _MU)


def quantize_pcm16(w: np.ndarray) -> np.ndarray:
    """float waveform -> int16 with round(x * 32768) saturated, the exact
    inverse of the k/32768 normalization; int16 passes through (copy of
    ``asr_study_tpu.data.wire.quantize_pcm16``)."""
    w = np.asarray(w)
    if w.dtype == np.int16:
        return w
    return np.clip(
        np.round(w.astype(np.float64) * 32768.0), -32768, 32767
    ).astype(np.int16)


def _codec_words(n_samples: int, codec: str) -> int:
    """int16 words occupied by one utterance's samples (copy of
    ``asr_study_tpu.data.wire._codec_words``)."""
    if codec == "pcm16":
        return n_samples
    if codec == "mulaw":
        return (n_samples + 1) // 2      # two 8-bit codes per word
    raise ValueError(f"unknown wire codec {codec!r}")


def wire_cap(batch: int, total_samples: int, align: int = 2048,
             codec: str = "pcm16") -> int:
    """Buffer length for ``batch`` utterances totalling ``total_samples``
    samples, rounded up to ``align`` words (pcm16 and mulaw; dpack sizes
    with :func:`dpack_measure`)."""
    if codec == "mulaw":
        # each utterance rounds up to a word boundary independently
        total_words = (total_samples + batch) // 2 + batch % 2
    else:
        total_words = _codec_words(total_samples, codec)
    cap = 2 * batch + total_words
    return -(-cap // align) * align


def pack_audio(wavs: Sequence[np.ndarray], cap: int,
               batch: int | None = None, codec: str = "pcm16",
               scap: int | None = None) -> np.ndarray:
    """Pack int16/float waveforms into one flat int16 wire buffer (copy of
    ``asr_study_tpu.data.wire.pack_audio``).

    Float inputs are quantized with round(x * 32768) saturated to
    [-32768, 32767], the exact inverse of the k/32768 normalization of
    ``read_wav`` and ``unpack_audio``; int16 passes through.  mulaw packs
    two codes a word.  ``batch`` pads the header to a fixed batch size
    (missing rows get length 0).  dpack needs ``scap``."""
    _check_codec(codec)
    if codec == "dpack":
        if scap is None:
            raise ValueError("codec='dpack' needs scap (see dpack_measure)")
        return dpack_pack(wavs, cap, scap, batch=batch)
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
        n_words = _codec_words(n, codec)
        if pos + n_words > cap:
            raise ValueError(
                f"wire overflow: need {pos + n_words}, cap {cap} "
                "(recompute wire_cap for this batch)"
            )
        flat[2 * i] = n & _LOW_MASK
        flat[2 * i + 1] = n >> _LOW_BITS
        if codec == "pcm16":
            flat[pos: pos + n] = quantize_pcm16(w)
        else:  # mulaw
            if w.dtype == np.int16:
                w = w.astype(np.float64) / 32768.0
            codes = mulaw_encode(w).astype(np.uint8)
            if n % 2:
                codes = np.concatenate([codes, np.zeros(1, np.uint8)])
            lo = codes[0::2].astype(np.uint16)
            hi = codes[1::2].astype(np.uint16)
            flat[pos: pos + n_words] = (lo | (hi << 8)).astype(np.int16)
        pos += n_words
    return flat


def _header(flat: torch.Tensor, batch: int) -> torch.Tensor:
    if flat.dtype != torch.int16 or flat.dim() != 1:
        raise ValueError(f"wire must be a 1-D int16 tensor, got "
                         f"{flat.dtype} {tuple(flat.shape)}")
    hdr = 2 * batch
    lo = flat[0:hdr:2].to(torch.int32)
    hi = flat[1:hdr:2].to(torch.int32)
    return lo + (hi << _LOW_BITS)


def _rows(stream: torch.Tensor, offsets: torch.Tensor, n: int
          ) -> torch.Tensor:
    """Row i = ``stream[offsets[i] : offsets[i] + n]`` of the stream padded
    with n zeros, the start clamped so the read stays inside (the JAX
    ``dynamic_slice`` semantics)."""
    padded = torch.cat([stream, stream.new_zeros(n)])
    start = offsets.clamp(0, padded.shape[0] - n).to(torch.int64)
    # every window of n entries as a view; indexing copies the B rows
    return padded.unfold(0, n, 1)[start]


def unpack_audio(flat: torch.Tensor, batch: int, n_pad: int,
                 codec: str = "pcm16", scap: int | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """flat int16 wire [cap] -> (float32 [batch, n_pad] wavs, int32 lengths).

    Row i holds utterance i's samples (k/32768 for pcm16 and dpack, the
    mu-law curve for mulaw) and zeros beyond its length.  Each row reads
    ``n_pad`` samples from its offset, the start clamped so the read stays
    inside the zero-padded buffer.  dpack needs ``scap``."""
    _check_codec(codec)
    if codec == "dpack":
        if scap is None:
            raise ValueError("codec='dpack' needs scap (see dpack_measure)")
        return dpack_unpack(flat, batch, n_pad, scap)
    lengths = _header(flat, batch)
    hdr = 2 * batch
    t = torch.arange(n_pad, device=flat.device)
    live = t[None, :] < lengths[:, None]
    if codec == "pcm16":
        offsets = hdr + torch.cumsum(lengths, 0, dtype=torch.int32) - lengths
        seg = _rows(flat, offsets, n_pad)
        wavs = torch.where(live, seg.to(torch.float32) * (1.0 / 32768.0),
                           0.0)
        return wavs, lengths

    # mulaw: two 8-bit codes per word, utterances word-aligned
    n_pad_words = (n_pad + 1) // 2
    words = (lengths + 1) >> 1
    offsets = hdr + torch.cumsum(words, 0, dtype=torch.int32) - words
    seg = _rows(flat, offsets, n_pad_words).to(torch.int32)
    lo_b = ((seg & 0xFF) + 128) % 256 - 128          # sign-extend int8
    hi_b = (((seg >> 8) & 0xFF) + 128) % 256 - 128
    codes = torch.stack([lo_b, hi_b], -1).reshape(batch, 2 * n_pad_words)
    wavs = torch.where(live, mulaw_decode(codes[:, :n_pad]), 0.0)
    return wavs, lengths


# ---------------------------------------------------------------------------
# dpack: lossless delta + per-block bit-packing
# ---------------------------------------------------------------------------
# Wire layout (int16 words), with B = batch, NBCAP = scap // 4096:
#   [0, 2B)            sample-length header (15-bit split, as pcm16)
#   [2B, 2B + NBCAP)   per-block bit widths w_j in 0..16, one per word
#   [2B + NBCAP, ...)  block payloads back to back; block j occupies
#                      256 * w_j words (4096 samples * w_j bits / 16)


def _dpack_deltas(wavs: Sequence[np.ndarray]) -> tuple[np.ndarray, list]:
    """Concatenated zigzagged wraparound deltas (uint32) + lengths (copy of
    ``asr_study_tpu.data.wire._dpack_deltas``)."""
    lens = [int(np.asarray(w).shape[0]) for w in wavs]
    if sum(lens) == 0:
        return np.zeros((0,), np.uint32), lens
    s = np.concatenate([quantize_pcm16(w) for w in wavs]).astype(np.int32)
    d = np.empty_like(s)
    d[0] = s[0]
    d[1:] = s[1:] - s[:-1]
    d = ((d + 32768) & 0xFFFF) - 32768   # int16 wraparound residual
    return (((d << 1) ^ (d >> 31)).astype(np.uint32)), lens


def dpack_encode(wavs: Sequence[np.ndarray], use_native: bool = True
                 ) -> tuple[list, np.ndarray, np.ndarray, int]:
    """Encode to (lengths, widths uint8 [nb], payload int16, n_samples)
    (port of ``asr_study_tpu.data.wire.dpack_encode``).

    The route is the native encoder (``native/asr_native.cc``
    ``asr_dpack_encode_v2``, through ``utils/native.py``), which raises if
    its library cannot be built; ``use_native=False`` takes the NumPy
    encoder below, its byte-identical plain twin."""
    if use_native:
        lens = [int(np.asarray(w).shape[0]) for w in wavs]
        if sum(lens):
            from asr_study_torch.utils import native

            samples = np.concatenate([quantize_pcm16(w) for w in wavs])
            widths, payload = native.dpack_encode(samples)
            return lens, widths, payload, samples.shape[0]
    u, lens = _dpack_deltas(wavs)
    n = u.shape[0]
    nb = -(-n // _DPACK_BLOCK)
    if nb == 0:
        return lens, np.zeros((0,), np.uint8), np.zeros((0,), np.int16), 0
    u = np.concatenate([u, np.zeros(nb * _DPACK_BLOCK - n, np.uint32)])
    blocks = u.reshape(nb, _DPACK_BLOCK)
    m = blocks.max(axis=1)
    # bit_length of the block max (0 for all-zero blocks)
    widths = np.zeros(nb, np.uint8)
    for b in range(1, 17):
        widths[m >= (1 << (b - 1))] = b
    word_off = _DPACK_GPB * np.concatenate(
        [[0], np.cumsum(widths.astype(np.int64))[:-1]]
    )
    payload = np.zeros(int(_DPACK_GPB * widths.astype(np.int64).sum()),
                       np.uint16)
    shift16 = (1 << np.arange(_DPACK_GROUP, dtype=np.uint32))
    for w in range(1, 17):
        sel = np.nonzero(widths == w)[0]
        if sel.size == 0:
            continue
        # bit planes: plane p, word m, bit i = bit p of sample 256i+m
        v = blocks[sel].reshape(-1, _DPACK_GROUP, _DPACK_GPB)  # [K, i, m]
        bits = ((v[..., None] >> np.arange(w, dtype=np.uint32)) & 1)
        planes = (
            bits.astype(np.uint32) * shift16[None, :, None, None]
        ).sum(1)                                     # [K, 256, w]
        words = planes.transpose(0, 2, 1).astype(np.uint16)  # [K, w, 256]
        idx = (
            word_off[sel][:, None]
            + np.arange(_DPACK_GPB * w, dtype=np.int64)[None, :]
        ).ravel()
        payload[idx] = words.reshape(sel.size, -1).ravel()
    return lens, widths, payload.view(np.int16), n


def dpack_pack(wavs: Sequence[np.ndarray], cap: int, scap: int,
               batch: int | None = None, enc=None) -> np.ndarray:
    """Pack with the dpack codec into a [cap] int16 buffer (copy of
    ``asr_study_tpu.data.wire.dpack_pack``).  ``enc`` passes
    ``dpack_encode(wavs)``'s result, so a caller that already encoded
    does not encode again."""
    if scap % _DPACK_BLOCK:
        raise ValueError(f"scap must be a multiple of {_DPACK_BLOCK}")
    b = batch if batch is not None else len(wavs)
    if len(wavs) > b:
        raise ValueError(f"{len(wavs)} wavs > batch {b}")
    lens, widths, payload, n = enc if enc is not None else dpack_encode(wavs)
    nbcap = scap // _DPACK_BLOCK
    if widths.shape[0] > nbcap:
        raise ValueError(
            f"dpack overflow: {n} samples need {widths.shape[0]} blocks, "
            f"scap {scap} holds {nbcap} (recompute dpack_measure)"
        )
    need = 2 * b + nbcap + payload.shape[0]
    if need > cap:
        raise ValueError(
            f"wire overflow: need {need}, cap {cap} "
            "(recompute dpack_measure for this batch)"
        )
    flat = np.zeros((cap,), np.int16)
    for i, ln in enumerate(lens):
        if ln >= 1 << 30:
            raise ValueError(f"utterance {i} too long for wire: {ln}")
        flat[2 * i] = ln & _LOW_MASK
        flat[2 * i + 1] = ln >> _LOW_BITS
    flat[2 * b: 2 * b + widths.shape[0]] = widths.astype(np.int16)
    flat[2 * b + nbcap: need] = payload
    return flat


def dpack_measure(groups: Sequence[Sequence[np.ndarray]], batch: int,
                  align: int = 2048) -> tuple[int, int]:
    """Shared (cap, scap) for every group (copy of
    ``asr_study_tpu.data.wire.dpack_measure``)."""
    scap = _DPACK_BLOCK
    words = 2 * batch
    for g in groups:
        n = sum(int(np.asarray(w).shape[0]) for w in g)
        scap = max(scap, -(-n // _DPACK_BLOCK) * _DPACK_BLOCK)
        _, widths, payload, _ = dpack_encode(g)
        words = max(words, 2 * batch + payload.shape[0])
    cap = -(-(words + scap // _DPACK_BLOCK) // align) * align
    return cap, scap


def dpack_regions(flat: torch.Tensor, batch: int, scap: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A dpack wire's decode arguments: (payload int16, row_start int32,
    widths int32).  Block j's planes start at row ``row_start[j]`` of the
    payload, the exclusive cumsum of the widths."""
    nbcap = scap // _DPACK_BLOCK
    hdr = 2 * batch
    if flat.shape[0] < hdr + nbcap:
        raise ValueError(f"dpack wire of {flat.shape[0]} words is shorter "
                         f"than its header and widths ({hdr + nbcap})")
    widths = flat[hdr: hdr + nbcap].to(torch.int32)
    row_start = torch.cumsum(widths, 0, dtype=torch.int32) - widths
    return flat[hdr + nbcap:], row_start, widths


def dpack_unpack(flat: torch.Tensor, batch: int, n_pad: int, scap: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """dpack wire -> (float32 [batch, n_pad] wavs, int32 lengths), equal to
    the pcm16 path's for the same audio.

    :func:`dpack_regions` cuts the wire; :func:`dpack_decode` turns the
    payload into the flat [scap]
    sample stream; row i is cut at the exclusive cumsum of the lengths (no
    header offset: the stream holds samples only) and masked past its
    length."""
    if scap % _DPACK_BLOCK:
        raise ValueError(f"scap must be a multiple of {_DPACK_BLOCK}")
    lengths = _header(flat, batch)
    samples = dpack_decode(*dpack_regions(flat, batch, scap), scap)
    offsets = torch.cumsum(lengths, 0, dtype=torch.int32) - lengths
    seg = _rows(samples, offsets, n_pad)
    t = torch.arange(n_pad, device=flat.device)
    wavs = torch.where(t[None, :] < lengths[:, None], seg, 0.0)
    return wavs, lengths


def probe_link(device: torch.device | str, size_mb: float = 4.0) -> float:
    """Host->device bandwidth estimate in MB/s (port of
    ``asr_study_tpu.data.wire.probe_link``).

    Times a copy to ``device`` plus a one-element read back, which
    synchronises, for a small and a large buffer and takes the
    difference, so the per-copy setup does not count as bandwidth; each
    size takes the min of 3 round trips.  A selection probe for
    :func:`choose_codec`, not a benchmark.  ``inf`` when the difference is
    below the timer's resolution (on the CPU the copy is a no-op)."""
    device = torch.device(device)

    def rt(n_bytes: int, rounds: int = 3) -> float:
        buf = torch.from_numpy(np.zeros(n_bytes // 2, np.int16))
        best = float("inf")
        for _ in range(rounds):
            t0 = time.perf_counter()
            dev = buf.to(device)
            dev[:1].cpu()            # the read back is the sync
            best = min(best, time.perf_counter() - t0)
        return best

    small = 1 << 16
    large = max(int(size_mb * 2**20), 4 * small)
    rt(small, rounds=1)              # warm the copy path
    dt = rt(large) - rt(small)
    if dt <= 0:                      # noise won anyway: one more attempt
        dt = rt(large) - rt(small)
    if dt <= 0:                      # below timer/setup resolution
        return float("inf")
    return (large - small) / dt / 2**20


def choose_codec(bandwidth_mbps: float) -> str:
    """The serving wire codec for a link of ``bandwidth_mbps`` (see
    :func:`probe_link`; port of ``asr_study_tpu.data.wire.choose_codec``):
    dpack below 1000 MB/s, where its ~12% fewer bytes outrun the decode,
    else pcm16."""
    return "dpack" if bandwidth_mbps < 1000.0 else "pcm16"
