"""The dpack wire decode: payload bit planes -> float32 samples (port of
``asr_study_tpu/ops/pallas_dpack.py`` ``dpack_decode``; the kernel is
``csrc/dpack_onepass.cu``, one cooperative launch).

Block j of the stream owns the payload plane rows ``[row_start[j],
row_start[j] + widths[j])``, each row 256 int16 words; plane p, word m,
bit i is bit p of the block's sample 256*i + m.  Expanding the planes
gives the zigzagged deltas, un-zigzagging gives the deltas of the
concatenated batch, and their inclusive prefix sum over the whole stream
(the carry crosses blocks and utterances) wrapped to int16 gives the
samples, scaled by 1/32768.

:func:`dpack_decode` runs the plain version for tensors on the CPU and
launches the kernel once for CUDA tensors; any other device raises.
``csrc/dpack.cu`` is the retired two-launch design (per-block totals, then
the decode); no route reaches it.
"""

from __future__ import annotations

import torch

from asr_study_torch import _build

BLOCK = 4096      # samples per dpack block
PLANES = 16       # bits per word == planes at most == sample rows a block
WORDS = 256       # payload words per plane
# CTA totals the one-pass kernel's scratch holds: its grid never exceeds
# this (an H100 keeps a few hundred of its CTAs resident together)
SCRATCH_CTAS = 4096
# (device, stream) -> int32 [SCRATCH_CTAS], kept across calls: the decodes
# that share one run in order on their stream
_SCRATCH: dict = {}


def _check(payload: torch.Tensor, row_start: torch.Tensor,
           widths: torch.Tensor, scap: int) -> int:
    """Validate the arguments -> the block count."""
    if scap < 0 or scap % BLOCK:
        raise ValueError(f"scap must be a multiple of {BLOCK}, got {scap}")
    nbcap = scap // BLOCK
    if payload.dtype != torch.int16 or payload.dim() != 1:
        raise ValueError(f"dpack_decode: payload must be 1-D int16, got "
                         f"{payload.dtype} {tuple(payload.shape)}")
    for name, t in (("row_start", row_start), ("widths", widths)):
        if t.dtype != torch.int32 or t.shape != (nbcap,):
            raise ValueError(f"dpack_decode: {name} must be int32 "
                             f"[{nbcap}], got {t.dtype} {tuple(t.shape)}")
        if t.device != payload.device:
            raise ValueError(f"dpack_decode: {name} on {t.device}, payload "
                             f"on {payload.device}")
    return nbcap


def dpack_decode_plain(payload: torch.Tensor, row_start: torch.Tensor,
                       widths: torch.Tensor, scap: int) -> torch.Tensor:
    """The plain version: the torch form of the XLA decode
    (``asr_study_tpu/data/wire.py`` ``dpack_unpack``).  Gathers each
    block's 16 plane rows (rows past the block's width, and words outside
    the payload, read as 0), expands the planes, un-zigzags, and takes the
    prefix sum in int64, so it is exact without int32 overflow, before
    the int16 wrap."""
    nbcap = _check(payload, row_start, widths, scap)
    dev = payload.device
    words = payload.to(torch.int64) & 0xFFFF
    p = torch.arange(PLANES, device=dev)
    idx = ((row_start.to(torch.int64)[:, None, None] + p[None, :, None])
           * WORDS + torch.arange(WORDS, device=dev)[None, None, :])
    live = ((p[None, :, None] < widths[:, None, None].to(torch.int64))
            & (idx >= 0) & (idx < words.shape[0]))
    if words.shape[0]:
        planes = torch.where(
            live, words[idx.clamp(0, words.shape[0] - 1)], 0)
    else:
        planes = torch.zeros(idx.shape, dtype=torch.int64, device=dev)
    # u[j, i, m] = sum_p ((planes[j, p, m] >> i) & 1) << p: block sample
    # 256 i + m, so the [nbcap, 16, 256] layout is flat sample order
    u = torch.zeros((nbcap, PLANES, WORDS), dtype=torch.int64, device=dev)
    for bit in range(PLANES):
        u |= ((planes[:, bit, None, :] >> p[None, :, None]) & 1) << bit
    u = u.reshape(scap)
    d = (u >> 1) ^ -(u & 1)                          # un-zigzag
    c = torch.cumsum(d, 0)
    wrapped = ((c + 32768) & 0xFFFF) - 32768
    return wrapped.to(torch.float32) * (1.0 / 32768.0)


def dpack_decode(payload: torch.Tensor, row_start: torch.Tensor,
                 widths: torch.Tensor, scap: int) -> torch.Tensor:
    """int16 payload [P], int32 row_start and widths [scap / 4096] ->
    float32 samples [scap] in flat sample order, k / 32768.

    Past the last encoded sample the stream holds the last sample's value
    (the padding deltas are 0).  CPU tensors take
    :func:`dpack_decode_plain`; CUDA tensors launch
    ``csrc/dpack_onepass.cu`` once (each CTA's delta total, a grid barrier,
    then the scan from each CTA's carry) or raise.  The CTA totals live in
    a scratch kept per device and stream, so a call allocates only its
    output."""
    nbcap = _check(payload, row_start, widths, scap)
    if payload.device.type == "cpu":
        return dpack_decode_plain(payload, row_start, widths, scap)
    if payload.device.type != "cuda":
        raise ValueError(f"dpack_decode: no kernel for device "
                         f"{payload.device}")
    payload = payload.contiguous()
    row_start = row_start.contiguous()
    widths = widths.contiguous()
    out = torch.empty(scap, dtype=torch.float32, device=payload.device)
    if nbcap == 0:
        return out
    stream = torch.cuda.current_stream(payload.device).cuda_stream
    scratch = _SCRATCH.get((payload.device, stream))
    if scratch is None:
        scratch = _SCRATCH[payload.device, stream] = torch.empty(
            SCRATCH_CTAS, dtype=torch.int32, device=payload.device)
    with torch.cuda.device(payload.device):
        err = _build.lib().asr_dpack_decode_onepass(
            payload.data_ptr(), payload.shape[0], row_start.data_ptr(),
            widths.data_ptr(), scratch.data_ptr(), SCRATCH_CTAS,
            out.data_ptr(), nbcap, stream,
        )
    _build.check(err, "dpack_decode")
    dpack_decode.launches += 1
    return out


dpack_decode.launches = 0
