"""What the recurrence ops (``ops/bilstm.py``, ``ops/gru.py``,
``ops/ln_lstm.py``) share around their kernels: the argument check, the
stream, the scan-previous state of a sequence and the cotangent of an
unused output."""

from __future__ import annotations

import torch


def check(name: str, gates: int, mask: torch.Tensor, xps: dict, whs: dict,
          seqs: dict, gate_vecs: dict | None = None,
          unit_vecs: dict | None = None) -> None:
    """Shapes [T, B, G*H] for ``xps``, [T, B, 1] for the mask, [H, G*H] for
    ``whs``, [T, B, H] for ``seqs``, [G*H] for ``gate_vecs`` and [H] for
    ``unit_vecs`` (dicts name -> tensor, G = ``gates``); float32, one
    device, contiguous on CUDA.  Raises ValueError."""
    first_name, first = next(iter(xps.items()))
    if first.dim() != 3 or first.shape[2] % gates:
        raise ValueError(f"{name}: {first_name} must be [T, B, {gates}H], "
                         f"got {tuple(first.shape)}")
    t_steps, batch, gh = first.shape
    hidden = gh // gates
    want = {
        **{k: (v, (t_steps, batch, gh)) for k, v in xps.items()},
        "mask": (mask, (t_steps, batch, 1)),
        **{k: (v, (hidden, gh)) for k, v in whs.items()},
        **{k: (v, (t_steps, batch, hidden)) for k, v in seqs.items()},
        **{k: (v, (gh,)) for k, v in (gate_vecs or {}).items()},
        **{k: (v, (hidden,)) for k, v in (unit_vecs or {}).items()},
    }
    for arg, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be float32, got {t.dtype}")
        if t.device != first.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, "
                             f"{first_name} on {first.device}")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {first.device}")
    if first.device.type == "cuda" and not all(
            t.is_contiguous() for t, _ in want.values()):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the kernels take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def prev(seq: torch.Tensor, reverse: bool) -> torch.Tensor:
    """The scan-previous state of every frame: t-1 for a forward walk, t+1
    for a reversed one, zero past the ends."""
    zero = seq.new_zeros((1,) + tuple(seq.shape[1:]))
    return torch.cat([seq[1:], zero]) if reverse else torch.cat(
        [zero, seq[:-1]])


def cotangent(dh, h: torch.Tensor) -> torch.Tensor:
    """The cotangent autograd hands a backward for output ``h``: zeros where
    it passes None (the output was not used), else made contiguous."""
    return torch.zeros_like(h) if dh is None else dh.contiguous()
