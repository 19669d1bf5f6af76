"""Both directions of one BLSTM layer in one launch: the kernel
``csrc/bilstm_fwd.cu`` and its plain version (port of
``asr_study_tpu/ops/pallas_bilstm.py`` ``pallas_bilstm``, forward only).

:func:`bilstm` launches the kernel for CUDA tensors and takes
:func:`bilstm_plain`, a Python loop over time on ``lstm_step`` for both
directions, for CPU tensors.  The backward kernel is ROADMAP queue B item 2;
until it lands the CUDA path refuses inputs that require a gradient.
"""

from __future__ import annotations

import torch

from asr_study_torch import _build
from asr_study_torch.models.cells import lstm_step


def bilstm_plain(xp_f: torch.Tensor, xp_b: torch.Tensor, mask: torch.Tensor,
                 wh_f: torch.Tensor, wh_b: torch.Tensor
                 ) -> tuple[torch.Tensor, ...]:
    """Plain version of the kernel; same arguments and results as
    :func:`bilstm`."""
    t_steps, batch, gh = xp_f.shape
    hidden = gh // 4
    outs = []
    for xp, wh, steps in ((xp_f, wh_f, range(t_steps)),
                          (xp_b, wh_b, reversed(range(t_steps)))):
        h = xp.new_zeros((batch, hidden))
        c = xp.new_zeros((batch, hidden))
        hs = [None] * t_steps
        cs = [None] * t_steps
        for t in steps:
            h, c = lstm_step(h, c, xp[t], mask[t], wh)
            hs[t], cs[t] = h, c
        empty = xp.new_zeros((0, batch, hidden))
        outs += [torch.stack(hs) if hs else empty,
                 torch.stack(cs) if cs else empty]
    return tuple(outs)


def _check(xp_f, xp_b, mask, wh_f, wh_b) -> None:
    if xp_f.dim() != 3 or xp_f.shape[2] % 4:
        raise ValueError(f"bilstm: xp_f must be [T, B, 4H], got "
                         f"{tuple(xp_f.shape)}")
    t_steps, batch, gh = xp_f.shape
    hidden = gh // 4
    want = {
        "xp_b": (xp_b, (t_steps, batch, gh)),
        "mask": (mask, (t_steps, batch, 1)),
        "wh_f": (wh_f, (hidden, gh)),
        "wh_b": (wh_b, (hidden, gh)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"bilstm: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("xp_f", xp_f), *((k, v[0]) for k, v in want.items())):
        if t.dtype != torch.float32:
            raise ValueError(f"bilstm: {name} must be float32, got {t.dtype}")
        if t.device != xp_f.device:
            raise ValueError(f"bilstm: {name} is on {t.device}, "
                             f"xp_f on {xp_f.device}")


def bilstm(xp_f: torch.Tensor, xp_b: torch.Tensor, mask: torch.Tensor,
           wh_f: torch.Tensor, wh_b: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One BLSTM layer's recurrence, both directions.

    xp_f, xp_b: [T, B, 4H] float32, ``x @ wx + b`` of each direction, both in
                forward time order (the reverse walk happens inside)
    mask:       [T, B, 1] float32, 1.0 on real frames
    wh_f, wh_b: [H, 4H] float32 recurrent weights, gate order i, f, g, o
    ->          (h_f, c_f, h_b, c_b), each [T, B, H] in forward time order;
                a masked frame repeats the previous state
    """
    _check(xp_f, xp_b, mask, wh_f, wh_b)
    if xp_f.device.type == "cpu":
        return bilstm_plain(xp_f, xp_b, mask, wh_f, wh_b)
    if xp_f.device.type != "cuda":
        raise ValueError(f"bilstm: no kernel for device {xp_f.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xp_f, xp_b, wh_f, wh_b)):
        raise ValueError("bilstm: the CUDA kernel has no backward yet "
                         "(ROADMAP queue B item 2)")
    args = (xp_f, xp_b, mask, wh_f, wh_b)
    if not all(t.is_contiguous() for t in args):
        raise ValueError("bilstm: the kernel takes contiguous tensors")
    t_steps, batch, gh = xp_f.shape
    hidden = gh // 4
    outs = tuple(torch.empty((t_steps, batch, hidden), dtype=torch.float32,
                             device=xp_f.device) for _ in range(4))
    if t_steps == 0 or batch == 0 or hidden == 0:
        return outs
    with torch.cuda.device(xp_f.device):
        err = _build.lib().asr_bilstm_fwd(
            *(t.data_ptr() for t in args), *(t.data_ptr() for t in outs),
            t_steps, batch, hidden,
            torch.cuda.current_stream(xp_f.device).cuda_stream,
        )
    _build.check(err, "bilstm_fwd")
    bilstm.launches += 1
    return outs


bilstm.launches = 0
