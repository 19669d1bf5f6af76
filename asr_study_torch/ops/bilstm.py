"""Both directions of one BLSTM layer in one launch, forward and backward:
the kernels ``csrc/bilstm_fwd.cu`` and ``csrc/bilstm_bwd.cu``, their plain
versions, and :class:`BiLSTMFunction`, the differentiable op (port of
``asr_study_tpu/ops/pallas_bilstm.py`` ``pallas_bilstm`` and its custom
VJP).

:func:`bilstm` and :func:`bilstm_bwd` launch their kernels for CUDA tensors
and take :func:`bilstm_plain` / :func:`bilstm_bwd_plain`, Python loops over
time, for CPU tensors.  Neither records an autograd graph on either device:
gradients go through :class:`BiLSTMFunction`, whose backward is
:func:`bilstm_bwd` plus one ``h_prev^T @ dxp`` matmul per direction for the
recurrent weights.
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


def _check(name: str, xp_f, xp_b, mask, wh_f, wh_b, **seqs) -> None:
    if xp_f.dim() != 3 or xp_f.shape[2] % 4:
        raise ValueError(f"{name}: xp_f must be [T, B, 4H], got "
                         f"{tuple(xp_f.shape)}")
    t_steps, batch, gh = xp_f.shape
    hidden = gh // 4
    want = {
        "xp_b": (xp_b, (t_steps, batch, gh)),
        "mask": (mask, (t_steps, batch, 1)),
        "wh_f": (wh_f, (hidden, gh)),
        "wh_b": (wh_b, (hidden, gh)),
        **{k: (v, (t_steps, batch, hidden)) for k, v in seqs.items()},
    }
    for arg, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {shape}, got "
                             f"{tuple(t.shape)}")
    for arg, t in (("xp_f", xp_f), *((k, v[0]) for k, v in want.items())):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be float32, got {t.dtype}")
        if t.device != xp_f.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, "
                             f"xp_f on {xp_f.device}")
    if xp_f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {xp_f.device}")
    if xp_f.device.type == "cuda" and not all(
            t.is_contiguous() for t in (xp_f, *(v[0] for v in want.values()))):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


def bilstm(xp_f: torch.Tensor, xp_b: torch.Tensor, mask: torch.Tensor,
           wh_f: torch.Tensor, wh_b: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One BLSTM layer's recurrence, both directions, forward only.

    xp_f, xp_b: [T, B, 4H] float32, ``x @ wx + b`` of each direction, both in
                forward time order (the reverse walk happens inside)
    mask:       [T, B, 1] float32, 1.0 on real frames
    wh_f, wh_b: [H, 4H] float32 recurrent weights, gate order i, f, g, o
    ->          (h_f, c_f, h_b, c_b), each [T, B, H] in forward time order;
                a masked frame repeats the previous state.  No autograd
                graph: :class:`BiLSTMFunction` is the differentiable form.
    """
    _check("bilstm", xp_f, xp_b, mask, wh_f, wh_b)
    if xp_f.device.type == "cpu":
        with torch.no_grad():
            return bilstm_plain(xp_f, xp_b, mask, wh_f, wh_b)
    args = (xp_f, xp_b, mask, wh_f, wh_b)
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


def _prev(seq_f: torch.Tensor, seq_b: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan-previous state of every frame: t-1 for the forward
    direction, t+1 for the reversed one, zero past the ends."""
    zero = seq_f.new_zeros((1,) + tuple(seq_f.shape[1:]))
    return torch.cat([zero, seq_f[:-1]]), torch.cat([seq_b[1:], zero])


def bilstm_bwd_plain(xp_f, xp_b, mask, wh_f, wh_b, h_f, c_f, h_b, c_b,
                     dh_f, dh_b) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`bilstm_bwd`: ``_lstm_row_bwd`` of the JAX
    package, a Python loop over time for each direction."""
    t_steps, batch, gh = xp_f.shape
    hidden = gh // 4
    hp_f, hp_b = _prev(h_f, h_b)
    cp_f, cp_b = _prev(c_f, c_b)
    outs = []
    for xp, wh, hp, cp, c, dh_out, steps in (
            (xp_f, wh_f, hp_f, cp_f, c_f, dh_f, reversed(range(t_steps))),
            (xp_b, wh_b, hp_b, cp_b, c_b, dh_b, range(t_steps))):
        dxp = torch.empty_like(xp)
        dh_next = xp.new_zeros((batch, hidden))
        dc_next = xp.new_zeros((batch, hidden))
        for t in steps:
            m = mask[t] > 0                                  # [B, 1]
            gates = xp[t] + hp[t] @ wh
            i, f, g, o = gates.chunk(4, dim=-1)
            i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                          torch.sigmoid(o))
            dh = dh_out[t] + dh_next
            tc = torch.tanh(c[t])
            dc = dc_next + dh * o * (1.0 - tc * tc)
            dpre = torch.cat([dc * g * i * (1.0 - i),
                              dc * cp[t] * f * (1.0 - f),
                              dc * i * (1.0 - g * g),
                              dh * tc * o * (1.0 - o)], dim=-1)
            dpre = torch.where(m, dpre, 0.0)
            dxp[t] = dpre
            # held frames pass h and c (and their cotangents) straight on
            dh_next = dpre @ wh.t() + torch.where(m, 0.0, dh)
            dc_next = torch.where(m, dc * f, dc_next)
        outs.append(dxp)
    return tuple(outs)


def bilstm_bwd(xp_f: torch.Tensor, xp_b: torch.Tensor, mask: torch.Tensor,
               wh_f: torch.Tensor, wh_b: torch.Tensor, h_f: torch.Tensor,
               c_f: torch.Tensor, h_b: torch.Tensor, c_b: torch.Tensor,
               dh_f: torch.Tensor, dh_b: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cotangent scans of both directions -> (dxp_f, dxp_b) [T, B, 4H].

    The first five arguments are :func:`bilstm`'s, h_* and c_* its
    outputs, dh_f and dh_b [T, B, H] the cotangents of h_f and h_b.
    dxp is zero on masked frames."""
    seqs = dict(h_f=h_f, c_f=c_f, h_b=h_b, c_b=c_b, dh_f=dh_f, dh_b=dh_b)
    _check("bilstm_bwd", xp_f, xp_b, mask, wh_f, wh_b, **seqs)
    if xp_f.device.type == "cpu":
        with torch.no_grad():
            return bilstm_bwd_plain(xp_f, xp_b, mask, wh_f, wh_b, h_f, c_f,
                                    h_b, c_b, dh_f, dh_b)
    t_steps, batch, gh = xp_f.shape
    dxp_f, dxp_b = torch.empty_like(xp_f), torch.empty_like(xp_b)
    if dxp_f.numel() == 0:
        return dxp_f, dxp_b
    wht_f, wht_b = wh_f.t().contiguous(), wh_b.t().contiguous()
    args = (xp_f, xp_b, mask, wh_f, wh_b, wht_f, wht_b, h_f, c_f, h_b, c_b,
            dh_f, dh_b, dxp_f, dxp_b)
    with torch.cuda.device(xp_f.device):
        err = _build.lib().asr_bilstm_bwd(
            *(t.data_ptr() for t in args), t_steps, batch, gh // 4,
            torch.cuda.current_stream(xp_f.device).cuda_stream,
        )
    _build.check(err, "bilstm_bwd")
    bilstm_bwd.launches += 1
    return dxp_f, dxp_b


bilstm_bwd.launches = 0


class BiLSTMFunction(torch.autograd.Function):
    """Differentiable BLSTM recurrence: ``apply(xp_f, xp_b, mask, wh_f,
    wh_b) -> (h_f, h_b)`` (the JAX ``pallas_bilstm``).

    Forward is :func:`bilstm`, keeping h and c of both directions; backward
    is :func:`bilstm_bwd` for dxp, and ``dwh = h_prev^T dxp`` over all T*B
    rows as one matmul per direction.  The mask gets no gradient."""

    @staticmethod
    def forward(ctx, xp_f, xp_b, mask, wh_f, wh_b):
        h_f, c_f, h_b, c_b = bilstm(xp_f, xp_b, mask, wh_f, wh_b)
        ctx.save_for_backward(xp_f, xp_b, mask, wh_f, wh_b, h_f, c_f, h_b,
                              c_b)
        return h_f, h_b

    @staticmethod
    def backward(ctx, dh_f, dh_b):
        xp_f, xp_b, mask, wh_f, wh_b, h_f, c_f, h_b, c_b = ctx.saved_tensors
        dh_f = torch.zeros_like(h_f) if dh_f is None else dh_f.contiguous()
        dh_b = torch.zeros_like(h_b) if dh_b is None else dh_b.contiguous()
        dxp_f, dxp_b = bilstm_bwd(xp_f, xp_b, mask, wh_f, wh_b, h_f, c_f,
                                  h_b, c_b, dh_f, dh_b)
        hp_f, hp_b = _prev(h_f, h_b)
        hidden, gh = wh_f.shape
        dwh_f = hp_f.reshape(-1, hidden).t() @ dxp_f.reshape(-1, gh)
        dwh_b = hp_b.reshape(-1, hidden).t() @ dxp_b.reshape(-1, gh)
        return dxp_f, dxp_b, None, dwh_f, dwh_b
