"""The LSTM recurrence, forward and backward, in both of the JAX package's
forms: both directions of a bidirectional layer in one launch (port of
``asr_study_tpu/ops/pallas_bilstm.py`` ``pallas_bilstm``) and one direction
(port of ``asr_study_tpu/ops/pallas_lstm.py`` ``pallas_lstm``), each with its
custom VJP.

Two designs of the kernels, each taking the number of directions, so
:func:`bilstm` and :func:`lstm` launch the same forward kernel with 2 and 1
directions, and :func:`bilstm_bwd` and :func:`lstm_bwd` the same backward:

- ``cluster``: ``csrc/bilstm_fwd.cu`` and ``csrc/bilstm_bwd.cu``, the
  recurrent weights resident in a thread-block cluster (its threads'
  registers, and for the backward its shared memory too) for the whole
  sequence, h exchanged through distributed shared memory;
- ``stream``: ``csrc/lstm_stream_fwd.cu`` and ``csrc/lstm_stream_bwd.cu``,
  one block per (direction, 4 rows) streaming ``wh`` from L2 every step,
  for the widths whose weights do not fit in a cluster (H=512).

:func:`lstm_geometry` picks the design by size alone; a failed build or
launch raises either way.  Each of the four wrappers counts its own
launches, in all and by design (``launches``, ``by_design``).  A CUDA
tensor launches a kernel (or raises); a CPU tensor takes the plain version,
a Python loop over time.  Neither records an autograd graph: gradients go
through :class:`BiLSTMFunction` and :class:`LSTMFunction`, whose backward is
the backward kernel plus one ``h_prev^T @ dxp`` matmul per direction for
the recurrent weights.

Gate order i, f, g, o with the bias folded into ``xp``.  Masked frames hold
h and c.
"""

from __future__ import annotations

import torch

from asr_study_torch import _build
from asr_study_torch.models.cells import lstm_step
from asr_study_torch.ops.recurrence import (STREAM_ROWS, Geometry, check,
                                            cluster_geometry, cotangent,
                                            kernel_info, prev, r4, stream)

# The cluster kernels' thread shape (csrc/bilstm_{fwd,bwd}.cu kThreads and
# kSlice): 256 threads a CTA, each holding 128 rows of one gate column.
CLUSTER_THREADS = 256
CLUSTER_SLICE = 128


def cluster_smem(hidden: int, units: int, rows: int, ctas: int
                 ) -> tuple[int, int]:
    """Dynamic shared memory per CTA of the cluster forward and backward,
    bytes: ``FwdLayout`` and ``BwdLayout`` of ``csrc/bilstm_{fwd,bwd}.cu``.
    """
    gc, hp = 4 * units, r4(hidden)
    ks = -(-hidden // CLUSTER_SLICE)           # slices of the reduction
    hs = ks * CLUSTER_SLICE                    # h rows padded to slices
    ws = r4(hp * (gc + 1))                     # the backward's weight copy
    fwd = (2 * rows * hs + 2 * rows * gc + r4(2 * rows) + ks * rows * gc
           + r4(rows * units))
    bwd = (ws + 2 * rows * hs + 2 * rows * gc + 3 * r4(2 * rows * units)
           + r4(2 * rows) + ks * rows * gc + rows * gc
           + r4(2 * ctas * rows * units) + 2 * r4(rows * units))
    return 4 * fwd, 4 * bwd


def stream_smem(hidden: int) -> tuple[int, int]:
    """Dynamic shared memory per block of the stream forward and backward,
    bytes, by the formulas of ``csrc/lstm_stream_{fwd,bwd}.cu``."""
    gates = 4 * hidden
    threads = min(-(-gates // 32) * 32, 1024)
    nsplit = max(threads // hidden, 1)
    return (4 * STREAM_ROWS * (2 * hidden + gates),
            4 * STREAM_ROWS * ((3 + nsplit) * hidden + gates))


def lstm_geometry(hidden: int, batch: int, ndir: int) -> Geometry:
    """The design and layout of the LSTM kernels for width ``hidden``,
    ``batch`` rows and ``ndir`` directions.

    ``cluster`` where :func:`~asr_study_torch.ops.recurrence.cluster_geometry`
    fits four gate columns a unit (H=256 and H=100 up to B=48 in two
    directions and B=96 in one: every width of the zoo but deep_speech's);
    ``stream`` otherwise (H=512: a CTA's 256 columns of 512 rows would take
    512 threads of 256 registers)."""
    return (cluster_geometry(hidden, batch, ndir, 4, CLUSTER_THREADS,
                             CLUSTER_SLICE, cluster_smem)
            or stream_geometry(hidden, batch, ndir))


def stream_geometry(hidden: int, batch: int, ndir: int) -> Geometry:
    """The stream design's layout, at any width: the one
    :func:`lstm_geometry` gives where the cluster design does not fit."""
    fwd, bwd = stream_smem(hidden)
    return Geometry("stream", 1, hidden, STREAM_ROWS,
                    (1, -(-batch // STREAM_ROWS), ndir), fwd, bwd)


def cluster_info(geo: Geometry, batch: int, hidden: int, backward: bool
                 ) -> tuple[int, int]:
    """On the card: (dynamic shared memory per CTA the kernel sizes, clusters
    of this launch the card holds at once), from the kernel's own launch
    configuration (``asr_bilstm_{fwd,bwd}_info``)."""
    return kernel_info("bilstm_bwd_info" if backward else "bilstm_fwd_info",
                       geo, batch, hidden)


def _scan(xp: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
          reverse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One direction's h and c sequences [T, B, H] in forward time order."""
    t_steps, batch, gh = xp.shape
    h = xp.new_zeros((batch, gh // 4))
    c = xp.new_zeros((batch, gh // 4))
    hs = [None] * t_steps
    cs = [None] * t_steps
    for t in (reversed(range(t_steps)) if reverse else range(t_steps)):
        h, c = lstm_step(h, c, xp[t], mask[t], wh)
        hs[t], cs[t] = h, c
    if not hs:
        empty = xp.new_zeros((0, batch, gh // 4))
        return empty, empty.clone()
    return torch.stack(hs), torch.stack(cs)


def bilstm_plain(xp_f: torch.Tensor, xp_b: torch.Tensor, mask: torch.Tensor,
                 wh_f: torch.Tensor, wh_b: torch.Tensor
                 ) -> tuple[torch.Tensor, ...]:
    """Plain version of the kernel; same arguments and results as
    :func:`bilstm`."""
    return (*_scan(xp_f, mask, wh_f, False), *_scan(xp_b, mask, wh_b, True))


def lstm_plain(xp: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`lstm`; same arguments and results."""
    return _scan(xp, mask, wh, False)


def _geometry(xp: torch.Tensor, ndir: int) -> Geometry:
    return lstm_geometry(xp.shape[2] // 4, xp.shape[1], ndir)


def launch_fwd(geo: Geometry, xps: list, mask: torch.Tensor,
               whs: list) -> list:
    """Launch the forward over ``len(xps)`` directions (the second one walks
    time backward) in the design and layout ``geo`` -> [h, c] per
    direction, flattened.  The wrappers count the launches."""
    t_steps, batch, gh = xps[0].shape
    hidden, ndir = gh // 4, len(xps)
    outs = [torch.empty((t_steps, batch, hidden), dtype=torch.float32,
                        device=xps[0].device) for _ in range(2 * ndir)]
    if outs[0].numel() == 0:
        return outs
    ptrs = (xps[0].data_ptr(), xps[-1].data_ptr(), mask.data_ptr(),
            whs[0].data_ptr(), whs[-1].data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), outs[-2].data_ptr(), outs[-1].data_ptr(),
            t_steps, batch, hidden, ndir)
    with torch.cuda.device(xps[0].device):
        if geo.design == "cluster":
            err = _build.lib().asr_bilstm_fwd(
                *ptrs, geo.ctas, geo.units, geo.rows, stream(xps[0]))
        else:
            err = _build.lib().asr_lstm_stream_fwd(*ptrs, stream(xps[0]))
    _build.check(err, f"{'bilstm' if ndir == 2 else 'lstm'}_fwd "
                      f"({geo.design})")
    return outs


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
    check("bilstm", 4, mask, dict(xp_f=xp_f, xp_b=xp_b),
          dict(wh_f=wh_f, wh_b=wh_b), {})
    if xp_f.device.type == "cpu":
        with torch.no_grad():
            return bilstm_plain(xp_f, xp_b, mask, wh_f, wh_b)
    geo = _geometry(xp_f, 2)
    outs = launch_fwd(geo, [xp_f, xp_b], mask, [wh_f, wh_b])
    bilstm.launches += 1
    bilstm.by_design[geo.design] += 1
    return tuple(outs)


bilstm.launches = 0
bilstm.by_design = {"cluster": 0, "stream": 0}


def lstm(xp: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """One unidirectional LSTM layer's recurrence, forward only: xp [T, B,
    4H], mask [T, B, 1], wh [H, 4H] -> (h, c), each [T, B, H] (see
    :func:`bilstm`).  :class:`LSTMFunction` is the differentiable form."""
    check("lstm", 4, mask, dict(xp=xp), dict(wh=wh), {})
    if xp.device.type == "cpu":
        with torch.no_grad():
            return lstm_plain(xp, mask, wh)
    geo = _geometry(xp, 1)
    h, c = launch_fwd(geo, [xp], mask, [wh])
    lstm.launches += 1
    lstm.by_design[geo.design] += 1
    return h, c


lstm.launches = 0
lstm.by_design = {"cluster": 0, "stream": 0}


def _walk_bwd(xp, mask, wh, h, c, dh_out, reverse: bool) -> torch.Tensor:
    """One direction's cotangent walk (``_lstm_row_bwd`` of the JAX
    package), from the end of its own time order back -> dxp."""
    t_steps, batch, gh = xp.shape
    hp, cp = prev(h, reverse), prev(c, reverse)
    dxp = torch.empty_like(xp)
    dh_next = xp.new_zeros((batch, gh // 4))
    dc_next = xp.new_zeros((batch, gh // 4))
    for t in (range(t_steps) if reverse else reversed(range(t_steps))):
        m = mask[t] > 0                                      # [B, 1]
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
    return dxp


def bilstm_bwd_plain(xp_f, xp_b, mask, wh_f, wh_b, h_f, c_f, h_b, c_b,
                     dh_f, dh_b) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`bilstm_bwd`."""
    return (_walk_bwd(xp_f, mask, wh_f, h_f, c_f, dh_f, False),
            _walk_bwd(xp_b, mask, wh_b, h_b, c_b, dh_b, True))


def lstm_bwd_plain(xp, mask, wh, h, c, dh) -> torch.Tensor:
    """Plain version of :func:`lstm_bwd`."""
    return _walk_bwd(xp, mask, wh, h, c, dh, False)


def launch_bwd(geo: Geometry, xps: list, mask: torch.Tensor, whs: list,
               hs: list, cs: list, dhs: list) -> list:
    """Launch the backward over ``len(xps)`` directions in the design and
    layout ``geo`` -> dxp per direction.  The wrappers count the
    launches."""
    outs = [torch.empty_like(x) for x in xps]
    if outs[0].numel() == 0:
        return outs
    t_steps, batch, gh = xps[0].shape
    hidden, ndir = gh // 4, len(xps)
    with torch.cuda.device(xps[0].device):
        if geo.design == "cluster":
            args = (xps[0], xps[-1], mask, whs[0], whs[-1], hs[0], cs[0],
                    hs[-1], cs[-1], dhs[0], dhs[-1], outs[0], outs[-1])
            err = _build.lib().asr_bilstm_bwd(
                *(t.data_ptr() for t in args), t_steps, batch, hidden, ndir,
                geo.ctas, geo.units, geo.rows, stream(xps[0]))
        else:
            whts = [w.t().contiguous() for w in whs]
            args = (xps[0], xps[-1], mask, whs[0], whs[-1], whts[0],
                    whts[-1], hs[0], cs[0], hs[-1], cs[-1], dhs[0], dhs[-1],
                    outs[0], outs[-1])
            err = _build.lib().asr_lstm_stream_bwd(
                *(t.data_ptr() for t in args), t_steps, batch, hidden, ndir,
                stream(xps[0]))
    _build.check(err, f"{'bilstm' if ndir == 2 else 'lstm'}_bwd "
                      f"({geo.design})")
    return outs


def bilstm_bwd(xp_f: torch.Tensor, xp_b: torch.Tensor, mask: torch.Tensor,
               wh_f: torch.Tensor, wh_b: torch.Tensor, h_f: torch.Tensor,
               c_f: torch.Tensor, h_b: torch.Tensor, c_b: torch.Tensor,
               dh_f: torch.Tensor, dh_b: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cotangent scans of both directions -> (dxp_f, dxp_b) [T, B, 4H].

    The first five arguments are :func:`bilstm`'s, h_* and c_* its
    outputs, dh_f and dh_b [T, B, H] the cotangents of h_f and h_b.
    dxp is zero on masked frames."""
    check("bilstm_bwd", 4, mask, dict(xp_f=xp_f, xp_b=xp_b),
          dict(wh_f=wh_f, wh_b=wh_b),
          dict(h_f=h_f, c_f=c_f, h_b=h_b, c_b=c_b, dh_f=dh_f, dh_b=dh_b))
    if xp_f.device.type == "cpu":
        with torch.no_grad():
            return bilstm_bwd_plain(xp_f, xp_b, mask, wh_f, wh_b, h_f, c_f,
                                    h_b, c_b, dh_f, dh_b)
    geo = _geometry(xp_f, 2)
    dxp_f, dxp_b = launch_bwd(geo, [xp_f, xp_b], mask, [wh_f, wh_b],
                              [h_f, h_b], [c_f, c_b], [dh_f, dh_b])
    bilstm_bwd.launches += 1
    bilstm_bwd.by_design[geo.design] += 1
    return dxp_f, dxp_b


bilstm_bwd.launches = 0
bilstm_bwd.by_design = {"cluster": 0, "stream": 0}


def lstm_bwd(xp: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
             h: torch.Tensor, c: torch.Tensor, dh: torch.Tensor
             ) -> torch.Tensor:
    """The cotangent scan of :func:`lstm` -> dxp [T, B, 4H], as in
    :func:`bilstm_bwd` for one direction."""
    check("lstm_bwd", 4, mask, dict(xp=xp), dict(wh=wh),
          dict(h=h, c=c, dh=dh))
    if xp.device.type == "cpu":
        with torch.no_grad():
            return lstm_bwd_plain(xp, mask, wh, h, c, dh)
    geo = _geometry(xp, 1)
    (dxp,) = launch_bwd(geo, [xp], mask, [wh], [h], [c], [dh])
    lstm_bwd.launches += 1
    lstm_bwd.by_design[geo.design] += 1
    return dxp


lstm_bwd.launches = 0
lstm_bwd.by_design = {"cluster": 0, "stream": 0}


def _dwh(h: torch.Tensor, dxp: torch.Tensor, reverse: bool) -> torch.Tensor:
    """``h_prev^T dxp`` over all T*B rows: one matmul (as
    ``pallas_lstm.py``'s einsum)."""
    hidden = h.shape[-1]
    return prev(h, reverse).reshape(-1, hidden).t() @ dxp.reshape(
        -1, 4 * hidden)


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
        dxp_f, dxp_b = bilstm_bwd(xp_f, xp_b, mask, wh_f, wh_b, h_f, c_f,
                                  h_b, c_b, cotangent(dh_f, h_f),
                                  cotangent(dh_b, h_b))
        return (dxp_f, dxp_b, None, _dwh(h_f, dxp_f, False),
                _dwh(h_b, dxp_b, True))


class LSTMFunction(torch.autograd.Function):
    """Differentiable unidirectional LSTM recurrence: ``apply(xp, mask, wh)
    -> h`` (the JAX ``pallas_lstm``).  Forward is :func:`lstm`, keeping h
    and c; backward is :func:`lstm_bwd` and ``dwh = h_prev^T dxp``.  The
    mask gets no gradient."""

    @staticmethod
    def forward(ctx, xp, mask, wh):
        h, c = lstm(xp, mask, wh)
        ctx.save_for_backward(xp, mask, wh, h, c)
        return h

    @staticmethod
    def backward(ctx, dh):
        xp, mask, wh, h, c = ctx.saved_tensors
        dxp = lstm_bwd(xp, mask, wh, h, c, cotangent(dh, h))
        return dxp, None, _dwh(h, dxp, False)
