"""The LSTM recurrence, forward and backward, in both of the JAX package's
forms: both directions of a bidirectional layer in one launch (port of
``asr_study_tpu/ops/pallas_bilstm.py`` ``pallas_bilstm``) and one direction
(port of ``asr_study_tpu/ops/pallas_lstm.py`` ``pallas_lstm``), each with its
custom VJP.

Three designs of the kernels, each taking the number of directions, so
:func:`bilstm` and :func:`lstm` launch the same forward kernel with 2 and 1
directions, and :func:`bilstm_bwd` and :func:`lstm_bwd` the same backward:

- ``cluster`` (H <= 256): ``csrc/bilstm_fwd.cu`` and ``csrc/bilstm_bwd.cu``,
  the recurrent weights resident in a thread-block cluster of 8 CTAs (its
  threads' registers, and for the backward its shared memory too) for the
  whole sequence, h exchanged through distributed shared memory;
- ``wide`` (256 < H <= 512, deep_speech's BLSTM): ``csrc/lstm_wide_fwd.cu``
  and ``csrc/lstm_wide_bwd.cu``, the weights resident in a non-portable
  cluster of up to 16 CTAs, each CTA's slice half in registers and half in
  shared memory.  The backward holds the slice once, for ``dpre @ wh^T``,
  and reads the four activated gates of every frame, which the forward
  writes when the layer trains, in place of recomputing them;
- ``stream``: ``csrc/lstm_stream_fwd.cu`` and ``csrc/lstm_stream_bwd.cu``,
  one block per (direction, 4 rows) streaming ``wh`` from L2 every step,
  for the shapes no cluster design takes.

:func:`lstm_geometry` picks the design by size alone; a failed build,
launch or residency check raises in every design.  Each of the four
wrappers counts its own launches, in all and by design (``launches``,
``by_design``).  A CUDA tensor launches a kernel (or raises); a CPU tensor
takes the plain version, a Python loop over time, in the same wiring (the
wide design's saved gates included).  Which design runs is this module's
concern alone: the forward called with ``residual=True`` returns, besides
h and c, an opaque ``res`` that the backward takes back whatever the
design (the gates where the wide design runs, nothing elsewhere).  Neither records an autograd graph:
gradients go through :class:`BiLSTMFunction` and :class:`LSTMFunction`,
whose backward is the backward kernel plus one ``h_prev^T @ dxp`` matmul
per direction for the recurrent weights.

bfloat16 weights (``train --bf16``, the JAX trainer's ``compute_dtype``):
``wh`` may be bfloat16 in every wrapper, both directions alike, while xp,
the mask, h, c and every cotangent stay float32.  Every design then
launches its bfloat16-weight form (the same sources, the ``_bf16`` entry
points): h_prev is rounded to bfloat16 where it enters the product (and
only there: the state update and a held frame take it unrounded) and the
backward rounds ``dpre`` before ``dpre @ wh^T``, as the JAX kernels'
``_mm`` does, each product taken in float32; dxp comes out unrounded.
The plain twins round the same way
(:func:`~asr_study_torch.models.nn.dot`), and ``dwh`` comes back
bfloat16.  No bfloat16 call takes a float32 form; ``by_design`` counts
bfloat16 launches under ``cluster_bf16``, ``wide_bf16`` and
``stream_bf16``.

Gate order i, f, g, o with the bias folded into ``xp``.  Masked frames hold
h and c.  :func:`lstm` and its plain twin start from a carried state
``h0``, ``c0`` [B, H] where given (zeros elsewhere, as every bidirectional
and whole-sequence call starts), so a stream's chunks thread the state
that the last frame of h and c hands on (``models/rnn.py``
``RNNLayer.apply_streaming``).
"""

from __future__ import annotations

import torch

from asr_study_torch import _build
from asr_study_torch.models.cells import lstm_gates, lstm_update
from asr_study_torch.models.nn import dot
from asr_study_torch.ops.recurrence import (STREAM_ROWS, WIDE_UNITS,
                                            Geometry, check, check_carry,
                                            check_res, cluster_geometry,
                                            cotangent, design_counts,
                                            design_key, kernel_info, prev,
                                            r4, stream, wide_geometry)

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


def wide_smem(rows: int, ctas: int) -> tuple[int, int]:
    """Dynamic shared memory per CTA of the wide forward and backward,
    bytes: ``FwdLayout`` and ``BwdLayout`` of ``csrc/lstm_wide_{fwd,bwd}.cu``
    (the slice's rows 256..511 of 4U = 128 columns, h of 512 rows, R
    ``rows``, ``ctas`` senders of partials)."""
    gc, slice_rows = 4 * WIDE_UNITS, 256
    fwd = (slice_rows * gc + 2 * rows * 512 + 2 * rows * gc + r4(2 * rows)
           + 2 * rows * gc)
    bwd = gc * slice_rows + gc * rows + 2 * ctas * WIDE_UNITS * rows
    return 4 * fwd, 4 * bwd


def stream_smem(hidden: int, bf16: bool = False) -> tuple[int, int]:
    """Dynamic shared memory per block of the stream forward and backward,
    bytes, by the formulas of ``csrc/lstm_stream_{fwd,bwd}.cu``; with
    ``bf16``, of the bfloat16-weight forms (the forward's rounded copy of
    h besides)."""
    gates = 4 * hidden
    threads = min(-(-gates // 32) * 32, 1024)
    nsplit = max(threads // hidden, 1)
    return (4 * STREAM_ROWS * ((3 if bf16 else 2) * hidden + gates),
            4 * STREAM_ROWS * ((3 + nsplit) * hidden + gates))


def lstm_geometry(hidden: int, batch: int, ndir: int) -> Geometry:
    """The design and layout of the LSTM kernels for width ``hidden``,
    ``batch`` rows and ``ndir`` directions.

    ``cluster`` where :func:`~asr_study_torch.ops.recurrence.cluster_geometry`
    fits four gate columns a unit (H=256 and H=100 up to B=48 in two
    directions and B=96 in one: every width of the zoo but deep_speech's);
    ``wide`` where :func:`~asr_study_torch.ops.recurrence.wide_geometry`
    fits (256 < H <= 512: at 8 CTAs a CTA's 256 columns of 512 rows would
    take 512 threads of 256 registers; H=512 up to B=48 in two directions
    and B=96 in one); ``stream`` otherwise."""
    return (cluster_geometry(hidden, batch, ndir, 4, CLUSTER_THREADS,
                             CLUSTER_SLICE, cluster_smem)
            or wide_geometry(hidden, batch, ndir, wide_smem)
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
    configuration (``asr_bilstm_{fwd,bwd}_info`` for the cluster design,
    ``asr_lstm_wide_{fwd,bwd}_info`` for the wide one)."""
    name = "bilstm" if geo.design == "cluster" else "lstm_wide"
    return kernel_info(f"{name}_{'bwd' if backward else 'fwd'}_info", geo,
                       batch, hidden)


def _scan(xp: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
          reverse: bool, keep_gates: bool = False, h0=None, c0=None
          ) -> tuple[torch.Tensor, ...]:
    """One direction's h and c sequences [T, B, H] in forward time order,
    and with ``keep_gates`` the activated gates [T, B, 4H] of every frame
    (held ones too: the step computes them before the mask holds h, c);
    from ``h0``, ``c0`` [B, H] where given, else zeros."""
    t_steps, batch, gh = xp.shape
    h = xp.new_zeros((batch, gh // 4)) if h0 is None else h0
    c = xp.new_zeros((batch, gh // 4)) if c0 is None else c0
    hs, cs, gs = [None] * t_steps, [None] * t_steps, [None] * t_steps
    for t in (reversed(range(t_steps)) if reverse else range(t_steps)):
        gs[t] = lstm_gates(xp[t], h, wh)
        h, c = lstm_update(gs[t], h, c, mask[t])
        hs[t], cs[t] = h, c
    if not hs:
        empty = xp.new_zeros((0, batch, gh // 4))
        out = (empty, empty.clone())
        return (*out, xp.new_zeros((0, batch, gh))) if keep_gates else out
    out = (torch.stack(hs), torch.stack(cs))
    return (*out, torch.stack(gs)) if keep_gates else out


def bilstm_plain(xp_f: torch.Tensor, xp_b: torch.Tensor, mask: torch.Tensor,
                 wh_f: torch.Tensor, wh_b: torch.Tensor,
                 keep_gates: bool = False) -> tuple[torch.Tensor, ...]:
    """Plain version of the kernel: :func:`bilstm`'s arguments and its (h_f,
    c_f, h_b, c_b), then with ``keep_gates`` (at any width) the activated
    gates g_f, g_b [T, B, 4H] that the wide forward kernel writes."""
    f = _scan(xp_f, mask, wh_f, False, keep_gates)
    b = _scan(xp_b, mask, wh_b, True, keep_gates)
    return (*f[:2], *b[:2], *f[2:], *b[2:])


def lstm_plain(xp: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
               h0: torch.Tensor | None = None, c0: torch.Tensor | None = None,
               keep_gates: bool = False) -> tuple[torch.Tensor, ...]:
    """Plain version of :func:`lstm`: (h, c) from ``h0``, ``c0`` (or
    zeros), then with ``keep_gates`` (at any width) the gates g [T, B,
    4H]."""
    return _scan(xp, mask, wh, False, keep_gates, h0, c0)


def _geometry(xp: torch.Tensor, ndir: int) -> Geometry:
    return lstm_geometry(xp.shape[2] // 4, xp.shape[1], ndir)


def launch_fwd(geo: Geometry, xps: list, mask: torch.Tensor,
               whs: list, keep_gates: bool = False, h0=None, c0=None
               ) -> list:
    """Launch the forward over ``len(xps)`` directions (the second one walks
    time backward) in the design and layout ``geo`` -> [h, c] per
    direction, flattened, then with ``keep_gates`` (the wide design only)
    the activated gates [T, B, 4H] of each direction.  ``h0``, ``c0``: the
    state the directions start from, [ndir, B, H] contiguous, or None for
    zeros.  The wrappers count the launches."""
    t_steps, batch, gh = xps[0].shape
    hidden, ndir = gh // 4, len(xps)
    outs = [torch.empty((t_steps, batch, hidden), dtype=torch.float32,
                        device=xps[0].device) for _ in range(2 * ndir)]
    gates = [torch.empty_like(x) for x in xps] if keep_gates else []
    if outs[0].numel() == 0:
        return outs + gates
    ptrs = (xps[0].data_ptr(), xps[-1].data_ptr(), mask.data_ptr(),
            whs[0].data_ptr(), whs[-1].data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), outs[-2].data_ptr(), outs[-1].data_ptr())
    init = tuple(None if s is None else s.data_ptr() for s in (h0, c0))
    dims = (t_steps, batch, hidden, ndir)
    form = "_bf16" if whs[0].dtype == torch.bfloat16 else ""
    with torch.cuda.device(xps[0].device):
        if geo.design == "cluster":
            err = getattr(_build.lib(), f"asr_bilstm_fwd{form}")(
                *ptrs, *init, *dims, geo.ctas, geo.units, geo.rows,
                stream(xps[0]))
        elif geo.design == "wide":
            g_ptrs = ((gates[0].data_ptr(), gates[-1].data_ptr())
                      if keep_gates else (None, None))
            err = getattr(_build.lib(), f"asr_lstm_wide_fwd{form}")(
                *ptrs, *g_ptrs, *init, *dims, geo.ctas, geo.units, geo.rows,
                stream(xps[0]))
        else:
            err = getattr(_build.lib(), f"asr_lstm_stream_fwd{form}")(
                *ptrs, *init, *dims, stream(xps[0]))
    _build.check(err, f"{'bilstm' if ndir == 2 else 'lstm'}_fwd "
                      f"({geo.design}{form})")
    return outs + gates


def bilstm(xp_f: torch.Tensor, xp_b: torch.Tensor, mask: torch.Tensor,
           wh_f: torch.Tensor, wh_b: torch.Tensor, residual: bool = False
           ) -> tuple:
    """One BLSTM layer's recurrence, both directions, forward only.

    xp_f, xp_b: [T, B, 4H] float32, ``x @ wx + b`` of each direction, both in
                forward time order (the reverse walk happens inside)
    mask:       [T, B, 1] float32, 1.0 on real frames
    wh_f, wh_b: [H, 4H] float32 recurrent weights, gate order i, f, g, o
    residual:   also return ``res``, what :func:`bilstm_bwd` reads beyond
                these outputs, to pass on to it unopened: where
                :func:`lstm_geometry` gives the wide design the activated
                gates (sigmoid i, f, o, tanh g) of every frame, g_f and g_b
                [T, B, 4H]; elsewhere nothing, ``()``
    ->          (h_f, c_f, h_b, c_b[, res]), h and c [T, B, H] in forward
                time order; a masked frame repeats the previous state.  No
                autograd graph: :class:`BiLSTMFunction` is the
                differentiable form.
    """
    check("bilstm", 4, mask, dict(xp_f=xp_f, xp_b=xp_b),
          dict(wh_f=wh_f, wh_b=wh_b), {})
    geo = _geometry(xp_f, 2)
    keep = residual and geo.design == "wide"
    if xp_f.device.type == "cpu":
        with torch.no_grad():
            outs = bilstm_plain(xp_f, xp_b, mask, wh_f, wh_b, keep)
    else:
        outs = launch_fwd(geo, [xp_f, xp_b], mask, [wh_f, wh_b], keep)
        bilstm.launches += 1
        bilstm.by_design[design_key(geo, wh_f)] += 1
    return (*outs[:4], tuple(outs[4:])) if residual else tuple(outs)


bilstm.launches = 0
bilstm.by_design = design_counts()


def lstm(xp: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
         h0: torch.Tensor | None = None, c0: torch.Tensor | None = None,
         residual: bool = False) -> tuple:
    """One unidirectional LSTM layer's recurrence, forward only: xp [T, B,
    4H], mask [T, B, 1], wh [H, 4H] -> (h, c[, res]), h and c [T, B, H],
    ``res`` with ``residual`` (see :func:`bilstm`: the gates (g,) where the
    wide design runs, else ``()``).  ``h0`` and ``c0`` [B, H], both or
    neither, are the state the recurrence starts from (zeros where not
    given); h[T-1] and c[T-1] are the state it ends in, a masked frame
    repeating the one before.  :class:`LSTMFunction` is the differentiable
    form."""
    check("lstm", 4, mask, dict(xp=xp), dict(wh=wh), {})
    check_carry("lstm", xp, 4, h0=h0, c0=c0)
    geo = _geometry(xp, 1)
    keep = residual and geo.design == "wide"
    if xp.device.type == "cpu":
        with torch.no_grad():
            outs = lstm_plain(xp, mask, wh, h0, c0, keep)
    else:
        outs = launch_fwd(geo, [xp], mask, [wh], keep, h0, c0)
        lstm.launches += 1
        lstm.by_design[design_key(geo, wh)] += 1
    return (*outs[:2], tuple(outs[2:])) if residual else tuple(outs)


lstm.launches = 0
lstm.by_design = design_counts()


def _walk_bwd(xp, mask, wh, h, c, dh_out, reverse: bool) -> torch.Tensor:
    """One direction's cotangent walk (``_lstm_row_bwd`` of the JAX
    package), from the end of its own time order back -> dxp; the gates
    recomputed from the saved h."""
    hp = prev(h, reverse)
    gates = torch.stack([lstm_gates(xp[t], hp[t], wh)
                         for t in range(xp.shape[0])]) if len(xp) else xp
    return _walk_gates(gates, mask, wh, c, dh_out, reverse)


def _walk_gates(gates, mask, wh, c, dh_out, reverse: bool) -> torch.Tensor:
    """One direction's cotangent walk from the activated gates of every
    frame -> dxp."""
    t_steps, batch, gh = gates.shape
    cp = prev(c, reverse)
    dxp = torch.empty_like(gates)
    dh_next = gates.new_zeros((batch, gh // 4))
    dc_next = gates.new_zeros((batch, gh // 4))
    for t in (range(t_steps) if reverse else reversed(range(t_steps))):
        m = mask[t] > 0                                      # [B, 1]
        i, f, g, o = gates[t].chunk(4, dim=-1)
        dh = dh_out[t] + dh_next
        tc = torch.tanh(c[t])
        dc = dc_next + dh * o * (1.0 - tc * tc)
        dpre = torch.cat([dc * g * i * (1.0 - i),
                          dc * cp[t] * f * (1.0 - f),
                          dc * i * (1.0 - g * g),
                          dh * tc * o * (1.0 - o)], dim=-1)
        dpre = torch.where(m, dpre, 0.0)
        dxp[t] = dpre
        # held frames pass h and c (and their cotangents) straight on; with
        # bfloat16 weights dpre is rounded before the product (dot)
        dh_next = dot(dpre, wh.t()) + torch.where(m, 0.0, dh)
        dc_next = torch.where(m, dc * f, dc_next)
    return dxp


def bilstm_bwd_plain(xp_f, xp_b, mask, wh_f, wh_b, h_f, c_f, h_b, c_b,
                     dh_f, dh_b) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`bilstm_bwd` (the gates recomputed)."""
    return (_walk_bwd(xp_f, mask, wh_f, h_f, c_f, dh_f, False),
            _walk_bwd(xp_b, mask, wh_b, h_b, c_b, dh_b, True))


def lstm_bwd_plain(xp, mask, wh, h, c, dh) -> torch.Tensor:
    """Plain version of :func:`lstm_bwd` (the gates recomputed)."""
    return _walk_bwd(xp, mask, wh, h, c, dh, False)


def bilstm_bwd_gates_plain(g_f, g_b, mask, wh_f, wh_b, c_f, c_b, dh_f, dh_b
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the wide design's backward, from the forward's saved
    gates g_f, g_b [T, B, 4H]; the arguments of ``asr_lstm_wide_bwd``."""
    return (_walk_gates(g_f, mask, wh_f, c_f, dh_f, False),
            _walk_gates(g_b, mask, wh_b, c_b, dh_b, True))


def lstm_bwd_gates_plain(g, mask, wh, c, dh) -> torch.Tensor:
    """:func:`bilstm_bwd_gates_plain` for one direction."""
    return _walk_gates(g, mask, wh, c, dh, False)


def launch_bwd(geo: Geometry, xps: list, mask: torch.Tensor, whs: list,
               hs: list, cs: list, dhs: list, gates: list | None = None
               ) -> list:
    """Launch the backward over ``len(xps)`` directions in the design and
    layout ``geo`` -> dxp per direction; the wide design reads ``gates``
    (the forward's, one per direction) in place of xp and h.  The wrappers
    count the launches."""
    outs = [torch.empty_like(x) for x in xps]
    if outs[0].numel() == 0:
        return outs
    t_steps, batch, gh = xps[0].shape
    hidden, ndir = gh // 4, len(xps)
    dims = (t_steps, batch, hidden, ndir)
    form = "_bf16" if whs[0].dtype == torch.bfloat16 else ""
    with torch.cuda.device(xps[0].device):
        if geo.design == "cluster":
            args = (xps[0], xps[-1], mask, whs[0], whs[-1], hs[0], cs[0],
                    hs[-1], cs[-1], dhs[0], dhs[-1], outs[0], outs[-1])
            err = getattr(_build.lib(), f"asr_bilstm_bwd{form}")(
                *(t.data_ptr() for t in args), *dims, geo.ctas, geo.units,
                geo.rows, stream(xps[0]))
        elif geo.design == "wide":
            args = (gates[0], gates[-1], mask, whs[0], whs[-1], cs[0],
                    cs[-1], dhs[0], dhs[-1], outs[0], outs[-1])
            err = getattr(_build.lib(), f"asr_lstm_wide_bwd{form}")(
                *(t.data_ptr() for t in args), *dims, geo.ctas, geo.units,
                geo.rows, stream(xps[0]))
        else:
            whts = [w.t().contiguous() for w in whs]
            args = (xps[0], xps[-1], mask, whs[0], whs[-1], whts[0],
                    whts[-1], hs[0], cs[0], hs[-1], cs[-1], dhs[0], dhs[-1],
                    outs[0], outs[-1])
            err = getattr(_build.lib(), f"asr_lstm_stream_bwd{form}")(
                *(t.data_ptr() for t in args), *dims, stream(xps[0]))
    _build.check(err, f"{'bilstm' if ndir == 2 else 'lstm'}_bwd "
                      f"({geo.design}{form})")
    return outs


def bilstm_bwd(xp_f: torch.Tensor, xp_b: torch.Tensor, mask: torch.Tensor,
               wh_f: torch.Tensor, wh_b: torch.Tensor, h_f: torch.Tensor,
               c_f: torch.Tensor, h_b: torch.Tensor, c_b: torch.Tensor,
               dh_f: torch.Tensor, dh_b: torch.Tensor, res: tuple = ()
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cotangent scans of both directions -> (dxp_f, dxp_b) [T, B, 4H].

    The first five arguments are :func:`bilstm`'s, h_*, c_* and ``res``
    what it returned with ``residual=True`` (the wide design's kernel reads
    the gates in ``res`` in place of xp and h), dh_f and dh_b [T, B, H] the
    cotangents of h_f and h_b.  dxp is zero on masked frames."""
    check("bilstm_bwd", 4, mask, dict(xp_f=xp_f, xp_b=xp_b),
          dict(wh_f=wh_f, wh_b=wh_b),
          dict(h_f=h_f, c_f=c_f, h_b=h_b, c_b=c_b, dh_f=dh_f, dh_b=dh_b))
    geo = _geometry(xp_f, 2)
    check_res("bilstm_bwd", 4, geo, mask, dict(xp_f=xp_f, xp_b=xp_b), res,
              "g")
    if xp_f.device.type == "cpu":
        with torch.no_grad():
            if res:
                return bilstm_bwd_gates_plain(*res, mask, wh_f, wh_b, c_f,
                                              c_b, dh_f, dh_b)
            return bilstm_bwd_plain(xp_f, xp_b, mask, wh_f, wh_b, h_f, c_f,
                                    h_b, c_b, dh_f, dh_b)
    dxp_f, dxp_b = launch_bwd(geo, [xp_f, xp_b], mask, [wh_f, wh_b],
                              [h_f, h_b], [c_f, c_b], [dh_f, dh_b], list(res))
    bilstm_bwd.launches += 1
    bilstm_bwd.by_design[design_key(geo, wh_f)] += 1
    return dxp_f, dxp_b


bilstm_bwd.launches = 0
bilstm_bwd.by_design = design_counts()


def lstm_bwd(xp: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
             h: torch.Tensor, c: torch.Tensor, dh: torch.Tensor,
             res: tuple = ()) -> torch.Tensor:
    """The cotangent scan of :func:`lstm` -> dxp [T, B, 4H], as in
    :func:`bilstm_bwd` for one direction (h, c and ``res`` as :func:`lstm`
    returned them with ``residual=True``)."""
    check("lstm_bwd", 4, mask, dict(xp=xp), dict(wh=wh),
          dict(h=h, c=c, dh=dh))
    geo = _geometry(xp, 1)
    check_res("lstm_bwd", 4, geo, mask, dict(xp=xp), res, "g")
    if xp.device.type == "cpu":
        with torch.no_grad():
            if res:
                return lstm_bwd_gates_plain(*res, mask, wh, c, dh)
            return lstm_bwd_plain(xp, mask, wh, h, c, dh)
    (dxp,) = launch_bwd(geo, [xp], mask, [wh], [h], [c], [dh], list(res))
    lstm_bwd.launches += 1
    lstm_bwd.by_design[design_key(geo, wh)] += 1
    return dxp


lstm_bwd.launches = 0
lstm_bwd.by_design = design_counts()


def _dwh(h: torch.Tensor, dxp: torch.Tensor, reverse: bool,
         wh: torch.Tensor) -> torch.Tensor:
    """``h_prev^T dxp`` over all T*B rows: one float32 matmul, cast to
    wh's dtype (as ``pallas_lstm.py``'s einsum and its ``astype``)."""
    hidden = h.shape[-1]
    return (prev(h, reverse).reshape(-1, hidden).t() @ dxp.reshape(
        -1, 4 * hidden)).to(wh.dtype)


class BiLSTMFunction(torch.autograd.Function):
    """Differentiable BLSTM recurrence: ``apply(xp_f, xp_b, mask, wh_f,
    wh_b) -> (h_f, h_b)`` (the JAX ``pallas_bilstm``).

    Forward is :func:`bilstm` with ``residual``, keeping h and c of both
    directions and its ``res`` (the gates of every frame where the wide
    design runs); backward is :func:`bilstm_bwd` for dxp, and ``dwh =
    h_prev^T dxp`` over all T*B rows as one matmul per direction.  The mask
    gets no gradient."""

    @staticmethod
    def forward(ctx, xp_f, xp_b, mask, wh_f, wh_b):
        h_f, c_f, h_b, c_b, res = bilstm(xp_f, xp_b, mask, wh_f, wh_b,
                                         residual=True)
        ctx.save_for_backward(xp_f, xp_b, mask, wh_f, wh_b, h_f, c_f, h_b,
                              c_b, *res)
        return h_f, h_b

    @staticmethod
    def backward(ctx, dh_f, dh_b):
        xp_f, xp_b, mask, wh_f, wh_b, h_f, c_f, h_b, c_b, *res = \
            ctx.saved_tensors
        dxp_f, dxp_b = bilstm_bwd(xp_f, xp_b, mask, wh_f, wh_b, h_f, c_f,
                                  h_b, c_b, cotangent(dh_f, h_f),
                                  cotangent(dh_b, h_b), tuple(res))
        return (dxp_f, dxp_b, None, _dwh(h_f, dxp_f, False, wh_f),
                _dwh(h_b, dxp_b, True, wh_b))


class LSTMFunction(torch.autograd.Function):
    """Differentiable unidirectional LSTM recurrence: ``apply(xp, mask, wh)
    -> h`` (the JAX ``pallas_lstm``).  Forward is :func:`lstm` with
    ``residual``, keeping h, c and its ``res``; backward is
    :func:`lstm_bwd` and ``dwh = h_prev^T dxp``.  The mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, xp, mask, wh):
        h, c, res = lstm(xp, mask, wh, residual=True)
        ctx.save_for_backward(xp, mask, wh, h, c, *res)
        return h

    @staticmethod
    def backward(ctx, dh):
        xp, mask, wh, h, c, *res = ctx.saved_tensors
        dxp = lstm_bwd(xp, mask, wh, h, c, cotangent(dh, h), tuple(res))
        return dxp, None, _dwh(h, dxp, False, wh)
