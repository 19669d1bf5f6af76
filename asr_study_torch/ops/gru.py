"""The GRU recurrence, forward and backward, in both of the JAX package's
forms: both directions of a bidirectional layer in one launch (port of
``asr_study_tpu/ops/pallas_bigru.py`` ``pallas_bigru``) and one direction
(port of ``asr_study_tpu/ops/pallas_gru.py`` ``pallas_gru``), each with its
custom VJP.

Three designs of the kernels, each taking the number of directions, so
:func:`bigru` and :func:`gru` launch the same forward kernel with 2 and 1
directions, and :func:`bigru_bwd` and :func:`gru_bwd` the same backward:

- ``cluster`` (H <= 256): ``csrc/gru_fwd.cu`` and ``csrc/gru_bwd.cu``, the
  recurrent weights resident in a thread-block cluster of 8 CTAs (its
  threads' registers, and for the backward its shared memory too) for the
  whole sequence, h exchanged through distributed shared memory;
- ``wide`` (256 < H <= 512, deep_gru at 512 units): ``csrc/gru_wide_fwd.cu``
  and ``csrc/gru_wide_bwd.cu``, the weights resident in a non-portable
  cluster of up to 16 CTAs of 32 units each.  The backward holds the slice
  once, for ``dhp @ wh^T``, and reads the h side of the pre-activations
  ``h_prev @ wh`` of every frame, which the forward writes when the layer
  trains, in place of recomputing them;
- ``stream``: ``csrc/gru_stream_fwd.cu`` and ``csrc/gru_stream_bwd.cu``, one
  block per (direction, 4 rows) streaming ``wh`` from L2 every step, for
  the shapes no cluster design takes (H > 512, or a batch beyond the wide
  design's clusters).

:func:`gru_geometry` picks the design by size alone (the fit rules of
``ops/recurrence.py``, shared with the LSTM, for three gate columns a unit
and this module's thread shapes); a failed build, launch or residency
check raises in every design.  Each of the four wrappers counts its own
launches, in all and by design (``launches``, ``by_design``).  A CUDA
tensor launches a kernel (or raises); a CPU tensor takes the plain version,
a Python loop over time, in the same wiring (the wide design's saved h side
included).  Which design runs is this module's concern alone: the forward
called with ``residual=True`` returns, besides h, an opaque ``res`` that
the backward takes back whatever the design (``h_prev @ wh`` of every
frame where the wide design runs, nothing elsewhere).  Neither records an
autograd graph: gradients go through :class:`BiGRUFunction` and
:class:`GRUFunction`, whose backward is the backward kernel plus one
``h_prev^T @ dhp`` matmul per direction for the recurrent weights.

bfloat16 weights (``train --bf16``, the JAX trainer's ``compute_dtype``,
under which ``pallas_bigru`` / ``pallas_gru`` run with a bfloat16 wh):
``wh`` may be bfloat16 in every wrapper, both directions alike, while xp,
the mask, h and every cotangent stay float32.  Every design then launches
its bfloat16-weight form (the same sources, the ``_bf16`` entry points):
h_prev is rounded to bfloat16 where it enters ``h_prev @ wh`` (and only
there: the cell's ``z * h_prev`` and a held frame take it unrounded), the
backward recomputes that product the same way and rounds ``dhp`` before
``dhp @ wh^T``, as the JAX kernels' ``_mm`` does, each product taken in
float32; dxp and dhp come out unrounded.  The plain twins round the same
way (:func:`~asr_study_torch.models.nn.dot`), and ``dwh`` comes back
bfloat16.  No bfloat16 call takes a float32 form;
``by_design`` counts bfloat16 launches under ``cluster_bf16``,
``wide_bf16`` and ``stream_bf16``.

Gate order r, z, n with every bias folded into ``xp`` (valid because
``n = tanh((xn + bn) + r * hn)``).  Masked frames hold ``h``.  :func:`gru`
and its plain twin start from a carried ``h0`` [B, H] where given (zeros
elsewhere, as every bidirectional and whole-sequence call starts), so a
stream's chunks thread the h that the last frame hands on
(``models/rnn.py`` ``RNNLayer.apply_streaming``).
"""

from __future__ import annotations

import torch

from asr_study_torch import _build
from asr_study_torch.models.cells import gru_update
from asr_study_torch.models.nn import dot
from asr_study_torch.ops.recurrence import (STREAM_ROWS, WIDE_UNITS,
                                            Geometry, check, check_carry,
                                            check_res, cluster_geometry,
                                            cotangent, design_counts,
                                            design_key, kernel_info, prev,
                                            r4, stream, wide_geometry)

# The cluster kernels' thread shape (csrc/gru_{fwd,bwd}.cu kThreads and
# kSlice): 384 threads a CTA, each holding 64 rows of one gate column, so at
# H=256 a CTA's 96 columns of four slices take every thread.  Measured
# faster than the LSTM's 256 threads of 128 rows (64 of them idle here) and
# than 192 threads of 128 rows (lstm_step_split.py; PERF.md).
GRU_THREADS = 384
GRU_SLICE = 64


def gru_cluster_smem(hidden: int, units: int, rows: int, ctas: int
                     ) -> tuple[int, int]:
    """Dynamic shared memory per CTA of the cluster forward and backward,
    bytes: ``FwdLayout`` and ``BwdLayout`` of ``csrc/gru_{fwd,bwd}.cu``."""
    gc, gcp = 3 * units, r4(3 * units)
    ks = -(-hidden // GRU_SLICE)               # slices of the reduction
    hs = ks * GRU_SLICE                        # h rows padded to slices
    fwd = 2 * rows * hs + r4(2 * rows * gc) + r4(2 * rows) + r4(
        ks * rows * gc)
    bwd = (r4(r4(hidden) * (gcp + 1))          # the weight copy ws
           + 2 * rows * hs + r4(2 * rows * gc) + r4(2 * rows * units)
           + r4(2 * rows) + r4(ks * rows * gc) + rows * gcp
           + r4(2 * ctas * rows * units) + r4(rows * units))
    return 4 * fwd, 4 * bwd


# The wide kernels' forward thread shape (csrc/gru_wide_fwd.cu kSplit):
# each of a CTA's 96 gate columns split over GRU_WIDE_SPLIT threads of 128
# rows in registers, the slice's other 512 - 128 * GRU_WIDE_SPLIT rows in
# shared memory.  2 (192 threads, half the slice in shared memory) measured
# 17% faster than 4 (384 threads, the whole slice in registers, where ptxas
# caps a thread at 168 registers and spills): lstm_step_split.py; PERF.md.
GRU_WIDE_SPLIT = 2


def gru_wide_smem(rows: int, ctas: int) -> tuple[int, int]:
    """Dynamic shared memory per CTA of the wide forward and backward,
    bytes: ``FwdLayout`` and ``BwdLayout`` of ``csrc/gru_wide_{fwd,bwd}.cu``
    (3U = 96 gate columns, h of 512 rows, R ``rows``, ``ctas`` senders of
    partials; the forward's shared rows of the slice by GRU_WIDE_SPLIT, the
    backward's rows 256..511)."""
    gc = 3 * WIDE_UNITS
    shared_rows = 512 - 128 * GRU_WIDE_SPLIT
    fwd = (shared_rows * gc + 2 * rows * 512 + 2 * rows * gc + r4(2 * rows)
           + GRU_WIDE_SPLIT * rows * gc)
    bwd = gc * 256 + gc * rows + 2 * ctas * WIDE_UNITS * rows
    return 4 * fwd, 4 * bwd


def gru_stream_smem(hidden: int, bf16: bool = False) -> tuple[int, int]:
    """Dynamic shared memory per block of the stream forward and backward,
    bytes, by the formulas of ``csrc/gru_stream_{fwd,bwd}.cu``; with
    ``bf16``, of the bfloat16-weight forms (the forward's rounded copy of
    h besides)."""
    gates = 3 * hidden
    threads = min(-(-gates // 32) * 32, 1024)
    nsplit = max(threads // hidden, 1)
    return (4 * STREAM_ROWS * ((2 if bf16 else 1) * hidden + gates),
            4 * STREAM_ROWS * ((2 + nsplit) * hidden + gates))


def gru_geometry(hidden: int, batch: int, ndir: int) -> Geometry:
    """The design and layout of the GRU kernels for width ``hidden``,
    ``batch`` rows and ``ndir`` directions: ``cluster`` where
    :func:`~asr_study_torch.ops.recurrence.cluster_geometry` fits three gate
    columns a unit (H=256: 8 CTAs of 32 units, 96 columns of four 64-row
    slices, R=4 rows a cluster in one direction and R=8 in two at B=32);
    ``wide`` where :func:`~asr_study_torch.ops.recurrence.wide_geometry`
    fits (256 < H <= 512: at 8 CTAs a CTA's 192 columns of 512 rows would
    take 1,536 threads; H=512 in 16 CTAs of 32 units, R=16 in two
    directions and R=8 in one at B=32, up to B=48 in two directions and
    B=96 in one); ``stream`` otherwise."""
    return (cluster_geometry(hidden, batch, ndir, 3, GRU_THREADS, GRU_SLICE,
                             gru_cluster_smem)
            or wide_geometry(hidden, batch, ndir, gru_wide_smem)
            or gru_stream_geometry(hidden, batch, ndir))


def gru_stream_geometry(hidden: int, batch: int, ndir: int) -> Geometry:
    """The stream design's layout, at any width: the one
    :func:`gru_geometry` gives where the cluster design does not fit."""
    fwd, bwd = gru_stream_smem(hidden)
    return Geometry("stream", 1, hidden, STREAM_ROWS,
                    (1, -(-batch // STREAM_ROWS), ndir), fwd, bwd)


def gru_cluster_info(geo: Geometry, batch: int, hidden: int, backward: bool
                     ) -> tuple[int, int]:
    """On the card: (dynamic shared memory per CTA the kernel sizes, clusters
    of this launch the card holds at once), from the kernel's own launch
    configuration (``asr_gru_{fwd,bwd}_info`` for the cluster design,
    ``asr_gru_wide_{fwd,bwd}_info`` for the wide one)."""
    name = "gru" if geo.design == "cluster" else "gru_wide"
    return kernel_info(f"{name}_{'bwd' if backward else 'fwd'}_info", geo,
                       batch, hidden)


def _scan(xp: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
          reverse: bool, keep_hg: bool = False, h0=None
          ) -> tuple[torch.Tensor, ...]:
    """One direction's h sequence [T, B, H] in forward time order, and with
    ``keep_hg`` the h side of every frame's pre-activations ``h_prev @ wh``
    [T, B, 3H] (held frames too: the step computes it before the mask holds
    h; in wh's dtype, :func:`dot`); from ``h0`` [B, H] where given, else
    zeros."""
    t_steps, batch, gh = xp.shape
    h = xp.new_zeros((batch, gh // 3)) if h0 is None else h0
    hs, hgs = [None] * t_steps, [None] * t_steps
    for t in (reversed(range(t_steps)) if reverse else range(t_steps)):
        hg = dot(h, wh)
        h = gru_update(hg, h, xp[t], mask[t])
        hs[t] = h
        if keep_hg:
            hgs[t] = hg
    out = (torch.stack(hs) if hs else xp.new_zeros((0, batch, gh // 3)),)
    if keep_hg:
        out += (torch.stack(hgs) if hgs else xp.new_zeros((0, batch, gh)),)
    return out


def bigru_plain(xp_f: torch.Tensor, xp_b: torch.Tensor, mask: torch.Tensor,
                wh_f: torch.Tensor, wh_b: torch.Tensor, keep_hg: bool = False
                ) -> tuple[torch.Tensor, ...]:
    """Plain version of the kernel: :func:`bigru`'s arguments and its (h_f,
    h_b), then with ``keep_hg`` (at any width) the h side of the
    pre-activations hg_f, hg_b [T, B, 3H] that the wide forward kernel
    writes."""
    f = _scan(xp_f, mask, wh_f, False, keep_hg)
    b = _scan(xp_b, mask, wh_b, True, keep_hg)
    return (f[0], b[0], *f[1:], *b[1:])


def gru_plain(xp: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
              h0: torch.Tensor | None = None, keep_hg: bool = False):
    """Plain version of :func:`gru`: h from ``h0`` (or zeros), or with
    ``keep_hg`` (at any width) (h, hg) with hg [T, B, 3H]."""
    out = _scan(xp, mask, wh, False, keep_hg, h0)
    return out if keep_hg else out[0]


def _geometry(xp: torch.Tensor, ndir: int) -> Geometry:
    return gru_geometry(xp.shape[2] // 3, xp.shape[1], ndir)


def launch_fwd(geo: Geometry, xps: list, mask: torch.Tensor,
               whs: list, keep_hg: bool = False, h0=None) -> list:
    """Launch the forward over ``len(xps)`` directions (the second one walks
    time backward) in the design and layout ``geo`` -> one h sequence per
    direction, then with ``keep_hg`` (the wide design only) the h side of
    the pre-activations [T, B, 3H] of each direction.  ``h0``: the h the
    directions start from, [ndir, B, H] contiguous, or None for zeros.  The
    wrappers count the launches."""
    t_steps, batch, gh = xps[0].shape
    hidden, ndir = gh // 3, len(xps)
    outs = [torch.empty((t_steps, batch, hidden), dtype=torch.float32,
                        device=xps[0].device) for _ in xps]
    hgs = [torch.empty_like(x) for x in xps] if keep_hg else []
    if outs[0].numel() == 0:
        return outs + hgs
    ptrs = (xps[0].data_ptr(), xps[-1].data_ptr(), mask.data_ptr(),
            whs[0].data_ptr(), whs[-1].data_ptr(), outs[0].data_ptr(),
            outs[-1].data_ptr())
    init = None if h0 is None else h0.data_ptr()
    dims = (t_steps, batch, hidden, ndir)
    form = "_bf16" if whs[0].dtype == torch.bfloat16 else ""
    with torch.cuda.device(xps[0].device):
        if geo.design == "cluster":
            err = getattr(_build.lib(), f"asr_gru_fwd{form}")(
                *ptrs, init, *dims, geo.ctas, geo.units, geo.rows,
                stream(xps[0]))
        elif geo.design == "wide":
            hg_ptrs = ((hgs[0].data_ptr(), hgs[-1].data_ptr()) if keep_hg
                       else (None, None))
            err = getattr(_build.lib(), f"asr_gru_wide_fwd{form}")(
                *ptrs, *hg_ptrs, init, *dims, geo.ctas, geo.units, geo.rows,
                stream(xps[0]))
        else:
            err = getattr(_build.lib(), f"asr_gru_stream_fwd{form}")(
                *ptrs, init, *dims, stream(xps[0]))
    _build.check(err, f"{'bigru' if ndir == 2 else 'gru'}_fwd "
                      f"({geo.design}{form})")
    return outs + hgs


def bigru(xp_f: torch.Tensor, xp_b: torch.Tensor, mask: torch.Tensor,
          wh_f: torch.Tensor, wh_b: torch.Tensor, residual: bool = False
          ) -> tuple:
    """One bidirectional GRU layer's recurrence, both directions, forward
    only.

    xp_f, xp_b: [T, B, 3H] float32, ``x @ wx + b`` of each direction, both in
                forward time order (the reverse walk happens inside)
    mask:       [T, B, 1] float32, 1.0 on real frames
    wh_f, wh_b: [H, 3H] float32 (or both bfloat16) recurrent weights,
                gate order r, z, n
    residual:   also return ``res``, what :func:`bigru_bwd` reads beyond
                these outputs, to pass on to it unopened: where
                :func:`gru_geometry` gives the wide design the h side of the
                pre-activations ``h_prev @ wh`` of every frame, hg_f and
                hg_b [T, B, 3H]; elsewhere nothing, ``()``
    ->          (h_f, h_b[, res]), h [T, B, H] in forward time order; a
                masked frame repeats the previous h.  No autograd graph:
                :class:`BiGRUFunction` is the differentiable form.
    """
    check("bigru", 3, mask, dict(xp_f=xp_f, xp_b=xp_b),
          dict(wh_f=wh_f, wh_b=wh_b), {})
    geo = _geometry(xp_f, 2)
    keep = residual and geo.design == "wide"
    if xp_f.device.type == "cpu":
        with torch.no_grad():
            outs = bigru_plain(xp_f, xp_b, mask, wh_f, wh_b, keep)
    else:
        outs = launch_fwd(geo, [xp_f, xp_b], mask, [wh_f, wh_b], keep)
        bigru.launches += 1
        bigru.by_design[design_key(geo, wh_f)] += 1
    return (*outs[:2], tuple(outs[2:])) if residual else tuple(outs)


bigru.launches = 0
bigru.by_design = design_counts()


def gru(xp: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
        h0: torch.Tensor | None = None, residual: bool = False):
    """One unidirectional GRU layer's recurrence, forward only: xp [T, B,
    3H], mask [T, B, 1], wh [H, 3H] -> h [T, B, H], or with ``residual``
    (h, res), ``res`` as in :func:`bigru` (the h side (hg,) where the wide
    design runs, else ``()``).  ``h0`` [B, H] is the h the recurrence starts
    from (zeros where not given); h[T-1] is the one it ends in, a masked
    frame repeating the one before.  :class:`GRUFunction` is the
    differentiable form."""
    check("gru", 3, mask, dict(xp=xp), dict(wh=wh), {})
    check_carry("gru", xp, 3, h0=h0)
    geo = _geometry(xp, 1)
    keep = residual and geo.design == "wide"
    if xp.device.type == "cpu":
        with torch.no_grad():
            outs = _scan(xp, mask, wh, False, keep, h0)
    else:
        outs = launch_fwd(geo, [xp], mask, [wh], keep, h0)
        gru.launches += 1
        gru.by_design[design_key(geo, wh)] += 1
    return (outs[0], tuple(outs[1:])) if residual else outs[0]


gru.launches = 0
gru.by_design = design_counts()


def _walk_bwd(xp, mask, wh, h, dh_out, reverse: bool, hg=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One direction's cotangent walk (``_gru_row_bwd`` of the JAX
    package), from the end of its own time order back -> (dxp, dhp); the h
    side of the pre-activations from ``hg`` [T, B, 3H] (the wide forward's
    res) where given, else recomputed as ``h_prev @ wh``; both products in
    wh's dtype (:func:`dot`), dxp and dhp unrounded."""
    t_steps, batch, gh = xp.shape
    hp = prev(h, reverse)
    dxp, dhp = torch.empty_like(xp), torch.empty_like(xp)
    dh_next = xp.new_zeros((batch, gh // 3))
    for t in (range(t_steps) if reverse else reversed(range(t_steps))):
        m = mask[t] > 0                                      # [B, 1]
        hg_t = dot(hp[t], wh) if hg is None else hg[t]
        hr, hz, hn = hg_t.chunk(3, dim=-1)
        xr, xz, xn = xp[t].chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        dh = dh_out[t] + dh_next
        dpre_n = dh * (1.0 - z) * (1.0 - n * n)
        dpre_r = dpre_n * hn * r * (1.0 - r)
        dpre_z = dh * (hp[t] - n) * z * (1.0 - z)
        dxp[t] = torch.where(m, torch.cat([dpre_r, dpre_z, dpre_n], -1), 0.0)
        dhp[t] = torch.where(m, torch.cat([dpre_r, dpre_z, dpre_n * r], -1),
                             0.0)
        # a held frame passes its h (and the cotangent) straight on; with
        # bfloat16 weights dhp is rounded before the product (dot)
        dh_next = dot(dhp[t], wh.t()) + torch.where(m, dh * z, dh)
    return dxp, dhp


def bigru_bwd_plain(xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b, dh_f, dh_b
                    ) -> tuple[torch.Tensor, ...]:
    """Plain version of :func:`bigru_bwd`."""
    return (*_walk_bwd(xp_f, mask, wh_f, h_f, dh_f, False),
            *_walk_bwd(xp_b, mask, wh_b, h_b, dh_b, True))


def gru_bwd_plain(xp, mask, wh, h, dh) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`gru_bwd`."""
    return _walk_bwd(xp, mask, wh, h, dh, False)


def bigru_bwd_res_plain(xp_f, xp_b, hg_f, hg_b, mask, wh_f, wh_b, h_f, h_b,
                        dh_f, dh_b) -> tuple[torch.Tensor, ...]:
    """Plain version of the wide design's backward, from the forward's
    saved h side of the pre-activations hg_f, hg_b [T, B, 3H]; the
    arguments of ``asr_gru_wide_bwd``."""
    return (*_walk_bwd(xp_f, mask, wh_f, h_f, dh_f, False, hg_f),
            *_walk_bwd(xp_b, mask, wh_b, h_b, dh_b, True, hg_b))


def gru_bwd_res_plain(xp, hg, mask, wh, h, dh
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`bigru_bwd_res_plain` for one direction."""
    return _walk_bwd(xp, mask, wh, h, dh, False, hg)


def launch_bwd(geo: Geometry, xps: list, mask: torch.Tensor, whs: list,
               hs: list, dhs: list, hgs: list | None = None) -> list:
    """Launch the backward over ``len(xps)`` directions in the design and
    layout ``geo`` -> [dxp, dhp] per direction, flattened; the wide design
    reads ``hgs`` (the forward's h side of the pre-activations, one per
    direction) in place of recomputing it.  The wrappers count the
    launches."""
    outs = [torch.empty_like(xps[0]) for _ in range(2 * len(xps))]
    if outs[0].numel() == 0:
        return outs
    t_steps, batch, gh = xps[0].shape
    hidden, ndir = gh // 3, len(xps)
    tail = (hs[0], hs[-1], dhs[0], dhs[-1], outs[0], outs[1], outs[-2],
            outs[-1])
    form = "_bf16" if whs[0].dtype == torch.bfloat16 else ""
    with torch.cuda.device(xps[0].device):
        if geo.design == "cluster":
            args = (xps[0], xps[-1], mask, whs[0], whs[-1], *tail)
            err = getattr(_build.lib(), f"asr_gru_bwd{form}")(
                *(t.data_ptr() for t in args), t_steps, batch, hidden, ndir,
                geo.ctas, geo.units, geo.rows, stream(xps[0]))
        elif geo.design == "wide":
            args = (xps[0], xps[-1], hgs[0], hgs[-1], mask, whs[0], whs[-1],
                    *tail)
            err = getattr(_build.lib(), f"asr_gru_wide_bwd{form}")(
                *(t.data_ptr() for t in args), t_steps, batch, hidden, ndir,
                geo.ctas, geo.units, geo.rows, stream(xps[0]))
        else:
            whts = [w.t().contiguous() for w in whs]
            args = (xps[0], xps[-1], mask, whs[0], whs[-1], whts[0],
                    whts[-1], *tail)
            err = getattr(_build.lib(), f"asr_gru_stream_bwd{form}")(
                *(t.data_ptr() for t in args), t_steps, batch, hidden, ndir,
                stream(xps[0]))
    _build.check(err, f"{'bigru' if ndir == 2 else 'gru'}_bwd "
                      f"({geo.design}{form})")
    return outs


def bigru_bwd(xp_f: torch.Tensor, xp_b: torch.Tensor, mask: torch.Tensor,
              wh_f: torch.Tensor, wh_b: torch.Tensor, h_f: torch.Tensor,
              h_b: torch.Tensor, dh_f: torch.Tensor, dh_b: torch.Tensor,
              res: tuple = ()) -> tuple[torch.Tensor, ...]:
    """Cotangent walks of both directions -> (dxp_f, dhp_f, dxp_b, dhp_b),
    each [T, B, 3H].

    The first five arguments are :func:`bigru`'s, h_f, h_b and ``res`` what
    it returned with ``residual=True`` (the wide design's kernel reads the
    h side of the pre-activations in ``res`` in place of recomputing it),
    dh_f and dh_b [T, B, H] the cotangents of h_f and h_b.  ``dxp = [dr, dz,
    dn]`` and ``dhp = [dr, dz, dn * r]`` (pre-activation gradients on the x
    and h side), both zero on masked frames; the recurrent weight gradient
    is ``h_prev^T dhp``."""
    check("bigru_bwd", 3, mask, dict(xp_f=xp_f, xp_b=xp_b),
          dict(wh_f=wh_f, wh_b=wh_b),
          dict(h_f=h_f, h_b=h_b, dh_f=dh_f, dh_b=dh_b))
    geo = _geometry(xp_f, 2)
    check_res("bigru_bwd", 3, geo, mask, dict(xp_f=xp_f, xp_b=xp_b), res,
              "hg")
    if xp_f.device.type == "cpu":
        with torch.no_grad():
            if res:
                return bigru_bwd_res_plain(xp_f, xp_b, *res, mask, wh_f,
                                           wh_b, h_f, h_b, dh_f, dh_b)
            return bigru_bwd_plain(xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b,
                                   dh_f, dh_b)
    outs = launch_bwd(geo, [xp_f, xp_b], mask, [wh_f, wh_b], [h_f, h_b],
                      [dh_f, dh_b], list(res))
    bigru_bwd.launches += 1
    bigru_bwd.by_design[design_key(geo, wh_f)] += 1
    return tuple(outs)


bigru_bwd.launches = 0
bigru_bwd.by_design = design_counts()


def gru_bwd(xp: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
            h: torch.Tensor, dh: torch.Tensor, res: tuple = ()
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cotangent walk of :func:`gru` -> (dxp, dhp), as in
    :func:`bigru_bwd` for one direction (h and ``res`` as :func:`gru`
    returned them with ``residual=True``)."""
    check("gru_bwd", 3, mask, dict(xp=xp), dict(wh=wh), dict(h=h, dh=dh))
    geo = _geometry(xp, 1)
    check_res("gru_bwd", 3, geo, mask, dict(xp=xp), res, "hg")
    if xp.device.type == "cpu":
        with torch.no_grad():
            if res:
                return gru_bwd_res_plain(xp, *res, mask, wh, h, dh)
            return gru_bwd_plain(xp, mask, wh, h, dh)
    dxp, dhp = launch_bwd(geo, [xp], mask, [wh], [h], [dh], list(res))
    gru_bwd.launches += 1
    gru_bwd.by_design[design_key(geo, wh)] += 1
    return dxp, dhp


gru_bwd.launches = 0
gru_bwd.by_design = design_counts()


def _dwh(h: torch.Tensor, dhp: torch.Tensor, reverse: bool,
         wh: torch.Tensor) -> torch.Tensor:
    """``h_prev^T dhp`` over all T*B rows (not ``dxp``: its n block lacks
    the factor r): one float32 matmul, cast to wh's dtype (as
    ``pallas_gru.py``'s einsum and its ``astype``)."""
    hidden = h.shape[-1]
    return (prev(h, reverse).reshape(-1, hidden).t() @ dhp.reshape(
        -1, 3 * hidden)).to(wh.dtype)


class BiGRUFunction(torch.autograd.Function):
    """Differentiable bidirectional GRU recurrence: ``apply(xp_f, xp_b,
    mask, wh_f, wh_b) -> (h_f, h_b)`` (the JAX ``pallas_bigru``).

    Forward is :func:`bigru` with ``residual``, keeping h of both directions
    and its ``res`` (``h_prev @ wh`` of every frame where the wide design
    runs); backward is :func:`bigru_bwd` for dxp and dhp, and ``dwh =
    h_prev^T dhp`` over all T*B rows as one matmul per direction.  The mask
    gets no gradient."""

    @staticmethod
    def forward(ctx, xp_f, xp_b, mask, wh_f, wh_b):
        h_f, h_b, res = bigru(xp_f, xp_b, mask, wh_f, wh_b, residual=True)
        ctx.save_for_backward(xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b, *res)
        return h_f, h_b

    @staticmethod
    def backward(ctx, dh_f, dh_b):
        xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b, *res = ctx.saved_tensors
        dxp_f, dhp_f, dxp_b, dhp_b = bigru_bwd(
            xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b, cotangent(dh_f, h_f),
            cotangent(dh_b, h_b), tuple(res))
        return (dxp_f, dxp_b, None, _dwh(h_f, dhp_f, False, wh_f),
                _dwh(h_b, dhp_b, True, wh_b))


class GRUFunction(torch.autograd.Function):
    """Differentiable unidirectional GRU recurrence: ``apply(xp, mask, wh)
    -> h`` (the JAX ``pallas_gru``).  Forward is :func:`gru` with
    ``residual``, keeping h and its ``res``; backward is :func:`gru_bwd`
    and ``dwh = h_prev^T dhp``.  The mask gets no gradient."""

    @staticmethod
    def forward(ctx, xp, mask, wh):
        h, res = gru(xp, mask, wh, residual=True)
        ctx.save_for_backward(xp, mask, wh, h, *res)
        return h

    @staticmethod
    def backward(ctx, dh):
        xp, mask, wh, h, *res = ctx.saved_tensors
        dxp, dhp = gru_bwd(xp, mask, wh, h, cotangent(dh, h), tuple(res))
        return dxp, None, _dwh(h, dhp, False, wh)
