"""The zoneout-LSTM recurrence, forward and backward, in both of the JAX
package's forms: both directions of a bidirectional layer in one launch
(port of ``asr_study_tpu/ops/pallas_bi_zoneout_lstm.py``
``pallas_bi_zoneout_lstm``) and one direction (port of
``asr_study_tpu/ops/pallas_zoneout_lstm.py`` ``pallas_zoneout_lstm``), each
with its custom VJP.

Zoneout's random decisions are made outside the recurrence and streamed in
as mix weights ``zh`` and ``zc`` [T, B, H], the weight of the new state:
{0, 1} samples in train mode, the constant ``1 - rate`` in eval mode
(``models.cells.zoneout_mix``).  A step is the LSTM update (gate order i,
f, g, o, the bias folded into ``xp``), then ``h = zh * h_new + (1 - zh) *
h_prev`` and the same for c with ``zc``, then the hold on masked frames.
Both directions take their mix weights in forward time order.

Two designs of the kernels, each taking the number of directions, so
:func:`bi_zoneout_lstm` and :func:`zoneout_lstm` launch the same forward
kernel with 2 and 1 directions, and :func:`bi_zoneout_lstm_bwd` and
:func:`zoneout_lstm_bwd` the same backward kernel:

- ``cluster``: ``csrc/zoneout_lstm_fwd.cu`` and ``csrc/zoneout_lstm_bwd.cu``,
  the recurrent weights resident in a thread-block cluster (its threads'
  registers, and for the backward its shared memory too) for the whole
  sequence, h and the cotangent partials exchanged through distributed
  shared memory, the mix weights of a CTA's own units staged a step ahead;
- ``stream``: ``csrc/zoneout_lstm_stream_fwd.cu`` and
  ``csrc/zoneout_lstm_stream_bwd.cu``, one block per (direction, 4 rows)
  streaming ``wh`` from L2 every step, for the widths whose weights do not
  fit in a cluster (H=300, H=512).

:func:`zoneout_geometry` picks the design by size alone (the LSTM's fit
rule of ``ops/recurrence.py``, with the LSTM kernels' thread shape); a
failed build or launch raises either way.  Each of the four wrappers counts
its own launches, in all and by design (``launches``, ``by_design``).  A
CUDA tensor launches a kernel (or raises); a CPU tensor takes the plain
version, a Python loop over time.  Neither records an autograd graph:
gradients go through :class:`BiZoneoutLSTMFunction` and
:class:`ZoneoutLSTMFunction`, whose backward is the backward kernel plus
one ``h_prev^T @ dxp`` matmul per direction.  The mix weights get no
gradient.

:func:`zoneout_lstm` and its plain twin start from a carried state ``h0``,
``c0`` [B, H] where given (zeros elsewhere): the first frame mixes its new
state with that carry, so a stream's chunks thread the state that the last
frame of h and c hands on (``models/rnn.py``
``RNNLayer.apply_streaming``).

bfloat16 weights (``train --bf16``, the JAX trainer's ``compute_dtype``,
under which ``pallas_bi_zoneout_lstm`` / ``pallas_zoneout_lstm`` run with a
bfloat16 wh): ``wh`` may be bfloat16 in every wrapper, both directions
alike, while xp, the mask, the mix weights, h, c and every cotangent stay
float32.  Both designs then launch their bfloat16-weight forms (the same
sources, the ``_bf16`` entry points): h_prev is rounded to bfloat16 where
it enters ``h_prev @ wh`` and only there (the mix and the hold take it
unrounded), the backward recomputes that product the same way and rounds
``dpre`` before ``dpre @ wh^T``, as the JAX kernels' ``_mm`` does, each
product taken in float32; dxp comes out unrounded.  The plain twins round
the same way (:func:`~asr_study_torch.models.nn.dot`), and ``dwh`` (a
float32 product of the unrounded h_prev and dxp) comes back bfloat16.  No
bfloat16 call takes a float32 form; ``by_design`` counts bfloat16
launches under ``cluster_bf16`` and ``stream_bf16``.
"""

from __future__ import annotations

import torch

from asr_study_torch import _build
from asr_study_torch.models.cells import zoneout_lstm_step
from asr_study_torch.models.nn import dot
from asr_study_torch.ops.bilstm import (CLUSTER_SLICE, CLUSTER_THREADS,
                                        _dwh, cluster_smem, stream_smem)
from asr_study_torch.ops.recurrence import (STREAM_ROWS, Geometry, check,
                                            check_carry, cluster_geometry,
                                            cotangent, design_counts,
                                            design_key, kernel_info, prev, r4,
                                            stream)


def zoneout_cluster_smem(hidden: int, units: int, rows: int, ctas: int
                         ) -> tuple[int, int]:
    """Dynamic shared memory per CTA of the cluster forward and backward,
    bytes: ``FwdLayout`` and ``BwdLayout`` of
    ``csrc/zoneout_lstm_{fwd,bwd}.cu``, the LSTM kernels'
    (``ops/bilstm.py`` ``cluster_smem``) with the mix weights zh and zc of
    the CTA's own (row, unit) pairs, two steps of each ([2][R][U] floats);
    the backward reads c at t_prev only, so its buffer of c at t goes."""
    fwd, bwd = cluster_smem(hidden, units, rows, ctas)
    pairs = 4 * r4(2 * rows * units)
    return fwd + 2 * pairs, bwd + pairs


def zoneout_stream_smem(hidden: int, bf16: bool = False) -> tuple[int, int]:
    """Dynamic shared memory per block of the stream forward and backward,
    bytes: the formulas of ``csrc/zoneout_lstm_stream_{fwd,bwd}.cu``, which
    are ``csrc/lstm_stream_{fwd,bwd}.cu``'s (``ops/bilstm.py``
    ``stream_smem``); with ``bf16``, of the bfloat16-weight forms (the
    forward's rounded copy of h besides)."""
    return stream_smem(hidden, bf16)


def zoneout_geometry(hidden: int, batch: int, ndir: int) -> Geometry:
    """The design and layout of the zoneout-LSTM kernels for width
    ``hidden``, ``batch`` rows and ``ndir`` directions: ``cluster`` where
    :func:`~asr_study_torch.ops.recurrence.cluster_geometry` fits four gate
    columns a unit in 256 threads of 128 rows (H=256: 8 CTAs of 32 units,
    R=4 rows a cluster in one direction and R=8 in two at B=32, 8 clusters
    either way; H=100: 13 units, the last CTA 9); ``stream`` otherwise
    (H=300: 4 x 38 columns of three slices would take 456 threads; H=512;
    and a batch no row count keeps within the budget, as B=49 at H=100 in
    two directions)."""
    return (cluster_geometry(hidden, batch, ndir, 4, CLUSTER_THREADS,
                             CLUSTER_SLICE, zoneout_cluster_smem)
            or zoneout_stream_geometry(hidden, batch, ndir))


def zoneout_stream_geometry(hidden: int, batch: int, ndir: int) -> Geometry:
    """The stream design's layout, at any width: the one
    :func:`zoneout_geometry` gives where the cluster design does not fit."""
    fwd, bwd = zoneout_stream_smem(hidden)
    return Geometry("stream", 1, hidden, STREAM_ROWS,
                    (1, -(-batch // STREAM_ROWS), ndir), fwd, bwd)


def zoneout_cluster_info(geo: Geometry, batch: int, hidden: int,
                         backward: bool) -> tuple[int, int]:
    """On the card: (dynamic shared memory per CTA the kernel sizes,
    clusters of this launch the card holds at once), from the kernel's own
    launch configuration (``asr_zoneout_lstm_{fwd,bwd}_info``)."""
    return kernel_info("zoneout_lstm_bwd_info" if backward
                       else "zoneout_lstm_fwd_info", geo, batch, hidden)


def _scan(xp, mask, zh, zc, wh, reverse: bool, h0=None, c0=None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """One direction's mixed h and c sequences [T, B, H] in forward time
    order, from ``h0``, ``c0`` [B, H] where given, else zeros."""
    t_steps, batch, gh = xp.shape
    h = xp.new_zeros((batch, gh // 4)) if h0 is None else h0
    c = xp.new_zeros((batch, gh // 4)) if c0 is None else c0
    hs = [None] * t_steps
    cs = [None] * t_steps
    for t in (reversed(range(t_steps)) if reverse else range(t_steps)):
        h, c = zoneout_lstm_step(h, c, xp[t], mask[t], zh[t], zc[t], wh)
        hs[t], cs[t] = h, c
    if not hs:
        empty = xp.new_zeros((0, batch, gh // 4))
        return empty, empty.clone()
    return torch.stack(hs), torch.stack(cs)


def bi_zoneout_lstm_plain(xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f,
                          wh_b) -> tuple[torch.Tensor, ...]:
    """Plain version of :func:`bi_zoneout_lstm`; same arguments and
    results."""
    return (*_scan(xp_f, mask, zh_f, zc_f, wh_f, False),
            *_scan(xp_b, mask, zh_b, zc_b, wh_b, True))


def zoneout_lstm_plain(xp, mask, zh, zc, wh, h0=None, c0=None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`zoneout_lstm`; same arguments and results."""
    return _scan(xp, mask, zh, zc, wh, False, h0, c0)


def _geometry(xp: torch.Tensor, ndir: int) -> Geometry:
    return zoneout_geometry(xp.shape[2] // 4, xp.shape[1], ndir)


def launch_fwd(geo: Geometry, xps: list, mask: torch.Tensor, zhs: list,
               zcs: list, whs: list, h0=None, c0=None) -> list:
    """Launch the forward over ``len(xps)`` directions (the second one walks
    time backward) in the design and layout ``geo`` -> [h, c] per
    direction, flattened.  ``h0``, ``c0``: the state the directions start
    from, [ndir, B, H] contiguous, or None for zeros.  The wrappers count
    the launches."""
    t_steps, batch, gh = xps[0].shape
    hidden, ndir = gh // 4, len(xps)
    outs = [torch.empty((t_steps, batch, hidden), dtype=torch.float32,
                        device=xps[0].device) for _ in range(2 * ndir)]
    if outs[0].numel() == 0:
        return outs
    args = (xps[0], xps[-1], mask, zhs[0], zhs[-1], zcs[0], zcs[-1], whs[0],
            whs[-1], outs[0], outs[1], outs[-2], outs[-1])
    ptrs = (*(a.data_ptr() for a in args),
            *(None if s is None else s.data_ptr() for s in (h0, c0)),
            t_steps, batch, hidden, ndir)
    form = "_bf16" if whs[0].dtype == torch.bfloat16 else ""
    with torch.cuda.device(xps[0].device):
        if geo.design == "cluster":
            err = getattr(_build.lib(), f"asr_zoneout_lstm_fwd{form}")(
                *ptrs, geo.ctas, geo.units, geo.rows, stream(xps[0]))
        else:
            err = getattr(_build.lib(), f"asr_zoneout_lstm_stream_fwd{form}")(
                *ptrs, stream(xps[0]))
    _build.check(err, f"{'bi_zoneout_lstm' if ndir == 2 else 'zoneout_lstm'}"
                      f"_fwd ({geo.design}{form})")
    return outs


def bi_zoneout_lstm(xp_f: torch.Tensor, xp_b: torch.Tensor,
                    mask: torch.Tensor, zh_f: torch.Tensor,
                    zh_b: torch.Tensor, zc_f: torch.Tensor,
                    zc_b: torch.Tensor, wh_f: torch.Tensor,
                    wh_b: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """One zoneout-BLSTM layer's recurrence, both directions, forward only.

    xp_f, xp_b: [T, B, 4H] float32, ``x @ wx + b`` of each direction, both
                in forward time order (the reverse walk happens inside)
    mask:       [T, B, 1] float32, 1.0 on real frames
    zh_*, zc_*: [T, B, H] float32 mix weights of each direction, both in
                forward time order
    wh_f, wh_b: [H, 4H] float32 (or both bfloat16) recurrent weights, gate
                order i, f, g, o
    ->          (h_f, c_f, h_b, c_b), the mixed states, each [T, B, H] in
                forward time order; a masked frame repeats the previous
                state.  No autograd graph: :class:`BiZoneoutLSTMFunction`
                is the differentiable form.
    """
    check("bi_zoneout_lstm", 4, mask, dict(xp_f=xp_f, xp_b=xp_b),
          dict(wh_f=wh_f, wh_b=wh_b),
          dict(zh_f=zh_f, zh_b=zh_b, zc_f=zc_f, zc_b=zc_b))
    args = (xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f, wh_b)
    geo = _geometry(xp_f, 2)
    if xp_f.device.type == "cpu":
        with torch.no_grad():
            return bi_zoneout_lstm_plain(*args)
    outs = launch_fwd(geo, [xp_f, xp_b], mask, [zh_f, zh_b], [zc_f, zc_b],
                      [wh_f, wh_b])
    bi_zoneout_lstm.launches += 1
    bi_zoneout_lstm.by_design[design_key(geo, wh_f)] += 1
    return tuple(outs)


bi_zoneout_lstm.launches = 0
bi_zoneout_lstm.by_design = design_counts()


def zoneout_lstm(xp: torch.Tensor, mask: torch.Tensor, zh: torch.Tensor,
                 zc: torch.Tensor, wh: torch.Tensor,
                 h0: torch.Tensor | None = None,
                 c0: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One unidirectional zoneout-LSTM layer's recurrence, forward only: xp
    [T, B, 4H], mask [T, B, 1], zh and zc [T, B, H], wh [H, 4H] -> (h, c),
    each [T, B, H] (see :func:`bi_zoneout_lstm`).  ``h0`` and ``c0`` [B,
    H], both or neither, are the state the recurrence starts from (zeros
    where not given); h[T-1] and c[T-1] are the state it ends in.
    :class:`ZoneoutLSTMFunction` is the differentiable form."""
    check("zoneout_lstm", 4, mask, dict(xp=xp), dict(wh=wh),
          dict(zh=zh, zc=zc))
    check_carry("zoneout_lstm", xp, 4, h0=h0, c0=c0)
    geo = _geometry(xp, 1)
    if xp.device.type == "cpu":
        with torch.no_grad():
            return zoneout_lstm_plain(xp, mask, zh, zc, wh, h0, c0)
    h, c = launch_fwd(geo, [xp], mask, [zh], [zc], [wh], h0, c0)
    zoneout_lstm.launches += 1
    zoneout_lstm.by_design[design_key(geo, wh)] += 1
    return h, c


zoneout_lstm.launches = 0
zoneout_lstm.by_design = design_counts()


def _walk_bwd(xp, mask, zh, zc, wh, h, c, dh_out, reverse: bool
              ) -> torch.Tensor:
    """One direction's cotangent walk (``_zo_row_bwd`` of the JAX package),
    from the end of its own time order back -> dxp.  The stored h and c are
    the mixed states, so c_new is recomputed from (xp, h_prev, c_prev);
    both products in wh's dtype (:func:`dot`), dxp unrounded."""
    t_steps, batch, gh = xp.shape
    hp, cp = prev(h, reverse), prev(c, reverse)
    dxp = torch.empty_like(xp)
    dh_next = xp.new_zeros((batch, gh // 4))
    dc_next = xp.new_zeros((batch, gh // 4))
    for t in (range(t_steps) if reverse else reversed(range(t_steps))):
        m = mask[t] > 0                                      # [B, 1]
        gates = xp[t] + dot(hp[t], wh)
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        tc = torch.tanh(f * cp[t] + i * g)                   # tanh(c_new)
        dh = dh_out[t] + dh_next
        dh_new = dh * zh[t]
        dc = dc_next * zc[t] + dh_new * o * (1.0 - tc * tc)
        dpre = torch.cat([dc * g * i * (1.0 - i),
                          dc * cp[t] * f * (1.0 - f),
                          dc * i * (1.0 - g * g),
                          dh_new * tc * o * (1.0 - o)], dim=-1)
        dpre = torch.where(m, dpre, 0.0)
        dxp[t] = dpre
        # a real frame passes dh * (1 - zh) and dc_next * (1 - zc) past the
        # cell; a held one passes dh and dc_next whole; with bfloat16
        # weights dpre is rounded before the product (dot)
        dh_next = dot(dpre, wh.t()) + torch.where(m, dh * (1.0 - zh[t]), dh)
        dc_next = torch.where(m, dc * f + dc_next * (1.0 - zc[t]), dc_next)
    return dxp


def bi_zoneout_lstm_bwd_plain(xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b,
                              wh_f, wh_b, h_f, c_f, h_b, c_b, dh_f, dh_b
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`bi_zoneout_lstm_bwd`."""
    return (_walk_bwd(xp_f, mask, zh_f, zc_f, wh_f, h_f, c_f, dh_f, False),
            _walk_bwd(xp_b, mask, zh_b, zc_b, wh_b, h_b, c_b, dh_b, True))


def zoneout_lstm_bwd_plain(xp, mask, zh, zc, wh, h, c, dh) -> torch.Tensor:
    """Plain version of :func:`zoneout_lstm_bwd`."""
    return _walk_bwd(xp, mask, zh, zc, wh, h, c, dh, False)


def launch_bwd(geo: Geometry, xps: list, mask: torch.Tensor, zhs: list,
               zcs: list, whs: list, hs: list, cs: list, dhs: list) -> list:
    """Launch the backward over ``len(xps)`` directions in the design and
    layout ``geo`` -> dxp per direction.  The cluster design holds its slice
    of ``wh`` on chip; the stream design also reads ``wh`` transposed, made
    here.  The wrappers count the launches."""
    outs = [torch.empty_like(x) for x in xps]
    if outs[0].numel() == 0:
        return outs
    t_steps, batch, gh = xps[0].shape
    hidden, ndir = gh // 4, len(xps)
    head = (xps[0], xps[-1], mask, zhs[0], zhs[-1], zcs[0], zcs[-1], whs[0],
            whs[-1])
    seqs = (hs[0], cs[0], hs[-1], cs[-1], dhs[0], dhs[-1], outs[0], outs[-1])
    form = "_bf16" if whs[0].dtype == torch.bfloat16 else ""
    with torch.cuda.device(xps[0].device):
        if geo.design == "cluster":
            err = getattr(_build.lib(), f"asr_zoneout_lstm_bwd{form}")(
                *(a.data_ptr() for a in (*head, *seqs)), t_steps, batch,
                hidden, ndir, geo.ctas, geo.units, geo.rows, stream(xps[0]))
        else:
            whts = [w.t().contiguous() for w in whs]
            args = (*head, whts[0], whts[-1], *seqs)
            err = getattr(_build.lib(), f"asr_zoneout_lstm_stream_bwd{form}")(
                *(a.data_ptr() for a in args), t_steps, batch, hidden, ndir,
                stream(xps[0]))
    _build.check(err, f"{'bi_zoneout_lstm' if ndir == 2 else 'zoneout_lstm'}"
                      f"_bwd ({geo.design}{form})")
    return outs


def bi_zoneout_lstm_bwd(xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f,
                        wh_b, h_f, c_f, h_b, c_b, dh_f, dh_b
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cotangent scans of both directions -> (dxp_f, dxp_b) [T, B, 4H].

    The first nine arguments are :func:`bi_zoneout_lstm`'s, h_* and c_* its
    outputs, dh_f and dh_b [T, B, H] the cotangents of h_f and h_b.  dxp is
    zero on masked frames."""
    check("bi_zoneout_lstm_bwd", 4, mask, dict(xp_f=xp_f, xp_b=xp_b),
          dict(wh_f=wh_f, wh_b=wh_b),
          dict(zh_f=zh_f, zh_b=zh_b, zc_f=zc_f, zc_b=zc_b, h_f=h_f, c_f=c_f,
               h_b=h_b, c_b=c_b, dh_f=dh_f, dh_b=dh_b))
    geo = _geometry(xp_f, 2)
    if xp_f.device.type == "cpu":
        with torch.no_grad():
            return bi_zoneout_lstm_bwd_plain(xp_f, xp_b, mask, zh_f, zh_b,
                                             zc_f, zc_b, wh_f, wh_b, h_f,
                                             c_f, h_b, c_b, dh_f, dh_b)
    dxp_f, dxp_b = launch_bwd(geo, [xp_f, xp_b], mask, [zh_f, zh_b],
                              [zc_f, zc_b], [wh_f, wh_b], [h_f, h_b],
                              [c_f, c_b], [dh_f, dh_b])
    bi_zoneout_lstm_bwd.launches += 1
    bi_zoneout_lstm_bwd.by_design[design_key(geo, wh_f)] += 1
    return dxp_f, dxp_b


bi_zoneout_lstm_bwd.launches = 0
bi_zoneout_lstm_bwd.by_design = design_counts()


def zoneout_lstm_bwd(xp, mask, zh, zc, wh, h, c, dh) -> torch.Tensor:
    """The cotangent scan of :func:`zoneout_lstm` -> dxp [T, B, 4H], as in
    :func:`bi_zoneout_lstm_bwd` for one direction."""
    check("zoneout_lstm_bwd", 4, mask, dict(xp=xp), dict(wh=wh),
          dict(zh=zh, zc=zc, h=h, c=c, dh=dh))
    geo = _geometry(xp, 1)
    if xp.device.type == "cpu":
        with torch.no_grad():
            return zoneout_lstm_bwd_plain(xp, mask, zh, zc, wh, h, c, dh)
    (dxp,) = launch_bwd(geo, [xp], mask, [zh], [zc], [wh], [h], [c], [dh])
    zoneout_lstm_bwd.launches += 1
    zoneout_lstm_bwd.by_design[design_key(geo, wh)] += 1
    return dxp


zoneout_lstm_bwd.launches = 0
zoneout_lstm_bwd.by_design = design_counts()


class BiZoneoutLSTMFunction(torch.autograd.Function):
    """Differentiable zoneout-BLSTM recurrence: ``apply(xp_f, xp_b, mask,
    zh_f, zh_b, zc_f, zc_b, wh_f, wh_b) -> (h_f, h_b)`` (the JAX
    ``pallas_bi_zoneout_lstm``).

    Forward is :func:`bi_zoneout_lstm`, keeping h and c of both directions;
    backward is :func:`bi_zoneout_lstm_bwd` for dxp, and ``dwh = h_prev^T
    dxp`` over all T*B rows as one matmul per direction.  The mask and the
    mix weights get no gradient."""

    @staticmethod
    def forward(ctx, xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f, wh_b):
        h_f, c_f, h_b, c_b = bi_zoneout_lstm(xp_f, xp_b, mask, zh_f, zh_b,
                                             zc_f, zc_b, wh_f, wh_b)
        ctx.save_for_backward(xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f,
                              wh_b, h_f, c_f, h_b, c_b)
        return h_f, h_b

    @staticmethod
    def backward(ctx, dh_f, dh_b):
        (xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f, wh_b, h_f, c_f, h_b,
         c_b) = ctx.saved_tensors
        dxp_f, dxp_b = bi_zoneout_lstm_bwd(
            xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f, wh_b, h_f, c_f,
            h_b, c_b, cotangent(dh_f, h_f), cotangent(dh_b, h_b))
        return (dxp_f, dxp_b, None, None, None, None, None,
                _dwh(h_f, dxp_f, False, wh_f), _dwh(h_b, dxp_b, True, wh_b))


class ZoneoutLSTMFunction(torch.autograd.Function):
    """Differentiable unidirectional zoneout-LSTM recurrence: ``apply(xp,
    mask, zh, zc, wh) -> h`` (the JAX ``pallas_zoneout_lstm``).  Forward is
    :func:`zoneout_lstm`, keeping h and c; backward is
    :func:`zoneout_lstm_bwd` and ``dwh = h_prev^T dxp``.  The mask and the
    mix weights get no gradient."""

    @staticmethod
    def forward(ctx, xp, mask, zh, zc, wh):
        h, c = zoneout_lstm(xp, mask, zh, zc, wh)
        ctx.save_for_backward(xp, mask, zh, zc, wh, h, c)
        return h

    @staticmethod
    def backward(ctx, dh):
        xp, mask, zh, zc, wh, h, c = ctx.saved_tensors
        dxp = zoneout_lstm_bwd(xp, mask, zh, zc, wh, h, c, cotangent(dh, h))
        return dxp, None, None, None, _dwh(h, dxp, False, wh)
