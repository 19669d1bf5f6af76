"""The multiplicative-integration (MI) LSTM recurrence, forward and
backward, in both of the JAX package's forms: both directions of a
bidirectional layer in one launch (port of
``asr_study_tpu/ops/pallas_bi_mi_lstm.py`` ``pallas_bi_mi_lstm``) and one
direction (port of ``asr_study_tpu/ops/pallas_mi_lstm.py``
``pallas_mi_lstm``), each with its custom VJP.

The gate pre-activation is ``alpha * xp * hp + beta1 * xp + beta2 * hp +
b`` with ``xp = x @ wx`` the raw input projection (the Hadamard term keeps
the bias out of it) and ``hp = h_prev @ wh``; alpha, beta1, beta2 and b
[4H] ride along with wh.  Then the LSTM update, gate order i, f, g, o;
masked frames hold h and c.

Two designs of the kernels, each taking the number of directions, so
:func:`bi_mi_lstm` and :func:`mi_lstm` launch the same forward kernel with 2
and 1 directions, and :func:`bi_mi_lstm_bwd` and :func:`mi_lstm_bwd` the
same backward kernel:

- ``cluster``: ``csrc/mi_lstm_fwd.cu`` and ``csrc/mi_lstm_bwd.cu``, the
  recurrent weights resident in a thread-block cluster (its threads'
  registers, and for the backward its shared memory too) for the whole
  sequence, h and the cotangent partials exchanged through distributed
  shared memory;
- ``stream``: ``csrc/mi_lstm_stream_fwd.cu`` and
  ``csrc/mi_lstm_stream_bwd.cu``, one block per (direction, 4 rows)
  streaming ``wh`` from L2 every step, for the widths whose weights do not
  fit in a cluster (H=300, H=512).

:func:`mi_geometry` picks the design by size alone (the LSTM's fit rule of
``ops/recurrence.py``, with the LSTM kernels' thread shape); a failed build
or launch raises either way.  Each of the four wrappers counts its own
launches, in all and by design (``launches``, ``by_design``).  A CUDA tensor
launches a kernel (or raises); a CPU tensor takes the plain version, a
Python loop over time.  Neither records an autograd graph: gradients go
through :class:`BiMILSTMFunction` and :class:`MILSTMFunction`, whose
backward is the backward kernel (``dpre``, the gate pre-activation
cotangents) plus :func:`dir_grads` per direction.

:func:`mi_lstm` and its plain twin start from a carried state ``h0``,
``c0`` [B, H] where given (zeros elsewhere), so a stream's chunks thread
the state that the last frame of h and c hands on (``models/rnn.py``
``RNNLayer.apply_streaming``).

bfloat16 weights (``train --bf16``, the JAX trainer's ``compute_dtype``,
under which ``pallas_bi_mi_lstm`` / ``pallas_mi_lstm`` run with a bfloat16
wh): ``wh`` may be bfloat16 in every wrapper, both directions alike, while
xp, the mask, the MI vectors (float32 copies of bfloat16 ones), h, c and
every cotangent stay float32.  Both designs then launch their
bfloat16-weight forms (the same sources, the ``_bf16`` entry points):
h_prev is rounded to bfloat16 where it enters ``hp = h_prev @ wh`` and
only there (a held frame keeps it unrounded), the backward recomputes hp
the same way and rounds ``dhp = dpre * (alpha * xp + beta2)`` before ``dhp
@ wh^T``, as the JAX kernels' ``_mm`` does, each product taken in float32;
dpre comes out unrounded.  The plain twins round the same way
(:func:`~asr_study_torch.models.nn.dot`).  :func:`dir_grads` follows the
JAX ``dir_grads``, which mixes the float32 h_prev with the bfloat16 wh:
its hp is the float32 product of the UNROUNDED h_prev and wh's values, and
``dwh`` comes back bfloat16.  No bfloat16 call takes a float32 form;
``by_design`` counts bfloat16 launches under ``cluster_bf16`` and
``stream_bf16``.
"""

from __future__ import annotations

import torch

from asr_study_torch import _build
from asr_study_torch.models.cells import mi_lstm_step
from asr_study_torch.models.nn import dot
from asr_study_torch.ops.bilstm import (CLUSTER_SLICE, CLUSTER_THREADS,
                                        cluster_smem, stream_smem)
from asr_study_torch.ops.recurrence import (STREAM_ROWS, Geometry, check,
                                            check_carry, cluster_geometry,
                                            cotangent, design_counts,
                                            design_key, kernel_info, prev,
                                            stream)


def mi_cluster_smem(hidden: int, units: int, rows: int, ctas: int
                    ) -> tuple[int, int]:
    """Dynamic shared memory per CTA of the cluster forward and backward,
    bytes: ``FwdLayout`` and ``BwdLayout`` of ``csrc/mi_lstm_{fwd,bwd}.cu``,
    the LSTM kernels' (``ops/bilstm.py`` ``cluster_smem``) with the MI
    vectors of the CTA's columns (alpha, beta1, beta2, b: 4 x 4U floats)."""
    fwd, bwd = cluster_smem(hidden, units, rows, ctas)
    vecs = 4 * 4 * 4 * units
    return fwd + vecs, bwd + vecs


def mi_stream_smem(hidden: int, bf16: bool = False) -> tuple[int, int]:
    """Dynamic shared memory per block of the stream forward and backward,
    bytes: the formulas of ``csrc/mi_lstm_stream_{fwd,bwd}.cu``, which are
    ``csrc/lstm_stream_{fwd,bwd}.cu``'s (``ops/bilstm.py``
    ``stream_smem``); with ``bf16``, of the bfloat16-weight forms (the
    forward's rounded copy of h besides)."""
    return stream_smem(hidden, bf16)


def mi_geometry(hidden: int, batch: int, ndir: int) -> Geometry:
    """The design and layout of the MI-LSTM kernels for width ``hidden``,
    ``batch`` rows and ``ndir`` directions: ``cluster`` where
    :func:`~asr_study_torch.ops.recurrence.cluster_geometry` fits four gate
    columns a unit in 256 threads of 128 rows (H=256: 8 CTAs of 32 units,
    R=4 rows a cluster in one direction and R=8 in two at B=32, 8 clusters
    either way; H=100: 13 units, the last CTA 9); ``stream`` otherwise
    (H=300: 4 x 38 columns of three slices would take 456 threads; H=512).
    """
    return (cluster_geometry(hidden, batch, ndir, 4, CLUSTER_THREADS,
                             CLUSTER_SLICE, mi_cluster_smem)
            or mi_stream_geometry(hidden, batch, ndir))


def mi_stream_geometry(hidden: int, batch: int, ndir: int) -> Geometry:
    """The stream design's layout, at any width: the one
    :func:`mi_geometry` gives where the cluster design does not fit."""
    fwd, bwd = mi_stream_smem(hidden)
    return Geometry("stream", 1, hidden, STREAM_ROWS,
                    (1, -(-batch // STREAM_ROWS), ndir), fwd, bwd)


def mi_cluster_info(geo: Geometry, batch: int, hidden: int, backward: bool
                    ) -> tuple[int, int]:
    """On the card: (dynamic shared memory per CTA the kernel sizes,
    clusters of this launch the card holds at once), from the kernel's own
    launch configuration (``asr_mi_lstm_{fwd,bwd}_info``)."""
    return kernel_info("mi_lstm_bwd_info" if backward else "mi_lstm_fwd_info",
                       geo, batch, hidden)


def _scan(xp, mask, wh, alpha, beta1, beta2, b, reverse: bool, h0=None,
          c0=None) -> tuple[torch.Tensor, torch.Tensor]:
    """One direction's h and c sequences [T, B, H] in forward time order,
    from ``h0``, ``c0`` [B, H] where given, else zeros."""
    t_steps, batch, gh = xp.shape
    h = xp.new_zeros((batch, gh // 4)) if h0 is None else h0
    c = xp.new_zeros((batch, gh // 4)) if c0 is None else c0
    hs = [None] * t_steps
    cs = [None] * t_steps
    for t in (reversed(range(t_steps)) if reverse else range(t_steps)):
        h, c = mi_lstm_step(h, c, xp[t], mask[t], wh, alpha, beta1, beta2, b)
        hs[t], cs[t] = h, c
    if not hs:
        empty = xp.new_zeros((0, batch, gh // 4))
        return empty, empty.clone()
    return torch.stack(hs), torch.stack(cs)


def bi_mi_lstm_plain(xp_f, xp_b, mask, wh_f, wh_b, alpha_f, alpha_b,
                     beta1_f, beta1_b, beta2_f, beta2_b, b_f, b_b
                     ) -> tuple[torch.Tensor, ...]:
    """Plain version of :func:`bi_mi_lstm`; same arguments and results."""
    return (*_scan(xp_f, mask, wh_f, alpha_f, beta1_f, beta2_f, b_f, False),
            *_scan(xp_b, mask, wh_b, alpha_b, beta1_b, beta2_b, b_b, True))


def mi_lstm_plain(xp, mask, wh, alpha, beta1, beta2, b, h0=None, c0=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`mi_lstm`; same arguments and results."""
    return _scan(xp, mask, wh, alpha, beta1, beta2, b, False, h0, c0)


def _geometry(xp: torch.Tensor, ndir: int) -> Geometry:
    return mi_geometry(xp.shape[2] // 4, xp.shape[1], ndir)


def _pairs(vecs: list, ndir: int) -> list:
    """alpha, beta1, beta2 and b, each as (forward, backward direction):
    ``vecs`` holds each vector of every direction in turn."""
    return [a for k in range(4)
            for a in (vecs[k * ndir], vecs[k * ndir + ndir - 1])]


def launch_fwd(geo: Geometry, xps: list, mask: torch.Tensor, whs: list,
               vecs: list, h0=None, c0=None) -> list:
    """Launch the forward over ``len(xps)`` directions (the second one walks
    time backward) in the design and layout ``geo`` -> [h, c] per
    direction, flattened.  ``vecs``: alpha, beta1, beta2 and b, each of
    every direction in turn.  ``h0``, ``c0``: the state the directions
    start from, [ndir, B, H] contiguous, or None for zeros.  The wrappers
    count the launches."""
    t_steps, batch, gh = xps[0].shape
    hidden, ndir = gh // 4, len(xps)
    outs = [torch.empty((t_steps, batch, hidden), dtype=torch.float32,
                        device=xps[0].device) for _ in range(2 * ndir)]
    if outs[0].numel() == 0:
        return outs
    args = (xps[0], xps[-1], mask, whs[0], whs[-1], *_pairs(vecs, ndir),
            outs[0], outs[1], outs[-2], outs[-1])
    ptrs = (*(a.data_ptr() for a in args),
            *(None if s is None else s.data_ptr() for s in (h0, c0)),
            t_steps, batch, hidden, ndir)
    form = "_bf16" if whs[0].dtype == torch.bfloat16 else ""
    with torch.cuda.device(xps[0].device):
        if geo.design == "cluster":
            err = getattr(_build.lib(), f"asr_mi_lstm_fwd{form}")(
                *ptrs, geo.ctas, geo.units, geo.rows, stream(xps[0]))
        else:
            err = getattr(_build.lib(), f"asr_mi_lstm_stream_fwd{form}")(
                *ptrs, stream(xps[0]))
    _build.check(err, f"{'bi_mi_lstm' if ndir == 2 else 'mi_lstm'}_fwd "
                      f"({geo.design}{form})")
    return outs


def bi_mi_lstm(xp_f: torch.Tensor, xp_b: torch.Tensor, mask: torch.Tensor,
               wh_f: torch.Tensor, wh_b: torch.Tensor,
               alpha_f: torch.Tensor, alpha_b: torch.Tensor,
               beta1_f: torch.Tensor, beta1_b: torch.Tensor,
               beta2_f: torch.Tensor, beta2_b: torch.Tensor,
               b_f: torch.Tensor, b_b: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """One MI-BLSTM layer's recurrence, both directions, forward only.

    xp_f, xp_b: [T, B, 4H] float32, the raw ``x @ wx`` of each direction,
                both in forward time order (the reverse walk happens inside)
    mask:       [T, B, 1] float32, 1.0 on real frames
    wh_f, wh_b: [H, 4H] float32 (or both bfloat16) recurrent weights, gate
                order i, f, g, o
    alpha_*, beta1_*, beta2_*, b_*: [4H] float32 MI vectors
    ->          (h_f, c_f, h_b, c_b), each [T, B, H] in forward time order;
                a masked frame repeats the previous state.  No autograd
                graph: :class:`BiMILSTMFunction` is the differentiable form.
    """
    check("bi_mi_lstm", 4, mask, dict(xp_f=xp_f, xp_b=xp_b),
          dict(wh_f=wh_f, wh_b=wh_b), {},
          dict(alpha_f=alpha_f, alpha_b=alpha_b, beta1_f=beta1_f,
               beta1_b=beta1_b, beta2_f=beta2_f, beta2_b=beta2_b, b_f=b_f,
               b_b=b_b))
    args = (xp_f, xp_b, mask, wh_f, wh_b, alpha_f, alpha_b, beta1_f,
            beta1_b, beta2_f, beta2_b, b_f, b_b)
    geo = _geometry(xp_f, 2)
    if xp_f.device.type == "cpu":
        with torch.no_grad():
            return bi_mi_lstm_plain(*args)
    outs = launch_fwd(geo, [xp_f, xp_b], mask, [wh_f, wh_b], list(args[5:]))
    bi_mi_lstm.launches += 1
    bi_mi_lstm.by_design[design_key(geo, wh_f)] += 1
    return tuple(outs)


bi_mi_lstm.launches = 0
bi_mi_lstm.by_design = design_counts()


def mi_lstm(xp: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
            alpha: torch.Tensor, beta1: torch.Tensor, beta2: torch.Tensor,
            b: torch.Tensor, h0: torch.Tensor | None = None,
            c0: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One unidirectional MI-LSTM layer's recurrence, forward only: xp [T,
    B, 4H] raw, mask [T, B, 1], wh [H, 4H], alpha, beta1, beta2 and b [4H]
    -> (h, c), each [T, B, H] (see :func:`bi_mi_lstm`).  ``h0`` and ``c0``
    [B, H], both or neither, are the state the recurrence starts from
    (zeros where not given); h[T-1] and c[T-1] are the state it ends in.
    :class:`MILSTMFunction` is the differentiable form."""
    check("mi_lstm", 4, mask, dict(xp=xp), dict(wh=wh), {},
          dict(alpha=alpha, beta1=beta1, beta2=beta2, b=b))
    check_carry("mi_lstm", xp, 4, h0=h0, c0=c0)
    geo = _geometry(xp, 1)
    if xp.device.type == "cpu":
        with torch.no_grad():
            return mi_lstm_plain(xp, mask, wh, alpha, beta1, beta2, b, h0,
                                 c0)
    h, c = launch_fwd(geo, [xp], mask, [wh], [alpha, beta1, beta2, b], h0,
                      c0)
    mi_lstm.launches += 1
    mi_lstm.by_design[design_key(geo, wh)] += 1
    return h, c


mi_lstm.launches = 0
mi_lstm.by_design = design_counts()


def _walk_bwd(xp, mask, wh, alpha, beta1, beta2, b, h, c, dh_out,
              reverse: bool) -> torch.Tensor:
    """One direction's cotangent walk (``_mi_row_bwd`` of the JAX package),
    from the end of its own time order back -> dpre.  The recurrent chain
    goes through ``dhp = dpre * (alpha * xp + beta2)`` and ``wh^T``; both
    products in wh's dtype (:func:`dot`), dpre unrounded."""
    t_steps, batch, gh = xp.shape
    hp_seq, cp_seq = prev(h, reverse), prev(c, reverse)
    dpre_seq = torch.empty_like(xp)
    dh_next = xp.new_zeros((batch, gh // 4))
    dc_next = xp.new_zeros((batch, gh // 4))
    for t in (range(t_steps) if reverse else reversed(range(t_steps))):
        m = mask[t] > 0                                      # [B, 1]
        hp = dot(hp_seq[t], wh)
        gates = alpha * xp[t] * hp + beta1 * xp[t] + beta2 * hp + b
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        dh = dh_out[t] + dh_next
        tc = torch.tanh(c[t])
        dc = dc_next + dh * o * (1.0 - tc * tc)
        dpre = torch.cat([dc * g * i * (1.0 - i),
                          dc * cp_seq[t] * f * (1.0 - f),
                          dc * i * (1.0 - g * g),
                          dh * tc * o * (1.0 - o)], dim=-1)
        dpre = torch.where(m, dpre, 0.0)
        dpre_seq[t] = dpre
        dhp = dpre * (alpha * xp[t] + beta2)
        # held frames pass h and c (and their cotangents) straight on; with
        # bfloat16 weights dhp is rounded before the product (dot)
        dh_next = dot(dhp, wh.t()) + torch.where(m, 0.0, dh)
        dc_next = torch.where(m, dc * f, dc_next)
    return dpre_seq


def bi_mi_lstm_bwd_plain(xp_f, xp_b, mask, wh_f, wh_b, alpha_f, alpha_b,
                         beta1_f, beta1_b, beta2_f, beta2_b, b_f, b_b, h_f,
                         c_f, h_b, c_b, dh_f, dh_b
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`bi_mi_lstm_bwd`."""
    return (_walk_bwd(xp_f, mask, wh_f, alpha_f, beta1_f, beta2_f, b_f, h_f,
                      c_f, dh_f, False),
            _walk_bwd(xp_b, mask, wh_b, alpha_b, beta1_b, beta2_b, b_b, h_b,
                      c_b, dh_b, True))


def mi_lstm_bwd_plain(xp, mask, wh, alpha, beta1, beta2, b, h, c, dh
                      ) -> torch.Tensor:
    """Plain version of :func:`mi_lstm_bwd`."""
    return _walk_bwd(xp, mask, wh, alpha, beta1, beta2, b, h, c, dh, False)


def launch_bwd(geo: Geometry, xps: list, mask: torch.Tensor, whs: list,
               vecs: list, hs: list, cs: list, dhs: list) -> list:
    """Launch the backward over ``len(xps)`` directions in the design and
    layout ``geo`` -> dpre per direction (``vecs`` as in
    :func:`launch_fwd`).  The cluster design holds its slice of ``wh`` on
    chip; the stream design also reads ``wh`` transposed, made here.  The
    wrappers count the launches."""
    outs = [torch.empty_like(x) for x in xps]
    if outs[0].numel() == 0:
        return outs
    t_steps, batch, gh = xps[0].shape
    hidden, ndir = gh // 4, len(xps)
    seqs = (*_pairs(vecs, ndir), hs[0], cs[0], hs[-1], cs[-1], dhs[0],
            dhs[-1], outs[0], outs[-1])
    form = "_bf16" if whs[0].dtype == torch.bfloat16 else ""
    with torch.cuda.device(xps[0].device):
        if geo.design == "cluster":
            args = (xps[0], xps[-1], mask, whs[0], whs[-1], *seqs)
            err = getattr(_build.lib(), f"asr_mi_lstm_bwd{form}")(
                *(a.data_ptr() for a in args), t_steps, batch, hidden, ndir,
                geo.ctas, geo.units, geo.rows, stream(xps[0]))
        else:
            whts = [w.t().contiguous() for w in whs]
            args = (xps[0], xps[-1], mask, whs[0], whs[-1], whts[0],
                    whts[-1], *seqs)
            err = getattr(_build.lib(), f"asr_mi_lstm_stream_bwd{form}")(
                *(a.data_ptr() for a in args), t_steps, batch, hidden, ndir,
                stream(xps[0]))
    _build.check(err, f"{'bi_mi_lstm' if ndir == 2 else 'mi_lstm'}_bwd "
                      f"({geo.design}{form})")
    return outs


def bi_mi_lstm_bwd(xp_f, xp_b, mask, wh_f, wh_b, alpha_f, alpha_b, beta1_f,
                   beta1_b, beta2_f, beta2_b, b_f, b_b, h_f, c_f, h_b, c_b,
                   dh_f, dh_b) -> tuple[torch.Tensor, torch.Tensor]:
    """Cotangent scans of both directions -> (dpre_f, dpre_b) [T, B, 4H],
    the cotangents of the gate pre-activations, zero on masked frames.

    The first thirteen arguments are :func:`bi_mi_lstm`'s, h_* and c_* its
    outputs, dh_f and dh_b [T, B, H] the cotangents of h_f and h_b."""
    check("bi_mi_lstm_bwd", 4, mask, dict(xp_f=xp_f, xp_b=xp_b),
          dict(wh_f=wh_f, wh_b=wh_b),
          dict(h_f=h_f, c_f=c_f, h_b=h_b, c_b=c_b, dh_f=dh_f, dh_b=dh_b),
          dict(alpha_f=alpha_f, alpha_b=alpha_b, beta1_f=beta1_f,
               beta1_b=beta1_b, beta2_f=beta2_f, beta2_b=beta2_b, b_f=b_f,
               b_b=b_b))
    vecs = [alpha_f, alpha_b, beta1_f, beta1_b, beta2_f, beta2_b, b_f, b_b]
    geo = _geometry(xp_f, 2)
    if xp_f.device.type == "cpu":
        with torch.no_grad():
            return bi_mi_lstm_bwd_plain(xp_f, xp_b, mask, wh_f, wh_b, *vecs,
                                        h_f, c_f, h_b, c_b, dh_f, dh_b)
    dpre_f, dpre_b = launch_bwd(geo, [xp_f, xp_b], mask, [wh_f, wh_b], vecs,
                                [h_f, h_b], [c_f, c_b], [dh_f, dh_b])
    bi_mi_lstm_bwd.launches += 1
    bi_mi_lstm_bwd.by_design[design_key(geo, wh_f)] += 1
    return dpre_f, dpre_b


bi_mi_lstm_bwd.launches = 0
bi_mi_lstm_bwd.by_design = design_counts()


def mi_lstm_bwd(xp, mask, wh, alpha, beta1, beta2, b, h, c, dh
                ) -> torch.Tensor:
    """The cotangent scan of :func:`mi_lstm` -> dpre [T, B, 4H], as in
    :func:`bi_mi_lstm_bwd` for one direction."""
    check("mi_lstm_bwd", 4, mask, dict(xp=xp), dict(wh=wh),
          dict(h=h, c=c, dh=dh),
          dict(alpha=alpha, beta1=beta1, beta2=beta2, b=b))
    geo = _geometry(xp, 1)
    if xp.device.type == "cpu":
        with torch.no_grad():
            return mi_lstm_bwd_plain(xp, mask, wh, alpha, beta1, beta2, b, h,
                                     c, dh)
    (dpre,) = launch_bwd(geo, [xp], mask, [wh], [alpha, beta1, beta2, b],
                         [h], [c], [dh])
    mi_lstm_bwd.launches += 1
    mi_lstm_bwd.by_design[design_key(geo, wh)] += 1
    return dpre


mi_lstm_bwd.launches = 0
mi_lstm_bwd.by_design = design_counts()


def dir_grads(dpre, xp, h, wh, alpha, beta1, beta2, reverse: bool
              ) -> tuple[torch.Tensor, ...]:
    """(dxp, dwh, dalpha, dbeta1, dbeta2, db) of one direction from the
    kernel's dpre, over all T*B rows at once (``pallas_mi_lstm.py``
    ``dir_grads``): one ``hp = h_prev @ wh``, then ``dxp = dpre * (alpha *
    hp + beta1)``, ``dhp = dpre * (alpha * xp + beta2)``, ``dwh =
    h_prev^T dhp`` (not ``dpre``) and the vectors' sums.  dpre is zero on
    masked frames, so every sum is mask-correct.  Both products are
    float32 on the unrounded h_prev, a bfloat16 wh taken at its values (the
    JAX einsum's promotion of its float32 h_prev and bfloat16 wh, not the
    kernels' rounded product), and dwh is cast to wh's dtype."""
    hidden = h.shape[-1]
    h_prev = prev(h, reverse).reshape(-1, hidden)
    dpre = dpre.reshape(-1, 4 * hidden)
    xp = xp.reshape(-1, 4 * hidden)
    hp = h_prev @ wh.float()
    dxp = dpre * (alpha * hp + beta1)
    dwh = (h_prev.t() @ (dpre * (alpha * xp + beta2))).to(wh.dtype)
    xph = dpre * xp
    return (dxp.view(h.shape[0], h.shape[1], 4 * hidden), dwh,
            (xph * hp).sum(dim=0), xph.sum(dim=0), (dpre * hp).sum(dim=0),
            dpre.sum(dim=0))


class BiMILSTMFunction(torch.autograd.Function):
    """Differentiable MI-BLSTM recurrence: ``apply(xp_f, xp_b, mask, wh_f,
    wh_b, alpha_f, alpha_b, beta1_f, beta1_b, beta2_f, beta2_b, b_f, b_b) ->
    (h_f, h_b)`` (the JAX ``pallas_bi_mi_lstm``).

    Forward is :func:`bi_mi_lstm`, keeping h and c of both directions;
    backward is :func:`bi_mi_lstm_bwd` for dpre and :func:`dir_grads` per
    direction.  The mask gets no gradient."""

    @staticmethod
    def forward(ctx, xp_f, xp_b, mask, wh_f, wh_b, alpha_f, alpha_b,
                beta1_f, beta1_b, beta2_f, beta2_b, b_f, b_b):
        args = (xp_f, xp_b, mask, wh_f, wh_b, alpha_f, alpha_b, beta1_f,
                beta1_b, beta2_f, beta2_b, b_f, b_b)
        h_f, c_f, h_b, c_b = bi_mi_lstm(*args)
        ctx.save_for_backward(*args, h_f, c_f, h_b, c_b)
        return h_f, h_b

    @staticmethod
    def backward(ctx, dh_f, dh_b):
        saved = ctx.saved_tensors
        args, (h_f, c_f, h_b, c_b) = saved[:13], saved[13:]
        xp_f, xp_b, _, wh_f, wh_b = args[:5]
        al_f, al_b, b1_f, b1_b, b2_f, b2_b = args[5:11]
        dpre_f, dpre_b = bi_mi_lstm_bwd(*args, h_f, c_f, h_b, c_b,
                                        cotangent(dh_f, h_f),
                                        cotangent(dh_b, h_b))
        gf = dir_grads(dpre_f, xp_f, h_f, wh_f, al_f, b1_f, b2_f, False)
        gb = dir_grads(dpre_b, xp_b, h_b, wh_b, al_b, b1_b, b2_b, True)
        return (gf[0], gb[0], None, gf[1], gb[1], gf[2], gb[2], gf[3], gb[3],
                gf[4], gb[4], gf[5], gb[5])


class MILSTMFunction(torch.autograd.Function):
    """Differentiable unidirectional MI-LSTM recurrence: ``apply(xp, mask,
    wh, alpha, beta1, beta2, b) -> h`` (the JAX ``pallas_mi_lstm``).
    Forward is :func:`mi_lstm`, keeping h and c; backward is
    :func:`mi_lstm_bwd` and :func:`dir_grads`.  The mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, xp, mask, wh, alpha, beta1, beta2, b):
        h, c = mi_lstm(xp, mask, wh, alpha, beta1, beta2, b)
        ctx.save_for_backward(xp, mask, wh, alpha, beta1, beta2, b, h, c)
        return h

    @staticmethod
    def backward(ctx, dh):
        xp, mask, wh, alpha, beta1, beta2, b, h, c = ctx.saved_tensors
        dpre = mi_lstm_bwd(xp, mask, wh, alpha, beta1, beta2, b, h, c,
                           cotangent(dh, h))
        dxp, dwh, dal, db1, db2, db = dir_grads(dpre, xp, h, wh, alpha,
                                                beta1, beta2, False)
        return dxp, None, dwh, dal, db1, db2, db
