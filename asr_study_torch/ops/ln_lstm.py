"""The layer-norm LSTM recurrence, forward and backward, in both of the JAX
package's forms: both directions of a bidirectional layer in one launch
(port of ``asr_study_tpu/ops/pallas_bi_ln_lstm.py`` ``pallas_bi_ln_lstm``)
and one direction (port of ``asr_study_tpu/ops/pallas_ln_lstm.py``
``pallas_ln_lstm``), each with its custom VJP.

The split of the maths is the JAX package's: ``ln_x`` has no recurrent
dependence, so the layer applies it outside over every frame and streams
``xpn = blockwise ln_x(x @ wx) + b + ln_h.b``; a step adds ``xhat(h_prev @
wh) * gh`` per gate block (``gh`` the ``ln_h`` gain), forms the gates and
c, and takes ``h = o * tanh(xhat(c) * gc + bc)`` (``ln_c``).  The port never
pads the hidden width, so every statistic is over all H units.

Two designs of the kernels, each taking the number of directions, so
:func:`bi_ln_lstm` and :func:`ln_lstm` launch the same forward kernel with 2
and 1 directions, and :func:`bi_ln_lstm_bwd` and :func:`ln_lstm_bwd` the
same backward kernel:

- ``cluster``: ``csrc/ln_lstm_fwd.cu`` and ``csrc/ln_lstm_bwd.cu``, the
  recurrent weights resident in a thread-block cluster (its threads'
  registers, and for the backward its shared memory too) for the whole
  sequence; h, the cotangent partials and every LayerNorm statistic cross
  the cluster through distributed shared memory;
- ``stream``: ``csrc/ln_lstm_stream_fwd.cu`` and
  ``csrc/ln_lstm_stream_bwd.cu``, one block per (direction, 4 rows)
  streaming ``wh`` from L2 every step, for the widths whose weights do not
  fit in a cluster (H=300, H=512).

:func:`ln_geometry` picks the design by size alone (the LSTM's fit rule of
``ops/recurrence.py``, with the LSTM kernels' thread shape); a failed build
or launch raises either way.  Each of the four wrappers counts its own
launches, in all and by design (``launches``, ``by_design``).  A CUDA tensor
launches a kernel (or raises); a CPU tensor takes the plain version, a
Python loop over time.  Neither records an autograd graph: gradients go
through :class:`BiLNLSTMFunction` and :class:`LNLSTMFunction`, whose
backward is the backward kernel (``dpre``, the gate pre-activation
cotangents, and ``dcn``, the cell-LN output's) plus :func:`_ln_param_grads`
per direction.

Masked frames hold h and c.
"""

from __future__ import annotations

import torch

from asr_study_torch import _build
from asr_study_torch.models.cells import ln_lstm_step, ln_stats
from asr_study_torch.ops.bilstm import CLUSTER_SLICE, CLUSTER_THREADS
from asr_study_torch.ops.recurrence import (STREAM_ROWS, Geometry, check,
                                            cluster_geometry, cotangent,
                                            kernel_info, prev, r4, stream)


def ln_cluster_smem(hidden: int, units: int, rows: int, ctas: int
                    ) -> tuple[int, int]:
    """Dynamic shared memory per CTA of the cluster forward and backward,
    bytes: ``FwdLayout`` and ``BwdLayout`` of ``csrc/ln_lstm_{fwd,bwd}.cu``
    (``ops/bilstm.py`` ``cluster_smem`` without the c buffer, whose unit
    state lives in registers here, and with the statistics slots: per
    sender and row, the (mean, M2) pairs of the four gate blocks and of c,
    and the backward's sums)."""
    gc, hp = 4 * units, r4(hidden)
    ks = -(-hidden // CLUSTER_SLICE)           # slices of the reduction
    hs = ks * CLUSTER_SLICE                    # h rows padded to slices
    cr = ctas * rows
    fwd = (2 * rows * hs + 2 * rows * gc + r4(2 * rows) + ks * rows * gc
           + 16 * cr + 4 * cr)
    bwd = (r4(hp * (gc + 1)) + 2 * rows * hs + 2 * rows * gc
           + 3 * r4(2 * rows * units) + r4(2 * rows) + ks * rows * gc
           + rows * gc + r4(2 * cr * units) + 24 * cr + 4 * cr + 16 * cr)
    return 4 * fwd, 4 * bwd


def ln_stream_smem(hidden: int) -> tuple[int, int]:
    """Dynamic shared memory per block of the stream forward and backward,
    bytes, by the formulas of ``csrc/ln_lstm_stream_{fwd,bwd}.cu``."""
    gates = 4 * hidden
    threads = min(-(-gates // 32) * 32, 1024)
    nsplit = max(threads // hidden, 1)
    return (4 * STREAM_ROWS * (4 * hidden + gates + 10),
            4 * STREAM_ROWS * ((6 + nsplit) * hidden + 2 * gates + 20))


def ln_geometry(hidden: int, batch: int, ndir: int) -> Geometry:
    """The design and layout of the LN-LSTM kernels for width ``hidden``,
    ``batch`` rows and ``ndir`` directions: ``cluster`` where
    :func:`~asr_study_torch.ops.recurrence.cluster_geometry` fits four gate
    columns a unit in 256 threads of 128 rows (H=256: 8 CTAs of 32 units,
    R=4 rows a cluster in one direction and R=8 in two at B=32, 8 clusters
    either way; H=100: 13 units, the last CTA 9); ``stream`` otherwise
    (H=300: 4 x 38 columns of three slices would take 456 threads; H=512).
    """
    return (cluster_geometry(hidden, batch, ndir, 4, CLUSTER_THREADS,
                             CLUSTER_SLICE, ln_cluster_smem)
            or ln_stream_geometry(hidden, batch, ndir))


def ln_stream_geometry(hidden: int, batch: int, ndir: int) -> Geometry:
    """The stream design's layout, at any width: the one
    :func:`ln_geometry` gives where the cluster design does not fit."""
    fwd, bwd = ln_stream_smem(hidden)
    return Geometry("stream", 1, hidden, STREAM_ROWS,
                    (1, -(-batch // STREAM_ROWS), ndir), fwd, bwd)


def ln_cluster_info(geo: Geometry, batch: int, hidden: int, backward: bool
                    ) -> tuple[int, int]:
    """On the card: (dynamic shared memory per CTA the kernel sizes,
    clusters of this launch the card holds at once), from the kernel's own
    launch configuration (``asr_ln_lstm_{fwd,bwd}_info``)."""
    return kernel_info("ln_lstm_bwd_info" if backward else "ln_lstm_fwd_info",
                       geo, batch, hidden)


def _scan(xpn, mask, wh, gh, gc, bc, reverse: bool
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """One direction's h and c sequences [T, B, H] in forward time order."""
    t_steps, batch, gh4 = xpn.shape
    h = xpn.new_zeros((batch, gh4 // 4))
    c = xpn.new_zeros((batch, gh4 // 4))
    hs = [None] * t_steps
    cs = [None] * t_steps
    for t in (reversed(range(t_steps)) if reverse else range(t_steps)):
        h, c = ln_lstm_step(h, c, xpn[t], mask[t], wh, gh, gc, bc)
        hs[t], cs[t] = h, c
    if not hs:
        empty = xpn.new_zeros((0, batch, gh4 // 4))
        return empty, empty.clone()
    return torch.stack(hs), torch.stack(cs)


def bi_ln_lstm_plain(xpn_f, xpn_b, mask, wh_f, wh_b, gh_f, gh_b, gc_f, gc_b,
                     bc_f, bc_b) -> tuple[torch.Tensor, ...]:
    """Plain version of :func:`bi_ln_lstm`; same arguments and results."""
    return (*_scan(xpn_f, mask, wh_f, gh_f, gc_f, bc_f, False),
            *_scan(xpn_b, mask, wh_b, gh_b, gc_b, bc_b, True))


def ln_lstm_plain(xpn, mask, wh, gh, gc, bc
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`ln_lstm`; same arguments and results."""
    return _scan(xpn, mask, wh, gh, gc, bc, False)


def _geometry(xpn: torch.Tensor, ndir: int) -> Geometry:
    return ln_geometry(xpn.shape[2] // 4, xpn.shape[1], ndir)


def launch_fwd(geo: Geometry, xpns: list, mask: torch.Tensor, whs: list,
               ghs: list, gcs: list, bcs: list) -> list:
    """Launch the forward over ``len(xpns)`` directions (the second one walks
    time backward) in the design and layout ``geo`` -> [h, c] per
    direction, flattened.  The wrappers count the launches."""
    t_steps, batch, gh4 = xpns[0].shape
    hidden, ndir = gh4 // 4, len(xpns)
    outs = [torch.empty((t_steps, batch, hidden), dtype=torch.float32,
                        device=xpns[0].device) for _ in range(2 * ndir)]
    if outs[0].numel() == 0:
        return outs
    args = (xpns[0], xpns[-1], mask, whs[0], whs[-1], ghs[0], ghs[-1],
            gcs[0], gcs[-1], bcs[0], bcs[-1], outs[0], outs[1], outs[-2],
            outs[-1])
    ptrs = (*(a.data_ptr() for a in args), t_steps, batch, hidden, ndir)
    with torch.cuda.device(xpns[0].device):
        if geo.design == "cluster":
            err = _build.lib().asr_ln_lstm_fwd(
                *ptrs, geo.ctas, geo.units, geo.rows, stream(xpns[0]))
        else:
            err = _build.lib().asr_ln_lstm_stream_fwd(*ptrs, stream(xpns[0]))
    _build.check(err, f"{'bi_ln_lstm' if ndir == 2 else 'ln_lstm'}_fwd "
                      f"({geo.design})")
    return outs


def bi_ln_lstm(xpn_f: torch.Tensor, xpn_b: torch.Tensor, mask: torch.Tensor,
               wh_f: torch.Tensor, wh_b: torch.Tensor, gh_f: torch.Tensor,
               gh_b: torch.Tensor, gc_f: torch.Tensor, gc_b: torch.Tensor,
               bc_f: torch.Tensor, bc_b: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """One LN-BLSTM layer's recurrence, both directions, forward only.

    xpn_f, xpn_b: [T, B, 4H] float32, each direction's streamed input (see
                  the module docstring), both in forward time order
    mask:         [T, B, 1] float32, 1.0 on real frames
    wh_f, wh_b:   [H, 4H] recurrent weights, gate order i, f, g, o
    gh_*:         [4H] ``ln_h`` gains;  gc_*, bc_*: [H] ``ln_c`` gain, bias
    ->            (h_f, c_f, h_b, c_b), each [T, B, H] in forward time
                  order, c before its LayerNorm; a masked frame repeats the
                  previous state.  No autograd graph:
                  :class:`BiLNLSTMFunction` is the differentiable form.
    """
    check("bi_ln_lstm", 4, mask, dict(xpn_f=xpn_f, xpn_b=xpn_b),
          dict(wh_f=wh_f, wh_b=wh_b), {}, dict(gh_f=gh_f, gh_b=gh_b),
          dict(gc_f=gc_f, gc_b=gc_b, bc_f=bc_f, bc_b=bc_b))
    args = (xpn_f, xpn_b, mask, wh_f, wh_b, gh_f, gh_b, gc_f, gc_b, bc_f,
            bc_b)
    if xpn_f.device.type == "cpu":
        with torch.no_grad():
            return bi_ln_lstm_plain(*args)
    geo = _geometry(xpn_f, 2)
    outs = launch_fwd(geo, [xpn_f, xpn_b], mask, [wh_f, wh_b], [gh_f, gh_b],
                      [gc_f, gc_b], [bc_f, bc_b])
    bi_ln_lstm.launches += 1
    bi_ln_lstm.by_design[geo.design] += 1
    return tuple(outs)


bi_ln_lstm.launches = 0
bi_ln_lstm.by_design = {"cluster": 0, "stream": 0}


def ln_lstm(xpn: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
            gh: torch.Tensor, gc: torch.Tensor, bc: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One unidirectional LN-LSTM layer's recurrence, forward only: xpn [T,
    B, 4H], mask [T, B, 1], wh [H, 4H], gh [4H], gc and bc [H] -> (h, c),
    each [T, B, H] (see :func:`bi_ln_lstm`).  :class:`LNLSTMFunction` is
    the differentiable form."""
    check("ln_lstm", 4, mask, dict(xpn=xpn), dict(wh=wh), {}, dict(gh=gh),
          dict(gc=gc, bc=bc))
    if xpn.device.type == "cpu":
        with torch.no_grad():
            return ln_lstm_plain(xpn, mask, wh, gh, gc, bc)
    geo = _geometry(xpn, 1)
    h, c = launch_fwd(geo, [xpn], mask, [wh], [gh], [gc], [bc])
    ln_lstm.launches += 1
    ln_lstm.by_design[geo.design] += 1
    return h, c


ln_lstm.launches = 0
ln_lstm.by_design = {"cluster": 0, "stream": 0}


def _ln_bwd(dy_g: torch.Tensor, xhat: torch.Tensor,
            rstd: torch.Tensor) -> torch.Tensor:
    """Backward of ``y = xhat * g`` to LN's input over the last dim, given
    ``dy_g = dy * g`` (``pallas_ln_lstm.py`` ``_ln_bwd``)."""
    m1 = dy_g.mean(dim=-1, keepdim=True)
    m2 = (dy_g * xhat).mean(dim=-1, keepdim=True)
    return rstd * (dy_g - m1 - xhat * m2)


def _walk_bwd(xpn, mask, wh, gh, gc, bc, h, c, dh_out, reverse: bool
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One direction's cotangent walk (``_ln_row_bwd`` of the JAX package),
    from the end of its own time order back -> (dpre, dcn)."""
    t_steps, batch, gh4 = xpn.shape
    hidden = gh4 // 4
    hp_seq, cp_seq = prev(h, reverse), prev(c, reverse)
    dpre_seq = torch.empty_like(xpn)
    dcn_seq = torch.empty_like(h)
    dh_next = xpn.new_zeros((batch, hidden))
    dc_next = xpn.new_zeros((batch, hidden))
    gh_g = gh.view(4, hidden)
    for t in (range(t_steps) if reverse else reversed(range(t_steps))):
        m = mask[t] > 0                                      # [B, 1]
        xhat, rstd = ln_stats((hp_seq[t] @ wh).view(batch, 4, hidden))
        pre = xpn[t] + (xhat * gh_g).view(batch, gh4)
        i, f, g, o = pre.chunk(4, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        chat, rstd_c = ln_stats(c[t])
        tc = torch.tanh(chat * gc + bc)
        dh = dh_out[t] + dh_next
        dcn = dh * o * (1.0 - tc * tc)
        dc = dc_next + _ln_bwd(dcn * gc, chat, rstd_c)
        dpre = torch.cat([dc * g * i * (1.0 - i),
                          dc * cp_seq[t] * f * (1.0 - f),
                          dc * i * (1.0 - g * g),
                          dh * tc * o * (1.0 - o)], dim=-1)
        # masked only after dc has used the unmasked dcn
        dpre = torch.where(m, dpre, 0.0)
        dcn_seq[t] = torch.where(m, dcn, 0.0)
        dpre_seq[t] = dpre
        dhp = _ln_bwd(dpre.view(batch, 4, hidden) * gh_g, xhat, rstd)
        # held frames pass h and c (and their cotangents) straight on
        dh_next = dhp.view(batch, gh4) @ wh.t() + torch.where(m, 0.0, dh)
        dc_next = torch.where(m, dc * f, dc_next)
    return dpre_seq, dcn_seq


def bi_ln_lstm_bwd_plain(xpn_f, xpn_b, mask, wh_f, wh_b, gh_f, gh_b, gc_f,
                         gc_b, bc_f, bc_b, h_f, c_f, h_b, c_b, dh_f, dh_b
                         ) -> tuple[torch.Tensor, ...]:
    """Plain version of :func:`bi_ln_lstm_bwd`."""
    return (*_walk_bwd(xpn_f, mask, wh_f, gh_f, gc_f, bc_f, h_f, c_f, dh_f,
                       False),
            *_walk_bwd(xpn_b, mask, wh_b, gh_b, gc_b, bc_b, h_b, c_b, dh_b,
                       True))


def ln_lstm_bwd_plain(xpn, mask, wh, gh, gc, bc, h, c, dh
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`ln_lstm_bwd`."""
    return _walk_bwd(xpn, mask, wh, gh, gc, bc, h, c, dh, False)


def launch_bwd(geo: Geometry, xpns: list, mask: torch.Tensor, whs: list,
               ghs: list, gcs: list, bcs: list, hs: list, cs: list,
               dhs: list) -> list:
    """Launch the backward over ``len(xpns)`` directions in the design and
    layout ``geo`` -> [dpre, dcn] per direction, flattened.  The wrappers
    count the launches."""
    outs = []
    for x, h in zip(xpns, hs):
        outs += [torch.empty_like(x), torch.empty_like(h)]
    if outs[0].numel() == 0:
        return outs
    t_steps, batch, gh4 = xpns[0].shape
    hidden, ndir = gh4 // 4, len(xpns)
    vecs = (ghs[0], ghs[-1], gcs[0], gcs[-1], bcs[0], bcs[-1], hs[0], cs[0],
            hs[-1], cs[-1], dhs[0], dhs[-1], outs[0], outs[1], outs[-2],
            outs[-1])
    with torch.cuda.device(xpns[0].device):
        if geo.design == "cluster":
            args = (xpns[0], xpns[-1], mask, whs[0], whs[-1], *vecs)
            err = _build.lib().asr_ln_lstm_bwd(
                *(a.data_ptr() for a in args), t_steps, batch, hidden, ndir,
                geo.ctas, geo.units, geo.rows, stream(xpns[0]))
        else:
            whts = [w.t().contiguous() for w in whs]
            args = (xpns[0], xpns[-1], mask, whs[0], whs[-1], whts[0],
                    whts[-1], *vecs)
            err = _build.lib().asr_ln_lstm_stream_bwd(
                *(a.data_ptr() for a in args), t_steps, batch, hidden, ndir,
                stream(xpns[0]))
    _build.check(err, f"{'bi_ln_lstm' if ndir == 2 else 'ln_lstm'}_bwd "
                      f"({geo.design})")
    return outs


def bi_ln_lstm_bwd(xpn_f, xpn_b, mask, wh_f, wh_b, gh_f, gh_b, gc_f, gc_b,
                   bc_f, bc_b, h_f, c_f, h_b, c_b, dh_f, dh_b
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Cotangent scans of both directions -> (dpre_f, dcn_f, dpre_b, dcn_b):
    dpre [T, B, 4H] of the gate pre-activations, dcn [T, B, H] of the cell
    LayerNorm's output ``xhat(c) * gc + bc``, both zero on masked frames.

    The first eleven arguments are :func:`bi_ln_lstm`'s, h_* and c_* its
    outputs, dh_f and dh_b [T, B, H] the cotangents of h_f and h_b."""
    check("bi_ln_lstm_bwd", 4, mask, dict(xpn_f=xpn_f, xpn_b=xpn_b),
          dict(wh_f=wh_f, wh_b=wh_b),
          dict(h_f=h_f, c_f=c_f, h_b=h_b, c_b=c_b, dh_f=dh_f, dh_b=dh_b),
          dict(gh_f=gh_f, gh_b=gh_b),
          dict(gc_f=gc_f, gc_b=gc_b, bc_f=bc_f, bc_b=bc_b))
    if xpn_f.device.type == "cpu":
        with torch.no_grad():
            return bi_ln_lstm_bwd_plain(xpn_f, xpn_b, mask, wh_f, wh_b, gh_f,
                                        gh_b, gc_f, gc_b, bc_f, bc_b, h_f,
                                        c_f, h_b, c_b, dh_f, dh_b)
    geo = _geometry(xpn_f, 2)
    outs = launch_bwd(geo, [xpn_f, xpn_b], mask, [wh_f, wh_b], [gh_f, gh_b],
                      [gc_f, gc_b], [bc_f, bc_b], [h_f, h_b], [c_f, c_b],
                      [dh_f, dh_b])
    bi_ln_lstm_bwd.launches += 1
    bi_ln_lstm_bwd.by_design[geo.design] += 1
    return tuple(outs)


bi_ln_lstm_bwd.launches = 0
bi_ln_lstm_bwd.by_design = {"cluster": 0, "stream": 0}


def ln_lstm_bwd(xpn, mask, wh, gh, gc, bc, h, c, dh
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cotangent scan of :func:`ln_lstm` -> (dpre, dcn), as in
    :func:`bi_ln_lstm_bwd` for one direction."""
    check("ln_lstm_bwd", 4, mask, dict(xpn=xpn), dict(wh=wh),
          dict(h=h, c=c, dh=dh), dict(gh=gh), dict(gc=gc, bc=bc))
    if xpn.device.type == "cpu":
        with torch.no_grad():
            return ln_lstm_bwd_plain(xpn, mask, wh, gh, gc, bc, h, c, dh)
    geo = _geometry(xpn, 1)
    dpre, dcn = launch_bwd(geo, [xpn], mask, [wh], [gh], [gc], [bc], [h],
                           [c], [dh])
    ln_lstm_bwd.launches += 1
    ln_lstm_bwd.by_design[geo.design] += 1
    return dpre, dcn


ln_lstm_bwd.launches = 0
ln_lstm_bwd.by_design = {"cluster": 0, "stream": 0}


def _ln_param_grads(dpre, dcn, h, c, wh, gh, reverse: bool
                    ) -> tuple[torch.Tensor, ...]:
    """(dwh, dgh, dgc, dbc) of one direction over all T*B rows at once
    (``pallas_ln_lstm.py`` ``_ln_param_grads``): one ``h_prev @ wh`` and its
    statistics, ``dgh = sum dpre * xhat_h``, ``dwh = h_prev^T dhp`` with
    ``dhp`` the LN backward of ``dpre * gh`` (not ``dpre`` itself), and
    ``dgc = sum dcn * xhat(c)``, ``dbc = sum dcn``."""
    hidden = h.shape[-1]
    h_prev = prev(h, reverse).reshape(-1, hidden)
    xhat_h, rstd_h = ln_stats((h_prev @ wh).view(-1, 4, hidden))
    dpre_g = dpre.reshape(-1, 4, hidden)
    dgh = (dpre_g * xhat_h).sum(dim=0).reshape(4 * hidden)
    dhp = _ln_bwd(dpre_g * gh.view(4, hidden), xhat_h, rstd_h)
    dwh = h_prev.t() @ dhp.reshape(-1, 4 * hidden)
    xhat_c, _ = ln_stats(c.reshape(-1, hidden))
    dcn = dcn.reshape(-1, hidden)
    return dwh, dgh, (dcn * xhat_c).sum(dim=0), dcn.sum(dim=0)


class BiLNLSTMFunction(torch.autograd.Function):
    """Differentiable LN-BLSTM recurrence: ``apply(xpn_f, xpn_b, mask, wh_f,
    wh_b, gh_f, gh_b, gc_f, gc_b, bc_f, bc_b) -> (h_f, h_b)`` (the JAX
    ``pallas_bi_ln_lstm``).

    Forward is :func:`bi_ln_lstm`, keeping h and c of both directions;
    backward is :func:`bi_ln_lstm_bwd` for dpre (the gradient of xpn) and
    dcn, and :func:`_ln_param_grads` per direction.  ``b``, ``ln_h.b`` and
    ``ln_x`` get theirs by autograd through xpn.  The mask gets none."""

    @staticmethod
    def forward(ctx, xpn_f, xpn_b, mask, wh_f, wh_b, gh_f, gh_b, gc_f, gc_b,
                bc_f, bc_b):
        h_f, c_f, h_b, c_b = bi_ln_lstm(xpn_f, xpn_b, mask, wh_f, wh_b, gh_f,
                                        gh_b, gc_f, gc_b, bc_f, bc_b)
        ctx.save_for_backward(xpn_f, xpn_b, mask, wh_f, wh_b, gh_f, gh_b,
                              gc_f, gc_b, bc_f, bc_b, h_f, c_f, h_b, c_b)
        return h_f, h_b

    @staticmethod
    def backward(ctx, dh_f, dh_b):
        (xpn_f, xpn_b, mask, wh_f, wh_b, gh_f, gh_b, gc_f, gc_b, bc_f, bc_b,
         h_f, c_f, h_b, c_b) = ctx.saved_tensors
        dpre_f, dcn_f, dpre_b, dcn_b = bi_ln_lstm_bwd(
            xpn_f, xpn_b, mask, wh_f, wh_b, gh_f, gh_b, gc_f, gc_b, bc_f,
            bc_b, h_f, c_f, h_b, c_b, cotangent(dh_f, h_f),
            cotangent(dh_b, h_b))
        gf = _ln_param_grads(dpre_f, dcn_f, h_f, c_f, wh_f, gh_f, False)
        gb = _ln_param_grads(dpre_b, dcn_b, h_b, c_b, wh_b, gh_b, True)
        return (dpre_f, dpre_b, None, gf[0], gb[0], gf[1], gb[1], gf[2],
                gb[2], gf[3], gb[3])


class LNLSTMFunction(torch.autograd.Function):
    """Differentiable unidirectional LN-LSTM recurrence: ``apply(xpn, mask,
    wh, gh, gc, bc) -> h`` (the JAX ``pallas_ln_lstm``).  Forward is
    :func:`ln_lstm`, keeping h and c; backward is :func:`ln_lstm_bwd` and
    :func:`_ln_param_grads`.  The mask gets no gradient."""

    @staticmethod
    def forward(ctx, xpn, mask, wh, gh, gc, bc):
        h, c = ln_lstm(xpn, mask, wh, gh, gc, bc)
        ctx.save_for_backward(xpn, mask, wh, gh, gc, bc, h, c)
        return h

    @staticmethod
    def backward(ctx, dh):
        xpn, mask, wh, gh, gc, bc, h, c = ctx.saved_tensors
        dpre, dcn = ln_lstm_bwd(xpn, mask, wh, gh, gc, bc, h, c,
                                cotangent(dh, h))
        return (dpre, None,
                *_ln_param_grads(dpre, dcn, h, c, wh, gh, False))
