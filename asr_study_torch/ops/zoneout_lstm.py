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

The kernels are ``csrc/zoneout_lstm_fwd.cu`` and
``csrc/zoneout_lstm_bwd.cu``; each takes the number of directions, so
:func:`bi_zoneout_lstm` and :func:`zoneout_lstm` launch the same forward
kernel with 2 and 1 directions, and :func:`bi_zoneout_lstm_bwd` and
:func:`zoneout_lstm_bwd` the same backward kernel.  Each of the four
wrappers counts its own launches.  A CUDA tensor launches the kernel (or
raises); a CPU tensor takes the plain version, a Python loop over time.
Neither records an autograd graph: gradients go through
:class:`BiZoneoutLSTMFunction` and :class:`ZoneoutLSTMFunction`, whose
backward is the backward kernel plus one ``h_prev^T @ dxp`` matmul per
direction.  The mix weights get no gradient.
"""

from __future__ import annotations

import torch

from asr_study_torch import _build
from asr_study_torch.models.cells import zoneout_lstm_step
from asr_study_torch.ops.bilstm import _dwh
from asr_study_torch.ops.recurrence import check, cotangent, prev, stream


def _scan(xp, mask, zh, zc, wh, reverse: bool
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """One direction's mixed h and c sequences [T, B, H] in forward time
    order."""
    t_steps, batch, gh = xp.shape
    h = xp.new_zeros((batch, gh // 4))
    c = xp.new_zeros((batch, gh // 4))
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


def zoneout_lstm_plain(xp, mask, zh, zc, wh
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`zoneout_lstm`; same arguments and results."""
    return _scan(xp, mask, zh, zc, wh, False)


def _fwd_kernel(name: str, xps: list, mask: torch.Tensor, zhs: list,
                zcs: list, whs: list) -> list:
    """Launch ``zoneout_lstm_fwd`` over ``len(xps)`` directions (the second
    one walks time backward) -> [h, c] per direction, flattened."""
    t_steps, batch, gh = xps[0].shape
    outs = [torch.empty((t_steps, batch, gh // 4), dtype=torch.float32,
                        device=xps[0].device) for _ in range(2 * len(xps))]
    if outs[0].numel() == 0:
        return outs
    args = (xps[0], xps[-1], mask, zhs[0], zhs[-1], zcs[0], zcs[-1], whs[0],
            whs[-1], outs[0], outs[1], outs[-2], outs[-1])
    with torch.cuda.device(xps[0].device):
        err = _build.lib().asr_zoneout_lstm_fwd(
            *(a.data_ptr() for a in args), t_steps, batch, gh // 4,
            len(xps), stream(xps[0]))
    _build.check(err, name)
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
    wh_f, wh_b: [H, 4H] float32 recurrent weights, gate order i, f, g, o
    ->          (h_f, c_f, h_b, c_b), the mixed states, each [T, B, H] in
                forward time order; a masked frame repeats the previous
                state.  No autograd graph: :class:`BiZoneoutLSTMFunction`
                is the differentiable form.
    """
    check("bi_zoneout_lstm", 4, mask, dict(xp_f=xp_f, xp_b=xp_b),
          dict(wh_f=wh_f, wh_b=wh_b),
          dict(zh_f=zh_f, zh_b=zh_b, zc_f=zc_f, zc_b=zc_b))
    args = (xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f, wh_b)
    if xp_f.device.type == "cpu":
        with torch.no_grad():
            return bi_zoneout_lstm_plain(*args)
    outs = _fwd_kernel("bi_zoneout_lstm_fwd", [xp_f, xp_b], mask,
                       [zh_f, zh_b], [zc_f, zc_b], [wh_f, wh_b])
    bi_zoneout_lstm.launches += 1
    return tuple(outs)


bi_zoneout_lstm.launches = 0


def zoneout_lstm(xp: torch.Tensor, mask: torch.Tensor, zh: torch.Tensor,
                 zc: torch.Tensor, wh: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One unidirectional zoneout-LSTM layer's recurrence, forward only: xp
    [T, B, 4H], mask [T, B, 1], zh and zc [T, B, H], wh [H, 4H] -> (h, c),
    each [T, B, H] (see :func:`bi_zoneout_lstm`).
    :class:`ZoneoutLSTMFunction` is the differentiable form."""
    check("zoneout_lstm", 4, mask, dict(xp=xp), dict(wh=wh),
          dict(zh=zh, zc=zc))
    if xp.device.type == "cpu":
        with torch.no_grad():
            return zoneout_lstm_plain(xp, mask, zh, zc, wh)
    h, c = _fwd_kernel("zoneout_lstm_fwd", [xp], mask, [zh], [zc], [wh])
    zoneout_lstm.launches += 1
    return h, c


zoneout_lstm.launches = 0


def _walk_bwd(xp, mask, zh, zc, wh, h, c, dh_out, reverse: bool
              ) -> torch.Tensor:
    """One direction's cotangent walk (``_zo_row_bwd`` of the JAX package),
    from the end of its own time order back -> dxp.  The stored h and c are
    the mixed states, so c_new is recomputed from (xp, h_prev, c_prev)."""
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
        # cell; a held one passes dh and dc_next whole
        dh_next = dpre @ wh.t() + torch.where(m, dh * (1.0 - zh[t]), dh)
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


def _bwd_kernel(name: str, xps: list, mask: torch.Tensor, zhs: list,
                zcs: list, whs: list, hs: list, cs: list, dhs: list) -> list:
    """Launch ``zoneout_lstm_bwd`` over ``len(xps)`` directions -> dxp per
    direction."""
    outs = [torch.empty_like(x) for x in xps]
    if outs[0].numel() == 0:
        return outs
    t_steps, batch, gh = xps[0].shape
    whts = [w.t().contiguous() for w in whs]
    args = (xps[0], xps[-1], mask, zhs[0], zhs[-1], zcs[0], zcs[-1], whs[0],
            whs[-1], whts[0], whts[-1], hs[0], cs[0], hs[-1], cs[-1], dhs[0],
            dhs[-1], outs[0], outs[-1])
    with torch.cuda.device(xps[0].device):
        err = _build.lib().asr_zoneout_lstm_bwd(
            *(a.data_ptr() for a in args), t_steps, batch, gh // 4,
            len(xps), stream(xps[0]))
    _build.check(err, name)
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
    if xp_f.device.type == "cpu":
        with torch.no_grad():
            return bi_zoneout_lstm_bwd_plain(xp_f, xp_b, mask, zh_f, zh_b,
                                             zc_f, zc_b, wh_f, wh_b, h_f,
                                             c_f, h_b, c_b, dh_f, dh_b)
    dxp_f, dxp_b = _bwd_kernel("bi_zoneout_lstm_bwd", [xp_f, xp_b], mask,
                               [zh_f, zh_b], [zc_f, zc_b], [wh_f, wh_b],
                               [h_f, h_b], [c_f, c_b], [dh_f, dh_b])
    bi_zoneout_lstm_bwd.launches += 1
    return dxp_f, dxp_b


bi_zoneout_lstm_bwd.launches = 0


def zoneout_lstm_bwd(xp, mask, zh, zc, wh, h, c, dh) -> torch.Tensor:
    """The cotangent scan of :func:`zoneout_lstm` -> dxp [T, B, 4H], as in
    :func:`bi_zoneout_lstm_bwd` for one direction."""
    check("zoneout_lstm_bwd", 4, mask, dict(xp=xp), dict(wh=wh),
          dict(zh=zh, zc=zc, h=h, c=c, dh=dh))
    if xp.device.type == "cpu":
        with torch.no_grad():
            return zoneout_lstm_bwd_plain(xp, mask, zh, zc, wh, h, c, dh)
    (dxp,) = _bwd_kernel("zoneout_lstm_bwd", [xp], mask, [zh], [zc], [wh],
                         [h], [c], [dh])
    zoneout_lstm_bwd.launches += 1
    return dxp


zoneout_lstm_bwd.launches = 0


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
                _dwh(h_f, dxp_f, False), _dwh(h_b, dxp_b, True))


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
        return dxp, None, None, None, _dwh(h, dxp, False)
