"""The GRU recurrence, forward and backward, in both of the JAX package's
forms: both directions of a bidirectional layer in one launch (port of
``asr_study_tpu/ops/pallas_bigru.py`` ``pallas_bigru``) and one direction
(port of ``asr_study_tpu/ops/pallas_gru.py`` ``pallas_gru``), each with its
custom VJP.

The kernels are ``csrc/gru_fwd.cu`` and ``csrc/gru_bwd.cu``; each takes the
number of directions, so :func:`bigru` and :func:`gru` launch the same
forward kernel with 2 and 1 directions, and :func:`bigru_bwd` and
:func:`gru_bwd` the same backward kernel.  Each of the four wrappers counts
its own launches.  A CUDA tensor launches the kernel (or raises); a CPU
tensor takes the plain version, a Python loop over time.  Neither records
an autograd graph: gradients go through :class:`BiGRUFunction` and
:class:`GRUFunction`, whose backward is the backward kernel plus one
``h_prev^T @ dhp`` matmul per direction for the recurrent weights.

Gate order r, z, n with every bias folded into ``xp`` (valid because
``n = tanh((xn + bn) + r * hn)``).  Masked frames hold ``h``.
"""

from __future__ import annotations

import torch

from asr_study_torch import _build
from asr_study_torch.models.cells import gru_step
from asr_study_torch.ops.recurrence import check, cotangent, prev, stream


def _scan(xp: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
          reverse: bool) -> torch.Tensor:
    """One direction's h sequence [T, B, H] in forward time order."""
    t_steps, batch, gh = xp.shape
    h = xp.new_zeros((batch, gh // 3))
    hs = [None] * t_steps
    for t in (reversed(range(t_steps)) if reverse else range(t_steps)):
        h = gru_step(h, xp[t], mask[t], wh)
        hs[t] = h
    return torch.stack(hs) if hs else xp.new_zeros((0, batch, gh // 3))


def bigru_plain(xp_f: torch.Tensor, xp_b: torch.Tensor, mask: torch.Tensor,
                wh_f: torch.Tensor, wh_b: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`bigru`; same arguments and results."""
    return _scan(xp_f, mask, wh_f, False), _scan(xp_b, mask, wh_b, True)


def gru_plain(xp: torch.Tensor, mask: torch.Tensor,
              wh: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gru`; same arguments and result."""
    return _scan(xp, mask, wh, False)


def _fwd_kernel(name: str, xps: list, mask: torch.Tensor,
                whs: list) -> list:
    """Launch ``gru_fwd`` over ``len(xps)`` directions (the second one
    walks time backward) -> one h sequence per direction."""
    t_steps, batch, gh = xps[0].shape
    outs = [torch.empty((t_steps, batch, gh // 3), dtype=torch.float32,
                        device=xps[0].device) for _ in xps]
    if outs[0].numel() == 0:
        return outs
    with torch.cuda.device(xps[0].device):
        err = _build.lib().asr_gru_fwd(
            xps[0].data_ptr(), xps[-1].data_ptr(), mask.data_ptr(),
            whs[0].data_ptr(), whs[-1].data_ptr(), outs[0].data_ptr(),
            outs[-1].data_ptr(), t_steps, batch, gh // 3, len(xps),
            stream(xps[0]))
    _build.check(err, name)
    return outs


def bigru(xp_f: torch.Tensor, xp_b: torch.Tensor, mask: torch.Tensor,
          wh_f: torch.Tensor, wh_b: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """One bidirectional GRU layer's recurrence, both directions, forward
    only.

    xp_f, xp_b: [T, B, 3H] float32, ``x @ wx + b`` of each direction, both in
                forward time order (the reverse walk happens inside)
    mask:       [T, B, 1] float32, 1.0 on real frames
    wh_f, wh_b: [H, 3H] float32 recurrent weights, gate order r, z, n
    ->          (h_f, h_b), each [T, B, H] in forward time order; a masked
                frame repeats the previous h.  No autograd graph:
                :class:`BiGRUFunction` is the differentiable form.
    """
    check("bigru", 3, mask, dict(xp_f=xp_f, xp_b=xp_b),
          dict(wh_f=wh_f, wh_b=wh_b), {})
    if xp_f.device.type == "cpu":
        with torch.no_grad():
            return bigru_plain(xp_f, xp_b, mask, wh_f, wh_b)
    h_f, h_b = _fwd_kernel("bigru_fwd", [xp_f, xp_b], mask, [wh_f, wh_b])
    bigru.launches += 1
    return h_f, h_b


bigru.launches = 0


def gru(xp: torch.Tensor, mask: torch.Tensor,
        wh: torch.Tensor) -> torch.Tensor:
    """One unidirectional GRU layer's recurrence, forward only: xp [T, B,
    3H], mask [T, B, 1], wh [H, 3H] -> h [T, B, H] (see :func:`bigru`).
    :class:`GRUFunction` is the differentiable form."""
    check("gru", 3, mask, dict(xp=xp), dict(wh=wh), {})
    if xp.device.type == "cpu":
        with torch.no_grad():
            return gru_plain(xp, mask, wh)
    (h,) = _fwd_kernel("gru_fwd", [xp], mask, [wh])
    gru.launches += 1
    return h


gru.launches = 0


def _walk_bwd(xp, mask, wh, h, dh_out, reverse: bool
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One direction's cotangent walk (``_gru_row_bwd`` of the JAX
    package), from the end of its own time order back -> (dxp, dhp)."""
    t_steps, batch, gh = xp.shape
    hp = prev(h, reverse)
    dxp, dhp = torch.empty_like(xp), torch.empty_like(xp)
    dh_next = xp.new_zeros((batch, gh // 3))
    for t in (range(t_steps) if reverse else reversed(range(t_steps))):
        m = mask[t] > 0                                      # [B, 1]
        hr, hz, hn = (hp[t] @ wh).chunk(3, dim=-1)
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
        # a held frame passes its h (and the cotangent) straight on
        dh_next = dhp[t] @ wh.t() + torch.where(m, dh * z, dh)
    return dxp, dhp


def bigru_bwd_plain(xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b, dh_f, dh_b
                    ) -> tuple[torch.Tensor, ...]:
    """Plain version of :func:`bigru_bwd`."""
    return (*_walk_bwd(xp_f, mask, wh_f, h_f, dh_f, False),
            *_walk_bwd(xp_b, mask, wh_b, h_b, dh_b, True))


def gru_bwd_plain(xp, mask, wh, h, dh) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`gru_bwd`."""
    return _walk_bwd(xp, mask, wh, h, dh, False)


def _bwd_kernel(name: str, xps: list, mask: torch.Tensor, whs: list,
                hs: list, dhs: list) -> list:
    """Launch ``gru_bwd`` over ``len(xps)`` directions -> [dxp, dhp] per
    direction, flattened."""
    outs = [torch.empty_like(xps[0]) for _ in range(2 * len(xps))]
    if outs[0].numel() == 0:
        return outs
    t_steps, batch, gh = xps[0].shape
    whts = [w.t().contiguous() for w in whs]
    args = (xps[0], xps[-1], mask, whs[0], whs[-1], whts[0], whts[-1],
            hs[0], hs[-1], dhs[0], dhs[-1], outs[0], outs[1], outs[-2],
            outs[-1])
    with torch.cuda.device(xps[0].device):
        err = _build.lib().asr_gru_bwd(
            *(t.data_ptr() for t in args), t_steps, batch, gh // 3,
            len(xps), stream(xps[0]))
    _build.check(err, name)
    return outs


def bigru_bwd(xp_f: torch.Tensor, xp_b: torch.Tensor, mask: torch.Tensor,
              wh_f: torch.Tensor, wh_b: torch.Tensor, h_f: torch.Tensor,
              h_b: torch.Tensor, dh_f: torch.Tensor, dh_b: torch.Tensor
              ) -> tuple[torch.Tensor, ...]:
    """Cotangent walks of both directions -> (dxp_f, dhp_f, dxp_b, dhp_b),
    each [T, B, 3H].

    The first five arguments are :func:`bigru`'s, h_f and h_b its outputs,
    dh_f and dh_b [T, B, H] their cotangents.  ``dxp = [dr, dz, dn]`` and
    ``dhp = [dr, dz, dn * r]`` (pre-activation gradients on the x and h
    side), both zero on masked frames; the recurrent weight gradient is
    ``h_prev^T dhp``."""
    check("bigru_bwd", 3, mask, dict(xp_f=xp_f, xp_b=xp_b),
          dict(wh_f=wh_f, wh_b=wh_b),
          dict(h_f=h_f, h_b=h_b, dh_f=dh_f, dh_b=dh_b))
    if xp_f.device.type == "cpu":
        with torch.no_grad():
            return bigru_bwd_plain(xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b,
                                   dh_f, dh_b)
    outs = _bwd_kernel("bigru_bwd", [xp_f, xp_b], mask, [wh_f, wh_b],
                       [h_f, h_b], [dh_f, dh_b])
    bigru_bwd.launches += 1
    return tuple(outs)


bigru_bwd.launches = 0


def gru_bwd(xp: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
            h: torch.Tensor, dh: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cotangent walk of :func:`gru` -> (dxp, dhp), as in
    :func:`bigru_bwd` for one direction."""
    check("gru_bwd", 3, mask, dict(xp=xp), dict(wh=wh), dict(h=h, dh=dh))
    if xp.device.type == "cpu":
        with torch.no_grad():
            return gru_bwd_plain(xp, mask, wh, h, dh)
    dxp, dhp = _bwd_kernel("gru_bwd", [xp], mask, [wh], [h], [dh])
    gru_bwd.launches += 1
    return dxp, dhp


gru_bwd.launches = 0


def _dwh(h: torch.Tensor, dhp: torch.Tensor, reverse: bool) -> torch.Tensor:
    """``h_prev^T dhp`` over all T*B rows (not ``dxp``: its n block lacks
    the factor r)."""
    hidden = h.shape[-1]
    return prev(h, reverse).reshape(-1, hidden).t() @ dhp.reshape(
        -1, 3 * hidden)


class BiGRUFunction(torch.autograd.Function):
    """Differentiable bidirectional GRU recurrence: ``apply(xp_f, xp_b,
    mask, wh_f, wh_b) -> (h_f, h_b)`` (the JAX ``pallas_bigru``).  The mask
    gets no gradient."""

    @staticmethod
    def forward(ctx, xp_f, xp_b, mask, wh_f, wh_b):
        h_f, h_b = bigru(xp_f, xp_b, mask, wh_f, wh_b)
        ctx.save_for_backward(xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b)
        return h_f, h_b

    @staticmethod
    def backward(ctx, dh_f, dh_b):
        xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b = ctx.saved_tensors
        dxp_f, dhp_f, dxp_b, dhp_b = bigru_bwd(
            xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b, cotangent(dh_f, h_f),
            cotangent(dh_b, h_b))
        return (dxp_f, dxp_b, None, _dwh(h_f, dhp_f, False),
                _dwh(h_b, dhp_b, True))


class GRUFunction(torch.autograd.Function):
    """Differentiable unidirectional GRU recurrence: ``apply(xp, mask, wh)
    -> h`` (the JAX ``pallas_gru``).  The mask gets no gradient."""

    @staticmethod
    def forward(ctx, xp, mask, wh):
        h = gru(xp, mask, wh)
        ctx.save_for_backward(xp, mask, wh, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        xp, mask, wh, h = ctx.saved_tensors
        dxp, dhp = gru_bwd(xp, mask, wh, h, cotangent(dh, h))
        return dxp, None, _dwh(h, dhp, False)
