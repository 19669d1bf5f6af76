"""Tensor parallelism for the recurrent stacks (port of
``asr_study_tpu/parallel/tp.py``): gate-dimension sharding of the plain
LSTM and GRU over the model group of ``parallel/dp.py``.

Each rank of a model group of n owns an H/n slice of EVERY gate block:
the parameters are viewed as ``[..., G, H]`` and sliced on H
(:func:`tp_slice`), so the input and recurrent products, the gate
nonlinearities and the cell state all run on ``[B, H/n]`` locally.  The
frames' only communication is ONE all-gather of the ``[B, H/n]`` hidden
state a frame (the next frame's ``h @ wh`` needs the whole h), whose
backward is the reduce-scatter of the cotangent (on gloo, which has none,
an all-reduce and this rank's slice: the same numbers).

The parameters stay REPLICATED, as in JAX: :func:`tp_slice`'s backward
all-reduces the full-weight cotangent over the model group, so every
model rank ends the step with the same gradients and the trainer's
all-reduce over the data group alone is exact.  Where the JAX scan takes
the gathered h both as the next frame's operand and as the layer's output,
the port keeps the two apart in the backward: the gathered frame feeds
only the next frame's partial product (its cotangent a partial sum on
each rank, which the reduce-scatter completes), the layer's output hands
each rank its slice of the replicated cotangent (:class:`_Output`), and
the input ``x`` enters the shard's ``x @ wx`` through :class:`_Replicated`,
whose backward all-reduces the shards' partial ``dx``.  The gradients are
then one device's; those of ``asr_study_tpu``'s TP step are n times one
device's for every recurrent weight (ROADMAP C8).

Like JAX, this path is plain tensor code, no hand kernel (the recurrence's
kernels have no cross-shard form: the all-gather sits between frames).  A
bfloat16 step rounds the operands of each product to bfloat16 with float32
accumulation (:func:`~asr_study_torch.models.nn.dot`, JAX's ``dot`` of
``tp.py``).  Supported cells: exactly ``LSTMCell`` and ``GRUCell``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from asr_study_torch.models.cells import (GRUCell, LSTMCell, gru_update,
                                          lstm_update)
from asr_study_torch.models.nn import dot


def _all_reduce(t: torch.Tensor, group: Any) -> torch.Tensor:
    """``t`` summed over the model group, in place -> ``t``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group.pg)
    return t


def _shard_view(v: torch.Tensor, num_gates: int) -> torch.Tensor:
    """``[..., G*H]`` -> ``[..., G, H]``."""
    return v.reshape(*v.shape[:-1], num_gates, v.shape[-1] // num_gates)


class _Slice(torch.autograd.Function):
    """:func:`tp_slice`: this shard's H/n of every gate block; backward
    the full cotangent (zeros outside the shard), all-reduced over the
    model group."""

    @staticmethod
    def forward(ctx, v, num_gates, group):
        ctx.num_gates, ctx.group = num_gates, group
        v3 = _shard_view(v, num_gates)
        hl = v3.shape[-1] // group.world
        loc = v3[..., group.rank * hl: (group.rank + 1) * hl]
        return loc.reshape(*v.shape[:-1], num_gates * hl).contiguous()

    @staticmethod
    def backward(ctx, ct):
        group, g = ctx.group, ctx.num_gates
        ct3 = _shard_view(ct, g)
        hl = ct3.shape[-1]
        full = ct.new_zeros((*ct.shape[:-1], g, hl * group.world),
                            dtype=torch.float32)
        full[..., group.rank * hl: (group.rank + 1) * hl] = ct3
        # one shard writes each element: the sum is exact in any dtype
        full = _all_reduce(full, group).to(ct.dtype)
        return full.reshape(*ct.shape[:-1], g * hl * group.world), None, None


def tp_slice(v: torch.Tensor, num_gates: int, group: Any,
             num_shards: int) -> torch.Tensor:
    """``[..., G*H]`` -> this shard's ``[..., G*(H/n)]`` (every gate block
    sliced on its H axis, shard ``group.rank`` of ``num_shards``).  The
    backward reassembles the FULL cotangent, all-reduced over the model
    group, so the replicated parameter's gradient is identical on every
    model rank."""
    if num_shards != group.world:
        raise ValueError(f"{num_shards} shards on a model group of "
                         f"{group.world}")
    return _Slice.apply(v, num_gates, group)


class _Gather(torch.autograd.Function):
    """One frame's local ``[B, H/n]`` -> the whole ``[B, H]`` in shard
    order; backward the reduce-scatter of the cotangent (the shards' partial
    sums, totalled, and this shard's slice)."""

    @staticmethod
    def forward(ctx, h, group):
        ctx.group = group
        parts = [torch.empty_like(h) for _ in range(group.world)]
        dist.all_gather(parts, h.contiguous(), group=group.pg)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, ct):
        group = ctx.group
        hl = ct.shape[-1] // group.world
        if group.backend == "nccl":
            out = ct.new_empty((ct.shape[0], hl))
            # shard k's columns as the k-th block of rows
            chunks = ct.reshape(-1, group.world, hl).transpose(0, 1)
            dist.reduce_scatter_tensor(out, chunks.reshape(-1, hl),
                                       op=dist.ReduceOp.SUM,
                                       group=group.pg)
            return out, None
        # gloo has no reduce-scatter: the all-reduce, then this shard's part
        full = _all_reduce(ct.contiguous().clone(), group)
        return full[..., group.rank * hl: (group.rank + 1) * hl], None


class _Replicated(torch.autograd.Function):
    """A replicated tensor entering a shard's partial product: forward the
    identity, backward the shards' partial cotangents all-reduced."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct.contiguous().clone(), ctx.group), None


class _Output(torch.autograd.Function):
    """The layer's output, the gathered frames ``h_full`` [T, B, H] (taken
    as they are), tied to the local frames ``h_loc`` [T, B, H/n]: its
    cotangent, replicated on every rank, hands each its own slice."""

    @staticmethod
    def forward(ctx, h_loc, h_full, rank):
        ctx.rank, ctx.hl = rank, h_loc.shape[-1]
        return h_full.clone()

    @staticmethod
    def backward(ctx, ct):
        lo = ctx.rank * ctx.hl
        return ct[..., lo: lo + ctx.hl], None, None


def _refuse(cell, num_shards: int) -> None:
    """Raise ValueError, with the JAX messages, unless ``cell`` is exactly
    an LSTMCell or a GRUCell whose hidden width ``num_shards`` divides."""
    if type(cell) not in (LSTMCell, GRUCell):
        raise ValueError(
            f"tensor parallelism supports lstm/gru cells, got "
            f"{type(cell).__name__} — run this cell data-parallel only")
    if cell.hidden % num_shards:
        raise ValueError(f"hidden={cell.hidden} not divisible by "
                         f"{num_shards} model shards")


def validate_tp(model, num_shards: int) -> None:
    """Fail fast (at CLI start-up) if the model cannot run tensor-parallel:
    :func:`tp_scan` takes plain LSTM and GRU cells (by type: the layer-norm,
    MI and zoneout LSTMs, subclasses of LSTMCell, are refused) with a hidden
    width the shard count divides.  Raises ValueError with the messages
    of the apply-time checks."""
    if num_shards <= 1:
        return
    for entry in model.rnn.layers:
        _refuse(entry.rnn.fw, num_shards)


def tp_scan(cell, x: torch.Tensor, mask: torch.Tensor, group: Any,
            num_shards: int, reverse: bool = False) -> torch.Tensor:
    """One direction of a gate-dim-sharded LSTM or GRU recurrence, as the
    JAX ``tp_scan``: x [T, B, F] and mask [T, B, 1] replicated across the
    model group -> [T, B, H] replicated, zeroed on masked frames (each
    frame's local [B, H/n] state all-gathered).  Gate orders i, f, g, o
    and r, z, n; a masked frame holds h (and c); ``reverse`` walks time
    backward.  Runs on every rank of ``group`` (a ``parallel.dp.
    ModelGroup``) together."""
    _refuse(cell, num_shards)
    hidden, g = cell.hidden, cell.num_gates
    hl = hidden // num_shards
    wx = tp_slice(cell.wx, g, group, num_shards)
    wh = tp_slice(cell.wh, g, group, num_shards)    # rows stay full H
    b = tp_slice(cell.b, g, group, num_shards)
    xp = dot(_Replicated.apply(x, group), wx) + b   # [T, B, G*hl]
    t_steps, batch = x.shape[:2]
    lstm = type(cell) is LSTMCell
    h_full = xp.new_zeros((batch, hidden))
    h_loc = xp.new_zeros((batch, hl))
    c_loc = xp.new_zeros((batch, hl))
    locs, fulls = [None] * t_steps, [None] * t_steps
    for t in (reversed(range(t_steps)) if reverse else range(t_steps)):
        hp = dot(h_full, wh)                        # [B, G*hl]
        if lstm:
            pre = xp[t] + hp
            i, f, gg, o = pre.chunk(4, dim=-1)
            gates = torch.cat([torch.sigmoid(i), torch.sigmoid(f),
                               torch.tanh(gg), torch.sigmoid(o)], dim=-1)
            h_loc, c_loc = lstm_update(gates, h_loc, c_loc, mask[t])
        else:
            h_loc = gru_update(hp, h_loc, xp[t], mask[t])
        h_full = _Gather.apply(h_loc, group)
        locs[t], fulls[t] = h_loc, h_full
    if not t_steps:
        return xp.new_zeros((0, batch, hidden))
    out = _Output.apply(torch.stack(locs), torch.stack(fulls).detach(),
                        group.rank)
    return out * mask


def tp_rnn_layer_apply(layer, x: torch.Tensor, mask: torch.Tensor,
                       group: Any, num_shards: int) -> torch.Tensor:
    """The TP form of ``RNNLayer.forward`` (``models/rnn.py``): each
    direction's :func:`tp_scan`, the reverse one walking backward, and
    their concatenation -> [T, B, output_dim]."""
    out_f = tp_scan(layer.fw, x, mask, group, num_shards)
    if not layer.bidirectional:
        return out_f
    out_b = tp_scan(layer.bw, x, mask, group, num_shards, reverse=True)
    return torch.cat([out_f, out_b], dim=-1)
