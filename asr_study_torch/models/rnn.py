"""Recurrent layers and their stack (port of ``asr_study_tpu/models/rnn.py``).

Time-major [T, B, F] inside.  Each layer follows the JAX fused paths: the
input projection of each direction is one matmul over all frames, which the
cell's ``prepare`` turns into the streamed tensor (``x @ wx + b``; for the
layer-norm LSTM ``xpn``, with ``ln_x`` applied; for the MI LSTM the raw
``x @ wx``) and the op's other arguments (for the zoneout LSTM its mix
weights, drawn there in train mode), and the recurrence runs in one
differentiable op (the forward and backward kernels on a CUDA device) —
both directions of a bidirectional layer together
(``RNNLayer._apply_fused_bidi``: ``ops.bilstm.BiLSTMFunction``,
``ops.gru.BiGRUFunction``, ``ops.ln_lstm.BiLNLSTMFunction``,
``ops.zoneout_lstm.BiZoneoutLSTMFunction`` or ``ops.mi_lstm.BiMILSTMFunction``),
or the one direction of a unidirectional layer (``scan_cell``'s Pallas path:
``LSTMFunction``, ``GRUFunction``, ``LNLSTMFunction``,
``ZoneoutLSTMFunction`` or ``MILSTMFunction``).  The output is zeroed on
padded frames.

Ported: every cell of the JAX package (LSTM, layer-norm, zoneout and MI
LSTM, GRU), uni- and bidirectional layers of each, the skip kinds
``none``, ``residual`` and ``highway``, inter-layer dropout in training.
In train mode the draws from the caller's generator go layer by layer:
the forward cell's zoneout zh and zc, the backward cell's, then the
layer's dropout.

Streaming (``apply_streaming``, ``init_stream_carry``; the JAX forms at
``asr_study_tpu/models/rnn.py`` ``RNNLayer.apply_streaming`` and
``StackedRNN.apply_streaming``): one chunk of a unidirectional stack of
any cell kind with each layer's state carried in and out, one launch of the
layer's forward kernel a chunk on a CUDA device (``ops.bilstm.lstm``,
``ops.gru.gru``, ``ops.ln_lstm.ln_lstm``, ``ops.mi_lstm.mi_lstm`` or
``ops.zoneout_lstm.zoneout_lstm`` started from the carry), inference only:
the zoneout cell mixes with its eval-mode constants.

Tensor parallelism (``tp=(model group, shards)``, the JAX ``tp=``): each
layer runs ``parallel.tp.tp_rnn_layer_apply``, the gate-dim-sharded scan of
the plain LSTM and GRU, in place of the kernel Functions.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from asr_study_torch.models.cells import (GRUCell, LayerNormLSTMCell,
                                          LSTMCell, MILSTMCell,
                                          ZoneoutLSTMCell)
from asr_study_torch.models.nn import dense_apply, dense_init
from asr_study_torch.models.nn import dropout as dropout_fn
from asr_study_torch.ops.bilstm import BiLSTMFunction, LSTMFunction, lstm
from asr_study_torch.ops.gru import BiGRUFunction, GRUFunction, gru
from asr_study_torch.ops.ln_lstm import (BiLNLSTMFunction, LNLSTMFunction,
                                         ln_lstm)
from asr_study_torch.ops.mi_lstm import (BiMILSTMFunction, MILSTMFunction,
                                         mi_lstm)
from asr_study_torch.ops.zoneout_lstm import (BiZoneoutLSTMFunction,
                                              ZoneoutLSTMFunction,
                                              zoneout_lstm)
from asr_study_torch.parallel.tp import tp_rnn_layer_apply

# cell kind -> (cell, fused bidirectional op, unidirectional op)
_KINDS = {"lstm": (LSTMCell, BiLSTMFunction, LSTMFunction),
          "gru": (GRUCell, BiGRUFunction, GRUFunction),
          "ln_lstm": (LayerNormLSTMCell, BiLNLSTMFunction, LNLSTMFunction),
          "zoneout_lstm": (ZoneoutLSTMCell, BiZoneoutLSTMFunction,
                           ZoneoutLSTMFunction),
          "mi_lstm": (MILSTMCell, BiMILSTMFunction, MILSTMFunction)}
# cell kind -> the forward op that starts from a carried state (the carry:
# (h,) for the GRU, (h, c) for every LSTM kind, as the JAX cells' carries)
_STREAM_OPS = {"lstm": lstm, "gru": gru, "ln_lstm": ln_lstm,
               "mi_lstm": mi_lstm, "zoneout_lstm": zoneout_lstm}
_UNIDIRECTIONAL = ("streaming requires a unidirectional layer — build the "
                   "model with bidirectional=false")


class RNNLayer(nn.Module):
    """One recurrent layer; parameters under ``fw`` (and ``bw`` when
    bidirectional).  ``cell_kw`` goes to the cell (the zoneout LSTM's
    ``zoneout_h`` and ``zoneout_c``)."""

    def __init__(self, cell_kind: str, input_dim: int, hidden: int,
                 bidirectional: bool = True,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str | None = None, **cell_kw):
        super().__init__()
        if cell_kind not in _KINDS:
            raise ValueError(f"unknown cell kind {cell_kind!r}; available: "
                             f"{', '.join(sorted(_KINDS))}")
        cell, self._bidi_op, self._uni_op = _KINDS[cell_kind]
        self.cell_kind = cell_kind
        self.hidden = hidden
        self.bidirectional = bidirectional
        self.fw = cell(input_dim, hidden, generator, device, **cell_kw)
        if bidirectional:
            self.bw = cell(input_dim, hidden, generator, device, **cell_kw)

    @property
    def output_dim(self) -> int:
        return self.hidden * (2 if self.bidirectional else 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                tp: Optional[tuple] = None) -> torch.Tensor:
        """x [T, B, F], mask [T, B, 1] -> [T, B, output_dim].  ``train`` and
        ``generator`` reach the cells' ``prepare`` (the zoneout draws).
        ``tp`` ``(model group, shards)`` with shards > 1 runs the
        tensor-parallel scan (``parallel/tp.py``), on every rank of that
        group together."""
        mask = mask.contiguous()
        if tp is not None and tp[1] > 1:
            return tp_rnn_layer_apply(self, x, mask, *tp) * mask
        xp_f, res_f = self.fw.prepare(x, train, generator)
        if not self.bidirectional:
            return self._uni_op.apply(xp_f, mask, *res_f) * mask
        xp_b, res_b = self.bw.prepare(x, train, generator)
        # the fused op takes each resident argument as (forward, backward)
        h_f, h_b = self._bidi_op.apply(
            xp_f, xp_b, mask, *(a for pair in zip(res_f, res_b)
                                for a in pair))
        return torch.cat([h_f, h_b], dim=-1) * mask

    def check_streaming(self) -> None:
        """Raise ValueError unless this layer can stream: a bidirectional
        layer cannot (as in JAX)."""
        if self.bidirectional:
            raise ValueError(_UNIDIRECTIONAL)

    def init_stream_carry(self, batch: int) -> tuple[torch.Tensor, ...]:
        """Zero state for ``batch`` streams: (h,) for the GRU, (h, c) for
        every LSTM kind, [B, H] each, on the layer's device."""
        self.check_streaming()
        zeros = self.fw.wh.new_zeros((batch, self.hidden))
        return (zeros,) if self.cell_kind == "gru" \
            else (zeros, zeros.clone())

    def apply_streaming(self, x: torch.Tensor, mask: torch.Tensor,
                        carry: tuple) -> tuple[torch.Tensor, tuple]:
        """One chunk of a forward-only recurrence with carried state, no
        autograd: x [T, B, F], mask [T, B, 1] -> (h [T, B, H] zeroed on
        masked frames, the new carry: h and c of the last frame, which a
        masked frame holds).  One forward launch on a CUDA device; the
        cell's ``prepare`` in eval mode gives the op's other arguments."""
        self.check_streaming()
        mask = mask.contiguous()
        with torch.no_grad():
            xp, res = self.fw.prepare(x)
            outs = _STREAM_OPS[self.cell_kind](xp, mask, *res, *carry)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return outs[0] * mask, tuple(o[-1] for o in outs)


class _StackEntry(nn.Module):
    """One entry of the stack; holds the layer under ``rnn`` and its skip
    parameters under ``proj`` and ``gate``, so that the parameter paths
    match the JAX tree (``layers/<i>/rnn/fw/wx``, ``layers/<i>/proj/w``,
    ``layers/<i>/gate/w``).

    ``proj`` exists only where the layer changes the width (a skip kind
    other than 'none'), ``gate`` in every highway layer."""

    def __init__(self, layer: RNNLayer, input_dim: int, skip: str,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str | None = None):
        super().__init__()
        self.rnn = layer
        self.proj = self.gate = None
        if skip != "none" and input_dim != layer.output_dim:
            self.proj = nn.ParameterDict(dense_init(
                input_dim, layer.output_dim, generator, device))
        if skip == "highway":
            self.gate = nn.ParameterDict(dense_init(
                input_dim, layer.output_dim, generator, device))


class StackedRNN(nn.Module):
    """N recurrent layers of one cell kind with skip connections 'none',
    'residual' or 'highway', as the JAX ``StackedRNN``:

    - residual: ``h = rnn(x) + proj(x)`` (proj the identity where the
      widths match);
    - highway: ``h = t * rnn(x) + (1 - t) * proj(x)``, ``t = sigmoid(x @ Wt
      + bt)``;

    then ``h *= mask``.  ``dropout`` acts after every layer but the last,
    after the skip, in train mode only."""

    def __init__(self, input_dim: int, cell_kind: str = "lstm",
                 hidden: int = 256, num_layers: int = 3,
                 bidirectional: bool = True, dropout: float = 0.0,
                 skip: str = "none",
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str | None = None, **cell_kw):
        super().__init__()
        if skip not in ("none", "residual", "highway"):
            raise ValueError(f"unknown skip kind {skip!r}")
        self.input_dim = input_dim
        self.dropout = dropout
        self.skip = skip
        entries = []
        dim = input_dim
        for _ in range(num_layers):
            layer = RNNLayer(cell_kind, dim, hidden, bidirectional,
                             generator, device, **cell_kw)
            entries.append(_StackEntry(layer, dim, skip, generator, device))
            dim = layer.output_dim
        self.layers = nn.ModuleList(entries)
        self.output_dim = dim

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                tp: Optional[tuple] = None) -> torch.Tensor:
        """x [T, B, F] -> [T, B, output_dim]; ``tp`` as
        :meth:`RNNLayer.forward` takes it."""
        last = len(self.layers) - 1
        for i, entry in enumerate(self.layers):
            h = self._skip(entry, entry.rnn(x, mask, train, generator, tp),
                           x, mask)
            if i < last:
                h = dropout_fn(h, self.dropout, train, generator)
            x = h
        return x

    def _skip(self, entry: _StackEntry, h: torch.Tensor, x: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
        """The layer's output h after the skip from its input x."""
        if self.skip == "none":
            return h
        skip_in = x if entry.proj is None else dense_apply(entry.proj, x)
        if self.skip == "residual":
            h = h + skip_in
        else:
            t = torch.sigmoid(dense_apply(entry.gate, x))
            h = t * h + (1.0 - t) * skip_in
        return h * mask

    def init_stream_carries(self, batch: int) -> list:
        """Each layer's zero carry for ``batch`` streams."""
        return [entry.rnn.init_stream_carry(batch) for entry in self.layers]

    def apply_streaming(self, x: torch.Tensor, mask: torch.Tensor,
                        carries: list) -> tuple[torch.Tensor, list]:
        """One chunk x [T, B, F] through the stack with each layer's carry
        (the skips and ``h *= mask`` as :meth:`forward`, no dropout) ->
        (out [T, B, output_dim], the new carries)."""
        new = []
        for entry, carry in zip(self.layers, carries):
            h, carry = entry.rnn.apply_streaming(x, mask, carry)
            new.append(carry)
            x = self._skip(entry, h, x, mask)
        return x, new
