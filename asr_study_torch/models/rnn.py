"""Recurrent layers and their stack (port of ``asr_study_tpu/models/rnn.py``).

Time-major [T, B, F] inside.  Each layer follows the JAX fused paths: the
input projection ``x @ wx + b`` of each direction is one matmul over all
frames, and the recurrence runs in one differentiable op (the forward and
backward kernels on a CUDA device) — both directions of a bidirectional
layer together (``RNNLayer._apply_fused_bidi``: ``ops.bilstm.BiLSTMFunction``
or ``ops.gru.BiGRUFunction``), or the one direction of a unidirectional GRU
layer (``scan_cell``'s Pallas path: ``ops.gru.GRUFunction``).  The output
is zeroed on padded frames.

Ported: LSTM and GRU cells, bidirectional LSTM and GRU layers,
unidirectional GRU layers, no skip connections, inter-layer dropout in
training.  The rest raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from asr_study_torch.models.cells import GRUCell, LSTMCell
from asr_study_torch.models.nn import dropout as dropout_fn
from asr_study_torch.ops.bilstm import BiLSTMFunction
from asr_study_torch.ops.gru import BiGRUFunction, GRUFunction

# cell kind -> (cell, fused bidirectional op)
_KINDS = {"lstm": (LSTMCell, BiLSTMFunction), "gru": (GRUCell, BiGRUFunction)}


class RNNLayer(nn.Module):
    """One recurrent layer; parameters under ``fw`` (and ``bw`` when
    bidirectional)."""

    def __init__(self, cell_kind: str, input_dim: int, hidden: int,
                 bidirectional: bool = True,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str | None = None):
        super().__init__()
        if cell_kind not in _KINDS:
            raise NotImplementedError(
                f"cell kind {cell_kind!r} is not ported yet (ROADMAP queue "
                "A item 1; its kernels are in queue B)")
        if cell_kind == "lstm" and not bidirectional:
            raise NotImplementedError(
                "unidirectional LSTM layers are not ported yet (ROADMAP "
                "queue B item 6, ops/pallas_lstm.py)")
        cell, self._bidi_op = _KINDS[cell_kind]
        self.hidden = hidden
        self.bidirectional = bidirectional
        self.fw = cell(input_dim, hidden, generator, device)
        if bidirectional:
            self.bw = cell(input_dim, hidden, generator, device)

    @property
    def output_dim(self) -> int:
        return self.hidden * (2 if self.bidirectional else 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [T, B, F], mask [T, B, 1] -> [T, B, output_dim]."""
        mask = mask.contiguous()
        xp_f = (self.fw.input_proj(x) + self.fw.b).contiguous()
        if not self.bidirectional:
            return GRUFunction.apply(xp_f, mask, self.fw.wh) * mask
        xp_b = (self.bw.input_proj(x) + self.bw.b).contiguous()
        h_f, h_b = self._bidi_op.apply(xp_f, xp_b, mask, self.fw.wh,
                                       self.bw.wh)
        return torch.cat([h_f, h_b], dim=-1) * mask


class _StackEntry(nn.Module):
    """One entry of the stack; holds the layer under ``rnn`` so that the
    parameter paths match the JAX tree (``layers/<i>/rnn/fw/wx``)."""

    def __init__(self, layer: RNNLayer):
        super().__init__()
        self.rnn = layer


class StackedRNN(nn.Module):
    """N recurrent layers of one cell kind; skip kind 'none' only.  ``dropout``
    acts after every layer but the last, in train mode only."""

    def __init__(self, input_dim: int, cell_kind: str = "lstm",
                 hidden: int = 256, num_layers: int = 3,
                 bidirectional: bool = True, dropout: float = 0.0,
                 skip: str = "none",
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str | None = None):
        super().__init__()
        if skip != "none":
            raise NotImplementedError(
                f"skip kind {skip!r} is not ported yet (ROADMAP queue A "
                "item 1)")
        self.input_dim = input_dim
        self.dropout = dropout
        entries = []
        dim = input_dim
        for _ in range(num_layers):
            layer = RNNLayer(cell_kind, dim, hidden, bidirectional,
                             generator, device)
            entries.append(_StackEntry(layer))
            dim = layer.output_dim
        self.layers = nn.ModuleList(entries)
        self.output_dim = dim

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """x [T, B, F] -> [T, B, output_dim]"""
        last = len(self.layers) - 1
        for i, entry in enumerate(self.layers):
            x = entry.rnn(x, mask)
            if i < last:
                x = dropout_fn(x, self.dropout, train, generator)
        return x
