"""Recurrent layers and their stack (port of ``asr_study_tpu/models/rnn.py``).

Time-major [T, B, F] inside.  Each layer follows the JAX fused paths: the
input projection of each direction is one matmul over all frames, which the
cell's ``prepare`` turns into the streamed tensor (``x @ wx + b``; for the
layer-norm LSTM ``xpn``, with ``ln_x`` applied), and the recurrence runs in
one differentiable op (the forward and backward kernels on a CUDA device) —
both directions of a bidirectional layer together
(``RNNLayer._apply_fused_bidi``: ``ops.bilstm.BiLSTMFunction``,
``ops.gru.BiGRUFunction`` or ``ops.ln_lstm.BiLNLSTMFunction``), or the one
direction of a unidirectional layer (``scan_cell``'s Pallas path:
``LSTMFunction``, ``GRUFunction`` or ``LNLSTMFunction``).  The output is
zeroed on padded frames.

Ported: the LSTM, layer-norm LSTM and GRU cells, uni- and bidirectional
layers of each, the skip kinds ``none``, ``residual`` and ``highway``,
inter-layer dropout in training.  The other cells raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from asr_study_torch.models.cells import (GRUCell, LayerNormLSTMCell,
                                          LSTMCell)
from asr_study_torch.models.nn import dense_apply, dense_init
from asr_study_torch.models.nn import dropout as dropout_fn
from asr_study_torch.ops.bilstm import BiLSTMFunction, LSTMFunction
from asr_study_torch.ops.gru import BiGRUFunction, GRUFunction
from asr_study_torch.ops.ln_lstm import BiLNLSTMFunction, LNLSTMFunction

# cell kind -> (cell, fused bidirectional op, unidirectional op)
_KINDS = {"lstm": (LSTMCell, BiLSTMFunction, LSTMFunction),
          "gru": (GRUCell, BiGRUFunction, GRUFunction),
          "ln_lstm": (LayerNormLSTMCell, BiLNLSTMFunction, LNLSTMFunction)}


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
        cell, self._bidi_op, self._uni_op = _KINDS[cell_kind]
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
        xp_f, res_f = self.fw.prepare(x)
        if not self.bidirectional:
            return self._uni_op.apply(xp_f, mask, *res_f) * mask
        xp_b, res_b = self.bw.prepare(x)
        # the fused op takes each resident argument as (forward, backward)
        h_f, h_b = self._bidi_op.apply(
            xp_f, xp_b, mask, *(a for pair in zip(res_f, res_b)
                                for a in pair))
        return torch.cat([h_f, h_b], dim=-1) * mask


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
                 device: torch.device | str | None = None):
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
                             generator, device)
            entries.append(_StackEntry(layer, dim, skip, generator, device))
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
            h = entry.rnn(x, mask)
            if self.skip != "none":
                skip_in = x if entry.proj is None else dense_apply(
                    entry.proj, x)
                if self.skip == "residual":
                    h = h + skip_in
                else:
                    t = torch.sigmoid(dense_apply(entry.gate, x))
                    h = t * h + (1.0 - t) * skip_in
                h = h * mask
            if i < last:
                h = dropout_fn(h, self.dropout, train, generator)
            x = h
        return x
