"""LSTM, layer-norm LSTM and GRU cells (port of
``asr_study_tpu/models/cells.py`` ``LSTMCell``, ``LayerNormLSTMCell`` and
``GRUCell``).

The input-side projection ``x @ wx`` for all frames is hoisted out of the
recurrence (``input_proj``); ``prepare`` turns it into what the layer's
recurrence op takes, and ``step`` is the plain recurrence for one frame.
LSTM gate order is i, f, g, o and the forget bias starts at 1; GRU
gate order is r, z, n, reset-after, all biases 0 at init.  A frame whose
mask is 0 keeps the previous state (``_hold``), which makes a reversed walk
over a right-padded batch exact.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from asr_study_torch.models.nn import (glorot_uniform, layer_norm_apply,
                                       layer_norm_init, orthogonal)


def _hold(mask_t: torch.Tensor, new: torch.Tensor,
          old: torch.Tensor) -> torch.Tensor:
    """Carry-hold on padded frames."""
    return torch.where(mask_t > 0, new, old)


def lstm_step(h_prev: torch.Tensor, c_prev: torch.Tensor, xp_t: torch.Tensor,
              mask_t: torch.Tensor, wh: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One frame: xp_t [B, 4H] (bias folded in), mask_t [B, 1] -> (h, c)."""
    pre = xp_t + torch.matmul(h_prev, wh)
    i, f, g, o = pre.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return _hold(mask_t, h, h_prev), _hold(mask_t, c, c_prev)


class LSTMCell(nn.Module):
    """Vanilla LSTM; parameters ``wx`` [F, 4H], ``wh`` [H, 4H], ``b`` [4H]."""

    num_gates = 4

    def __init__(self, input_dim: int, hidden: int,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str | None = None):
        super().__init__()
        self.hidden = hidden
        g = self.num_gates * hidden
        b = torch.zeros((g,), dtype=torch.float32)
        b[hidden: 2 * hidden] = 1.0                  # forget-gate bias
        self.wx = nn.Parameter(glorot_uniform((input_dim, g), generator,
                                              device))
        self.wh = nn.Parameter(orthogonal((hidden, g), generator, device))
        self.b = nn.Parameter(b.to(device))

    def input_proj(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.wx)

    def prepare(self, x: torch.Tensor
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        """What the recurrence op takes for input x [T, B, F]: the streamed
        ``x @ wx + b`` [T, B, 4H] and the resident ``(wh,)``."""
        return (self.input_proj(x) + self.b).contiguous(), (self.wh,)

    def step(self, carry: tuple[torch.Tensor, torch.Tensor],
             xp_t: torch.Tensor, mask_t: torch.Tensor
             ) -> tuple[tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        """xp_t [B, 4H] is ``input_proj`` without the bias."""
        h, c = lstm_step(carry[0], carry[1], xp_t + self.b, mask_t, self.wh)
        return (h, c), h


LN_EPS = 1e-5


def ln_stats(x: torch.Tensor, eps: float = LN_EPS
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """LayerNorm statistics over the last dim, mean first and then the mean
    of the squared deviations -> (xhat, rstd), rstd keeping the dim."""
    d = x - x.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((d * d).mean(dim=-1, keepdim=True) + eps)
    return d * rstd, rstd


def ln_lstm_step(h_prev: torch.Tensor, c_prev: torch.Tensor,
                 xpn_t: torch.Tensor, mask_t: torch.Tensor, wh: torch.Tensor,
                 gh: torch.Tensor, gc: torch.Tensor, bc: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One frame of the layer-norm LSTM in the kernel's split form: xpn_t
    [B, 4H] carries every additive term (``ln_x`` of ``x @ wx``, ``b`` and
    ``ln_h``'s bias), the h side adds ``xhat(h_prev @ wh) * gh`` per gate
    block; gh [4H], gc and bc [H] (``ln_c``).  -> (h, c)."""
    batch, hidden = h_prev.shape
    xhat, _ = ln_stats(torch.matmul(h_prev, wh).view(batch, 4, hidden))
    pre = xpn_t + (xhat * gh.view(4, hidden)).view(batch, 4 * hidden)
    i, f, g, o = pre.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    chat, _ = ln_stats(c)
    h = torch.sigmoid(o) * torch.tanh(chat * gc + bc)
    return _hold(mask_t, h, h_prev), _hold(mask_t, c, c_prev)


class LayerNormLSTMCell(LSTMCell):
    """Layer-norm LSTM (port of ``cells.py`` ``LayerNormLSTMCell``): LN of
    the x- and h-side gate pre-activations, each gate block on its own and
    with its own gains, and LN of the cell state before the output tanh.
    Parameters of ``LSTMCell`` plus ``ln_x`` and ``ln_h`` (``g``, ``b``
    [4H]) and ``ln_c`` (``g``, ``b`` [H]): gains 1, biases 0."""

    def __init__(self, input_dim: int, hidden: int,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str | None = None):
        super().__init__(input_dim, hidden, generator, device)
        g = self.num_gates * hidden
        self.ln_x = nn.ParameterDict(layer_norm_init(g, device))
        self.ln_h = nn.ParameterDict(layer_norm_init(g, device))
        self.ln_c = nn.ParameterDict(layer_norm_init(hidden, device))

    @staticmethod
    def _blockwise_ln(ln, x: torch.Tensor, blocks: int = 4) -> torch.Tensor:
        """LN applied to each gate block of x [..., blocks*H] on its own."""
        shape = x.shape
        y = layer_norm_apply({"g": ln["g"].view(blocks, -1),
                              "b": ln["b"].view(blocks, -1)},
                             x.reshape(*shape[:-1], blocks, -1))
        return y.reshape(shape)

    def prepare(self, x: torch.Tensor
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        """The streamed ``xpn`` [T, B, 4H] (``ln_x`` has no recurrent
        dependence, so it runs here over every frame, and every additive
        term is folded in) and the resident ``(wh, ln_h.g, ln_c.g,
        ln_c.b)``."""
        xpn = (self._blockwise_ln(self.ln_x, self.input_proj(x)) + self.b
               + self.ln_h["b"])
        return xpn.contiguous(), (self.wh, self.ln_h["g"], self.ln_c["g"],
                                  self.ln_c["b"])

    def step(self, carry: tuple[torch.Tensor, torch.Tensor],
             xp_t: torch.Tensor, mask_t: torch.Tensor
             ) -> tuple[tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        """xp_t [B, 4H] is ``input_proj`` without the bias."""
        h_prev, c_prev = carry
        pre = (self._blockwise_ln(self.ln_x, xp_t)
               + self._blockwise_ln(self.ln_h, torch.matmul(h_prev, self.wh))
               + self.b)
        i, f, g, o = pre.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(layer_norm_apply(self.ln_c, c))
        h, c = _hold(mask_t, h, h_prev), _hold(mask_t, c, c_prev)
        return (h, c), h


def gru_step(h_prev: torch.Tensor, xp_t: torch.Tensor, mask_t: torch.Tensor,
             wh: torch.Tensor) -> torch.Tensor:
    """One frame: xp_t [B, 3H] (bias folded in), mask_t [B, 1] -> h.

    ``n = tanh(xn + r * hn)``: the bias ``bn`` is additive inside the tanh
    and outside ``r * hn``, so it folds into ``xn`` with the others."""
    hr, hz, hn = torch.matmul(h_prev, wh).chunk(3, dim=-1)
    xr, xz, xn = xp_t.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return _hold(mask_t, (1.0 - z) * n + z * h_prev, h_prev)


class GRUCell(nn.Module):
    """Vanilla GRU; parameters ``wx`` [F, 3H], ``wh`` [H, 3H], ``b`` [3H]."""

    num_gates = 3

    def __init__(self, input_dim: int, hidden: int,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str | None = None):
        super().__init__()
        self.hidden = hidden
        g = self.num_gates * hidden
        self.wx = nn.Parameter(glorot_uniform((input_dim, g), generator,
                                              device))
        self.wh = nn.Parameter(orthogonal((hidden, g), generator, device))
        self.b = nn.Parameter(torch.zeros((g,), dtype=torch.float32,
                                          device=device))

    def input_proj(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.wx)

    def prepare(self, x: torch.Tensor
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        """The streamed ``x @ wx + b`` [T, B, 3H] and the resident
        ``(wh,)``."""
        return (self.input_proj(x) + self.b).contiguous(), (self.wh,)

    def step(self, carry: tuple[torch.Tensor], xp_t: torch.Tensor,
             mask_t: torch.Tensor
             ) -> tuple[tuple[torch.Tensor], torch.Tensor]:
        """xp_t [B, 3H] is ``input_proj`` without the bias."""
        h = gru_step(carry[0], xp_t + self.b, mask_t, self.wh)
        return (h,), h
