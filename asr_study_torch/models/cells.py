"""LSTM and GRU cells (port of ``asr_study_tpu/models/cells.py``
``LSTMCell`` and ``GRUCell``).

The input-side projection ``x @ wx`` for all frames is hoisted out of the
recurrence (``input_proj``); ``step`` is the plain recurrence for one
frame.  LSTM gate order is i, f, g, o and the forget bias starts at 1; GRU
gate order is r, z, n, reset-after, all biases 0 at init.  A frame whose
mask is 0 keeps the previous state (``_hold``), which makes a reversed walk
over a right-padded batch exact.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from asr_study_torch.models.nn import glorot_uniform, orthogonal


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

    def step(self, carry: tuple[torch.Tensor, torch.Tensor],
             xp_t: torch.Tensor, mask_t: torch.Tensor
             ) -> tuple[tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        """xp_t [B, 4H] is ``input_proj`` without the bias."""
        h, c = lstm_step(carry[0], carry[1], xp_t + self.b, mask_t, self.wh)
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

    def step(self, carry: tuple[torch.Tensor], xp_t: torch.Tensor,
             mask_t: torch.Tensor
             ) -> tuple[tuple[torch.Tensor], torch.Tensor]:
        """xp_t [B, 3H] is ``input_proj`` without the bias."""
        h = gru_step(carry[0], xp_t + self.b, mask_t, self.wh)
        return (h,), h
