"""LSTM, layer-norm, multiplicative-integration and zoneout LSTM, and GRU
cells (port of ``asr_study_tpu/models/cells.py`` ``LSTMCell``,
``LayerNormLSTMCell``, ``MILSTMCell``, ``ZoneoutLSTMCell`` and
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

from asr_study_torch.models.nn import (dot, glorot_uniform,
                                       layer_norm_apply, layer_norm_init,
                                       orthogonal)


def _hold(mask_t: torch.Tensor, new: torch.Tensor,
          old: torch.Tensor) -> torch.Tensor:
    """Carry-hold on padded frames."""
    return torch.where(mask_t > 0, new, old)


def lstm_gates(xp_t: torch.Tensor, h_prev: torch.Tensor, wh: torch.Tensor
               ) -> torch.Tensor:
    """One frame's activated gates [B, 4H]: sigmoid i, f, o and tanh g of
    ``xp_t + h_prev @ wh``, the product in wh's dtype (:func:`dot`: with
    bfloat16 weights h_prev is rounded to bfloat16, as the JAX kernels'
    ``_mm`` rounds it)."""
    i, f, g, o = (xp_t + dot(h_prev, wh)).chunk(4, dim=-1)
    return torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o)], dim=-1)


def lstm_update(gates: torch.Tensor, h_prev: torch.Tensor,
                c_prev: torch.Tensor, mask_t: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(h, c) of one frame from its activated gates (:func:`lstm_gates`)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c = f * c_prev + i * g
    h = o * torch.tanh(c)
    return _hold(mask_t, h, h_prev), _hold(mask_t, c, c_prev)


def lstm_step(h_prev: torch.Tensor, c_prev: torch.Tensor, xp_t: torch.Tensor,
              mask_t: torch.Tensor, wh: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One frame: xp_t [B, 4H] (bias folded in), mask_t [B, 1] -> (h, c)."""
    return lstm_update(lstm_gates(xp_t, h_prev, wh), h_prev, c_prev, mask_t)


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
        """``x @ wx`` in wx's dtype, float32 out (:func:`dot`)."""
        return dot(x, self.wx)

    def prepare(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        """What the recurrence op takes for input x [T, B, F]: the streamed
        ``x @ wx + b`` [T, B, 4H] (float32: a bfloat16 b is added as it
        is) and the rest of its arguments, here
        ``(wh,)``.  ``train`` and ``generator`` reach the cells that draw
        (:class:`ZoneoutLSTMCell`); the others ignore them."""
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
    block; gh [4H], gc and bc [H] (``ln_c``).  The product is taken in
    wh's dtype (:func:`dot`: with bfloat16 weights h_prev is rounded to
    bfloat16 there, and only there: its statistics, c and the hold stay
    float32 and take it unrounded).  -> (h, c)."""
    batch, hidden = h_prev.shape
    xhat, _ = ln_stats(dot(h_prev, wh).view(batch, 4, hidden))
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

    def prepare(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        """The streamed ``xpn`` [T, B, 4H] (``ln_x`` has no recurrent
        dependence, so it runs here over every frame, and every additive
        term is folded in; float32: bfloat16 ``ln_x``, ``b`` and ``ln_h.b``
        are applied to the float32 projection as they are) and the resident
        ``(wh, ln_h.g, ln_c.g, ln_c.b)``, the three vectors as float32
        (bfloat16 ones cast, as the JAX route's ``astype(jnp.float32)``:
        their gradients are rounded to bfloat16 at the cast)."""
        xpn = (self._blockwise_ln(self.ln_x, self.input_proj(x)) + self.b
               + self.ln_h["b"])
        return xpn.contiguous(), (self.wh, *(v.float() for v in (
            self.ln_h["g"], self.ln_c["g"], self.ln_c["b"])))

    def step(self, carry: tuple[torch.Tensor, torch.Tensor],
             xp_t: torch.Tensor, mask_t: torch.Tensor
             ) -> tuple[tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        """xp_t [B, 4H] is ``input_proj`` without the bias."""
        h_prev, c_prev = carry
        pre = (self._blockwise_ln(self.ln_x, xp_t)
               + self._blockwise_ln(self.ln_h, dot(h_prev, self.wh))
               + self.b)
        i, f, g, o = pre.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(layer_norm_apply(self.ln_c, c))
        h, c = _hold(mask_t, h, h_prev), _hold(mask_t, c, c_prev)
        return (h, c), h


def mi_lstm_step(h_prev: torch.Tensor, c_prev: torch.Tensor,
                 xp_t: torch.Tensor, mask_t: torch.Tensor, wh: torch.Tensor,
                 alpha: torch.Tensor, beta1: torch.Tensor,
                 beta2: torch.Tensor, b: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One frame of the multiplicative-integration LSTM: xp_t [B, 4H] is the
    raw ``x @ wx`` (no bias), alpha, beta1, beta2 and b [4H]; the gate
    pre-activation is ``alpha * xp * hp + beta1 * xp + beta2 * hp + b`` with
    ``hp = h_prev @ wh`` in wh's dtype (:func:`dot`: with bfloat16 weights
    h_prev is rounded to bfloat16 there, and only there: a held frame keeps
    it unrounded).  -> (h, c)."""
    hp = dot(h_prev, wh)
    pre = alpha * xp_t * hp + beta1 * xp_t + beta2 * hp + b
    i, f, g, o = pre.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return _hold(mask_t, h, h_prev), _hold(mask_t, c, c_prev)


class MILSTMCell(LSTMCell):
    """Multiplicative-integration LSTM (port of ``cells.py``
    ``MILSTMCell``, Wu et al. 2016): the parameters of ``LSTMCell`` plus
    ``alpha``, ``beta1`` and ``beta2`` [4H], ones at init."""

    def __init__(self, input_dim: int, hidden: int,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str | None = None):
        super().__init__(input_dim, hidden, generator, device)
        g = self.num_gates * hidden
        for name in ("alpha", "beta1", "beta2"):
            setattr(self, name, nn.Parameter(torch.ones(
                (g,), dtype=torch.float32, device=device)))

    def prepare(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        """The streamed RAW ``x @ wx`` [T, B, 4H] (the Hadamard term needs
        it without the bias) and the resident ``(wh, alpha, beta1, beta2,
        b)``, the four vectors as float32 (bfloat16 ones cast, as the JAX
        route's ``astype(jnp.float32)``: their gradients are rounded to
        bfloat16 at the cast)."""
        return self.input_proj(x).contiguous(), (
            self.wh, *(v.float() for v in (self.alpha, self.beta1,
                                             self.beta2, self.b)))

    def step(self, carry: tuple[torch.Tensor, torch.Tensor],
             xp_t: torch.Tensor, mask_t: torch.Tensor
             ) -> tuple[tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        """xp_t [B, 4H] is ``input_proj``."""
        h, c = mi_lstm_step(carry[0], carry[1], xp_t, mask_t, self.wh,
                            self.alpha, self.beta1, self.beta2, self.b)
        return (h, c), h


def zoneout_lstm_step(h_prev: torch.Tensor, c_prev: torch.Tensor,
                      xp_t: torch.Tensor, mask_t: torch.Tensor,
                      zh_t: torch.Tensor, zc_t: torch.Tensor,
                      wh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One frame of the zoneout LSTM in the kernel's split form (the JAX
    ``_zo_cell_math``): the LSTM update from xp_t [B, 4H] (bias folded in),
    then ``h = zh * h_new + (1 - zh) * h_prev`` and the same for c with zc
    (zh_t, zc_t [B, H]: the weight of the new state), then the hold on
    masked frames.  The product is taken in wh's dtype (:func:`dot`: with
    bfloat16 weights h_prev is rounded to bfloat16 there, and only there:
    the mix and the hold take it unrounded).  -> (h, c)."""
    pre = xp_t + dot(h_prev, wh)
    i, f, g, o = pre.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    h = zh_t * h_new + (1.0 - zh_t) * h_prev
    c = zc_t * c_new + (1.0 - zc_t) * c_prev
    return _hold(mask_t, h, h_prev), _hold(mask_t, c, c_prev)


def zoneout_mix(rate: float, train: bool,
                generator: Optional[torch.Generator], shape: tuple,
                device: torch.device | str | None = None) -> torch.Tensor:
    """Zoneout mix weights of ``shape``, the weight of the new state (the
    JAX ``_zoneout_mix`` without its key schedule): in train mode at a rate
    above 0, {0, 1} samples that are 1 with probability ``1 - rate``, drawn
    from ``generator`` (on ``device``; train mode without one raises, as
    dropout does); else the constant ``1 - rate`` (1.0 at rate <= 0), with
    no draw."""
    if train and rate > 0.0:
        if generator is None:
            raise ValueError("zoneout in train mode needs a torch.Generator")
        u = torch.rand(shape, generator=generator, device=device,
                       dtype=torch.float32)
        return (u < 1.0 - rate).to(torch.float32)
    return torch.full(shape, 1.0 if rate <= 0.0 else 1.0 - rate,
                      dtype=torch.float32, device=device)


class ZoneoutLSTMCell(LSTMCell):
    """Zoneout LSTM (port of ``cells.py`` ``ZoneoutLSTMCell``, Krueger et
    al. 2017): the parameters of ``LSTMCell``; each unit's h (c) keeps its
    previous value with probability ``zoneout_h`` (``zoneout_c``) in train
    mode, and eval mode takes ``(1 - rate) * new + rate * old``.

    The mix weights are drawn outside the recurrence, for every frame at
    once (``prepare``), and streamed into the recurrence op; a train-mode
    layer draws its own zh, then its zc, from the caller's generator."""

    def __init__(self, input_dim: int, hidden: int,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str | None = None,
                 zoneout_h: float = 0.1, zoneout_c: float = 0.1):
        super().__init__(input_dim, hidden, generator, device)
        self.zoneout_h = zoneout_h
        self.zoneout_c = zoneout_c

    def mix(self, t_steps: int, batch: int, train: bool = False,
            generator: Optional[torch.Generator] = None,
            device: torch.device | str | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
        """(zh, zc) [T, B, H] for a walk of ``t_steps`` frames: zh drawn
        first, then zc (:func:`zoneout_mix`)."""
        shape = (t_steps, batch, self.hidden)
        return (zoneout_mix(self.zoneout_h, train, generator, shape, device),
                zoneout_mix(self.zoneout_c, train, generator, shape, device))

    def prepare(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        """The streamed ``x @ wx + b`` [T, B, 4H] (float32: a bfloat16 b is
        added as it is) and ``(zh, zc, wh)``, the mix weights [T, B, H] in
        forward time order whichever way the layer walks."""
        zh, zc = self.mix(x.shape[0], x.shape[1], train, generator,
                          x.device)
        return (self.input_proj(x) + self.b).contiguous(), (zh, zc, self.wh)

    def step(self, carry: tuple[torch.Tensor, torch.Tensor],
             xp_t: torch.Tensor, mask_t: torch.Tensor, train: bool = False,
             generator: Optional[torch.Generator] = None
             ) -> tuple[tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        """xp_t [B, 4H] is ``input_proj`` without the bias: the LSTM step,
        the mix (weights drawn for this frame), the hold."""
        zh, zc = self.mix(1, xp_t.shape[0], train, generator, xp_t.device)
        h, c = zoneout_lstm_step(carry[0], carry[1], xp_t + self.b, mask_t,
                                 zh[0], zc[0], self.wh)
        return (h, c), h


def gru_step(h_prev: torch.Tensor, xp_t: torch.Tensor, mask_t: torch.Tensor,
             wh: torch.Tensor) -> torch.Tensor:
    """One frame: xp_t [B, 3H] (bias folded in), mask_t [B, 1] -> h.

    ``n = tanh(xn + r * hn)``: the bias ``bn`` is additive inside the tanh
    and outside ``r * hn``, so it folds into ``xn`` with the others.  The
    product is taken in wh's dtype (:func:`dot`: with bfloat16 weights
    h_prev is rounded to bfloat16 there, and only there)."""
    return gru_update(dot(h_prev, wh), h_prev, xp_t, mask_t)


def gru_update(hg_t: torch.Tensor, h_prev: torch.Tensor, xp_t: torch.Tensor,
               mask_t: torch.Tensor) -> torch.Tensor:
    """h of one frame from the h side of its pre-activations, ``hg_t = [hr,
    hz, hn] = h_prev @ wh`` [B, 3H] (:func:`gru_step` without the
    product)."""
    hr, hz, hn = hg_t.chunk(3, dim=-1)
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
        """``x @ wx`` in wx's dtype, float32 out (:func:`dot`)."""
        return dot(x, self.wx)

    def prepare(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        """The streamed ``x @ wx + b`` [T, B, 3H] (float32: a bfloat16 b is
        added as it is) and the resident ``(wh,)``."""
        return (self.input_proj(x) + self.b).contiguous(), (self.wh,)

    def step(self, carry: tuple[torch.Tensor], xp_t: torch.Tensor,
             mask_t: torch.Tensor
             ) -> tuple[tuple[torch.Tensor], torch.Tensor]:
        """xp_t [B, 3H] is ``input_proj`` without the bias."""
        h = gru_step(carry[0], xp_t + self.b, mask_t, self.wh)
        return (h,), h
