"""Dense-layer primitives, LayerNorm and dropout (port of
``asr_study_tpu/models/nn.py``).

Parameters keep the JAX layout: ``w`` [in, out], ``b`` [out].  Random
initialisation draws from a ``torch.Generator`` on the CPU and moves the
result to ``device``, so one seed gives the same weights on every device
(it does not give JAX's numbers: the two generators differ).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch


def glorot_uniform(shape: tuple[int, ...],
                   generator: Optional[torch.Generator] = None,
                   device: torch.device | str | None = None) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return ((2.0 * u - 1.0) * limit).to(device)


def orthogonal(shape: tuple[int, int],
               generator: Optional[torch.Generator] = None,
               device: torch.device | str | None = None) -> torch.Tensor:
    """Orthogonal init; for (H, G*H) shapes, one orthogonal block per gate."""
    rows, cols = shape

    def square(n):
        a = torch.randn((n, n), generator=generator, dtype=torch.float32)
        q, r = torch.linalg.qr(a)
        return q * torch.sign(torch.diagonal(r))[None, :]

    if cols % rows == 0 and cols != rows:
        w = torch.cat([square(rows) for _ in range(cols // rows)], dim=1)
    else:
        w = square(max(rows, cols))[:rows, :cols]
    return w.contiguous().to(device)


def dense_init(in_dim: int, out_dim: int,
               generator: Optional[torch.Generator] = None,
               device: torch.device | str | None = None
               ) -> dict[str, torch.Tensor]:
    return {
        "w": glorot_uniform((in_dim, out_dim), generator, device),
        "b": torch.zeros((out_dim,), dtype=torch.float32, device=device),
    }


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the weights' dtype with float32 accumulation (the JAX
    ``cells._dot``): with bfloat16 weights both operands are rounded to
    bfloat16 and multiplied in float32, which is exact for such operands,
    so the result is float32 and unrounded, and autograd hands ``x`` and
    ``w`` gradients rounded to bfloat16, as the VJP of the JAX cast does.
    With float32 weights it is ``x @ w``."""
    if w.dtype == torch.float32:
        return torch.matmul(x, w)
    return torch.matmul(x.to(w.dtype).float(), w.float())


def dense_apply(params: Mapping[str, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` through :func:`dot`; a bfloat16 bias is added to the
    float32 product as it is (the JAX promotion)."""
    return dot(x, params["w"]) + params["b"]


def layer_norm_init(dim: int, device: torch.device | str | None = None
                    ) -> dict[str, torch.Tensor]:
    """Gain ``g`` (ones) and bias ``b`` (zeros), both [dim]."""
    return {"g": torch.ones((dim,), dtype=torch.float32, device=device),
            "b": torch.zeros((dim,), dtype=torch.float32, device=device)}


def layer_norm_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim with the population variance (as
    ``jnp.var``)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * params["g"] + params["b"]


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout, ``where(keep, x / (1 - rate), 0)``, with the keep
    mask drawn from ``generator`` (on ``x``'s device).  The identity in
    eval mode or at rate 0."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device,
                   dtype=x.dtype)
    return torch.where(u < keep, x / keep, 0.0)
