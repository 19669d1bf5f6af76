"""Greedy CTC decoding (port of ``asr_study_tpu/ops/ctc.py``
``greedy_decode``).  The CTC loss is ROADMAP queue A item 2."""

from __future__ import annotations

from typing import Optional

import torch


def greedy_decode(logits: torch.Tensor, logit_lengths: torch.Tensor,
                  blank_id: Optional[int] = None, pad_id: int = -1
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-path decode: argmax (first index on ties) -> collapse repeats
    -> drop blanks -> left-pack with a stable sort.

    logits [B, T, V], logit_lengths [B] -> (decoded int32 [B, T] padded
    with ``pad_id``, lengths int32 [B])."""
    batch, t_max, vocab = logits.shape
    if blank_id is None:
        blank_id = vocab - 1
    preds = torch.argmax(logits, dim=-1).to(torch.int32)      # [B, T]
    t = torch.arange(t_max, device=logits.device)[None, :]
    valid = t < logit_lengths[:, None]
    prev = torch.cat([preds.new_full((batch, 1), -1), preds[:, :-1]], dim=1)
    keep = valid & (preds != blank_id) & (preds != prev)
    key = torch.where(keep, t, t_max)
    order = torch.argsort(key, dim=1, stable=True)
    packed = torch.gather(preds, 1, order)
    lengths = keep.sum(dim=1).to(torch.int32)
    packed = torch.where(t < lengths[:, None], packed, pad_id)
    return packed.to(torch.int32), lengths
