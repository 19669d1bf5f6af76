"""Label error metrics on the device (port of
``asr_study_tpu/ops/metrics.py`` ``edit_distance`` and ``ler``).

The row-wise Levenshtein recurrence ``new[j] = min(row[j] + 1,
new[j-1] + 1, row[j-1] + cost)`` depends on ``new[j-1]``; with
``m[j] = new[j] - j`` it becomes a running minimum, so each hypothesis
token is one batched ``cummin`` over the reference axis.  Plain torch: the
JAX version is XLA, not a Pallas kernel.
"""

from __future__ import annotations

import torch


def edit_distance(hyp: torch.Tensor, hyp_lengths: torch.Tensor,
                  ref: torch.Tensor, ref_lengths: torch.Tensor
                  ) -> torch.Tensor:
    """Batched Levenshtein distance between ``hyp[b, :hyp_lengths[b]]`` and
    ``ref[b, :ref_lengths[b]]``.

    hyp [B, H], ref [B, R] integer ids (padding beyond the lengths is
    ignored) -> int32 [B]."""
    batch, h_max = hyp.shape
    r_max = ref.shape[1]
    dev = hyp.device
    hyp = hyp.to(torch.int64)
    ref = ref.to(device=dev, dtype=torch.int64)
    hyp_lengths = hyp_lengths.to(device=dev, dtype=torch.int64)
    j_idx = torch.arange(r_max + 1, device=dev)
    row = j_idx.expand(batch, r_max + 1)
    for i in range(h_max):
        sub = (ref != hyp[:, i: i + 1]).to(torch.int64)            # [B, R]
        cand = torch.minimum(row[:, 1:] + 1, row[:, :-1] + sub)
        cand = torch.cat([row.new_full((batch, 1), i + 1), cand], dim=1)
        new_row = torch.cummin(cand - j_idx, dim=1).values + j_idx
        row = torch.where((i < hyp_lengths)[:, None], new_row, row)
    idx = ref_lengths.to(device=dev, dtype=torch.int64)[:, None]
    return torch.gather(row, 1, idx)[:, 0].to(torch.int32)


def ler(hyp: torch.Tensor, hyp_lengths: torch.Tensor, ref: torch.Tensor,
        ref_lengths: torch.Tensor) -> torch.Tensor:
    """Label error rate: edit distance over the reference length, float32
    [B]."""
    dist = edit_distance(hyp, hyp_lengths, ref, ref_lengths)
    return dist.to(torch.float32) / torch.clamp(
        ref_lengths.to(device=dist.device, dtype=torch.float32), min=1.0)
