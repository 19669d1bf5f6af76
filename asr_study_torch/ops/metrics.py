"""Label error metrics: on the device (port of
``asr_study_tpu/ops/metrics.py`` ``edit_distance`` and ``ler``) and on
the host (``wer`` and ``cer`` over transcripts, through the native host
library).

The row-wise Levenshtein recurrence ``new[j] = min(row[j] + 1,
new[j-1] + 1, row[j-1] + cost)`` depends on ``new[j-1]``; with
``m[j] = new[j] - j`` it becomes a running minimum, so each hypothesis
token is one batched ``cummin`` over the reference axis.  Plain torch: the
JAX version is XLA, not a Pallas kernel.
"""

from __future__ import annotations

from typing import List, Sequence

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


# ---------------------------------------------------------------------------
# host metrics over decoded strings (port of asr_study_tpu/ops/metrics.py
# ``_levenshtein_py``, ``wer`` and ``cer``: the distance from the native
# host library on token ids, the pure-Python DP its plain twin)
# ---------------------------------------------------------------------------

def _levenshtein_py(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance between two token sequences (the plain twin of
    :func:`levenshtein`)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a):
        cur = [i + 1]
        for j, y in enumerate(b):
            cur.append(min(prev[j + 1] + 1, cur[j] + 1, prev[j] + (x != y)))
        prev = cur
    return prev[-1]


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance between two token sequences: the tokens mapped
    to int32 ids, then ``asr_levenshtein`` of ``native/asr_native.cc``."""
    from asr_study_torch.utils import native

    ids: dict = {}
    enc_a = [ids.setdefault(t, len(ids)) for t in a]
    enc_b = [ids.setdefault(t, len(ids)) for t in b]
    return native.levenshtein(enc_a, enc_b)


def wer(hyps: List[str], refs: List[str]) -> float:
    """Corpus word error rate over decoded transcripts."""
    errs = tot = 0
    for h, r in zip(hyps, refs):
        rw = r.split()
        errs += levenshtein(h.split(), rw)
        tot += len(rw)
    return errs / max(tot, 1)


def cer(hyps: List[str], refs: List[str]) -> float:
    """Corpus character error rate over decoded transcripts."""
    errs = tot = 0
    for h, r in zip(hyps, refs):
        errs += levenshtein(list(h), list(r))
        tot += len(r)
    return errs / max(tot, 1)
