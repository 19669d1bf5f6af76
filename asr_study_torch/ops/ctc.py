"""CTC loss and greedy decoding (port of ``asr_study_tpu/ops/ctc.py`` and
``asr_study_tpu/ops/pallas_ctc.py``).

The loss follows the JAX lattice setup line by line: blank-interleaved
labels (S = 2L+1 states), the Graves 2006 eq. 6 skip mask, ``log_softmax``,
the per-state emissions ``lp_ext`` [T, B, S], the virtual pre-start state,
``LOG_EPS`` floors, pass-through on padded frames and the infeasible clamp.
The recursion itself is :class:`CTCNLL`, a ``torch.autograd.Function``
whose gradient boundary is ``lp_ext``, as the JAX ``ctc_nll`` custom VJP:

- forward: :func:`ctc_alpha`, the log-space alpha walk (on a CUDA device
  a kernel, :func:`ctc_alpha_plain` on the CPU);
- backward: :func:`ctc_beta`, the beta walk giving gamma = alpha + beta
  (a kernel / :func:`ctc_beta_plain`), then
  ``dlp = -exp(min(gamma - logP, 0))`` on feasible rows, elementwise.

Two kernel designs compute each walk; :func:`ctc_design` picks one from
the lattice size S.  The warp design (``csrc/ctc_warp.cu``: a warp for
each 32 states of a batch row, a state in each lane's registers, the
neighbours by warp shuffles, the emissions loaded frames ahead) takes
S <= ``CTC_WARP_MAX_S`` (544, L <= 271), which every main path's lattice
meets; the block design (``csrc/ctc.cu``: a block a row, the neighbours
through a row in shared memory) takes longer ones.

The log-softmax stays an ordinary autograd op.  The label gather is
:class:`LatticeGather`: a gather forward, and backward the JAX package's
one-hot product, which sums each class's lattice states in a fixed order
(so a train step repeats bit for bit on the card).  S is not padded to 128
lanes (a TPU-only form).
"""

from __future__ import annotations

from typing import Optional

import torch

from asr_study_torch import _build

# Large-negative stand-in for log(0): keeps -inf out of the recursions so
# that (-inf) - (-inf) NaNs never appear.
LOG_EPS = -1e30


def _logadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stable log(exp(a) + exp(b)) without -inf hazards."""
    mx = torch.clamp(torch.maximum(a, b), min=LOG_EPS)
    return mx + torch.log1p(torch.exp(torch.minimum(a, b) - mx))


def _logadd3(a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """One-shot stable log(e^a + e^b + e^c)."""
    mx = torch.clamp(torch.maximum(torch.maximum(a, b), c), min=LOG_EPS)
    return mx + torch.log(torch.exp(a - mx) + torch.exp(b - mx)
                          + torch.exp(c - mx))


def extend_labels(labels: torch.Tensor, blank_id: int) -> torch.Tensor:
    """[B, L] -> [B, 2L+1] blank-interleaved: (b, l1, b, l2, ..., lL, b)."""
    batch, max_len = labels.shape
    ext = labels.new_full((batch, 2 * max_len + 1), blank_id)
    ext[:, 1::2] = labels
    return ext


# -- the two recursions: plain versions ------------------------------------

def _shift_r(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, S] states shifted right by ``n``, LOG_EPS filled."""
    return torch.cat([x.new_full((x.shape[0], n), LOG_EPS), x[:, :-n]],
                     dim=1)[:, : x.shape[1]]


def _shift_l(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, S] states shifted left by ``n``, LOG_EPS filled."""
    return torch.cat([x[:, n:], x.new_full((x.shape[0], n), LOG_EPS)],
                     dim=1)[:, -x.shape[1]:]


def ctc_alpha_plain(lp_ext: torch.Tensor, valid: torch.Tensor,
                    skip: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`ctc_alpha`: a Python loop over time."""
    t_steps, batch, s_len = lp_ext.shape
    alpha = lp_ext.new_full((batch, s_len), LOG_EPS)
    alpha[:, 0] = 0.0                      # virtual pre-start state
    out = torch.empty_like(lp_ext)
    for t in range(t_steps):
        nxt = _logadd3(alpha, _shift_r(alpha, 1),
                       _shift_r(alpha, 2) + skip) + lp_ext[t]
        nxt = torch.clamp(nxt, min=LOG_EPS)
        alpha = torch.where(valid[t][:, None] > 0, nxt, alpha)
        out[t] = alpha
    return out


def ctc_beta_plain(lp_ext: torch.Tensor, valid: torch.Tensor,
                   alpha_seq: torch.Tensor, skip2: torch.Tensor,
                   end_ind: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`ctc_beta`: a Python loop over time."""
    t_steps, batch, s_len = lp_ext.shape
    beta = end_ind.clone()
    lp_next = torch.zeros_like(end_ind)
    v_next = lp_ext.new_zeros((batch,))
    gamma = torch.empty_like(lp_ext)
    for t in reversed(range(t_steps)):
        be = beta + lp_next
        upd = torch.clamp(_logadd3(be, _shift_l(be, 1),
                                   _shift_l(be, 2) + skip2), min=LOG_EPS)
        beta = torch.where(v_next[:, None] > 0, upd, beta)
        gamma[t] = torch.where(valid[t][:, None] > 0, alpha_seq[t] + beta,
                               LOG_EPS)
        lp_next, v_next = lp_ext[t], valid[t]
    return gamma


# -- the kernel wrappers ---------------------------------------------------

# The warp design runs J = ceil(S / 32) warps a row, J <= 17 (csrc/ctc_warp.cu
# kMaxJ, which also bounds its one-warp shape's registers); its entry points
# refuse longer lattices.
CTC_WARP_MAX_S = 17 * 32


def ctc_design(s_len: int) -> str:
    """The kernel design for a lattice of ``s_len`` states: ``"warp"``
    (csrc/ctc_warp.cu) up to CTC_WARP_MAX_S, ``"block"`` (csrc/ctc.cu)
    beyond."""
    return "warp" if s_len <= CTC_WARP_MAX_S else "block"


def _check(name: str, want: dict) -> None:
    dev = next(iter(want.values()))[0].device
    for arg, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous()
                                      for t, _ in want.values()):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")


def ctc_alpha(lp_ext: torch.Tensor, valid: torch.Tensor,
              skip: torch.Tensor) -> torch.Tensor:
    """Log-space alpha walk over the 2L+1 lattice.

    lp_ext: [T, B, S] float32 per-state emission log-probs
    valid:  [T, B] float32, 1.0 on real frames
    skip:   [B, S] float32, 0 where the s-2 -> s skip is allowed, LOG_EPS
            elsewhere
    ->      alpha_seq [T, B, S]; a padded frame repeats the previous row
    """
    t_steps, batch, s_len = lp_ext.shape
    _check("ctc_alpha", {"lp_ext": (lp_ext, (t_steps, batch, s_len)),
                         "valid": (valid, (t_steps, batch)),
                         "skip": (skip, (batch, s_len))})
    if lp_ext.device.type == "cpu":
        return ctc_alpha_plain(lp_ext, valid, skip)
    out = torch.empty_like(lp_ext)
    if out.numel() == 0:
        return out
    design = ctc_design(s_len)
    lib = _build.lib()
    fn = lib.asr_ctc_alpha_warp if design == "warp" else lib.asr_ctc_alpha
    with torch.cuda.device(lp_ext.device):
        err = fn(lp_ext.data_ptr(), valid.data_ptr(), skip.data_ptr(),
                 out.data_ptr(), t_steps, batch, s_len,
                 torch.cuda.current_stream(lp_ext.device).cuda_stream)
    _build.check(err, f"ctc_alpha ({design} design)")
    ctc_alpha.launches += 1
    ctc_alpha.by_design[design] += 1
    return out


ctc_alpha.launches = 0
ctc_alpha.by_design = {"warp": 0, "block": 0}


def ctc_beta(lp_ext: torch.Tensor, valid: torch.Tensor,
             alpha_seq: torch.Tensor, skip2: torch.Tensor,
             end_ind: torch.Tensor) -> torch.Tensor:
    """Beta walk (time reversed) -> gamma = alpha + beta.

    lp_ext, alpha_seq: [T, B, S] float32; valid: [T, B] float32
    skip2:   [B, S] the skip gate seen from the source state (allowed into
             s+2), LOG_EPS where it is not or s+2 >= S
    end_ind: [B, S] 0 at the end states, LOG_EPS elsewhere
    ->       gamma [T, B, S], LOG_EPS on padded frames
    """
    t_steps, batch, s_len = lp_ext.shape
    _check("ctc_beta", {"lp_ext": (lp_ext, (t_steps, batch, s_len)),
                        "valid": (valid, (t_steps, batch)),
                        "alpha_seq": (alpha_seq, (t_steps, batch, s_len)),
                        "skip2": (skip2, (batch, s_len)),
                        "end_ind": (end_ind, (batch, s_len))})
    if lp_ext.device.type == "cpu":
        return ctc_beta_plain(lp_ext, valid, alpha_seq, skip2, end_ind)
    out = torch.empty_like(lp_ext)
    if out.numel() == 0:
        return out
    design = ctc_design(s_len)
    lib = _build.lib()
    fn = lib.asr_ctc_beta_warp if design == "warp" else lib.asr_ctc_beta
    with torch.cuda.device(lp_ext.device):
        err = fn(lp_ext.data_ptr(), valid.data_ptr(), alpha_seq.data_ptr(),
                 skip2.data_ptr(), end_ind.data_ptr(), out.data_ptr(),
                 t_steps, batch, s_len,
                 torch.cuda.current_stream(lp_ext.device).cuda_stream)
    _build.check(err, f"ctc_beta ({design} design)")
    ctc_beta.launches += 1
    ctc_beta.by_design[design] += 1
    return out


ctc_beta.launches = 0
ctc_beta.by_design = {"warp": 0, "block": 0}


# -- the loss --------------------------------------------------------------

def final_logp(alpha_last: torch.Tensor, end: torch.Tensor,
                label_lengths: torch.Tensor) -> torch.Tensor:
    """logP from the last alpha row: the final blank and the final label."""
    a_end = torch.gather(alpha_last, 1, end[:, None])[:, 0]
    a_pre = torch.gather(alpha_last, 1,
                         torch.clamp(end - 1, min=0)[:, None])[:, 0]
    a_pre = torch.where(label_lengths > 0, a_pre,
                        torch.full_like(a_pre, LOG_EPS))
    return _logadd(a_end, a_pre)


def end_indicator(end: torch.Tensor, label_lengths: torch.Tensor,
                   s_len: int) -> torch.Tensor:
    ids = torch.arange(s_len, device=end.device)[None, :]
    at_end = (ids == end[:, None]) | ((ids == end[:, None] - 1)
                                      & (label_lengths[:, None] > 0))
    return torch.where(at_end, 0.0, LOG_EPS).to(torch.float32)


def skip_from_source(skip: torch.Tensor) -> torch.Tensor:
    """The skip gate seen from the source state: skip2[s] = skip[s+2]."""
    return _shift_l(skip, 2)


def posterior_grad(gamma: torch.Tensor, logp: torch.Tensor,
                   cot: torch.Tensor) -> torch.Tensor:
    """d nll / d lp_ext = -exp(gamma - logP) times the cotangent [B].

    The posterior is <= 1: the exponent is clamped so that infeasible rows
    (logP at the floor) cannot overflow, and their gradient is zeroed
    entirely (the derivative of the loss clamp)."""
    expo = torch.clamp(gamma - logp[None, :, None], max=0.0)
    feasible = (logp > 0.5 * LOG_EPS).to(gamma.dtype)
    return -torch.exp(expo) * (feasible * cot)[None, :, None]


class CTCNLL(torch.autograd.Function):
    """Per-sequence CTC negative log-likelihood from lattice emissions
    (the JAX ``pallas_ctc.ctc_nll``).  Differentiable in ``lp_ext`` only.

    lp_ext [T, B, S] f32, valid [T, B] f32, skip [B, S] f32,
    end [B] int64 (2 * label_lengths), label_lengths [B] int64
    -> nll [B], unclamped (the caller applies the infeasible clamp)
    """

    @staticmethod
    def forward(ctx, lp_ext, valid, skip, end, label_lengths):
        alpha_seq = ctc_alpha(lp_ext, valid, skip)
        logp = final_logp(alpha_seq[-1], end, label_lengths)
        ctx.save_for_backward(lp_ext, valid, skip, end, label_lengths,
                              alpha_seq, logp)
        return -logp

    @staticmethod
    def backward(ctx, cot):
        lp_ext, valid, skip, end, label_lengths, alpha_seq, logp = \
            ctx.saved_tensors
        gamma = ctc_beta(lp_ext, valid, alpha_seq, skip_from_source(skip),
                         end_indicator(end, label_lengths, lp_ext.shape[2]))
        return posterior_grad(gamma, logp, cot), None, None, None, None


class LatticeGather(torch.autograd.Function):
    """The per-state emissions ``lp_ext[t, b, s] = log_probs[b, t,
    ext[b, s]]`` -> [T, B, S], from log_probs [B, T, V] and the lattice's
    class ids ext [B, S] (int64, in range).

    The forward is a gather.  The backward sums each class's lattice states
    (the blank's L+1 of them) in a fixed order, so that a train step is
    reproducible bit for bit on a CUDA device, where the gather's own
    backward is an atomic scatter-add whose order changes from run to run:
    it is the one-hot [B, S, V] product of the JAX package's ``ctc_loss``,
    as one batched matmul in float64 (exact sums of the float32 cotangents
    whatever the caller's TF32 setting), rounded once to float32."""

    @staticmethod
    def forward(ctx, log_probs, ext):
        batch, t_max, vocab = log_probs.shape
        ctx.save_for_backward(ext)
        ctx.vocab = vocab
        idx = ext[:, None, :].expand(batch, t_max, ext.shape[1])
        return torch.gather(log_probs, 2, idx).transpose(0, 1).contiguous()

    @staticmethod
    def backward(ctx, d_lp):
        (ext,) = ctx.saved_tensors
        sel = torch.nn.functional.one_hot(ext, ctx.vocab).double()
        d = torch.bmm(d_lp.transpose(0, 1).double(), sel)     # [B, T, V]
        return d.to(d_lp.dtype), None


def lattice(logits: torch.Tensor, logit_lengths: torch.Tensor,
            labels: torch.Tensor, label_lengths: torch.Tensor,
            blank_id: Optional[int] = None) -> tuple[torch.Tensor, ...]:
    """The lattice inputs of :class:`CTCNLL`: (lp_ext [T, B, S], valid
    [T, B], skip [B, S], end [B], label_lengths [B]).  ``lp_ext`` keeps the
    autograd graph back to ``logits``."""
    batch, t_max, vocab = logits.shape
    if t_max == 0:
        raise ValueError("ctc_loss: logits have no frames")
    if blank_id is None:
        blank_id = vocab - 1
    dev = logits.device
    labels = labels.to(device=dev, dtype=torch.int64)
    label_lengths = label_lengths.to(device=dev, dtype=torch.int64)
    ext = extend_labels(labels, blank_id)                   # [B, S]
    # skip s-2 -> s allowed iff ext[s] is a real label differing from
    # ext[s-2] (Graves 2006 eq. 6)
    # (cut to S: at L = 0 the pad alone is wider than the lattice)
    ext_m2 = torch.cat([ext.new_full((batch, 2), -1), ext[:, :-2]],
                       dim=1)[:, : ext.shape[1]]
    can_skip = (ext != blank_id) & (ext != ext_m2)
    skip = torch.where(can_skip, 0.0, LOG_EPS).to(torch.float32)

    log_probs = torch.log_softmax(logits.float(), dim=-1)   # [B, T, V]
    # states past a row's labels never reach its end states, so an
    # out-of-range pad id may read any class: clamp it into the table
    lp_ext = LatticeGather.apply(log_probs, torch.clamp(ext, 0, vocab - 1))
    valid = (torch.arange(t_max, device=dev)[:, None]
             < logit_lengths.to(dev)[None, :]).to(torch.float32)
    return lp_ext, valid, skip, 2 * label_lengths, label_lengths


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank_id: Optional[int] = None) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood, shape [B].

    logits [B, T, V] unnormalised, logit_lengths [B] true frame counts,
    labels [B, L] class ids < blank (padding beyond ``label_lengths`` never
    influences the loss), label_lengths [B].  Infeasible sequences come out
    at ``-LOG_EPS`` with a zero gradient."""
    nll = CTCNLL.apply(*lattice(logits, logit_lengths, labels,
                                label_lengths, blank_id))
    return torch.clamp(nll, max=-LOG_EPS).to(logits.dtype)


def ctc_loss_mean(logits: torch.Tensor, logit_lengths: torch.Tensor,
                  labels: torch.Tensor, label_lengths: torch.Tensor,
                  blank_id: Optional[int] = None,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batch-mean CTC loss; ``weights`` zeroes padded rows."""
    per_seq = ctc_loss(logits, logit_lengths, labels, label_lengths,
                       blank_id)
    if weights is None:
        return per_seq.mean()
    weights = weights.to(per_seq)
    return (per_seq * weights).sum() / torch.clamp(weights.sum(), min=1.0)


# -- decoding ----------------------------------------------------------------

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
