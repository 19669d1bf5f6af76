"""CTC prefix beam search with optional char n-gram LM shallow fusion (port
of ``asr_study_tpu/ops/beam.py``, its gather form).

The beam is dense: per utterance W beams, each with its length, last
character, the (p_blank, p_nonblank) log-prob split, an LM context code and
a rolling prefix hash in two independent uint32 lanes.  Each frame expands
the W beams into W stays and W*E extensions (E = V-1 characters, or the
frame's top ``prune``), merges the candidates that denote the same prefix
and keeps the top W.  Two facts make the merge a hash match and nothing
more: two extensions never denote the same string, and the beams' prefixes
are pairwise distinct, so the only merges are stay(w) == extend(w', c),
one to one.  A spurious merge needs both hash lanes to collide.

Ranking is exact and ties go to the lower candidate index, as
``jax.lax.top_k`` and ``jnp.argsort`` break them: dead beams and killed
extensions sit at LOG_EPS exactly, so ties are common.  The decoded
strings are not carried: each frame writes (parent, emitted char)
backpointers, walked back once at the end.

:func:`beam_search_decode` takes the log-softmax in torch, then runs the
walk: on a CUDA tensor one launch of a beam kernel (:func:`ctc_beam`, a CTA
per utterance, the whole time loop inside), on a CPU tensor
:func:`beam_search_plain` (a loop over T of batched [B, W] torch ops).
:func:`beam_design` picks the kernel: ``csrc/ctc_beam.cu`` (the select
design, its state in shared memory) for W <= 128 and V <= 64, else
``csrc/ctc_beam_wide.cu`` (the wide design, its state in global-memory
scratch), so every width and vocabulary the reference takes runs on the
card.  The TPU forms of the reference (the one-hot winner reshuffle, its
16-bit halves and the ``ASR_BEAM_SELECT`` knob) are left out.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from asr_study_torch import _build
from asr_study_torch.ops.ctc import LOG_EPS, _logadd, greedy_decode

_HASH_MULT = 0x9E3779B1   # golden-ratio multiplier (lane 1)
_HASH_MULT2 = 0x85EBCA77  # murmur3 fmix constant (lane 2)
_HASH_INIT = 1
# hash seeds of the dead placeholder beams 1..W-1: distinct, so they never
# merge with anything live
_DEAD1, _DEAD2 = 0xDEAD0000, 0xBEEF0000
_U32 = 0xFFFFFFFF

# the select design's route: csrc/ctc_beam.cu sizes its shared beam state
# (W beams), a frame's char tables (V classes) and its warps' lists of 32*R
# keys (R <= 4 a lane) to these; the wide design takes the rest
SELECT_MAX_WIDTH = 128
SELECT_MAX_VOCAB = 64
# the wide design's candidate index is 32 bits of its sort key, and its
# loops count candidates in int: W * (E + 1) stays below this
WIDE_MAX_CANDIDATES = 2 ** 31


class BeamConfig(NamedTuple):
    """A decode's beam options (the CLIs' ``--beam_width``,
    ``--beam_prune``, ``--lm``, ``--lm_alpha``, ``--lm_beta``)."""
    width: int
    prune: int = 0
    lm: object = None              # text.lm.CharNGramLM
    lm_alpha: float = 1.0
    lm_beta: float = 0.0


def _mul_u32(h: torch.Tensor, mult: int) -> torch.Tensor:
    """(h * mult) mod 2^32 for int64 h in [0, 2^32), from 16-bit halves of
    ``mult`` so that no product passes 2^63."""
    lo, hi = mult & 0xFFFF, mult >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _U32


def _lm_context(lm, n_char: int) -> tuple[int, int]:
    """-> (the LM's order, the modulus of its context update); checks the
    table against the decoder's alphabet."""
    if lm.logp.shape[1] != n_char:
        raise ValueError(
            f"LM alphabet {lm.logp.shape[1]} != decoder's {n_char} "
            "(the LM must be fit on the same label vocabulary, "
            "blank excluded)")
    return lm.order, n_char ** max(lm.order - 2, 0)


# each LM's table on each device it decoded on, made at its first decode
# there (a decode per batch would otherwise copy it from the host each time)
_LM_TABLES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _lm_table(lm, dev: torch.device) -> torch.Tensor:
    """``lm.logp`` as a contiguous float32 tensor on ``dev``, moved there
    once per LM and device."""
    tables = _LM_TABLES.setdefault(lm, {})
    if dev not in tables:
        tables[dev] = torch.from_numpy(
            np.ascontiguousarray(lm.logp, np.float32)).to(dev)
    return tables[dev]


def _sort_desc(x: torch.Tensor) -> torch.Tensor:
    """Indices of ``x`` along its last dim by value descending, ties by the
    lower index first (``jax.lax.top_k``'s order; ``torch.topk`` promises
    none among ties)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices


class BeamState(NamedTuple):
    """The beam state a stream carries from chunk to chunk (the JAX
    ``beam_stream_init`` carry), in slot order, each [..., W]: lengths,
    last char (-1: none), p_blank, p_nonblank, the two hash lanes (uint32
    bits held in int32) and the LM context (0 without an LM)."""
    lengths: torch.Tensor      # int32
    last: torch.Tensor         # int32
    p_b: torch.Tensor          # float32
    p_nb: torch.Tensor         # float32
    h1: torch.Tensor           # int32, the uint32 lane's bits
    h2: torch.Tensor           # int32
    lm: torch.Tensor           # int32


def beam_stream_init(beam_width: int, lm_state0: int = 0,
                     device: torch.device | str = "cpu") -> BeamState:
    """The initial state of a stream, [W] each (JAX ``beam_stream_init``):
    beam 0 the empty prefix, the rest dead placeholders with the distinct
    hashes ``0xDEAD0000 + w`` and ``0xBEEF0000 + w``.  ``lm_state0`` is the
    LM's start context (``CharNGramLM.init_state()``), 0 without an LM."""
    w_idx = torch.arange(beam_width, dtype=torch.int64, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    p_b = torch.full((beam_width,), LOG_EPS, device=device)
    p_b[0] = 0.0
    h1, h2 = _DEAD1 + w_idx, _DEAD2 + w_idx
    h1[0] = h2[0] = _HASH_INIT
    return BeamState(torch.zeros(beam_width, **i32),
                     torch.full((beam_width,), -1, **i32), p_b,
                     torch.full((beam_width,), LOG_EPS, device=device),
                     _to_bits(h1), _to_bits(h2),
                     torch.full((beam_width,), lm_state0, **i32))


def _to_bits(h: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(h >= 2 ** 31, h - 2 ** 32, h).to(torch.int32)


def _beam_scan(log_probs: torch.Tensor, lengths: torch.Tensor, state: tuple,
               width: int, prune: int, lm, lm_alpha: float, lm_beta: float
               ) -> tuple[tuple, torch.Tensor, torch.Tensor]:
    """The reference's scan from ``state`` (int64 lengths, last char and LM
    context, float32 p_b and p_nb, int64 hash lanes in [0, 2^32), [B, W]
    each), batched over B, a Python loop over the frames within
    ``lengths`` -> (the final state, backpointers: parent and emitted char
    (-1: none) [T', B, W], T' the longest length)."""
    batch, t_max, vocab = log_probs.shape
    dev = log_probs.device
    n_char, blank = vocab - 1, vocab - 1
    n_ext = n_char if prune <= 0 else min(prune, n_char)
    i64 = dict(dtype=torch.int64, device=dev)
    w_idx = torch.arange(width, **i64)
    lengths = lengths.to(**i64)
    lens, last, p_b, p_nb, h1, h2, lm_state = state
    p_b, p_nb = p_b.to(log_probs.dtype), p_nb.to(log_probs.dtype)
    if lm is not None:
        order, lm_mod = _lm_context(lm, n_char)
        lm_tab = _lm_table(lm, dev)
    else:
        order = 0
    all_chars = torch.arange(n_char, **i64).expand(batch, n_char)

    # frames past every length leave the state and emit nothing
    t_run = max(0, min(t_max, int(lengths.max()))) if batch else 0
    bp_parent = torch.empty((t_run, batch, width), **i64)
    bp_char = torch.empty((t_run, batch, width), **i64)
    for t in range(t_run):
        lp = log_probs[:, t]                                  # [B, V]
        valid = (t < lengths)[:, None]                        # [B, 1]
        if n_ext < n_char:
            chars = _sort_desc(lp[:, :n_char])[:, :n_ext]      # [B, E]
            lp_c = torch.gather(lp, 1, chars)
        else:
            chars, lp_c = all_chars, lp[:, :n_char]

        # candidate scores
        p_tot = _logadd(p_b, p_nb)                            # [B, W]
        stay_pb = p_tot + lp[:, blank, None]
        lp_sel = torch.gather(lp, 1, last.clamp(min=0))
        stay_pnb = p_nb + torch.where(last >= 0, lp_sel, LOG_EPS)
        is_last = chars[:, None, :] == last[:, :, None]       # [B, W, E]
        ext_pnb = torch.where(is_last, p_b[..., None],
                              p_tot[..., None]) + lp_c[:, None, :]
        if lm is not None:
            lm_lp = torch.gather(lm_tab[lm_state], 2,
                                 chars[:, None, :].expand(-1, width, -1))
            ext_pnb = ext_pnb + lm_alpha * lm_lp + lm_beta
        ext_pnb = ext_pnb.reshape(batch, width * n_ext)
        step = chars[:, None, :] + 1
        ext_h1 = ((_mul_u32(h1, _HASH_MULT)[..., None] + step) & _U32
                  ).reshape(batch, -1)
        ext_h2 = ((_mul_u32(h2, _HASH_MULT2)[..., None] + step) & _U32
                  ).reshape(batch, -1)

        # merge: stay(w) == extend(w', c), found by a two-lane hash match
        eq = ((ext_h1[:, None, :] == h1[..., None])
              & (ext_h2[:, None, :] == h2[..., None]))        # [B, W, W*E]
        absorbed = torch.where(eq, ext_pnb[:, None, :], LOG_EPS).amax(2)
        stay_pnb = _logadd(stay_pnb, absorbed)
        ext_score = torch.where(eq.any(1), LOG_EPS, ext_pnb)
        stay_score = _logadd(stay_pb, stay_pnb)

        # keep the top W of [W stays | W*E extensions]
        sel = _sort_desc(torch.cat([stay_score, ext_score], 1))[:, :width]
        is_stay = sel < width
        eflat = (sel - width).clamp(min=0)
        parent = torch.where(is_stay, sel, eflat // n_ext)
        ext_char = torch.gather(chars, 1, eflat % n_ext)
        if lm is not None and order >= 2:
            ext_lm = (torch.gather(lm_state, 1, parent) % lm_mod) * n_char \
                + ext_char
        else:
            ext_lm = torch.gather(lm_state, 1, parent)

        def pick(stay, ext):
            return torch.where(is_stay, torch.gather(stay, 1, parent), ext)

        new = (
            torch.gather(lens, 1, parent) + (~is_stay).long(),
            torch.where(is_stay, torch.gather(last, 1, parent), ext_char),
            torch.where(is_stay, torch.gather(stay_pb, 1, parent), LOG_EPS),
            pick(stay_pnb, torch.gather(ext_pnb, 1, eflat)),
            pick(h1, torch.gather(ext_h1, 1, eflat)),
            pick(h2, torch.gather(ext_h2, 1, eflat)),
            pick(lm_state, ext_lm),
        )
        lens, last, p_b, p_nb, h1, h2, lm_state = (
            torch.where(valid, n, o) for n, o in
            zip(new, (lens, last, p_b, p_nb, h1, h2, lm_state)))
        bp_parent[t] = torch.where(valid, parent, w_idx)
        bp_char[t] = torch.where(valid & ~is_stay, ext_char, -1)
    return (lens, last, p_b, p_nb, h1, h2, lm_state), bp_parent, bp_char


def _walk_back(bp_parent: torch.Tensor, bp_char: torch.Tensor, t_max: int,
               pad_id: int) -> tuple[torch.Tensor, ...]:
    """The backpointers walked back from each final slot (JAX
    ``_materialize``) -> (prefixes [B, W, t_max] int64, each emitted char
    at its position and ``pad_id`` past them, emits [B, W], the slot each
    final beam started the span in [B, W])."""
    t_run, batch, width = bp_parent.shape
    slots = torch.arange(width, device=bp_parent.device).expand(batch, width)
    chars_tw = torch.empty_like(bp_char)
    for t in reversed(range(t_run)):
        chars_tw[t] = torch.gather(bp_char[t], 1, slots)
        slots = torch.gather(bp_parent[t], 1, slots)
    emitted = chars_tw >= 0
    pos = torch.where(emitted, emitted.cumsum(0) - 1, t_max)
    prefixes = torch.full((batch, width, t_max + 1), pad_id,
                          dtype=torch.int64, device=bp_parent.device)
    prefixes.scatter_(2, pos.permute(1, 2, 0), chars_tw.permute(1, 2, 0))
    return prefixes[..., :t_max], emitted.sum(0), slots


def beam_search_plain(log_probs: torch.Tensor, lengths: torch.Tensor,
                      beam_width: int, pad_id: int = -1, prune: int = 0,
                      lm=None, lm_alpha: float = 1.0, lm_beta: float = 0.0
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of :func:`ctc_beam`: the reference's scan, batched
    over B as [B, W] state tensors, a Python loop over T.

    log_probs [B, T, V] float32 (a log-softmax, blank = V-1), lengths [B]
    -> (prefixes [B, W, T] int32 padded with ``pad_id``, lengths [B, W]
    int32, scores [B, W] float32), all W beams best first."""
    batch, t_max, _ = log_probs.shape
    dev = log_probs.device
    init = beam_stream_init(beam_width, 0 if lm is None else lm.init_state(),
                            dev)
    state, bp_parent, bp_char = _beam_scan(
        log_probs, lengths, _working(init, batch), beam_width, prune, lm,
        lm_alpha, lm_beta)
    lens, _, p_b, p_nb = state[:4]
    prefixes = _walk_back(bp_parent, bp_char, t_max, pad_id)[0]

    scores = _logadd(p_b, p_nb)
    order_w = _sort_desc(scores)
    prefixes = torch.gather(prefixes, 1,
                            order_w[..., None].expand(-1, -1, t_max))
    lens = torch.gather(lens, 1, order_w)
    prefixes = torch.where(torch.arange(t_max, device=dev) < lens[..., None],
                           prefixes, pad_id)
    return (prefixes.to(torch.int32), lens.to(torch.int32),
            torch.gather(scores, 1, order_w))


def _working(state: BeamState, batch: int | None = None) -> tuple:
    """A :class:`BeamState` ([B, W], or [W] broadcast to ``batch`` rows) as
    :func:`_beam_scan` takes it: int64 integers, the hash lanes in [0,
    2^32)."""
    if batch is not None:
        state = BeamState(*(t.expand(batch, -1) for t in state))
    lens, last, p_b, p_nb, h1, h2, lm = state
    i64 = [t.to(torch.int64) for t in (lens, last, h1, h2, lm)]
    return (i64[0], i64[1], p_b.clone(), p_nb.clone(), i64[2] & _U32,
            i64[3] & _U32, i64[4])


def beam_stream_plain(log_probs: torch.Tensor, lengths: torch.Tensor,
                      state: BeamState, beam_width: int, pad_id: int = -1,
                      prune: int = 0, lm=None, lm_alpha: float = 1.0,
                      lm_beta: float = 0.0) -> tuple:
    """The plain version of :func:`ctc_beam_stream`: :func:`beam_search_plain`
    started from ``state`` ([B, W] each) and left unsorted.

    log_probs [B, T, V] float32 log-softmax of one chunk of B streams,
    lengths [B] the chunk's valid frames -> (the final state, prefixes [B,
    W, T] int32 (each slot's chars of the chunk, ``pad_id`` past them),
    emits [B, W] int32, start_slots [B, W] int32 (the slot each beam began
    the chunk in), scores [B, W] float32), in slot order."""
    t_max = log_probs.shape[1]
    fin, bp_parent, bp_char = _beam_scan(
        log_probs, lengths, _working(state), beam_width, prune, lm,
        lm_alpha, lm_beta)
    prefixes, emits, start = _walk_back(bp_parent, bp_char, t_max, pad_id)
    lens, last, p_b, p_nb, h1, h2, lm_ctx = fin
    i32 = torch.int32
    out = BeamState(lens.to(i32), last.to(i32), p_b, p_nb, _to_bits(h1),
                    _to_bits(h2), lm_ctx.to(i32))
    return (out, prefixes.to(i32), emits.to(i32), start.to(i32),
            _logadd(p_b, p_nb))


def beam_design(beam_width: int, vocab: int) -> str:
    """The beam kernel a decode of ``beam_width`` beams over ``vocab``
    classes (blank included) launches: "select" (``csrc/ctc_beam.cu``) for
    W <= 128 and V <= 64, else "wide" (``csrc/ctc_beam_wide.cu``)."""
    if beam_width < 1:
        raise ValueError(f"ctc_beam: beam_width {beam_width} < 1")
    if vocab < 2:
        raise ValueError(f"ctc_beam: {vocab} classes (blank included) < 2")
    if beam_width <= SELECT_MAX_WIDTH and vocab <= SELECT_MAX_VOCAB:
        return "select"
    return "wide"


def wide_scratch_bytes(beam_width: int, vocab: int, n_ext: int) -> int:
    """The wide design's scratch an utterance, in bytes (the layout of
    ``csrc/ctc_beam_wide.cu`` ``carve``, which checks it): 8-byte candidate
    keys (W + W*E) and the sorted top W (padded to a power of two); the two
    state buffers (10 fields of W), the stays' merged p_nonblank, the kill
    stamps (W*E) and two frames' chars (E, E, V-1), 4 bytes each; rounded
    up to 8."""
    w, e = beam_width, n_ext
    wp = 1 << max(w - 1, 0).bit_length()
    n = 8 * (w + w * e + wp) + 4 * (20 * w + w + w * e + 4 * e
                                    + 2 * (vocab - 1))
    return -(-n // 8) * 8


def _wide_buffers(batch: int, t_max: int, beam_width: int, vocab: int,
                  n_ext: int, dev: torch.device
                  ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The wide design's backpointers [B, T, W] int64 and scratch [B,
    stride] bytes -> (bp, scratch, stride); raises ValueError, with the
    numbers, for a frame of too many candidates or scratch past the card's
    memory."""
    cand = beam_width * (n_ext + 1)
    if cand >= WIDE_MAX_CANDIDATES:
        raise ValueError(
            f"ctc_beam: W={beam_width} beams by E={n_ext} extension chars "
            f"make {cand} candidates a frame, past the wide design's "
            f"{WIDE_MAX_CANDIDATES - 1} (a 32-bit candidate index)")
    stride = wide_scratch_bytes(beam_width, vocab, n_ext)
    need = batch * (stride + 8 * max(t_max, 1) * beam_width)
    try:
        bp = torch.empty((batch, max(t_max, 1), beam_width),
                         dtype=torch.int64, device=dev)
        scratch = torch.empty((batch, stride), dtype=torch.uint8, device=dev)
    except torch.cuda.OutOfMemoryError as e:
        free, total = torch.cuda.mem_get_info(dev)
        raise ValueError(
            f"ctc_beam: the wide design needs {need} bytes of scratch and "
            f"backpointers for B={batch}, T={t_max}, W={beam_width}, "
            f"V={vocab}, E={n_ext}; {dev} has {free} of {total} free") from e
    return bp, scratch, stride


def _lm_args(lm, n_char: int, dev: torch.device) -> tuple[int, int, int]:
    """(order, context modulus, table pointer) of a decode's LM on ``dev``,
    (0, 1, 0) without one."""
    if lm is None:
        return 0, 1, 0
    order, lm_mod = _lm_context(lm, n_char)
    if lm.logp.shape[0] >= 2 ** 31:
        raise ValueError("ctc_beam: the LM's context codes pass int32")
    return order, lm_mod, _lm_table(lm, dev).data_ptr()


def _check_input(log_probs: torch.Tensor, what: str) -> None:
    if log_probs.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {log_probs.device}")
    if log_probs.dtype != torch.float32:
        raise ValueError(f"{what}: log_probs must be float32, got "
                         f"{log_probs.dtype}")


def ctc_beam(log_probs: torch.Tensor, lengths: torch.Tensor,
             beam_width: int, pad_id: int = -1, top_paths: int = 1,
             prune: int = 0, lm=None, lm_alpha: float = 1.0,
             lm_beta: float = 0.0
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The beam walk on a CUDA tensor: one launch of the kernel
    :func:`beam_design` picks (``csrc/ctc_beam.cu`` or
    ``csrc/ctc_beam_wide.cu``) for the batch, counted in ``launches`` and
    ``by_design``.

    log_probs [B, T, V] float32 log-softmax (blank = V-1), lengths [B] ->
    (prefixes [B, P, T] int32, lengths [B, P] int32, scores [B, P]
    float32), P = min(top_paths, beam_width), best first.  Raises for a
    tensor not on a CUDA device, and on the wide design for a frame of 2^31
    candidates or scratch past the card's memory."""
    batch, t_max, vocab = log_probs.shape
    dev = log_probs.device
    _check_input(log_probs, "ctc_beam")
    design = beam_design(beam_width, vocab)
    n_char = vocab - 1
    n_ext = n_char if prune <= 0 else min(prune, n_char)
    paths = max(1, min(top_paths, beam_width))
    lp = log_probs.contiguous()
    lens_in = lengths.to(device=dev, dtype=torch.int32).contiguous()
    prefixes = torch.empty((batch, paths, t_max), dtype=torch.int32,
                           device=dev)
    out_len = torch.empty((batch, paths), dtype=torch.int32, device=dev)
    scores = torch.empty((batch, paths), dtype=torch.float32, device=dev)
    if batch == 0:
        return prefixes, out_len, scores
    order, lm_mod, lm_ptr = _lm_args(lm, n_char, dev)
    state0 = 0 if lm is None else lm.init_state()
    tail = (prefixes.data_ptr(), out_len.data_ptr(), scores.data_ptr(),
            batch, t_max, vocab, beam_width, paths, n_ext, pad_id, order,
            lm_mod, state0, lm_alpha, lm_beta, _HASH_MULT & _U32,
            _HASH_MULT2 & _U32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if design == "select":
            # backpointers (parent | (char + 1) << 16) of every frame, beam
            bp = torch.empty((batch, max(t_max, 1), beam_width),
                             dtype=torch.int32, device=dev)
            err = _build.lib().asr_ctc_beam(
                lp.data_ptr(), lens_in.data_ptr(), lm_ptr, bp.data_ptr(),
                *tail, stream)
        else:
            bp, scratch, stride = _wide_buffers(batch, t_max, beam_width,
                                                vocab, n_ext, dev)
            err = _build.lib().asr_ctc_beam_wide(
                lp.data_ptr(), lens_in.data_ptr(), lm_ptr, bp.data_ptr(),
                scratch.data_ptr(), stride, *tail, stream)
    _build.check(err, f"ctc_beam ({design} design)")
    ctc_beam.launches += 1
    ctc_beam.by_design[design] += 1
    return prefixes, out_len, scores


ctc_beam.launches = 0
ctc_beam.by_design = {"select": 0, "wide": 0}


def ctc_beam_stream(log_probs: torch.Tensor, lengths: torch.Tensor,
                    state: BeamState, beam_width: int, pad_id: int = -1,
                    prune: int = 0, lm=None, lm_alpha: float = 1.0,
                    lm_beta: float = 0.0) -> tuple:
    """The stream form on a CUDA tensor: one launch of the kernel
    :func:`beam_design` picks (``asr_ctc_beam_stream`` or
    ``asr_ctc_beam_wide_stream``) for a chunk of B streams, counted with
    :func:`ctc_beam`'s launches.  Arguments and results as
    :func:`beam_stream_plain`'s; the kernel writes the new state into a
    copy of ``state``, which stays as it was.  Raises for a tensor not on
    a CUDA device and as :func:`ctc_beam`."""
    batch, t_max, vocab = log_probs.shape
    dev = log_probs.device
    _check_input(log_probs, "ctc_beam_stream")
    design = beam_design(beam_width, vocab)
    for name, t in zip(BeamState._fields, state):
        want = torch.float32 if name.startswith("p_") else torch.int32
        if (tuple(t.shape) != (batch, beam_width) or t.dtype != want
                or t.device != dev):
            raise ValueError(
                f"ctc_beam_stream: state.{name} must be {want} "
                f"{(batch, beam_width)} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    n_char = vocab - 1
    n_ext = n_char if prune <= 0 else min(prune, n_char)
    lp = log_probs.contiguous()
    lens_in = lengths.to(device=dev, dtype=torch.int32).contiguous()
    new = BeamState(*(t.contiguous().clone() for t in state))
    i32 = dict(dtype=torch.int32, device=dev)
    prefixes = torch.empty((batch, beam_width, t_max), **i32)
    emits = torch.empty((batch, beam_width), **i32)
    start = torch.empty((batch, beam_width), **i32)
    scores = torch.empty((batch, beam_width), dtype=torch.float32,
                         device=dev)
    if batch == 0:
        return new, prefixes, emits, start, scores
    order, lm_mod, lm_ptr = _lm_args(lm, n_char, dev)
    tail = (*(t.data_ptr() for t in new), prefixes.data_ptr(),
            emits.data_ptr(), start.data_ptr(), scores.data_ptr(), batch,
            t_max, vocab, beam_width, n_ext, pad_id, order, lm_mod, lm_alpha,
            lm_beta, _HASH_MULT & _U32, _HASH_MULT2 & _U32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if design == "select":
            bp = torch.empty((batch, max(t_max, 1), beam_width), **i32)
            err = _build.lib().asr_ctc_beam_stream(
                lp.data_ptr(), lens_in.data_ptr(), lm_ptr, bp.data_ptr(),
                *tail, stream)
        else:
            bp, scratch, stride = _wide_buffers(batch, t_max, beam_width,
                                                vocab, n_ext, dev)
            err = _build.lib().asr_ctc_beam_wide_stream(
                lp.data_ptr(), lens_in.data_ptr(), lm_ptr, bp.data_ptr(),
                scratch.data_ptr(), stride, *tail, stream)
    _build.check(err, f"ctc_beam_stream ({design} design)")
    ctc_beam.launches += 1
    ctc_beam.by_design[design] += 1
    return new, prefixes, emits, start, scores


def _valid_frames(valid, t_max: int) -> int:
    """A chunk's valid frames: a count, or a [t] bool mask that must be a
    prefix (the streams pad only their ragged tail)."""
    if isinstance(valid, (int, np.integer)):
        return max(0, min(int(valid), t_max))
    v = torch.as_tensor(np.asarray(valid) if not torch.is_tensor(valid)
                        else valid).to("cpu", torch.bool)
    n = int(v.sum())
    if tuple(v.shape) != (t_max,) or not bool(v[:n].all()):
        raise ValueError("beam_stream_chunk: valid must be a [t] mask of "
                         "leading frames")
    return n


def beam_stream_chunk(log_probs: torch.Tensor, valid, state: BeamState,
                      beam_width: int, blank_id: int, prune: int = 0,
                      pad_id: int = -1, lm=None, lm_alpha: float = 1.0,
                      lm_beta: float = 0.0) -> tuple:
    """Advance one stream's beam over one chunk (JAX ``beam_stream_chunk``).

    log_probs [t, V] a log-softmax (blank = V-1), ``valid`` the chunk's
    valid frames (a count, or a [t] mask of leading frames), ``state`` [W]
    each from :func:`beam_stream_init` or the previous chunk (with an LM,
    ``beam_stream_init(W, lm.init_state())``) -> (state, prefixes [W, t],
    emits [W], start_slots [W], scores [W]): beam w extends the previous
    chunk's beam ``start_slots[w]`` by ``prefixes[w, :emits[w]]``.  The
    beams stay in slot order; order by ``scores`` at the stream's end.  A
    CUDA tensor launches the kernel (:func:`ctc_beam_stream`), a CPU one
    takes :func:`beam_stream_plain`."""
    t_max, vocab = log_probs.shape
    if blank_id != vocab - 1:
        raise ValueError("beam_stream_chunk requires blank as the last id")
    dev = log_probs.device
    if dev.type == "cuda":
        run = ctc_beam_stream
    elif dev.type == "cpu":
        run = beam_stream_plain
    else:
        raise ValueError(f"beam_stream_chunk: no kernel for device {dev}")
    lengths = torch.tensor([_valid_frames(valid, t_max)], dtype=torch.int32,
                           device=dev)
    out = run(log_probs[None], lengths, BeamState(*(t[None] for t in state)),
              beam_width, pad_id, prune, lm, lm_alpha, lm_beta)
    return (BeamState(*(t[0] for t in out[0])),
            *(t[0] for t in out[1:]))


def beam_search_decode(
    logits: torch.Tensor,           # [B, T, V]
    logit_lengths: torch.Tensor,    # [B]
    beam_width: int = 16,
    blank_id: Optional[int] = None,
    pad_id: int = -1,
    top_paths: int = 1,
    prune: int = 0,
    lm=None,
    lm_alpha: float = 1.0,
    lm_beta: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CTC prefix beam search over a batch.

    Returns (decoded [B, P, T] int32 padded with ``pad_id``, lengths [B, P]
    int32, log_scores [B, P] float32) with ``P = top_paths`` beams (at most
    ``beam_width``) best first.  ``prune > 0`` expands only the frame's
    top-``prune`` characters.  ``lm`` (a ``text.lm.CharNGramLM`` over the
    label alphabet, blank excluded) fuses ``lm_alpha * log p_lm + lm_beta``
    into every extension, so beams rank, and the scores are, the combined
    objective.  CPU tensors take :func:`beam_search_plain`; CUDA tensors
    launch the kernel (:func:`ctc_beam`) or raise."""
    vocab = logits.shape[-1]
    if blank_id is None:
        blank_id = vocab - 1
    if blank_id != vocab - 1:
        raise ValueError("beam_search_decode requires blank as the last id")
    dev = logits.device
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    if dev.type == "cuda":
        return ctc_beam(log_probs, logit_lengths, beam_width, pad_id,
                        top_paths, prune, lm, lm_alpha, lm_beta)
    if dev.type != "cpu":
        raise ValueError(f"beam_search_decode: no kernel for device {dev}")
    prefixes, lens, scores = beam_search_plain(
        log_probs, logit_lengths, beam_width, pad_id, prune, lm, lm_alpha,
        lm_beta)
    return (prefixes[:, :top_paths], lens[:, :top_paths],
            scores[:, :top_paths])


def decode(logits: torch.Tensor, lengths: torch.Tensor, blank_id: int,
           beam: Optional[BeamConfig] = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode, or with ``beam`` the best beam -> (decoded [B, T']
    int32 padded with -1, lengths [B] int32)."""
    if beam is None or beam.width <= 0:
        return greedy_decode(logits, lengths, blank_id=blank_id)
    dec, lens, _ = beam_search_decode(
        logits, lengths, beam_width=beam.width, blank_id=blank_id,
        prune=beam.prune, lm=beam.lm, lm_alpha=beam.lm_alpha,
        lm_beta=beam.lm_beta)
    return dec[:, 0], lens[:, 0]
