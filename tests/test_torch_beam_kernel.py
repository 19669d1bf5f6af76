"""NumPy models of the two algorithms of ``csrc/ctc_beam.cu`` (the beam
decode's CUDA kernel), held exactly against the plain twin's own forms in
``ops/beam.py`` ``beam_search_plain``.

- The merge: a stay w can absorb only the extension of a parent p by the
  one step s = h1[w] - h1[p] * mult1 (mod 2^32) that lane 1 of the hash
  allows, if 1 <= s <= V-1, the char s-1 is among the frame's extension
  chars (the inverse table ``slot``) and lane 2 agrees: W*W pair checks.
  Its absorbed maxima and kill mask must equal those of the twin's ``eq``
  tensor (both hash lanes of every stay against every extension's).
- The selection: each warp's 32-key chunks, less the keys above the worst
  stay's key, sorted by a bitonic network of shuffles and merged into a
  running first 32*R keys, the lists merged by rank (a binary search in
  each).  Its winners must equal ``_sort_desc(cat)[:, :W]``.

States come from real twin decodes (recorded as the twin runs) and from
adversarial constructions: lane 1 degraded to a multiplier of 0, lane-1
collisions, the dead placeholder beams, stays whose last char was pruned
away, two stays with the same hashes; ties at LOG_EPS, -0.0 against +0.0,
all-equal scores, candidate counts that are no multiple of 32.
"""

import numpy as np
import pytest
import torch

from asr_study_torch.ops import beam
from asr_study_torch.ops.ctc import LOG_EPS

U32 = 0xFFFFFFFF
PAD = np.uint64(0xFFFFFFFFFFFFFFFF)
LANE = np.arange(32)
WIDTHS = (1, 4, 16, 64, 128)


# -- the models ----------------------------------------------------------------

def merge_model(h1, h2, chars, n_char, ext_pnb, mult1, mult2):
    """The kernel's merge for one utterance: h1, h2 [W] (uint32 values),
    chars [E] (the frame's extension chars by rank), ext_pnb [W, E] float32
    -> (absorbed [W] float32, killed [W*E] bool, pair checks made)."""
    width, n_ext = ext_pnb.shape
    slot = np.full(n_char, -1)
    slot[chars] = np.arange(n_ext)
    h1 = np.asarray(h1, np.uint64)
    h2 = np.asarray(h2, np.uint64)
    # [stay w, parent p]: the one step lane 1 allows
    s = (h1[:, None] - h1[None, :] * np.uint64(mult1)) & U32
    ok = (s >= 1) & (s <= n_char)
    e = np.where(ok, slot[np.clip(s.astype(np.int64) - 1, 0, n_char - 1)],
                 -1)
    match = (e >= 0) & (((h2[None, :] * np.uint64(mult2) + s) & U32)
                        == h2[:, None])
    absorbed = np.full(width, LOG_EPS, np.float32)
    killed = np.zeros(width * n_ext, bool)
    for w, p in zip(*np.nonzero(match)):
        absorbed[w] = max(absorbed[w], ext_pnb[p, e[w, p]])
        killed[p * n_ext + e[w, p]] = True
    return absorbed, killed, s.size


def make_keys(scores):
    """The kernel's 64-bit keys: the score, ordered descending, above the
    candidate index; -0 as +0."""
    u = np.asarray(scores, np.float32).view(np.uint32).astype(np.uint64)
    u = np.where(u == 0x80000000, 0, u)
    u = np.where(u & 0x80000000, ~u & U32, u | 0x80000000)
    return ((~u & U32) << 32) | np.arange(len(u), dtype=np.uint64)


def warp_sort(x):
    """Ascending bitonic sort of 32 keys, one a lane, by xor shuffles."""
    k = 2
    while k <= 32:
        j = k // 2
        while j:
            o = x[LANE ^ j]
            keep_min = ((LANE & j) == 0) == ((LANE & k) == 0)
            x = np.where(keep_min, np.minimum(x, o), np.maximum(x, o))
            j //= 2
        k *= 2
    return x


def merge_chunk(lst, chunk):
    """The running list [R, 32] (element r*32 + lane, ascending) and an
    ascending chunk -> the first 32*R of both, ascending."""
    lst = lst.copy()
    n_regs = lst.shape[0]
    lst[-1] = np.minimum(lst[-1], chunk[31 - LANE])
    jr = n_regs // 2
    while jr:
        for q in range(n_regs // 2):
            r = (q // jr) * 2 * jr + q % jr
            lo = np.minimum(lst[r], lst[r + jr])
            hi = np.maximum(lst[r], lst[r + jr])
            lst[r], lst[r + jr] = lo, hi
        jr //= 2
    for j in (16, 8, 4, 2, 1):
        o = lst[:, LANE ^ j]
        lst = np.where((LANE & j) != 0, np.maximum(lst, o),
                       np.minimum(lst, o))
    return lst


def select_model(scores, width, warps, regs):
    """The kernel's top-``width`` selection of one utterance's candidate
    scores (the first ``width`` are the stays) with ``warps`` warps keeping
    32*``regs`` keys each -> the winners' candidate indices, slot by
    slot."""
    keys = make_keys(scores)
    n_chunks = -(-len(keys) // 32)
    padded = np.full(n_chunks * 32, PAD, np.uint64)
    padded[:len(keys)] = keys
    lists = np.full((warps, 32 * regs), PAD, np.uint64)
    # the worst stay's key bounds the top W: the extensions above it go
    bound = keys[:width].max()
    for w in range(warps):
        lst = np.full((regs, 32), PAD, np.uint64)
        empty = True
        for c in range(w, n_chunks, warps):
            chunk = padded[c * 32:(c + 1) * 32]
            chunk = np.where(chunk > bound, PAD, chunk)
            if (chunk == PAD).all():      # nothing kept: not sorted
                continue
            chunk = warp_sort(chunk)
            lst = np.where(np.arange(regs)[:, None] == 0, chunk, lst) \
                if empty else merge_chunk(lst, chunk)
            empty = False
        lists[w] = lst.reshape(-1)
        # the first 32*R keys of the warp's chunks at or below the bound
        own = np.concatenate([padded[c * 32:(c + 1) * 32] for c in
                              range(w, n_chunks, warps)] or [[]])
        own = np.sort(own[own <= bound]).astype(np.uint64)
        own = np.concatenate([own, np.full(32 * regs, PAD, np.uint64)])
        np.testing.assert_array_equal(lists[w], own[:32 * regs])
    kept = (lists != PAD).sum(1)
    li, q = np.divmod(np.arange(warps * width), width)
    live = q < kept[li]
    li, q = li[live], q[live]
    key = lists[li, q]
    rank = q.copy()
    for j in np.flatnonzero(kept):
        pos = np.zeros_like(rank)
        s = 16 * regs
        while s:
            pos += s * (lists[j][pos + s - 1] < key)
            s >>= 1
        pos += lists[j][pos] < key
        rank += np.where(li == j, 0, pos)
    win = rank < width
    # every slot has exactly one winner
    assert np.bincount(rank[win], minlength=width).tolist() == [1] * width
    out = np.full(width, -1, np.int64)
    out[rank[win]] = (key[win] & U32).astype(np.int64)
    return out


def kernel_regs(width):
    """Keys a lane of the kernel's lists for a beam width."""
    return 1 if width <= 32 else 2 if width <= 64 else 4


# -- the twin's forms ----------------------------------------------------------

def twin_merge(h1, h2, chars, ext_pnb):
    """ops/beam.py beam_search_plain's merge (its ``eq`` tensor) for one
    utterance -> (absorbed [W], killed [W*E])."""
    h1 = torch.as_tensor(np.asarray(h1, np.int64))[None]
    h2 = torch.as_tensor(np.asarray(h2, np.int64))[None]
    step = torch.as_tensor(np.asarray(chars, np.int64))[None, None, :] + 1
    ext_h1 = ((beam._mul_u32(h1, beam._HASH_MULT)[..., None] + step)
              & beam._U32).reshape(1, -1)
    ext_h2 = ((beam._mul_u32(h2, beam._HASH_MULT2)[..., None] + step)
              & beam._U32).reshape(1, -1)
    ext = torch.from_numpy(np.asarray(ext_pnb, np.float32)).reshape(1, -1)
    eq = ((ext_h1[:, None, :] == h1[..., None])
          & (ext_h2[:, None, :] == h2[..., None]))
    absorbed = torch.where(eq, ext[:, None, :], LOG_EPS).amax(2)
    return absorbed[0].numpy(), eq.any(1)[0].numpy()


def twin_select(scores, width):
    return beam._sort_desc(torch.from_numpy(
        np.asarray(scores, np.float32))[None])[0, :width].numpy()


def check_merge(h1, h2, chars, n_char, rng):
    """The model against the twin's form on one state, with extension
    scores that tie at LOG_EPS and elsewhere; -> the number of matches."""
    width, n_ext = len(h1), len(chars)
    ext = rng.choice(np.float32([LOG_EPS, -3.5, -1.25, 0.0]),
                     size=(width, n_ext))
    ext = np.where(rng.rand(width, n_ext) < 0.5,
                   rng.randn(width, n_ext) * 4, ext).astype(np.float32)
    got_abs, got_kill, checks = merge_model(
        h1, h2, chars, n_char, ext, beam._HASH_MULT & U32,
        beam._HASH_MULT2 & U32)
    want_abs, want_kill = twin_merge(h1, h2, chars, ext)
    assert checks == width * width
    np.testing.assert_array_equal(got_abs, want_abs)
    np.testing.assert_array_equal(got_kill, want_kill)
    return int(got_kill.sum())


def recorded_decode(monkeypatch, width, prune, seed, t_max=14, vocab=7):
    """A twin decode with its hash lanes and candidate scores recorded
    frame by frame -> (log_probs [B, T, V], [(h1 [B, W], h2 [B, W])],
    [cat [B, W + W*E]])."""
    rng = np.random.RandomState(seed)
    x = (2.0 * rng.randn(3, t_max, vocab)).astype(np.float32)
    x[:, :, -1] += np.where(rng.rand(3, t_max) < 0.5, 2.0, -2.0)
    lp = torch.log_softmax(torch.from_numpy(x), -1)
    lens = torch.tensor([t_max, t_max - 3, 1])
    hashes, cats = [], []
    mul, sort = beam._mul_u32, beam._sort_desc
    n_ext = prune if prune else vocab - 1

    def record_mul(h, mult):
        if not hashes or len(hashes[-1]) == 2:     # h1, then h2
            hashes.append([h.clone()])
        else:
            hashes[-1].append(h.clone())
        return mul(h, mult)

    def record_sort(v):
        if v.shape[-1] == width + width * n_ext:
            cats.append(v.clone())
        return sort(v)

    monkeypatch.setattr(beam, "_mul_u32", record_mul)
    monkeypatch.setattr(beam, "_sort_desc", record_sort)
    beam.beam_search_plain(lp, lens, width, prune=prune)
    monkeypatch.setattr(beam, "_mul_u32", mul)
    monkeypatch.setattr(beam, "_sort_desc", sort)
    assert len(hashes) == len(cats) == t_max
    return lp, hashes, cats


def frame_chars(lp_t, prune):
    """The twin's extension chars of a frame (row [V])."""
    n_char = lp_t.shape[-1] - 1
    if not prune:
        return np.arange(n_char)
    return beam._sort_desc(lp_t[None, :n_char])[0, :prune].numpy()


# -- the merge -----------------------------------------------------------------

@pytest.mark.parametrize("mult0", [False, True], ids=["hash", "lane1_mult0"])
@pytest.mark.parametrize("prune", [0, 3])
@pytest.mark.parametrize("width", WIDTHS)
def test_merge_model_on_twin_states(monkeypatch, width, prune, mult0):
    """Every frame's state of real twin decodes (V=7, 14 frames, rows of
    length 14, 11 and 1): the model's absorbed maxima and kill mask equal
    the twin's ``eq`` form; with prune 3 some stays' last chars are pruned
    away; with lane 1's multiplier 0 its hash is the last char + 1."""
    if mult0:
        monkeypatch.setattr(beam, "_HASH_MULT", 0)
    lp, hashes, _ = recorded_decode(monkeypatch, width, prune, seed=width)
    rng = np.random.RandomState(width + prune)
    matches = 0
    for t, (h1, h2) in enumerate(hashes):
        for b in range(lp.shape[0]):
            matches += check_merge(h1[b].numpy(), h2[b].numpy(),
                                   frame_chars(lp[b, t], prune),
                                   lp.shape[-1] - 1, rng)
    if width >= 4:
        assert matches > 0


def _prefix_hashes(prefixes, mult1, mult2):
    """Both hash lanes of each prefix (a list of char ids), as the twin
    rolls them from _HASH_INIT."""
    out1, out2 = [], []
    for pre in prefixes:
        g1 = g2 = beam._HASH_INIT
        for c in pre:
            g1 = (g1 * mult1 + int(c) + 1) & U32
            g2 = (g2 * mult2 + int(c) + 1) & U32
        out1.append(g1)
        out2.append(g2)
    return np.array(out1, np.uint64), np.array(out2, np.uint64)


@pytest.mark.parametrize("width", WIDTHS)
def test_merge_model_on_constructed_states(width):
    """Constructed states: the dead placeholders of the first frame; stays
    that are extensions of other beams (true merges); lane-1 collisions
    whose lane 2 differs; stays one step of 0 or V (no char's) from a beam
    in both lanes; stays whose last char is pruned this frame; two stays
    with the same hashes (both absorb, the extension killed once)."""
    rng = np.random.RandomState(100 + width)
    n_char = 27
    m1, m2 = beam._HASH_MULT & U32, beam._HASH_MULT2 & U32
    # the first frame: the empty prefix and the dead placeholders
    w_idx = np.arange(width, dtype=np.uint64)
    h1 = (beam._DEAD1 + w_idx) & U32
    h2 = (beam._DEAD2 + w_idx) & U32
    h1[0] = h2[0] = beam._HASH_INIT
    check_merge(h1, h2, np.arange(n_char), n_char, rng)
    # random prefixes, then stays built from other beams
    prefixes = [list(rng.randint(0, n_char, size=rng.randint(0, 6)))
                for _ in range(width)]
    for w in range(1, width):
        p = rng.randint(0, w)
        if w % 4 == 1:
            prefixes[w] = prefixes[p] + [int(rng.randint(0, n_char))]
    h1, h2 = _prefix_hashes(prefixes, m1, m2)
    for w in range(2, width, 4):        # lane 1 only: a collision
        p = int(rng.randint(0, width))
        c = int(rng.randint(0, n_char))
        h1[w] = (h1[p] * np.uint64(m1) + c + 1) & U32
        h2[w] = (h2[w] + 7) & U32
    for w in range(3, width, 8):        # steps 0 and V: no char's
        p = int(rng.randint(0, width))
        step = np.uint64(0 if w % 16 == 3 else n_char + 1)
        h1[w] = (h1[p] * np.uint64(m1) + step) & U32
        h2[w] = (h2[p] * np.uint64(m2) + step) & U32
    if width >= 8:                      # the same hashes twice
        h1[6], h2[6] = h1[1], h2[1]
    chars = np.arange(n_char)
    full = check_merge(h1, h2, chars, n_char, rng)
    if width >= 8:
        assert full > 0
    # prune: the extensions' chars of the true merges leave the frame
    last = {pre[-1] for pre in prefixes if pre}
    kept = np.array([c for c in range(n_char) if c not in last][:8]
                    or [0])
    check_merge(h1, h2, kept, n_char, rng)
    for n_ext in (1, 8):
        check_merge(h1, h2, rng.permutation(n_char)[:n_ext], n_char, rng)


# -- the selection -------------------------------------------------------------

@pytest.mark.parametrize("warps", [4, 8, 16])
@pytest.mark.parametrize("prune", [0, 3])
@pytest.mark.parametrize("width", WIDTHS)
def test_select_model_on_twin_candidates(monkeypatch, width, prune, warps):
    """Every frame's candidate scores of real twin decodes: the model's
    winners, slot by slot, equal the twin's ``_sort_desc(cat)[:, :W]``
    (ties at LOG_EPS among the dead beams and killed extensions)."""
    _, _, cats = recorded_decode(monkeypatch, width, prune, seed=7 + width)
    for cat in cats:
        for row in cat.numpy():
            np.testing.assert_array_equal(
                select_model(row, width, warps, kernel_regs(width)),
                twin_select(row, width))


@pytest.mark.parametrize("n_ext", [1, 8, 27, 63])
@pytest.mark.parametrize("width", WIDTHS)
def test_select_model_adversarial(width, n_ext):
    """Candidate counts W + W*E (no multiple of 32 for most), with: most
    scores at LOG_EPS; -0.0 against +0.0; all scores equal; random scores
    with repeats; in each CTA shape the kernel has."""
    rng = np.random.RandomState(width * 64 + n_ext)
    n = width + width * n_ext
    eps = np.full(n, LOG_EPS, np.float32)
    eps[rng.choice(n, size=min(n, max(1, width // 2)), replace=False)] = (
        rng.randn(min(n, max(1, width // 2))))
    zeros = np.where(rng.rand(n) < 0.5, np.float32(-0.0), np.float32(0.0))
    zeros[rng.rand(n) < 0.2] = np.float32(LOG_EPS)
    same = np.full(n, -2.5, np.float32)
    rep = rng.choice(np.float32([-1.0, -2.0, 0.0, 1e-30, -1e-30, LOG_EPS]),
                     size=n)
    for scores in (eps, zeros, same, rep):
        want = twin_select(scores, width)
        for warps in (4, 8, 16):
            np.testing.assert_array_equal(
                select_model(scores, width, warps, kernel_regs(width)), want)


def test_select_model_wider_lists():
    """More keys a lane than the width needs (R = 4 at W = 16 and 33,
    R = 2 at W = 5) select the same winners."""
    rng = np.random.RandomState(3)
    for width, n_ext, regs in ((16, 27, 4), (5, 8, 2), (33, 27, 4)):
        scores = rng.choice(np.float32([LOG_EPS, -1.0, 0.0, -0.0]),
                            size=width + width * n_ext)
        np.testing.assert_array_equal(
            select_model(scores, width, 8, regs), twin_select(scores, width))
