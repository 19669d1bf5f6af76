"""The port's prefix beam search (``ops/beam.py``, its plain twin on the CPU)
and ``blank_collapse`` against the JAX package: the JAX decoder in its
gather form (``ASR_BEAM_SELECT=gather``), a dict-based reference beam (after
the JAX tests' ``_py_prefix_beam``), adversarial hash collisions, and
``-inf``-masked logits.  Prefixes and lengths must be equal; scores agree
to rtol 1e-5, atol 1e-4 (the two frameworks' exp and log1p may differ in
the last bit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_study_torch.ops import beam
from asr_study_torch.ops import beam_search_decode, blank_collapse
from asr_study_torch.ops.ctc import greedy_decode
from asr_study_torch.text.lm import fit_ngram_lm
from asr_study_tpu.ops import beam_search_decode as jax_beam_search_decode
from asr_study_tpu.ops import blank_collapse as jax_blank_collapse
from asr_study_tpu.text.lm import fit_ngram_lm as jax_fit_ngram_lm

SCORE_TOL = dict(rtol=1e-5, atol=1e-4)


def _logits(seed, batch, t_max, vocab, blank_bias=0.0):
    """Seeded emissions: normal logits, the blank column pushed up on a
    random 60% of frames by ``blank_bias`` (speech-like runs of blanks)."""
    rng = np.random.RandomState(seed)
    x = (2.0 * rng.randn(batch, t_max, vocab)).astype(np.float32)
    if blank_bias:
        x[:, :, -1] += np.where(rng.rand(batch, t_max) < 0.6, blank_bias,
                                -blank_bias).astype(np.float32)
    return x


def _lm_pair(seed, order, n_char):
    """The same LM from both packages' fit_ngram_lm."""
    rng = np.random.RandomState(seed)
    seqs = [rng.randint(0, n_char, size=rng.randint(1, 15))
            for _ in range(40)]
    return (fit_ngram_lm(seqs, order, n_char, n_char - 1),
            jax_fit_ngram_lm(seqs, order, n_char, n_char - 1))


def _assert_same(got, want, top_paths):
    dec, lens, scores = (t.numpy() for t in got)
    wdec, wlens, wscores = (np.asarray(a) for a in want)
    assert dec.shape == wdec.shape and dec.shape[1] == top_paths
    np.testing.assert_array_equal(lens, wlens)
    np.testing.assert_array_equal(dec, wdec)
    np.testing.assert_allclose(scores, wscores, **SCORE_TOL)


# (T, V, W, prune, top_paths, LM order (0: none), lengths): every width of
# 1, 4, 8, 16, prune 0 and 3, top_paths up to W, no LM and orders 1-3, and
# lengths 0, 1 and T among the rows; then W = 129 and 160 at V = 65, 70 and
# 28, pruned and not, with LMs of order 2 and 3 (the wide design's sizes);
# 12 decode shapes for the JAX side
CASES = [
    (20, 6, 1, 0, 1, 0, (20, 0, 1)),
    (33, 6, 4, 0, 4, 1, (33, 1, 0)),
    (40, 6, 8, 3, 5, 2, (40, 17, 1)),
    (24, 6, 16, 0, 16, 0, (24, 0, 9)),
    (40, 28, 16, 0, 3, 3, (40, 1, 0)),
    (30, 28, 8, 3, 8, 0, (0, 30, 1)),
    (36, 28, 4, 3, 2, 3, (36, 12, 1)),
    # the wide design's route on the card (W > 128 or V > 64)
    (14, 65, 129, 0, 3, 0, (14, 0, 5)),
    (12, 70, 160, 6, 160, 3, (12, 1, 7)),
    (10, 28, 160, 0, 4, 2, (10, 10, 0)),
    (12, 70, 129, 0, 129, 0, (12, 3, 12)),
]


@pytest.mark.parametrize("t_max,vocab,width,prune,paths,order,lengths",
                         CASES)
def test_decode_matches_jax_gather(monkeypatch, t_max, vocab, width, prune,
                                   paths, order, lengths):
    monkeypatch.setenv("ASR_BEAM_SELECT", "gather")
    logits = _logits(width + vocab + t_max, 3, t_max, vocab, blank_bias=3.0)
    lens = np.array(lengths, np.int32)
    kw = dict(beam_width=width, top_paths=paths, prune=prune)
    lm = jlm = None
    if order:
        lm, jlm = _lm_pair(order, order, vocab - 1)
        kw.update(lm_alpha=0.7, lm_beta=0.3)
    got = beam_search_decode(torch.from_numpy(logits),
                             torch.from_numpy(lens), lm=lm, **kw)
    want = jax_beam_search_decode(jnp.asarray(logits), jnp.asarray(lens),
                                  lm=jlm, **kw)
    _assert_same(got, want, paths)
    # a zero-length row decodes to the empty prefix with score 0
    for i in np.flatnonzero(lens == 0):
        assert int(got[1][i, 0]) == 0 and float(got[2][i, 0]) == 0.0
        assert (got[0][i] == -1).all()


def test_inf_masked_logits_decode_finite_and_agree(monkeypatch):
    """-inf class masking: the gather form never reads the masked entries
    into a product, so scores stay finite and the class is never
    emitted; the same prefixes as JAX's gather form."""
    monkeypatch.setenv("ASR_BEAM_SELECT", "gather")
    logits = _logits(7, 2, 12, 6)
    logits[:, :, 2] = -np.inf
    lens = np.array([12, 9], np.int32)
    got = beam_search_decode(torch.from_numpy(logits),
                             torch.from_numpy(lens), beam_width=4,
                             top_paths=2)
    assert torch.isfinite(got[2]).all()
    assert not (got[0] == 2).any()
    want = jax_beam_search_decode(jnp.asarray(logits), jnp.asarray(lens),
                                  beam_width=4, top_paths=2)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def _py_prefix_beam(log_probs, length, beam_width, blank):
    """Dict-based reference prefix beam search (Hannun-style), after the
    JAX package's tests/test_ctc.py."""
    beams = {(): (0.0, -np.inf)}  # prefix -> (log p_blank, log p_nonblank)
    for t in range(length):
        lp = log_probs[t]
        new = {}

        def add(prefix, pb, pnb):
            opb, opnb = new.get(prefix, (-np.inf, -np.inf))
            new[prefix] = (np.logaddexp(opb, pb), np.logaddexp(opnb, pnb))

        for prefix, (pb, pnb) in beams.items():
            ptot = np.logaddexp(pb, pnb)
            add(prefix, ptot + lp[blank], -np.inf)          # stay via blank
            if prefix:
                add(prefix, -np.inf, pnb + lp[prefix[-1]])  # repeat last
            for c in range(len(lp)):
                if c == blank:
                    continue
                if prefix and c == prefix[-1]:
                    add(prefix + (c,), -np.inf, pb + lp[c])
                else:
                    add(prefix + (c,), -np.inf, ptot + lp[c])
        beams = dict(sorted(new.items(),
                            key=lambda kv: -np.logaddexp(*kv[1]))[:beam_width])
    ranked = sorted(beams.items(), key=lambda kv: -np.logaddexp(*kv[1]))
    return [(list(p), float(np.logaddexp(*v))) for p, v in ranked]


def _against_dict_reference(seed, t_max=7, vocab=4, width=8, paths=3):
    logits = _logits(seed, 1, t_max, vocab)
    lp = torch.log_softmax(torch.from_numpy(logits), -1).numpy()[0]
    want = _py_prefix_beam(lp.astype(np.float64), t_max, width,
                           blank=vocab - 1)
    dec, lens, scores = beam_search_decode(
        torch.from_numpy(logits), torch.tensor([t_max]), beam_width=width,
        top_paths=paths)
    for p in range(paths):
        assert dec[0, p, : int(lens[0, p])].tolist() == want[p][0]
        np.testing.assert_allclose(float(scores[0, p]), want[p][1],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_dict_reference(seed):
    _against_dict_reference(seed)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_collision_does_not_merge(monkeypatch, seed):
    """Lane 1 degraded to a multiplier of 0 (its hash is then the last
    char + 1, so every two prefixes with the same last char collide in
    it): lane 2 alone must keep distinct prefixes apart, and the decode
    still equals the dict reference."""
    monkeypatch.setattr(beam, "_HASH_MULT", 0)
    _against_dict_reference(seed)


@pytest.mark.parametrize("seed,threshold,keep_ratio", [
    (0, 0.99, 0.6), (1, 0.5, 0.6), (2, 0.5, 0.25)])
def test_blank_collapse_matches_jax(seed, threshold, keep_ratio):
    """Packed logits, new lengths and dropped frames exactly as JAX's; the
    last case overflows its budget on some rows."""
    logits = _logits(seed, 4, 37, 6, blank_bias=6.0)
    lens = np.array([37, 20, 1, 0], np.int32)
    got = blank_collapse(torch.from_numpy(logits), torch.from_numpy(lens),
                         threshold=threshold, keep_ratio=keep_ratio)
    want = jax_blank_collapse(jnp.asarray(logits), jnp.asarray(lens),
                              threshold=threshold, keep_ratio=keep_ratio)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == got[2].dtype == torch.int32
    if keep_ratio < 0.5:
        assert int(got[2].sum()) > 0


def test_decode_helper_and_guards():
    logits = torch.from_numpy(_logits(5, 2, 15, 6))
    lens = torch.tensor([15, 8])
    for got, want in zip(beam.decode(logits, lens, 5), greedy_decode(
            logits, lens, blank_id=5)):
        assert torch.equal(got, want)
    dec, dlens = beam.decode(logits, lens, 5, beam.BeamConfig(4, prune=2))
    full = beam_search_decode(logits, lens, beam_width=4, prune=2)
    assert torch.equal(dec, full[0][:, 0]) and torch.equal(dlens, full[1][:, 0])
    with pytest.raises(ValueError, match="blank as the last id"):
        beam_search_decode(logits, lens, blank_id=0)
    lm, _ = _lm_pair(0, 2, 4)
    with pytest.raises(ValueError, match="LM alphabet"):
        beam_search_decode(logits, lens, beam_width=2, lm=lm)
    # the kernel wrappers take CUDA tensors only, on either design
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        beam.ctc_beam(torch.log_softmax(logits, -1), lens, 4)
    wide = torch.log_softmax(torch.randn(2, 5, 70), -1)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        beam.ctc_beam(wide, lens, 160)
    state = beam.BeamState(*(t[None].repeat(2, 1)
                             for t in beam.beam_stream_init(160)))
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        beam.ctc_beam_stream(wide, lens, state, 160)
    # the route rule: past the select design's W <= 128 and V <= 64, the
    # wide design; below 1 beam or 2 classes, nothing
    assert beam.beam_design(beam.SELECT_MAX_WIDTH + 1, 28) == "wide"
    assert beam.beam_design(16, beam.SELECT_MAX_VOCAB + 1) == "wide"
    assert beam.beam_design(beam.SELECT_MAX_WIDTH,
                            beam.SELECT_MAX_VOCAB) == "select"
    with pytest.raises(ValueError, match="beam_width 0"):
        beam.beam_design(0, 28)
    with pytest.raises(ValueError, match="1 classes"):
        beam.beam_design(4, 1)


@pytest.mark.parametrize("width,vocab,design", [
    (1, 2, "select"), (128, 64, "select"), (128, 2, "select"),
    (1, 64, "select"), (129, 64, "wide"), (128, 65, "wide"),
    (129, 65, "wide"), (1, 65, "wide"), (129, 2, "wide"),
    (1024, 256, "wide"), (16, 28, "select")])
def test_beam_design_edges(width, vocab, design):
    assert beam.beam_design(width, vocab) == design


def test_wide_scratch_bytes():
    """The wide design's scratch an utterance (csrc/ctc_beam_wide.cu
    ``carve``): W=1024, V=256, E=255 by hand; a multiple of 8, growing with
    each of W, V and E."""
    w, v, e = 1024, 256, 255
    want = 8 * (w + w * e + 1024) + 4 * (20 * w + w + w * e + 4 * e
                                         + 2 * (v - 1))
    assert beam.wide_scratch_bytes(w, v, e) == want == 3_241_960
    for args in ((129, 65, 64), (129, 65, 3), (1, 2, 1), (160, 70, 6)):
        n = beam.wide_scratch_bytes(*args)
        assert n % 8 == 0 and n > 0
        for k in range(3):
            bigger = list(args)
            bigger[k] += 1
            if bigger[2] < bigger[1]:
                assert beam.wide_scratch_bytes(*bigger) > n


def test_wide_design_refuses_a_frame_past_its_candidate_index():
    """The wide design's one field limit, W * (E + 1) < 2^31, is raised
    as ValueError with its numbers before anything is allocated."""
    with pytest.raises(ValueError, match="65536 beams by E=32768 .* "
                       "2147549184 candidates"):
        beam._wide_buffers(1, 1, 65536, 32769, 32768, torch.device("cpu"))


@pytest.mark.parametrize("width,vocab,prune,order", [
    (160, 70, 5, 2), (129, 65, 0, 0)], ids=["w160-v70-p5-lm2", "w129-v65"])
def test_wide_stream_matches_jax_gather(monkeypatch, width, vocab, prune,
                                        order):
    """beam_stream_chunk on the wide design's sizes, chunk by chunk against
    the JAX one (its gather form), the last chunk ragged: prefixes, emits
    and start slots exactly, scores and the state's scores at rtol 1e-5,
    its integers exactly."""
    import jax

    from asr_study_tpu.ops import beam as jbeam

    monkeypatch.setenv("ASR_BEAM_SELECT", "gather")
    lp = np.asarray(torch.log_softmax(torch.from_numpy(
        _logits(width + vocab, 1, 17, vocab, blank_bias=3.0)[0]), -1))
    n_char, chunk = vocab - 1, 7
    kw = dict(prune=prune)
    jkw = dict(kw)
    if order:
        lm, jlm = _lm_pair(order, order, n_char)
        kw.update(lm=lm, lm_alpha=0.7, lm_beta=0.2)
        jkw.update(lm=jlm, lm_alpha=0.7, lm_beta=0.2)
    lm0 = kw["lm"].init_state() if order else 0
    state = beam.beam_stream_init(width, lm0)
    jstate = jbeam.beam_stream_init(width, lm0)
    j_chunk = jax.jit(lambda x, v, st: jbeam.beam_stream_chunk(
        x, v, st, width, n_char, **jkw))
    for lo in range(0, len(lp), chunk):
        part = lp[lo: lo + chunk]
        padded = np.zeros((chunk, vocab), np.float32)
        padded[: len(part)] = part
        valid = np.arange(chunk) < len(part)
        state, pref, emits, start, scores = beam.beam_stream_chunk(
            torch.from_numpy(padded), torch.from_numpy(valid), state, width,
            n_char, **kw)
        jstate, jpref, jemits, jstart, jscores = j_chunk(
            jnp.asarray(padded), jnp.asarray(valid), jstate)
        np.testing.assert_array_equal(pref.numpy(), np.asarray(jpref))
        np.testing.assert_array_equal(emits.numpy(), np.asarray(jemits))
        np.testing.assert_array_equal(start.numpy(), np.asarray(jstart))
        np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                                   **SCORE_TOL)
        for name, got, want in zip(beam.BeamState._fields, state, jstate):
            want = np.asarray(want)
            if name.startswith("p_"):
                np.testing.assert_allclose(got.numpy(), want, **SCORE_TOL)
            else:
                np.testing.assert_array_equal(got.numpy(),
                                              want.view(np.int32))
