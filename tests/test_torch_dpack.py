"""The port's dpack decode (asr_study_torch/ops/dpack.py and
data/wire.dpack_unpack) against the JAX package: the plain decode's whole
[scap] stream against the Pallas kernel in interpret mode, and the unpacked
batch against the XLA and the Pallas forms of ``dpack_unpack``, exactly.
Small batches (at most 9 blocks) keep the interpreter fast."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_study_torch.data import wire
from asr_study_torch.ops import dpack
from asr_study_torch.ops.dpack import dpack_decode, dpack_decode_plain
from asr_study_tpu.data import wire as jwire
from asr_study_tpu.ops import pallas_dpack


def _edge_batch():
    """Width extremes in one batch: speech-like noise, an all-zero block
    (w=0), ones (w=1-2) and a full-scale alternation (w=16)."""
    rng = np.random.RandomState(9)
    wavs = [(rng.randn(n) * 0.3).astype(np.float32)
            for n in (3100, 7000, 4095)]
    return wavs + [np.zeros(4096, np.int16), np.ones(4097, np.int16),
                   np.tile(np.array([32767, -32768], np.int16), 2100)]


def _single(n):
    rng = np.random.RandomState(n % 1000)
    return [(rng.randn(n) * 0.2).astype(np.float32)]


# block counts 1, 3 and 9, and the edge batch's 7
BATCHES = {"edge": _edge_batch, "1 block": lambda: _single(100),
           "3 blocks": lambda: _single(3 * 4096 - 7),
           "9 blocks": lambda: _single(9 * 4096 - 5)}


def _wire(wavs):
    b = len(wavs)
    cap, scap = wire.dpack_measure([wavs], b)
    flat = wire.pack_audio(wavs, cap, batch=b, codec="dpack", scap=scap)
    n_pad = -(-max(len(w) for w in wavs) // 2048) * 2048
    return flat, b, n_pad, scap


def _regions(flat, b, scap):
    return [t.numpy() for t in wire.dpack_regions(torch.from_numpy(flat), b,
                                                  scap)]


@pytest.mark.parametrize("name", list(BATCHES))
def test_plain_stream_equals_pallas_kernel(name):
    flat, b, _, scap = _wire(BATCHES[name]())
    payload, row_start, widths = _regions(flat, b, scap)
    want = pallas_dpack.dpack_decode(
        jnp.asarray(payload), jnp.asarray(row_start), jnp.asarray(widths),
        scap, interpret=True)
    got = dpack_decode_plain(torch.from_numpy(payload),
                             torch.from_numpy(row_start),
                             torch.from_numpy(widths), scap)
    assert got.dtype == torch.float32 and got.shape == (scap,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", list(BATCHES))
def test_unpack_equals_jax_xla_and_pallas(name):
    wavs = BATCHES[name]()
    flat, b, n_pad, scap = _wire(wavs)
    got, lens = wire.unpack_audio(torch.from_numpy(flat), b, n_pad,
                                  codec="dpack", scap=scap)
    for backend in ("xla", "pallas"):
        want, want_lens = jwire.dpack_unpack(jnp.asarray(flat), b, n_pad,
                                             scap, backend)
        np.testing.assert_array_equal(lens.numpy(), np.asarray(want_lens))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pcm = wire.pack_audio(wavs, wire.wire_cap(b, sum(map(len, wavs))))
    want, _ = wire.unpack_audio(torch.from_numpy(pcm), b, n_pad)
    assert torch.equal(got, want)


def test_unpack_partial_batch_and_window_of_a_chunk():
    """A header padded to 5 rows, and the wire as a [cap] window of a
    larger buffer (as the CLI slices its one host->device chunk)."""
    wavs = _edge_batch()[:3]
    cap, scap = wire.dpack_measure([wavs], 5)
    flat = wire.pack_audio(wavs, cap, batch=5, codec="dpack", scap=scap)
    chunk = torch.from_numpy(np.concatenate([np.zeros(cap, np.int16), flat,
                                             np.ones(cap, np.int16)]))
    got, lens = wire.unpack_audio(chunk[cap: 2 * cap], 5, 8192,
                                  codec="dpack", scap=scap)
    want, want_lens = jwire.dpack_unpack(jnp.asarray(flat), 5, 8192, scap,
                                         "xla")
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[3:].any()


def test_unpack_with_a_larger_shared_scap():
    """A group packed at the scap of a larger one (as the CLI shares one
    scap over its batches): the blocks past its own are width 0."""
    wavs = _edge_batch()[:2]
    _, scap = wire.dpack_measure([_single(9 * 4096 - 5)], 2)
    cap, own = wire.dpack_measure([wavs], 2)
    assert own < scap
    flat = wire.pack_audio(wavs, cap + scap // 4096, codec="dpack",
                           scap=scap)
    got, _ = wire.unpack_audio(torch.from_numpy(flat), 2, 8192,
                               codec="dpack", scap=scap)
    for backend in ("xla", "pallas"):
        want, _ = jwire.dpack_unpack(jnp.asarray(flat), 2, 8192, scap,
                                     backend)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stream_past_the_end_holds_the_last_sample():
    """The padding deltas are 0, so the decoded stream keeps the last
    sample's value up to scap (a decode writing zeros there is wrong)."""
    wavs = [np.full(5000, -1234, np.int16)]
    flat, b, _, scap = _wire(wavs)
    got = dpack_decode(*map(torch.from_numpy, _regions(flat, b, scap)),
                       scap)
    assert scap == 8192
    assert torch.equal(got, torch.full((scap,), -1234 / 32768.0))


def test_reads_past_the_payload_are_zero():
    """A payload cut short decodes as if zero-padded (the Pallas kernel's
    padding of the payload)."""
    flat, b, _, scap = _wire(_single(3 * 4096 - 7))
    payload, row_start, widths = _regions(flat, b, scap)
    cut = payload[: int(widths.sum()) * 256 - 700]
    padded = np.concatenate([cut, np.zeros(700, np.int16)])
    got = dpack_decode_plain(torch.from_numpy(cut),
                             torch.from_numpy(row_start),
                             torch.from_numpy(widths), scap)
    want = pallas_dpack.dpack_decode(jnp.asarray(padded),
                                     jnp.asarray(row_start),
                                     jnp.asarray(widths), scap,
                                     interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_wrapper_takes_the_plain_version():
    """On the CPU: the plain version, no launch counted, and no scratch for
    the one-launch kernel's CTA totals."""
    flat, b, _, scap = _wire(_edge_batch())
    args = [torch.from_numpy(a) for a in _regions(flat, b, scap)]
    before = dpack_decode.launches
    assert torch.equal(dpack_decode(*args, scap),
                       dpack_decode_plain(*args, scap))
    assert dpack_decode.launches == before
    assert not dpack._SCRATCH


def _transpose16(words):
    """csrc/dpack_onepass.cu's 16x16 bit-matrix transpose, 4 rounds of
    masked swaps, on [16, ...] uint32 plane words -> d[i] bit p = words[p]
    bit i."""
    d = [w.copy() for w in words]
    for s, mask in ((8, 0x00FF), (4, 0x0F0F), (2, 0x3333), (1, 0x5555)):
        for p in range(16):
            if p & s:
                continue
            t = ((d[p] >> s) ^ d[p + s]) & mask
            d[p + s] ^= t
            d[p] ^= t << s
    return np.stack(d)


def _onepass_model(payload, row_start, widths, scap, grid):
    """The one-launch decode as the kernel runs it: CTA c owns blocks
    [c nb / G, (c+1) nb / G); each CTA's delta total; its carry the totals
    before it; each block scanned from the running carry; uint32 wrap."""
    nb = scap // 4096
    words = payload.astype(np.int64) & 0xFFFF
    m = np.arange(256)

    def deltas(j):
        at = (row_start[j] + np.arange(16)[:, None]) * 256 + m[None, :]
        live = ((np.arange(16)[:, None] < min(max(widths[j], 0), 16))
                & (at >= 0) & (at < words.shape[0]))
        planes = np.where(live, words[np.clip(at, 0, len(words) - 1)],
                          0).astype(np.uint32)
        u = _transpose16(planes)              # [16 samples i, 256 words m]
        return ((u >> 1) ^ (0 - (u & 1))).astype(np.uint32).reshape(-1)

    bounds = [nb * c // grid for c in range(grid + 1)]
    totals = [np.uint32(sum(int(deltas(j).sum(dtype=np.uint64))
                            for j in range(bounds[c], bounds[c + 1]))
                        & 0xFFFFFFFF) for c in range(grid)]
    out = np.empty(scap, np.float32)
    for c in range(grid):
        carry = sum(int(t) for t in totals[:c]) & 0xFFFFFFFF
        for j in range(bounds[c], bounds[c + 1]):
            v = (carry + np.cumsum(deltas(j), dtype=np.uint64)) & 0xFFFFFFFF
            carry = int(v[-1])
            s16 = ((v + 32768) & 0xFFFF).astype(np.int64) - 32768
            out[j * 4096: (j + 1) * 4096] = s16 / 32768.0
    return out


@pytest.mark.parametrize("grid", [1, 4, 9])
def test_onepass_model_equals_pallas_kernel(grid):
    """A NumPy model of the one-launch kernel's block split, bit-matrix
    transpose and carries, on 1, 4 and 9 CTAs (one block each at 9), against
    the Pallas kernel in interpret mode, exactly."""
    flat, b, _, scap = _wire(BATCHES["9 blocks"]())
    payload, row_start, widths = _regions(flat, b, scap)
    want = pallas_dpack.dpack_decode(
        jnp.asarray(payload), jnp.asarray(row_start), jnp.asarray(widths),
        scap, interpret=True)
    got = _onepass_model(payload, row_start, widths, scap, grid)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_decode_arguments_checked():
    payload = torch.zeros(512, dtype=torch.int16)
    rs = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 4096"):
        dpack_decode(payload, rs, rs, 4000)
    with pytest.raises(ValueError, match="payload"):
        dpack_decode(payload.to(torch.int32), rs, rs, 4096)
    with pytest.raises(ValueError, match="widths"):
        dpack_decode(payload, rs, rs.to(torch.int64), 4096)
    with pytest.raises(ValueError, match="row_start"):
        dpack_decode(payload, torch.zeros(2, dtype=torch.int32), rs, 4096)
    with pytest.raises(ValueError, match="no kernel"):
        dpack_decode(payload.to("meta"), rs.to("meta"), rs.to("meta"), 4096)
    with pytest.raises(ValueError, match="shorter"):
        wire.unpack_audio(torch.zeros(8, dtype=torch.int16), 4, 64,
                          codec="dpack", scap=4 * 4096)
