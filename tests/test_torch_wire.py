"""Port's pcm16 wire (asr_study_torch/data/wire.py) against the JAX
module: the host packer byte for byte, the device unpacker value for
value."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_study_torch.data import wire
from asr_study_tpu.data import wire as jwire


def _wavs(seed, lengths, as_int16=False):
    rng = np.random.RandomState(seed)
    out = []
    for n in lengths:
        w = np.clip(0.4 * rng.randn(n), -1.2, 1.2).astype(np.float32)
        out.append(jwire.quantize_pcm16(w) if as_int16 else w)
    return out


@pytest.mark.parametrize("lengths,batch,as_int16", [
    ((5000, 3100, 4321), None, False),
    ((5000, 3100, 4321), 5, False),        # header padded to 5 rows
    ((7, 1, 40000), None, True),
    ((33000,), 2, True),                   # length above 2^15: both halves
    ((0, 17), None, False),
])
def test_pack_audio_byte_equal(lengths, batch, as_int16):
    wavs = _wavs(0, lengths, as_int16)
    b = batch or len(wavs)
    cap = jwire.wire_cap(b, sum(lengths), align=256)
    assert wire.wire_cap(b, sum(lengths), align=256) == cap
    want = jwire.pack_audio(wavs, cap, batch=batch)
    got = wire.pack_audio(wavs, cap, batch=batch)
    assert got.dtype == want.dtype == np.int16
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("lengths,n_pad", [
    ((5000, 3100, 4321), 6144),
    ((5000, 3100, 4321), 4096),            # rows longer than n_pad clip
    ((33000, 12), 34816),
])
def test_unpack_audio_matches_jax(lengths, n_pad):
    wavs = _wavs(1, lengths)
    b = len(wavs)
    cap = jwire.wire_cap(b, sum(lengths), align=256)
    flat = jwire.pack_audio(wavs, cap)
    w_j, l_j = jwire.unpack_audio(jnp.asarray(flat), b, n_pad)
    w_p, l_p = wire.unpack_audio(torch.from_numpy(flat), b, n_pad)
    assert w_p.dtype == torch.float32 and w_p.shape == (b, n_pad)
    np.testing.assert_array_equal(l_p.numpy(), np.asarray(l_j))
    np.testing.assert_array_equal(w_p.numpy(), np.asarray(w_j))


@pytest.mark.parametrize("codec", ["mulaw", "dpack"])
def test_unported_codecs_raise(codec):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        wire.pack_audio([np.zeros(4, np.float32)], 256, codec=codec)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        wire.unpack_audio(torch.zeros(256, dtype=torch.int16), 1, 16,
                          codec=codec)


def test_pack_overflow_raises():
    with pytest.raises(ValueError, match="overflow"):
        wire.pack_audio([np.zeros(300, np.float32)], 256)
