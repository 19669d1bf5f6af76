"""WAV file IO without external audio deps.

Copied from ``asr_study_tpu/features/wav.py`` so that the port imports
nothing of the JAX package.  It imports numpy and the standard library
only, so two parts differ from the original: the RIFF/WAVE parser is the
original's pure-Python one (the original tries its C++ reader first, which
decodes the same samples), and the resampler is a numpy form of
``scipy.signal.resample_poly``'s default filter (Kaiser window, beta 5, half
length 10 taps per rate step), summed in float64.

The reference loads audio through ``librosa.load`` [ref:
preprocessing/audio.py], which decodes to mono float32 in [-1, 1] at a
requested sample rate.  Here RIFF/WAVE is parsed directly (PCM 8/16/24/32
and IEEE float32/64) and resampled with a polyphase filter when needed.
"""

from __future__ import annotations

import math
import struct
from typing import Tuple

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _decode_pcm(raw: bytes, bits: int, n_channels: int) -> np.ndarray:
    if bits == 8:  # unsigned
        data = np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
        data = (data - 128.0) / 128.0
    elif bits == 16:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8)
        b = b[: (len(b) // 3) * 3].reshape(-1, 3)
        vals = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        data = vals.astype(np.float32) / float(1 << 23)
    elif bits == 32:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported PCM bit depth: {bits}")
    if n_channels > 1:
        data = data[: (len(data) // n_channels) * n_channels]
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data


def read_wav(path: str, sr: int | None = 16000) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (mono float32 signal in [-1, 1], sample_rate).

    If ``sr`` is given and differs from the file's rate, resample (polyphase,
    like librosa's default resampler family).  Pass ``sr=None`` to keep the
    native rate.
    """
    with open(path, "rb") as f:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", hdr)
            if cid == b"fmt ":
                fmt = f.read(csize)
            elif cid == b"data":
                data = f.read(csize)
            else:
                f.seek(csize + (csize & 1), 1)
                continue
            if csize & 1:
                f.seek(1, 1)
            if fmt is not None and data is not None:
                break
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    (audio_format, n_channels, file_sr, _br, _ba, bits) = struct.unpack(
        "<HHIIHH", fmt[:16]
    )
    if audio_format == _WAVE_FORMAT_EXTENSIBLE and len(fmt) >= 26:
        audio_format = struct.unpack("<H", fmt[24:26])[0]
    if audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        dtype = "<f4" if bits == 32 else "<f8"
        sig = np.frombuffer(data, dtype=dtype).astype(np.float32)
        if n_channels > 1:
            sig = sig[: (len(sig) // n_channels) * n_channels]
            sig = sig.reshape(-1, n_channels).mean(axis=1)
    elif audio_format == _WAVE_FORMAT_PCM:
        sig = _decode_pcm(data, bits, n_channels)
    else:
        raise ValueError(f"{path}: unsupported WAV format tag {audio_format}")
    return _maybe_resample(sig, file_sr, sr)


def _maybe_resample(
    sig: np.ndarray, file_sr: int, sr: int | None
) -> Tuple[np.ndarray, int]:
    if sr is not None and sr != file_sr:
        g = math.gcd(sr, file_sr)
        sig = resample_poly(sig, sr // g, file_sr // g).astype(np.float32)
        file_sr = sr
    return np.ascontiguousarray(sig, dtype=np.float32), file_sr


def resample_poly(x: np.ndarray, up: int, down: int,
                  block: int = 65536) -> np.ndarray:
    """``scipy.signal.resample_poly(x, up, down)`` with its default window
    and zero padding, in numpy: a linear-phase low-pass FIR (cutoff
    1/max(up, down) of Nyquist, Kaiser window, beta 5) applied to ``x``
    upsampled by ``up``, every ``down``-th sample kept, the filter delay
    trimmed.  ``block`` output samples are formed at a time."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    x = np.asarray(x, dtype=np.float64)
    if up == down == 1:
        return x.copy()
    n_in = x.shape[0]
    n_out = n_in * up // down + bool(n_in * up % down)
    max_rate = max(up, down)
    f_c = 1.0 / max_rate
    half_len = 10 * max_rate
    m = np.arange(2 * half_len + 1) - half_len
    h = f_c * np.sinc(f_c * m) * np.kaiser(2 * half_len + 1, 5.0)
    h = h / h.sum() * up
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    n_post_pad = 0
    while ((n_in - 1) * up + h.shape[0] + n_pre_pad + n_post_pad - 1) \
            // down + 1 < n_out + n_pre_remove:
        n_post_pad += 1
    h = np.concatenate([np.zeros(n_pre_pad), h, np.zeros(n_post_pad)])
    # y[k] = sum_m x[m] h[k*down - m*up]: each output reads `taps` inputs
    taps = -(-h.shape[0] // up)
    out = np.empty(n_out)
    for k0 in range(0, n_out, block):
        pos = (np.arange(k0, min(k0 + block, n_out)) + n_pre_remove) * down
        src = pos[:, None] // up - np.arange(taps)[None, :]
        tap = pos[:, None] - src * up
        ok = (src >= 0) & (src < n_in) & (tap < h.shape[0])
        out[k0: k0 + pos.shape[0]] = np.where(
            ok, x[np.clip(src, 0, n_in - 1)] * h[np.minimum(tap,
                                                            h.shape[0] - 1)],
            0.0).sum(axis=1)
    return out


def write_wav(path: str, signal: np.ndarray, sr: int = 16000) -> None:
    """Write mono float32 [-1, 1] as PCM16 WAV (used by tests/dummy corpus)."""
    sig = np.clip(np.asarray(signal, dtype=np.float32), -1.0, 1.0)
    pcm = (sig * 32767.0).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(pcm)) + pcm)
