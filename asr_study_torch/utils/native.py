"""ctypes loader of the port's native host library
(``asr_study_torch/native/asr_native.cc``), the counterpart of
``asr_study_tpu/utils/native.py``.

The library is built with ``g++`` at its first use, never at import, into
``build/native-<hash>/`` at the repository root, where the hash covers the
source and the flags (the same on the CPU and on the machine with the
card).  The compile runs in a private directory and the library is renamed
into place, so processes that build at once never load a half-written
file.  A library that fails to build or to load raises with the compiler's
output: there is no quiet fall back.  The plain twins (``dpack_encode(...,
use_native=False)`` in ``data/wire.py``, ``read_wav_plain`` in
``features/wav.py``, ``_levenshtein_py`` in ``ops/metrics.py``) are reached
only by name.
"""

from __future__ import annotations

import array
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

from asr_study_torch._build import BUILD_ROOT

SOURCE = Path(__file__).resolve().parent.parent / "native" / "asr_native.cc"
LIB_NAME = "libasrnative.so"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_P = ctypes.c_void_p
_L = ctypes.c_long
_I64 = ctypes.c_int64

# C entry points: name -> (argtypes, restype); every pointer is c_void_p
SIGNATURES = {
    # path, out, max_samples, *sample_rate -> samples or a negative code
    "asr_read_wav": ([ctypes.c_char_p, _P, _L, _P], _L),
    # src, offsets, lens, n_rows, t_pad, feat_dim, out
    "asr_pack_batch": ([_P, _P, _P, _I64, _I64, _I64, _P], None),
    # src, offsets, lens, n_rows, out_rows, t_pad, feat_dim, out
    "asr_pack_batch_full": ([_P, _P, _P, _I64, _I64, _I64, _I64, _P], None),
    # samples, n, widths, payload -> payload words
    "asr_dpack_encode_v2": ([_P, _L, _P, _P], _L),
    # a, len(a), b, len(b) -> distance
    "asr_levenshtein": ([_P, _L, _P, _L], _L),
}


def cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found on PATH: the native host library "
                           "of asr_study_torch cannot be built")
    return path


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def build_dir(root: Path = BUILD_ROOT) -> Path:
    return Path(root) / f"native-{source_hash()}"


def build(root: Path = BUILD_ROOT) -> Path:
    """Compile the library into ``build_dir(root)`` (once) -> its path."""
    out_dir = build_dir(root)
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        cmd = [cxx(), *CXX_FLAGS, "-o", str(tmp / LIB_NAME), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (rc {proc.returncode}):\n$ "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp / LIB_NAME, lib_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def load(path: Path) -> ctypes.CDLL:
    """The library at ``path`` with every entry point declared."""
    dll = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(dll, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return dll


@functools.cache
def lib() -> ctypes.CDLL:
    """The library of the current source, built at first use."""
    return load(build())


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# the samples of a thread's scratch buffer for read_wav: a file that fits
# is read with no stat and no fresh pages to fault in, then copied out
_SCRATCH_SAMPLES = 1 << 20
_scratch = threading.local()


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Decode a RIFF/WAVE file (PCM 8/16/24/32 or IEEE float 32/64, the
    extensible tag, channels averaged) -> (float32 [N] in [-1, 1], sample
    rate), raising as ``features/wav.py`` ``read_wav_plain`` does for a
    file it refuses.  Up to ``_SCRATCH_SAMPLES`` samples are decoded into
    the thread's scratch buffer and copied out; a longer file is read again
    into a buffer of the size the reader reports."""
    buf = getattr(_scratch, "buf", None)
    if buf is None:
        buf = _scratch.buf = np.empty(_SCRATCH_SAMPLES, np.float32)
    info = ctypes.c_int(0)
    n = lib().asr_read_wav(os.fsencode(path), _ptr(buf), buf.shape[0],
                           ctypes.addressof(info))
    if n >= 0:
        return buf[:n].copy(), int(info.value)
    if n == -5:
        buf = np.empty(info.value, np.float32)
        n = lib().asr_read_wav(os.fsencode(path), _ptr(buf), buf.shape[0],
                               ctypes.addressof(info))
        if n >= 0:
            return (buf[:n] if 2 * n >= buf.shape[0] else buf[:n].copy(),
                    int(info.value))
    if n == -1:
        open(path, "rb").close()  # the OS's own error
        raise OSError(f"{path}: cannot open")
    raise ValueError(f"{path}: " + {
        -2: "not a RIFF/WAVE file",
        -3: "missing fmt/data chunk",
        -4: f"unsupported WAV format tag {info.value}",
        -6: f"unsupported PCM bit depth: {info.value}",
    }.get(n, f"the native WAV reader failed ({n})"))


def pack_batch_into(src: np.ndarray, offsets: np.ndarray, lens: np.ndarray,
                    out: np.ndarray) -> None:
    """Rows of a flat float32 [sum_T, F] buffer into ``out`` [B, t_pad, F]:
    row i is ``src[offsets[i]: offsets[i] + lens[i]]``, cut at t_pad; each
    row's tail and the rows past ``len(offsets)`` are zeroed, so ``out``
    may come uninitialized (``asr_pack_batch_full``)."""
    if out.dtype != np.float32 or not out.flags.c_contiguous \
            or out.ndim != 3:
        raise ValueError(f"pack_batch_into: out must be a C-contiguous "
                         f"float32 [B, T, F] array, got {out.dtype} "
                         f"{out.shape}")
    if len(offsets) > out.shape[0]:
        raise ValueError(f"pack_batch_into: {len(offsets)} rows for an out "
                         f"of {out.shape[0]}")
    src = np.ascontiguousarray(src, np.float32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    if src.size and src.shape[-1] != out.shape[2]:
        raise ValueError(f"pack_batch_into: rows of {src.shape[-1]} "
                         f"features for an out of {out.shape[2]}")
    lib().asr_pack_batch_full(_ptr(src), _ptr(offsets), _ptr(lens),
                              len(offsets), out.shape[0], out.shape[1],
                              out.shape[2], _ptr(out))


def dpack_encode(samples: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """dpack-encode a concatenated int16 sample stream (``data/wire.py``'s
    per-4096-block delta and bit planes) -> (widths uint8 [nb], payload
    int16)."""
    s = np.ascontiguousarray(samples, np.int16)
    nb = -(-s.shape[0] // 4096)
    widths = np.zeros(max(nb, 1), np.uint8)
    # a partial final block still takes 256 * w words: nb * 4096 at most
    payload = np.empty(max(nb * 4096, 1), np.uint16)
    words = lib().asr_dpack_encode_v2(_ptr(s), s.shape[0], _ptr(widths),
                                      _ptr(payload))
    return widths[:nb], payload[:words].view(np.int16)


def levenshtein(a: Sequence[int], b: Sequence[int]) -> int:
    """Edit distance between two int32 id sequences (``array`` buffers:
    for a transcript's few tokens, half the cost of NumPy arrays)."""
    a, b = array.array("i", a), array.array("i", b)
    return int(lib().asr_levenshtein(a.buffer_info()[0], len(a),
                                     b.buffer_info()[0], len(b)))
