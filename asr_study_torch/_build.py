"""Build the CUDA kernels of ``csrc/`` into one shared library and load it.

The sources expose a plain C interface, so they are compiled by ``nvcc``
alone (no PyTorch headers: a few seconds instead of minutes) and loaded
with ``ctypes``.  The library lands in ``build/kernels-<hash>/`` at the
repository root, where the hash covers the sources and the flags; a
changed source therefore builds anew at its first use, and an unchanged
one loads the library already built.

Nothing here runs at import: the first call to :func:`lib` builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build"
LIB_NAME = "libasr_kernels.so"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# one object per source, compiled in parallel, then one link
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-c",
)
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_U = ctypes.c_uint

# C entry points: name -> argtypes.  Every pointer and the stream are
# c_void_p (a bare Python int would be passed as a 32-bit int).
SIGNATURES = {
    # pre, n_sig, win, cos, sin, mel, dct, lift, out,
    # batch, n_frames, frame_len, hop, n_bins, n_mel, n_cep, n_out,
    # inv_nfft, floor, mode, append_energy, stream
    "asr_fbank": [_P, _I, _P, _P, _P, _P, _P, _P, _P,
                  _I, _I, _I, _I, _I, _I, _I, _I,
                  _F, _F, _I, _I, _P],
    # the FFT design: pre, n_sig, win, twiddle, mel_packed, n_packed,
    # bands, dct, lift, out, batch, n_frames, frame_len, hop, nfft, n_mel,
    # n_cep, n_out, floor, mode, append_energy, stream
    "asr_fbank_fft": [_P, _I, _P, _P, _P, _I, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _I,
                      _F, _I, _I, _P],
    # xp_f, xp_b, mask, wh_f, wh_b, h_f, c_f, h_b, c_b, h_init, c_init (the
    # carried state [ndir, B, H], or null), T, B, H, ndir, cluster CTAs,
    # units per CTA, rows per cluster, stream
    "asr_bilstm_fwd": [_P] * 11 + [_I] * 7 + [_P],
    # B, H, ndir, cluster CTAs, units, rows, *smem bytes, *max clusters
    "asr_bilstm_fwd_info": [_I] * 6 + [_P, _P],
    # xp_f, xp_b, mask, wh_f, wh_b, h_f, c_f, h_b, c_b, dh_f, dh_b, dxp_f,
    # dxp_b, T, B, H, ndir, cluster CTAs, units, rows, stream
    "asr_bilstm_bwd": [_P] * 13 + [_I] * 7 + [_P],
    "asr_bilstm_bwd_info": [_I] * 6 + [_P, _P],
    # the bfloat16-weight forms: the same arguments, wh_f and wh_b bfloat16
    "asr_bilstm_fwd_bf16": [_P] * 11 + [_I] * 7 + [_P],
    "asr_bilstm_bwd_bf16": [_P] * 13 + [_I] * 7 + [_P],
    # the wide forms (256 < H <= 512): xp_f, xp_b, mask, wh_f, wh_b, h_f,
    # c_f, h_b, c_b, g_f, g_b (the saved gates, or null), h_init, c_init,
    # T, B, H, ndir, cluster CTAs, units per CTA, rows per cluster, stream
    "asr_lstm_wide_fwd": [_P] * 13 + [_I] * 7 + [_P],
    # B, H, ndir, cluster CTAs, units, rows, *smem bytes, *max clusters
    "asr_lstm_wide_fwd_info": [_I] * 6 + [_P, _P],
    # g_f, g_b, mask, wh_f, wh_b, c_f, c_b, dh_f, dh_b, dxp_f, dxp_b, T, B,
    # H, ndir, cluster CTAs, units, rows, stream
    "asr_lstm_wide_bwd": [_P] * 11 + [_I] * 7 + [_P],
    "asr_lstm_wide_bwd_info": [_I] * 6 + [_P, _P],
    # the bfloat16-weight forms: the same arguments, wh_f and wh_b bfloat16
    "asr_lstm_wide_fwd_bf16": [_P] * 13 + [_I] * 7 + [_P],
    "asr_lstm_wide_bwd_bf16": [_P] * 11 + [_I] * 7 + [_P],
    # the streamed-weight forms (H=512): xp_f, xp_b, mask, wh_f, wh_b, h_f,
    # c_f, h_b, c_b, h_init, c_init, T, B, H, ndir, stream
    "asr_lstm_stream_fwd": [_P] * 11 + [_I] * 4 + [_P],
    # xp_f, xp_b, mask, wh_f, wh_b, wht_f, wht_b, h_f, c_f, h_b, c_b,
    # dh_f, dh_b, dxp_f, dxp_b, T, B, H, ndir, stream
    "asr_lstm_stream_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # the bfloat16-weight forms: the same arguments, wh_f, wh_b (and wht_f,
    # wht_b) bfloat16
    "asr_lstm_stream_fwd_bf16": [_P] * 11 + [_I] * 4 + [_P],
    "asr_lstm_stream_bwd_bf16": [_P] * 15 + [_I] * 4 + [_P],
    # xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b, h_init (the carried h [ndir,
    # B, H], or null), T, B, H, ndir, cluster CTAs, units per CTA, rows per
    # cluster, stream
    "asr_gru_fwd": [_P] * 8 + [_I] * 7 + [_P],
    # B, H, ndir, cluster CTAs, units, rows, *smem bytes, *max clusters
    "asr_gru_fwd_info": [_I] * 6 + [_P, _P],
    # xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b, dh_f, dh_b, dxp_f, dhp_f,
    # dxp_b, dhp_b, T, B, H, ndir, cluster CTAs, units, rows, stream
    "asr_gru_bwd": [_P] * 13 + [_I] * 7 + [_P],
    "asr_gru_bwd_info": [_I] * 6 + [_P, _P],
    # the bfloat16-weight forms: the same arguments, wh_f and wh_b bfloat16
    "asr_gru_fwd_bf16": [_P] * 8 + [_I] * 7 + [_P],
    "asr_gru_bwd_bf16": [_P] * 13 + [_I] * 7 + [_P],
    # the wide forms (256 < H <= 512): xp_f, xp_b, mask, wh_f, wh_b, h_f,
    # h_b, hg_f, hg_b (the saved h side of the pre-activations, or null),
    # h_init, T, B, H, ndir, cluster CTAs, units per CTA, rows per cluster,
    # stream
    "asr_gru_wide_fwd": [_P] * 10 + [_I] * 7 + [_P],
    # B, H, ndir, cluster CTAs, units, rows, *smem bytes, *max clusters
    "asr_gru_wide_fwd_info": [_I] * 6 + [_P, _P],
    # xp_f, xp_b, hg_f, hg_b, mask, wh_f, wh_b, h_f, h_b, dh_f, dh_b, dxp_f,
    # dhp_f, dxp_b, dhp_b, T, B, H, ndir, cluster CTAs, units, rows, stream
    "asr_gru_wide_bwd": [_P] * 15 + [_I] * 7 + [_P],
    "asr_gru_wide_bwd_info": [_I] * 6 + [_P, _P],
    # the bfloat16-weight forms: the same arguments, wh_f and wh_b bfloat16
    "asr_gru_wide_fwd_bf16": [_P] * 10 + [_I] * 7 + [_P],
    "asr_gru_wide_bwd_bf16": [_P] * 15 + [_I] * 7 + [_P],
    # the streamed-weight forms (H > 512, or batches beyond the wide
    # design): xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b, h_init, T, B, H,
    # ndir, stream
    "asr_gru_stream_fwd": [_P] * 8 + [_I] * 4 + [_P],
    # xp_f, xp_b, mask, wh_f, wh_b, wht_f, wht_b, h_f, h_b, dh_f, dh_b,
    # dxp_f, dhp_f, dxp_b, dhp_b, T, B, H, ndir, stream
    "asr_gru_stream_bwd": [_P] * 15 + [_I] * 4 + [_P],
    # the bfloat16-weight forms: the same arguments, wh_f, wh_b (and wht_f,
    # wht_b) bfloat16
    "asr_gru_stream_fwd_bf16": [_P] * 8 + [_I] * 4 + [_P],
    "asr_gru_stream_bwd_bf16": [_P] * 15 + [_I] * 4 + [_P],
    # xpn_f, xpn_b, mask, wh_f, wh_b, gh_f, gh_b, gc_f, gc_b, bc_f, bc_b,
    # h_f, c_f, h_b, c_b, h_init, c_init (the carried state [ndir, B, H],
    # or null), T, B, H, ndir, cluster CTAs, units per CTA, rows per
    # cluster, stream
    "asr_ln_lstm_fwd": [_P] * 17 + [_I] * 7 + [_P],
    # B, H, ndir, cluster CTAs, units, rows, *smem bytes, *max clusters
    "asr_ln_lstm_fwd_info": [_I] * 6 + [_P, _P],
    # xpn_f, xpn_b, mask, wh_f, wh_b, gh_f, gh_b, gc_f, gc_b, bc_f, bc_b,
    # h_f, c_f, h_b, c_b, dh_f, dh_b, dpre_f, dcn_f, dpre_b, dcn_b, T, B, H,
    # ndir, cluster CTAs, units, rows, stream
    "asr_ln_lstm_bwd": [_P] * 21 + [_I] * 7 + [_P],
    "asr_ln_lstm_bwd_info": [_I] * 6 + [_P, _P],
    # the bfloat16-weight forms: the same arguments, wh_f and wh_b bfloat16
    "asr_ln_lstm_fwd_bf16": [_P] * 17 + [_I] * 7 + [_P],
    "asr_ln_lstm_bwd_bf16": [_P] * 21 + [_I] * 7 + [_P],
    # the streamed-weight forms (H=300, H=512): the cluster forward's
    # arguments without the geometry
    "asr_ln_lstm_stream_fwd": [_P] * 17 + [_I, _I, _I, _I, _P],
    # xpn_f, xpn_b, mask, wh_f, wh_b, wht_f, wht_b, gh_f, gh_b, gc_f, gc_b,
    # bc_f, bc_b, h_f, c_f, h_b, c_b, dh_f, dh_b, dpre_f, dcn_f, dpre_b,
    # dcn_b, T, B, H, ndir, stream
    "asr_ln_lstm_stream_bwd": [_P] * 23 + [_I, _I, _I, _I, _P],
    # the bfloat16-weight forms: the same arguments, wh_f, wh_b (and wht_f,
    # wht_b) bfloat16
    "asr_ln_lstm_stream_fwd_bf16": [_P] * 17 + [_I] * 4 + [_P],
    "asr_ln_lstm_stream_bwd_bf16": [_P] * 23 + [_I] * 4 + [_P],
    # xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f, wh_b, h_f, c_f, h_b,
    # c_b, h_init, c_init, T, B, H, ndir, cluster CTAs, units per CTA, rows
    # per cluster, stream
    "asr_zoneout_lstm_fwd": [_P] * 15 + [_I] * 7 + [_P],
    # B, H, ndir, cluster CTAs, units, rows, *smem bytes, *max clusters
    "asr_zoneout_lstm_fwd_info": [_I] * 6 + [_P, _P],
    # xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f, wh_b, h_f, c_f, h_b,
    # c_b, dh_f, dh_b, dxp_f, dxp_b, T, B, H, ndir, cluster CTAs, units,
    # rows, stream
    "asr_zoneout_lstm_bwd": [_P] * 17 + [_I] * 7 + [_P],
    "asr_zoneout_lstm_bwd_info": [_I] * 6 + [_P, _P],
    # the bfloat16-weight forms: the same arguments, wh_f and wh_b bfloat16
    "asr_zoneout_lstm_fwd_bf16": [_P] * 15 + [_I] * 7 + [_P],
    "asr_zoneout_lstm_bwd_bf16": [_P] * 17 + [_I] * 7 + [_P],
    # the streamed-weight forms (H=300, H=512): the cluster forward's
    # arguments without the geometry
    "asr_zoneout_lstm_stream_fwd": [_P] * 15 + [_I, _I, _I, _I, _P],
    # xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f, wh_b, wht_f, wht_b,
    # h_f, c_f, h_b, c_b, dh_f, dh_b, dxp_f, dxp_b, T, B, H, ndir, stream
    "asr_zoneout_lstm_stream_bwd": [_P] * 19 + [_I, _I, _I, _I, _P],
    # the bfloat16-weight forms: the same arguments, wh_f, wh_b (and wht_f,
    # wht_b) bfloat16
    "asr_zoneout_lstm_stream_fwd_bf16": [_P] * 15 + [_I] * 4 + [_P],
    "asr_zoneout_lstm_stream_bwd_bf16": [_P] * 19 + [_I] * 4 + [_P],
    # xp_f, xp_b, mask, wh_f, wh_b, alpha_f, alpha_b, beta1_f, beta1_b,
    # beta2_f, beta2_b, b_f, b_b, h_f, c_f, h_b, c_b, h_init, c_init, T, B,
    # H, ndir, cluster CTAs, units per CTA, rows per cluster, stream
    "asr_mi_lstm_fwd": [_P] * 19 + [_I] * 7 + [_P],
    # B, H, ndir, cluster CTAs, units, rows, *smem bytes, *max clusters
    "asr_mi_lstm_fwd_info": [_I] * 6 + [_P, _P],
    # xp_f, xp_b, mask, wh_f, wh_b, alpha_f, alpha_b, beta1_f, beta1_b,
    # beta2_f, beta2_b, b_f, b_b, h_f, c_f, h_b, c_b, dh_f, dh_b, dpre_f,
    # dpre_b, T, B, H, ndir, cluster CTAs, units, rows, stream
    "asr_mi_lstm_bwd": [_P] * 21 + [_I] * 7 + [_P],
    "asr_mi_lstm_bwd_info": [_I] * 6 + [_P, _P],
    # the bfloat16-weight forms: the same arguments, wh_f and wh_b bfloat16
    "asr_mi_lstm_fwd_bf16": [_P] * 19 + [_I] * 7 + [_P],
    "asr_mi_lstm_bwd_bf16": [_P] * 21 + [_I] * 7 + [_P],
    # the streamed-weight forms (H=300, H=512): the cluster forward's
    # arguments without the geometry
    "asr_mi_lstm_stream_fwd": [_P] * 19 + [_I, _I, _I, _I, _P],
    # xp_f, xp_b, mask, wh_f, wh_b, wht_f, wht_b, alpha_f, alpha_b, beta1_f,
    # beta1_b, beta2_f, beta2_b, b_f, b_b, h_f, c_f, h_b, c_b, dh_f, dh_b,
    # dpre_f, dpre_b, T, B, H, ndir, stream
    "asr_mi_lstm_stream_bwd": [_P] * 23 + [_I, _I, _I, _I, _P],
    # the bfloat16-weight forms: the same arguments, wh_f, wh_b (and wht_f,
    # wht_b) bfloat16
    "asr_mi_lstm_stream_fwd_bf16": [_P] * 19 + [_I] * 4 + [_P],
    "asr_mi_lstm_stream_bwd_bf16": [_P] * 23 + [_I] * 4 + [_P],
    # lp_ext, valid, skip, alpha_seq, T, B, S, stream
    "asr_ctc_alpha": [_P, _P, _P, _P, _I, _I, _I, _P],
    # lp_ext, valid, alpha_seq, skip2, end_ind, gamma, T, B, S, stream
    "asr_ctc_beta": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # the warp design (S <= 544), the same arguments
    "asr_ctc_alpha_warp": [_P, _P, _P, _P, _I, _I, _I, _P],
    "asr_ctc_beta_warp": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # the beam decode: log_probs, lengths, lm_logp (or null), bp, prefixes,
    # out_len, out_score, B, T, V, W, P, E, pad_id, lm_order, lm_mod,
    # lm_state0, alpha, beta, hash multipliers, stream
    "asr_ctc_beam": [_P] * 7 + [_I] * 10 + [_F, _F, _U, _U, _P],
    # its stream form: log_probs, lengths, lm_logp (or null), bp, the beam
    # state len, last, pb, pnb, h1, h2, lm (in and out), prefixes, emits,
    # start slots, scores, B, T, V, W, E, pad_id, lm_order, lm_mod, alpha,
    # beta, hash multipliers, stream
    "asr_ctc_beam_stream": [_P] * 15 + [_I] * 8 + [_F, _F, _U, _U, _P],
    # the wide design (every W, V the select design does not take): the
    # decode's arguments with bp int64 and, after it, the scratch [B,
    # stride] bytes and its stride
    "asr_ctc_beam_wide": [_P] * 5 + [_L] + [_P] * 3 + [_I] * 10
                         + [_F, _F, _U, _U, _P],
    "asr_ctc_beam_wide_stream": [_P] * 5 + [_L] + [_P] * 11 + [_I] * 8
                                + [_F, _F, _U, _U, _P],
    # payload, n_words, row_start, widths, totals, out, nbcap, stream
    "asr_dpack_decode": [_P, _L, _P, _P, _P, _P, _I, _P],
    # the one-launch design: payload, n_words, row_start, widths, scratch,
    # scratch_cap, out, nbcap, stream
    "asr_dpack_decode_onepass": [_P, _L, _P, _P, _P, _I, _P, _I, _P],
}


# designs kept only for timing in turns (lstm_step_split.py builds them on
# their own); their entry points would clash with the library's
TIMING_ONLY = frozenset({"ctc_beam_sort.cu"})


def sources() -> list[Path]:
    return sorted(p for p in CSRC.glob("*.cu") if p.name not in TIMING_ONLY)


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of asr_study_torch cannot be built"
    )


def build_dir() -> Path:
    return BUILD_ROOT / f"kernels-{source_hash()}"


def _run_all(cmds: list[list[str]]) -> tuple[bool, str]:
    """Start every command at once, wait for all -> (all succeeded, their
    commands, times and output as one log)."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    ok, log = True, ""
    for cmd, proc in zip(cmds, procs):
        out = proc.communicate()[0]
        ok = ok and proc.returncode == 0
        log += (f"$ {' '.join(cmd)}\n# done at {time.perf_counter() - t0:.2f}"
                f" s, rc {proc.returncode}\n{out}")
    return ok, log


def build() -> Path:
    """Compile ``csrc/*.cu`` into the hashed build directory (once): one
    ``nvcc`` per source, all started together, then one link.

    The compiler's report (``-Xptxas -v``: registers, shared memory and
    spills of each kernel) is kept beside the library as ``build.log``.
    Returns the library's path."""
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    # build in a private directory, then rename: a concurrent process
    # building the same hash never loads a half-written library
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    objs = [str(tmp / f"{src.stem}.o") for src in sources()]
    ok, log = _run_all([[nvcc(), *NVCC_FLAGS, "-o", obj, str(src)]
                        for src, obj in zip(sources(), objs)])
    if ok:
        ok, link_log = _run_all([[nvcc(), *LINK_FLAGS, "-o",
                                  str(tmp / LIB_NAME), *objs]])
        log += link_log
    (out_dir / "build.log").write_text(log)
    if not ok:
        shutil.rmtree(tmp)
        raise RuntimeError(f"nvcc failed:\n{log}")
    os.replace(tmp / LIB_NAME, lib_path)
    shutil.rmtree(tmp)
    return lib_path


def build_log() -> str:
    """The compiler report of the current sources' build."""
    return (build_dir() / "build.log").read_text()


@functools.cache
def lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with every entry point's
    ``argtypes`` and ``restype`` (a CUDA error code) declared."""
    dll = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(dll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return dll


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
