#!/usr/bin/env python3
"""Where a step of the cluster LSTM, GRU, layer-norm, zoneout and MI LSTM
kernels, of the wide LSTM and GRU kernels, and of the CTC walks spends its
time, and where a frame of the fbank kernel's FFT design spends its, on one
NVIDIA GPU.

    python3 lstm_step_split.py [kernel ...]

With no argument every kernel below; with names (``gru_wide_fwd``, ...)
those alone.

Compiles ``asr_study_torch/csrc/bilstm_fwd.cu``, ``gru_fwd.cu``,
``gru_bwd.cu``, ``ln_lstm_fwd.cu``, ``ln_lstm_bwd.cu``,
``zoneout_lstm_fwd.cu``, ``zoneout_lstm_bwd.cu``, ``mi_lstm_fwd.cu`` and
``mi_lstm_bwd.cu`` as they are and in variants, into ``build/step_split/``,
and times each at the main paths' shapes (H=256, B=32; T=805 forward,
T=512 backward; one direction, R=4 rows a cluster, and two, R=8) with CUDA
events, the unchanged kernel first and last; ``lstm_wide_fwd.cu``,
``lstm_wide_bwd.cu``, ``gru_wide_fwd.cu`` and ``gru_wide_bwd.cu`` the same
way at H=512 (16 CTAs of 32 units; R=8 in one direction, R=16 in two).
Variants that drop one part
of the step (their outputs are wrong; only their times count):

- ``no_push``: h goes to the CTA's own buffer only, no exchange through
  distributed shared memory;
- ``no_push_no_sync``: that, and a block barrier instead of the cluster
  barrier;
- ``no_product``: no h_prev @ w;
- ``no_cell_math``: the cell's sigmoids and tanhs replaced by sums;
- ``skeleton``: neither product nor exchange.

The difference to the unchanged kernel is the part's cost on the step's
critical path.  Variants of the GRU kernels' thread shape (their outputs
are right; the committed kernels run 384 threads of 64 rows of a column,
the 96 gate columns of four slices at H=256):

- ``slice128``: the LSTM kernels' shape, 256 threads of 128 rows, of which
  64 wait out the product;
- ``threads192``: 192 threads of 128 rows, none idle.

Variants of the layer-norm LSTM kernels, whose steps add rounds of
LayerNorm statistics across the cluster (outputs wrong; times count):

- ``no_stats_sync``: the forward's two statistics rounds keep their pushes
  but lose their cluster barriers (the backward: the two LN rounds of its
  cotangent chain; its h-side and c statistics share the partials');
- ``no_stats``: the forward's statistics rounds gone, pushes and barriers;
- ``no_push``, ``no_product``: as above, for the forward.

Variants of the wide LSTM kernels (outputs wrong; times count): for the
forward ``no_push``, ``no_push_no_sync`` and ``no_product`` as above, and
``no_shared_half``: the product without the slice's rows 256..511, which
it reads from shared memory; for the backward, ``no_push`` keeps each
row's cotangent partials in the sender's own buffer and ``no_product``
drops its one product (dpre @ wh^T).

Variants of the wide GRU kernels: for the forward ``no_push``,
``no_push_no_sync``, ``no_product`` and ``no_shared_half`` as the wide
LSTM forward's (the committed shape: 192 threads, each column split over
two threads of 128 rows in registers, the slice's rows 256..511 in shared
memory); the other thread shape, ``split4`` (outputs right): 384 threads
of 128 rows, the whole slice in registers.  For the backward ``no_push`` and
``no_product`` as the wide LSTM backward's, and ``no_shared_half``: the
product without the rows 256..511 of wh, which it reads from shared
memory.

Variants of the MI-LSTM kernels (outputs wrong; times count):
``no_push`` and ``no_product`` as above for the forward; for the backward,
``no_push`` keeps each unit's cotangent partial in the sender's own
buffer, and ``no_product`` drops both of its products (the recomputed
h_prev @ w and the partials' dhp @ ws^T).

Variants of the zoneout-LSTM kernels (outputs wrong; times count): the
forward's as the LSTM forward's above (``no_cell_math`` there keeps the
mix), and ``no_mix``: h_new and c_new taken whole, the mix weights still
staged; ``no_mix_loads``: that, and no staging of zh and zc either; for the
backward, ``no_push`` and ``no_product`` as the MI backward's, and
``no_mix_loads``: no staging of zh and zc (the step reads stale ones).

The CTC walks (``ctc_alpha``, ``ctc_beta``): ``ctc.cu`` (the block design)
and ``ctc_warp.cu`` (the warp design), the block design first, at the main
path's lattice (T=512, B=32, S=97), in the variants listed at
``CTC_KERNELS``.

The fbank kernel's FFT design (``fbank_fft``, csrc/fbank_fft.cu) at the
serving shape (B=32 utterances of 3-8 s, T=805, MFCC, nfft=512), unchanged
(8 warps a CTA, tiles of 16 frames) first and last, in the variants listed
at ``FBANK_KERNELS``: the other CTA shapes (outputs right), ``warps4``
(4 warps a CTA), ``tile32`` (tiles of 32 frames) and ``warps4_tile32``;
and, outputs wrong, times count: ``no_passes`` (the FFT's passes after the
first), ``no_split`` (the split step's four loads of Z), ``no_mel`` (the
band sums), ``no_dct`` (the DCT sums), and ``skeleton`` (the four
together: the tile's copy, the tables, the first pass, the power, the logs
and the stores).

Prints one line per variant and the card's name and power limit.  Without
CUDA it exits 1.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

T_FWD, T_BWD, B, H_NARROW = 805, 512, 32, 256

PRODUCT = "for (int kk = 0; kk < kSlice; kk += 4) {"
NO_PRODUCT = (PRODUCT, PRODUCT.replace("kk < kSlice", "kk < 0"))
PUSH = "cluster.map_shared_rank(hn, p)[r * HS + unit] = h;"
NO_PUSH = (PUSH, "if (p == rank) hn[r * HS + unit] = h;")
NO_SYNC = ("    cluster.sync();\n  }\n}", "    __syncthreads();\n  }\n}")
LSTM_CELL = ("      float c = fg * c_prev + ig * gg;\n"
             "      float h = og * tanhf(c);",
             "      float c = pre[0] + pre[1] + pre[2] + pre[3] + c_prev;\n"
             "      float h = c;")
GRU_CELL = ("      const float rg = sigmoidf(xr[u] + hsum[0]);\n"
            "      const float zg = sigmoidf(xr[U + u] + hsum[1]);\n"
            "      const float ng = tanhf(xr[2 * U + u] + rg * hsum[2]);",
            "      const float rg = xr[u] + hsum[0];\n"
            "      const float zg = xr[U + u] + hsum[1];\n"
            "      const float ng = xr[2 * U + u] + rg * hsum[2];")
SLICE = ("constexpr int kSlice = 64; ", "constexpr int kSlice = 128;")
SLICE128 = [("constexpr int kThreads = 384;",
             "constexpr int kThreads = 256;"), SLICE]
THREADS192 = [("constexpr int kThreads = 384;",
               "constexpr int kThreads = 192;"), SLICE]
LN_FWD_SYNCS = [("    cluster.sync();\n\n    // 3. the gates",
                 "\n\n    // 3. the gates"),
                ("    cluster.sync();\n\n    // 4. h from",
                 "\n\n    // 4. h from")]
LN_FWD_PUSHES = [("      if (lane < C) {\n        float4* dst",
                  "      if (false) {\n        float4* dst"),
                 ("      if (lane < C)\n        *reinterpret_cast<float2*>",
                  "      if (false)\n        *reinterpret_cast<float2*>")]
LN_PUSH = ("for (int p = 0; p < C; ++p) *cluster.map_shared_rank(hn_buf, p) "
           "= hn;", "*hn_buf = hn;")
LN_BWD_SYNCS = [(f"      cluster.sync();\n\n      // {step}",
                 f"\n\n      // {step}")
                for step in ("d. dc, dpre", "e. dhp of own")]
MI_BWD_PUSH = ("float* dst = cluster.map_shared_rank(recv + (cur * C + rank)"
               " * RU,\n                                           owner);",
               "float* dst = recv + (cur * C + rank) * RU;")
MI_BWD_PRODUCT = ("for (int k = 0; k < GC; k += 4) {",
                  "for (int k = 0; k < 0; k += 4) {")
ZO_CELL = ("      const float c_new = fg * c_prev + ig * gg;\n"
           "      const float h_new = og * tanhf(c_new);",
           "      const float c_new = pre[0] + pre[1] + pre[2] + pre[3] + "
           "c_prev;\n      const float h_new = c_new;")
ZO_MIX = ("      float h = mh * h_new + (1.f - mh) * h_prev;\n"
          "      float c = mc * c_new + (1.f - mc) * c_prev;",
          "      float h = h_new;\n      float c = c_new;")
ZO_LOADS = ("      cp_async4(zhs + slot * RU + i, ok ? zh + o : zh, ok);\n"
            "      cp_async4(zcs + slot * RU + i, ok ? zc + o : zc, ok);\n",
            "")
WIDE_PUSH = ("*reinterpret_cast<float4*>(cluster.map_shared_rank(hn, p))"
             " = h4;", "if (p == rank) *reinterpret_cast<float4*>(hn) = h4;")
WIDE_SHARED = ("#pragma unroll 4\n      for (int kk = 0; kk < kSlice; "
               "kk += 4) {", "#pragma unroll 4\n      for (int kk = 0; "
               "kk < 0; kk += 4) {")
WIDE_BWD_PUSH = ("cluster.map_shared_rank(\n            slot + (j - owner * "
                 "kUnits) * R, owner)", "(slot + (j - owner * kUnits) * R)")
WIDE_BWD_PRODUCT = ("for (int col = 0; col < kCols; ++col) {\n        const "
                    "float wa", "for (int col = 0; col < 0; ++col) {\n"
                    "        const float wa")
GRU_WIDE_SPLIT4 = ("constexpr int kSplit = 2;", "constexpr int kSplit = 4;")
GRU_WIDE_SHARED = ("for (int kk = 0; kk < kPerShared; kk += 4) {",
                   "for (int kk = 0; kk < 0; kk += 4) {")
GRU_WIDE_BWD_SHARED = ("const float wa = w[col], wb = ws[col * kThreads + "
                       "tid];", "const float wa = w[col], wb = 0.f;")
SPLIT = {
    "no_push": [NO_PUSH],
    "no_push_no_sync": [NO_PUSH, NO_SYNC],
    "no_product": [NO_PRODUCT],
    "skeleton": [NO_PRODUCT, NO_PUSH],
}
# kernel -> (source, C entry point, gate columns a unit, steps, variants;
# the wide kernels' width is H_WIDE)
H_WIDE = 512
KERNELS = {
    "bilstm_fwd": ("bilstm_fwd.cu", "asr_bilstm_fwd", 4, T_FWD,
                   {"base": [], **SPLIT, "no_cell_math": [LSTM_CELL]}),
    "gru_fwd": ("gru_fwd.cu", "asr_gru_fwd", 3, T_FWD,
                {"base": [], **SPLIT, "no_cell_math": [GRU_CELL],
                 "slice128": SLICE128, "threads192": THREADS192}),
    "gru_bwd": ("gru_bwd.cu", "asr_gru_bwd", 3, T_BWD,
                {"base": [], "slice128": SLICE128,
                 "threads192": THREADS192}),
    "ln_lstm_fwd": ("ln_lstm_fwd.cu", "asr_ln_lstm_fwd", 4, T_FWD,
                    {"base": [], "no_stats_sync": LN_FWD_SYNCS,
                     "no_stats": LN_FWD_SYNCS + LN_FWD_PUSHES,
                     "no_push": [LN_PUSH], "no_product": [NO_PRODUCT]}),
    "ln_lstm_bwd": ("ln_lstm_bwd.cu", "asr_ln_lstm_bwd", 4, T_BWD,
                    {"base": [], "no_stats_sync": LN_BWD_SYNCS}),
    "zoneout_lstm_fwd": ("zoneout_lstm_fwd.cu", "asr_zoneout_lstm_fwd", 4,
                         T_FWD, {"base": [], **SPLIT,
                                 "no_cell_math": [ZO_CELL],
                                 "no_mix": [ZO_MIX],
                                 "no_mix_loads": [ZO_MIX, ZO_LOADS]}),
    "zoneout_lstm_bwd": ("zoneout_lstm_bwd.cu", "asr_zoneout_lstm_bwd", 4,
                         T_BWD, {"base": [], "no_push": [MI_BWD_PUSH],
                                 "no_product": [NO_PRODUCT, MI_BWD_PRODUCT],
                                 "no_mix_loads": [ZO_LOADS]}),
    "mi_lstm_fwd": ("mi_lstm_fwd.cu", "asr_mi_lstm_fwd", 4, T_FWD,
                    {"base": [], "no_push": [NO_PUSH],
                     "no_product": [NO_PRODUCT]}),
    "mi_lstm_bwd": ("mi_lstm_bwd.cu", "asr_mi_lstm_bwd", 4, T_BWD,
                    {"base": [], "no_push": [MI_BWD_PUSH],
                     "no_product": [NO_PRODUCT, MI_BWD_PRODUCT]}),
    "lstm_wide_fwd": ("lstm_wide_fwd.cu", "asr_lstm_wide_fwd", 4, T_FWD,
                      {"base": [], "no_push": [WIDE_PUSH],
                       "no_push_no_sync": [WIDE_PUSH, NO_SYNC],
                       "no_product": [NO_PRODUCT],
                       "no_shared_half": [WIDE_SHARED]}),
    "lstm_wide_bwd": ("lstm_wide_bwd.cu", "asr_lstm_wide_bwd", 4, T_BWD,
                      {"base": [], "no_push": [WIDE_BWD_PUSH],
                       "no_product": [WIDE_BWD_PRODUCT]}),
    "gru_wide_fwd": ("gru_wide_fwd.cu", "asr_gru_wide_fwd", 3, T_FWD,
                     {"base": [], "no_push": [WIDE_PUSH],
                      "no_push_no_sync": [WIDE_PUSH, NO_SYNC],
                      "no_product": [NO_PRODUCT, GRU_WIDE_SHARED],
                      "no_shared_half": [GRU_WIDE_SHARED],
                      "split4": [GRU_WIDE_SPLIT4]}),
    "gru_wide_bwd": ("gru_wide_bwd.cu", "asr_gru_wide_bwd", 3, T_BWD,
                     {"base": [], "no_push": [WIDE_BWD_PUSH],
                      "no_product": [WIDE_BWD_PRODUCT],
                      "no_shared_half": [GRU_WIDE_BWD_SHARED]}),
}


def variants_of(kernel: str) -> list:
    """The variants of one entry -> [(key, source, C entry point, edits)];
    the key (kernel, variant), for the CTC kernels (kernel, design,
    variant)."""
    if kernel in FBANK_KERNELS:
        source, c_name, variants = FBANK_KERNELS[kernel]
        return [((kernel, name), source, c_name, edits)
                for name, edits in variants.items()]
    if kernel in CTC_KERNELS:
        return [((kernel, design, name), source, c_name, edits)
                for design, (source, c_name, variants)
                in CTC_KERNELS[kernel].items()
                for name, edits in variants.items()]
    source, c_name, _, _, variants = KERNELS[kernel]
    return [((kernel, name), source, c_name, edits)
            for name, edits in variants.items()]


def build(root: Path, kernels: list) -> dict:
    """The variants of ``kernels``, compiled in parallel -> their key ->
    its C entry point."""
    from asr_study_torch import _build

    out = root / "build" / "step_split"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel in kernels:
        for key, source, c_name, edits in variants_of(kernel):
            text = (_build.CSRC / source).read_text()
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"{key}: the kernel no longer has "
                                       f"{old!r}")
                text = text.replace(old, new)
            stem = "_".join(key)
            (out / f"{stem}.cu").write_text(text)
            procs[key] = (c_name, stem, subprocess.Popen(
                [_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                 "-Xcompiler", "-fPIC", "-shared", "-o",
                 str(out / f"{stem}.so"), str(out / f"{stem}.cu")]))
    entry = {}
    for key, (c_name, stem, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on the {key} variant")
        fn = getattr(ctypes.CDLL(str(out / f"{stem}.so")), c_name)
        fn.argtypes = _build.SIGNATURES[c_name]
        fn.restype = ctypes.c_int
        entry[key] = fn
    return entry


def time_ms(call, reps: int = 10) -> float:
    """Mean ms a call from CUDA events around ``reps`` calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ctc_split(card: str, kernel: str, entry: dict) -> None:
    """One CTC kernel's variants, the block design's first, at the main
    path's lattice (T=512, B=32, L=48: S=97, lengths 256..512, label
    lengths 24..48), each design's unchanged kernel first and last; the
    variants that compute the same function are held against it."""
    from asr_study_torch.ops import ctc

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    t, l_max = T_BWD, 48
    lengths = torch.randint(t // 2, t + 1, (B,), generator=g)
    lengths[0] = t
    lab_lens = torch.randint(l_max // 2, l_max + 1, (B,), generator=g)
    lab_lens[0] = l_max
    with torch.no_grad():
        lp_ext, valid, skip, end, ll = ctc.lattice(
            torch.randn(B, t, 28, generator=g).to(dev), lengths.to(dev),
            torch.randint(0, 27, (B, l_max), generator=g).to(dev),
            lab_lens.to(dev))
        s_len = lp_ext.shape[2]
        alpha = ctc.ctc_alpha_plain(lp_ext, valid, skip)
        args = ((lp_ext, valid, skip) if kernel == "ctc_alpha" else
                (lp_ext, valid, alpha, ctc.skip_from_source(skip),
                 ctc.end_indicator(end, ll, s_len)))
    out = torch.empty_like(lp_ext)
    clk = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0])
    for design, (_, _, variants) in CTC_KERNELS[kernel].items():
        base = None
        for name in [*variants, "base"]:
            def call(fn=entry[kernel, design, name]):
                err = fn(*(a.data_ptr() for a in (*args, out)), t, B, s_len,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{kernel} {design} {name}: launch "
                                       f"failed ({err})")
            call()
            torch.cuda.synchronize()
            if base is None:
                base = out.clone()
            same = ("" if "no_" in name else
                    f", max |out - base's| "
                    f"{float((out - base).abs().max()):.3e}")
            ms = time_ms(call, 20)
            print(f"[{card}] {kernel}, {design} design, T={t} B={B} "
                  f"S={s_len}, {name}: {ms:.4f} ms, {1e3 * ms / t:.4f} us "
                  f"a step ({1e3 * ms / t * clk:.0f} cycles at {clk:.0f} "
                  f"MHz){same}")


# The CTC kernels: kernel -> design -> (source, C entry point, variants
# past the unchanged one).  Variants that drop one part of the step (their
# outputs are wrong; only their times count): ``no_lp_load``, the frame's
# emissions replaced by 0 (the warp design: not loaded either);
# ``no_exchange``, the lattice neighbours' exchange dropped (the block
# design: its barrier; the warp design: the shuffles, each state taking
# its own chunk's values); ``no_barrier``, the warp design's named barrier
# dropped (its chunk edges read stale values); ``no_logadd``, logadd3
# replaced by the max of its arguments.  The warp design's other ring
# depths and thread shape compute the same function: ``depth4``,
# ``depth8`` (frames fetched ahead; the committed kernel 16) and
# ``one_warp``, ``one_warp_depth8`` (one warp a row, J = ceil(S/32) states
# a lane, the neighbours by shuffles alone; the committed kernel runs J
# warps a row, one state a lane, the chunk edges through shared memory
# behind a named barrier).
NO_LOGADD = ("  return mx + logf(expf(a - mx) + expf(b - mx) + expf(c - mx));",
             "  return mx;")
ONE_WARP = ("constexpr bool kSplitRow = true;",
            "constexpr bool kSplitRow = false;")
DEPTH8 = ("constexpr int kDepth = 16;", "constexpr int kDepth = 8;")
WARP_SHAPES = {
    "depth4": [("constexpr int kDepth = 16;", "constexpr int kDepth = 4;")],
    "depth8": [DEPTH8],
    "one_warp": [ONE_WARP],
    "one_warp_depth8": [ONE_WARP, DEPTH8],
    "no_barrier": [("row_barrier<kThreads>();", "")],
}
FBANK_NO_PASSES = ("      fft_rest<M, R>(re, im, ptw, lane);\n", "")
FBANK_NO_SPLIT = ("const float a = re[ik], bq = im[ik], c = re[jk], "
                  "d = im[jk];", "const float a = ik, bq = jk, c = 0.f, "
                  "d = 0.f;")
FBANK_NO_MEL = ("for (int k = 0; k < n; ++k) acc", "for (int k = 0; k < 0; "
                "++k) acc")
FBANK_NO_DCT = ("for (int m = 0; m < n_mel; ++m)\n          acc",
                "for (int m = 0; m < 0; ++m)\n          acc")
FBANK_WARPS4 = ("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")
FBANK_TILE32 = ("constexpr int kTile = 16;", "constexpr int kTile = 32;")
FBANK_KERNELS = {
    "fbank_fft": ("fbank_fft.cu", "asr_fbank_fft", {
        "base": [], "warps4": [FBANK_WARPS4], "tile32": [FBANK_TILE32],
        "warps4_tile32": [FBANK_WARPS4, FBANK_TILE32],
        "no_passes": [FBANK_NO_PASSES],
        "no_split": [FBANK_NO_SPLIT], "no_mel": [FBANK_NO_MEL],
        "no_dct": [FBANK_NO_DCT],
        "skeleton": [FBANK_NO_PASSES, FBANK_NO_SPLIT, FBANK_NO_MEL,
                     FBANK_NO_DCT]}),
}


def fbank_split(card: str, entry: dict) -> None:
    """The FFT design's variants at the serving shape (chip_smoke.py's
    batch: 32 utterances of 3-8 s, one of 8 s, T=805), the unchanged
    kernel first and last; the other CTA shapes also against the unchanged
    kernel's output, which must be equal bit for bit."""
    import numpy as np

    from asr_study_torch.features.fbank import _MODES
    from asr_study_torch.features.select import featurizer

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    lens = rng.randint(48000, 128001, size=B)
    lens[0] = 128000
    n_pad = -(-int(lens.max()) // 2048) * 2048
    w = torch.from_numpy(0.3 * rng.randn(B, n_pad).astype(np.float32))
    w = w * (torch.arange(n_pad)[None, :] < torch.from_numpy(lens)[:, None])
    feat = featurizer("mfcc", dev)
    pre, t, _ = feat._prep(w.to(dev), torch.from_numpy(lens).to(dev))
    ch = feat.chain
    out = torch.empty(B, t, ch.num_out, device=dev)
    n_mel, n_cep = ch.dct.shape
    _, _, variants = FBANK_KERNELS["fbank_fft"]
    shapes = ("warps4", "tile32", "warps4_tile32")
    ref = None
    for name in [*variants, "base"]:
        def call(fn=entry["fbank_fft", name]):
            err = fn(pre.data_ptr(), pre.shape[1], ch.window.data_ptr(),
                     ch.twiddle.data_ptr(), ch.mel_packed.data_ptr(),
                     ch.mel_packed.shape[0], ch.mel_bands.data_ptr(),
                     ch.dct.data_ptr(), ch.lift.data_ptr(), out.data_ptr(),
                     B, t, ch.frame_len, ch.frame_step, ch.nfft, n_mel,
                     n_cep, ch.num_out, ch.floor, _MODES[ch.kind],
                     int(ch.append_energy),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"fbank_fft {name}: launch failed ({err})")
        call()
        torch.cuda.synchronize()
        note = ""
        if ref is None:
            ref = out.clone()
        elif name in shapes:
            if not torch.equal(out, ref):
                raise RuntimeError(f"fbank_fft {name}: output differs from "
                                   "the unchanged kernel's")
            note = ", output bit-equal to base"
        ms = time_ms(call, 20)
        print(f"[{card}] fbank_fft, B={B} T={t} nfft={ch.nfft}, {name}: "
              f"{ms:.4f} ms, {1e6 * ms / (B * t):.3f} ns a frame{note}")


CTC_KERNELS = {
    "ctc_alpha": {
        "block": ("ctc.cu", "asr_ctc_alpha", {
            "base": [],
            "no_lp_load": [("logadd3(a0, a1, a2) + lp[row + s]",
                            "logadd3(a0, a1, a2) + 0.f")],
            "no_exchange": [("      alpha_seq[row + s] = a;\n    }\n"
                             "    __syncthreads();",
                             "      alpha_seq[row + s] = a;\n    }")],
            "no_logadd": [NO_LOGADD]}),
        "warp": ("ctc_warp.cu", "asr_ctc_alpha_warp", {
            "base": [],
            "no_lp_load": [("++i) ring_lp[u][i] = in[i] ? lp_at[s_of[i]] : "
                            "0.f;", "++i) ring_lp[u][i] = 0.f;")],
            "no_exchange": [("a1[i] = __shfl_sync(kFull, lane == 31 ? below "
                             ": cur[i],\n                            (lane "
                             "+ 31) & 31);", "a1[i] = below;"),
                            ("a2[i] = __shfl_sync(kFull, lane >= 30 ? below "
                             ": cur[i],\n                            (lane "
                             "+ 30) & 31);", "a2[i] = cur[i];")],
            "no_logadd": [NO_LOGADD], **WARP_SHAPES}),
    },
    "ctc_beta": {
        "block": ("ctc.cu", "asr_ctc_beta", {
            "base": [],
            "no_lp_load": [("lp_next[s] = lp[row + s];",
                            "lp_next[s] = 0.f;")],
            "no_exchange": [("      be[s] = beta[s] + lp_next[s];\n"
                             "    __syncthreads();",
                             "      be[s] = beta[s] + lp_next[s];")],
            "no_logadd": [NO_LOGADD]}),
        "warp": ("ctc_warp.cu", "asr_ctc_beta_warp", {
            "base": [],
            "no_lp_load": [("ring_lp[u][i] = in[i] ? lp_at[s_of[i]] : "
                            "0.f;\n      ring_a", "ring_lp[u][i] = 0.f;\n"
                            "      ring_a")],
            "no_exchange": [("b1[i] = __shfl_sync(kFull, lane == 0 ? above "
                             ": be[i],\n                            (lane "
                             "+ 1) & 31);", "b1[i] = above;"),
                            ("b2[i] = __shfl_sync(kFull, lane < 2 ? above : "
                             "be[i],\n                            (lane + "
                             "2) & 31);", "b2[i] = be[i];")],
            "no_logadd": [NO_LOGADD], **WARP_SHAPES}),
    },
}


def main() -> int:
    if not torch.cuda.is_available():
        print("lstm_step_split: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from asr_study_torch.ops.bilstm import lstm, lstm_geometry
    from asr_study_torch.ops.gru import gru_geometry
    from asr_study_torch.ops.ln_lstm import ln_geometry, ln_lstm
    from asr_study_torch.ops.mi_lstm import mi_geometry, mi_lstm
    from asr_study_torch.ops.recurrence import stream
    from asr_study_torch.ops.zoneout_lstm import zoneout_geometry, zoneout_lstm

    from asr_study_torch.ops.gru import gru

    names = [*KERNELS, *CTC_KERNELS, *FBANK_KERNELS]
    kernels = sys.argv[1:] or names
    unknown = [k for k in kernels if k not in names]
    if unknown:
        print(f"lstm_step_split: no kernel {unknown}; the kernels are "
              f"{names}", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    entry = build(Path(__file__).resolve().parent, kernels)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    print(card)
    for kernel in kernels:
        if kernel in CTC_KERNELS:
            ctc_split(card, kernel, entry)
            continue
        if kernel in FBANK_KERNELS:
            fbank_split(card, entry)
            continue
        _, _, gates, t, variants = KERNELS[kernel]
        H = H_WIDE if "wide" in kernel else H_NARROW
        geometry = (ln_geometry if kernel.startswith("ln") else
                    mi_geometry if kernel.startswith("mi") else
                    zoneout_geometry if kernel.startswith("zoneout") else
                    lstm_geometry if gates == 4 else gru_geometry)
        xp = torch.randn(t, B, gates * H, device=dev, generator=g)
        wh = torch.randn(H, gates * H, device=dev, generator=g) / H ** 0.5
        mask = torch.ones(t, B, 1, device=dev)
        seqs = [torch.randn(t, B, H, device=dev, generator=g) * 0.5
                for _ in range(2)]
        outs = [torch.zeros(t, B, H if kernel.endswith("fwd") else gates * H,
                            device=dev) for _ in range(4)]
        # the layer-norm gains and bias: gh [4H], gc and bc [H]
        gh = 1.0 + 0.1 * torch.randn(gates * H, device=dev, generator=g)
        gc = 1.0 + 0.1 * torch.randn(H, device=dev, generator=g)
        bc = 0.1 * torch.randn(H, device=dev, generator=g)
        ln = (gh, gh, gc, gc, bc, bc)
        # the MI vectors alpha, beta1, beta2 about 1 and b about 0, [4H]
        al, b1, b2 = (1.0 + 0.1 * torch.randn(gates * H, device=dev,
                                              generator=g) for _ in range(3))
        bias = 0.1 * torch.randn(gates * H, device=dev, generator=g)
        mi = (al, al, b1, b1, b2, b2, bias, bias)
        # the zoneout mix weights, Bernoulli(0.9) as in train mode
        zh, zc = ((torch.rand(t, B, H, device=dev, generator=g) < 0.9).float()
                  for _ in range(2))
        zo = (zh, zh, zc, zc)
        if kernel == "ln_lstm_fwd":     # h_f, c_f, h_b, c_b
            ptrs = (xp, xp, mask, wh, wh, *ln, *outs)
        elif kernel == "ln_lstm_bwd":   # h, c, dh; dpre, dcn of each lane
            # h and c from the forward: random ones make the cotangent
            # chain overflow
            h, c = ln_lstm(xp, mask, wh, gh, gc, bc)
            outs[1], outs[3] = (torch.zeros(t, B, H, device=dev)
                                for _ in range(2))
            ptrs = (xp, xp, mask, wh, wh, *ln, h, c, h, c, seqs[1], seqs[1],
                    *outs)
        elif kernel == "zoneout_lstm_fwd":  # h_f, c_f, h_b, c_b
            ptrs = (xp, xp, mask, *zo, wh, wh, *outs)
        elif kernel == "zoneout_lstm_bwd":  # h, c, dh; dxp of each lane
            h, c = zoneout_lstm(xp, mask, zh, zc, wh)
            ptrs = (xp, xp, mask, *zo, wh, wh, h, c, h, c, seqs[1], seqs[1],
                    *outs[:2])
        elif kernel == "mi_lstm_fwd":   # h_f, c_f, h_b, c_b
            ptrs = (xp, xp, mask, wh, wh, *mi, *outs)
        elif kernel == "mi_lstm_bwd":   # h, c, dh; dpre of each lane
            h, c = mi_lstm(xp, mask, wh, al, b1, b2, bias)
            ptrs = (xp, xp, mask, wh, wh, *mi, h, c, h, c, seqs[1], seqs[1],
                    *outs[:2])
        elif kernel == "bilstm_fwd":    # h_f, c_f, h_b, c_b
            ptrs = (xp, xp, mask, wh, wh, *outs)
        elif kernel == "lstm_wide_fwd":  # h_f, c_f, h_b, c_b; no gates
            ptrs = (xp, xp, mask, wh, wh, *outs, None, None)
        elif kernel == "lstm_wide_bwd":  # gates, c, dh; dxp of each lane
            # the gates and c from the forward
            _, c, (gts,) = lstm(xp, mask, wh, residual=True)
            ptrs = (gts, gts, mask, wh, wh, c, c, seqs[1], seqs[1],
                    *outs[:2])
        elif kernel == "gru_wide_fwd":  # h_f, h_b; no hg
            ptrs = (xp, xp, mask, wh, wh, *outs[:2], None, None)
        elif kernel == "gru_wide_bwd":  # xp, hg, h, dh; dxp, dhp each lane
            # h and hg from the forward
            h, (hg,) = gru(xp, mask, wh, residual=True)
            ptrs = (xp, xp, hg, hg, mask, wh, wh, h, h, seqs[1], seqs[1],
                    *outs)
        elif kernel == "gru_fwd":       # h_f, h_b
            ptrs = (xp, xp, mask, wh, wh, *outs[:2])
        else:                           # h, dh; dxp_f, dhp_f, dxp_b, dhp_b
            ptrs = (xp, xp, mask, wh, wh, seqs[0], seqs[0], seqs[1],
                    seqs[1], *outs)
        for ndir in (1, 2):
            geo = geometry(H, B, ndir)
            base = None
            for name in [*variants, "base"]:
                def call(fn=entry[kernel, name]):
                    err = fn(*(None if a is None else a.data_ptr()
                               for a in ptrs), t, B, H, ndir,
                             geo.ctas, geo.units, geo.rows, stream(xp))
                    if err:
                        raise RuntimeError(f"{kernel} {name}: launch failed "
                                           f"({err})")
                call()
                torch.cuda.synchronize()
                if base is None:
                    base = [o.clone() for o in outs]
                # the thread-shape variants compute the same function
                shape_err = ("" if name in SPLIT or "no_" in name
                             else ", max |out - base's| " + format(max(
                                 float((o - b).abs().max())
                                 for o, b in zip(outs, base)), ".3e"))
                ms = time_ms(call)
                print(f"[{card}] {kernel}, ndir={ndir} R={geo.rows} H={H} "
                      f"T={t} B={B}, {name}: {ms:.4f} ms, "
                      f"{1e3 * ms / t:.3f} us a step{shape_err}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
