#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (asr_study_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``asr_study_torch/csrc`` and drives the port's
serving path (BASELINE config 2: pcm16 wire -> MFCC+deltas -> deep_blstm
2x256 -> greedy CTC) at full width: B=32 LapsBM-like utterances of 3-8 s
at 16 kHz, 8 batches, random weights from a seeded ``torch.Generator``.

Phases, in order; any failure raises and the exit code is not 0:

1. toolchain: torch and its CUDA, nvcc, triton, the card and power limit;
2. build: nvcc time and each kernel's registers / shared memory / spills;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes, within the stated tolerance;
4. the slice through ``cli.predict.serve_batch`` (what the CLI calls),
   with launch counters proving both kernels ran, logits held against the
   plain path on the CPU, decoded lengths within the frame lengths;
5. timings from CUDA events after a warm-up.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA the script exits 1.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import subprocess
import sys
import time

import numpy as np
import torch

SR = 16000
BATCH = 32
N_BATCHES = 8
SECONDS = (3.0, 8.0)          # LapsBM-like durations (bench.py)
HIDDEN = 256
LAYERS = 2
NUM_CLASSES = 27
SEED = 0

# Tolerances, max absolute error against the plain version:
# - fbank: log-domain features; both sides are fp32 but sum in other
#   orders, and log amplifies the relative error of near-silent mel
#   channels; the repo's device-vs-oracle log-domain contract is 2e-3.
FBANK_TOL = 2e-3
# - bilstm: |kernel - plain| <= ATOL + RTOL * |plain| elementwise over h and
#   c of both directions.  805 serial steps of fp32 FMAs summed in another
#   order than cuBLAS's; h is bounded by 1 but c is not (|c| reaches
#   hundreds on random weights), so the bound scales with the value.
BILSTM_ATOL = 1e-4
BILSTM_RTOL = 1e-5
# - logits of the whole slice, kernel path on the card against the plain
#   path on the CPU (features, two layers and the classifier between).
LOGITS_TOL = 2e-3


def synth_batch(rng: np.random.RandomState, max_len: bool = False):
    """Speech-like wavs (harmonic tones + noise) of LapsBM durations; with
    ``max_len`` the first one is exactly SECONDS[1] long."""
    durs = rng.uniform(*SECONDS, size=BATCH)
    if max_len:
        durs[0] = SECONDS[1]
    wavs = []
    for d in durs:
        n = int(d * SR)
        t = np.arange(n) / SR
        f0 = rng.uniform(80, 250)
        sig = sum(np.sin(2 * np.pi * f0 * (k + 1) * t) / (k + 1)
                  for k in range(4))
        sig += 0.1 * rng.randn(n)
        wavs.append((sig / np.abs(sig).max() * 0.5).astype(np.float32))
    return wavs, float(durs.sum())


def require(ok: bool, what: str) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` from CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from asr_study_torch import _build
    from asr_study_torch.cli.predict import pack_batches, serve_batch
    from asr_study_torch.features.device import spectral_plain
    from asr_study_torch.features.fbank import fbank
    from asr_study_torch.features.select import featurizer
    from asr_study_torch.models.zoo import deep_blstm
    from asr_study_torch.ops.bilstm import bilstm, bilstm_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. toolchain --------------------------------------------------------
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    nvcc_v = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                            text=True, check=True).stdout.strip()
    print(f"nvcc: {nvcc_v.splitlines()[-1]}")
    print(f"triton present: {importlib.util.find_spec('triton') is not None}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card)

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(sm_90a, {len(_build.sources())} sources, "
          f"{_build.build_dir().name})")
    for line in _build.build_log().splitlines():
        if ("ptxas info" in line and (
                "Compiling entry" in line or "Used" in line)) \
                or "spill" in line:
            print(f"  {line.strip()}")
    # both kernels size their shared memory at launch (ptxas sees none);
    # the bytes at the main path's shapes, by the formulas of asr_fbank
    # and asr_bilstm_fwd in csrc/
    print(f"  dynamic shared memory per block: fbank "
          f"{4 * (16 * (400 + 257 + 40) + 16)} B (16 frames, L=400, "
          f"K=257, M=40), bilstm_fwd {4 * 4 * (2 * HIDDEN + 4 * HIDDEN)} B "
          f"(4 rows, H={HIDDEN})")

    # 3. kernels against their plain versions at main-path shapes ---------
    rng = np.random.RandomState(SEED)
    wavs, _ = synth_batch(rng, max_len=True)
    n_pad = -(-max(len(w) for w in wavs) // 2048) * 2048
    w = torch.zeros((BATCH, n_pad), dtype=torch.float32)
    for i, x in enumerate(wavs):
        w[i, : len(x)] = torch.from_numpy(x)
    w = w.to(dev)
    lens = torch.tensor([len(x) for x in wavs], dtype=torch.int32,
                        device=dev)
    feat = featurizer("mfcc", dev)
    pre, t_out, feat_lengths = feat._prep(w, lens)
    fb_k = fbank(feat.chain, pre, t_out)
    fb_p = spectral_plain(feat.chain, pre, t_out)
    fbank_err = float((fb_k - fb_p).abs().max())
    print(f"fbank kernel vs plain: B={BATCH} T={t_out} F={fb_k.shape[2]} "
          f"max_abs_err={fbank_err:.3e} (tol {FBANK_TOL:g})")
    require(bool(torch.isfinite(fb_k).all()), "fbank: non-finite output")
    require(fbank_err <= FBANK_TOL, "fbank kernel disagrees with plain")

    gen = torch.Generator().manual_seed(SEED)
    model = deep_blstm(f"num_hiddens={HIDDEN},num_layers={LAYERS}",
                       num_classes=NUM_CLASSES, input_dim=feat.num_feats,
                       generator=gen, device=dev).eval()
    with torch.inference_mode():
        feats, _ = feat(w, lens)
        x = feats.transpose(0, 1)
        layer = model.rnn.layers[0].rnn
        xp_f = (layer.fw.input_proj(x) + layer.fw.b).contiguous()
        xp_b = (layer.bw.input_proj(x) + layer.bw.b).contiguous()
        mask = (torch.arange(t_out, device=dev)[:, None]
                < feat_lengths[None, :]).float()[..., None].contiguous()
        wh_f, wh_b = layer.fw.wh.detach(), layer.bw.wh.detach()
        bl_args = (xp_f, xp_b, mask, wh_f, wh_b)
        bl_k = bilstm(*bl_args)
        bl_p = bilstm_plain(*bl_args)
        bl_cpu = bilstm_plain(*(a.cpu() for a in bl_args))
    errs = [float((a - b).abs().max()) for a, b in zip(bl_k, bl_p)]
    bilstm_err = max(errs)
    bilstm_ok = all(bool(((a - b).abs() <= BILSTM_ATOL
                          + BILSTM_RTOL * b.abs()).all())
                    for a, b in zip(bl_k, bl_p))
    # yardstick: the same plain loop on the CPU against it on the card
    yard = max(float((a.cpu() - b).abs().max()) for a, b in zip(bl_p, bl_cpu))
    print(f"bilstm kernel vs plain: T={t_out} B={BATCH} H={HIDDEN} "
          f"lengths {int(feat_lengths.min())}..{int(feat_lengths.max())} "
          f"max_abs_err={bilstm_err:.3e} (h_f {errs[0]:.2e} c_f "
          f"{errs[1]:.2e} h_b {errs[2]:.2e} c_b {errs[3]:.2e}; max|c| "
          f"{max(float(bl_p[1].abs().max()), float(bl_p[3].abs().max())):.2f})"
          f" (tol {BILSTM_ATOL:g} + {BILSTM_RTOL:g}*|plain|); plain on CPU "
          f"vs plain on card "
          f"{yard:.3e}")
    require(bilstm_ok, "bilstm kernel disagrees with plain")

    # 4. the slice, through the CLI's serving function --------------------
    all_wavs, audio_s = [], 0.0
    for _ in range(N_BATCHES):
        b_wavs, secs = synth_batch(rng)
        all_wavs += b_wavs
        audio_s += secs
    chunk, cap, n_pad = pack_batches(all_wavs, BATCH)
    dev_chunk = torch.from_numpy(chunk).to(dev)
    offsets = range(0, chunk.shape[0], cap)

    def run_slice():
        return [serve_batch(model, feat, dev_chunk[o: o + cap], BATCH, n_pad)
                for o in offsets]

    fbank.launches = 0
    bilstm.launches = 0
    served = run_slice()
    torch.cuda.synchronize()
    launches = {"fbank": fbank.launches, "bilstm_fwd": bilstm.launches}
    print(f"slice: {N_BATCHES} batches x {BATCH}, {audio_s:.1f} s of audio, "
          f"T={served[0].logits.shape[1]}; launches {launches}")
    require(launches["fbank"] == N_BATCHES, f"fbank launches {launches}")
    require(launches["bilstm_fwd"] == N_BATCHES * LAYERS,
            f"bilstm_fwd launches {launches}")

    model_cpu = copy.deepcopy(model).to("cpu")
    feat_cpu = featurizer("mfcc", "cpu")
    chunk_cpu = torch.from_numpy(chunk)
    logits_err, same = 0.0, 0
    for o, s in zip(offsets, served):
        ref = serve_batch(model_cpu, feat_cpu, chunk_cpu[o: o + cap], BATCH,
                          n_pad)
        require(s.logits.shape == (BATCH, ref.logits.shape[1],
                                   NUM_CLASSES + 1),
                f"logits shape {tuple(s.logits.shape)}")
        require(bool(torch.isfinite(s.logits).all()), "non-finite logits")
        require(torch.equal(s.feat_lengths.cpu(), ref.feat_lengths),
                "frame lengths differ from the plain path")
        require(bool((s.lengths <= s.feat_lengths).all()),
                "a decode is longer than its frames")
        logits_err = max(logits_err,
                         float((s.logits.cpu() - ref.logits).abs().max()))
        same += int((s.decoded.cpu() == ref.decoded).all(1).sum())
    print(f"slice logits, kernel path on the card vs plain path on the CPU: "
          f"max_abs_err={logits_err:.3e} (tol {LOGITS_TOL:g}); identical "
          f"transcripts {same}/{N_BATCHES * BATCH}")
    require(logits_err <= LOGITS_TOL, "slice logits disagree with plain")

    # 5. timings ------------------------------------------------------------
    with torch.inference_mode():
        fb_ms = cuda_ms(lambda: fbank(feat.chain, pre, t_out), 20)
        fb_plain_ms = cuda_ms(lambda: spectral_plain(feat.chain, pre, t_out),
                              20)
        bl_ms = cuda_ms(lambda: bilstm(*bl_args), 10)
        bl_plain_ms = cuda_ms(lambda: bilstm_plain(*bl_args), 3, warmup=1)
    slice_ms = cuda_ms(run_slice, 3, warmup=1) / N_BATCHES
    print(f"[{card}] fbank: kernel {fb_ms:.4f} ms/batch, plain "
          f"{fb_plain_ms:.4f} ms/batch (B={BATCH}, T={t_out})")
    print(f"[{card}] bilstm_fwd (one layer, both directions): kernel "
          f"{bl_ms:.4f} ms/batch, plain {bl_plain_ms:.4f} ms/batch "
          f"(T={t_out}, B={BATCH}, H={HIDDEN})")
    print(f"[{card}] slice: {slice_ms:.4f} ms/batch, "
          f"{audio_s / (slice_ms * N_BATCHES / 1e3):.1f} audio-s/s "
          f"(wire unpack + features + {LAYERS}x{HIDDEN} BLSTM + classifier "
          f"+ greedy decode, B={BATCH})")

    record = {"kernels": [
        {"name": "fbank", "route": "cuda",
         "source": "asr_study_torch/csrc/fbank.cu",
         "replaces": "asr_study_tpu/features/pallas_fbank.py:107",
         "launches": launches["fbank"], "max_abs_err": fbank_err,
         "ms": fb_ms, "plain_ms": fb_plain_ms},
        {"name": "bilstm_fwd", "route": "cuda",
         "source": "asr_study_torch/csrc/bilstm_fwd.cu",
         "replaces": "asr_study_tpu/ops/pallas_bilstm.py:84",
         "launches": launches["bilstm_fwd"], "max_abs_err": bilstm_err,
         "ms": bl_ms, "plain_ms": bl_plain_ms},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
