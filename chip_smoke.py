#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (asr_study_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``asr_study_torch/csrc`` and drives the port's
paths at full width, with random weights from a seeded
``torch.Generator``:

- serving (BASELINE config 2): pcm16 wire -> MFCC+deltas -> deep_blstm
  2x256 -> greedy CTC, B=32 LapsBM-like utterances of 3-8 s at 16 kHz, 8
  batches, through ``cli.predict.serve_batch``; the same batches over the
  dpack wire (the dpack decode kernel) and the mu-law wire;
- serving the other recurrent models at full width, the same 8 batches
  through the same function: ``deep_gru`` 3x256 (bidirectional),
  ``deep_blstm`` 3x256 with ``bidirectional=false``, ``highway_blstm``
  5x256, ``deep_speech`` (3x512 dense front end, one 512-unit BLSTM; and
  with ``bidirectional=false``), ``ln_blstm`` 3x256 (layer-norm BLSTM),
  ``zoneout_blstm`` 3x256 (eval mode), ``mi_blstm`` 3x256
  (multiplicative integration) and ``deep_gru`` 3x512 (the wide GRU
  kernels; bidirectional and with ``bidirectional=false``);
- training (BASELINE config 3): features [32, 512, 39] -> deep_blstm 3x256
  (dropout 0) -> CTC -> backward -> clip by global norm -> Adam
  (``make_optimizer("adam", 1e-4, 400.0)``), through ``Trainer.train_step``
  and ``fit``, as ``benchmarks/bench_train.py`` drives the JAX trainer;
- training at the same shapes through ``Trainer.train_step``: ``deep_gru``
  3x256 bidirectional and unidirectional, ``deep_blstm`` 3x256
  unidirectional, ``highway_blstm`` 5x256, ``deep_speech`` bidirectional
  and unidirectional (the wide LSTM kernels), ``deep_gru`` 3x512
  bidirectional and unidirectional (the wide GRU kernels), and
  ``ln_blstm``, ``zoneout_blstm`` (train mode at zoneout 0.1/0.1, the mix
  weights drawn on the card) and ``mi_blstm``, each 3x256 bidirectional and
  unidirectional, dropout 0.

Phases, in order; any failure raises and the exit code is not 0:

1. toolchain: torch and its CUDA, nvcc, triton, the card and power limit;
2. build: nvcc time and each kernel's registers / shared memory / spills;
3. each kernel against its plain PyTorch version on the card, at its path's
   shapes, within the stated tolerance, with its time, its plain version's
   time, its bound and the time of the PyTorch library call that computes
   the same function (cuDNN ``nn.LSTM`` / ``nn.GRU``, ``F.ctc_loss``; none
   for fbank, dpack_decode and the layer-norm, zoneout and MI LSTMs); the
   LSTM kernels' wide design at H=512 (deep_speech's width), both
   directions and one, its backward from the forward's saved gates, timed
   in turns against the stream design it replaced beside cuDNN's two
   calls and the bound, with the card's cudaOccupancyMaxActiveClusters
   for its 16-CTA clusters; the GRU kernels' wide design at H=512 the same
   way (its backward from the h side of the pre-activations the forward
   keeps), beside cuDNN ``nn.GRU``; the layer-norm, zoneout and MI LSTM
   kernels' stream route at H=512 against plain once and timed beside its
   bound; the
   LSTM, GRU and MI kernels also at H=512 and H=100, and at shapes ragged
   for the cluster design's tiling (H=100, B=5 and B=33, a row masked
   throughout, T=1), with the design each width takes, its cluster
   geometry and shared memory; at H=256 the cluster design timed in turns
   against the stream design it replaced (through the latter's C entry
   point) beside cuDNN, the layer-norm, zoneout and MI LSTM kernels too (no
   cuDNN); the MI kernels at alpha = 0, beta1 = beta2 = 1 and the zoneout
   kernels at zh = zc = 1 against the LSTM kernels; the zoneout kernels
   with Bernoulli and with constant mix weights, and at ragged shapes as
   the MI ones; the CTC walks' warp design (csrc/ctc_warp.cu, through the
   wrappers) and block design (csrc/ctc.cu, through its C entry points)
   against their plain versions at T=512, B=32, S=97, timed in turns
   beside F.ctc_loss, and a lattice just above the warp design's cap
   through the wrappers, which must take the block design; the dpack
   decode bit for bit over the whole stream of every serving batch and of
   an edge batch, with the host encode time;
4. the serving slices, with launch counters proving their kernels ran
   (the LSTM, GRU, layer-norm, zoneout and MI LSTM kernels in the design
   their width takes; the LSTM's wide design under its own kernel line rows),
   logits held against the plain path on the CPU (for ln_blstm, whose
   recurrence is chaotic, on a batch cut to LN_CHECK_T frames); the dpack
   slice's logits and transcripts equal to the pcm16 slice's, the mulaw
   slice's logits against the plain path fed the same mulaw wire; the
   link probe and the codec it picks;
5. serving timings from CUDA events after a warm-up;
6. the training slices: launch counters per step, one card step held
   against the same step of the plain path on the CPU (loss, grad norm,
   every gradient; for ln_blstm a step on LN_CHECK_T frames; for
   zoneout_blstm with the card's mix weights), the loss falling over 20
   steps on one batch, two identical steps equal bit for bit, and (for
   the bidirectional deep_blstm) ``fit`` over a few batches with a
   checkpoint saved, restored and continued;
7. training timings: ms per step, steps/s, audio-s/s, per-stage ms (the
   deep_blstm step's CTC stage split into its pieces), the device busy
   share.

Each path is driven with every launch counter set to 0 just before it and
read just after; the kernels line sums those counts.  The line before the
last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA the script exits 1.
"""

from __future__ import annotations

import contextlib
import copy
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

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
# - bilstm_bwd: dxp elementwise |kernel - plain| <= ATOL + RTOL*|plain|,
#   the forward check's form: 512 serial steps of fp32 sums in other orders
#   (the first card run measured 9.5e-6 abs at |dxp| up to 17.8).
BWD_ATOL = 1e-4
BWD_RTOL = 1e-4
# - dwh through BiLSTMFunction against autograd through bilstm_plain: a sum
#   over T*B = 16384 rows, so the bound is relative to the largest entry.
DWH_RTOL = 1e-4
# - ctc_alpha / ctc_beta: alpha and gamma are log-likelihoods reaching
#   about -2000, where one fp32 ulp is 1.2e-4: |kernel - plain| <= ATOL +
#   RTOL*|plain| on entries above the floor; entries at LOG_EPS must be at
#   LOG_EPS on both sides.  dlp = -exp(gamma - logP) lies in [-1, 0].
CTC_ATOL = 1e-3
CTC_RTOL = 1e-5
DLP_TOL = 1e-5
# - one train step on the card against the same step of the plain path on
#   the CPU, same weights and batch: three layers of 512 steps in other
#   summation orders.  Loss relative 1e-4; grad norm relative 1e-3; each
#   parameter's gradient (after the clip) within 1e-3 of its norm
#   (||g_card - g_cpu|| <= 1e-3 * ||g_cpu||).
STEP_LOSS_RTOL = 1e-4
STEP_GNORM_RTOL = 1e-3
STEP_GRAD_RTOL = 1e-3

# - bigru_fwd / gru_fwd: h elementwise, |kernel - plain| <= ATOL + RTOL *
#   |plain|.  A GRU's h is a convex mix of tanh values, so |h| <= 1 and the
#   absolute term carries the check: 805 serial steps of fp32 sums in
#   another order than cuBLAS's.  The GRU backward kernels are held to the
#   bilstm_bwd bounds (BWD_*, DWH_RTOL), for the same reasons.
GRU_ATOL = 1e-4
GRU_RTOL = 1e-5
# - The layer-norm LSTM.  Its recurrence is chaotic at these widths and
#   init scales: a perturbation grows about e^(0.04 t) (its backward grows
#   to 5e8 over T=512, in the JAX scan's VJP as in the port), so two fp32
#   runs of the same maths part within a few hundred frames (logits of
#   the 3x256 slice by 0.7, train steps at T=512 by 1e-2 in the loss).  So
#   the LN forward kernels are held step by step: every frame of the
#   kernel's h and raw c against the plain step from the kernel's own
#   previous state, to the BILSTM_* bounds.  The backward is linear in its
#   cotangents given the forward states, which both sides share: dpre and
#   dcn of every (frame, row) within BWD_RTOL of that row's norm plus
#   BWD_ATOL.  dwh, dgh, dgc and dbc through the Functions, the ln_blstm
#   logits and the train step against the CPU are held at the usual bounds
#   on the first LN_CHECK_T frames, where e^(0.04 t) is still about 13.
LN_CHECK_T = 64

# H100 SXM peaks (NVIDIA's data sheet, at a 700 W power limit): fp32
# outside the tensor cores, and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_HBM = 3.35e12

# config 3 (benchmarks/bench_train.py defaults)
TRAIN_B, TRAIN_T, TRAIN_L, TRAIN_LAYERS, FEATS = 32, 512, 48, 3, 39
TRAIN_STEPS = 20                 # steps on one fixed batch
AUDIO_PER_STEP = TRAIN_B * TRAIN_T * 0.01   # 10 ms frames: 163.84 s


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


def within(got: torch.Tensor, want: torch.Tensor, atol: float,
           rtol: float) -> bool:
    """|got - want| <= atol + rtol * |want| everywhere."""
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def ctc_compare(got: torch.Tensor, want: torch.Tensor
                ) -> tuple[bool, bool, float]:
    """Log-likelihood rows: entries at the LOG_EPS floor must be at the
    floor on both sides; the rest within CTC_ATOL + CTC_RTOL * |want|.
    -> (floors equal, live entries within tolerance, max abs error of the
    live entries)"""
    floor = want <= -5e29
    floors_equal = torch.equal(got <= -5e29, floor)
    live = ~floor
    err = float((got - want)[live].abs().max()) if live.any() else 0.0
    return (floors_equal, within(got[live], want[live], CTC_ATOL, CTC_RTOL),
            err)


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of ``ops`` fp32
    operations at PEAK_FP32 and ``nbytes`` moved at PEAK_HBM -> (ms, which
    of the two limits it)."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def tensor_bytes(*ts: torch.Tensor) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


def rnn_bound(xp: torch.Tensor, hidden: int, ndir: int, passes: int,
              moved: tuple) -> tuple[float, str]:
    """Bound of a recurrent kernel: ``passes`` [B, H] x [H, G] products a
    step and direction (1 forward; 2 backward: the recomputed h-side
    pre-activations and the cotangent through wh^T) over every frame of
    xp [T, B, G]; the gate maths is left out, so it stays a lower bound.
    ``moved``: the function's inputs and outputs, each counted once."""
    t, b, g = xp.shape
    return bound(passes * 2.0 * t * b * hidden * g * ndir,
                 tensor_bytes(*moved))


def ctc_yardsticks(logits: torch.Tensor, lengths: torch.Tensor,
                   labels: torch.Tensor, lab_lens: torch.Tensor,
                   reps: int = 20) -> dict:
    """The library call for the CTC loss: ``F.ctc_loss`` (summed over the
    batch, on log-softmaxed logits) forward alone and forward + backward,
    beside the port's ``ops.ctc.ctc_loss`` (lattice, then CTCNLL: ctc_alpha
    forward, ctc_beta backward) timed the same way -> ms of each, the
    library's backward alone as the difference, and the relative
    difference of the two losses."""
    from asr_study_torch.ops import ctc

    blank = logits.shape[2] - 1
    lg = logits.detach().clone().requires_grad_()

    def lib(x):
        return torch.nn.functional.ctc_loss(
            torch.log_softmax(x, -1).transpose(0, 1), labels, lengths,
            lab_lens, blank=blank, reduction="sum")

    def port(x):
        return ctc.ctc_loss(x, lengths, labels, lab_lens,
                            blank_id=blank).sum()

    with torch.no_grad():
        want, got = lib(logits), port(logits)
        lib_fwd = cuda_ms(lambda: lib(logits), reps)
        port_fwd = cuda_ms(lambda: port(logits), reps)
    lib_fwd_grad = cuda_ms(lambda: lib(lg), reps)
    lib_fb = cuda_ms(lambda: torch.autograd.grad(lib(lg), lg), reps)
    port_fb = cuda_ms(lambda: torch.autograd.grad(port(lg), lg), reps)
    return {"lib_fwd": lib_fwd, "lib_bwd": lib_fb - lib_fwd_grad,
            "lib_fwd_bwd": lib_fb, "port_fwd": port_fwd,
            "port_fwd_bwd": port_fb,
            "loss_rel": float((got - want).abs() / want.abs())}


def rnn_yardsticks(kind: str, layer, x: torch.Tensor, lengths: torch.Tensor,
                   mask: torch.Tensor, reps: int = 5) -> dict:
    """The library call for a recurrent layer: cuDNN ``nn.LSTM`` /
    ``nn.GRU`` loaded with ``layer``'s weights (``bias_hh`` zero: the port
    folds every bias into ``x @ wx + b``, and nn.GRU would put b_hn inside
    r * (...)) on the packed x [T, B, F], forward alone and forward +
    backward (dx and every weight), beside the port's whole layer timed the
    same way.  Both include the input projection, which the port leaves to
    cuBLAS around its kernels.  -> ms of each, the library's backward alone
    as the difference, and the max abs difference of the two layers'
    outputs."""
    cells = [layer.fw] + ([layer.bw] if layer.bidirectional else [])
    ref = (torch.nn.LSTM if kind == "lstm" else torch.nn.GRU)(
        x.shape[2], layer.hidden, bidirectional=len(cells) == 2).to(x.device)
    with torch.no_grad():
        for sfx, cell in zip(("", "_reverse"), cells):
            getattr(ref, "weight_ih_l0" + sfx).copy_(cell.wx.t())
            getattr(ref, "weight_hh_l0" + sfx).copy_(cell.wh.t())
            getattr(ref, "bias_ih_l0" + sfx).copy_(cell.b)
            getattr(ref, "bias_hh_l0" + sfx).zero_()
    lens_cpu = lengths.cpu()
    x = x.detach().clone()
    x_req = x.clone().requires_grad_()

    def lib(inp):
        return ref(torch.nn.utils.rnn.pack_padded_sequence(
            inp, lens_cpu, enforce_sorted=False))[0]

    ref.eval()
    with torch.no_grad():
        out = torch.nn.utils.rnn.pad_packed_sequence(
            lib(x), total_length=x.shape[0])[0]
        mine = layer(x, mask)
        err = float((out - mine).abs().max())
        lib_fwd = cuda_ms(lambda: lib(x), reps)
        port_fwd = cuda_ms(lambda: layer(x, mask), reps)
    ref.train()
    g_lib = torch.randn_like(out.new_empty(int(lens_cpu.sum()),
                                           out.shape[2]))
    g_port = torch.randn_like(mine)
    lib_leaves = [x_req, *ref.parameters()]
    port_leaves = [x_req, *layer.parameters()]
    lib_fwd_grad = cuda_ms(lambda: lib(x_req), reps)
    lib_fb = cuda_ms(lambda: torch.autograd.grad(lib(x_req).data,
                                                 lib_leaves, g_lib), reps)
    port_fb = cuda_ms(lambda: torch.autograd.grad(layer(x_req, mask),
                                                  port_leaves, g_port), reps)
    return {"lib_fwd": lib_fwd, "lib_bwd": lib_fb - lib_fwd_grad,
            "lib_fwd_bwd": lib_fb, "port_fwd": port_fwd,
            "port_fwd_bwd": port_fb, "out_err": err}


def print_yardsticks(card: str, what: str, y: dict) -> None:
    print(f"[{card}] library yardstick, {what}: forward {y['lib_fwd']:.4f} "
          f"ms, forward + backward {y['lib_fwd_bwd']:.4f} ms (backward "
          f"alone {y['lib_bwd']:.4f} ms); the port's layer (x@wx cuBLAS + "
          f"kernel) forward {y['port_fwd']:.4f} ms, forward + backward "
          f"{y['port_fwd_bwd']:.4f} ms; outputs differ by at most "
          f"{y['out_err']:.3e}")


def device_busy(prof) -> tuple[float, float, float] | None:
    """(busy share, device-busy ms, window ms) of a torch.profiler run: the
    union of the device's kernel and copy intervals over the span of all
    recorded events.  None when the profiler saw no device activity."""
    evs = prof.events()
    dev = sorted((e.time_range.start, e.time_range.end) for e in evs
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    if not dev:
        return None
    busy, cur_s, cur_e = 0.0, dev[0][0], dev[0][1]
    for s, e in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = (max(e.time_range.end for e in evs)
            - min(e.time_range.start for e in evs))
    return busy / span, busy / 1e3, span / 1e3


def mask_of(lengths: torch.Tensor, t: int, dev: torch.device) -> torch.Tensor:
    """The frame mask [T, B, 1] of ``lengths``, contiguous on ``dev``."""
    return (torch.arange(t)[:, None] < lengths.cpu()[None, :]).float()[
        ..., None].to(dev).contiguous()


def input_proj(cell, x: torch.Tensor) -> torch.Tensor:
    """``x @ wx + b`` of one cell, as the layer hands it to the kernel."""
    with torch.no_grad():
        return (cell.input_proj(x) + cell.b).contiguous()


def check_training_kernels(dev: torch.device, card: str) -> dict:
    """Phase 3 for the training kernels, at config-3 shapes (T=512, B=32,
    H=256, L=48, S=97, lengths 256-512, label lengths 24-48), and their
    timings against the plain versions."""
    from asr_study_torch.models.zoo import deep_blstm
    from asr_study_torch.ops import ctc
    from asr_study_torch.ops.bilstm import (BiLSTMFunction, bilstm,
                                            bilstm_bwd, bilstm_bwd_plain,
                                            bilstm_plain)

    g = torch.Generator().manual_seed(SEED + 1)
    t, b, h = TRAIN_T, TRAIN_B, HIDDEN
    layer = deep_blstm(f"num_hiddens={h},num_layers=1", input_dim=FEATS,
                       generator=g, device=dev).rnn.layers[0].rnn
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g)
    lengths[0] = t
    x = torch.randn(t, b, FEATS, generator=g).to(dev)
    mask = mask_of(lengths, t, dev)
    dh_f = torch.randn(t, b, h, generator=g).to(dev)
    dh_b = torch.randn(t, b, h, generator=g).to(dev)
    with torch.no_grad():
        xp_f, xp_b = input_proj(layer.fw, x), input_proj(layer.bw, x)
        wh_f, wh_b = layer.fw.wh.detach(), layer.bw.wh.detach()
        fwd_args = (xp_f, xp_b, mask, wh_f, wh_b)
        bwd_args = (*fwd_args, *bilstm(*fwd_args), dh_f, dh_b)
        d_k = bilstm_bwd(*bwd_args)
        d_p = bilstm_bwd_plain(*bwd_args)
    bwd_errs = [float((k - p).abs().max()) for k, p in zip(d_k, d_p)]
    bwd_ok = all(within(k, p, BWD_ATOL, BWD_RTOL) for k, p in zip(d_k, d_p))
    # dwh through the Function against autograd through the plain loop
    w_k = [w.clone().requires_grad_() for w in (wh_f, wh_b)]
    w_p = [w.clone().requires_grad_() for w in (wh_f, wh_b)]
    h_k = BiLSTMFunction.apply(xp_f, xp_b, mask, *w_k)
    torch.autograd.backward(h_k, (dh_f, dh_b))
    h_p = bilstm_plain(xp_f, xp_b, mask, *w_p)
    torch.autograd.backward((h_p[0], h_p[2]), (dh_f, dh_b))
    dwh_err = max(float((a.grad - p.grad).abs().max() / p.grad.abs().max())
                  for a, p in zip(w_k, w_p))
    print(f"bilstm_bwd kernel vs plain: T={t} B={b} H={h} lengths "
          f"{int(lengths.min())}..{t} max_abs_err={max(bwd_errs):.3e} "
          f"(dxp_f {bwd_errs[0]:.2e} dxp_b {bwd_errs[1]:.2e}; max|dxp| "
          f"{max(float(p.abs().max()) for p in d_p):.2f}) (tol "
          f"{BWD_ATOL:g} + {BWD_RTOL:g}*|plain|); dwh via BiLSTMFunction vs "
          f"autograd through bilstm_plain: max err / max|dwh| = "
          f"{dwh_err:.3e} (tol {DWH_RTOL:g})")
    require(bwd_ok, "bilstm_bwd kernel disagrees with plain")
    require(dwh_err <= DWH_RTOL, "BiLSTMFunction dwh disagrees with autograd")

    vocab = NUM_CLASSES + 1
    logits = torch.randn(b, t, vocab, generator=g).to(dev)
    labels = torch.randint(0, NUM_CLASSES, (b, TRAIN_L), generator=g)
    lab_lens = torch.randint(TRAIN_L // 2, TRAIN_L + 1, (b,), generator=g)
    lab_lens[0] = TRAIN_L
    with torch.no_grad():
        lp_ext, valid, skip, end, ll = ctc.lattice(
            logits, lengths.to(dev), labels.to(dev), lab_lens.to(dev))
        s_len = lp_ext.shape[2]
        skip2 = ctc.skip_from_source(skip)
        end_ind = ctc.end_indicator(end, ll, s_len)
        a_k = ctc.ctc_alpha(lp_ext, valid, skip)
        a_p = ctc.ctc_alpha_plain(lp_ext, valid, skip)
        g_k = ctc.ctc_beta(lp_ext, valid, a_k, skip2, end_ind)
        g_p = ctc.ctc_beta_plain(lp_ext, valid, a_p, skip2, end_ind)
        ones = torch.ones(b, device=dev)
        dlp_k = ctc.posterior_grad(g_k, ctc.final_logp(a_k[-1], end, ll),
                                   ones)
        dlp_p = ctc.posterior_grad(g_p, ctc.final_logp(a_p[-1], end, ll),
                                   ones)
    require(ctc.ctc_design(s_len) == "warp",
            f"the main path's lattice (S={s_len}) does not take the warp "
            f"design")
    # the block design (csrc/ctc.cu) through its C entry points, from the
    # same inputs; the warp design's entry points, for the timings
    entry = {design: ctc_entries(lp_ext, valid, skip, skip2, end_ind,
                                 a_p, suffix)
             for design, suffix in (("warp", "_warp"), ("block", ""))}
    entry["block"]["ctc_alpha"]()
    entry["block"]["ctc_beta"]()
    with torch.no_grad():
        a_blk, g_blk = entry["block"]["outs"]()
        dlp_blk = ctc.posterior_grad(g_blk, ctc.final_logp(a_blk[-1], end,
                                                           ll), ones)
    ctc_errs = {}
    for design, (a_d, g_d, dlp_d) in (("warp", (a_k, g_k, dlp_k)),
                                      ("block", (a_blk, g_blk, dlp_blk))):
        alpha_floor, alpha_ok, alpha_err = ctc_compare(a_d, a_p)
        gamma_floor, gamma_ok, gamma_err = ctc_compare(g_d, g_p)
        dlp_err = float((dlp_d - dlp_p).abs().max())
        live = a_p > -5e29
        how = ("through the wrappers" if design == "warp" else
               "through its C entry points")
        print(f"ctc_alpha {design} design ({how}) vs plain: T={t} B={b} "
              f"S={s_len} label lengths {int(lab_lens.min())}..{TRAIN_L} "
              f"max_abs_err={alpha_err:.3e} above the floor (tol "
              f"{CTC_ATOL:g} + {CTC_RTOL:g}*|plain|; alpha there down to "
              f"{float(a_p[live].min()):.1f}); LOG_EPS entries equal: "
              f"{alpha_floor}")
        print(f"ctc_beta {design} design vs plain: gamma max_abs_err="
              f"{gamma_err:.3e} above the floor (same tol); LOG_EPS entries "
              f"equal: {gamma_floor}; dlp max_abs_err={dlp_err:.3e} (tol "
              f"{DLP_TOL:g})")
        require(alpha_floor and alpha_ok,
                f"ctc_alpha {design} design disagrees with plain")
        require(gamma_floor and gamma_ok,
                f"ctc_beta {design} design disagrees with plain")
        require(dlp_err <= DLP_TOL, f"ctc dlp ({design}) disagrees with "
                f"plain")
        ctc_errs[design] = (alpha_err, gamma_err)
    alpha_err, gamma_err = ctc_errs["warp"]
    check_ctc_beyond_cap(dev)

    bounds = {
        "bilstm_bwd": rnn_bound(xp_f, h, 2, 2, (*bwd_args, *d_k)),
        # a logadd3 (3 exp, a log, about 8 adds and compares) per entry
        "ctc_alpha": bound(12.0 * a_k.numel(), tensor_bytes(
            lp_ext, valid, skip, a_k)),
        "ctc_beta": bound(12.0 * g_k.numel(), tensor_bytes(
            lp_ext, valid, a_k, skip2, end_ind, g_k)),
    }
    lstm_y = rnn_yardsticks("lstm", layer, x, lengths.to(dev), mask)
    print_yardsticks(card, f"cuDNN nn.LSTM bidirectional, T={t} B={b} "
                     f"H={h}", lstm_y)
    ctc_y = ctc_yardsticks(logits, lengths.to(dev), labels.to(dev),
                           lab_lens.to(dev))
    print(f"[{card}] library yardstick, F.ctc_loss at T={t} B={b} "
          f"L={TRAIN_L}: forward {ctc_y['lib_fwd']:.4f} ms, forward + "
          f"backward {ctc_y['lib_fwd_bwd']:.4f} ms (backward alone "
          f"{ctc_y['lib_bwd']:.4f} ms); the port's ctc_loss forward "
          f"{ctc_y['port_fwd']:.4f} ms, forward + backward "
          f"{ctc_y['port_fwd_bwd']:.4f} ms; losses differ by "
          f"{ctc_y['loss_rel']:.3e} relative")
    require(ctc_y["loss_rel"] <= 1e-4, "ctc_loss disagrees with F.ctc_loss")
    library = {"bilstm_bwd": lstm_y["lib_bwd"],
               "ctc_alpha": ctc_y["lib_fwd"], "ctc_beta": ctc_y["lib_bwd"]}

    warp_ms = time_ctc_designs(card, entry, bounds, library, t, b, s_len)
    with torch.no_grad():
        times = {
            "bilstm_fwd": (cuda_ms(lambda: bilstm(*fwd_args), 10),
                           cuda_ms(lambda: bilstm_plain(*fwd_args), 2, 1)),
            "bilstm_bwd": (cuda_ms(lambda: bilstm_bwd(*bwd_args), 10),
                           cuda_ms(lambda: bilstm_bwd_plain(*bwd_args), 2,
                                   1)),
            "ctc_alpha": (warp_ms["ctc_alpha"],
                          cuda_ms(lambda: ctc.ctc_alpha_plain(
                              lp_ext, valid, skip), 2, 1)),
            "ctc_beta": (warp_ms["ctc_beta"],
                         cuda_ms(lambda: ctc.ctc_beta_plain(
                             lp_ext, valid, a_k, skip2, end_ind), 2, 1)),
        }
    for name, (k_ms, p_ms) in times.items():
        print(f"[{card}] {name} at T={t} B={b}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms")
    return {"errs": {"bilstm_bwd": max(bwd_errs), "ctc_alpha": alpha_err,
                     "ctc_beta": gamma_err},
            "times": times, "bounds": bounds, "library": library}


def ctc_entries(lp_ext, valid, skip, skip2, end_ind, alpha_in,
                suffix: str) -> dict:
    """The CTC kernels of one design through their C entry points
    (``suffix`` "_warp": csrc/ctc_warp.cu; "": csrc/ctc.cu), into outputs
    of their own, beta from ``alpha_in`` -> {"ctc_alpha": launch,
    "ctc_beta": launch, "outs": () -> (alpha, gamma)}.  They count no
    launch: the wrappers do."""
    from asr_study_torch import _build

    t, b, s = lp_ext.shape
    alpha, gamma = torch.empty_like(lp_ext), torch.empty_like(lp_ext)
    lib = _build.lib()

    def launch(name, *args):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(getattr(lib, name + suffix)(
            *(a.data_ptr() for a in args), t, b, s, stream), name + suffix)

    return {"ctc_alpha": lambda: launch("asr_ctc_alpha", lp_ext, valid, skip,
                                        alpha),
            "ctc_beta": lambda: launch("asr_ctc_beta", lp_ext, valid,
                                       alpha_in, skip2, end_ind, gamma),
            "outs": lambda: (alpha, gamma)}


def time_ctc_designs(card: str, entry: dict, bounds: dict, library: dict,
                     t: int, b: int, s_len: int) -> dict:
    """The CTC kernels' warp and block designs through their C entry
    points, timed in turns, warp, block, block, warp, 20 calls a turn ->
    the warp design's mean ms by kernel.  Prints both, µs a step, the
    bound, F.ctc_loss's time and the warp kernels' device time from the
    profiler."""
    turns = {k: {"warp": [], "block": []} for k in ("ctc_alpha", "ctc_beta")}
    for design in ("warp", "block", "block", "warp"):
        for name in turns:
            turns[name][design].append(cuda_ms(entry[design][name], 20))
    clk = sm_clock_hz()
    out = {}
    for name, by in turns.items():
        w_ms, b_ms = (sum(by[d]) / 2 for d in ("warp", "block"))
        dev_ms = kernel_device_ms(entry["warp"][name], 20, name + "_warp")
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        print(f"[{card}] {name} at T={t} B={b} S={s_len}, in turns: warp "
              f"design {by['warp'][0]:.4f} / {by['warp'][1]:.4f} ms, block "
              f"design {by['block'][0]:.4f} / {by['block'][1]:.4f} ms "
              f"({b_ms / w_ms:.2f}x); {1e3 * w_ms / t:.4f} us a step "
              f"({1e6 * w_ms / t * clk / 1e9:.0f} cycles at the SM clock "
              f"{clk / 1e6:.0f} MHz) against the block design's "
              f"{1e3 * b_ms / t:.4f}; the warp kernel's device time "
              f"{dev_txt} (torch.profiler); bound {bounds[name][0]:.4f} ms "
              f"({bounds[name][1]}); F.ctc_loss "
              f"{'forward' if name == 'ctc_alpha' else 'backward'} "
              f"{library[name]:.4f} ms ({library[name] / w_ms:.2f}x the "
              f"warp design)")
        out[name] = w_ms
    return out


def check_ctc_beyond_cap(dev: torch.device) -> None:
    """One lattice just above CTC_WARP_MAX_S states through the wrappers:
    the block design runs (by_design), and agrees with plain."""
    from asr_study_torch.ops import ctc

    g = torch.Generator().manual_seed(SEED + 3)
    b, l_max = 4, (ctc.CTC_WARP_MAX_S + 1) // 2
    t = 2 * l_max + 40
    lengths = torch.randint(t - 40, t + 1, (b,), generator=g)
    lab_lens = torch.randint(l_max // 2, l_max + 1, (b,), generator=g)
    lab_lens[0] = l_max
    with torch.no_grad():
        lp_ext, valid, skip, end, ll = ctc.lattice(
            torch.randn(b, t, NUM_CLASSES + 1, generator=g).to(dev),
            lengths.to(dev), torch.randint(0, NUM_CLASSES, (b, l_max),
                                           generator=g).to(dev),
            lab_lens.to(dev))
        s_len = lp_ext.shape[2]
        skip2 = ctc.skip_from_source(skip)
        end_ind = ctc.end_indicator(end, ll, s_len)
        before = (dict(ctc.ctc_alpha.by_design),
                  dict(ctc.ctc_beta.by_design))
        a_k = ctc.ctc_alpha(lp_ext, valid, skip)
        g_k = ctc.ctc_beta(lp_ext, valid, a_k, skip2, end_ind)
        after = (dict(ctc.ctc_alpha.by_design), dict(ctc.ctc_beta.by_design))
        a_p = ctc.ctc_alpha_plain(lp_ext, valid, skip)
        g_p = ctc.ctc_beta_plain(lp_ext, valid, a_p, skip2, end_ind)
    ran = [{d: n - was[d] for d, n in now.items() if n != was[d]}
           for was, now in zip(before, after)]
    a_floor, a_ok, a_err = ctc_compare(a_k, a_p)
    g_floor, g_ok, g_err = ctc_compare(g_k, g_p)
    print(f"ctc beyond the warp design's cap (CTC_WARP_MAX_S "
          f"{ctc.CTC_WARP_MAX_S}): T={t} B={b} S={s_len} through the "
          f"wrappers ran alpha {ran[0]}, beta {ran[1]}; vs plain alpha "
          f"max_abs_err={a_err:.3e}, gamma {g_err:.3e}, LOG_EPS entries "
          f"equal: {a_floor and g_floor}")
    require(ran == [{"block": 1}, {"block": 1}],
            f"S={s_len}: the wrappers ran {ran}, want the block design")
    require(a_floor and a_ok and g_floor and g_ok,
            f"the block design at S={s_len} disagrees with plain")


def check_gru_kernels(dev: torch.device, card: str, x_serve: torch.Tensor,
                      len_serve: torch.Tensor) -> dict:
    """Phase 3 for the GRU kernels: bigru_fwd at the serving shapes (the
    check batch's features [T=805, B=32, 39] through layer 0 of a 3x256
    deep_gru, ragged lengths), and bigru_bwd, gru_fwd and gru_bwd at the
    config-3 shapes (T=512, B=32, H=256, lengths 256-512); each against its
    plain version, dwh through BiGRUFunction / GRUFunction against autograd
    through the plain loops, timed, with its bound and its library call."""
    from asr_study_torch.models.zoo import deep_gru
    from asr_study_torch.ops.gru import (BiGRUFunction, GRUFunction, bigru,
                                         bigru_bwd, bigru_bwd_plain,
                                         bigru_plain, gru, gru_bwd,
                                         gru_bwd_plain, gru_plain)

    g = torch.Generator().manual_seed(SEED + 3)
    h = HIDDEN

    def layer0(bidirectional: bool):
        return deep_gru(f"num_hiddens={h},num_layers=1,bidirectional="
                        f"{str(bidirectional).lower()}", input_dim=FEATS,
                        generator=g, device=dev).rnn.layers[0].rnn

    def dwh_err(fn, plain_fn, xps, mask, whs, dhs):
        """max |dwh kernel - dwh autograd(plain)| / max |dwh|"""
        w_k = [w.clone().requires_grad_() for w in whs]
        w_p = [w.clone().requires_grad_() for w in whs]
        torch.autograd.backward(fn(*xps, mask, *w_k), dhs)
        torch.autograd.backward(plain_fn(*xps, mask, *w_p), dhs)
        return max(float((a.grad - p.grad).abs().max()
                         / p.grad.abs().max()) for a, p in zip(w_k, w_p))

    def max_err(got, want):
        return max(float((k - p).abs().max()) for k, p in zip(got, want))

    errs, times, bounds, library = {}, {}, {}, {}

    # bigru_fwd at the serving shapes
    bi = layer0(True)
    t_s = x_serve.shape[0]
    mask_s = mask_of(len_serve, t_s, dev)
    fwd_s = (input_proj(bi.fw, x_serve), input_proj(bi.bw, x_serve),
             mask_s, bi.fw.wh.detach(), bi.bw.wh.detach())
    with torch.no_grad():
        got, want = bigru(*fwd_s), bigru_plain(*fwd_s)
        times["bigru_fwd"] = (cuda_ms(lambda: bigru(*fwd_s), 10),
                              cuda_ms(lambda: bigru_plain(*fwd_s), 2, 1))
    errs["bigru_fwd"] = max_err(got, want)
    bounds["bigru_fwd"] = rnn_bound(fwd_s[0], h, 2, 1, (*fwd_s, *got))
    print(f"bigru_fwd kernel vs plain: T={t_s} B={BATCH} H={h} lengths "
          f"{int(len_serve.min())}..{int(len_serve.max())} "
          f"max_abs_err={errs['bigru_fwd']:.3e} (tol {GRU_ATOL:g} + "
          f"{GRU_RTOL:g}*|plain|)")
    require(all(within(k, p, GRU_ATOL, GRU_RTOL) for k, p in zip(got, want)),
            "bigru_fwd kernel disagrees with plain")
    y = rnn_yardsticks("gru", bi, x_serve, len_serve, mask_s)
    print_yardsticks(card, f"cuDNN nn.GRU bidirectional, T={t_s} B={BATCH} "
                     f"H={h}", y)
    require(y["out_err"] <= LOGITS_TOL, "layer disagrees with nn.GRU")
    library["bigru_fwd"] = y["lib_fwd"]

    # the training shapes: both directions, then one
    t, b = TRAIN_T, TRAIN_B
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g)
    lengths[0] = t
    x = torch.randn(t, b, FEATS, generator=g).to(dev)
    mask = mask_of(lengths, t, dev)
    dh = [torch.randn(t, b, h, generator=g).to(dev) for _ in range(2)]
    uni = layer0(False)
    cases = {
        # name: (layer, xps, whs, forward, its plain, backward, its plain,
        #        differentiable op, plain op)
        "bigru": (bi, [input_proj(bi.fw, x), input_proj(bi.bw, x)],
                  [bi.fw.wh.detach(), bi.bw.wh.detach()], bigru, bigru_plain,
                  bigru_bwd, bigru_bwd_plain, BiGRUFunction.apply,
                  bigru_plain),
        "gru": (uni, [input_proj(uni.fw, x)], [uni.fw.wh.detach()], gru,
                gru_plain, gru_bwd, gru_bwd_plain, GRUFunction.apply,
                gru_plain),
    }
    for name, (layer, xps, whs, fwd, fwd_plain, bwd, bwd_plain, fn,
               plain_fn) in cases.items():
        n = len(xps)
        fwd_args = (*xps, mask, *whs)
        with torch.no_grad():
            hs = fwd(*fwd_args)
            hs = hs if n == 2 else (hs,)
            hs_p = fwd_plain(*fwd_args)
            hs_p = hs_p if n == 2 else (hs_p,)
            bwd_args = (*xps, mask, *whs, *hs, *dh[:n])
            d_k, d_p = bwd(*bwd_args), bwd_plain(*bwd_args)
            times[f"{name}_bwd"] = (cuda_ms(lambda: bwd(*bwd_args), 10),
                                    cuda_ms(lambda: bwd_plain(*bwd_args), 2,
                                            1))
            if n == 1:
                times["gru_fwd"] = (cuda_ms(lambda: fwd(*fwd_args), 10),
                                    cuda_ms(lambda: fwd_plain(*fwd_args), 2,
                                            1))
        if n == 1:
            errs["gru_fwd"] = max_err(hs, hs_p)
            bounds["gru_fwd"] = rnn_bound(xps[0], h, 1, 1, (*fwd_args, *hs))
            print(f"gru_fwd kernel vs plain: T={t} B={b} H={h} "
                  f"max_abs_err={errs['gru_fwd']:.3e} (tol {GRU_ATOL:g} + "
                  f"{GRU_RTOL:g}*|plain|)")
            require(within(hs[0], hs_p[0], GRU_ATOL, GRU_RTOL),
                    "gru_fwd kernel disagrees with plain")
        errs[f"{name}_bwd"] = max_err(d_k, d_p)
        bounds[f"{name}_bwd"] = rnn_bound(xps[0], h, n, 2, (*bwd_args, *d_k))
        d_err = dwh_err(fn, plain_fn, xps, mask, whs, dh[:n])
        print(f"{name}_bwd kernel vs plain: T={t} B={b} H={h} lengths "
              f"{int(lengths.min())}..{t} max_abs_err over dxp and dhp "
              f"{errs[f'{name}_bwd']:.3e} (max|dxp| "
              f"{max(float(p.abs().max()) for p in d_p):.2f}; tol "
              f"{BWD_ATOL:g} + {BWD_RTOL:g}*|plain|); dwh via "
              f"{fn.__self__.__name__} vs autograd through {plain_fn.__name__}"
              f": max err / max|dwh| = {d_err:.3e} (tol {DWH_RTOL:g})")
        require(all(within(k, p, BWD_ATOL, BWD_RTOL)
                    for k, p in zip(d_k, d_p)),
                f"{name}_bwd kernel disagrees with plain")
        require(d_err <= DWH_RTOL, f"{name} dwh disagrees with autograd")
        y = rnn_yardsticks("gru", layer, x, lengths.to(dev), mask)
        print_yardsticks(card, f"cuDNN nn.GRU {'bi' if n == 2 else 'uni'}"
                         f"directional, T={t} B={b} H={h}", y)
        require(y["out_err"] <= LOGITS_TOL, "layer disagrees with nn.GRU")
        library[f"{name}_bwd"] = y["lib_bwd"]
        if n == 1:
            library["gru_fwd"] = y["lib_fwd"]
    for name, (k_ms, p_ms) in times.items():
        print(f"[{card}] {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]}), library "
              f"{library[name]:.4f} ms")
    return {"errs": errs, "times": times, "bounds": bounds,
            "library": library}


def print_cluster_geometry() -> None:
    """The LSTM, GRU, layer-norm, zoneout and MI LSTM kernels' design at
    each width of the zoo (and H=100) and each direction count, at B=32:
    the cluster (or, for the LSTM and the GRU at H=512, the wide) geometry
    and shared memory, held against the kernels' own launch configuration
    (asr_{bilstm,gru,ln_lstm,zoneout_lstm,mi_lstm,lstm_wide,gru_wide}_
    {fwd,bwd}_info), and the clusters the card holds at once against those
    the launch needs."""
    from asr_study_torch.ops.bilstm import (CLUSTER_THREADS, cluster_info,
                                            lstm_geometry)
    from asr_study_torch.ops.gru import (GRU_THREADS, GRU_WIDE_SPLIT,
                                         gru_cluster_info, gru_geometry)
    from asr_study_torch.ops.ln_lstm import ln_cluster_info, ln_geometry
    from asr_study_torch.ops.mi_lstm import mi_cluster_info, mi_geometry
    from asr_study_torch.ops.zoneout_lstm import (zoneout_cluster_info,
                                                  zoneout_geometry)

    # bi name, uni name, geometry, info, source stem and threads a CTA
    # (forward / backward) by design
    lstm_threads = f"{CLUSTER_THREADS} / {CLUSTER_THREADS}"
    families = (("bilstm", "lstm", lstm_geometry, cluster_info,
                 {"cluster": ("bilstm", lstm_threads),
                  "wide": ("lstm_wide", "256 / 256"),
                  "stream": ("lstm_stream", "")}),
                ("bigru", "gru", gru_geometry, gru_cluster_info,
                 {"cluster": ("gru", f"{GRU_THREADS} / {GRU_THREADS}"),
                  "wide": ("gru_wide", f"{96 * GRU_WIDE_SPLIT} / 256"),
                  "stream": ("gru_stream", "")}),
                ("bi_ln_lstm", "ln_lstm", ln_geometry, ln_cluster_info,
                 {"cluster": ("ln_lstm", lstm_threads),
                  "stream": ("ln_lstm_stream", "")}),
                ("bi_zoneout_lstm", "zoneout_lstm", zoneout_geometry,
                 zoneout_cluster_info,
                 {"cluster": ("zoneout_lstm", lstm_threads),
                  "stream": ("zoneout_lstm_stream", "")}),
                ("bi_mi_lstm", "mi_lstm", mi_geometry, mi_cluster_info,
                 {"cluster": ("mi_lstm", lstm_threads),
                  "stream": ("mi_lstm_stream", "")}))
    for bi, uni, geometry, info, designs in families:
        for hidden in (100, HIDDEN, 512):
            for ndir in (2, 1):
                geo = geometry(hidden, BATCH, ndir)
                names = bi if ndir == 2 else uni
                src, threads = designs[geo.design]
                if geo.design == "stream":
                    print(f"  {names}_fwd/_bwd at H={hidden}, B={BATCH}: "
                          f"stream design (csrc/{src}_*.cu), grid "
                          f"{geo.grid} of {geo.rows}-row blocks, dynamic "
                          f"shared memory {geo.smem_fwd} / {geo.smem_bwd} B "
                          f"a block")
                    continue
                (fwd_b, fwd_fit), (bwd_b, bwd_fit) = (
                    info(geo, BATCH, hidden, bwd) for bwd in (False, True))
                clusters = geo.grid[1] * geo.grid[2]
                print(f"  {names}_fwd/_bwd at H={hidden}, B={BATCH}: "
                      f"{geo.design} design (csrc/{src}_*.cu), {clusters} "
                      f"clusters of {geo.ctas} CTAs x {threads} "
                      f"threads (fwd / bwd), grid {geo.grid}, {geo.units} "
                      f"units and "
                      f"{geo.rows} rows a CTA; dynamic shared memory "
                      f"{fwd_b} / {bwd_b} B a CTA (of 232448), the card "
                      f"holds {fwd_fit} / {bwd_fit} such clusters at once "
                      f"(cudaOccupancyMaxActiveClusters)")
                require((fwd_b, bwd_b) == (geo.smem_fwd, geo.smem_bwd),
                        f"{names} geometry's shared memory at H={hidden} "
                        f"differs from the kernels' own")
                require(min(fwd_fit, bwd_fit) >= clusters,
                        f"the {names} clusters at H={hidden} do not fit in "
                        f"one wave")


def time_in_turns(card: str, label: str, cluster_fn, stream_fn, steps: int,
                  geo, passes: int, rest: str, gates: int = 4,
                  library: tuple[str, float] | None = None,
                  hidden: int = HIDDEN) -> float:
    """One kernel's resident design (``geo.design``: cluster or wide) and
    the stream design timed in turns, resident, stream, stream, resident,
    5 calls a turn, at H=``hidden`` and B=BATCH -> the resident design's
    mean ms.  Prints both, the library call's time where there is one
    (``library``: its name and ms in this run), and the resident design's
    step split into the FMA time of one CTA's slice (``passes`` [R, H] x
    [H, gates*U] products a step in the layout ``geo``, at 128 FMAs a
    clock and the card's SM clock) and the ``rest``."""
    turns = {"cluster": [], "stream": []}
    for design in ("cluster", "stream", "stream", "cluster"):
        turns[design].append(cuda_ms(
            cluster_fn if design == "cluster" else stream_fn, 5))
    clk = sm_clock_hz()
    fmas = passes * geo.rows * hidden * gates * geo.units
    c_ms = sum(turns["cluster"]) / 2
    s_ms = sum(turns["stream"]) / 2
    step_us = 1e3 * c_ms / steps
    fma_us = 1e6 * fmas / (128 * clk)
    lib = ("" if library is None else
           f"{library[0]} {library[1]:.4f} ms ({library[1] / c_ms:.2f}x the "
           f"{geo.design} design); ")
    print(f"[{card}] {label} at H={hidden} T={steps} B={BATCH} "
          f"(R={geo.rows}), in turns: {geo.design} design "
          f"{turns['cluster'][0]:.4f} / {turns['cluster'][1]:.4f} ms, "
          f"stream design {turns['stream'][0]:.4f} / "
          f"{turns['stream'][1]:.4f} ms ({s_ms / c_ms:.2f}x); {lib}"
          f"{step_us:.3f} us a step, of which the {fmas} FMAs of one "
          f"CTA's slice take {fma_us:.3f} us at 128 a clock and the SM "
          f"clock {clk / 1e6:.0f} MHz, the rest ({rest}) "
          f"{step_us - fma_us:.3f} us")
    return c_ms


def ln_smem(hidden: int) -> tuple[int, int, int]:
    """Dynamic shared memory per block of the layer-norm LSTM's stream
    route (csrc/ln_lstm_stream_{fwd,bwd}.cu: the widths whose weights do
    not fit in a cluster, and the design the cluster one is timed against)
    at width ``hidden`` -> (forward bytes, backward bytes, the backward's
    partial sums per unit)."""
    from asr_study_torch.ops.ln_lstm import ln_stream_smem

    threads = min(-(-4 * hidden // 32) * 32, 1024)
    return (*ln_stream_smem(hidden), max(threads // hidden, 1))


def ln_stepwise(args, outs) -> list:
    """The layer-norm LSTM's plain step from the kernel's own previous state
    at every frame at once, each direction -> (h, c) per direction,
    flattened as the kernel's outputs; ``args`` the op's (xpn..., mask, wh,
    gh, gc, bc paired by direction), ``outs`` the kernel's (h, c...)."""
    from asr_study_torch.models.cells import ln_lstm_step
    from asr_study_torch.ops.recurrence import prev

    n = len(outs) // 2
    xpns, mask_ = args[:n], args[n]
    vecs = args[n + 1:]
    steps = []
    for d in range(n):
        wh, gh, gc, bc = vecs[d::n]
        h_k, c_k = outs[2 * d], outs[2 * d + 1]
        h = h_k.shape[2]
        tb = h_k.shape[0] * h_k.shape[1]
        h_s, c_s = ln_lstm_step(
            prev(h_k, d == 1).reshape(tb, h), prev(c_k, d == 1).reshape(
                tb, h), xpns[d].reshape(tb, 4 * h), mask_.reshape(tb, 1),
            wh, gh, gc, bc)
        steps += [h_s.view_as(h_k), c_s.view_as(c_k)]
    return steps


def rows_within(got, want, atol: float, rtol: float) -> bool:
    """Every (frame, row) vector: ||got - want|| <= atol + rtol *
    ||want||."""
    return all(bool(((k - p).norm(dim=-1) <= atol + rtol * p.norm(
        dim=-1)).all()) for k, p in zip(got, want))


def check_ln_kernels(dev: torch.device, card: str, x_serve: torch.Tensor,
                     len_serve: torch.Tensor) -> dict:
    """Phase 3 for the layer-norm LSTM kernels.

    bi_ln_lstm_fwd and ln_lstm_fwd at the serving shapes (the check batch's
    features [T=805, B=32, 39] through layer 0 of a 3x256 ln_blstm, both
    directions and one, ragged lengths), every frame against the plain
    step from the kernel's own previous state; bi_ln_lstm_bwd and
    ln_lstm_bwd at the config-3 shapes (T=512, B=32, H=256, lengths
    256-512) against their plain versions row by row; dwh, dgh, dgc and dbc
    through BiLNLSTMFunction / LNLSTMFunction against autograd through the
    plain loops on the first LN_CHECK_T frames; each in the design
    ``ln_geometry`` gives (the cluster one at H=256: held by the by-design
    counts) and timed with its plain version and its bound, and in turns
    (cluster, stream, stream, cluster) against the stream design (its C
    entry point, through ``launch_fwd`` / ``launch_bwd``, which count no
    launch), with the per-step time split into the FMA time of one CTA's
    slice at the card's SM clock and the rest.  The LN gains and biases are
    moved off their init (1 and 0) by seeded noise, so that every vector
    the kernels take matters."""
    from asr_study_torch.models.zoo import ln_blstm
    from asr_study_torch.ops.ln_lstm import (BiLNLSTMFunction, LNLSTMFunction,
                                             bi_ln_lstm, bi_ln_lstm_bwd,
                                             bi_ln_lstm_bwd_plain,
                                             bi_ln_lstm_plain, launch_bwd,
                                             launch_fwd, ln_geometry, ln_lstm,
                                             ln_lstm_bwd, ln_lstm_bwd_plain,
                                             ln_lstm_plain,
                                             ln_stream_geometry)

    g = torch.Generator().manual_seed(SEED + 7)
    h = HIDDEN

    def layer0(bidirectional: bool):
        layer = ln_blstm(f"num_hiddens={h},num_layers=1,bidirectional="
                         f"{str(bidirectional).lower()}", input_dim=FEATS,
                         generator=g, device=dev).rnn.layers[0].rnn
        with torch.no_grad():
            for cell in [layer.fw] + ([layer.bw] if bidirectional else []):
                for ln in (cell.ln_x, cell.ln_h, cell.ln_c):
                    for v in ln.values():
                        v.add_(0.1 * torch.randn(v.shape, generator=g).to(dev))
        return layer

    def prepared(layer, x):
        """xpn of each direction, and the resident arguments in the order
        the ops take them (wh, gh, gc, bc; each forward, then backward)."""
        cells = [layer.fw] + ([layer.bw] if layer.bidirectional else [])
        with torch.no_grad():
            preps = [c.prepare(x) for c in cells]
        return ([p[0] for p in preps],
                [a.detach() for vecs in zip(*(p[1] for p in preps))
                 for a in vecs])

    def max_err(got, want):
        return max(float((k - p).abs().max()) for k, p in zip(got, want))

    def ran_design(wrapper, before, ndir, batch):
        """The wrapper launched once since ``before`` (its by-design counts),
        in the design ln_geometry gives."""
        want = ln_geometry(h, batch, ndir).design
        after = dict(wrapper.by_design)
        require(after[want] == before[want] + 1 and sum(after.values())
                == sum(before.values()) + 1,
                f"{wrapper.__name__} ran {after} (before {before}), want one "
                f"more launch of the {want} design")
        return want

    def in_turns(label, cluster_fn, stream_fn, steps, ndir, passes):
        return time_in_turns(card, label, cluster_fn, stream_fn, steps,
                             ln_geometry(h, BATCH, ndir), passes,
                             "statistics, exchange, barriers, cell, loads")

    errs, times, bounds = {}, {}, {}
    cases = {
        # name: (layer, forward, its plain, backward, its plain, Function)
        "bi_ln_lstm": (layer0(True), bi_ln_lstm, bi_ln_lstm_plain,
                       bi_ln_lstm_bwd, bi_ln_lstm_bwd_plain,
                       BiLNLSTMFunction),
        "ln_lstm": (layer0(False), ln_lstm, ln_lstm_plain, ln_lstm_bwd,
                    ln_lstm_bwd_plain, LNLSTMFunction),
    }
    t_s = x_serve.shape[0]
    mask_s = mask_of(len_serve, t_s, dev)
    t, b = TRAIN_T, TRAIN_B
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g)
    lengths[0] = t
    x = torch.randn(t, b, FEATS, generator=g).to(dev)
    mask = mask_of(lengths, t, dev)
    dh = [torch.randn(t, b, h, generator=g).to(dev) for _ in range(2)]
    for name, (layer, fwd, fwd_plain, bwd, bwd_plain, fn) in cases.items():
        # the forward at the serving shapes
        xpns, res = prepared(layer, x_serve)
        n = len(xpns)
        args = (*xpns, mask_s, *res)
        # wh, gh, gc, bc, each a list over the directions
        groups = [list(res[i * n: (i + 1) * n]) for i in range(4)]
        with torch.no_grad():
            before = dict(fwd.by_design)
            got, want = fwd(*args), fwd_plain(*args)
            torch.cuda.synchronize()
            design = ran_design(fwd, before, n, BATCH)
            steps = ln_stepwise(args, got)
            # the recurrence's own fp32 spread: h of each fp32 run against
            # a float64 run of the plain loop (printed, not held)
            ref = fwd_plain(*(a.double() for a in args))[0::2]
            cpu = fwd_plain(*(a.cpu() for a in args))[0::2]
            drift = [max_err([r.double().to(dev) for r in run], ref)
                     for run in (got[0::2], want[0::2], cpu)]
            times[f"{name}_fwd"] = (
                in_turns(f"{name}_fwd", lambda: fwd(*args),
                         lambda: launch_fwd(ln_stream_geometry(h, BATCH, n),
                                            list(xpns), mask_s, *groups),
                         t_s, n, 1),
                cuda_ms(lambda: fwd_plain(*args), 2, 1))
        errs[f"{name}_fwd"] = max_err(got, steps)
        bounds[f"{name}_fwd"] = rnn_bound(xpns[0], h, n, 1, (*args, *got))
        print(f"{name}_fwd kernel ({design} design) vs the plain step from "
              f"its own state, every frame: T={t_s} B={BATCH} H={h} lengths "
              f"{int(len_serve.min())}..{int(len_serve.max())} "
              f"max_abs_err={errs[f'{name}_fwd']:.3e} (h "
              f"{max_err(got[0::2], steps[0::2]):.2e} c "
              f"{max_err(got[1::2], steps[1::2]):.2e}; max|c| "
              f"{max(float(c.abs().max()) for c in got[1::2]):.2f}) (tol "
              f"{BILSTM_ATOL:g} + {BILSTM_RTOL:g}*|plain|); the whole "
              f"trajectories of kernel and plain loop part by "
              f"{max_err(got, want):.3e} (h "
              f"{max_err(got[0::2], want[0::2]):.2e}); h against a float64 "
              f"run of the plain loop: kernel {drift[0]:.2e}, plain loop on "
              f"the card {drift[1]:.2e}, on the CPU {drift[2]:.2e}")
        require(all(within(k, p, BILSTM_ATOL, BILSTM_RTOL)
                    for k, p in zip(got, steps)),
                f"{name}_fwd kernel disagrees with the plain step")

        # the backward at the training shapes
        xpns, res = prepared(layer, x)
        args = (*xpns, mask, *res)
        groups = [list(res[i * n: (i + 1) * n]) for i in range(4)]
        with torch.no_grad():
            hc = fwd(*args)
            bwd_args = (*args, *hc, *dh[:n])
            before = dict(bwd.by_design)
            d_k, d_p = bwd(*bwd_args), bwd_plain(*bwd_args)
            torch.cuda.synchronize()
            design = ran_design(bwd, before, n, b)
            times[f"{name}_bwd"] = (
                in_turns(f"{name}_bwd", lambda: bwd(*bwd_args),
                         lambda: launch_bwd(ln_stream_geometry(h, b, n),
                                            list(xpns), mask, *groups,
                                            list(hc[0::2]), list(hc[1::2]),
                                            dh[:n]),
                         t, n, 2),
                cuda_ms(lambda: bwd_plain(*bwd_args), 2, 1))
        errs[f"{name}_bwd"] = max_err(d_k, d_p)
        bounds[f"{name}_bwd"] = rnn_bound(xpns[0], h, n, 2,
                                          (*bwd_args, *d_k))
        row_rel = max(float(((k - p).norm(dim=-1) / p.norm(dim=-1).clamp(
            min=1e-30)).max()) for k, p in zip(d_k, d_p))
        # the parameter gradients through the Function against autograd
        # through the plain loop, on the first LN_CHECK_T frames
        cut = [a[:LN_CHECK_T] for a in (*xpns, mask, *dh[:n])]
        w_k = [a.clone().requires_grad_() for a in res]
        w_p = [a.clone().requires_grad_() for a in res]
        outs = fn.apply(*cut[:n], cut[n], *w_k)
        torch.autograd.backward(outs if n == 2 else (outs,), cut[n + 1:])
        torch.autograd.backward(fwd_plain(*cut[:n], cut[n], *w_p)[0::2],
                                cut[n + 1:])
        p_errs = [float((a.grad - p.grad).abs().max() / p.grad.abs().max())
                  for a, p in zip(w_k, w_p)]
        by_kind = {k: max(p_errs[i * n: (i + 1) * n])
                   for i, k in enumerate(("dwh", "dgh", "dgc", "dbc"))}
        print(f"{name}_bwd kernel ({design} design) vs plain: T={t} B={b} "
              f"H={h} lengths {int(lengths.min())}..{t} max_abs_err over "
              f"dpre and dcn {errs[f'{name}_bwd']:.3e} at max|dpre| "
              f"{max(float(p.abs().max()) for p in d_p[0::2]):.4g}; worst "
              f"(frame, row) ||diff||/||plain|| {row_rel:.3e} (tol "
              f"{BWD_ATOL:g} + {BWD_RTOL:g}*||plain||); via {fn.__name__} "
              f"vs autograd through {fwd_plain.__name__} at T={LN_CHECK_T}, "
              f"max err / max|grad|: "
              + ", ".join(f"{k} {v:.3e}" for k, v in by_kind.items())
              + f" (tol {DWH_RTOL:g})")
        require(rows_within(d_k, d_p, BWD_ATOL, BWD_RTOL),
                f"{name}_bwd kernel disagrees with plain")
        require(max(p_errs) <= DWH_RTOL,
                f"{fn.__name__} parameter gradients disagree with autograd")
    print("layer-norm LSTM library yardstick: none; no PyTorch call computes "
          "an LN-LSTM (cuDNN's nn.LSTM has no layer norm), so library_ms is "
          "null for its four kernels")
    for name, (k_ms, p_ms) in times.items():
        print(f"[{card}] {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]})")
    return {"errs": errs, "times": times, "bounds": bounds,
            "library": dict.fromkeys(times)}


def check_lstm_kernels(dev: torch.device, card: str, x_serve: torch.Tensor,
                       len_serve: torch.Tensor) -> dict:
    """Phase 3 for the one-direction LSTM kernels, and for the two-direction
    ones at the zoo's other widths.

    lstm_fwd at the serving shapes (the check batch's features [T=805,
    B=32, 39] through layer 0 of a unidirectional 3x256 deep_blstm, ragged
    lengths) and lstm_bwd at the config-3 shapes (T=512, B=32, H=256,
    lengths 256-512), each against its plain version, dwh through
    LSTMFunction against autograd through lstm_plain, timed with its bound
    and cuDNN's unidirectional ``nn.LSTM``.  Then bilstm_fwd (T=805) and
    bilstm_bwd (T=512) at H=100 (graves2006's width) against their plain
    versions, timed; their xp come from the features through a layer of
    that width.  H=512 is ``check_lstm_wide``'s."""
    from asr_study_torch.models.zoo import deep_blstm
    from asr_study_torch.ops.bilstm import (LSTMFunction, bilstm, bilstm_bwd,
                                            bilstm_bwd_plain, bilstm_plain,
                                            lstm, lstm_bwd, lstm_bwd_plain,
                                            lstm_plain)

    g = torch.Generator().manual_seed(SEED + 6)

    def layer0(hidden: int, bidirectional: bool):
        return deep_blstm(f"num_hiddens={hidden},num_layers=1,bidirectional="
                          f"{str(bidirectional).lower()}", input_dim=FEATS,
                          generator=g, device=dev).rnn.layers[0].rnn

    def max_err(got, want):
        return max(float((k - p).abs().max()) for k, p in zip(got, want))

    errs, times, bounds, library = {}, {}, {}, {}

    # lstm_fwd at the serving shapes
    uni = layer0(HIDDEN, False)
    t_s = x_serve.shape[0]
    mask_s = mask_of(len_serve, t_s, dev)
    fwd_s = (input_proj(uni.fw, x_serve), mask_s, uni.fw.wh.detach())
    with torch.no_grad():
        got, want = lstm(*fwd_s), lstm_plain(*fwd_s)
        times["lstm_fwd"] = (cuda_ms(lambda: lstm(*fwd_s), 10),
                             cuda_ms(lambda: lstm_plain(*fwd_s), 2, 1))
    errs["lstm_fwd"] = max_err(got, want)
    bounds["lstm_fwd"] = rnn_bound(fwd_s[0], HIDDEN, 1, 1, (*fwd_s, *got))
    print(f"lstm_fwd kernel vs plain: T={t_s} B={BATCH} H={HIDDEN} lengths "
          f"{int(len_serve.min())}..{int(len_serve.max())} "
          f"max_abs_err={errs['lstm_fwd']:.3e} (h "
          f"{max_err(got[:1], want[:1]):.2e} c "
          f"{max_err(got[1:], want[1:]):.2e}; max|c| "
          f"{float(want[1].abs().max()):.2f}) (tol {BILSTM_ATOL:g} + "
          f"{BILSTM_RTOL:g}*|plain|)")
    require(all(within(k, p, BILSTM_ATOL, BILSTM_RTOL)
                for k, p in zip(got, want)),
            "lstm_fwd kernel disagrees with plain")
    y = rnn_yardsticks("lstm", uni, x_serve, len_serve, mask_s)
    print_yardsticks(card, f"cuDNN nn.LSTM unidirectional, T={t_s} "
                     f"B={BATCH} H={HIDDEN}", y)
    require(y["out_err"] <= LOGITS_TOL, "layer disagrees with nn.LSTM")
    library["lstm_fwd"] = y["lib_fwd"]

    # lstm_bwd at the training shapes
    t, b = TRAIN_T, TRAIN_B
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g)
    lengths[0] = t
    x = torch.randn(t, b, FEATS, generator=g).to(dev)
    mask = mask_of(lengths, t, dev)
    dh = torch.randn(t, b, HIDDEN, generator=g).to(dev)
    xp, wh = input_proj(uni.fw, x), uni.fw.wh.detach()
    with torch.no_grad():
        bwd_args = (xp, mask, wh, *lstm(xp, mask, wh), dh)
        d_k, d_p = lstm_bwd(*bwd_args), lstm_bwd_plain(*bwd_args)
        times["lstm_bwd"] = (cuda_ms(lambda: lstm_bwd(*bwd_args), 10),
                             cuda_ms(lambda: lstm_bwd_plain(*bwd_args), 2,
                                     1))
    errs["lstm_bwd"] = float((d_k - d_p).abs().max())
    bounds["lstm_bwd"] = rnn_bound(xp, HIDDEN, 1, 2, (*bwd_args, d_k))
    w_k, w_p = wh.clone().requires_grad_(), wh.clone().requires_grad_()
    torch.autograd.backward(LSTMFunction.apply(xp, mask, w_k), dh)
    torch.autograd.backward(lstm_plain(xp, mask, w_p)[0], dh)
    dwh_err = float((w_k.grad - w_p.grad).abs().max() / w_p.grad.abs().max())
    print(f"lstm_bwd kernel vs plain: T={t} B={b} H={HIDDEN} lengths "
          f"{int(lengths.min())}..{t} max_abs_err={errs['lstm_bwd']:.3e} "
          f"(max|dxp| {float(d_p.abs().max()):.2f}; tol {BWD_ATOL:g} + "
          f"{BWD_RTOL:g}*|plain|); dwh via LSTMFunction vs autograd through "
          f"lstm_plain: max err / max|dwh| = {dwh_err:.3e} (tol "
          f"{DWH_RTOL:g})")
    require(within(d_k, d_p, BWD_ATOL, BWD_RTOL),
            "lstm_bwd kernel disagrees with plain")
    require(dwh_err <= DWH_RTOL, "LSTMFunction dwh disagrees with autograd")
    y = rnn_yardsticks("lstm", uni, x, lengths.to(dev), mask)
    print_yardsticks(card, f"cuDNN nn.LSTM unidirectional, T={t} B={b} "
                     f"H={HIDDEN}", y)
    require(y["out_err"] <= LOGITS_TOL, "layer disagrees with nn.LSTM")
    library["lstm_bwd"] = y["lib_bwd"]
    for name in ("lstm_fwd", "lstm_bwd"):
        k_ms, p_ms = times[name]
        print(f"[{card}] {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]}), library "
              f"{library[name]:.4f} ms")

    # the two-direction kernels at graves2006's width
    for hidden, model in ((100, "graves2006"),):
        bi = layer0(hidden, True)
        fwd_args = (input_proj(bi.fw, x_serve), input_proj(bi.bw, x_serve),
                    mask_s, bi.fw.wh.detach(), bi.bw.wh.detach())
        train_fwd = (input_proj(bi.fw, x), input_proj(bi.bw, x), mask,
                     bi.fw.wh.detach(), bi.bw.wh.detach())
        dhs = [torch.randn(t, b, hidden, generator=g).to(dev)
               for _ in range(2)]
        with torch.no_grad():
            got, want = bilstm(*fwd_args), bilstm_plain(*fwd_args)
            bwd_args = (*train_fwd, *bilstm(*train_fwd), *dhs)
            d_k, d_p = bilstm_bwd(*bwd_args), bilstm_bwd_plain(*bwd_args)
            fwd_ms = (cuda_ms(lambda: bilstm(*fwd_args), 5),
                      cuda_ms(lambda: bilstm_plain(*fwd_args), 1, 1))
            bwd_ms = (cuda_ms(lambda: bilstm_bwd(*bwd_args), 5),
                      cuda_ms(lambda: bilstm_bwd_plain(*bwd_args), 1, 1))
        fwd_bound = rnn_bound(fwd_args[0], hidden, 2, 1, (*fwd_args, *got))
        bwd_bound = rnn_bound(train_fwd[0], hidden, 2, 2, (*bwd_args, *d_k))
        max_c = max(float(want[1].abs().max()), float(want[3].abs().max()))
        print(f"bilstm_fwd kernel vs plain at H={hidden} ({model}'s width): "
              f"T={t_s} B={BATCH} max_abs_err={max_err(got, want):.3e} "
              f"(max|c| {max_c:.2f})"
              f" (tol {BILSTM_ATOL:g} + {BILSTM_RTOL:g}*|plain|); bilstm_bwd "
              f"at T={t} B={b}: max_abs_err={max_err(d_k, d_p):.3e} (max|dxp| "
              f"{max(float(p.abs().max()) for p in d_p):.2f}; tol "
              f"{BWD_ATOL:g} + {BWD_RTOL:g}*|plain|)")
        require(all(within(k, p, BILSTM_ATOL, BILSTM_RTOL)
                    for k, p in zip(got, want)),
                f"bilstm_fwd kernel disagrees with plain at H={hidden}")
        require(all(within(k, p, BWD_ATOL, BWD_RTOL)
                    for k, p in zip(d_k, d_p)),
                f"bilstm_bwd kernel disagrees with plain at H={hidden}")
        print(f"[{card}] bilstm_fwd at H={hidden}, T={t_s} B={BATCH}: kernel "
              f"{fwd_ms[0]:.4f} ms, plain {fwd_ms[1]:.4f} ms, bound "
              f"{fwd_bound[0]:.4f} ms ({fwd_bound[1]}); bilstm_bwd at "
              f"H={hidden}, T={t} B={b}: kernel {bwd_ms[0]:.4f} ms, plain "
              f"{bwd_ms[1]:.4f} ms, bound {bwd_bound[0]:.4f} ms "
              f"({bwd_bound[1]})")
    return {"errs": errs, "times": times, "bounds": bounds,
            "library": library}


def check_lstm_wide(dev: torch.device, card: str, x_serve: torch.Tensor,
                    len_serve: torch.Tensor) -> dict:
    """Phase 3 for the wide design of the LSTM kernels
    (csrc/lstm_wide_{fwd,bwd}.cu), at deep_speech's width H=512, two
    directions and one, B=32.

    The forward at the serving shapes (the check batch's features [T=805,
    B=32, 39] through a 512-unit layer, ragged lengths), as serving runs it
    (no gates), against its plain version at the BILSTM_* bounds, and as
    training runs it (``residual``, whose res holds the gates): h and c
    bit-equal to the serving run, the gates against the plain gates.  The
    backward at the config-3 shapes (T=512, lengths 256-512) from the card
    forward's res against the plain backward from the same gates and
    against the plain walk that recomputes them, both at the BWD_* bounds,
    dwh through the Function against autograd through the plain loop
    (DWH_RTOL).  The stream design (csrc/lstm_stream_{fwd,bwd}.cu, through
    its C entry point: the route of the batches the wide design cannot
    hold) on the same inputs against the same plain versions.  Each wide
    kernel timed in turns against the stream design (wide, stream, stream,
    wide), beside cuDNN ``nn.LSTM`` at the same shapes, timed twice in the
    run (the library time is the lower), the plain version and the bound:
    the forward's one product a step, the backward's one (``dpre @ wh^T``;
    its gates are an input) -> the kernel line's numbers for the four wide
    rows, which are the serving forward's; the training forward (which
    also writes the gates) timed and bounded beside it."""
    from asr_study_torch.models.zoo import deep_blstm
    from asr_study_torch.ops.bilstm import (BiLSTMFunction, LSTMFunction,
                                            bilstm, bilstm_bwd,
                                            bilstm_bwd_gates_plain,
                                            bilstm_bwd_plain, bilstm_plain,
                                            cluster_info, launch_bwd,
                                            launch_fwd, lstm, lstm_bwd,
                                            lstm_bwd_gates_plain,
                                            lstm_bwd_plain, lstm_geometry,
                                            lstm_plain, stream_geometry)

    h = 512
    g = torch.Generator().manual_seed(SEED + 14)
    t_s = x_serve.shape[0]
    mask_s = mask_of(len_serve, t_s, dev)
    t, b = TRAIN_T, TRAIN_B
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g)
    lengths[0] = t
    x = torch.randn(t, b, FEATS, generator=g).to(dev)
    mask = mask_of(lengths, t, dev)
    dh = [torch.randn(t, b, h, generator=g).to(dev) for _ in range(2)]
    errs, times, bounds, library = {}, {}, {}, {}

    def max_err(got, want):
        return max(float((k - p).abs().max()) for k, p in zip(got, want))

    for n in (2, 1):
        pre = "bi" if n == 2 else ""
        fwd_row, bwd_row = f"{pre}lstm_fwd_wide", f"{pre}lstm_bwd_wide"
        layer = deep_blstm(f"num_hiddens={h},num_layers=1,bidirectional="
                           f"{str(n == 2).lower()}", input_dim=FEATS,
                           generator=g, device=dev).rnn.layers[0].rnn
        cells = [layer.fw] + ([layer.bw] if n == 2 else [])
        whs = [c.wh.detach() for c in cells]
        fxps = [input_proj(c, x_serve) for c in cells]
        bxps = [input_proj(c, x) for c in cells]
        geo = lstm_geometry(h, BATCH, n)
        require(geo.design == "wide", f"{fwd_row}: lstm_geometry gives "
                f"{geo.design} at H={h}, B={BATCH}")
        fits = [cluster_info(geo, BATCH, h, bwd) for bwd in (False, True)]
        print(f"{pre}lstm_fwd/_bwd at H={h} B={BATCH}: wide design, "
              f"{geo.grid[1] * geo.grid[2]} clusters of {geo.ctas} CTAs "
              f"(R={geo.rows}); cudaOccupancyMaxActiveClusters at their "
              f"shared memory ({fits[0][0]} / {fits[1][0]} B): "
              f"{fits[0][1]} / {fits[1][1]}")

        def fwd(xps, m, train=False):
            if n == 2:
                return bilstm(*xps, m, *whs, residual=train)
            return lstm(xps[0], m, whs[0], residual=train)

        def fwd_plain(xps, m, keep=False):
            if n == 2:
                return bilstm_plain(*xps, m, *whs, keep_gates=keep)
            return lstm_plain(xps[0], m, whs[0], keep_gates=keep)

        def bwd(hcs, res):
            if n == 2:
                return bilstm_bwd(*bxps, mask, *whs, *hcs, *dh, res)
            return (lstm_bwd(bxps[0], mask, whs[0], *hcs, dh[0], res),)

        def bwd_plain(cs, gs):
            if n == 2:
                return bilstm_bwd_gates_plain(*gs, mask, *whs, *cs, *dh)
            return (lstm_bwd_gates_plain(gs[0], mask, whs[0], cs[0],
                                         dh[0]),)

        stream_geo = stream_geometry(h, BATCH, n)
        with torch.no_grad():
            got, want = fwd(fxps, mask_s), fwd_plain(fxps, mask_s)
            *kept, kept_g = fwd(fxps, mask_s, train=True)
            want_g = fwd_plain(fxps, mask_s, keep=True)[2 * n:]
            *hcs, gs = fwd(bxps, mask, train=True)
            hs, cs = hcs[0::2], hcs[1::2]
            require(len(gs) == n and len(kept_g) == n,
                    f"{fwd_row}: the training forward's res holds "
                    f"{len(gs)} tensors, not the gates of {n} directions")
            d_k, d_p = bwd(hcs, gs), bwd_plain(cs, gs)
            d_r = (bilstm_bwd_plain(*bxps, mask, *whs, *hcs, *dh)
                   if n == 2 else (lstm_bwd_plain(bxps[0], mask, whs[0],
                                                  *hcs, dh[0]),))
            # the stream design on the same inputs (its C entry points,
            # which count no launch)
            s_fwd = launch_fwd(stream_geo, fxps, mask_s, whs)
            s_bwd = launch_bwd(stream_geo, bxps, mask, whs, list(hs),
                               list(cs), dh[:n])
            times[fwd_row] = (None, cuda_ms(lambda: fwd_plain(fxps, mask_s),
                                            1, 1))
            times[bwd_row] = (None, cuda_ms(lambda: bwd_plain(cs, gs), 1, 1))
        errs[fwd_row] = max_err(got, want)
        errs[bwd_row] = max_err(d_k, d_p)
        g_err = max_err(kept_g, want_g)
        same = all(torch.equal(a, c) for a, c in zip(kept, got))
        max_c = max(float(c.abs().max()) for c in want[1::2])
        print(f"{fwd_row} kernel vs plain: T={t_s} B={BATCH} H={h} "
              f"max_abs_err={errs[fwd_row]:.3e} (max|c| {max_c:.2f}; tol "
              f"{BILSTM_ATOL:g} + {BILSTM_RTOL:g}*|plain|); the training "
              f"form's h and c bit-equal to the serving run {same}, its "
              f"gates max_abs_err={g_err:.3e}")
        require(all(within(k, p, BILSTM_ATOL, BILSTM_RTOL)
                    for k, p in zip(got, want)),
                f"{fwd_row} kernel disagrees with plain")
        require(same and all(within(k, p, BILSTM_ATOL, BILSTM_RTOL)
                             for k, p in zip(kept_g, want_g)),
                f"{fwd_row} kernel's gates disagree with plain")
        s_errs = max_err(s_fwd, want), max_err(s_bwd, d_r)
        print(f"{pre}lstm stream design (csrc/lstm_stream_{{fwd,bwd}}.cu) "
              f"vs plain at H={h} B={BATCH}: forward T={t_s} "
              f"max_abs_err={s_errs[0]:.3e} (tol {BILSTM_ATOL:g} + "
              f"{BILSTM_RTOL:g}*|plain|), backward T={t} "
              f"max_abs_err={s_errs[1]:.3e} against the plain walk that "
              f"recomputes the gates (tol {BWD_ATOL:g} + "
              f"{BWD_RTOL:g}*|plain|)")
        require(all(within(k, p, BILSTM_ATOL, BILSTM_RTOL)
                    for k, p in zip(s_fwd, want)),
                f"{pre}lstm stream forward disagrees with plain at H={h}")
        require(all(within(k, p, BWD_ATOL, BWD_RTOL)
                    for k, p in zip(s_bwd, d_r)),
                f"{pre}lstm stream backward disagrees with plain at H={h}")
        w_k = [w.clone().requires_grad_() for w in whs]
        w_p = [w.clone().requires_grad_() for w in whs]
        if n == 2:
            torch.autograd.backward(
                BiLSTMFunction.apply(*bxps, mask, *w_k), dh)
            torch.autograd.backward(bilstm_plain(*bxps, mask, *w_p)[0::2],
                                    dh)
        else:
            torch.autograd.backward(LSTMFunction.apply(bxps[0], mask,
                                                       w_k[0]), dh[0])
            torch.autograd.backward(lstm_plain(bxps[0], mask, w_p[0])[0],
                                    dh[0])
        dwh_err = max(float((a.grad - p.grad).abs().max() / p.grad.abs().max())
                      for a, p in zip(w_k, w_p))
        print(f"{bwd_row} kernel vs plain (from the card's gates): T={t} "
              f"B={b} H={h} lengths {int(lengths.min())}..{t} "
              f"max_abs_err={errs[bwd_row]:.3e} (max|dxp| "
              f"{max(float(p.abs().max()) for p in d_p):.2f}; tol "
              f"{BWD_ATOL:g} + {BWD_RTOL:g}*|plain|); against the plain walk "
              f"that recomputes the gates {max_err(d_k, d_r):.3e}; dwh via "
              f"the Function vs autograd through the plain loop: max err / "
              f"max|dwh| = {dwh_err:.3e} (tol {DWH_RTOL:g})")
        require(all(within(k, p, BWD_ATOL, BWD_RTOL)
                    for k, p in zip(d_k, d_p)),
                f"{bwd_row} kernel disagrees with plain")
        require(all(within(k, p, BWD_ATOL, BWD_RTOL)
                    for k, p in zip(d_k, d_r)),
                f"{bwd_row} kernel disagrees with the recomputing plain walk")
        require(dwh_err <= DWH_RTOL, f"{bwd_row}: dwh disagrees with autograd")
        bounds[fwd_row] = rnn_bound(fxps[0], h, n, 1,
                                    (*fxps, mask_s, *whs, *got))
        train_bound = rnn_bound(fxps[0], h, n, 1,
                                (*fxps, mask_s, *whs, *kept, *kept_g))
        bounds[bwd_row] = rnn_bound(bxps[0], h, n, 1,
                                    (*gs, mask, *whs, *cs, *dh[:n], *d_k))

        # cuDNN at the same shapes, twice, around the designs in turns
        def yardsticks():
            out = []
            for xs, lens, m in ((x_serve, len_serve, mask_s),
                                (x, lengths.to(dev), mask)):
                y = rnn_yardsticks("lstm", layer, xs, lens, m)
                print_yardsticks(card, f"cuDNN nn.LSTM {pre or 'uni'}"
                                 f"directional, T={xs.shape[0]} B={BATCH} "
                                 f"H={h}", y)
                require(y["out_err"] <= LOGITS_TOL,
                        f"layer disagrees with nn.LSTM at H={h}")
                out.append(y)
            return out[0]["lib_fwd"], out[1]["lib_bwd"]

        libs = [yardsticks()]
        with torch.no_grad():
            k_fwd = time_in_turns(
                card, fwd_row, lambda: fwd(fxps, mask_s),
                lambda: launch_fwd(stream_geo, fxps, mask_s, whs), t_s, geo,
                1, "exchange, barrier, cell, loads", hidden=h)
            k_train = cuda_ms(lambda: fwd(fxps, mask_s, train=True), 10)
            k_bwd = time_in_turns(
                card, bwd_row, lambda: bwd(hcs, gs),
                lambda: launch_bwd(stream_geo, bxps, mask, whs, list(hs),
                                   list(cs), dh[:n]), t, geo, 1,
                "exchange, barrier, cell, loads", hidden=h)
        libs.append(yardsticks())
        print(f"[{card}] {fwd_row} as training runs it (residual: also "
              f"writes the gates [T, B, 4H] of each direction), T={t_s} "
              f"B={BATCH}: {k_train:.4f} ms against the serving form's "
              f"{k_fwd:.4f} ms ({k_train / k_fwd:.3f}x); bound "
              f"{train_bound[0]:.4f} ms ({train_bound[1]}; the gates' "
              f"{tensor_bytes(*kept_g) / 1e6:.1f} MB written included)")
        times[fwd_row] = (k_fwd, times[fwd_row][1])
        times[bwd_row] = (k_bwd, times[bwd_row][1])
        library[fwd_row] = min(lib[0] for lib in libs)
        library[bwd_row] = min(lib[1] for lib in libs)
        for row, k_ms, i in ((fwd_row, k_fwd, 0), (bwd_row, k_bwd, 1)):
            print(f"[{card}] {row}: kernel {k_ms:.4f} ms, plain "
                  f"{times[row][1]:.4f} ms, bound {bounds[row][0]:.4f} ms "
                  f"({bounds[row][1]}); cuDNN nn.LSTM "
                  f"{libs[0][i]:.4f} / {libs[1][i]:.4f} ms, the lower "
                  f"{library[row] / k_ms:.2f}x the kernel")
    return {"errs": errs, "times": times, "bounds": bounds,
            "library": library}


def check_gru_wide(dev: torch.device, card: str, x_serve: torch.Tensor,
                   len_serve: torch.Tensor) -> dict:
    """Phase 3 for the wide design of the GRU kernels
    (csrc/gru_wide_{fwd,bwd}.cu), at H=512 (deep_gru at 512 units), two
    directions and one, B=32.

    The forward at the serving shapes (the check batch's features [T=805,
    B=32, 39] through a 512-unit layer, ragged lengths), as serving runs it
    (no residual), against its plain version at the GRU_* bounds, and as
    training runs it (``residual``, whose res holds the h side of the
    pre-activations ``h_prev @ wh``): h bit-equal to the serving run, res
    against the plain one.  The backward at the config-3 shapes (T=512,
    lengths 256-512) from the card forward's res against the plain backward
    from the same res and against the plain walk that recomputes it, both
    at the BWD_* bounds, dwh through the Function against autograd through
    the plain loop (DWH_RTOL).  The stream design (csrc/gru_stream_{fwd,
    bwd}.cu, through its C entry point: the route of the shapes the wide
    design cannot hold) on the same inputs against the same plain versions.
    Each wide kernel timed in turns against the stream design (wide,
    stream, stream, wide), beside cuDNN ``nn.GRU`` at the same shapes,
    timed twice in the run (the library time is the lower), the plain
    version and the bound: the forward's one product a step, the
    backward's one (``dhp @ wh^T``; res is an input) -> the kernel line's
    numbers for the four wide rows, which are the serving forward's; the
    training forward (which also writes res) timed and bounded beside
    it."""
    from asr_study_torch.models.zoo import deep_gru
    from asr_study_torch.ops.gru import (BiGRUFunction, GRUFunction, bigru,
                                         bigru_bwd, bigru_bwd_plain,
                                         bigru_bwd_res_plain, bigru_plain,
                                         gru, gru_bwd, gru_bwd_plain,
                                         gru_bwd_res_plain, gru_cluster_info,
                                         gru_geometry, gru_plain,
                                         gru_stream_geometry, launch_bwd,
                                         launch_fwd)

    h = 512
    g = torch.Generator().manual_seed(SEED + 15)
    t_s = x_serve.shape[0]
    mask_s = mask_of(len_serve, t_s, dev)
    t, b = TRAIN_T, TRAIN_B
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g)
    lengths[0] = t
    x = torch.randn(t, b, FEATS, generator=g).to(dev)
    mask = mask_of(lengths, t, dev)
    dh = [torch.randn(t, b, h, generator=g).to(dev) for _ in range(2)]
    errs, times, bounds, library = {}, {}, {}, {}

    def max_err(got, want):
        return max(float((k - p).abs().max()) for k, p in zip(got, want))

    for n in (2, 1):
        pre = "bi" if n == 2 else ""
        fwd_row, bwd_row = f"{pre}gru_fwd_wide", f"{pre}gru_bwd_wide"
        layer = deep_gru(f"num_hiddens={h},num_layers=1,bidirectional="
                         f"{str(n == 2).lower()}", input_dim=FEATS,
                         generator=g, device=dev).rnn.layers[0].rnn
        cells = [layer.fw] + ([layer.bw] if n == 2 else [])
        whs = [c.wh.detach() for c in cells]
        fxps = [input_proj(c, x_serve) for c in cells]
        bxps = [input_proj(c, x) for c in cells]
        geo = gru_geometry(h, BATCH, n)
        require(geo.design == "wide", f"{fwd_row}: gru_geometry gives "
                f"{geo.design} at H={h}, B={BATCH}")
        fits = [gru_cluster_info(geo, BATCH, h, bwd) for bwd in (False, True)]
        print(f"{pre}gru_fwd/_bwd at H={h} B={BATCH}: wide design, "
              f"{geo.grid[1] * geo.grid[2]} clusters of {geo.ctas} CTAs "
              f"(R={geo.rows}); cudaOccupancyMaxActiveClusters at their "
              f"shared memory ({fits[0][0]} / {fits[1][0]} B): "
              f"{fits[0][1]} / {fits[1][1]}")

        def fwd(xps, m, train=False):
            """-> h of each direction, and with ``train`` (h..., res)."""
            if n == 2:
                out = bigru(*xps, m, *whs, residual=train)
                return (out[:2], out[2]) if train else out
            out = gru(xps[0], m, whs[0], residual=train)
            return ((out[0],), out[1]) if train else (out,)

        def fwd_plain(xps, m, keep=False):
            if n == 2:
                return bigru_plain(*xps, m, *whs, keep_hg=keep)
            out = gru_plain(xps[0], m, whs[0], keep_hg=keep)
            return out if keep else (out,)

        def bwd(hs, res):
            if n == 2:
                return bigru_bwd(*bxps, mask, *whs, *hs, *dh, res)
            return gru_bwd(bxps[0], mask, whs[0], hs[0], dh[0], res)

        def bwd_plain(hs, res):
            if n == 2:
                return bigru_bwd_res_plain(*bxps, *res, mask, *whs, *hs, *dh)
            return gru_bwd_res_plain(bxps[0], *res, mask, whs[0], hs[0],
                                     dh[0])

        stream_geo = gru_stream_geometry(h, BATCH, n)
        with torch.no_grad():
            got, want = fwd(fxps, mask_s), fwd_plain(fxps, mask_s)
            kept, kept_g = fwd(fxps, mask_s, train=True)
            want_g = fwd_plain(fxps, mask_s, keep=True)[n:]
            hs, gs = fwd(bxps, mask, train=True)
            require(len(gs) == n and len(kept_g) == n,
                    f"{fwd_row}: the training forward's res holds "
                    f"{len(gs)} tensors, not the h side of {n} directions")
            d_k, d_p = bwd(hs, gs), bwd_plain(hs, gs)
            d_r = (bigru_bwd_plain(*bxps, mask, *whs, *hs, *dh) if n == 2
                   else gru_bwd_plain(bxps[0], mask, whs[0], hs[0], dh[0]))
            # the stream design on the same inputs (its C entry points,
            # which count no launch)
            s_fwd = launch_fwd(stream_geo, fxps, mask_s, whs)
            s_bwd = launch_bwd(stream_geo, bxps, mask, whs, list(hs), dh[:n])
            times[fwd_row] = (None, cuda_ms(lambda: fwd_plain(fxps, mask_s),
                                            1, 1))
            times[bwd_row] = (None, cuda_ms(lambda: bwd_plain(hs, gs), 1, 1))
        errs[fwd_row] = max_err(got, want)
        errs[bwd_row] = max_err(d_k, d_p)
        g_err = max_err(kept_g, want_g)
        same = all(torch.equal(a, c) for a, c in zip(kept, got))
        print(f"{fwd_row} kernel vs plain: T={t_s} B={BATCH} H={h} "
              f"max_abs_err={errs[fwd_row]:.3e} (tol {GRU_ATOL:g} + "
              f"{GRU_RTOL:g}*|plain|); the training form's h bit-equal to "
              f"the serving run {same}, its res (h_prev @ wh) "
              f"max_abs_err={g_err:.3e} (max|hg| "
              f"{max(float(a.abs().max()) for a in want_g):.2f})")
        require(all(within(k, p, GRU_ATOL, GRU_RTOL)
                    for k, p in zip(got, want)),
                f"{fwd_row} kernel disagrees with plain")
        require(same and all(within(k, p, GRU_ATOL, GRU_RTOL)
                             for k, p in zip(kept_g, want_g)),
                f"{fwd_row} kernel's res disagrees with plain")
        s_errs = max_err(s_fwd, want), max_err(s_bwd, d_r)
        print(f"{pre}gru stream design (csrc/gru_stream_{{fwd,bwd}}.cu) "
              f"vs plain at H={h} B={BATCH}: forward T={t_s} "
              f"max_abs_err={s_errs[0]:.3e} (tol {GRU_ATOL:g} + "
              f"{GRU_RTOL:g}*|plain|), backward T={t} "
              f"max_abs_err={s_errs[1]:.3e} against the plain walk that "
              f"recomputes h_prev @ wh (tol {BWD_ATOL:g} + "
              f"{BWD_RTOL:g}*|plain|)")
        require(all(within(k, p, GRU_ATOL, GRU_RTOL)
                    for k, p in zip(s_fwd, want)),
                f"{pre}gru stream forward disagrees with plain at H={h}")
        require(all(within(k, p, BWD_ATOL, BWD_RTOL)
                    for k, p in zip(s_bwd, d_r)),
                f"{pre}gru stream backward disagrees with plain at H={h}")
        w_k = [w.clone().requires_grad_() for w in whs]
        w_p = [w.clone().requires_grad_() for w in whs]
        if n == 2:
            torch.autograd.backward(BiGRUFunction.apply(*bxps, mask, *w_k),
                                    dh)
            torch.autograd.backward(bigru_plain(*bxps, mask, *w_p), dh)
        else:
            torch.autograd.backward(GRUFunction.apply(bxps[0], mask, w_k[0]),
                                    dh[0])
            torch.autograd.backward(gru_plain(bxps[0], mask, w_p[0]), dh[0])
        dwh_err = max(float((a.grad - p.grad).abs().max() / p.grad.abs().max())
                      for a, p in zip(w_k, w_p))
        print(f"{bwd_row} kernel vs plain (from the card's res): T={t} "
              f"B={b} H={h} lengths {int(lengths.min())}..{t} "
              f"max_abs_err={errs[bwd_row]:.3e} over dxp and dhp (max|dxp| "
              f"{max(float(p.abs().max()) for p in d_p):.2f}; tol "
              f"{BWD_ATOL:g} + {BWD_RTOL:g}*|plain|); against the plain walk "
              f"that recomputes h_prev @ wh {max_err(d_k, d_r):.3e}; dwh via "
              f"the Function vs autograd through the plain loop: max err / "
              f"max|dwh| = {dwh_err:.3e} (tol {DWH_RTOL:g})")
        require(all(within(k, p, BWD_ATOL, BWD_RTOL)
                    for k, p in zip(d_k, d_p)),
                f"{bwd_row} kernel disagrees with plain")
        require(all(within(k, p, BWD_ATOL, BWD_RTOL)
                    for k, p in zip(d_k, d_r)),
                f"{bwd_row} kernel disagrees with the recomputing plain walk")
        require(dwh_err <= DWH_RTOL, f"{bwd_row}: dwh disagrees with autograd")
        bounds[fwd_row] = rnn_bound(fxps[0], h, n, 1,
                                    (*fxps, mask_s, *whs, *got))
        train_bound = rnn_bound(fxps[0], h, n, 1,
                                (*fxps, mask_s, *whs, *kept, *kept_g))
        bounds[bwd_row] = rnn_bound(bxps[0], h, n, 1,
                                    (*bxps, *gs, mask, *whs, *hs, *dh[:n],
                                     *d_k))

        # cuDNN at the same shapes, twice, around the designs in turns
        def yardsticks():
            out = []
            for xs, lens, m in ((x_serve, len_serve, mask_s),
                                (x, lengths.to(dev), mask)):
                y = rnn_yardsticks("gru", layer, xs, lens, m)
                print_yardsticks(card, f"cuDNN nn.GRU {pre or 'uni'}"
                                 f"directional, T={xs.shape[0]} B={BATCH} "
                                 f"H={h}", y)
                require(y["out_err"] <= LOGITS_TOL,
                        f"layer disagrees with nn.GRU at H={h}")
                out.append(y)
            return out[0]["lib_fwd"], out[1]["lib_bwd"]

        libs = [yardsticks()]
        with torch.no_grad():
            k_fwd = time_in_turns(
                card, fwd_row, lambda: fwd(fxps, mask_s),
                lambda: launch_fwd(stream_geo, fxps, mask_s, whs), t_s, geo,
                1, "exchange, barrier, cell, loads", gates=3, hidden=h)
            k_train = cuda_ms(lambda: fwd(fxps, mask_s, train=True), 10)
            k_bwd = time_in_turns(
                card, bwd_row, lambda: bwd(hs, gs),
                lambda: launch_bwd(stream_geo, bxps, mask, whs, list(hs),
                                   dh[:n]), t, geo, 1,
                "exchange, barrier, cell, loads", gates=3, hidden=h)
        libs.append(yardsticks())
        print(f"[{card}] {fwd_row} as training runs it (residual: also "
              f"writes h_prev @ wh [T, B, 3H] of each direction), T={t_s} "
              f"B={BATCH}: {k_train:.4f} ms against the serving form's "
              f"{k_fwd:.4f} ms ({k_train / k_fwd:.3f}x); bound "
              f"{train_bound[0]:.4f} ms ({train_bound[1]}; the res "
              f"{tensor_bytes(*kept_g) / 1e6:.1f} MB written included)")
        times[fwd_row] = (k_fwd, times[fwd_row][1])
        times[bwd_row] = (k_bwd, times[bwd_row][1])
        library[fwd_row] = min(lib[0] for lib in libs)
        library[bwd_row] = min(lib[1] for lib in libs)
        for row, k_ms, i in ((fwd_row, k_fwd, 0), (bwd_row, k_bwd, 1)):
            print(f"[{card}] {row}: kernel {k_ms:.4f} ms, plain "
                  f"{times[row][1]:.4f} ms, bound {bounds[row][0]:.4f} ms "
                  f"({bounds[row][1]}); cuDNN nn.GRU "
                  f"{libs[0][i]:.4f} / {libs[1][i]:.4f} ms, the lower "
                  f"{library[row] / k_ms:.2f}x the kernel")
    return {"errs": errs, "times": times, "bounds": bounds,
            "library": library}


def check_stream_h512(dev: torch.device, card: str,
                      x_serve: torch.Tensor) -> None:
    """The layer-norm, zoneout and MI LSTM kernels' route at H=512 (their
    stream design, csrc/{ln,zoneout,mi}_lstm_stream_{fwd,bwd}.cu; no zoo
    model's default width), two directions and one, B=32: each forward and
    backward through its wrapper against its plain version once (the
    forward at the serving shapes, T=805, the backward at the config-3
    ones, T=512, every frame real), at the BILSTM_* and BWD_* bounds (the
    chaotic layer-norm recurrence as ``check_ln_kernels`` holds it: every
    frame of the forward against the plain step from the kernel's own
    previous state, every (frame, row) of the backward against the row's
    norm), and timed beside its plain version and its bound (no library
    call computes them), for the ranking of the wide routes still to
    redesign."""
    from asr_study_torch.models.zoo import build_model
    from asr_study_torch.ops import ln_lstm, mi_lstm, zoneout_lstm

    h = 512
    g = torch.Generator().manual_seed(SEED + 16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    x = torch.randn(TRAIN_T, TRAIN_B, FEATS, generator=g).to(dev)
    families = {"ln_lstm": (ln_lstm, "ln_blstm", ln_lstm.ln_geometry),
                "zoneout_lstm": (zoneout_lstm, "zoneout_blstm",
                                 zoneout_lstm.zoneout_geometry),
                "mi_lstm": (mi_lstm, "mi_blstm", mi_lstm.mi_geometry)}

    def max_err(got, want):
        return max(float((k - p).abs().max()) for k, p in zip(got, want))

    def tup(out):
        return out if isinstance(out, tuple) else (out,)

    for stem, (op, model, geometry) in families.items():
        chaotic = stem == "ln_lstm"
        for n in (2, 1):
            name = f"bi_{stem}" if n == 2 else stem
            fwd, fwd_plain, bwd, bwd_plain = (
                getattr(op, name), getattr(op, f"{name}_plain"),
                getattr(op, f"{name}_bwd"), getattr(op, f"{name}_bwd_plain"))
            layer = build_model(model, f"num_hiddens={h},num_layers=1,"
                                f"bidirectional={str(n == 2).lower()}",
                                input_dim=FEATS, generator=g,
                                device=dev).rnn.layers[0].rnn
            cells = [layer.fw] + ([layer.bw] if n == 2 else [])
            design = geometry(h, BATCH, n).design

            def args_of(xs):
                """The op's arguments for input xs: streamed tensors, the
                mask (every frame real), the residents paired by
                direction, as RNNLayer hands them (zoneout: train-mode
                mix weights drawn on the card)."""
                with torch.no_grad():
                    preps = [c.prepare(xs, True, gen) for c in cells]
                mask = torch.ones(xs.shape[0], xs.shape[1], 1, device=dev)
                return (*[p[0] for p in preps], mask,
                        *[a.detach() for vecs in zip(*(p[1] for p in preps))
                          for a in vecs])

            fa, ba = args_of(x_serve), args_of(x)
            with torch.no_grad():
                before = dict(fwd.by_design)
                got = fwd(*fa)
                want = ln_stepwise(fa, got) if chaotic else fwd_plain(*fa)
                hc = fwd(*ba)
                dhs = [torch.randn(hc[0].shape, generator=g).to(dev)
                       for _ in range(n)]
                d_k = tup(bwd(*ba, *hc, *dhs))
                d_p = tup(bwd_plain(*ba, *hc, *dhs))
                torch.cuda.synchronize()
                require(fwd.by_design[design] == before[design] + 2,
                        f"{name} did not run the {design} design at H={h}")
                k_fwd = cuda_ms(lambda: fwd(*fa), 3)
                k_bwd = cuda_ms(lambda: bwd(*ba, *hc, *dhs), 3)
                p_fwd = cuda_ms(lambda: fwd_plain(*fa), 1, 1)
                p_bwd = cuda_ms(lambda: bwd_plain(*ba, *hc, *dhs), 1, 1)
            f_err, b_err = max_err(got, want), max_err(d_k, d_p)
            fb = rnn_bound(fa[0], h, n, 1, (*fa, *got))
            bb = rnn_bound(ba[0], h, n, 2, (*ba, *hc, *dhs, *d_k))
            how = ""
            if chaotic:
                row_rel = max(float(((k - p).norm(dim=-1) / p.norm(
                    dim=-1).clamp(min=1e-30)).max()) for k, p in zip(d_k, d_p))
                how = (" (a chaotic recurrence: the forward against the "
                       "plain step from its own state, every frame; the "
                       "backward row by row, max ||diff|| / ||plain|| "
                       f"{row_rel:.3e})")
            print(f"[{card}] {name} at H={h} ({design} design, "
                  f"csrc/{stem}_stream_*.cu), B={BATCH}: forward T="
                  f"{fa[0].shape[0]} kernel {k_fwd:.4f} ms, plain "
                  f"{p_fwd:.4f} ms, bound {fb[0]:.4f} ms ({fb[1]}); "
                  f"backward T={ba[0].shape[0]} kernel {k_bwd:.4f} ms, plain "
                  f"{p_bwd:.4f} ms, bound {bb[0]:.4f} ms ({bb[1]}, two "
                  f"products a step); against plain{how}: forward "
                  f"max_abs_err={f_err:.3e} (tol {BILSTM_ATOL:g} + "
                  f"{BILSTM_RTOL:g}*|plain|), backward {b_err:.3e} (tol "
                  f"{BWD_ATOL:g} + {BWD_RTOL:g}*|plain|"
                  f"{', of the row norm' if chaotic else ''}); library: none")
            require(all(within(k, p, BILSTM_ATOL, BILSTM_RTOL)
                        for k, p in zip(got, want)),
                    f"{name} stream forward disagrees with plain at H={h}")
            require(rows_within(d_k, d_p, BWD_ATOL, BWD_RTOL) if chaotic
                    else all(within(k, p, BWD_ATOL, BWD_RTOL)
                             for k, p in zip(d_k, d_p)),
                    f"{name} stream backward disagrees with plain at H={h}")


def sm_clock_hz() -> float:
    """The card's SM clock now, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.splitlines()[0]) * 1e6


def check_lstm_designs(dev: torch.device, card: str, x_serve: torch.Tensor,
                       len_serve: torch.Tensor, library: dict) -> None:
    """Phase 3 for the cluster design of the LSTM kernels beyond the main
    paths, and its time against the design it replaced.

    The four wrappers against their plain versions at shapes ragged for the
    cluster tiling: H=100 (13 units a CTA, the last CTA 9), B=5 and B=33
    (rows left over in the last group), a row masked on every frame, T=1,
    and H=512 at B=49 (two directions: more rows than the wide design's
    clusters hold, so the stream design; one direction: the wide design
    with a ragged last group); each case runs the design ``lstm_geometry``
    picks, held by the wrappers' by-design counts, at the forward and
    backward tolerances.  Then, at H=256 and the main paths' shapes (T=805
    forward, T=512 backward, B=32), the cluster design and the stream design
    (its C entry point) timed in turns, cluster, stream, stream, cluster,
    beside cuDNN's time from ``library`` (this run), with the per-step time
    split into the FMA time of one CTA's slice at the card's SM clock and
    the rest (exchange, barrier, cell)."""
    from asr_study_torch.models.zoo import deep_blstm
    from asr_study_torch.ops.bilstm import (bilstm, bilstm_bwd,
                                            bilstm_bwd_plain, bilstm_plain,
                                            launch_bwd, launch_fwd, lstm,
                                            lstm_bwd, lstm_bwd_plain,
                                            lstm_geometry, lstm_plain,
                                            stream_geometry)

    g = torch.Generator().manual_seed(SEED + 12)
    for t, b, h, masked in ((37, 5, 100, True), (40, 33, 256, True),
                            (1, 33, 256, False), (1, 5, 100, False),
                            (64, 9, 256, True), (24, 49, 512, True)):
        xps = [torch.randn(t, b, 4 * h, generator=g) for _ in range(2)]
        whs = [torch.randn(h, 4 * h, generator=g) / h ** 0.5
               for _ in range(2)]
        lengths = torch.randint(1, t + 1, (b,), generator=g)
        lengths[0] = t
        mask = (torch.arange(t)[:, None] < lengths[None, :]).float()
        if masked:
            mask[:, b - 1] = 0.0
        dhs = [torch.randn(t, b, h, generator=g).to(dev) for _ in range(2)]
        xps = [x.to(dev) for x in xps]
        whs = [w.to(dev) for w in whs]
        mask = mask[..., None].to(dev)
        designs = {n: lstm_geometry(h, b, n).design for n in (2, 1)}
        ran = {w: (designs[n], w.by_design[designs[n]]) for w, n in (
            (bilstm, 2), (bilstm_bwd, 2), (lstm, 1), (lstm_bwd, 1))}
        with torch.no_grad():
            bi = (*xps, mask, *whs)
            *hc, res = bilstm(*bi, residual=True)
            fb = hc, bilstm_plain(*bi)
            bb = (bilstm_bwd(*bi, *hc, *dhs, res),
                  bilstm_bwd_plain(*bi, *hc, *dhs))
            uni = (xps[0], mask, whs[0])
            *hc, res = lstm(*uni, residual=True)
            fu = hc, lstm_plain(*uni)
            bu = (lstm_bwd(*uni, *hc, dhs[0], res),
                  lstm_bwd_plain(*uni, *hc, dhs[0]))
        errs = {}
        for name, (got, want), atol, rtol in (
                ("bilstm_fwd", fb, BILSTM_ATOL, BILSTM_RTOL),
                ("bilstm_bwd", bb, BWD_ATOL, BWD_RTOL),
                ("lstm_fwd", fu, BILSTM_ATOL, BILSTM_RTOL),
                ("lstm_bwd", ([bu[0]], [bu[1]]), BWD_ATOL, BWD_RTOL)):
            errs[name] = max(float((k - p).abs().max())
                             for k, p in zip(got, want))
            require(all(within(k, p, atol, rtol) for k, p in zip(got, want)),
                    f"{name} kernel disagrees with plain at T={t} B={b} "
                    f"H={h}")
        for w, (design, before) in ran.items():
            require(w.by_design[design] == before + 1,
                    f"{w.__name__} at T={t} B={b} H={h} did not run the "
                    f"{design} design")
        print(f"LSTM kernels vs plain at T={t} B={b} H={h}"
              f"{', the last row masked throughout' if masked else ''} "
              f"(designs: bi {designs[2]}, uni {designs[1]}): max_abs_err "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (tol fwd {BILSTM_ATOL:g} + {BILSTM_RTOL:g}*|plain|, bwd "
              f"{BWD_ATOL:g} + {BWD_RTOL:g}*|plain|)")

    # the two designs in turns at H=256
    layer = deep_blstm(f"num_hiddens={HIDDEN},num_layers=1", input_dim=FEATS,
                       generator=g, device=dev).rnn.layers[0].rnn
    t_s = x_serve.shape[0]
    mask_s = mask_of(len_serve, t_s, dev)
    fxps = [input_proj(layer.fw, x_serve), input_proj(layer.bw, x_serve)]
    whs = [layer.fw.wh.detach(), layer.bw.wh.detach()]
    t, b = TRAIN_T, TRAIN_B
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g)
    lengths[0] = t
    x = torch.randn(t, b, FEATS, generator=g).to(dev)
    mask = mask_of(lengths, t, dev)
    bxps = [input_proj(layer.fw, x), input_proj(layer.bw, x)]
    dhs = [torch.randn(t, b, HIDDEN, generator=g).to(dev) for _ in range(2)]
    with torch.no_grad():
        hf, cf, hb, cb = bilstm(*bxps, mask, *whs)
        # the stream design through launch_fwd / launch_bwd, which call
        # its C entry points directly and count no launch
        uni_s, bi_s = (stream_geometry(HIDDEN, BATCH, n) for n in (1, 2))
        runs = {
            "lstm_fwd": (lambda: lstm(fxps[0], mask_s, whs[0]),
                         lambda: launch_fwd(uni_s, fxps[:1], mask_s,
                                            whs[:1]), t_s, 1, 1),
            "bilstm_fwd": (lambda: bilstm(*fxps, mask_s, *whs),
                           lambda: launch_fwd(bi_s, fxps, mask_s, whs),
                           t_s, 2, 1),
            "lstm_bwd": (lambda: lstm_bwd(bxps[0], mask, whs[0], hf, cf,
                                          dhs[0]),
                         lambda: launch_bwd(uni_s, bxps[:1], mask, whs[:1],
                                            [hf], [cf], dhs[:1]), t, 1, 2),
            "bilstm_bwd": (lambda: bilstm_bwd(*bxps, mask, *whs, hf, cf, hb,
                                              cb, *dhs),
                           lambda: launch_bwd(bi_s, bxps, mask, whs,
                                              [hf, hb], [cf, cb], dhs),
                           t, 2, 2),
        }
        for name, (cluster_fn, stream_fn, steps, ndir, passes) in \
                runs.items():
            time_in_turns(card, name, cluster_fn, stream_fn, steps,
                          lstm_geometry(HIDDEN, BATCH, ndir), passes,
                          "exchange, barrier, cell, loads",
                          library=("cuDNN", library[name]))


def check_gru_designs(dev: torch.device, card: str, x_serve: torch.Tensor,
                      len_serve: torch.Tensor, library: dict) -> None:
    """Phase 3 for the cluster design of the GRU kernels beyond the main
    paths, and its time against the design it replaced, as
    ``check_lstm_designs`` for the LSTM.

    The four wrappers against their plain versions at shapes ragged for the
    cluster tiling (H=100: 13 units a CTA, the last CTA 9; B=5 and B=33; a
    row masked on every frame; T=1) and at H=512 (the wide design, its
    backward from the forward's res), each case in the design
    ``gru_geometry`` picks (held by the by-design counts), at the forward
    and backward tolerances.  Then, at H=256 and
    the main paths' shapes (T=805 forward, T=512 backward, B=32), the
    cluster and stream designs timed in turns, cluster, stream, stream,
    cluster, beside nn.GRU's time in this run (``library``; for the
    one-direction forward, which the kernel line times at T=512, nn.GRU is
    timed here at T=805), with the per-step time split into the FMA time of
    one CTA's slice at the card's SM clock and the rest."""
    from asr_study_torch.models.zoo import deep_gru
    from asr_study_torch.ops.gru import (bigru, bigru_bwd, bigru_bwd_plain,
                                         bigru_plain, gru, gru_bwd,
                                         gru_bwd_plain, gru_geometry,
                                         gru_plain, gru_stream_geometry,
                                         launch_bwd, launch_fwd)

    g = torch.Generator().manual_seed(SEED + 13)
    wrappers = {"bigru_fwd": bigru, "bigru_bwd": bigru_bwd, "gru_fwd": gru,
                "gru_bwd": gru_bwd}
    for t, b, h, masked in ((37, 5, 100, True), (40, 33, 256, True),
                            (1, 33, 256, False), (1, 5, 100, False),
                            (64, 9, 256, True), (20, 3, 512, True)):
        xps = [torch.randn(t, b, 3 * h, generator=g) for _ in range(2)]
        whs = [torch.randn(h, 3 * h, generator=g) / h ** 0.5
               for _ in range(2)]
        lengths = torch.randint(1, t + 1, (b,), generator=g)
        lengths[0] = t
        mask = (torch.arange(t)[:, None] < lengths[None, :]).float()
        if masked:
            mask[:, b - 1] = 0.0
        dhs = [torch.randn(t, b, h, generator=g).to(dev) for _ in range(2)]
        xps = [x.to(dev) for x in xps]
        whs = [w.to(dev) for w in whs]
        mask = mask[..., None].to(dev)
        designs = {n: gru_geometry(h, b, n).design for n in (2, 1)}
        before = {k: dict(w.by_design) for k, w in wrappers.items()}
        with torch.no_grad():
            bi = (*xps, mask, *whs)
            *h_bi, res_bi = bigru(*bi, residual=True)
            fb = h_bi, bigru_plain(*bi)
            bb = (bigru_bwd(*bi, *h_bi, *dhs, res_bi),
                  bigru_bwd_plain(*bi, *h_bi, *dhs))
            uni = (xps[0], mask, whs[0])
            h_uni, res_uni = gru(*uni, residual=True)
            fu = [h_uni], [gru_plain(*uni)]
            bu = (gru_bwd(*uni, h_uni, dhs[0], res_uni),
                  gru_bwd_plain(*uni, h_uni, dhs[0]))
        torch.cuda.synchronize()
        for name, w in wrappers.items():
            design = designs[2 if name.startswith("bi") else 1]
            require(w.by_design[design] == before[name][design] + 1,
                    f"{name} did not run the {design} design at T={t} B={b} "
                    f"H={h}")
        errs = {}
        for name, (got, want), atol, rtol in (
                ("bigru_fwd", fb, GRU_ATOL, GRU_RTOL),
                ("bigru_bwd", bb, BWD_ATOL, BWD_RTOL),
                ("gru_fwd", fu, GRU_ATOL, GRU_RTOL),
                ("gru_bwd", bu, BWD_ATOL, BWD_RTOL)):
            errs[name] = max(float((k - p).abs().max())
                             for k, p in zip(got, want))
            require(all(within(k, p, atol, rtol) for k, p in zip(got, want)),
                    f"{name} kernel disagrees with plain at T={t} B={b} "
                    f"H={h}")
        print(f"GRU kernels vs plain at T={t} B={b} H={h}"
              f"{', the last row masked throughout' if masked else ''} "
              f"(designs: bi {designs[2]}, uni {designs[1]}): max_abs_err "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (tol fwd {GRU_ATOL:g} + {GRU_RTOL:g}*|plain|, bwd "
              f"{BWD_ATOL:g} + {BWD_RTOL:g}*|plain|)")

    # the two designs in turns at H=256
    layer, uni = (deep_gru(f"num_hiddens={HIDDEN},num_layers=1,bidirectional="
                           f"{bi}", input_dim=FEATS, generator=g,
                           device=dev).rnn.layers[0].rnn
                  for bi in ("true", "false"))
    t_s = x_serve.shape[0]
    mask_s = mask_of(len_serve, t_s, dev)
    y = rnn_yardsticks("gru", uni, x_serve, len_serve, mask_s)
    print_yardsticks(card, f"cuDNN nn.GRU unidirectional, T={t_s} "
                     f"B={BATCH} H={HIDDEN}", y)
    require(y["out_err"] <= LOGITS_TOL, "layer disagrees with nn.GRU")
    library = {**library, "gru_fwd": y["lib_fwd"]}
    fxps = [input_proj(layer.fw, x_serve), input_proj(layer.bw, x_serve)]
    whs = [layer.fw.wh.detach(), layer.bw.wh.detach()]
    uxp, uwh = input_proj(uni.fw, x_serve), uni.fw.wh.detach()
    t, b = TRAIN_T, TRAIN_B
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g)
    lengths[0] = t
    x = torch.randn(t, b, FEATS, generator=g).to(dev)
    mask = mask_of(lengths, t, dev)
    bxps = [input_proj(layer.fw, x), input_proj(layer.bw, x)]
    dhs = [torch.randn(t, b, HIDDEN, generator=g).to(dev) for _ in range(2)]
    with torch.no_grad():
        hf, hb = bigru(*bxps, mask, *whs)
        # the stream design through launch_fwd / launch_bwd, which call
        # its C entry points directly and count no launch
        uni_s, bi_s = (gru_stream_geometry(HIDDEN, BATCH, n) for n in (1, 2))
        runs = {
            "gru_fwd": (lambda: gru(uxp, mask_s, uwh),
                        lambda: launch_fwd(uni_s, [uxp], mask_s, [uwh]),
                        t_s, 1, 1),
            "bigru_fwd": (lambda: bigru(*fxps, mask_s, *whs),
                          lambda: launch_fwd(bi_s, fxps, mask_s, whs),
                          t_s, 2, 1),
            "gru_bwd": (lambda: gru_bwd(bxps[0], mask, whs[0], hf, dhs[0]),
                        lambda: launch_bwd(uni_s, bxps[:1], mask, whs[:1],
                                           [hf], dhs[:1]), t, 1, 2),
            "bigru_bwd": (lambda: bigru_bwd(*bxps, mask, *whs, hf, hb, *dhs),
                          lambda: launch_bwd(bi_s, bxps, mask, whs, [hf, hb],
                                             dhs), t, 2, 2),
        }
        for name, (cluster_fn, stream_fn, steps, ndir, passes) in \
                runs.items():
            time_in_turns(card, name, cluster_fn, stream_fn, steps,
                          gru_geometry(HIDDEN, BATCH, ndir), passes,
                          "exchange, barrier, cell, loads", gates=3,
                          library=("cuDNN nn.GRU", library[name]))


def check_cell_family(dev: torch.device, card: str, x_serve: torch.Tensor,
                      len_serve: torch.Tensor, family: str) -> dict:
    """Phase 3 for the zoneout-LSTM (``family`` "zoneout") or the MI-LSTM
    ("mi") kernels, both forms (two directions a launch and one).

    Each forward at the serving shapes (the check batch's features [T=805,
    B=32, 39] through layer 0 of a 3x256 model, ragged lengths) and each
    backward at the config-3 shapes (T=512, B=32, H=256, lengths 256-512)
    against its plain version, with the LSTM tolerances; the parameter
    gradients through the Function against autograd through the plain
    loop; each timed with its plain version and its bound (the mix weights'
    bytes counted in).  The zoneout kernels are held twice, with
    Bernoulli(0.9) mix weights drawn on the card (train mode) and with the
    eval constant 0.9, and at zh = zc = 1 against the cluster LSTM kernels
    (``check_zoneout_anchor``).  The MI vectors alpha, beta1, beta2 and b
    are moved off their init by seeded noise, so that each one the kernels
    take matters.  Both families' kernels run the design
    ``zoneout_geometry`` / ``mi_geometry`` gives (the cluster one at H=256:
    held by the by-design counts), are timed in turns against the stream
    design (its C entry point through ``launch_fwd`` / ``launch_bwd``,
    which count no launch); the MI kernels are held at alpha = 0, beta1 =
    beta2 = 1 against the cluster LSTM kernels fed xp + b, where the MI
    pre-activation is the LSTM's; then ``check_zoneout_designs`` /
    ``check_mi_designs`` holds them at ragged shapes.
    The forward's h is also printed against a float64 run of the plain
    loop, the recurrence's own fp32 spread."""
    from asr_study_torch.models.zoo import build_model
    from asr_study_torch.ops import mi_lstm as mi
    from asr_study_torch.ops import zoneout_lstm as zo

    g = torch.Generator().manual_seed(SEED + (8 if family == "zoneout" else 9))
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    h = HIDDEN
    model_name = {"zoneout": "zoneout_blstm", "mi": "mi_blstm"}[family]
    op = zo if family == "zoneout" else mi
    geometry = zo.zoneout_geometry if family == "zoneout" else mi.mi_geometry
    stream_geometry = (zo.zoneout_stream_geometry if family == "zoneout"
                       else mi.mi_stream_geometry)
    stem = "zoneout_lstm" if family == "zoneout" else "mi_lstm"
    # positions of the differentiable resident arguments (the MI vectors
    # and wh; a zoneout cell's mix weights get no gradient)
    grad_names = (("dwh",) if family == "zoneout"
                  else ("dwh", "dalpha", "dbeta1", "dbeta2", "db"))

    def layer0(bidirectional: bool):
        layer = build_model(model_name, f"num_hiddens={h},num_layers=1,"
                            f"bidirectional={str(bidirectional).lower()}",
                            input_dim=FEATS, generator=g,
                            device=dev).rnn.layers[0].rnn
        if family == "mi":
            with torch.no_grad():
                for cell in [layer.fw] + ([layer.bw] if bidirectional
                                          else []):
                    for v in (cell.alpha, cell.beta1, cell.beta2, cell.b):
                        v.add_(0.1 * torch.randn(v.shape, generator=g).to(
                            dev))
        return layer

    def prepared(layer, x, train: bool):
        """The op's arguments but the mask: streamed tensors, then the
        residents (each forward, then backward), as RNNLayer hands them."""
        cells = [layer.fw] + ([layer.bw] if layer.bidirectional else [])
        with torch.no_grad():
            preps = [c.prepare(x, train, gen) for c in cells]
        return ([p[0] for p in preps],
                [a.detach() for vecs in zip(*(p[1] for p in preps))
                 for a in vecs])

    def max_err(got, want):
        return max(float((k - p).abs().max()) for k, p in zip(got, want))

    def ran_design(wrapper, before, ndir, batch):
        """One launch of ``wrapper`` since ``before`` (its by-design
        counts), in the design the family's geometry gives -> its words for
        the report."""
        want = geometry(h, batch, ndir).design
        after = dict(wrapper.by_design)
        require(after[want] == before[want] + 1 and sum(after.values())
                == sum(before.values()) + 1,
                f"{wrapper.__name__} ran {after} (before {before}), want one "
                f"more launch of the {want} design")
        return f" ({want} design)"

    def in_turns(label, cluster_fn, stream_fn, steps, ndir, passes):
        return time_in_turns(card, label, cluster_fn, stream_fn, steps,
                             geometry(h, BATCH, ndir), passes,
                             "exchange, barrier, cell, loads")

    def split(res, n):
        """The residents as launch_fwd / launch_bwd take them: zoneout's
        (zh, zc, wh), the MI's (wh, its vectors), each a list over the
        directions."""
        if family == "zoneout":
            return [list(res[k * n:(k + 1) * n]) for k in range(3)]
        return [list(res[:n]), list(res[n:])]

    mixes = ("bernoulli", "constant") if family == "zoneout" else ("-",)
    errs, times, bounds = {}, {}, {}
    t_s = x_serve.shape[0]
    mask_s = mask_of(len_serve, t_s, dev)
    t, b = TRAIN_T, TRAIN_B
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g)
    lengths[0] = t
    x = torch.randn(t, b, FEATS, generator=g).to(dev)
    mask = mask_of(lengths, t, dev)
    dh = [torch.randn(t, b, h, generator=g).to(dev) for _ in range(2)]
    forms = {f"bi_{stem}": (layer0(True), getattr(op, f"bi_{stem}"),
                            getattr(op, f"bi_{stem}_plain"),
                            getattr(op, f"bi_{stem}_bwd"),
                            getattr(op, f"bi_{stem}_bwd_plain"),
                            op.BiZoneoutLSTMFunction if family == "zoneout"
                            else op.BiMILSTMFunction),
             stem: (layer0(False), getattr(op, stem),
                    getattr(op, f"{stem}_plain"),
                    getattr(op, f"{stem}_bwd"),
                    getattr(op, f"{stem}_bwd_plain"),
                    op.ZoneoutLSTMFunction if family == "zoneout"
                    else op.MILSTMFunction)}
    for name, (layer, fwd, fwd_plain, bwd, bwd_plain, fn) in forms.items():
        for mix in mixes:
            train = mix == "bernoulli"
            how = f" ({mix} mix weights)" if family == "zoneout" else ""
            # the forward at the serving shapes
            xps, res = prepared(layer, x_serve, train)
            n = len(xps)
            args = (*xps, mask_s, *res)
            with torch.no_grad():
                before = dict(fwd.by_design)
                got, want = fwd(*args), fwd_plain(*args)
                torch.cuda.synchronize()
                design = ran_design(fwd, before, n, BATCH)
                ref = fwd_plain(*(a.double() for a in args))[0::2]
                drift = [max_err([r.double() for r in run], ref)
                         for run in (got[0::2], want[0::2])]
                if mix != "constant":
                    geo_s = stream_geometry(h, BATCH, n)
                    times[f"{name}_fwd"] = (
                        in_turns(f"{name}_fwd", lambda: fwd(*args),
                                 lambda: op.launch_fwd(
                                     geo_s, list(xps), mask_s,
                                     *split(res, n)), t_s, n, 1),
                        cuda_ms(lambda: fwd_plain(*args), 2, 1))
            err = max_err(got, want)
            errs[f"{name}_fwd"] = max(err, errs.get(f"{name}_fwd", 0.0))
            bounds[f"{name}_fwd"] = rnn_bound(xps[0], h, n, 1, (*args, *got))
            print(f"{name}_fwd kernel{design} vs plain{how}: T={t_s} "
                  f"B={BATCH} H={h} "
                  f"lengths {int(len_serve.min())}..{int(len_serve.max())} "
                  f"max_abs_err={err:.3e} (h "
                  f"{max_err(got[0::2], want[0::2]):.2e} c "
                  f"{max_err(got[1::2], want[1::2]):.2e}; max|c| "
                  f"{max(float(c.abs().max()) for c in want[1::2]):.2f}) "
                  f"(tol {BILSTM_ATOL:g} + {BILSTM_RTOL:g}*|plain|); h against "
                  f"a float64 run of the plain loop: kernel {drift[0]:.2e}, "
                  f"plain loop on the card {drift[1]:.2e}")
            require(all(within(k, p, BILSTM_ATOL, BILSTM_RTOL)
                        for k, p in zip(got, want)),
                    f"{name}_fwd kernel disagrees with plain{how}")

            # the backward at the training shapes
            xps, res = prepared(layer, x, train)
            args = (*xps, mask, *res)
            with torch.no_grad():
                hc = fwd(*args)
                bwd_args = (*args, *hc, *dh[:n])
                before = dict(bwd.by_design)
                d_k, d_p = bwd(*bwd_args), bwd_plain(*bwd_args)
                torch.cuda.synchronize()
                design = ran_design(bwd, before, n, b)
                d_k = d_k if n == 2 else (d_k,)
                d_p = d_p if n == 2 else (d_p,)
                if mix != "constant":
                    geo_s = stream_geometry(h, b, n)
                    times[f"{name}_bwd"] = (
                        in_turns(f"{name}_bwd", lambda: bwd(*bwd_args),
                                 lambda: op.launch_bwd(
                                     geo_s, list(xps), mask, *split(res, n),
                                     list(hc[0::2]), list(hc[1::2]), dh[:n]),
                                 t, n, 2),
                        cuda_ms(lambda: bwd_plain(*bwd_args), 2, 1))
            err = max_err(d_k, d_p)
            errs[f"{name}_bwd"] = max(err, errs.get(f"{name}_bwd", 0.0))
            bounds[f"{name}_bwd"] = rnn_bound(xps[0], h, n, 2,
                                              (*bwd_args, *d_k))
            # the parameter gradients through the Function against autograd
            # through the plain loop
            diff = [i for i in range(len(res))
                    if family != "zoneout" or i >= 2 * n]
            w_k = [a.clone().requires_grad_() if i in diff else a
                   for i, a in enumerate(res)]
            w_p = [a.clone().requires_grad_() if i in diff else a
                   for i, a in enumerate(res)]
            outs = fn.apply(*xps, mask, *w_k)
            torch.autograd.backward(outs if n == 2 else (outs,), dh[:n])
            torch.autograd.backward(fwd_plain(*xps, mask, *w_p)[0::2],
                                    dh[:n])
            p_errs = [float((w_k[i].grad - w_p[i].grad).abs().max()
                            / w_p[i].grad.abs().max()) for i in diff]
            by_kind = {k: max(p_errs[j * n: (j + 1) * n])
                       for j, k in enumerate(grad_names)}
            print(f"{name}_bwd kernel{design} vs plain{how}: T={t} B={b} "
                  f"H={h} "
                  f"lengths {int(lengths.min())}..{t} max_abs_err={err:.3e} "
                  f"(max|{'dpre' if family == 'mi' else 'dxp'}| "
                  f"{max(float(p.abs().max()) for p in d_p):.4g}; tol "
                  f"{BWD_ATOL:g} + {BWD_RTOL:g}*|plain|); via {fn.__name__} "
                  f"vs autograd through {fwd_plain.__name__}, max err / "
                  f"max|grad|: " + ", ".join(f"{k} {v:.3e}"
                                             for k, v in by_kind.items())
                  + f" (tol {DWH_RTOL:g})")
            require(all(within(k, p, BWD_ATOL, BWD_RTOL)
                        for k, p in zip(d_k, d_p)),
                    f"{name}_bwd kernel disagrees with plain{how}")
            require(max(p_errs) <= DWH_RTOL,
                    f"{fn.__name__} gradients disagree with autograd{how}")
            if family == "mi":
                check_mi_anchor(name, xps, mask, res, dh[:n])
            elif mix == "constant":
                check_zoneout_anchor(name, xps, mask, res, dh[:n])
    if family == "mi":
        check_mi_designs(dev)
    else:
        check_zoneout_designs(dev)
    print(f"{family} LSTM library yardstick: none; no PyTorch call computes "
          f"a{' zoneout' if family == 'zoneout' else 'n MI'} LSTM (cuDNN's "
          f"nn.LSTM has no {'zoneout mix' if family == 'zoneout' else 'multiplicative integration'}), "
          f"so library_ms is null for its four kernels")
    for name, (k_ms, p_ms) in times.items():
        print(f"[{card}] {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]})")
    return {"errs": errs, "times": times, "bounds": bounds,
            "library": dict.fromkeys(times)}


def check_mi_anchor(name: str, xps: list, mask: torch.Tensor, res: list,
                    dhs: list) -> None:
    """The MI kernels at alpha = 0 and beta1 = beta2 = 1, where the MI
    pre-activation is the LSTM's, xp + hp + b: ``name``'s forward (two
    directions of mi_lstm_fwd, or one) against the cluster LSTM forward
    (bilstm_fwd, or lstm_fwd) fed xp + b, at the BILSTM_* bounds, and its
    backward's dpre against the LSTM backward's dxp from the same h and c,
    at the BWD_* bounds.  ``res``: the layer's wh, alpha, beta1, beta2 and
    b, each of every direction in turn (only wh and b are used)."""
    from asr_study_torch.ops import mi_lstm as mi
    from asr_study_torch.ops.bilstm import (bilstm, bilstm_bwd, lstm,
                                            lstm_bwd, lstm_geometry)

    n = len(xps)
    t, b, gh = xps[0].shape
    whs, bs = list(res[:n]), list(res[4 * n:])
    ones = [torch.ones_like(v) for v in bs]
    vecs = [torch.zeros_like(v) for v in bs] + ones + ones + bs
    lstm_xps = [(x + b_).contiguous() for x, b_ in zip(xps, bs)]
    designs = {lstm_geometry(gh // 4, b, n).design,
               mi.mi_geometry(gh // 4, b, n).design}
    require(designs == {"cluster"}, f"{name} anchor runs {designs}")
    with torch.no_grad():
        if n == 2:
            got = mi.bi_mi_lstm(*xps, mask, *whs, *vecs)
            want = bilstm(*lstm_xps, mask, *whs)
            d_k = mi.bi_mi_lstm_bwd(*xps, mask, *whs, *vecs, *want, *dhs)
            d_w = bilstm_bwd(*lstm_xps, mask, *whs, *want, *dhs)
        else:
            got = mi.mi_lstm(xps[0], mask, whs[0], *vecs)
            want = lstm(lstm_xps[0], mask, whs[0])
            d_k = (mi.mi_lstm_bwd(xps[0], mask, whs[0], *vecs, *want,
                                  dhs[0]),)
            d_w = (lstm_bwd(lstm_xps[0], mask, whs[0], *want, dhs[0]),)
    torch.cuda.synchronize()
    f_err = max(float((k - w).abs().max()) for k, w in zip(got, want))
    b_err = max(float((k - w).abs().max()) for k, w in zip(d_k, d_w))
    print(f"{name} at alpha = 0, beta1 = beta2 = 1 vs the cluster "
          f"{'bilstm' if n == 2 else 'lstm'} kernels fed xp + b: T={t} B={b} "
          f"H={gh // 4}, forward max_abs_err={f_err:.3e} (tol "
          f"{BILSTM_ATOL:g} + {BILSTM_RTOL:g}*|lstm|), dpre vs dxp "
          f"max_abs_err={b_err:.3e} (tol {BWD_ATOL:g} + {BWD_RTOL:g}*|lstm|)")
    require(all(within(k, w, BILSTM_ATOL, BILSTM_RTOL)
                for k, w in zip(got, want)),
            f"{name}_fwd at alpha = 0 differs from the LSTM kernel")
    require(all(within(k, w, BWD_ATOL, BWD_RTOL) for k, w in zip(d_k, d_w)),
            f"{name}_bwd at alpha = 0 differs from the LSTM kernel")


def check_mi_designs(dev: torch.device) -> None:
    """Phase 3 for the MI-LSTM kernels beyond the main paths, as
    ``check_gru_designs`` for the GRU: the four wrappers against their
    plain versions at shapes ragged for the cluster tiling (H=100: 13 units
    a CTA, the last CTA 9; B=5 and B=33, rows left over in the last group;
    a row masked on every frame; T=1) and at H=512 (the stream design),
    each case in the design ``mi_geometry`` picks (held by the by-design
    counts), at the forward and backward tolerances.  The MI vectors are
    about 1 (alpha, beta1, beta2) and 0 (b), none exactly."""
    from asr_study_torch.ops.mi_lstm import (bi_mi_lstm, bi_mi_lstm_bwd,
                                             bi_mi_lstm_bwd_plain,
                                             bi_mi_lstm_plain, mi_geometry,
                                             mi_lstm, mi_lstm_bwd,
                                             mi_lstm_bwd_plain, mi_lstm_plain)

    g = torch.Generator().manual_seed(SEED + 14)
    wrappers = {"bi_mi_lstm_fwd": bi_mi_lstm, "bi_mi_lstm_bwd": bi_mi_lstm_bwd,
                "mi_lstm_fwd": mi_lstm, "mi_lstm_bwd": mi_lstm_bwd}
    for t, b, h, masked in ((37, 5, 100, True), (29, 33, 100, True),
                            (40, 33, 256, True), (1, 33, 256, False),
                            (1, 5, 100, False), (64, 9, 256, True),
                            (20, 3, 512, True)):
        xps = [torch.randn(t, b, 4 * h, generator=g) for _ in range(2)]
        whs = [torch.randn(h, 4 * h, generator=g) / h ** 0.5
               for _ in range(2)]
        vecs = [c + 0.3 * torch.randn(4 * h, generator=g)
                for c in (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0)]
        lengths = torch.randint(1, t + 1, (b,), generator=g)
        lengths[0] = t
        mask = (torch.arange(t)[:, None] < lengths[None, :]).float()
        if masked:
            mask[:, b - 1] = 0.0
        dhs = [torch.randn(t, b, h, generator=g).to(dev) for _ in range(2)]
        xps = [x.to(dev) for x in xps]
        whs = [w.to(dev) for w in whs]
        vecs = [v.to(dev) for v in vecs]
        mask = mask[..., None].to(dev)
        designs = {n: mi_geometry(h, b, n).design for n in (2, 1)}
        before = {k: dict(w.by_design) for k, w in wrappers.items()}
        with torch.no_grad():
            bi = (*xps, mask, *whs, *vecs)
            fb = bi_mi_lstm(*bi), bi_mi_lstm_plain(*bi)
            bb = (bi_mi_lstm_bwd(*bi, *fb[0], *dhs),
                  bi_mi_lstm_bwd_plain(*bi, *fb[0], *dhs))
            uni = (xps[0], mask, whs[0], *vecs[0::2])
            fu = mi_lstm(*uni), mi_lstm_plain(*uni)
            bu = ([mi_lstm_bwd(*uni, *fu[0], dhs[0])],
                  [mi_lstm_bwd_plain(*uni, *fu[0], dhs[0])])
        torch.cuda.synchronize()
        for name, w in wrappers.items():
            design = designs[2 if name.startswith("bi") else 1]
            require(w.by_design[design] == before[name][design] + 1,
                    f"{name} did not run the {design} design at T={t} B={b} "
                    f"H={h}")
        errs = {}
        for name, (got, want), atol, rtol in (
                ("bi_mi_lstm_fwd", fb, BILSTM_ATOL, BILSTM_RTOL),
                ("bi_mi_lstm_bwd", bb, BWD_ATOL, BWD_RTOL),
                ("mi_lstm_fwd", fu, BILSTM_ATOL, BILSTM_RTOL),
                ("mi_lstm_bwd", bu, BWD_ATOL, BWD_RTOL)):
            errs[name] = max(float((k - p).abs().max())
                             for k, p in zip(got, want))
            require(all(within(k, p, atol, rtol) for k, p in zip(got, want)),
                    f"{name} kernel disagrees with plain at T={t} B={b} "
                    f"H={h}")
        print(f"MI kernels vs plain at T={t} B={b} H={h}"
              f"{', the last row masked throughout' if masked else ''} "
              f"(designs: bi {designs[2]}, uni {designs[1]}): max_abs_err "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (tol fwd {BILSTM_ATOL:g} + {BILSTM_RTOL:g}*|plain|, bwd "
              f"{BWD_ATOL:g} + {BWD_RTOL:g}*|plain|)")



def check_zoneout_anchor(name: str, xps: list, mask: torch.Tensor,
                         res: list, dhs: list) -> None:
    """The zoneout kernels at zh = zc = 1, where every step takes the new
    state and the zoneout recurrence is the LSTM's: ``name``'s forward (two
    directions of zoneout_lstm_fwd, or one) against the cluster LSTM
    forward (bilstm_fwd, or lstm_fwd) on the same xp and wh, within 1e-6 +
    1e-6*|lstm| (the same layout and summation order: only the mix, exact
    at weight 1, differs), and its backward's dxp against the LSTM
    backward's from the same h and c, at the BWD_* bounds (the zoneout
    backward recomputes tanh(c_new) from the gates, the LSTM's reads the
    stored c).  ``res``: the layer's zh, zc and wh, each of every direction
    in turn (only wh is used)."""
    from asr_study_torch.ops import zoneout_lstm as zo
    from asr_study_torch.ops.bilstm import (bilstm, bilstm_bwd, lstm,
                                            lstm_bwd, lstm_geometry)

    n = len(xps)
    t, b, gh = xps[0].shape
    whs = list(res[2 * n:])
    ones = [torch.ones(t, b, gh // 4, device=xps[0].device)] * (2 * n)
    designs = {lstm_geometry(gh // 4, b, n).design,
               zo.zoneout_geometry(gh // 4, b, n).design}
    require(designs == {"cluster"}, f"{name} anchor runs {designs}")
    with torch.no_grad():
        if n == 2:
            got = zo.bi_zoneout_lstm(*xps, mask, *ones, *whs)
            want = bilstm(*xps, mask, *whs)
            d_k = zo.bi_zoneout_lstm_bwd(*xps, mask, *ones, *whs, *want,
                                         *dhs)
            d_w = bilstm_bwd(*xps, mask, *whs, *want, *dhs)
        else:
            got = zo.zoneout_lstm(xps[0], mask, *ones, whs[0])
            want = lstm(xps[0], mask, whs[0])
            d_k = (zo.zoneout_lstm_bwd(xps[0], mask, *ones, whs[0], *want,
                                       dhs[0]),)
            d_w = (lstm_bwd(xps[0], mask, whs[0], *want, dhs[0]),)
    torch.cuda.synchronize()
    f_err = max(float((k - w).abs().max()) for k, w in zip(got, want))
    b_err = max(float((k - w).abs().max()) for k, w in zip(d_k, d_w))
    print(f"{name} at zh = zc = 1 vs the cluster "
          f"{'bilstm' if n == 2 else 'lstm'} kernels on the same inputs: "
          f"T={t} B={b} H={gh // 4}, forward max_abs_err={f_err:.3e}, "
          f"bit-equal {all(torch.equal(k, w) for k, w in zip(got, want))} "
          f"(tol 1e-6 + 1e-6*|lstm|), dxp max_abs_err={b_err:.3e}, "
          f"bit-equal {all(torch.equal(k, w) for k, w in zip(d_k, d_w))} "
          f"(tol {BWD_ATOL:g} + {BWD_RTOL:g}*|lstm|)")
    require(all(within(k, w, 1e-6, 1e-6) for k, w in zip(got, want)),
            f"{name}_fwd at zh = zc = 1 differs from the LSTM kernel")
    require(all(within(k, w, BWD_ATOL, BWD_RTOL) for k, w in zip(d_k, d_w)),
            f"{name}_bwd at zh = zc = 1 differs from the LSTM kernel")


def check_zoneout_designs(dev: torch.device) -> None:
    """Phase 3 for the zoneout-LSTM kernels beyond the main paths, as
    ``check_mi_designs`` for the MI kernels: the four wrappers against their
    plain versions, with Bernoulli(0.9) mix weights, at shapes ragged for
    the cluster tiling (H=100: 13 units a CTA, the last CTA 9; B=5 and
    B=33, rows left over in the last group; B=49 at H=100, which takes the
    stream design in two directions by size and the cluster one at R=8 in
    one; a row masked on every frame; T=1) and at H=300 (the stream
    design), each case in the design ``zoneout_geometry`` picks (held by
    the by-design counts), at the forward and backward tolerances."""
    from asr_study_torch.ops.zoneout_lstm import (bi_zoneout_lstm,
                                                  bi_zoneout_lstm_bwd,
                                                  bi_zoneout_lstm_bwd_plain,
                                                  bi_zoneout_lstm_plain,
                                                  zoneout_geometry,
                                                  zoneout_lstm,
                                                  zoneout_lstm_bwd,
                                                  zoneout_lstm_bwd_plain,
                                                  zoneout_lstm_plain)

    g = torch.Generator().manual_seed(SEED + 15)
    wrappers = {"bi_zoneout_lstm_fwd": bi_zoneout_lstm,
                "bi_zoneout_lstm_bwd": bi_zoneout_lstm_bwd,
                "zoneout_lstm_fwd": zoneout_lstm,
                "zoneout_lstm_bwd": zoneout_lstm_bwd}
    for t, b, h, masked in ((37, 5, 100, True), (29, 49, 100, True),
                            (40, 33, 256, True), (1, 33, 256, False),
                            (1, 5, 100, False), (64, 9, 256, True),
                            (20, 3, 300, True)):
        xps = [torch.randn(t, b, 4 * h, generator=g) for _ in range(2)]
        whs = [torch.randn(h, 4 * h, generator=g) / h ** 0.5
               for _ in range(2)]
        zs = [(torch.rand(t, b, h, generator=g) < 0.9).float()
              for _ in range(4)]
        lengths = torch.randint(1, t + 1, (b,), generator=g)
        lengths[0] = t
        mask = (torch.arange(t)[:, None] < lengths[None, :]).float()
        if masked:
            mask[:, b - 1] = 0.0
        dhs = [torch.randn(t, b, h, generator=g).to(dev) for _ in range(2)]
        xps = [x.to(dev) for x in xps]
        whs = [w.to(dev) for w in whs]
        zs = [z.to(dev) for z in zs]
        mask = mask[..., None].to(dev)
        designs = {n: zoneout_geometry(h, b, n).design for n in (2, 1)}
        before = {k: dict(w.by_design) for k, w in wrappers.items()}
        with torch.no_grad():
            bi = (*xps, mask, *zs, *whs)
            fb = bi_zoneout_lstm(*bi), bi_zoneout_lstm_plain(*bi)
            bb = (bi_zoneout_lstm_bwd(*bi, *fb[0], *dhs),
                  bi_zoneout_lstm_bwd_plain(*bi, *fb[0], *dhs))
            uni = (xps[0], mask, zs[0], zs[2], whs[0])
            fu = zoneout_lstm(*uni), zoneout_lstm_plain(*uni)
            bu = ([zoneout_lstm_bwd(*uni, *fu[0], dhs[0])],
                  [zoneout_lstm_bwd_plain(*uni, *fu[0], dhs[0])])
        torch.cuda.synchronize()
        for name, w in wrappers.items():
            design = designs[2 if name.startswith("bi") else 1]
            require(w.by_design[design] == before[name][design] + 1,
                    f"{name} did not run the {design} design at T={t} B={b} "
                    f"H={h}")
        errs = {}
        for name, (got, want), atol, rtol in (
                ("bi_zoneout_lstm_fwd", fb, BILSTM_ATOL, BILSTM_RTOL),
                ("bi_zoneout_lstm_bwd", bb, BWD_ATOL, BWD_RTOL),
                ("zoneout_lstm_fwd", fu, BILSTM_ATOL, BILSTM_RTOL),
                ("zoneout_lstm_bwd", bu, BWD_ATOL, BWD_RTOL)):
            errs[name] = max(float((k - p).abs().max())
                             for k, p in zip(got, want))
            require(all(within(k, p, atol, rtol) for k, p in zip(got, want)),
                    f"{name} kernel disagrees with plain at T={t} B={b} "
                    f"H={h}")
        print(f"zoneout kernels vs plain at T={t} B={b} H={h}"
              f"{', the last row masked throughout' if masked else ''} "
              f"(designs: bi {designs[2]}, uni {designs[1]}): max_abs_err "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (tol fwd {BILSTM_ATOL:g} + {BILSTM_RTOL:g}*|plain|, bwd "
              f"{BWD_ATOL:g} + {BWD_RTOL:g}*|plain|)")

class Wire(NamedTuple):
    """One codec's wire buffers of the serving batches, end to end."""
    cap: int                     # words a buffer
    n_pad: int
    scap: int | None             # dpack's sample capacity
    dev: torch.Tensor            # the chunk on the card
    cpu: torch.Tensor            # the same chunk on the host
    offsets: range               # each buffer's first word


def make_wire(wavs: list, codec: str, dev: torch.device) -> Wire:
    from asr_study_torch.cli.predict import pack_batches

    chunk, cap, n_pad, scap = pack_batches(wavs, BATCH, codec)
    cpu = torch.from_numpy(chunk)
    return Wire(cap, n_pad, scap, cpu.to(dev), cpu,
                range(0, chunk.shape[0], cap))


def edge_dpack_batches() -> dict:
    """The dpack decode's edge cases (tests/test_wire.py): width extremes in
    one batch (an all-zero block, w=0; ones, w=1-2; a full-scale +-32768
    alternation, w=16), and single utterances of 1, 3, 9 and 13 blocks (13
    divides by no grouping of blocks)."""
    rng = np.random.RandomState(SEED + 9)
    edge = [(rng.randn(n) * 0.3).astype(np.float32)
            for n in (3100, 7000, 4095)]
    edge += [np.zeros(4096, np.int16), np.ones(4097, np.int16),
             np.tile(np.array([32767, -32768], np.int16), 2100)]
    out = {"width extremes": edge}
    for n in (100, 3 * 4096 - 7, 9 * 4096 - 5, 13 * 4096 - 1):
        out[f"{-(-n // 4096)} block(s)"] = [
            (rng.randn(n) * 0.2).astype(np.float32)]
    return out


def kernel_device_ms(fn, reps: int, part: str) -> float | None:
    """Device ms per call of the kernels whose name holds ``part``, from
    torch.profiler over ``reps`` calls; None when it saw none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and part in e.name)
    return us / 1e3 / reps if us else None


def check_dpack_kernel(dev: torch.device, card: str, groups: list,
                       wires: dict) -> dict:
    """Phase 3 for the dpack decode: bit for bit against its plain version
    over the whole [scap] stream of every serving batch's dpack wire and of
    the edge batches, and unpack_audio over dpack equal to it over pcm16;
    times at the first serving batch; the host encode time."""
    from asr_study_torch.data import wire
    from asr_study_torch.ops.dpack import dpack_decode, dpack_decode_plain

    enc_ms = []
    for g in groups:
        t0 = time.perf_counter()
        wire.dpack_encode(g)
        enc_ms.append(1e3 * (time.perf_counter() - t0))
    print(f"dpack host encode (NumPy, host time, not the card's): "
          f"{np.mean(enc_ms):.1f} ms per batch of {BATCH} (min "
          f"{min(enc_ms):.1f}, max {max(enc_ms):.1f})")

    dp, pcm = wires["dpack"], wires["pcm16"]
    cases = []
    for k, (o, o_pcm) in enumerate(zip(dp.offsets, pcm.offsets)):
        cases.append((f"serving batch {k}", dp.dev[o: o + dp.cap], BATCH,
                      dp.n_pad, dp.scap, pcm.dev[o_pcm: o_pcm + pcm.cap]))
    for name, ws in edge_dpack_batches().items():
        b = len(ws)
        cap, scap = wire.dpack_measure([ws], b, align=256)
        n_pad = -(-max(len(x) for x in ws) // 2048) * 2048
        flat = wire.pack_audio(ws, cap, batch=b, codec="dpack", scap=scap)
        flat_pcm = wire.pack_audio(ws, wire.wire_cap(b, sum(map(len, ws))),
                                   batch=b)
        cases.append((name, torch.from_numpy(flat).to(dev), b, n_pad, scap,
                      torch.from_numpy(flat_pcm).to(dev)))
    for name, flat, b, n_pad, scap, flat_pcm in cases:
        args = wire.dpack_regions(flat, b, scap)
        got = dpack_decode(*args, scap)
        want = dpack_decode_plain(*args, scap)
        wav_d, len_d = wire.unpack_audio(flat, b, n_pad, codec="dpack",
                                         scap=scap)
        wav_p, len_p = wire.unpack_audio(flat_pcm, b, n_pad)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"dpack_decode differs from plain on {name}: max_abs_err "
                f"{float((got - want).abs().max()):.3e}")
        require(torch.equal(wav_d, wav_p) and torch.equal(len_d, len_p),
                f"unpack over dpack differs from pcm16 on {name}")
    print(f"dpack_decode kernel vs plain: bit-equal over the whole stream "
          f"on {len(cases)} wires ({len(dp.offsets)} serving batches of "
          f"{dp.scap // 4096} blocks, scap {dp.scap}; edge: "
          f"{', '.join(c[0] for c in cases[len(dp.offsets):])}); "
          f"unpack_audio over dpack bit-equal to pcm16 on each")

    args = wire.dpack_regions(dp.dev[: dp.cap], BATCH, dp.scap)
    payload, row_start, widths = args
    ms = cuda_ms(lambda: dpack_decode(*args, dp.scap), 50, warmup=5)
    plain_ms = cuda_ms(lambda: dpack_decode_plain(*args, dp.scap), 5)
    dev_ms = kernel_device_ms(lambda: dpack_decode(*args, dp.scap), 20,
                              "dpack")
    w_sum = int(widths.sum())
    # bytes: the payload rows the blocks own, row_start and widths, the f32
    # stream; operations: one integer add a sample in the scan (the
    # expansion's shifts and masks are left out, so a lower bound)
    d_bound = bound(float(dp.scap),
                    256 * 2 * w_sum + tensor_bytes(row_start, widths)
                    + 4.0 * dp.scap)
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    print(f"[{card}] dpack_decode (one batch: {dp.scap // 4096} blocks, "
          f"{16 * w_sum * 256 / dp.scap:.2f} bits a sample of scap): "
          f"kernel {ms:.4f} ms (device time of its two launches "
          f"{dev_txt}, torch.profiler), plain {plain_ms:.4f} ms, bound "
          f"{d_bound[0]:.4f} ms ({d_bound[1]})")
    print("dpack_decode library yardstick: none; no PyTorch call decodes "
          "dpack (bit-plane expansion with a carried prefix sum), so "
          "library_ms is null")
    return {"errs": {"dpack_decode": 0.0},
            "times": {"dpack_decode": (ms, plain_ms)},
            "bounds": {"dpack_decode": d_bound},
            "library": {"dpack_decode": None}}


# every kernel of the port: name -> (source in asr_study_torch/csrc, the TPU
# kernel it replaces in asr_study_tpu)
KERNELS = {
    "fbank": ("fbank.cu", "features/pallas_fbank.py:107"),
    "bilstm_fwd": ("bilstm_fwd.cu", "ops/pallas_bilstm.py:84"),
    "bilstm_bwd": ("bilstm_bwd.cu", "ops/pallas_bilstm.py:125"),
    "ctc_alpha": ("ctc_warp.cu", "ops/pallas_ctc.py:76"),
    "ctc_beta": ("ctc_warp.cu", "ops/pallas_ctc.py:101"),
    "bigru_fwd": ("gru_fwd.cu", "ops/pallas_bigru.py:69"),
    "bigru_bwd": ("gru_bwd.cu", "ops/pallas_bigru.py:92"),
    "gru_fwd": ("gru_fwd.cu", "ops/pallas_gru.py:41"),
    "gru_bwd": ("gru_bwd.cu", "ops/pallas_gru.py:60"),
    "lstm_fwd": ("bilstm_fwd.cu", "ops/pallas_lstm.py:83"),
    "lstm_bwd": ("bilstm_bwd.cu", "ops/pallas_lstm.py:173"),
    "bi_ln_lstm_fwd": ("ln_lstm_fwd.cu", "ops/pallas_bi_ln_lstm.py:39"),
    "bi_ln_lstm_bwd": ("ln_lstm_bwd.cu", "ops/pallas_bi_ln_lstm.py:81"),
    "ln_lstm_fwd": ("ln_lstm_fwd.cu", "ops/pallas_ln_lstm.py:106"),
    "ln_lstm_bwd": ("ln_lstm_bwd.cu", "ops/pallas_ln_lstm.py:198"),
    "bi_zoneout_lstm_fwd": ("zoneout_lstm_fwd.cu",
                            "ops/pallas_bi_zoneout_lstm.py:41"),
    "bi_zoneout_lstm_bwd": ("zoneout_lstm_bwd.cu",
                            "ops/pallas_bi_zoneout_lstm.py:83"),
    "zoneout_lstm_fwd": ("zoneout_lstm_fwd.cu",
                         "ops/pallas_zoneout_lstm.py:56"),
    "zoneout_lstm_bwd": ("zoneout_lstm_bwd.cu",
                         "ops/pallas_zoneout_lstm.py:133"),
    "bi_mi_lstm_fwd": ("mi_lstm_fwd.cu", "ops/pallas_bi_mi_lstm.py:39"),
    "bi_mi_lstm_bwd": ("mi_lstm_bwd.cu", "ops/pallas_bi_mi_lstm.py:81"),
    "mi_lstm_fwd": ("mi_lstm_fwd.cu", "ops/pallas_mi_lstm.py:59"),
    "mi_lstm_bwd": ("mi_lstm_bwd.cu", "ops/pallas_mi_lstm.py:132"),
    "dpack_decode": ("dpack.cu", "ops/pallas_dpack.py:56"),
    # the LSTM wrappers' wide design (256 < H <= 512): the same TPU
    # kernels, another source
    "bilstm_fwd_wide": ("lstm_wide_fwd.cu", "ops/pallas_bilstm.py:84"),
    "bilstm_bwd_wide": ("lstm_wide_bwd.cu", "ops/pallas_bilstm.py:125"),
    "lstm_fwd_wide": ("lstm_wide_fwd.cu", "ops/pallas_lstm.py:83"),
    "lstm_bwd_wide": ("lstm_wide_bwd.cu", "ops/pallas_lstm.py:173"),
    # the GRU wrappers' wide design (256 < H <= 512)
    "bigru_fwd_wide": ("gru_wide_fwd.cu", "ops/pallas_bigru.py:69"),
    "bigru_bwd_wide": ("gru_wide_bwd.cu", "ops/pallas_bigru.py:92"),
    "gru_fwd_wide": ("gru_wide_fwd.cu", "ops/pallas_gru.py:41"),
    "gru_bwd_wide": ("gru_wide_bwd.cu", "ops/pallas_gru.py:60"),
}
# kernel line row of the wide design -> the wrapper that launches it
WIDE_ROWS = {"bilstm_fwd_wide": "bilstm_fwd", "bilstm_bwd_wide": "bilstm_bwd",
             "lstm_fwd_wide": "lstm_fwd", "lstm_bwd_wide": "lstm_bwd",
             "bigru_fwd_wide": "bigru_fwd", "bigru_bwd_wide": "bigru_bwd",
             "gru_fwd_wide": "gru_fwd", "gru_bwd_wide": "gru_bwd"}

# training paths: label -> (zoo model, its hparams, forward and backward
# kernel of its recurrence, recurrent layers, what it is); the LN paths'
# first step is held against the CPU on LN_CHECK_T frames (CHAOTIC); the
# zoneout paths train at their default rates 0.1, the mix weights drawn
# on the card from a CUDA generator
_CONFIG3 = f"num_hiddens={HIDDEN},num_layers={TRAIN_LAYERS},dropout=0.0"
TRAIN_PATHS = {
    "deep_blstm": ("deep_blstm", _CONFIG3, "bilstm_fwd", "bilstm_bwd",
                   TRAIN_LAYERS, f"{TRAIN_LAYERS}x{HIDDEN}"),
    "deep_gru": ("deep_gru", _CONFIG3, "bigru_fwd", "bigru_bwd",
                 TRAIN_LAYERS, f"{TRAIN_LAYERS}x{HIDDEN}"),
    "deep_gru uni": ("deep_gru", _CONFIG3 + ",bidirectional=false",
                     "gru_fwd", "gru_bwd", TRAIN_LAYERS,
                     f"{TRAIN_LAYERS}x{HIDDEN}"),
    "deep_blstm uni": ("deep_blstm", _CONFIG3 + ",bidirectional=false",
                       "lstm_fwd", "lstm_bwd", TRAIN_LAYERS,
                       f"{TRAIN_LAYERS}x{HIDDEN}"),
    "highway_blstm": ("highway_blstm", f"num_hiddens={HIDDEN},dropout=0.0",
                      "bilstm_fwd", "bilstm_bwd", 5, f"5x{HIDDEN} highway"),
    "deep_speech": ("deep_speech", "dropout=0.0,input_dropout=0.0",
                    "bilstm_fwd_wide", "bilstm_bwd_wide", 1,
                    "3x512 dense + 1x512 BLSTM"),
    "deep_speech uni": ("deep_speech", "dropout=0.0,input_dropout=0.0,"
                        "bidirectional=false", "lstm_fwd_wide",
                        "lstm_bwd_wide", 1,
                        "3x512 dense + 1x512 unidirectional LSTM"),
    "ln_blstm": ("ln_blstm", _CONFIG3, "bi_ln_lstm_fwd", "bi_ln_lstm_bwd",
                 TRAIN_LAYERS, f"{TRAIN_LAYERS}x{HIDDEN} LN"),
    "ln_blstm uni": ("ln_blstm", _CONFIG3 + ",bidirectional=false",
                     "ln_lstm_fwd", "ln_lstm_bwd", TRAIN_LAYERS,
                     f"{TRAIN_LAYERS}x{HIDDEN} LN"),
    "zoneout_blstm": ("zoneout_blstm", _CONFIG3, "bi_zoneout_lstm_fwd",
                      "bi_zoneout_lstm_bwd", TRAIN_LAYERS,
                      f"{TRAIN_LAYERS}x{HIDDEN} zoneout 0.1/0.1"),
    "zoneout_blstm uni": ("zoneout_blstm", _CONFIG3 + ",bidirectional=false",
                          "zoneout_lstm_fwd", "zoneout_lstm_bwd",
                          TRAIN_LAYERS,
                          f"{TRAIN_LAYERS}x{HIDDEN} zoneout 0.1/0.1"),
    "mi_blstm": ("mi_blstm", _CONFIG3, "bi_mi_lstm_fwd", "bi_mi_lstm_bwd",
                 TRAIN_LAYERS, f"{TRAIN_LAYERS}x{HIDDEN} MI"),
    "mi_blstm uni": ("mi_blstm", _CONFIG3 + ",bidirectional=false",
                     "mi_lstm_fwd", "mi_lstm_bwd", TRAIN_LAYERS,
                     f"{TRAIN_LAYERS}x{HIDDEN} MI"),
    "deep_gru 512": ("deep_gru", f"num_hiddens=512,num_layers={TRAIN_LAYERS}"
                     ",dropout=0.0", "bigru_fwd_wide", "bigru_bwd_wide",
                     TRAIN_LAYERS, f"{TRAIN_LAYERS}x512 BGRU"),
    "deep_gru 512 uni": ("deep_gru", f"num_hiddens=512,num_layers="
                         f"{TRAIN_LAYERS},dropout=0.0,bidirectional=false",
                         "gru_fwd_wide", "gru_bwd_wide", TRAIN_LAYERS,
                         f"{TRAIN_LAYERS}x512 unidirectional GRU"),
}
CHAOTIC = ("ln_blstm", "ln_blstm uni")


def launch_counters() -> dict:
    """Every kernel wrapper of the port, by kernel name."""
    from asr_study_torch.features.fbank import fbank
    from asr_study_torch.ops import ctc
    from asr_study_torch.ops.bilstm import bilstm, bilstm_bwd, lstm, lstm_bwd
    from asr_study_torch.ops.dpack import dpack_decode
    from asr_study_torch.ops.gru import bigru, bigru_bwd, gru, gru_bwd
    from asr_study_torch.ops.ln_lstm import (bi_ln_lstm, bi_ln_lstm_bwd,
                                             ln_lstm, ln_lstm_bwd)
    from asr_study_torch.ops.mi_lstm import (bi_mi_lstm, bi_mi_lstm_bwd,
                                             mi_lstm, mi_lstm_bwd)
    from asr_study_torch.ops.zoneout_lstm import (bi_zoneout_lstm,
                                                  bi_zoneout_lstm_bwd,
                                                  zoneout_lstm,
                                                  zoneout_lstm_bwd)
    return {"fbank": fbank, "bilstm_fwd": bilstm, "bilstm_bwd": bilstm_bwd,
            "ctc_alpha": ctc.ctc_alpha, "ctc_beta": ctc.ctc_beta,
            "bigru_fwd": bigru, "bigru_bwd": bigru_bwd, "gru_fwd": gru,
            "gru_bwd": gru_bwd, "lstm_fwd": lstm, "lstm_bwd": lstm_bwd,
            "bi_ln_lstm_fwd": bi_ln_lstm, "bi_ln_lstm_bwd": bi_ln_lstm_bwd,
            "ln_lstm_fwd": ln_lstm, "ln_lstm_bwd": ln_lstm_bwd,
            "bi_zoneout_lstm_fwd": bi_zoneout_lstm,
            "bi_zoneout_lstm_bwd": bi_zoneout_lstm_bwd,
            "zoneout_lstm_fwd": zoneout_lstm,
            "zoneout_lstm_bwd": zoneout_lstm_bwd,
            "bi_mi_lstm_fwd": bi_mi_lstm, "bi_mi_lstm_bwd": bi_mi_lstm_bwd,
            "mi_lstm_fwd": mi_lstm, "mi_lstm_bwd": mi_lstm_bwd,
            "dpack_decode": dpack_decode}


# the wrappers of the LSTM, GRU, layer-norm, zoneout and MI LSTM kernels
# and of the CTC kernels, which count their launches by design too
DESIGN_WRAPPERS = ("bilstm_fwd", "bilstm_bwd", "lstm_fwd", "lstm_bwd",
                   "bigru_fwd", "bigru_bwd", "gru_fwd", "gru_bwd",
                   "bi_ln_lstm_fwd", "bi_ln_lstm_bwd", "ln_lstm_fwd",
                   "ln_lstm_bwd", "bi_zoneout_lstm_fwd",
                   "bi_zoneout_lstm_bwd", "zoneout_lstm_fwd",
                   "zoneout_lstm_bwd", "bi_mi_lstm_fwd", "bi_mi_lstm_bwd",
                   "mi_lstm_fwd", "mi_lstm_bwd", "ctc_alpha", "ctc_beta")


def reset_counts() -> None:
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    for name in DESIGN_WRAPPERS:
        counters[name].by_design = dict.fromkeys(counters[name].by_design, 0)


def check_designs(label: str, hidden: int, batch: int,
                  s_len: int | None = None) -> None:
    """The LSTM, GRU, layer-norm, zoneout and MI LSTM kernels launched
    since the counts were reset ran the design ``lstm_geometry`` /
    ``gru_geometry`` / ``ln_geometry`` / ``zoneout_geometry`` /
    ``mi_geometry`` gives this path's width and batch, and the CTC kernels
    the one ``ctc_design`` gives its lattice of ``s_len`` states, and no
    other."""
    from asr_study_torch.ops.bilstm import lstm_geometry
    from asr_study_torch.ops.ctc import ctc_design
    from asr_study_torch.ops.gru import gru_geometry
    from asr_study_torch.ops.ln_lstm import ln_geometry
    from asr_study_torch.ops.mi_lstm import mi_geometry
    from asr_study_torch.ops.zoneout_lstm import zoneout_geometry

    counters = launch_counters()
    ran = {name: {k: v for k, v in counters[name].by_design.items() if v}
           for name in DESIGN_WRAPPERS if counters[name].launches}
    if not ran:
        return
    print(f"{label}: launches by design (H={hidden}) {ran}")
    for name, by_design in ran.items():
        if name.startswith("ctc"):
            want = ctc_design(s_len)
            require(list(by_design) == [want],
                    f"{label}: {name} ran {by_design}, want only {want}")
            continue
        geometry = (gru_geometry if "gru" in name else
                    ln_geometry if "ln_" in name else
                    zoneout_geometry if "zoneout" in name else
                    mi_geometry if "mi_" in name else lstm_geometry)
        want = geometry(hidden, batch,
                        2 if name.startswith("bi") else 1).design
        require(list(by_design) == [want],
                f"{label}: {name} ran {by_design}, want only {want}")


def read_counts() -> dict:
    """The nonzero launch counts by kernel line row: the LSTM wrappers'
    wide launches under their own rows (WIDE_ROWS), the rest under the
    wrapper's."""
    counters = launch_counters()
    counts = {k: fn.launches for k, fn in counters.items()}
    for row, name in WIDE_ROWS.items():
        counts[row] = counters[name].by_design["wide"]
        counts[name] -= counts[row]
    return {k: v for k, v in counts.items() if v}


class MixTap:
    """The zoneout mix weights of one train-mode run, handed to another:
    inside ``record()`` the train-mode draws are kept (layer by layer, the
    forward cell first); inside ``replay()`` they are handed out in that
    order, on the caller's device, instead of new draws.  Eval mode and the
    other cells are left alone."""

    def __init__(self):
        self.drawn = []

    @contextlib.contextmanager
    def _patched(self, replay: bool):
        from asr_study_torch.models.cells import ZoneoutLSTMCell

        real = ZoneoutLSTMCell.mix
        queue = list(self.drawn)

        def mix(cell, t_steps, batch, train=False, generator=None,
                device=None):
            if train and replay:
                return tuple(z.to(device) for z in queue.pop(0))
            out = real(cell, t_steps, batch, train, generator, device)
            if train:
                self.drawn.append(out)
            return out

        ZoneoutLSTMCell.mix = mix
        try:
            yield
        finally:
            ZoneoutLSTMCell.mix = real
        require(not (replay and queue), "mix weights left over in replay")

    def record(self):
        self.drawn = []
        return self._patched(False)

    def replay(self):
        return self._patched(True)


def check_reproducible(path: str, make, spec, batch, dev) -> None:
    """Two train steps from the same weights, fresh Adam state, batch and
    generator seed: the loss and every gradient must be equal bit for
    bit."""
    from asr_study_torch.train.trainer import Trainer

    runs = []
    for _ in range(2):
        tr = Trainer(make(dev), spec)
        _, m = tr.train_step(tr.init_state(), *batch,
                             torch.Generator(device=dev).manual_seed(SEED + 9))
        runs.append((m["loss"], {n: p.grad for n, p in
                                 tr.model.named_parameters()}))
    (loss0, g0), (loss1, g1) = runs
    differ = [n for n in g0 if not torch.equal(g0[n], g1[n])]
    same = bool(torch.equal(loss0, loss1)) and not differ
    print(f"{path} train, two identical steps (same weights, fresh Adam "
          f"state, batch and generator seed): loss bit-equal "
          f"{bool(torch.equal(loss0, loss1))} ({float(loss0):.6f} vs "
          f"{float(loss1):.6f}), gradients bit-equal "
          f"{len(g0) - len(differ)}/{len(g0)}"
          + (f"; differing: {differ[:4]}" if differ else ""))
    require(same, f"{path}: two identical train steps differ")


def training_slice(dev: torch.device, card: str, path: str = "deep_blstm",
                   with_fit: bool = True) -> dict:
    """Phases 6 and 7 for one of TRAIN_PATHS: the config-3 training shapes
    through Trainer (and, ``with_fit``, fit with a checkpoint)."""
    from asr_study_torch.models.zoo import build_model
    from asr_study_torch.train.trainer import Trainer, make_optimizer

    model_name, hp, fwd_name, bwd_name, layers, desc = TRAIN_PATHS[path]

    def per_steps(n, evals=0):
        return {fwd_name: layers * (n + evals), bwd_name: layers * n,
                "ctc_alpha": n + evals, "ctc_beta": n}

    def make(device, seed=SEED):
        return build_model(model_name, hp, num_classes=NUM_CLASSES,
                           input_dim=FEATS,
                           generator=torch.Generator().manual_seed(seed),
                           device=device)

    spec = make_optimizer("adam", 1e-4, 400.0)
    rng = np.random.RandomState(SEED)
    host = (rng.randn(TRAIN_B, TRAIN_T, FEATS).astype(np.float32),
            np.full(TRAIN_B, TRAIN_T, np.int32),
            rng.randint(0, NUM_CLASSES, (TRAIN_B, TRAIN_L)).astype(np.int32),
            np.full(TRAIN_B, TRAIN_L, np.int32),
            np.ones(TRAIN_B, np.float32))
    batch_cpu = [torch.from_numpy(a) for a in host]
    batch = [a.to(dev) for a in batch_cpu]
    model = make(dev)
    model_cpu = make("cpu")
    trainer = Trainer(model, spec)
    state = trainer.init_state()
    # draws in train mode (the zoneout mix weights) come from the card
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tap = MixTap()

    # the main path: TRAIN_STEPS steps on one batch, counted
    reset_counts()
    with tap.record():
        state, m = trainer.train_step(state, *batch, gen)
    losses = [m["loss"]]
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    loss_1, gnorm_1 = float(m["loss"]), float(m["grad_norm"])
    for _ in range(TRAIN_STEPS - 1):
        state, m = trainer.train_step(state, *batch, gen)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    launches = read_counts()
    losses = torch.stack(losses).cpu()
    print(f"train slice: {path} {desc} B={TRAIN_B} "
          f"T={TRAIN_T} L={TRAIN_L}, adam 1e-4 clip 400; launches over "
          f"{TRAIN_STEPS} steps {launches}, per step "
          f"{ {k: v / TRAIN_STEPS for k, v in launches.items()} }")
    require(launches == per_steps(TRAIN_STEPS),
            f"train launches {launches}, want {per_steps(TRAIN_STEPS)}")
    check_designs(f"{path} train", model.rnn.layers[0].rnn.hidden, TRAIN_B,
                  2 * TRAIN_L + 1)
    require(bool(torch.isfinite(losses).all()), "non-finite train loss")
    print(f"{path} train loss over {TRAIN_STEPS} steps on one batch: "
          f"{float(losses[0]):.4f} -> {float(losses[-1]):.4f} "
          f"(every 5th step: "
          f"{[round(float(v), 4) for v in losses[::5]]})")
    require(float(losses[-1]) < float(losses[0]), "train loss did not fall")
    check_reproducible(path, make, spec, batch, dev)

    # the first step again on the CPU: the plain path, the same weights
    check_on = "the first step"
    if path in CHAOTIC:
        # the full-size first step on the CPU too: printed, not held
        full = Trainer(make("cpu"), spec)
        _, m_full = full.train_step(full.init_state(), *batch_cpu)
        print(f"{path} train, the first step at full size, kernel path on "
              f"the card vs plain path on the CPU (not held: a chaotic "
              f"recurrence): loss {loss_1:.4f} vs "
              f"{float(m_full['loss']):.4f}, rel "
              f"{abs(loss_1 / float(m_full['loss']) - 1):.3e}; grad_norm "
              f"{gnorm_1:.4g} vs {float(m_full['grad_norm']):.4g}")
        # one step from the same weights on the batch cut to LN_CHECK_T
        # frames and LN_CHECK_T // 4 labels, on the card and on the CPU
        n_lab = LN_CHECK_T // 4
        batch_cpu = [batch_cpu[0][:, :LN_CHECK_T],
                     torch.clamp(batch_cpu[1], max=LN_CHECK_T),
                     batch_cpu[2][:, :n_lab],
                     torch.clamp(batch_cpu[3], max=n_lab), batch_cpu[4]]
        short = Trainer(make(dev), spec)
        _, m = short.train_step(short.init_state(),
                                *[a.to(dev) for a in batch_cpu])
        grads = {n: p.grad.detach().cpu()
                 for n, p in short.model.named_parameters()}
        loss_1, gnorm_1 = float(m["loss"]), float(m["grad_norm"])
        check_on = (f"a step at T={LN_CHECK_T}, L={n_lab} from the same "
                    f"weights (a chaotic recurrence)")
    if tap.drawn:
        check_on += (f" with the card's mix weights of that step "
                     f"({len(tap.drawn)} pairs, mean zh "
                     f"{float(torch.stack([z[0].mean() for z in tap.drawn]).mean()):.4f})")
    t0 = time.perf_counter()
    trainer_cpu = Trainer(model_cpu, spec)
    with tap.replay():
        _, m_cpu = trainer_cpu.train_step(trainer_cpu.init_state(),
                                          *batch_cpu,
                                          torch.Generator().manual_seed(SEED))
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(loss_1 - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
    gnorm_rel = (abs(gnorm_1 - float(m_cpu["grad_norm"]))
                 / float(m_cpu["grad_norm"]))
    grad_rel = {n: float((grads[n] - p.grad).norm() / p.grad.norm())
                for n, p in model_cpu.named_parameters()}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"{path} train, {check_on}, kernel path on the card vs plain "
          f"path on the CPU "
          f"({cpu_s:.1f} s there): loss {loss_1:.4f} vs "
          f"{float(m_cpu['loss']):.4f}, rel {loss_rel:.3e} (tol "
          f"{STEP_LOSS_RTOL:g}); grad_norm {gnorm_1:.4f} vs "
          f"{float(m_cpu['grad_norm']):.4f}, rel {gnorm_rel:.3e} (tol "
          f"{STEP_GNORM_RTOL:g}); gradients of {len(grad_rel)} parameters, "
          f"worst ||diff||/||cpu|| {grad_rel[worst]:.3e} in {worst} (tol "
          f"{STEP_GRAD_RTOL:g})")
    require(loss_rel <= STEP_LOSS_RTOL, "train loss disagrees with CPU")
    require(gnorm_rel <= STEP_GNORM_RTOL, "grad norm disagrees with CPU")
    require(grad_rel[worst] <= STEP_GRAD_RTOL,
            "a gradient disagrees with CPU")

    if with_fit:
        fit_and_resume(dev, make, spec, per_steps)
    stats = train_timings(card, path, desc, layers, trainer, state, batch,
                          gen)
    return {"launches": launches, **stats}


def fit_and_resume(dev, make, spec, per_steps) -> None:
    """fit over a DatasetIterator, checkpoint, restore, continue; ``make``
    builds the model on a device from a seed, ``per_steps`` gives the
    launches that n steps and their evals should count."""
    from asr_study_torch.data.generator import DatasetGenerator
    from asr_study_torch.train.checkpoint import CheckpointManager
    from asr_study_torch.train.loop import fit
    from asr_study_torch.train.trainer import Trainer

    frng = np.random.RandomState(SEED + 2)
    n_utt = 3 * TRAIN_B
    feats = [frng.randn(frng.randint(256, TRAIN_T + 1), FEATS)
             .astype(np.float32) for _ in range(n_utt)]
    labs = [frng.randint(0, NUM_CLASSES, frng.randint(24, TRAIN_L + 1))
            .astype(np.int32) for _ in range(n_utt)]
    gen = DatasetGenerator(batch_size=TRAIN_B)
    train_iter = gen.flow(feats, labs)
    valid_iter = gen.flow(feats[:TRAIN_B], labs[:TRAIN_B])
    n_fit = train_iter.steps_per_epoch
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "run")
        fit_trainer = Trainer(make(dev), spec)
        reset_counts()
        t0 = time.perf_counter()
        fit_state = fit(fit_trainer, fit_trainer.init_state(), train_iter,
                        valid_iter, epochs=1, seed=SEED,
                        ckpt=CheckpointManager(run_dir),
                        log_dir=os.path.join(tmp, "logs"), log_every=1)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = read_counts()
        require(fit_launches == per_steps(n_fit, evals=1),
                f"fit launches {fit_launches}")
        # a fresh model and state, restored from the checkpoint
        resumed = Trainer(make(dev, seed=SEED + 5), spec)
        r_state = resumed.init_state()
        ckpt = CheckpointManager(run_dir)
        ckpt.restore(r_state)
        require(r_state.step == n_fit and ckpt.latest_step == n_fit,
                f"restored step {r_state.step}, latest {ckpt.latest_step}")
        require(all(torch.equal(a, b) for a, b in zip(
            fit_state.model.state_dict().values(),
            r_state.model.state_dict().values())),
            "restored weights differ from the saved ones")
        r_state = fit(resumed, r_state, train_iter, valid_iter, epochs=1,
                      seed=SEED + 1, ckpt=ckpt,
                      log_dir=os.path.join(tmp, "logs"), log_every=1)
        hist = CheckpointManager(run_dir).meta["history"]
        require(r_state.step == 2 * n_fit and ckpt.latest_step == 2 * n_fit,
                f"continued to step {r_state.step}")
        require(len(hist) == 2 and all(np.isfinite(h["val_loss"])
                                       for h in hist),
                f"checkpoint history {hist}")
        print(f"fit: {n_fit} steps + eval in {fit_s:.1f} s, launches "
              f"{fit_launches}; checkpoint at step {n_fit} restored into a "
              f"fresh model (weights equal), continued to step "
              f"{r_state.step}; val_loss per epoch "
              f"{[round(h['val_loss'], 4) for h in hist]}, val_ler "
              f"{[round(h['val_ler'], 4) for h in hist]}, best step "
              f"{ckpt.best_step}")


def train_timings(card: str, path: str, desc: str, layers: int, trainer,
                  state, batch, gen: torch.Generator) -> dict:
    """Phase 7: ms per step, per-stage CUDA events, the busy share; train
    mode draws from ``gen``."""
    from asr_study_torch.ops import ctc

    model = trainer.model
    step_ms = cuda_ms(lambda: trainer.train_step(state, *batch, gen), 10)
    x, il, lab, ll, w = batch

    def staged():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        state.optimizer.zero_grad(set_to_none=True)
        ev[0].record()
        logits = model(x, il, train=True, generator=gen)
        ev[1].record()
        lg = logits.detach().requires_grad_()
        per_seq = ctc.ctc_loss(lg, il, lab, ll, blank_id=model.blank_id)
        ((per_seq * w).sum() / torch.clamp(w.sum(), min=1.0)).backward()
        ev[2].record()
        logits.backward(lg.grad)
        ev[3].record()
        trainer.apply_gradients(state)
        ev[4].record()
        return ev

    staged()
    runs = [staged() for _ in range(5)]
    torch.cuda.synchronize()
    names = (f"forward ({layers} recurrent layers + classifier)",
             "CTC (lattice, alpha, beta, dlp, log-softmax grad)",
             f"backward (classifier + {layers} recurrent layers)",
             "clip + Adam")
    stages = {n: sum(r[i].elapsed_time(r[i + 1]) for r in runs) / len(runs)
              for i, n in enumerate(names)}
    if path == "deep_blstm":
        ctc_stage_split(card, model, batch, gen)
    print(f"[{card}] {path} train step ({desc}, "
          f"B={TRAIN_B}, T={TRAIN_T}, L={TRAIN_L}): {step_ms:.4f} ms/step, "
          f"{1e3 / step_ms:.3f} steps/s, "
          f"{AUDIO_PER_STEP / (step_ms / 1e3):.1f} audio-s/s")
    print(f"[{card}] {path} train step stages, CUDA events, mean of "
          f"{len(runs)}: "
          + "; ".join(f"{n} {v:.4f} ms" for n, v in stages.items())
          + f"; sum {sum(stages.values()):.4f} ms")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            trainer.train_step(state, *batch, gen)
        torch.cuda.synchronize()
    busy = device_busy(prof)
    if busy is None:
        print(f"[{card}] {path} train device busy share: not measured (the "
              "profiler recorded no device activity)")
    else:
        print(f"[{card}] {path} train device busy share over 5 steps: "
              f"{busy[0]:.4f} ({busy[1]:.2f} ms busy of {busy[2]:.2f} ms)")
        tops = sorted(prof.key_averages(), key=lambda a: -getattr(
            a, "self_device_time_total", 0.0))[:8]
        print("  top device time: " + "; ".join(
            f"{a.key[:60]} {getattr(a, 'self_device_time_total', 0.0) / 1e3:.2f}"
            f" ms x{a.count}" for a in tops))
    return {"step_ms": step_ms, "stages": stages, "busy": busy}


def ctc_stage_split(card: str, model, batch, gen: torch.Generator) -> None:
    """The train step's CTC stage split with CUDA events, its pieces run as
    ``ops.ctc.ctc_loss`` and ``CTCNLL`` run them: log-softmax and the
    lattice gather; alpha; the loss reduction; beta; ``posterior_grad``;
    the gather's and log-softmax's backward.  Mean of 5 after one
    warm-up."""
    from asr_study_torch.ops import ctc

    x, il, lab, ll, w = batch
    with torch.no_grad():
        logits = model(x, il, train=True, generator=gen)

    def split():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        lg = logits.detach().requires_grad_()
        ev[0].record()
        lp_ext, valid, skip, end, lens = ctc.lattice(lg, il, lab, ll,
                                                      model.blank_id)
        ev[1].record()
        lp = lp_ext.detach()
        alpha = ctc.ctc_alpha(lp, valid, skip)
        ev[2].record()
        logp = ctc.final_logp(alpha[-1], end, lens)
        nll = -logp
        wsum = torch.clamp(w.sum(), min=1.0)
        loss = (torch.clamp(nll, max=-ctc.LOG_EPS) * w).sum() / wsum
        cot = (nll < -ctc.LOG_EPS).to(nll.dtype) * w / wsum
        ev[3].record()
        gamma = ctc.ctc_beta(lp, valid, alpha, ctc.skip_from_source(skip),
                             ctc.end_indicator(end, lens, lp.shape[2]))
        ev[4].record()
        dlp = ctc.posterior_grad(gamma, logp, cot)
        ev[5].record()
        lp_ext.backward(dlp)
        ev[6].record()
        return ev, loss

    split()
    runs = [split()[0] for _ in range(5)]
    torch.cuda.synchronize()
    names = ("log-softmax + lattice gather", "alpha", "loss reduction",
             "beta", "posterior_grad", "gather + log-softmax backward")
    parts = {n: sum(r[i].elapsed_time(r[i + 1]) for r in runs) / len(runs)
             for i, n in enumerate(names)}
    print(f"[{card}] deep_blstm train step's CTC stage split, CUDA events, "
          f"mean of {len(runs)}: "
          + "; ".join(f"{n} {v:.4f} ms" for n, v in parts.items())
          + f"; sum {sum(parts.values()):.4f} ms")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from asr_study_torch import _build
    from asr_study_torch.cli.predict import pack_batches, serve_batch
    from asr_study_torch.data import wire
    from asr_study_torch.features.device import spectral_plain
    from asr_study_torch.features.fbank import fbank
    from asr_study_torch.features.select import featurizer
    from asr_study_torch.models.zoo import build_model, deep_blstm
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
    # the kernels size their shared memory at launch (ptxas sees none);
    # the bytes at the main paths' shapes, by the formulas of the C entry
    # points in csrc/
    s_len = 2 * TRAIN_L + 1
    # the CTC warp design: static, the chunk edges' row [2][J][2] floats,
    # J = ceil(S / 32)
    print(f"  dynamic shared memory per block: fbank "
          f"{4 * (16 * (400 + 257 + 40) + 16)} B (16 frames, L=400, "
          f"K=257, M=40); ctc_alpha and ctc_beta, the warp design, none "
          f"({16 * -(-s_len // 32)} B static at S={s_len}; the block design "
          f"{4 * 2 * s_len} B and {4 * 4 * s_len} B)")
    print_cluster_geometry()
    for hidden in (HIDDEN, 512):
        fwd_b, bwd_b, nsplit = ln_smem(hidden)
        print(f"  dynamic shared memory per block at H={hidden} of the "
              f"layer-norm LSTM's stream route: ln_lstm_stream_fwd (both "
              f"forms) {fwd_b} B (4 rows), ln_lstm_stream_bwd {bwd_b} B (4 "
              f"rows, {nsplit} partial sums), raised at each launch")

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

    chain = feat.chain
    n_bins, n_mel = chain.mel.shape
    fb_bound = bound(
        # the DFT (cos and sin), mel and DCT products of every frame
        2.0 * BATCH * t_out * (2 * chain.frame_len * n_bins + n_bins * n_mel
                               + n_mel * chain.dct.shape[1]),
        tensor_bytes(pre, chain.window, chain.cos, chain.sin, chain.mel,
                     chain.dct, chain.lift, fb_k))
    print("fbank library yardstick: none; no single PyTorch call computes "
          "the framed, windowed DFT -> power -> mel -> log -> DCT chain of "
          "MFCC (torch has no torchaudio here), so library_ms is null")

    gen = torch.Generator().manual_seed(SEED)
    model = deep_blstm(f"num_hiddens={HIDDEN},num_layers={LAYERS}",
                       num_classes=NUM_CLASSES, input_dim=feat.num_feats,
                       generator=gen, device=dev).eval()
    with torch.inference_mode():
        feats, _ = feat(w, lens)
        x = feats.transpose(0, 1)
        layer = model.rnn.layers[0].rnn
        xp_f, xp_b = input_proj(layer.fw, x), input_proj(layer.bw, x)
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
    bl_bound = rnn_bound(xp_f, HIDDEN, 2, 1, (*bl_args, *bl_k))
    # outside inference mode: the yardsticks differentiate through them
    x_serve, mask_serve = x.clone(), mask.clone()
    lstm_y = rnn_yardsticks("lstm", layer, x_serve, feat_lengths, mask_serve)
    print_yardsticks(card, f"cuDNN nn.LSTM bidirectional, T={t_out} "
                     f"B={BATCH} H={HIDDEN}", lstm_y)
    require(lstm_y["out_err"] <= LOGITS_TOL, "layer disagrees with nn.LSTM")
    train_kernels = check_training_kernels(dev, card)
    gru_kernels = check_gru_kernels(dev, card, x_serve, feat_lengths)
    lstm_kernels = check_lstm_kernels(dev, card, x_serve, feat_lengths)
    wide_kernels = check_lstm_wide(dev, card, x_serve, feat_lengths)
    check_lstm_designs(dev, card, x_serve, feat_lengths, {
        "bilstm_fwd": lstm_y["lib_fwd"],
        "bilstm_bwd": train_kernels["library"]["bilstm_bwd"],
        **lstm_kernels["library"]})
    check_gru_designs(dev, card, x_serve, feat_lengths,
                      gru_kernels["library"])
    gru_wide_kernels = check_gru_wide(dev, card, x_serve, feat_lengths)
    ln_kernels = check_ln_kernels(dev, card, x_serve, feat_lengths)
    zo_kernels = check_cell_family(dev, card, x_serve, feat_lengths,
                                   "zoneout")
    mi_kernels = check_cell_family(dev, card, x_serve, feat_lengths, "mi")
    check_stream_h512(dev, card, x_serve)

    # 4, 5. the serving slices, through the CLI's serving function ---------
    all_wavs, groups, audio_s = [], [], 0.0
    for _ in range(N_BATCHES):
        b_wavs, secs = synth_batch(rng)
        all_wavs += b_wavs
        groups.append(b_wavs)
        audio_s += secs
    wires = {}
    for codec in ("pcm16", "dpack", "mulaw"):
        t0 = time.perf_counter()
        wires[codec] = make_wire(all_wavs, codec, dev)
        print(f"{codec} wire: {N_BATCHES} buffers of {wires[codec].cap} "
              f"words ({2 * wires[codec].cap / 2**20:.3f} MiB each), packed "
              f"in {time.perf_counter() - t0:.2f} s of host time")
    dpack_kernels = check_dpack_kernel(dev, card, groups, wires)
    feat_cpu = featurizer("mfcc", "cpu")

    def serving_slice(label, model, fwd_name, layers, desc, chaotic=False,
                      codec="pcm16", vs_pcm16=None, cpu_batches=N_BATCHES):
        """One model's serving slice over the ``codec`` wire: launches
        counted from 0, logits and transcripts against the plain path on
        the CPU fed the same wire, ms per batch -> (launches, served).  For
        a ``chaotic`` recurrence (the layer-norm LSTM) the full batches'
        logits drift is printed, and the logits are held on the first
        LN_CHECK_T frames' worth of audio of one batch instead.  The dpack
        slice is held equal to ``vs_pcm16``, the pcm16 slice's batches
        (the same samples after the unpack); the mulaw slice counts its
        transcripts equal to them.  ``cpu_batches``: how many of the
        batches (the first ones) the plain path on the CPU checks."""
        w = wires[codec]

        def run_slice():
            return [serve_batch(model, feat, w.dev[o: o + w.cap], BATCH,
                                w.n_pad, codec, w.scap) for o in w.offsets]

        reset_counts()
        served = run_slice()
        torch.cuda.synchronize()
        launches = read_counts()
        print(f"{label} slice: {N_BATCHES} batches x {BATCH}, {audio_s:.1f} "
              f"s of audio, T={served[0].logits.shape[1]}; launches "
              f"{launches}")
        want = {"fbank": N_BATCHES, fwd_name: N_BATCHES * layers}
        if codec == "dpack":
            want["dpack_decode"] = N_BATCHES
        require(launches == want, f"{label} launches {launches}, want {want}")
        check_designs(label, model.rnn.layers[0].rnn.hidden, BATCH)

        if codec == "dpack":
            logits_err, bit_equal = 0.0, True
            for s, r in zip(served, vs_pcm16):
                bit_equal = bit_equal and torch.equal(s.logits, r.logits)
                logits_err = max(logits_err,
                                 float((s.logits - r.logits).abs().max()))
                require(torch.equal(s.decoded, r.decoded)
                        and torch.equal(s.lengths, r.lengths),
                        f"{label} transcripts differ from the pcm16 slice's")
            print(f"{label} slice vs the pcm16 slice: logits "
                  + ("bit-equal" if bit_equal else
                     f"max_abs_err={logits_err:.3e} (tol {LOGITS_TOL:g})")
                  + f"; identical transcripts {N_BATCHES * BATCH}/"
                  f"{N_BATCHES * BATCH}")
        else:
            model_cpu = copy.deepcopy(model).to("cpu")
            logits_err, same = 0.0, 0
            for o, s in list(zip(w.offsets, served))[:cpu_batches]:
                ref = serve_batch(model_cpu, feat_cpu, w.cpu[o: o + w.cap],
                                  BATCH, w.n_pad, codec, w.scap)
                require(s.logits.shape == (BATCH, ref.logits.shape[1],
                                           NUM_CLASSES + 1),
                        f"logits shape {tuple(s.logits.shape)}")
                require(bool(torch.isfinite(s.logits).all()),
                        "non-finite logits")
                require(torch.equal(s.feat_lengths.cpu(), ref.feat_lengths),
                        "frame lengths differ from the plain path")
                require(bool((s.lengths <= s.feat_lengths).all()),
                        "a decode is longer than its frames")
                logits_err = max(logits_err, float(
                    (s.logits.cpu() - ref.logits).abs().max()))
                same += int((s.decoded.cpu() == ref.decoded).all(1).sum())
            held = ", not held: a chaotic recurrence" if chaotic else ""
            print(f"{label} slice logits, kernel path on the card vs plain "
                  f"path on the CPU ({cpu_batches} of {N_BATCHES} batches): "
                  f"max_abs_err={logits_err:.3e} (tol {LOGITS_TOL:g}{held}); "
                  f"identical transcripts {same}/{cpu_batches * BATCH}")
        if codec == "mulaw":
            same = sum(int((s.decoded == r.decoded).all(1).sum())
                       for s, r in zip(served, vs_pcm16))
            print(f"{label} slice: transcripts equal to the pcm16 slice's "
                  f"{same}/{N_BATCHES * BATCH} (mu-law is lossy; "
                  f"informational)")
        if chaotic:
            short = [w_[: LN_CHECK_T * 160] for w_ in all_wavs[:BATCH]]
            s_chunk, s_cap, s_pad, _ = pack_batches(short, BATCH)
            got = serve_batch(model, feat, torch.from_numpy(s_chunk).to(dev),
                              BATCH, s_pad)
            ref = serve_batch(model_cpu, feat_cpu, torch.from_numpy(s_chunk),
                              BATCH, s_pad)
            logits_err = float((got.logits.cpu() - ref.logits).abs().max())
            print(f"{label} logits on {BATCH} utterances cut to "
                  f"{LN_CHECK_T * 160} samples (T={got.logits.shape[1]}), "
                  f"kernel path on the card vs plain path on the CPU: "
                  f"max_abs_err={logits_err:.3e} (tol {LOGITS_TOL:g})")
        require(logits_err <= LOGITS_TOL,
                f"{label} slice logits disagree with plain")
        slice_ms = cuda_ms(run_slice, 3, warmup=1) / N_BATCHES
        print(f"[{card}] {label} slice: {slice_ms:.4f} ms/batch, "
              f"{audio_s / (slice_ms * N_BATCHES / 1e3):.1f} audio-s/s "
              f"({codec} wire unpack + features + {desc} + classifier + "
              f"greedy decode, B={BATCH})")
        return launches, served

    blstm_desc = f"{LAYERS}x{HIDDEN} BLSTM"
    launches, pcm_served = serving_slice("deep_blstm", model, "bilstm_fwd",
                                         LAYERS, blstm_desc)
    path_launches = [launches]
    for codec in ("dpack", "mulaw"):
        launches, _ = serving_slice(f"deep_blstm {codec}", model,
                                    "bilstm_fwd", LAYERS, blstm_desc,
                                    codec=codec, vs_pcm16=pcm_served)
        path_launches.append(launches)
    del pcm_served
    bw = wire.probe_link(dev)
    print(f"[{card}] probe_link: host -> card ~{bw:.0f} MB/s (4 MiB against "
          f"64 KiB copies, min of 3); choose_codec picks "
          f"{wire.choose_codec(bw)}")
    # the other recurrent models at full width: label -> (zoo model, its
    # hparams, forward kernel, what it is); random weights from seeds
    serve_models = {
        "deep_gru": ("deep_gru", "", "bigru_fwd", f"3x{HIDDEN} BGRU"),
        "deep_blstm uni": ("deep_blstm", "bidirectional=false", "lstm_fwd",
                           f"3x{HIDDEN} unidirectional LSTM"),
        "highway_blstm": ("highway_blstm", "", "bilstm_fwd",
                          f"5x{HIDDEN} highway BLSTM"),
        "deep_speech": ("deep_speech", "", "bilstm_fwd_wide",
                        "3x512 clipped-ReLU dense + 1x512 BLSTM"),
        "ln_blstm": ("ln_blstm", "", "bi_ln_lstm_fwd",
                     f"3x{HIDDEN} layer-norm BLSTM"),
        "zoneout_blstm": ("zoneout_blstm", "", "bi_zoneout_lstm_fwd",
                          f"3x{HIDDEN} zoneout BLSTM, eval mode"),
        "mi_blstm": ("mi_blstm", "", "bi_mi_lstm_fwd", f"3x{HIDDEN} MI BLSTM"),
        "deep_speech uni": ("deep_speech", "bidirectional=false",
                            "lstm_fwd_wide", "3x512 clipped-ReLU dense + "
                            "1x512 unidirectional LSTM"),
        # the GRU's wide design; the CPU plain path checks one batch
        "deep_gru 512": ("deep_gru", "num_hiddens=512", "bigru_fwd_wide",
                         "3x512 BGRU"),
        "deep_gru 512 uni": ("deep_gru", "num_hiddens=512,bidirectional="
                             "false", "gru_fwd_wide",
                             "3x512 unidirectional GRU"),
    }
    for i, (label, (name, hp, fwd_name, desc)) in enumerate(
            serve_models.items()):
        served = build_model(name, hp, num_classes=NUM_CLASSES,
                             input_dim=feat.num_feats,
                             generator=torch.Generator().manual_seed(
                                 SEED + 4 + i), device=dev).eval()
        path_launches.append(serving_slice(
            label, served, fwd_name, len(served.rnn.layers), desc,
            chaotic=name == "ln_blstm",
            cpu_batches=1 if "512" in label else N_BATCHES)[0])
        del served

    with torch.inference_mode():
        fb_ms = cuda_ms(lambda: fbank(feat.chain, pre, t_out), 20)
        fb_plain_ms = cuda_ms(lambda: spectral_plain(feat.chain, pre, t_out),
                              20)
        bl_ms = cuda_ms(lambda: bilstm(*bl_args), 10)
        bl_plain_ms = cuda_ms(lambda: bilstm_plain(*bl_args), 3, warmup=1)
    print(f"[{card}] fbank: kernel {fb_ms:.4f} ms/batch, plain "
          f"{fb_plain_ms:.4f} ms/batch (B={BATCH}, T={t_out})")
    print(f"[{card}] bilstm_fwd (one layer, both directions): kernel "
          f"{bl_ms:.4f} ms/batch, plain {bl_plain_ms:.4f} ms/batch "
          f"(T={t_out}, B={BATCH}, H={HIDDEN})")

    # 6, 7. the training paths ---------------------------------------------
    for path in TRAIN_PATHS:
        path_launches.append(training_slice(
            dev, card, path, with_fit=path == "deep_blstm")["launches"])

    # the kernels line -------------------------------------------------------
    measured = {
        "fbank": (fbank_err, fb_ms, fb_plain_ms, fb_bound, None),
        "bilstm_fwd": (bilstm_err, bl_ms, bl_plain_ms, bl_bound,
                       lstm_y["lib_fwd"]),
    }
    for found in (train_kernels, gru_kernels, lstm_kernels, wide_kernels,
                  gru_wide_kernels, ln_kernels, zo_kernels, mi_kernels,
                  dpack_kernels):
        for name, err in found["errs"].items():
            measured[name] = (err, *found["times"][name],
                              found["bounds"][name], found["library"][name])
    record = {"kernels": []}
    for name, (source, replaces) in KERNELS.items():
        err, ms, plain_ms, (bound_ms, bound_by), library_ms = measured[name]
        launches = sum(p.get(name, 0) for p in path_launches)
        require(launches > 0, f"{name} was not launched on a main path")
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"asr_study_torch/csrc/{source}",
            "replaces": f"asr_study_tpu/{replaces}", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the "
          f"kernels' build included")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
