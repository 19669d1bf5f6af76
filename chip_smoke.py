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
  unidirectional, dropout 0;
- training from a corpus through the CLIs' ``main(argv)`` (BASELINE config
  3 with its variable-length bucketed batches): ``cli.make_dataset``
  writes a manifest of 800 SynthWords utterances, ``cli.train`` trains
  ``deep_blstm`` at its zoo defaults (3x256, dropout 0.2) from it for 3
  epochs and one more with ``--resume``, ``cli.eval`` scores its valid and
  test splits;
- the HDF5 path on that corpus: ``cli.make_dataset --output`` with host
  MFCC (both layouts), raw waveforms, and features extracted on the card
  over the pcm16 and dpack wires; ``cli.train`` of deep_blstm 3x256 from
  the MFCC ``.h5`` and from the raw one with ``--device_features mfcc
  --spec_augment --wav_augment gain_db=3``; ``cli.eval`` and
  ``cli.predict --save`` of that run;
- prefix beam search (BASELINE config 4): the ``ctc_beam`` kernel
  (csrc/ctc_beam.cu, a CTA per utterance) on speech-like emissions of
  B=32, T=512, V=28 at widths 4, 16 and 64, pruned, after blank collapse
  and with a char 3-gram LM fused; its wide design (csrc/ctc_beam_wide.cu,
  every W > 128 or V > 64) at W=256, W=16 and 128 over 100 classes,
  W=1024 and W=256 with the LM at B=8 (its stream form at W=256 in the
  streaming phase); the
  deep_blstm 2x256 serving slice with ``beam_width=16`` through
  ``serve_batch``; ``cli.train_lm`` on the corpus manifest and
  ``cli.eval --beam_width 16`` with its LM and with ``--blank_collapse
  0.99``, and ``cli.eval --beam_width 256``;
- the native host library (``asr_study_torch/native/asr_native.cc``,
  built with g++): the dpack encode against NumPy's on the serving and
  edge batches and ``read_wav`` against the plain parser on the corpus's
  files, byte for byte, each timed on the host in turns; the wall seconds
  of these checks and of the wide design's cases and CLI runs are printed
  with the phases';
- streaming (``predict --stream``): ``streaming.StreamingRecognizer`` on
  60 s of audio in 1 s pushes, 128-frame chunks (as
  ``benchmarks/bench_stream.py`` drives the JAX one), for unidirectional
  ``deep_gru`` 2x256, ``deep_blstm`` 3x256 and ``deep_speech`` (the wide
  LSTM kernel), greedy and deep_gru by beam16 with the LM, the recurrent
  state and the beam state carried on the card from chunk to chunk; a
  ``MultiStreamRecognizer`` of 32 streams; ``cli.predict --stream``; and
  ``StreamingRecognizer`` on a short clip for unidirectional ``ln_blstm``,
  ``mi_blstm`` and ``zoneout_blstm`` 3x256;
- the rest of the optimizer factory on deep_blstm 3x256 through
  ``Trainer.train_step``: adamw, sgd, rmsprop, reduce-on-plateau and
  gradient accumulation, ``check_nans`` and ``fit(profile=True)``;
- bf16 training (``train --bf16``, ``Trainer(compute_dtype=
  torch.bfloat16)``): train steps of deep_blstm 3x256 (the LSTM cluster
  kernels' bfloat16-weight forms) and deep_speech (the wide kernels'),
  each bidirectional and unidirectional, of deep_gru 3x256 (the GRU
  cluster kernels'), bidirectional and unidirectional, and 3x512 (the wide
  GRU kernels'), of zoneout_blstm, mi_blstm and ln_blstm 3x256 (their
  cluster kernels'), bidirectional and unidirectional, of deep_blstm
  3x256, deep_speech, deep_gru 3x256, zoneout_blstm, mi_blstm and
  ln_blstm 3x256 at B=64 bidirectional (the LSTM, GRU, zoneout, MI and LN
  stream kernels' bfloat16-weight forms: ``--batch_size 64``) and of
  zoneout_blstm, mi_blstm and ln_blstm unidirectional at B=128, and
  ``cli.train --bf16`` of deep_blstm, deep_gru, zoneout_blstm, mi_blstm
  and ln_blstm on the corpus manifest, and of deep_blstm, zoneout_blstm
  and ln_blstm with ``--batch_size 64``;
- data parallelism (BASELINE config 5, ``train --num_devices``,
  ``Trainer(group=)``): deep_blstm 3x256 at B=32, T=512 in two ranks
  (``parallel.dp.launch``) that share the one card over gloo, which stages
  the all-reduce through the host (the machine has one card, so not a
  data-parallel rate), and in one rank over NCCL; ``fit`` over the corpus
  manifest's train split in two ranks;
- tensor parallelism (``train --tp_devices``, ``parallel/tp.py``):
  deep_blstm and deep_gru 3x256 at B=32, T=512, each layer's gate
  dimension sharded over two ranks (``dp.launch(..., tp=2)``) that share
  the one card over gloo.

Phases, in order; any failure raises and the exit code is not 0:

1. toolchain: torch and its CUDA, nvcc, triton, the card and power limit;
2. build: nvcc time and each kernel's registers / shared memory / spills;
3. each kernel against its plain PyTorch version on the card, at its path's
   shapes, within the stated tolerance, with its time, its plain version's
   time, its bound and the time of the PyTorch library call that computes
   the same function (cuDNN ``nn.LSTM`` / ``nn.GRU``, ``F.ctc_loss``; none
   for fbank, dpack_decode and the layer-norm, zoneout and MI LSTMs); the
   fbank kernel's FFT design (csrc/fbank_fft.cu) and DFT design
   (csrc/fbank.cu) both against the plain version and against it run with
   float64 tables, the FFT design timed beside the stock cuFFT chain
   (``torch.fft.rfft`` and the rest, several calls); the LSTM kernels' wide design at H=512 (deep_speech's width), both
   directions and one, its backward from the forward's saved gates, timed
   beside cuDNN's two calls and the bound, with the card's
   cudaOccupancyMaxActiveClusters
   for its 16-CTA clusters; the GRU kernels' wide design at H=512 the same
   way (its backward from the h side of the pre-activations the forward
   keeps), beside cuDNN ``nn.GRU``; the layer-norm, zoneout and MI LSTM
   kernels' stream route at H=512 against plain once and timed beside its
   bound; the
   LSTM, GRU and MI kernels also at H=512 and H=100, and at shapes ragged
   for the cluster design's tiling (H=100, B=5 and B=33, a row masked
   throughout, T=1), with the design each width takes, its cluster
   geometry and shared memory, each timed with its step split (the
   designs these replaced, the stream design, the fbank DFT design and the
   two-launch dpack decode, are timed against them in turns by
   ``lstm_step_split.py stream_design``, ``fbank_dft`` and
   ``dpack_two_launch``); the MI kernels at alpha = 0, beta1 = beta2 = 1
   and the zoneout kernels at zh = zc = 1 against the LSTM kernels; the
   zoneout kernels
   with Bernoulli and with constant mix weights, and at ragged shapes as
   the MI ones; the CTC walks' warp design (csrc/ctc_warp.cu, through the
   wrappers) and block design (csrc/ctc.cu, through its C entry points)
   against their plain versions at T=512, B=32, S=97, timed in turns
   beside F.ctc_loss, and a lattice just above the warp design's cap
   through the wrappers, which must take the block design; the dpack
   decode's one-launch design (csrc/dpack_onepass.cu) bit for bit against
   its plain version and the two-launch design (csrc/dpack.cu) over the
   whole stream of every serving batch, of the edge batches and of a
   stream of more blocks than the cooperative grid has CTAs; the native
   library's dpack encode byte-equal to NumPy's on every serving and edge
   batch, both timed on the host in turns;
4. the serving slices, with launch counters proving their kernels ran
   (fbank in the FFT design only)
   (the LSTM, GRU, layer-norm, zoneout and MI LSTM kernels in the design
   their width takes; the LSTM's wide design under its own kernel line rows),
   logits held against the plain path on the CPU (every batch of the
   deep_blstm pcm16 slice, the first batch of the others; for ln_blstm,
   whose recurrence is chaotic, on a batch cut to LN_CHECK_T frames); the
   dpack
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
   share; then the optimizer phase: adamw (weight decay 1e-2), sgd,
   rmsprop and Adam with reduce-on-plateau (patience 1, window 1), each
   OPT_STEPS steps of deep_blstm 3x256 on a batch a step, launches
   counted, each step's loss and grad norm held against the plain path on
   the CPU, run twice bit for bit; accumulation over two halves against
   the whole batch; check_nans raising on a NaN batch with the weights
   untouched; fit(profile=True) writing a trace with the card's kernels;
   then the bf16 phase: the twenty-four bfloat16-weight kernels (the
   cluster, wide and stream LSTM and GRU kernels, the cluster and stream
   zoneout, MI and LN LSTM kernels, forward and backward) against their
   plain twins at T=512, B=32, H=256 and (LSTM, GRU) 512, one and two
   directions, and the stream forms at B=64 in two directions at H=256
   and 512 and at B=128 in one at H=256 (h, c, the kept gates or h side,
   dxp, the GRU's dhp, the MI dpre; the LN's forward frame by frame and
   its backward by rows, as ln_bf16_held holds it; dwh after its matmul;
   the zoneout mix drawn once,
   Bernoulli(0.9), for kernel and twin), two launches bit-equal, each
   timed beside its float32 form, its bound and cuDNN ``nn.LSTM`` /
   ``nn.GRU`` in bfloat16 (no library call for LN, zoneout or MI);
   BF16_STEPS bf16 train steps of deep_blstm and deep_speech, each
   bidirectional and with ``bidirectional=false``, of deep_gru 3x256 bi
   and uni and 3x512, of zoneout_blstm (rates 0.1), mi_blstm and ln_blstm
   3x256 bi and uni, of deep_blstm, deep_speech, deep_gru, zoneout_blstm
   (rates 0.1), mi_blstm and ln_blstm 3x256 at B=64 bi (the stream forms:
   train --bf16 --batch_size 64), and of zoneout_blstm, mi_blstm and
   ln_blstm 3x256 uni at B=128 (their unidirectional stream forms), from
   the float32 slice's
   weights, their launches (the bf16 forms only), losses beside the
   float32 run's, two identical steps bit-equal, ms a step;
8. the corpus phase: each CLI run's launches held to what its steps and
   evals need, every logged loss finite and the train loss falling from
   the first epoch to the third, the step count continued by ``--resume``,
   eval's valid loss equal to the run's last ``val_loss``, finite test
   CER and WER, then ``train --bf16`` of deep_blstm, deep_gru,
   zoneout_blstm, mi_blstm and ln_blstm for an epoch each (the bf16
   cluster forms in every step) and of deep_blstm, zoneout_blstm and
   ln_blstm with ``--batch_size 64`` (the bf16 stream forms in every
   step); the host
   seconds of the synthesis and of the manifest's features, ms per train
   step (CUDA events) and audio-s/s, eval ms per batch; then the h5 phase
   on its corpus: make_dataset --output (host MFCC in both layouts, raw, and
   --device over pcm16 and dpack: the two bit-equal, near host MFCC),
   train from the .h5 (each step's loss that of the manifest run's first
   epoch) and with --device_features,
   --spec_augment and --wav_augment (fbank in every step), eval and
   predict of that run; extraction rates, flow_from_h5's read rate;
9. the beam phase: ctc_beam against its plain twin on the card (all W
   beams of every row; prefixes, lengths and scores equal bit for bit),
   each case timed beside its bound (no library call does prefix beam
   search), the plain twin once; the
   beam serving slice's launches and transcripts against the plain twin
   on its logits, its ms a batch beside the greedy slice's; train_lm's
   report, each beam eval's record and launches (one ctc_beam a batch;
   at --beam_width 256 one ctc_beam_wide); the wide design against its
   plain twin bit for bit (BEAM_WIDE_CASES, a repeat bit-equal), each
   case timed beside its bound;
10. the streaming phase: (a) the LSTM and GRU forwards on each route
   (cluster at H=256, wide at H=512, stream at B=97), and the layer-norm,
   MI and zoneout LSTM forwards on each (cluster at H=256, stream at
   H=512), started from a random carry, in chunks of 128 bit-equal to one
   launch over 512 frames, within the forward tolerance of the plain twin
   (the layer-norm LSTM's plain step from the kernel's own state, its
   recurrence being chaotic), no carry bit-equal to a zero carry, ms a
   chunk at B=1 and B=32; (b) the beam
   kernel's stream form bit-equal to beam_stream_plain in chunks of 7, 64
   and 512 at W = 4, 16, 64, with the LM and at W=256 (the wide design),
   the spliced best paths equal to the one-shot beam's, us a frame at
   W=16 and 256; (c) each recognizer's
   launches (one forward a layer and chunk, one beam a chunk), its
   transcript equal to the whole utterance's on the card, its logits
   against the CPU plain streaming path, bench_stream.py's first-push
   latency and stream and batch audio-s/s; (d) the 32 streams' ids each
   equal to its own recognizer's, audio-s/s; (e) ``predict --stream``'s
   JSON lines equal to ``predict``'s, greedy, beam16 with the LM and
   beam256 (the wide design); (f)
   the layer-norm, MI and zoneout recognizers' launches and transcripts
   equal to the whole utterance's;
11. the dp phase (after the corpus phase, on its manifest): (a) one SGD
   step of deep_blstm 3x256 at B=32, T=512 in two ranks on cuda:0 over
   gloo against the one-process step from the same weights (loss rel
   DP_LOSS_RTOL, each gradient within DP_GRAD_FRAC of its max abs), and
   with DP_RAGGED_REAL real rows of 32, so that the second rank holds
   one; two identical DP steps bit-equal; (b) one rank over NCCL in this
   process, bit-equal to the step without a group; (c) DP_FIT_STEPS
   ``fit`` steps (one epoch of the corpus's train split) in the two ranks,
   launches counted in each, losses within DP_FIT_RTOL of the one-process
   run's, one checkpoint written by rank 0; (d) ms a step of the two
   ranks beside the one-process B=32 step, and ms of the flat all-reduce
   alone;
12. the tp phase: deep_blstm and deep_gru 3x256 at B=32, T=512 in two
   ranks on cuda:0 over gloo (``dp.launch(..., tp=2)``: one data rank of
   two model shards), each an eval step and an SGD step from the same
   weights as the one-process steps on the kernels: the eval and train
   losses within TP_LOSS_RTOL, each gradient within TP_GRAD_FRAC of its
   norm, the two ranks' gradients bit-equal, no recurrence kernel
   launched in the ranks (the TP scan is plain tensor code, as in JAX);
   the reduce-scatter of the NCCL form of the all-gather's backward and
   tp_slice's all-reduce in a one-rank NCCL group; ms of each step,
   which is not a TP rate (one card, gloo stages every frame's
   all-gather through the host).

The deep_blstm pcm16 slice's wire unpack and features stage are split
with CUDA events (``_prep``, fbank, the two deltas, ``_finalize``), and
each phase's wall time is printed as it ends.

Each path is driven with every launch counter set to 0 just before it and
read just after; the kernels line sums those counts.  The line before the
last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA the script exits 1.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import importlib.util
import dataclasses
import io
import json
import math
import os
import queue
import re
import subprocess
import sys
import tempfile
import threading
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
# the bfloat16-weight forms (train --bf16) against their plain twins, both
# rounding h_prev and dpre to bfloat16 and multiplying in float32: an
# operand on a rounding boundary may round apart between the two, which
# moves a step's sum by a bfloat16 ulp of one product, and the recurrence
# carries it (measured max 1.1e-3 on h, c and dxp at T=512, B=32, H=256
# and 512); dwh, a bfloat16 matmul result, against its max abs
BF16_ATOL = 5e-3
BF16_RTOL = 5e-3
BF16_DWH_FRAC = 1e-2
# the layer-norm LSTM's bfloat16 backward.  It scales dhp by the rstd of a
# gate block of h_prev @ wh, so a bfloat16 rounding of dhp that flips
# between two summation orders moves the next cotangent by up to a percent
# of its norm, and the chain carries that on: the plain twin parts from
# itself with its products summed in float64 parts by up to 4.2e-2 of a
# (frame, row)'s norm over T=LN_CHECK_T and 1.0e-2 of dwh's max at H=256,
# B=32 (tests/test_torch_bf16_ln.py, test_ln_bf16_backward_spread_*);
# over T=512 the kernels and the twins part by as much as a row's norm
# (printed by check_bf16_kernels).  So its
# dpre and dcn are held per (frame, row) on the first LN_CHECK_T steps of
# each chain within BF16_ATOL + LN_BF16_ROW_RTOL * ||plain||, dwh within
# LN_BF16_DWH_FRAC of its max there; the rest of a chain is printed.
LN_BF16_ROW_RTOL = 0.1
LN_BF16_DWH_FRAC = 3e-2
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
# outside the tensor cores, bf16 products into fp32 on the tensor cores
# (dense), and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_HBM = 3.35e12

# config 3 (benchmarks/bench_train.py defaults)
TRAIN_B, TRAIN_T, TRAIN_L, TRAIN_LAYERS, FEATS = 32, 512, 48, 3, 39
TRAIN_STEPS = 20                 # steps on one fixed batch
AUDIO_PER_STEP = TRAIN_B * TRAIN_T * 0.01   # 10 ms frames: 163.84 s

# the corpus phase: BASELINE config 3 from a SynthWords manifest through the
# CLIs (deep_blstm at its zoo defaults, 3x256, dropout 0.2; Adam 1e-3, clip
# 400): 640 train, 80 valid and 80 test utterances of 3-8 words
CORPUS_N, CORPUS_EPOCHS, CORPUS_B = 800, 3, 32
CORPUS_LOSS_RTOL = 1e-5          # eval's valid loss against the last val_loss
# the dp phase: a DP step against the one-process step (loss, gradients as
# a share of their max abs), the fit losses of two ranks against one
# process's, the ragged batch's real rows (the second rank holds one)
DP_LOSS_RTOL, DP_GRAD_FRAC, DP_FIT_RTOL = 1e-5, 1e-4, 1e-3
DP_RAGGED_REAL, DP_FIT_STEPS, DP_TIME_STEPS = 17, 20, 5
DP_JOIN_S = 300                  # the two ranks' launch, at most
# the tp phase: the TP eval and train step against the one-process steps
# (losses; each gradient as ||diff|| / ||one process's||)
TP_LOSS_RTOL, TP_GRAD_FRAC = 1e-4, 1e-3
TP_MODELS = ("deep_blstm", "deep_gru")
# the h5 phase: each step's loss from the MFCC .h5 against the corpus
# phase's from the manifest (the same features, weights, seed and batches);
# device extraction held against host MFCC at a power floor (without one,
# SynthWords' near-silent mel channels part fp32 from fp64 logs by ~15)
H5_LOSS_RTOL = 1e-4
H5_LOG_FLOOR = 1e-2

# the beam phase (BASELINE config 4, prefix beam search on an eval set):
# speech-like emissions as benchmarks/bench_decode.py:49-53 makes them
# (randn, the blank column +10 on 65% of frames and -10 on the rest), B=32,
# T=512, V=28; 24 rows at T, 8 ragged in 1..T-1; 10 ms frames.  The
# kernel is held equal to its plain twin bit for bit: prefixes, lengths
# and scores (the same arithmetic in the same order)
BEAM_B, BEAM_T, BEAM_V, BEAM_FULL = 32, 512, 28, 24
BEAM_WIDTHS = (4, 16, 64)
BEAM_SERVE_W = 16                # the serving slice's and the CLIs' width
# the wide design's cases (csrc/ctc_beam_wide.cu, every W > 128 or V > 64):
# label -> (W, V, B, T, with the LM); W >= 512 cut to B=4, T=128, where the
# plain twin's [B, W, W*E] merge would take minutes, and the LM case to
# B=8 (its twin ~1.3 s at B=32); the CLIs' wide width
BEAM_WIDE_CASES = {
    "W=256": (256, BEAM_V, BEAM_B, BEAM_T, False),
    "W=16 V=100": (16, 100, BEAM_B, BEAM_T, False),
    "W=128 V=100": (128, 100, BEAM_B, BEAM_T, False),
    "W=1024": (1024, BEAM_V, 4, 128, False),
    "W=256 LM": (256, BEAM_V, 8, BEAM_T, True),
}
BEAM_WIDE_W = 256
BEAM_LM = dict(lm_alpha=0.8, lm_beta=0.1)
FRAME_S = 0.01


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


def bound(ops: float, nbytes: float, peak: float = PEAK_FP32
          ) -> tuple[float, str]:
    """The least time the card could take: the larger of ``ops``
    operations at ``peak`` (fp32: PEAK_FP32) and ``nbytes`` moved at
    PEAK_HBM -> (ms, which of the two limits it)."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def tensor_bytes(*ts: torch.Tensor) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


# wall seconds of the native host library's checks and of the wide beam
# design's cases and CLI runs, each summed over the phases it runs in
PARTS: dict[str, float] = {}


def add_part(name: str, t0: float) -> None:
    PARTS[name] = PARTS.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def part(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add_part(name, t0)


class PhaseClock:
    """Wall time of each phase, printed as it ends and summed at the end."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.rows = []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.rows.append((name, now - self.last))
        print(f"phase wall time: {name} {now - self.last:.1f} s")
        self.last = now

    def summary(self) -> str:
        return "; ".join(f"{n} {s:.1f}" for n, s in self.rows)


def rnn_bound(xp: torch.Tensor, hidden: int, ndir: int, passes: int,
              moved: tuple, peak: float = PEAK_FP32) -> tuple[float, str]:
    """Bound of a recurrent kernel: ``passes`` [B, H] x [H, G] products a
    step and direction (1 forward; 2 backward: the recomputed h-side
    pre-activations and the cotangent through wh^T) over every frame of
    xp [T, B, G] at ``peak`` (PEAK_BF16 for bfloat16 operands); the gate
    maths is left out, so it stays a lower bound.  ``moved``: the
    function's inputs and outputs, each counted once."""
    t, b, g = xp.shape
    return bound(passes * 2.0 * t * b * hidden * g * ndir,
                 tensor_bytes(*moved), peak)


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


def time_resident(card: str, label: str, fn, steps: int, geo,
                  passes: int, rest: str, gates: int = 4,
                  hidden: int = HIDDEN) -> float:
    """One kernel's resident design (``geo.design``: cluster or wide) in
    two turns of 5 calls at H=``hidden`` and B=BATCH -> its mean ms.
    Prints both turns and the step split into the FMA time of one CTA's
    slice (``passes`` [R, H] x [H, gates*U] products a step in the layout
    ``geo``, at 128 FMAs a clock and the card's SM clock) and the
    ``rest``.  The stream design these kernels
    replaced is timed against them in turns by ``lstm_step_split.py
    stream_design``."""
    turns = [cuda_ms(fn, 5) for _ in range(2)]
    clk = sm_clock_hz()
    fmas = passes * geo.rows * hidden * gates * geo.units
    ms = sum(turns) / 2
    step_us = 1e3 * ms / steps
    fma_us = 1e6 * fmas / (128 * clk)
    print(f"[{card}] {label} at H={hidden} T={steps} B={BATCH} "
          f"(R={geo.rows}): {geo.design} design {turns[0]:.4f} / "
          f"{turns[1]:.4f} ms; {step_us:.3f} us a step, of which the "
          f"{fmas} FMAs of one CTA's slice take {fma_us:.3f} us at 128 a "
          f"clock and the SM clock {clk / 1e6:.0f} MHz, the rest ({rest}) "
          f"{step_us - fma_us:.3f} us")
    return ms


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
    counts) and timed with its plain version and its bound, with the
    per-step time split into the FMA time of one CTA's slice at the card's
    SM clock and the rest (``lstm_step_split.py stream_design`` times the
    stream design against it in turns).  The LN gains and biases are
    moved off their init (1 and 0) by seeded noise, so that every vector
    the kernels take matters."""
    from asr_study_torch.models.zoo import ln_blstm
    from asr_study_torch.ops.ln_lstm import (BiLNLSTMFunction, LNLSTMFunction,
                                             bi_ln_lstm, bi_ln_lstm_bwd,
                                             bi_ln_lstm_bwd_plain,
                                             bi_ln_lstm_plain, ln_geometry,
                                             ln_lstm, ln_lstm_bwd,
                                             ln_lstm_bwd_plain,
                                             ln_lstm_plain)

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

    def timed(label, fn, steps, ndir, passes):
        return time_resident(card, label, fn, steps,
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
                timed(f"{name}_fwd", lambda: fwd(*args), t_s, n, 1),
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
        with torch.no_grad():
            hc = fwd(*args)
            bwd_args = (*args, *hc, *dh[:n])
            before = dict(bwd.by_design)
            d_k, d_p = bwd(*bwd_args), bwd_plain(*bwd_args)
            torch.cuda.synchronize()
            design = ran_design(bwd, before, n, b)
            times[f"{name}_bwd"] = (
                timed(f"{name}_bwd", lambda: bwd(*bwd_args), t, n, 2),
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
            k_fwd = time_resident(
                card, fwd_row, lambda: fwd(fxps, mask_s), t_s, geo, 1,
                "exchange, barrier, cell, loads", hidden=h)
            k_train = cuda_ms(lambda: fwd(fxps, mask_s, train=True), 10)
            k_bwd = time_resident(
                card, bwd_row, lambda: bwd(hcs, gs), t, geo, 1,
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
            k_fwd = time_resident(
                card, fwd_row, lambda: fwd(fxps, mask_s), t_s, geo, 1,
                "exchange, barrier, cell, loads", gates=3, hidden=h)
            k_train = cuda_ms(lambda: fwd(fxps, mask_s, train=True), 10)
            k_bwd = time_resident(
                card, bwd_row, lambda: bwd(hs, gs), t, geo, 1,
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


def check_lstm_designs(dev: torch.device) -> None:
    """Phase 3 for the cluster design of the LSTM kernels beyond the main
    paths.

    The four wrappers against their plain versions at shapes ragged for the
    cluster tiling: H=100 (13 units a CTA, the last CTA 9), B=5 and B=33
    (rows left over in the last group), a row masked on every frame, T=1,
    and H=512 at B=49 (two directions: more rows than the wide design's
    clusters hold, so the stream design; one direction: the wide design
    with a ragged last group); each case runs the design ``lstm_geometry``
    picks, held by the wrappers' by-design counts, at the forward and
    backward tolerances.  (``lstm_step_split.py stream_design`` times the
    cluster design against the stream design it replaced, in turns.)"""
    from asr_study_torch.ops.bilstm import (bilstm, bilstm_bwd,
                                            bilstm_bwd_plain, bilstm_plain,
                                            lstm, lstm_bwd, lstm_bwd_plain,
                                            lstm_geometry, lstm_plain)

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


def check_gru_designs(dev: torch.device) -> None:
    """Phase 3 for the cluster design of the GRU kernels beyond the main
    paths, as ``check_lstm_designs`` for the LSTM.

    The four wrappers against their plain versions at shapes ragged for the
    cluster tiling (H=100: 13 units a CTA, the last CTA 9; B=5 and B=33; a
    row masked on every frame; T=1) and at H=512 (the wide design, its
    backward from the forward's res), each case in the design
    ``gru_geometry`` picks (held by the by-design counts), at the forward
    and backward tolerances.  (``lstm_step_split.py stream_design`` times
    the cluster design against the stream design in turns.)"""
    from asr_study_torch.ops.gru import (bigru, bigru_bwd, bigru_bwd_plain,
                                         bigru_plain, gru, gru_bwd,
                                         gru_bwd_plain, gru_geometry,
                                         gru_plain)

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
    held by the by-design counts), timed with the per-step split
    (``lstm_step_split.py stream_design`` times the stream design against
    them in turns); the MI kernels are held at alpha = 0, beta1 =
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

    def timed(label, fn, steps, ndir, passes):
        return time_resident(card, label, fn, steps,
                             geometry(h, BATCH, ndir), passes,
                             "exchange, barrier, cell, loads")

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
                    times[f"{name}_fwd"] = (
                        timed(f"{name}_fwd", lambda: fwd(*args), t_s, n, 1),
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
                    times[f"{name}_bwd"] = (
                        timed(f"{name}_bwd", lambda: bwd(*bwd_args), t, n, 2),
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

def fbank_bounds(chain, pre: torch.Tensor, out: torch.Tensor) -> dict:
    """fbank's bound two ways -> {"fft": (ms, limit), "dft": (ms, limit)}.
    "fft" is the least work of the function: a real FFT at 2.5 nfft
    log2(nfft) flops a frame, the power (3 a bin), the banded mel (2 a
    band weight), the DCT (2 a table entry) and the window (1 a sample),
    against the bytes of pre, the FFT design's tables and the output.
    "dft" is the earlier yardstick, the DFT, mel and DCT as dense
    products against the DFT design's tables."""
    frames = out.shape[0] * out.shape[1]
    n_bins, n_mel = chain.mel.shape
    n_cep = chain.dct.shape[1]
    fft_ops = frames * (2.5 * chain.nfft * math.log2(chain.nfft)
                        + 3 * n_bins + 2 * chain.mel_packed.numel()
                        + 2 * n_mel * n_cep + chain.frame_len)
    dft_ops = 2.0 * frames * (2 * chain.frame_len * n_bins + n_bins * n_mel
                              + n_mel * n_cep)
    return {"fft": bound(fft_ops, tensor_bytes(
                pre, chain.window, chain.twiddle, chain.mel_packed,
                chain.mel_bands, chain.dct, chain.lift, out)),
            "dft": bound(dft_ops, tensor_bytes(
                pre, chain.window, chain.cos, chain.sin, chain.mel,
                chain.dct, chain.lift, out))}


def cufft_chain(chain, pre: torch.Tensor, t_out: int) -> torch.Tensor:
    """The stock PyTorch form of the MFCC chain, as a yardstick: frames by
    ``unfold``, ``torch.fft.rfft`` (cuFFT), power, the mel and DCT as
    matrix products, the logs and floors of spectral_plain."""
    from asr_study_torch.features.device import F32_EPS
    need = (t_out - 1) * chain.frame_step + chain.frame_len
    if need > pre.shape[1]:
        pre = torch.nn.functional.pad(pre, (0, need - pre.shape[1]))
    frames = pre.unfold(1, chain.frame_len, chain.frame_step)[:, :t_out]
    spec = torch.fft.rfft(frames * chain.window, n=chain.nfft)
    pspec = spec.abs().square() / chain.nfft
    log_e = torch.log(pspec.sum(-1).clamp_min(F32_EPS).clamp_min(
        chain.floor))
    feat = torch.matmul(pspec, chain.mel).clamp_min(F32_EPS)
    cep = torch.matmul(torch.log(feat.clamp_min(chain.floor)), chain.dct) \
        * chain.lift
    return torch.cat([log_e[..., None], cep[..., 1:]], dim=-1)


def check_fbank_kernel(card: str, feat, pre: torch.Tensor,
                       t_out: int) -> dict:
    """Phase 3 for fbank at the serving shape: the FFT design through the
    wrapper, and the DFT design through its C entry point asr_fbank as the
    wrapper ran it (the signal padded to the last frame, then the launch),
    against spectral_plain at FBANK_TOL, each beside its error against
    spectral_plain with float64 tables; the fft design timed, two turns of
    20 calls, with its device time; the cuFFT chain as a yardstick; both
    designs' bounds."""
    from asr_study_torch.features.device import spectral_plain
    from asr_study_torch.features.fbank import (chain_design, fbank,
                                                launch_dft)

    chain = feat.chain
    require(chain_design(chain) == "fft",
            "the serving featurizer's shapes must take the FFT design")
    need = (t_out - 1) * chain.frame_step + chain.frame_len
    dft_out = torch.empty(pre.shape[0], t_out, chain.num_out,
                          device=pre.device)

    def dft():
        padded = torch.nn.functional.pad(pre, (0, max(0, need
                                                      - pre.shape[1])))
        launch_dft(chain, padded, t_out, dft_out)
        return dft_out

    before = dict(fbank.by_design)
    with torch.inference_mode():
        got = {"fft": fbank(chain, pre, t_out), "dft": dft().clone()}
        plain = spectral_plain(chain, pre, t_out)
        chain64 = dataclasses.replace(chain, **{
            k: getattr(chain, k).double()
            for k in ("window", "cos", "sin", "mel", "dct", "lift")})
        truth = spectral_plain(chain64, pre.double(), t_out)
    torch.cuda.synchronize()
    require(fbank.by_design == {"fft": before["fft"] + 1,
                                "dft": before["dft"]},
            f"fbank by_design {fbank.by_design} after one call")
    errs = {d: float((x - plain).abs().max()) for d, x in got.items()}
    vs64 = {d: float((x.double() - truth).abs().max())
            for d, x in got.items()}
    vs64["plain"] = float((plain.double() - truth).abs().max())
    print(f"fbank kernel vs plain: B={pre.shape[0]} T={t_out} "
          f"F={got['fft'].shape[2]} max_abs_err: fft design "
          f"{errs['fft']:.3e}, dft design {errs['dft']:.3e} (tol "
          f"{FBANK_TOL:g}); against spectral_plain with float64 tables on "
          f"the card: fft {vs64['fft']:.3e}, dft {vs64['dft']:.3e}, plain "
          f"(fp32) {vs64['plain']:.3e}")
    for d, x in got.items():
        require(bool(torch.isfinite(x).all()), f"fbank {d}: non-finite")
        require(errs[d] <= FBANK_TOL, f"fbank {d} design disagrees with "
                "plain")

    def fft():
        return fbank(chain, pre, t_out)

    with torch.inference_mode():
        turns = [cuda_ms(fft, 20) for _ in range(2)]
        dev = kernel_device_ms(fft, 20, "fbank_fft")
        plain_ms = cuda_ms(lambda: spectral_plain(chain, pre, t_out), 20)
        lib_out = cufft_chain(chain, pre, t_out)
        lib_ms = cuda_ms(lambda: cufft_chain(chain, pre, t_out), 20)
    torch.cuda.synchronize()
    fft_ms = sum(turns) / 2
    bounds = fbank_bounds(chain, pre, got["fft"])
    print(f"[{card}] fbank at B={pre.shape[0]} T={t_out}, the fft design "
          f"through the wrapper, two turns: {turns[0]:.4f} / {turns[1]:.4f}"
          f" ms (device time "
          f"{'not measured' if dev is None else f'{dev:.4f} ms'}; "
          f"``lstm_step_split.py fbank_dft`` times the dft design against "
          f"it in turns); plain {plain_ms:.4f} ms; bound "
          f"{bounds['fft'][0]:.4f} ms "
          f"({bounds['fft'][1]}; the least work: a real FFT, banded mel), "
          f"the DFT-form bound {bounds['dft'][0]:.4f} ms "
          f"({bounds['dft'][1]})")
    print(f"[{card}] fbank yardstick, the stock cuFFT chain (unfold, "
          f"torch.fft.rfft, power, mel and DCT products, logs; several "
          f"calls, so library_ms stays null): {lib_ms:.4f} ms "
          f"({lib_ms / fft_ms:.2f}x the fft design), max_abs_err vs plain "
          f"{float((lib_out - plain).abs().max()):.3e}")
    return {"errs": {"fbank": errs["fft"]},
            "times": {"fbank": (fft_ms, plain_ms)},
            "bounds": {"fbank": bounds["fft"]},
            "library": {"fbank": None}}


def features_stage_split(card: str, feat, flat: torch.Tensor,
                         n_pad: int) -> None:
    """The deep_blstm pcm16 slice's wire unpack and features stage split
    with CUDA events, as ``serve_batch`` and ``DeviceFeaturizer._transform``
    run them: unpack_audio; _prep; fbank; the two _delta_device calls; the
    concatenation and _finalize.  Mean of 5 after one warm-up."""
    from asr_study_torch.data import wire
    from asr_study_torch.features.device import _delta_device

    def split():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        wavs, lens = wire.unpack_audio(flat, BATCH, n_pad)
        wavs, lens = wavs.to(torch.float32), lens.to(torch.int32)
        ev[1].record()
        pre, t_out, fl = feat._prep(wavs, lens)
        ev[2].record()
        base = feat._spectral(pre, t_out)
        ev[3].record()
        d1 = _delta_device(base, fl)
        ev[4].record()
        d2 = _delta_device(d1, fl)
        ev[5].record()
        feat._finalize(torch.cat([base, d1, d2], dim=-1), fl)
        ev[6].record()
        return ev

    with torch.inference_mode():
        split()
        runs = [split() for _ in range(5)]
    torch.cuda.synchronize()
    names = ("pcm16 unpack_audio", "_prep", "fbank", "delta",
             "delta of delta", "cat + _finalize")
    parts = {n: sum(r[i].elapsed_time(r[i + 1]) for r in runs) / len(runs)
             for i, n in enumerate(names)}
    print(f"[{card}] deep_blstm pcm16 slice's wire and features stages "
          f"split, CUDA events, one batch, mean of {len(runs)}: "
          + "; ".join(f"{n} {v:.4f} ms" for n, v in parts.items())
          + f"; features {sum(parts.values()) - parts[names[0]]:.4f} ms")


# processes that run the serving slices' plain path on the CPU at once, at
# most, one thread each (the H100 machines this runs on have 8 cores)
PLAIN_WORKERS = 8
_plain_model: dict = {}
# torch's threads in this process (one a core): CpuChecks' chaotic held
# steps run in as many
HELD_THREADS = torch.get_num_threads()


def plain_workers(jobs: int) -> int:
    """Worker processes for ``jobs`` plain batches: one a core that this
    process may run on, up to PLAIN_WORKERS."""
    return max(1, min(jobs, PLAIN_WORKERS, len(os.sched_getaffinity(0))))


def plain_worker_init() -> None:
    """A plain worker: one thread, and no card (a CUDA tensor in a job
    fails loudly rather than opening a context)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)


def plain_serve(path: str, codec: str, chunk: np.ndarray, n_pad: int,
                scap: int | None) -> tuple:
    """One serving batch through the plain path on the CPU, in a worker
    process: the model pickled at ``path`` (the worker keeps the last one
    it loaded) fed the wire buffer ``chunk`` -> Served's fields as
    arrays."""
    from asr_study_torch.cli.predict import serve_batch
    from asr_study_torch.features.select import featurizer

    if _plain_model.get("path") != path:
        _plain_model.update(path=path,
                            model=torch.load(path, weights_only=False))
    if "feat" not in _plain_model:
        _plain_model["feat"] = featurizer("mfcc", "cpu")
    served = serve_batch(_plain_model["model"], _plain_model["feat"],
                         torch.from_numpy(chunk), BATCH, n_pad, codec, scap)
    return tuple(t.detach().numpy() for t in served)


def run_plain(jobs: list) -> list:
    """plain_serve of each job, in plain_workers(len(jobs)) spawned
    processes, all stopped before it returns -> Served on the CPU, in the
    jobs' order."""
    import concurrent.futures
    import multiprocessing

    from asr_study_torch.cli.predict import Served

    pool = concurrent.futures.ProcessPoolExecutor(
        plain_workers(len(jobs)),
        mp_context=multiprocessing.get_context("spawn"),
        initializer=plain_worker_init)
    try:
        futures = [pool.submit(plain_serve, *job) for job in jobs]
        return [Served(*map(torch.from_numpy, f.result())) for f in futures]
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


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


def dpack_two_launch(payload: torch.Tensor, row_start: torch.Tensor,
                     widths: torch.Tensor, scap: int):
    """The retired two-launch dpack decode (csrc/dpack.cu) through its C
    entry point -> (launch, its output).  It counts no launch."""
    from asr_study_torch import _build

    nbcap = scap // 4096
    out = torch.empty(scap, dtype=torch.float32, device=payload.device)
    totals = torch.empty(nbcap, dtype=torch.int32, device=payload.device)

    def launch():
        _build.check(_build.lib().asr_dpack_decode(
            payload.data_ptr(), payload.shape[0], row_start.data_ptr(),
            widths.data_ptr(), totals.data_ptr(), out.data_ptr(), nbcap,
            torch.cuda.current_stream().cuda_stream), "asr_dpack_decode")
    return launch, out


def dpack_one_launch(payload: torch.Tensor, row_start: torch.Tensor,
                     widths: torch.Tensor, scap: int):
    """The one-launch dpack decode (csrc/dpack_onepass.cu) through its C
    entry point, with its output and scratch made once -> (launch, its
    output).  It counts no launch: the wrapper does."""
    from asr_study_torch import _build
    from asr_study_torch.ops.dpack import SCRATCH_CTAS

    out = torch.empty(scap, dtype=torch.float32, device=payload.device)
    scratch = torch.empty(SCRATCH_CTAS, dtype=torch.int32,
                          device=payload.device)

    def launch():
        _build.check(_build.lib().asr_dpack_decode_onepass(
            payload.data_ptr(), payload.shape[0], row_start.data_ptr(),
            widths.data_ptr(), scratch.data_ptr(), SCRATCH_CTAS,
            out.data_ptr(), scap // 4096,
            torch.cuda.current_stream().cuda_stream),
            "asr_dpack_decode_onepass")
    return launch, out


def dpack_max_grid(dev: torch.device) -> int:
    """The most CTAs the one-launch design's cooperative grid can hold on
    ``dev``: its 256-thread CTAs that fit in the SMs' threads (the
    occupancy calculator, which the C entry point asks, may allow fewer)."""
    p = torch.cuda.get_device_properties(dev)
    return p.multi_processor_count * p.max_threads_per_multi_processor // 256


def native_encode_check(groups: list) -> None:
    """The native phase's encode part: the dpack encode of the native host
    library (``utils/native.py``, the encoder's route) against its NumPy
    twin, byte for byte, on the serving batches and the edge batches; each
    serving batch timed on the host in turns (native, NumPy, native), with
    the library built before."""
    from asr_study_torch.data import wire
    from asr_study_torch.utils import native

    t0 = time.perf_counter()
    path = native.build()
    native.lib()
    print(f"native host library: {path.parent.name}/{path.name} built or "
          f"found in {time.perf_counter() - t0:.2f} s (g++ "
          f"{' '.join(native.CXX_FLAGS)})")

    def timed(ws, use_native):
        t0 = time.perf_counter()
        got = wire.dpack_encode(ws, use_native=use_native)
        return got, 1e3 * (time.perf_counter() - t0)

    edges = list(edge_dpack_batches().values())
    ms = {True: [], False: []}
    for k, ws in enumerate([*groups, *edges]):
        got, nat = timed(ws, True)
        want, npy = timed(ws, False)
        require(got[0] == want[0] and got[3] == want[3]
                and all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
                        for a, b in zip(got[1:3], want[1:3])),
                "the native dpack encode differs from NumPy's")
        if k < len(groups):
            ms[True] += [nat, timed(ws, True)[1]]
            ms[False].append(npy)
    nat, npy = np.mean(ms[True]), np.mean(ms[False])
    print(f"dpack encode, native against NumPy: byte-equal on "
          f"{len(groups)} serving batches and {len(edges)} edge batches; "
          f"host time on this machine's CPU, not the card's, in turns over "
          f"the {len(groups)} serving batches of {BATCH}: native "
          f"{nat:.3f} ms per batch (min {min(ms[True]):.3f}, max "
          f"{max(ms[True]):.3f}), NumPy {npy:.3f} (min "
          f"{min(ms[False]):.3f}, max {max(ms[False]):.3f}), "
          f"{npy / nat:.1f}x")


def check_dpack_kernel(dev: torch.device, card: str, groups: list,
                       wires: dict) -> dict:
    """Phase 3 for the dpack decode: the one-launch design bit for bit
    against its plain version and the two-launch design over the whole
    [scap] stream of every serving batch's dpack wire, of the edge batches
    and of 48 rows of 8 s (more dpack blocks than the cooperative grid has
    CTAs), and unpack_audio over dpack equal to it over pcm16; the
    one-launch design timed at the first serving batch, through the
    wrapper and by device time (``lstm_step_split.py dpack_two_launch``
    times the two designs in turns); the native dpack encode against
    NumPy's (``native_encode_check``)."""
    from asr_study_torch.data import wire
    from asr_study_torch.ops.dpack import dpack_decode, dpack_decode_plain

    with part("native encode check"):
        native_encode_check(groups)

    dp, pcm = wires["dpack"], wires["pcm16"]
    cases = []
    for k, (o, o_pcm) in enumerate(zip(dp.offsets, pcm.offsets)):
        cases.append((f"serving batch {k}", dp.dev[o: o + dp.cap], BATCH,
                      dp.n_pad, dp.scap, pcm.dev[o_pcm: o_pcm + pcm.cap]))
    rng = np.random.RandomState(SEED + 10)
    edges = dict(edge_dpack_batches())
    edges["48 rows of 8 s"] = [(rng.randn(8 * SR) * 0.2).astype(np.float32)
                               for _ in range(48)]
    for name, ws in edges.items():
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
        two, two_out = dpack_two_launch(*args, scap)
        two()
        wav_d, len_d = wire.unpack_audio(flat, b, n_pad, codec="dpack",
                                         scap=scap)
        wav_p, len_p = wire.unpack_audio(flat_pcm, b, n_pad)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"dpack_decode differs from plain on {name}: max_abs_err "
                f"{float((got - want).abs().max()):.3e}")
        require(torch.equal(got, two_out),
                f"dpack_decode differs from the two-launch design on {name}")
        require(torch.equal(wav_d, wav_p) and torch.equal(len_d, len_p),
                f"unpack over dpack differs from pcm16 on {name}")
    max_grid = dpack_max_grid(dev)
    big = cases[-1]
    require(big[4] // 4096 > max_grid, "the long stream must have more "
            "dpack blocks than the cooperative grid has CTAs")
    print(f"dpack_decode kernel (one-launch design) vs plain and the "
          f"two-launch design: bit-equal over the whole stream on "
          f"{len(cases)} wires ({len(dp.offsets)} serving batches of "
          f"{dp.scap // 4096} blocks, scap {dp.scap}; edge: "
          f"{', '.join(c[0] for c in cases[len(dp.offsets):])}, the last "
          f"{big[4] // 4096} blocks, more than the {max_grid} CTAs the "
          f"cooperative grid can hold); unpack_audio over dpack bit-equal "
          f"to pcm16 on each")

    args = wire.dpack_regions(dp.dev[: dp.cap], BATCH, dp.scap)
    payload, row_start, widths = args
    one = dpack_one_launch(*args, dp.scap)[0]
    entry_ms = cuda_ms(one, 50, warmup=5)
    dev_ms = kernel_device_ms(one, 20, "dpack")
    ms = cuda_ms(lambda: dpack_decode(*args, dp.scap), 50, warmup=5)
    plain_ms = cuda_ms(lambda: dpack_decode_plain(*args, dp.scap), 5)
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
          f"through the wrapper {ms:.4f} ms; through its C entry point, 50 "
          f"calls: {entry_ms:.4f} ms (device time {dev_txt}, "
          f"torch.profiler); plain {plain_ms:.4f} ms, bound "
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
    "fbank": ("fbank_fft.cu", "features/pallas_fbank.py:107"),
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
    "dpack_decode": ("dpack_onepass.cu", "ops/pallas_dpack.py:56"),
    # no Pallas kernel: the JAX package's beam is one XLA scan; the wide
    # design takes the (W, V) the select design does not
    "ctc_beam": ("ctc_beam.cu", "ops/beam.py:412"),
    "ctc_beam_wide": ("ctc_beam_wide.cu", "ops/beam.py:412"),
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
    # the LSTM's bfloat16-weight forms (train --bf16): the cluster and wide
    # kernels on a bfloat16 wh, the same sources
    "bilstm_fwd_bf16": ("bilstm_fwd.cu", "ops/pallas_bilstm.py:84"),
    "bilstm_bwd_bf16": ("bilstm_bwd.cu", "ops/pallas_bilstm.py:125"),
    "bilstm_fwd_wide_bf16": ("lstm_wide_fwd.cu", "ops/pallas_bilstm.py:84"),
    "bilstm_bwd_wide_bf16": ("lstm_wide_bwd.cu", "ops/pallas_bilstm.py:125"),
    # the GRU's bfloat16-weight forms: the cluster and wide GRU kernels on
    # a bfloat16 wh, the same sources
    "bigru_fwd_bf16": ("gru_fwd.cu", "ops/pallas_bigru.py:69"),
    "bigru_bwd_bf16": ("gru_bwd.cu", "ops/pallas_bigru.py:92"),
    "bigru_fwd_wide_bf16": ("gru_wide_fwd.cu", "ops/pallas_bigru.py:69"),
    "bigru_bwd_wide_bf16": ("gru_wide_bwd.cu", "ops/pallas_bigru.py:92"),
    # the zoneout and MI LSTMs' bfloat16-weight forms: their cluster
    # kernels on a bfloat16 wh, the same sources; both directions' rows
    "bi_zoneout_lstm_fwd_bf16": ("zoneout_lstm_fwd.cu",
                                 "ops/pallas_bi_zoneout_lstm.py:41"),
    "bi_zoneout_lstm_bwd_bf16": ("zoneout_lstm_bwd.cu",
                                 "ops/pallas_bi_zoneout_lstm.py:83"),
    "zoneout_lstm_fwd_bf16": ("zoneout_lstm_fwd.cu",
                              "ops/pallas_zoneout_lstm.py:56"),
    "zoneout_lstm_bwd_bf16": ("zoneout_lstm_bwd.cu",
                              "ops/pallas_zoneout_lstm.py:133"),
    "bi_mi_lstm_fwd_bf16": ("mi_lstm_fwd.cu", "ops/pallas_bi_mi_lstm.py:39"),
    "bi_mi_lstm_bwd_bf16": ("mi_lstm_bwd.cu", "ops/pallas_bi_mi_lstm.py:81"),
    "mi_lstm_fwd_bf16": ("mi_lstm_fwd.cu", "ops/pallas_mi_lstm.py:59"),
    "mi_lstm_bwd_bf16": ("mi_lstm_bwd.cu", "ops/pallas_mi_lstm.py:132"),
    # the layer-norm LSTM's bfloat16-weight forms: its cluster kernels on a
    # bfloat16 wh, the same sources; both directions' rows
    "bi_ln_lstm_fwd_bf16": ("ln_lstm_fwd.cu",
                            "ops/pallas_bi_ln_lstm.py:39"),
    "bi_ln_lstm_bwd_bf16": ("ln_lstm_bwd.cu",
                            "ops/pallas_bi_ln_lstm.py:81"),
    "ln_lstm_fwd_bf16": ("ln_lstm_fwd.cu", "ops/pallas_ln_lstm.py:106"),
    "ln_lstm_bwd_bf16": ("ln_lstm_bwd.cu", "ops/pallas_ln_lstm.py:198"),
    # the LSTM's and the GRU's stream design on a bfloat16 wh (train --bf16
    # at the batches no resident design takes, as --batch_size 64 in two
    # directions), the same sources
    "bilstm_fwd_stream_bf16": ("lstm_stream_fwd.cu",
                               "ops/pallas_bilstm.py:84"),
    "bilstm_bwd_stream_bf16": ("lstm_stream_bwd.cu",
                               "ops/pallas_bilstm.py:125"),
    "bigru_fwd_stream_bf16": ("gru_stream_fwd.cu", "ops/pallas_bigru.py:69"),
    "bigru_bwd_stream_bf16": ("gru_stream_bwd.cu", "ops/pallas_bigru.py:92"),
    # the zoneout and MI LSTMs' stream design on a bfloat16 wh (train --bf16
    # --batch_size 64 of zoneout_blstm and mi_blstm), the same sources; both
    # directions' rows
    "bi_zoneout_lstm_fwd_stream_bf16": ("zoneout_lstm_stream_fwd.cu",
                                        "ops/pallas_bi_zoneout_lstm.py:41"),
    "bi_zoneout_lstm_bwd_stream_bf16": ("zoneout_lstm_stream_bwd.cu",
                                        "ops/pallas_bi_zoneout_lstm.py:83"),
    "zoneout_lstm_fwd_stream_bf16": ("zoneout_lstm_stream_fwd.cu",
                                     "ops/pallas_zoneout_lstm.py:56"),
    "zoneout_lstm_bwd_stream_bf16": ("zoneout_lstm_stream_bwd.cu",
                                     "ops/pallas_zoneout_lstm.py:133"),
    "bi_mi_lstm_fwd_stream_bf16": ("mi_lstm_stream_fwd.cu",
                                   "ops/pallas_bi_mi_lstm.py:39"),
    "bi_mi_lstm_bwd_stream_bf16": ("mi_lstm_stream_bwd.cu",
                                   "ops/pallas_bi_mi_lstm.py:81"),
    "mi_lstm_fwd_stream_bf16": ("mi_lstm_stream_fwd.cu",
                                "ops/pallas_mi_lstm.py:59"),
    "mi_lstm_bwd_stream_bf16": ("mi_lstm_stream_bwd.cu",
                                "ops/pallas_mi_lstm.py:132"),
    # the layer-norm LSTM's stream design on a bfloat16 wh (train --bf16
    # --batch_size 64 --model ln_blstm), the same sources; both directions'
    # rows
    "bi_ln_lstm_fwd_stream_bf16": ("ln_lstm_stream_fwd.cu",
                                   "ops/pallas_bi_ln_lstm.py:39"),
    "bi_ln_lstm_bwd_stream_bf16": ("ln_lstm_stream_bwd.cu",
                                   "ops/pallas_bi_ln_lstm.py:81"),
    "ln_lstm_fwd_stream_bf16": ("ln_lstm_stream_fwd.cu",
                                "ops/pallas_ln_lstm.py:106"),
    "ln_lstm_bwd_stream_bf16": ("ln_lstm_stream_bwd.cu",
                                "ops/pallas_ln_lstm.py:198"),
}
# kernel line row of the wide design -> the wrapper that launches it
WIDE_ROWS = {"bilstm_fwd_wide": "bilstm_fwd", "bilstm_bwd_wide": "bilstm_bwd",
             "lstm_fwd_wide": "lstm_fwd", "lstm_bwd_wide": "lstm_bwd",
             "bigru_fwd_wide": "bigru_fwd", "bigru_bwd_wide": "bigru_bwd",
             "gru_fwd_wide": "gru_fwd", "gru_bwd_wide": "gru_bwd",
             "ctc_beam_wide": "ctc_beam"}
# kernel line row of a bfloat16-weight form -> (the wrapper that launches
# it, its by_design key); the LSTM's and the GRU's unidirectional rows are
# counted but not in the kernels line, whose bf16 rows of theirs are the
# bidirectional ones (the LN, zoneout and MI LSTMs' rows of both
# directions are in it)
BF16_ROWS = {**{f"{w}{suffix}_bf16": (w, design + "_bf16")
                for w in ("bilstm_fwd", "bilstm_bwd", "lstm_fwd", "lstm_bwd",
                          "bigru_fwd", "bigru_bwd", "gru_fwd", "gru_bwd")
                for suffix, design in (("", "cluster"), ("_wide", "wide"),
                                       ("_stream", "stream"))},
             **{f"{w}_bf16": (w, "cluster_bf16")
                for w in ("bi_zoneout_lstm_fwd", "bi_zoneout_lstm_bwd",
                          "zoneout_lstm_fwd", "zoneout_lstm_bwd",
                          "bi_mi_lstm_fwd", "bi_mi_lstm_bwd", "mi_lstm_fwd",
                          "mi_lstm_bwd", "bi_ln_lstm_fwd", "bi_ln_lstm_bwd",
                          "ln_lstm_fwd", "ln_lstm_bwd")},
             **{f"{w}_stream_bf16": (w, "stream_bf16")
                for w in ("bi_zoneout_lstm_fwd", "bi_zoneout_lstm_bwd",
                          "zoneout_lstm_fwd", "zoneout_lstm_bwd",
                          "bi_mi_lstm_fwd", "bi_mi_lstm_bwd", "mi_lstm_fwd",
                          "mi_lstm_bwd", "bi_ln_lstm_fwd", "bi_ln_lstm_bwd",
                          "ln_lstm_fwd", "ln_lstm_bwd")}}

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
# the optimizer phase: deep_blstm 3x256 (the deep_blstm training path's
# model) for OPT_STEPS steps, a fresh batch of OPT_B x OPT_T each step (so
# the plateau sees a loss that need not fall), against the CPU plain path;
# label -> make_optimizer's arguments after the name (clip 400)
OPT_B, OPT_T, OPT_L, OPT_STEPS = 8, 128, 24, 3
OPT_CASES = {
    "adamw": dict(name="adamw", lr=1e-4, weight_decay=1e-2),
    "sgd": dict(name="sgd", lr=2e-4),
    "rmsprop": dict(name="rmsprop", lr=1e-4),
    "adam+plateau": dict(name="adam", lr=1e-4, plateau_factor=0.5,
                         plateau_patience=1, plateau_window=1),
}


def launch_counters() -> dict:
    """Every kernel wrapper of the port, by kernel name."""
    from asr_study_torch.features.fbank import fbank
    from asr_study_torch.ops import beam, ctc
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
            "dpack_decode": dpack_decode, "ctc_beam": beam.ctc_beam}


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
    for name in (*DESIGN_WRAPPERS, "fbank", "ctc_beam"):
        counters[name].by_design = dict.fromkeys(counters[name].by_design, 0)


def check_designs(label: str, hidden: int, batch: int,
                  s_len: int | None = None, bf16: bool = False) -> None:
    """The LSTM, GRU, layer-norm, zoneout and MI LSTM kernels launched
    since the counts were reset ran the design ``lstm_geometry`` /
    ``gru_geometry`` / ``ln_geometry`` / ``zoneout_geometry`` /
    ``mi_geometry`` gives this path's width and batch (with ``bf16``, its
    bfloat16-weight form), and the CTC kernels the one ``ctc_design``
    gives its lattice of ``s_len`` states, and no other."""
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
        want += "_bf16" if bf16 else ""
        require(list(by_design) == [want],
                f"{label}: {name} ran {by_design}, want only {want}")


def read_counts() -> dict:
    """The nonzero launch counts by kernel line row: the LSTM, GRU and
    beam wrappers' wide launches under their own rows (WIDE_ROWS), the
    LSTM wrappers' bfloat16-weight launches under theirs (BF16_ROWS), the
    rest under the wrapper's."""
    counters = launch_counters()
    counts = {k: fn.launches for k, fn in counters.items()}
    rows = {**{row: (name, "wide") for row, name in WIDE_ROWS.items()},
            **BF16_ROWS}
    for row, (name, design) in rows.items():
        counts[row] = counters[name].by_design[design]
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


def check_reproducible(path: str, make, spec, batch, dev,
                       compute_dtype=None) -> None:
    """Two train steps from the same weights, fresh Adam state, batch and
    generator seed (in ``compute_dtype``): the loss and every gradient must
    be equal bit for bit."""
    from asr_study_torch.train.trainer import Trainer

    runs = []
    for _ in range(2):
        tr = Trainer(make(dev), spec, compute_dtype=compute_dtype)
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


def train_host(seed: int = SEED) -> tuple:
    """The training paths' batch (config-3 shapes, from ``seed``) as numpy
    arrays: features [B, T, F], frame lengths, labels, label lengths,
    weights."""
    rng = np.random.RandomState(seed)
    return (rng.randn(TRAIN_B, TRAIN_T, FEATS).astype(np.float32),
            np.full(TRAIN_B, TRAIN_T, np.int32),
            rng.randint(0, NUM_CLASSES, (TRAIN_B, TRAIN_L)).astype(np.int32),
            np.full(TRAIN_B, TRAIN_L, np.int32),
            np.ones(TRAIN_B, np.float32))


def cpu_train_step(path: str, host: tuple, mix: list,
                   threads: int | None = None) -> tuple:
    """The first train step of one of TRAIN_PATHS on the CPU (the plain
    path), in a worker process (CpuChecks): the path's model from SEED,
    adam 1e-4 clip 400, the batch ``host`` (numpy arrays), the zoneout mix
    weights ``mix`` (the card's, pairs of arrays) replayed, in ``threads``
    torch threads where given -> (loss, grad_norm, {parameter: gradient},
    seconds)."""
    from asr_study_torch.models.zoo import build_model
    from asr_study_torch.train.trainer import Trainer, make_optimizer

    t0 = time.perf_counter()
    before = torch.get_num_threads()
    if threads is not None:
        torch.set_num_threads(threads)
    model_name, hp = TRAIN_PATHS[path][:2]
    model = build_model(model_name, hp, num_classes=NUM_CLASSES,
                        input_dim=FEATS,
                        generator=torch.Generator().manual_seed(SEED),
                        device="cpu")
    trainer = Trainer(model, make_optimizer("adam", 1e-4, 400.0))
    tap = MixTap()
    tap.drawn = [tuple(map(torch.from_numpy, z)) for z in mix]
    try:
        with tap.replay():
            _, m = trainer.train_step(trainer.init_state(),
                                      *map(torch.from_numpy, host),
                                      torch.Generator().manual_seed(SEED))
    finally:
        torch.set_num_threads(before)
    return (float(m["loss"]), float(m["grad_norm"]),
            {n: p.grad.numpy() for n, p in model.named_parameters()},
            time.perf_counter() - t0)


class CpuChecks:
    """The training paths' steps on the CPU (cpu_train_step), in spawned
    processes of one thread each, one core left to the process that drives
    the card: a path hands in its jobs and goes on, and ``finish`` (after
    the last path) waits for each result and runs its check.  A chaotic
    path's held step runs in as many threads as this process has
    (HELD_THREADS), the summation order its check has always had: that
    step's plain path parts from itself by more than STEP_GRAD_RTOL
    between one thread and eight (ln_blstm at T=LN_CHECK_T: 1.58e-3 of
    ln_c.b's gradient in one thread, 2.36e-4 in eight)."""

    def __init__(self, jobs: int):
        import concurrent.futures
        import multiprocessing

        self.workers = max(1, plain_workers(jobs) - 1)
        self.pool = concurrent.futures.ProcessPoolExecutor(
            self.workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=plain_worker_init)
        self.pending = []
        self.t0 = time.perf_counter()

    def submit(self, job: tuple, check) -> None:
        """cpu_train_step(*job), its result handed to ``check``."""
        self.pending.append((self.pool.submit(cpu_train_step, *job), check))

    def finish(self) -> None:
        t_wait = time.perf_counter()
        try:
            results = [(f.result(), check) for f, check in self.pending]
        finally:
            self.pool.shutdown(wait=True, cancel_futures=True)
        now = time.perf_counter()
        cpu_s = sum(r[3] for r, _ in results)
        PARTS["training paths' CPU steps, waited for"] = now - t_wait
        print(f"the training paths' steps on the CPU: {len(results)} in "
              f"{self.workers} worker processes of one thread, {cpu_s:.1f} s "
              f"of steps in {now - self.t0:.1f} s of wall time beside the "
              f"card's work, {now - t_wait:.1f} s of it waited for after "
              f"the last path")
        for r, check in results:
            check(r)


def cpu_steps_turns(turns: int = 2) -> int:
    """``python3 chip_smoke.py cpu_steps_turns``: the training paths' steps
    on the CPU (the jobs training_slice hands CpuChecks: every path's first
    step at full size, the chaotic paths' at LN_CHECK_T too; the zoneout
    paths' mix weights drawn here, Bernoulli(0.9) as on the card) timed in
    their two placements, in turns: one after another in this process, its
    threads on every core (the placement before CpuChecks), and in
    CpuChecks' worker processes.  Host work only: no card is needed; the
    wall times vary with the machine's load, so compare them within one
    run."""
    rng = np.random.RandomState(SEED + 1)
    host = train_host()
    n_lab = LN_CHECK_T // 4
    short = (host[0][:, :LN_CHECK_T], np.minimum(host[1], LN_CHECK_T),
             host[2][:, :n_lab], np.minimum(host[3], n_lab), host[4])
    jobs = []
    for path, (model_name, _, _, _, layers, _) in TRAIN_PATHS.items():
        pairs = (layers * (1 if "uni" in path else 2)
                 if model_name == "zoneout_blstm" else 0)
        mix = [tuple((rng.rand(TRAIN_T, TRAIN_B, HIDDEN) < 0.9).astype(
            np.float32) for _ in range(2)) for _ in range(pairs)]
        jobs.append((path, host, mix))
        if path in CHAOTIC:
            jobs.append((path, short, mix, HELD_THREADS))
    print(f"{len(jobs)} CPU steps of the training paths, {turns} turns of "
          f"each placement (in process, then workers, then the reverse)")
    walls = {"in process": [], "workers": []}
    order = ["in process", "workers"]
    for turn in range(turns):
        for where in (order if turn % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            if where == "in process":
                steps = [cpu_train_step(*job[:3])[3] for job in jobs]
            else:
                checks = CpuChecks(len(jobs))
                for job in jobs:
                    checks.submit(job, lambda r: None)
                steps = [f.result()[3] for f, _ in checks.pending]
                checks.pool.shutdown(wait=True)
            walls[where].append(time.perf_counter() - t0)
            print(f"turn {turn}, {where}: {walls[where][-1]:.1f} s wall, "
                  f"steps {sum(steps):.1f} s in all (longest "
                  f"{max(steps):.1f} s), torch threads here "
                  f"{torch.get_num_threads()}, cores "
                  f"{len(os.sched_getaffinity(0))}")
    print("mean wall s: " + "; ".join(f"{k} {np.mean(v):.1f}"
                                       for k, v in walls.items()))
    return 0


def training_slice(dev: torch.device, card: str, path: str,
                   checks: CpuChecks, with_fit: bool = True) -> dict:
    """Phases 6 and 7 for one of TRAIN_PATHS: the config-3 training shapes
    through Trainer (and, ``with_fit``, fit with a checkpoint); the first
    step on the CPU handed to ``checks`` -> the launches, and ``time``,
    which times the path's steps (train_timings) once ``checks`` has
    finished: the workers share the host, and steps timed beside them
    ran slower."""
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
    host = train_host()
    batch = [torch.from_numpy(a).to(dev) for a in host]
    model = make(dev)
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

    # the first step again on the CPU: the plain path, the same weights,
    # in a worker process (CpuChecks) while the card goes on
    check_on = "the first step"
    if path in CHAOTIC:
        # the full-size first step on the CPU too: printed, not held
        def printed(r, loss_1=loss_1, gnorm_1=gnorm_1):
            print(f"{path} train, the first step at full size, kernel path "
                  f"on the card vs plain path on the CPU (not held: a "
                  f"chaotic recurrence; {r[3]:.1f} s there): loss "
                  f"{loss_1:.4f} vs {r[0]:.4f}, rel "
                  f"{abs(loss_1 / r[0] - 1):.3e}; grad_norm {gnorm_1:.4g} "
                  f"vs {r[1]:.4g}")

        checks.submit((path, host, []), printed)
        # one step from the same weights on the batch cut to LN_CHECK_T
        # frames and LN_CHECK_T // 4 labels, on the card and on the CPU
        n_lab = LN_CHECK_T // 4
        host = (host[0][:, :LN_CHECK_T], np.minimum(host[1], LN_CHECK_T),
                host[2][:, :n_lab], np.minimum(host[3], n_lab), host[4])
        short = Trainer(make(dev), spec)
        _, m = short.train_step(short.init_state(),
                                *[torch.from_numpy(a).to(dev) for a in host])
        grads = {n: p.grad.detach().cpu()
                 for n, p in short.model.named_parameters()}
        loss_1, gnorm_1 = float(m["loss"]), float(m["grad_norm"])
        check_on = (f"a step at T={LN_CHECK_T}, L={n_lab} from the same "
                    f"weights (a chaotic recurrence)")
    if tap.drawn:
        check_on += (f" with the card's mix weights of that step "
                     f"({len(tap.drawn)} pairs, mean zh "
                     f"{float(torch.stack([z[0].mean() for z in tap.drawn]).mean()):.4f})")

    threads = HELD_THREADS if path in CHAOTIC else None

    def held(r):
        loss_cpu, gnorm_cpu, grads_cpu, cpu_s = r
        loss_rel = abs(loss_1 - loss_cpu) / abs(loss_cpu)
        gnorm_rel = abs(gnorm_1 - gnorm_cpu) / gnorm_cpu
        grad_rel = {n: float((grads[n] - torch.from_numpy(g)).norm()
                             / torch.from_numpy(g).norm())
                    for n, g in grads_cpu.items()}
        worst = max(grad_rel, key=grad_rel.get)
        print(f"{path} train, {check_on}, kernel path on the card vs plain "
              f"path on the CPU ({cpu_s:.1f} s there"
              + (f", {threads} threads" if threads else "")
              + f"): loss {loss_1:.4f} vs "
              f"{loss_cpu:.4f}, rel {loss_rel:.3e} (tol {STEP_LOSS_RTOL:g}); "
              f"grad_norm {gnorm_1:.4f} vs {gnorm_cpu:.4f}, rel "
              f"{gnorm_rel:.3e} (tol {STEP_GNORM_RTOL:g}); gradients of "
              f"{len(grad_rel)} parameters, worst ||diff||/||cpu|| "
              f"{grad_rel[worst]:.3e} in {worst} (tol {STEP_GRAD_RTOL:g})")
        require(loss_rel <= STEP_LOSS_RTOL,
                f"{path}: train loss disagrees with CPU")
        require(gnorm_rel <= STEP_GNORM_RTOL,
                f"{path}: grad norm disagrees with CPU")
        require(grad_rel[worst] <= STEP_GRAD_RTOL,
                f"{path}: a gradient disagrees with CPU")

    checks.submit((path, host, [tuple(z.cpu().numpy() for z in pair)
                                for pair in tap.drawn], threads), held)

    if with_fit:
        fit_and_resume(dev, make, spec, per_steps)
    return {"launches": launches,
            "time": lambda: train_timings(card, path, desc, layers, trainer,
                                          state, batch, gen)}


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


def optimizer_phase(dev: torch.device, card: str) -> list:
    """The rest of the optimizer factory on the deep_blstm training path's
    model: for each of OPT_CASES, OPT_STEPS steps with launches counted
    from 0, each step's loss and grad norm against the same steps of the
    plain path on the CPU (STEP_LOSS_RTOL, STEP_GNORM_RTOL; the weights'
    distance printed, held elementwise for SGD, whose update is linear in
    the gradient: Adam's and RMSprop's first updates turn a near-zero
    gradient's rounding into a sign), and the run repeated bit for bit;
    SGD with accum_steps=2 over the two halves of a batch against one
    step on the whole of it; check_nans raising on a NaN batch before any
    update; fit(profile=True) writing a trace with the card's kernels ->
    the launches of each counted run."""
    from asr_study_torch.data.generator import DatasetGenerator
    from asr_study_torch.models.zoo import build_model
    from asr_study_torch.train.loop import fit
    from asr_study_torch.train.trainer import Trainer, make_optimizer

    model_name, hp, fwd_name, bwd_name, layers, desc = \
        TRAIN_PATHS["deep_blstm"]

    def make(device):
        return build_model(model_name, hp, num_classes=NUM_CLASSES,
                           input_dim=FEATS,
                           generator=torch.Generator().manual_seed(SEED + 60),
                           device=device)

    rng = np.random.RandomState(SEED + 60)
    hosts = [(rng.randn(OPT_B, OPT_T, FEATS).astype(np.float32),
              rng.randint(OPT_T // 2, OPT_T + 1, OPT_B).astype(np.int32),
              rng.randint(0, NUM_CLASSES, (OPT_B, OPT_L)).astype(np.int32),
              rng.randint(OPT_L // 2, OPT_L + 1, OPT_B).astype(np.int32),
              np.ones(OPT_B, np.float32)) for _ in range(OPT_STEPS)]
    cpu_batches = [[torch.from_numpy(a) for a in h] for h in hosts]
    batches = [[a.to(dev) for a in b] for b in cpu_batches]

    def run(spec, device, steps, **kw):
        trainer = Trainer(make(device), spec, **kw)
        state = trainer.init_state()
        ms = [trainer.train_step(state, *b)[1] for b in steps]
        return state, [(float(m["loss"]), float(m["grad_norm"]))
                       for m in ms]

    def weights(state):
        return [p.detach().cpu() for p in state.model.parameters()]

    def rel(a, b):
        return abs(a - b) / abs(b)

    runs = []
    for label, kw in OPT_CASES.items():
        spec = make_optimizer(clipnorm=400.0, **kw)
        reset_counts()
        state, card_m = run(spec, dev, batches)
        launches = read_counts()
        want = {fwd_name: layers * OPT_STEPS, bwd_name: layers * OPT_STEPS,
                "ctc_alpha": OPT_STEPS, "ctc_beta": OPT_STEPS}
        require(launches == want, f"optimizer {label}: launches {launches}, "
                f"want {want}")
        runs.append(launches)
        again, _ = run(spec, dev, batches)
        same = all(torch.equal(a, b) for a, b in zip(
            state.model.parameters(), again.model.parameters()))
        require(same, f"optimizer {label}: two identical runs differ")
        t0 = time.perf_counter()
        cpu_state, cpu_m = run(spec, "cpu", cpu_batches)
        cpu_s = time.perf_counter() - t0
        loss_rel = max(rel(a[0], b[0]) for a, b in zip(card_m, cpu_m))
        gnorm_rel = max(rel(a[1], b[1]) for a, b in zip(card_m, cpu_m))
        w0 = weights(run(spec, "cpu", [])[0])
        w_card, w_cpu = weights(state), weights(cpu_state)
        w_rel = max(float((a - b).norm() / (b - c).norm())
                    for a, b, c in zip(w_card, w_cpu, w0))
        w_ok = all(within(a, b, 1e-5, 1e-4) for a, b in zip(w_card, w_cpu))
        scale = ("" if state.plateau is None else
                 f"; plateau scale {float(state.plateau.scale):g} on the "
                 f"card, {float(cpu_state.plateau.scale):g} on the CPU")
        print(f"optimizer {label} ({kw}), deep_blstm {desc} B={OPT_B} "
              f"T={OPT_T}, {OPT_STEPS} steps on fresh batches: launches "
              f"{launches}; losses {[round(m[0], 4) for m in card_m]}, vs "
              f"the CPU plain path ({cpu_s:.1f} s there) rel {loss_rel:.3e} "
              f"(tol {STEP_LOSS_RTOL:g}), grad norms rel {gnorm_rel:.3e} (tol "
              f"{STEP_GNORM_RTOL:g}); weights: worst ||card - cpu|| / "
              f"||update|| {w_rel:.3e}, elementwise within 1e-5 + "
              f"1e-4*|cpu| {w_ok}{scale}; two runs bit-equal {same}")
        require(loss_rel <= STEP_LOSS_RTOL,
                f"optimizer {label}: a loss disagrees with the CPU")
        require(gnorm_rel <= STEP_GNORM_RTOL,
                f"optimizer {label}: a grad norm disagrees with the CPU")
        if kw["name"] == "sgd":
            require(w_ok, f"optimizer {label}: the weights disagree with "
                    "the CPU")
        if state.plateau is not None:
            require(torch.equal(state.plateau.scale.cpu(),
                                cpu_state.plateau.scale),
                    f"optimizer {label}: the plateau scale differs")

    # accumulation: two halves against the whole batch
    halves = [[a[i * OPT_B // 2: (i + 1) * OPT_B // 2] for a in batches[0]]
              for i in range(2)]
    acc_spec = make_optimizer("sgd", 2e-4, 400.0, accum_steps=2)
    reset_counts()
    acc_state, _ = run(acc_spec, dev, halves)
    launches = read_counts()
    runs.append(launches)
    acc_again, _ = run(acc_spec, dev, halves)
    big_state, _ = run(make_optimizer("sgd", 2e-4, 400.0), dev, batches[:1])
    acc_w, big_w = weights(acc_state), weights(big_state)
    err = max(float((a - b).abs().max()) for a, b in zip(acc_w, big_w))
    acc_ok = all(within(a, b, 1e-5, 1e-4) for a, b in zip(acc_w, big_w))
    acc_same = all(torch.equal(a, b) for a, b in zip(
        acc_state.model.parameters(), acc_again.model.parameters()))
    print(f"optimizer sgd accum_steps=2 over the two halves of a batch "
          f"(B={OPT_B // 2} each) vs one step on the whole: launches "
          f"{launches}, steps {acc_state.step} vs {big_state.step}, weights "
          f"max_abs_err={err:.3e} (tol 1e-5 + 1e-4*|whole|); two runs "
          f"bit-equal {acc_same}")
    require(acc_state.step == 2 and acc_ok and acc_same,
            "accumulation disagrees with the whole batch")

    # check_nans: a NaN in the inputs stops the step before the update
    nan_batch = [a.clone() for a in batches[0]]
    nan_batch[0][0, 3, 5] = float("nan")
    trainer = Trainer(make(dev), make_optimizer("adam", 1e-4, 400.0),
                      check_nans=True)
    nan_state = trainer.init_state()
    before = [p.detach().clone() for p in nan_state.model.parameters()]
    try:
        trainer.train_step(nan_state, *nan_batch)
        raised = ""
    except FloatingPointError as e:
        raised = str(e)
    untouched = all(torch.equal(a, b) for a, b in zip(
        before, nan_state.model.parameters()))
    print(f"check_nans on a batch with a NaN input: raised "
          f"FloatingPointError {bool(raised)} ({raised[:60]}...), weights "
          f"untouched {untouched}, step {nan_state.step}")
    require(bool(raised) and untouched and nan_state.step == 0,
            "check_nans did not stop the NaN step")

    # fit(profile=True): steps [1, 3) of two epochs of two steps traced
    frng = np.random.RandomState(SEED + 61)
    feats = [frng.randn(frng.randint(OPT_T // 2, OPT_T + 1), FEATS)
             .astype(np.float32) for _ in range(2 * OPT_B)]
    labs = [frng.randint(0, NUM_CLASSES, frng.randint(8, OPT_L + 1))
            .astype(np.int32) for _ in range(2 * OPT_B)]
    it = DatasetGenerator(batch_size=OPT_B).flow(feats, labs)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(make(dev), make_optimizer("adam", 1e-4, 400.0))
        reset_counts()
        t0 = time.perf_counter()
        fit_state = fit(trainer, trainer.init_state(), it, epochs=2,
                        log_dir=tmp, profile=True, profile_steps=(1, 3))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = read_counts()
        runs.append(launches)
        files = os.listdir(os.path.join(tmp, "trace"))
        require(files == ["steps_1_3.pt.trace.json"],
                f"fit(profile=True) wrote {files}")
        path = os.path.join(tmp, "trace", files[0])
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(path)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ours = sorted({m.group(0) for m in (
        re.search(r"\w*(?:lstm|ctc)\w*", e["name"]) for e in kernels) if m})
    print(f"fit(profile=True): {fit_state.step} steps in {fit_s:.1f} s, "
          f"launches {launches}; steps [1, 3) traced into "
          f"<log_dir>/trace/{files[0]} ({size} bytes, {len(events)} events, "
          f"{len(kernels)} kernel events; the port's: {ours})")
    require(bool(ours), "the profile trace holds none of the port's kernels")
    return runs


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


class CliTap:
    """Inside ``record()``: CUDA events around every ``Trainer.train_step``
    and ``cli.eval.eval_batch`` call, with the batch's padded T, each
    step's loss (a device scalar), and the host seconds and iterators of
    every ``DatasetGenerator.flow_from_json`` and ``flow_from_h5`` call (the
    manifest's features, or the HDF5 split read), as the CLIs make them;
    nothing else changes."""

    def __init__(self):
        self.steps, self.evals, self.flows, self.losses = [], [], [], []
        self.features_s = 0.0

    @contextlib.contextmanager
    def record(self):
        from asr_study_torch.cli import eval as cli_eval
        from asr_study_torch.data.generator import DatasetGenerator
        from asr_study_torch.train.trainer import Trainer

        real_step, real_eval = Trainer.train_step, cli_eval.eval_batch
        real_flow = DatasetGenerator.flow_from_json
        real_h5 = DatasetGenerator.flow_from_h5

        def timed(fn, into, inputs_at, losses=None):
            def call(*args, **kwargs):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = fn(*args, **kwargs)
                ev[1].record()
                into.append((ev, args[inputs_at].shape[1]))
                if losses is not None:
                    losses.append(out[1]["loss"])
                return out
            return call

        def tapped(real, split_at):
            def flow(gen, *args, **kwargs):
                t0 = time.perf_counter()
                it = real(gen, *args, **kwargs)
                self.features_s += time.perf_counter() - t0
                split = kwargs.get("split", args[split_at]
                                   if len(args) > split_at else None)
                self.flows.append((split, it))
                return it
            return flow

        Trainer.train_step = timed(real_step, self.steps, 2, self.losses)
        cli_eval.eval_batch = timed(real_eval, self.evals, 1)
        DatasetGenerator.flow_from_json = tapped(real_flow, 3)
        DatasetGenerator.flow_from_h5 = tapped(real_h5, 1)
        try:
            yield self
        finally:
            Trainer.train_step, cli_eval.eval_batch = real_step, real_eval
            DatasetGenerator.flow_from_json = real_flow
            DatasetGenerator.flow_from_h5 = real_h5

    @staticmethod
    def epoch_windows(timed, spe: int) -> list:
        """ms from the first step's start event to the last step's end
        event of each epoch of ``spe`` steps: the steps and the host's
        gaps between them (batches, copies, log fetches), not the
        validation and checkpoint after the epoch."""
        torch.cuda.synchronize()
        return [timed[e][0][0].elapsed_time(timed[e + spe - 1][0][1])
                for e in range(0, len(timed), spe)]

    @staticmethod
    def ms(timed) -> tuple[list, str]:
        """-> (ms of each call, the mean ms by padded T as text)."""
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for (a, b), _ in timed]
        by_t = {}
        for m, (_, t) in zip(ms, timed):
            by_t.setdefault(t, []).append(m)
        return ms, ", ".join(f"T={t} {np.mean(v):.4f} (x{len(v)})"
                             for t, v in sorted(by_t.items()))


def threaded_batches(batches, depth: int = 2):
    """``batches`` built by a daemon thread up to ``depth`` ahead of the
    consumer, in order, a worker's error re-raised at the consumer: the
    training loop's alternative that the corpus phase times against the
    loop's plain iteration."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done, stop = object(), threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for b in batches:
                if not put(b):
                    return
        except BaseException as e:  # re-raised by the consumer
            put(e)
            return
        put(done)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while (item := q.get()) is not done:
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()


def native_read_check(paths: list) -> None:
    """The native phase's read part: ``read_wav`` (the native library's
    reader, its route) against ``read_wav_plain`` on the corpus's files,
    sample for sample (mono PCM16: exact), each timed on the host over all
    of them in turns (native, plain, then plain, native)."""
    from asr_study_torch.features.wav import read_wav, read_wav_plain

    secs = {read_wav: 0.0, read_wav_plain: 0.0}
    for fns in ((read_wav, read_wav_plain), (read_wav_plain, read_wav)):
        for p in paths:
            got = []
            for fn in fns:
                t0 = time.perf_counter()
                got.append(fn(p, sr=None))
                secs[fn] += time.perf_counter() - t0
            (a, sr_a), (b, sr_b) = got
            require(sr_a == sr_b and np.array_equal(a, b),
                    f"read_wav differs from read_wav_plain on {p}")
    nat, plain = (1e3 * secs[f] / (2 * len(paths))
                  for f in (read_wav, read_wav_plain))
    print(f"read_wav, native against plain on the corpus's {len(paths)} "
          f"files: sample for sample equal; host time on this machine's "
          f"CPU, in turns: native {nat:.4f} ms a file, plain {plain:.4f} "
          f"({plain / nat:.2f}x)")


def corpus_phase(card: str, tmp: str) -> tuple[list, str, str, list, object]:
    """BASELINE config 3 from a corpus, through the CLIs' ``main(argv)``:
    make_dataset (a SynthWords manifest), train (deep_blstm at its zoo
    defaults, CORPUS_EPOCHS epochs from the manifest), train --resume (one
    more epoch), eval on the valid and test splits; the launch counts of
    each held to what its steps and evals need; then fresh train runs in
    turns with the loop's batches straight from the iterator, as ``fit``
    takes them, and built ahead by a worker thread; all in ``tmp`` ->
    (each counted CLI run's launches, the manifest, the first run's
    directory, the first run's loss of each step of its first epoch, its
    train split's iterator)."""
    from asr_study_torch.data.generator import DatasetGenerator
    from asr_study_torch.cli import eval as cli_eval
    from asr_study_torch.cli import make_dataset
    from asr_study_torch.cli import train as cli_train

    runs = []
    manifest = os.path.join(tmp, "m.json")
    run_dir = os.path.join(tmp, "run")
    t0 = time.perf_counter()
    require(make_dataset.main([
        "--parser", "synthwords", "--dataset_dir",
        os.path.join(tmp, "corpus"), "--corpus_params",
        json.dumps({"n": CORPUS_N, "seed": SEED}),
        "--to_json", manifest]) == 0, "make_dataset failed")
    synth_s = time.perf_counter() - t0
    with open(manifest) as f:
        utts = [json.loads(line) for line in f]
    by_split = {s: [u for u in utts if u["split"] == s]
                for s in ("train", "valid", "test")}
    require({s: len(u) for s, u in by_split.items()}
            == {"train": CORPUS_N * 8 // 10, "valid": CORPUS_N // 10,
                "test": CORPUS_N // 10},
            f"manifest splits {[(s, len(u)) for s, u in by_split.items()]}")
    train_audio_s = sum(u["duration"] for u in by_split["train"])
    with part("native read check"):
        native_read_check([u["audio"] for u in utts])
    print(f"corpus: make_dataset --parser synthwords n={CORPUS_N}: "
          f"{len(utts)} utterances ({train_audio_s:.1f} s of train "
          f"audio, {min(u['duration'] for u in utts):.2f}-"
          f"{max(u['duration'] for u in utts):.2f} s each) synthesised "
          f"and written in {synth_s:.2f} s of host time")

    def train(argv, epochs):
        tap = CliTap()
        reset_counts()
        t0 = time.perf_counter()
        with tap.record():
            require(cli_train.main([
                "--dataset", manifest, "--model", "deep_blstm",
                "--batch_size", str(CORPUS_B), "--seed", str(SEED),
                "--log_every", "5", "--save", run_dir,
                "--epochs", str(epochs), *argv]) == 0, "train failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        its = dict(tap.flows)
        spe = its["train"].steps_per_epoch
        v_batches = its["valid"].steps_per_epoch
        want = {"bilstm_fwd": TRAIN_LAYERS * epochs * (spe + v_batches),
                "bilstm_bwd": TRAIN_LAYERS * epochs * spe,
                "ctc_alpha": epochs * (spe + v_batches),
                "ctc_beta": epochs * spe}
        require(launches == want,
                f"corpus train launches {launches}, want {want}")
        labels = max(l for it in its.values()
                     for _, l in it.padded_shapes())
        check_designs("corpus train", HIDDEN, CORPUS_B, 2 * labels + 1)
        step_ms, by_t = CliTap.ms(tap.steps)
        require(len(step_ms) == epochs * spe,
                f"{len(step_ms)} steps timed, want {epochs * spe}")
        shapes = sorted(its["train"].padded_shapes())
        print(f"corpus train {' '.join(argv) or '(fresh)'}: {epochs} "
              f"epochs x {spe} steps, B={CORPUS_B}, {len(shapes)} (T, L) "
              f"buckets {shapes}; launches {launches}; manifest features "
              f"(train + valid) {tap.features_s:.2f} s of host time; "
              f"{wall:.1f} s wall in all")
        # the run's first step carries one-time costs (cuBLAS
        # handles, first launches): shown apart
        steady = step_ms[1:]
        windows = CliTap.epoch_windows(tap.steps, spe)
        print(f"[{card}] corpus train step, CUDA events around each of "
              f"{len(step_ms)} steps: first {step_ms[0]:.4f} ms, the "
              f"rest {np.mean(steady):.4f} ms/step mean, median "
              f"{np.median(steady):.4f} ({min(steady):.4f}-"
              f"{max(steady):.4f}); by bucket {by_t}; step-time rate "
              f"{epochs * train_audio_s / (sum(step_ms) / 1e3):.1f} "
              f"audio-s/s over the {len(step_ms)} steps alone; epoch "
              f"windows (first step's start to last step's end) "
              f"{', '.join(f'{w:.4f}' for w in windows)} ms: "
              f"{epochs * train_audio_s / (sum(windows) / 1e3):.1f} "
              f"audio-s/s with the gaps between steps")
        runs.append(launches)
        return spe, its, [float(v) for v in tap.losses[:spe]]

    spe, its, first_epoch = train([], CORPUS_EPOCHS)
    with open(os.path.join(run_dir, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(run_dir, "train_metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    logged = [float(r["loss"]) for r in rows if r.get("loss")]
    epoch_loss = [h["train_loss"] for h in meta["history"]]
    print(f"corpus train: logged losses {[round(v, 3) for v in logged]}; "
          f"train_loss by epoch {[round(v, 4) for v in epoch_loss]}, "
          f"val_loss {[round(h['val_loss'], 4) for h in meta['history']]}"
          f", val_ler {[round(h['val_ler'], 4) for h in meta['history']]}")
    require(len(logged) > 0 and all(math.isfinite(v) for v in logged)
            and all(math.isfinite(v) for h in meta["history"]
                    for v in h.values()), "a non-finite corpus loss")
    require(len(epoch_loss) == CORPUS_EPOCHS
            and epoch_loss[-1] < epoch_loss[0],
            f"train_loss did not fall over the epochs: {epoch_loss}")
    require(meta["last_step"] == CORPUS_EPOCHS * spe,
            f"last step {meta['last_step']}")

    train(["--resume"], 1)
    with open(os.path.join(run_dir, "meta.json")) as f:
        meta = json.load(f)
    require(meta["last_step"] == (CORPUS_EPOCHS + 1) * spe
            and [h["step"] for h in meta["history"]]
            == [(e + 1) * spe for e in range(CORPUS_EPOCHS + 1)],
            f"--resume: history steps {[h['step'] for h in meta['history']]}")
    print(f"corpus train --resume: continued from step "
          f"{CORPUS_EPOCHS * spe} to {meta['last_step']}")

    for split in ("valid", "test"):
        tap = CliTap()
        out = io.StringIO()
        reset_counts()
        with tap.record(), contextlib.redirect_stdout(out):
            require(cli_eval.main(["--dataset", manifest, "--split",
                                   split, "--save", run_dir]) == 0,
                    "eval failed")
        torch.cuda.synchronize()
        launches = read_counts()
        res = json.loads(out.getvalue().strip().splitlines()[-1])
        n_b = dict(tap.flows)[split].steps_per_epoch
        want = {"bilstm_fwd": TRAIN_LAYERS * n_b, "ctc_alpha": n_b}
        require(launches == want,
                f"corpus eval {split} launches {launches}, want {want}")
        ms, by_t = CliTap.ms(tap.evals)
        print(f"corpus eval --split {split}: {res}; launches {launches}; "
              f"manifest features {tap.features_s:.2f} s of host time")
        print(f"[{card}] corpus eval, CUDA events around each of "
              f"{len(ms)} batches (B={CORPUS_B}): {np.mean(ms):.4f} "
              f"ms/batch mean; {by_t}")
        require(res["num_utts"] == CORPUS_N // 10 and all(
            math.isfinite(res[k]) for k in ("loss", "cer", "wer")),
            f"eval {split}: {res}")
        if split == "valid":
            val_loss = meta["history"][-1]["val_loss"]
            rel = abs(res["loss"] - val_loss) / abs(val_loss)
            print(f"corpus eval valid loss {res['loss']:.6f} vs the "
                  f"run's last val_loss {val_loss:.6f}: rel {rel:.3e} "
                  f"(tol {CORPUS_LOSS_RTOL:g})")
            require(rel <= CORPUS_LOSS_RTOL,
                    "eval's valid loss differs from the last val_loss")
        runs.append(launches)

    # the loop's batches from the iterator (fit) or from a worker
    # thread, in turns, on the first run's splits (no features again);
    # the same batches in the same order, so the same losses
    real_flow, train_it = DatasetGenerator.flow_from_json, its["train"]
    ab = {"plain": [], "thread": []}
    histories = []
    for i, variant in enumerate(("plain", "thread", "thread", "plain")):
        if variant == "thread":
            plain_epoch = train_it.epoch
            train_it.epoch = lambda *a, **k: threaded_batches(
                plain_epoch(*a, **k))
        DatasetGenerator.flow_from_json = (
            lambda gen, *a, split=None, **k: its[split])
        tap = CliTap()
        try:
            with tap.record(), contextlib.redirect_stdout(io.StringIO()):
                require(cli_train.main([
                    "--dataset", manifest, "--model", "deep_blstm",
                    "--batch_size", str(CORPUS_B), "--seed", str(SEED),
                    "--log_every", "5", "--epochs", str(CORPUS_EPOCHS),
                    "--save", os.path.join(tmp, f"ab{i}")]) == 0,
                    "train failed")
        finally:
            DatasetGenerator.flow_from_json = real_flow
            train_it.__dict__.pop("epoch", None)
        windows = CliTap.epoch_windows(tap.steps, spe)
        step_ms, _ = CliTap.ms(tap.steps)
        ab[variant].append((sum(windows), sum(step_ms)))
        with open(os.path.join(tmp, f"ab{i}", "meta.json")) as f:
            histories.append([h["train_loss"]
                              for h in json.load(f)["history"]])
        print(f"[{card}] corpus train, batches from "
              f"{'the iterator' if variant == 'plain' else 'a thread'} "
              f"(run {i}): epoch windows {sum(windows):.4f} ms, steps "
              f"{sum(step_ms):.4f} ms, "
              f"{CORPUS_EPOCHS * train_audio_s / (sum(windows) / 1e3):.1f}"
              f" audio-s/s over the windows")
    require(all(h == histories[0] for h in histories),
            f"the train losses differ between the loops: {histories}")
    means = {v: np.mean(r, axis=0) for v, r in ab.items()}
    print(f"[{card}] corpus train loop A/B, {CORPUS_EPOCHS} epochs a run"
          f", 2 runs each in turns, mean epoch windows (steps): "
          + "; ".join(f"{v} {m[0]:.4f} ms ({m[1]:.4f} ms), "
                      f"{CORPUS_EPOCHS * train_audio_s / (m[0] / 1e3):.1f}"
                      f" audio-s/s" for v, m in means.items())
          + f"; thread/plain {means['thread'][0] / means['plain'][0]:.4f}"
          f"; train losses equal")
    return runs, manifest, run_dir, first_epoch, train_it


def h5_phase(card: str, tmp: str, manifest: str,
             corpus_losses: list) -> list:
    """The HDF5 path through the CLIs, on the corpus phase's SynthWords
    corpus in ``tmp``: (a) make_dataset --output, host MFCC in both
    layouts (the packed rows held equal to the vlen file's, in duration
    order) and raw; (b) make_dataset --device over the pcm16 and the dpack
    wire at H5_LOG_FLOOR, the two files bit-equal and the test split
    within FBANK_TOL of host MFCC at that floor; flow_from_h5's read rate;
    (c) train deep_blstm one epoch from the MFCC file, each step's loss
    within H5_LOSS_RTOL of the corpus phase's first epoch from the
    manifest (the same weights, seed, batches and features); (d) train
    --device_features mfcc --spec_augment --wav_augment gain_db=3 one epoch
    from the raw file, the fbank kernel in every step and eval batch;
    (e) eval and predict --on_device of run (d).  Every run's launches are
    held to what it needs -> those launch counts."""
    from asr_study_torch.cli import eval as cli_eval
    from asr_study_torch.cli import make_dataset
    from asr_study_torch.cli import predict as cli_predict
    from asr_study_torch.cli import train as cli_train
    from asr_study_torch.data.dataset_parser import read_h5
    from asr_study_torch.data.generator import DatasetGenerator
    from asr_study_torch.features.audio import MFCC

    runs = []
    splits = ("train", "valid", "test")
    with open(manifest) as f:
        utts = [json.loads(line) for line in f]
    n_utts, audio_s = len(utts), sum(u["duration"] for u in utts)
    batches = sum(-(-sum(u["split"] == s for u in utts) // 32)
                  for s in splits)
    files = {}

    def build(name: str, *extra) -> tuple[float, dict]:
        files[name] = os.path.join(tmp, f"{name}.h5")
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            require(make_dataset.main([
                "--parser", "synthwords", "--dataset_dir",
                os.path.join(tmp, "corpus"), "--corpus_params",
                json.dumps({"n": CORPUS_N, "seed": SEED}), "--output",
                files[name], *extra]) == 0, f"make_dataset {name} failed")
        torch.cuda.synchronize()
        return time.perf_counter() - t0, read_counts()

    def rate(what: str, secs: float) -> str:
        return (f"{what} {secs:.2f} s, {n_utts / secs:.1f} utterances/s, "
                f"{audio_s / secs:.1f} audio-s/s")

    # (a) host features, both layouts, and raw
    t_host, launches = build("feats")
    require(not launches, f"host make_dataset launched {launches}")
    build("packed", "--layout", "packed")
    t_raw, _ = build("raw", "--input_parser", "raw")
    host = {s: read_h5(files["feats"], s) for s in splits}
    for s in splits:
        packed = read_h5(files["packed"], s)
        order = np.argsort(host[s][3], kind="stable")
        require(packed[2] == [host[s][2][i] for i in order] and all(
            np.array_equal(packed[0][k], host[s][0][i])
            for k, i in enumerate(order)),
            f"packed rows of {s} differ from the vlen file's")
    raw_test = read_h5(files["raw"], "test")[0]
    require(all(r.shape[1] == 1 for r in raw_test)
            and len(raw_test) == len(host["test"][0]), "raw.h5 rows")
    print(f"h5 phase (a): make_dataset --output, host MFCC: "
          f"{rate('vlen', t_host)}; packed rows equal to the vlen file's in "
          f"duration order; raw {t_raw:.2f} s")

    # (b) device extraction over both wires
    floor = json.dumps({"log_floor": H5_LOG_FLOOR})
    dev, t_dev = {}, {}
    for codec in ("pcm16", "dpack"):
        t_dev[codec], launches = build(
            f"dev_{codec}", "--device", "--device_wire_codec", codec,
            "--input_params", floor)
        want = {"fbank": batches}
        if codec == "dpack":
            want["dpack_decode"] = batches
        require(launches == want, f"make_dataset --device {codec} launches "
                f"{launches}, want {want}")
        runs.append(launches)
        dev[codec] = {s: read_h5(files[f"dev_{codec}"], s)[0]
                      for s in splits}
    require(all(np.array_equal(a, b) for s in splits
                for a, b in zip(dev["pcm16"][s], dev["dpack"][s])),
            "the pcm16 and dpack files' features differ")
    mfcc = MFCC(log_floor=H5_LOG_FLOOR)
    test_wavs = [u["audio"] for u in utts if u["split"] == "test"]
    err = max(float(np.abs(mfcc(w) - r).max())
              for w, r in zip(test_wavs, dev["pcm16"]["test"]))
    print(f"[{card}] h5 phase (b): make_dataset --device, {batches} batches "
          f"of <= 32, one fbank launch each (+ one dpack_decode with "
          f"dpack): {rate('host MFCC', t_host)}; "
          f"{rate('pcm16', t_dev['pcm16'])}; "
          f"{rate('dpack', t_dev['dpack'])} (the native encoder; whole "
          f"CLI runs: wav reads, "
          f"extraction, HDF5 writes); pcm16 and dpack files bit-equal; "
          f"test split against host MFCC at log_floor {H5_LOG_FLOOR:g}: "
          f"max abs err {err:.3e} (tol {FBANK_TOL:g})")
    require(err <= FBANK_TOL, f"device features {err:.3e} from host MFCC")

    # the read rate of flow_from_h5, eager and lazy, both layouts
    mb = sum(x.nbytes for x in host["train"][0]) / 2**20
    reads = []
    for name in ("feats", "packed"):
        for lazy in (False, True):
            t0 = time.perf_counter()
            it = DatasetGenerator(batch_size=CORPUS_B).flow_from_h5(
                files[name], "train", lazy=lazy)
            n_b = sum(1 for _ in it.epoch(seed=SEED))
            dt = time.perf_counter() - t0
            reads.append(f"{'packed' if name == 'packed' else 'vlen'} "
                         f"{'lazy' if lazy else 'eager'} {mb / dt:.1f} MB/s "
                         f"({n_b / dt:.1f} batches/s)")
    print(f"h5 phase: flow_from_h5 of the train split ({mb:.1f} MB of "
          f"features) and one epoch of batches, host time: "
          + "; ".join(reads))

    # (c) train from the MFCC file, against the manifest's first epoch
    tap = CliTap()
    reset_counts()
    with tap.record(), contextlib.redirect_stdout(io.StringIO()):
        require(cli_train.main([
            "--dataset", files["feats"], "--model", "deep_blstm",
            "--batch_size", str(CORPUS_B), "--seed", str(SEED),
            "--log_every", "5", "--epochs", "1", "--save",
            os.path.join(tmp, "h5run")]) == 0, "train on the .h5 failed")
    torch.cuda.synchronize()
    launches = read_counts()
    runs.append(launches)
    its = dict(tap.flows)
    spe, v_b = its["train"].steps_per_epoch, its["valid"].steps_per_epoch
    want = {"bilstm_fwd": TRAIN_LAYERS * (spe + v_b),
            "bilstm_bwd": TRAIN_LAYERS * spe, "ctc_alpha": spe + v_b,
            "ctc_beta": spe}
    require(launches == want, f"h5 train launches {launches}, want {want}")
    losses = [float(v) for v in tap.losses]
    require(len(losses) == len(corpus_losses) == spe,
            f"{len(losses)} steps from the .h5, {len(corpus_losses)} from "
            "the manifest")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, corpus_losses))
    step_ms, by_t = CliTap.ms(tap.steps)
    print(f"[{card}] h5 phase (c): train deep_blstm 3x{HIDDEN} one epoch "
          f"from feats.h5, {spe} steps: {np.mean(step_ms[1:]):.4f} ms/step "
          f"mean after the first ({by_t}); each step's loss against the "
          f"manifest run's first epoch: max rel {rel:.3e} (tol "
          f"{H5_LOSS_RTOL:g}); launches {launches}")
    require(rel <= H5_LOSS_RTOL, "the .h5 run's losses differ from the "
            "manifest run's")

    # (d) raw waveforms, featurized in each step, with both augmentations
    raw_run = os.path.join(tmp, "rawrun")
    tap = CliTap()
    reset_counts()
    with tap.record(), contextlib.redirect_stdout(io.StringIO()):
        require(cli_train.main([
            "--dataset", files["raw"], "--model", "deep_blstm",
            "--batch_size", str(CORPUS_B), "--seed", str(SEED),
            "--log_every", "5", "--epochs", "1", "--save", raw_run,
            "--device_features", "mfcc", "--spec_augment", "--wav_augment",
            "gain_db=3"]) == 0, "train --device_features failed")
    torch.cuda.synchronize()
    launches = read_counts()
    runs.append(launches)
    its = dict(tap.flows)
    spe, v_b = its["train"].steps_per_epoch, its["valid"].steps_per_epoch
    want = {"fbank": spe + v_b, "bilstm_fwd": TRAIN_LAYERS * (spe + v_b),
            "bilstm_bwd": TRAIN_LAYERS * spe, "ctc_alpha": spe + v_b,
            "ctc_beta": spe}
    require(launches == want, f"--device_features train launches "
            f"{launches}, want {want}")
    losses = [float(v) for v in tap.losses]
    require(all(math.isfinite(v) for v in losses), f"losses {losses}")
    step_ms, by_t = CliTap.ms(tap.steps)
    print(f"[{card}] h5 phase (d): train --device_features mfcc "
          f"--spec_augment --wav_augment gain_db=3 one epoch from raw.h5, "
          f"{spe} steps: {np.mean(step_ms[1:]):.4f} ms/step mean after the "
          f"first (padded samples: {by_t}); fbank launches a step and eval "
          f"batch {launches['fbank'] / (spe + v_b):g}; losses "
          f"{[round(v, 3) for v in losses[::5]]} (every 5th)")

    # (e) eval and predict of run (d)
    out = io.StringIO()
    tap = CliTap()
    reset_counts()
    with tap.record(), contextlib.redirect_stdout(out):
        require(cli_eval.main(["--dataset", files["raw"], "--split", "test",
                               "--save", raw_run]) == 0, "eval failed")
    launches = read_counts()
    runs.append(launches)
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    n_b = dict(tap.flows)["test"].steps_per_epoch
    require(launches == {"fbank": n_b, "bilstm_fwd": TRAIN_LAYERS * n_b,
                         "ctc_alpha": n_b}, f"eval launches {launches}")
    require(res["num_utts"] == CORPUS_N // 10 and all(
        math.isfinite(res[k]) for k in ("loss", "cer", "wer")),
        f"eval of the raw run: {res}")
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        require(cli_predict.main(["--save", raw_run, "--on_device",
                                  "--batch_size", "8",
                                  *test_wavs[:8]]) == 0, "predict failed")
    launches = read_counts()
    runs.append(launches)
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    require(len(lines) == 8 and launches == {
        "fbank": 1, "bilstm_fwd": TRAIN_LAYERS},
        f"predict: {len(lines)} lines, launches {launches}")
    print(f"h5 phase (e): eval --split test of run (d): {res}; predict "
          f"--save --on_device of 8 test wavs with the run's recorded "
          f"features: {len(lines)} transcripts, launches {launches}")
    return runs


def beam_emissions(dev: torch.device, batch: int = BEAM_B,
                   t_max: int = BEAM_T, vocab: int = BEAM_V
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The beam phase's logits [batch, t_max, vocab] and lengths: a
    quarter of the rows ragged (BEAM_FULL of BEAM_B rows at T)."""
    rng = np.random.RandomState(SEED)
    x = rng.randn(batch, t_max, vocab).astype(np.float32)
    blank = rng.rand(batch, t_max) < 0.65
    x[:, :, -1] += np.where(blank, 10.0, -10.0).astype(np.float32)
    lens = np.full(batch, t_max, np.int32)
    full = batch * BEAM_FULL // BEAM_B
    lens[full:] = rng.randint(1, t_max, batch - full)
    return torch.from_numpy(x).to(dev), torch.from_numpy(lens).to(dev)


def beam_bound(lp: torch.Tensor, lens: torch.Tensor, width: int, n_ext: int,
               outs: tuple, lm=None) -> tuple[float, str]:
    """Bound of one beam decode.  Operations, for each frame within a
    row's length: the stays' three logadds (5 each) and 3 adds, each
    extension's add and select (2 more with the LM), the merge as one
    lookup for each stay (its only possible partner is the extension of
    its parent by its last char), and a selection that looks at each of
    the W + W*E candidates once.  Bytes: the log-probs, lengths and LM
    table read, the outputs written."""
    frames = float(lens.clamp(0, lp.shape[1]).sum())
    cand = width * n_ext
    per = (18 * width + (4 if lm is not None else 2) * cand + width
           + width + cand)
    moved = tensor_bytes(lp, lens, *outs)
    if lm is not None:
        moved += 4.0 * lm.logp.size
    return bound(frames * per, moved)


def check_beam_kernel(dev: torch.device, card: str, lm) -> dict:
    """ctc_beam against its plain twin on the card (all W beams of every
    row: prefixes, lengths, scores) at W = 4, 16, 64, W = 64 pruned to 8,
    W = 16 after blank_collapse(0.99) and W = 16 with ``lm`` fused; each
    case timed beside its bound, the plain twin once at W = 16."""
    from asr_study_torch.ops import beam
    from asr_study_torch.ops.ctc import blank_collapse

    logits, lens = beam_emissions(dev)
    lp = torch.log_softmax(logits, -1)
    c_logits, c_lens, dropped = blank_collapse(logits, lens, threshold=0.99)
    c_lp = torch.log_softmax(c_logits, -1)
    print(f"beam emissions: B={BEAM_B} T={BEAM_T} V={BEAM_V}, lengths "
          f"{sorted(lens.tolist())[:BEAM_B - BEAM_FULL]} and {BEAM_FULL} x "
          f"{BEAM_T}; blank_collapse(0.99, keep_ratio 0.6): T2="
          f"{c_logits.shape[1]}, lengths {int(c_lens.min())}.."
          f"{int(c_lens.max())}, {int((dropped > 0).sum())} rows over the "
          f"budget ({int(dropped.sum())} frames dropped)")
    cases = {f"W={w}": (lp, lens, w, {}) for w in BEAM_WIDTHS}
    cases["W=64 prune 8"] = (lp, lens, 64, {"prune": 8})
    cases["W=16 after blank_collapse 0.99"] = (c_lp, c_lens, 16, {})
    cases[f"W=16 LM order {lm.order}"] = (lp, lens, 16, {"lm": lm,
                                                          **BEAM_LM})
    err, timed = 0.0, {}
    for label, (x, n, w, kw) in cases.items():
        got = beam.ctc_beam(x, n, w, top_paths=w, **kw)
        want = beam.beam_search_plain(x, n, w, **kw)
        require(torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1]),
                f"ctc_beam {label}: prefixes or lengths differ from plain")
        diff = float((got[2] - want[2]).abs().max())
        require(torch.equal(got[2], want[2]),
                f"ctc_beam {label}: scores differ from plain by up to "
                f"{diff:.3e} (tol 0: bit-equal)")
        err = max(err, diff)
        n_ext = min(kw.get("prune") or BEAM_V - 1, BEAM_V - 1)
        ms = cuda_ms(lambda: beam.ctc_beam(x, n, w, **kw), 5)
        out = beam.ctc_beam(x, n, w, **kw)
        b_ms, b_by = beam_bound(x, n, w, n_ext, out, kw.get("lm"))
        audio = float(n.sum()) * FRAME_S
        timed[label] = (ms, b_ms, b_by)
        print(f"ctc_beam kernel vs plain, {label} (T={x.shape[1]}, E="
              f"{n_ext}; a frame: {w + w * n_ext} candidates for the top "
              f"{w}, {w * w} merge pair checks): all {w} beams of "
              f"{BEAM_B} rows, prefixes, lengths and scores equal bit for "
              f"bit (tol 0)")
        print(f"[{card}] ctc_beam {label}: {ms:.4f} ms/batch, "
              f"{1e3 * ms / x.shape[1]:.3f} us a frame of T, "
              f"{audio / (ms / 1e3):.1f} audio-s/s ({audio:.2f} s of audio "
              f"at 10 ms a frame); bound {b_ms:.6f} ms ({b_by})")
    plain_ms = cuda_ms(lambda: beam.beam_search_plain(lp, lens, BEAM_SERVE_W),
                       1, warmup=1)
    ms16, b16, by16 = timed[f"W={BEAM_SERVE_W}"]
    print(f"[{card}] ctc_beam W={BEAM_SERVE_W}: kernel {ms16:.4f} ms/batch, "
          f"plain twin {plain_ms:.4f} ms/batch; library: none (no PyTorch "
          f"call does prefix beam search, and torchaudio is absent)")
    return {"errs": {"ctc_beam": err},
            "times": {"ctc_beam": (ms16, plain_ms)},
            "bounds": {"ctc_beam": (b16, by16)},
            "library": {"ctc_beam": None}}


def wide_beam_case(dev: torch.device, card: str, lm, label: str, w: int,
                   vocab: int, b: int, t: int, with_lm: bool) -> tuple:
    """One case of ``check_beam_wide`` -> (ms a batch, the twin's ms,
    bound ms, bound by)."""
    from asr_study_torch.ops import beam

    logits, n = beam_emissions(dev, b, t, vocab)
    x = torch.log_softmax(logits, -1)
    kw = dict(lm=lm, **BEAM_LM) if with_lm else {}
    require(beam.beam_design(w, vocab) == "wide",
            f"{label}: beam_design {beam.beam_design(w, vocab)}")
    before = dict(beam.ctc_beam.by_design)
    got = beam.ctc_beam(x, n, w, top_paths=w, **kw)
    require(beam.ctc_beam.by_design == {
        "select": before["select"], "wide": before["wide"] + 1},
        f"{label}: ran {beam.ctc_beam.by_design} from {before}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = beam.beam_search_plain(x, n, w, **kw)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    require(all(torch.equal(g_, w_) for g_, w_ in zip(got, want)),
            f"ctc_beam wide {label}: differs from plain (scores by up "
            f"to {float((got[2] - want[2]).abs().max()):.3e}; tol 0)")
    if label == f"W={BEAM_WIDE_W}":
        again = beam.ctc_beam(x, n, w, top_paths=w, **kw)
        require(all(torch.equal(g_, a_) for g_, a_ in zip(got, again)),
                f"ctc_beam wide {label}: two runs differ")
    ms = cuda_ms(lambda: beam.ctc_beam(x, n, w, **kw), 3, warmup=1)
    out = beam.ctc_beam(x, n, w, **kw)
    b_ms, b_by = beam_bound(x, n, w, vocab - 1, out, kw.get("lm"))
    print(f"ctc_beam wide design vs plain, {label} (B={b}, T={t}, "
          f"V={vocab}{', LM order %d' % lm.order if with_lm else ''}; "
          f"a frame: {w + w * (vocab - 1)} candidates for the top {w}): "
          f"all {w} beams of {b} rows, prefixes, lengths and scores "
          f"equal bit for bit (tol 0)"
          + ("; two runs bit-equal" if label == f"W={BEAM_WIDE_W}"
             else ""))
    print(f"[{card}] ctc_beam wide {label}: {ms:.4f} ms/batch, "
          f"{1e3 * ms / t:.3f} us a frame of T; bound {b_ms:.6f} ms "
          f"({b_by}); plain twin {plain_ms:.4f} ms/batch (host clock "
          f"to a synchronize, once); library: none")
    return ms, plain_ms, b_ms, b_by


def check_beam_wide(dev: torch.device, card: str, lm) -> dict:
    """The wide design (csrc/ctc_beam_wide.cu) against its plain twin on
    the card, BEAM_WIDE_CASES: every beam of every row, prefixes, lengths
    and scores bit for bit, launches by design; each case's ms a batch, us
    a frame and bound; W=256 run twice bit-equal.  Its stream form runs in
    the streaming phase (BEAM_STREAM_CASES)."""
    timed = {}
    for label, case in BEAM_WIDE_CASES.items():
        with part(f"wide beam {label}"):
            timed[label] = wide_beam_case(dev, card, lm, label, *case)
    ms, plain_ms, b_ms, b_by = timed[f"W={BEAM_WIDE_W}"]
    return {"errs": {"ctc_beam_wide": 0.0},      # bit-equal, required
            "times": {"ctc_beam_wide": (ms, plain_ms)},
            "bounds": {"ctc_beam_wide": (b_ms, b_by)},
            "library": {"ctc_beam_wide": None}}


def beam_serving_slice(card: str, model, feat, w: "Wire",
                       audio_s: float) -> dict:
    """deep_blstm 2x256 served over the pcm16 wire with beam width
    BEAM_SERVE_W through ``serve_batch``: launches counted from 0, every
    batch's transcripts against the plain twin on the same logits, ms a
    batch beside the greedy slice's -> the launches."""
    from asr_study_torch.cli.predict import serve_batch
    from asr_study_torch.ops.beam import BeamConfig, beam_search_plain

    cfg = BeamConfig(BEAM_SERVE_W)

    def run(beam=None):
        return [serve_batch(model, feat, w.dev[o: o + w.cap], BATCH, w.n_pad,
                            "pcm16", w.scap, beam) for o in w.offsets]

    reset_counts()
    served = run(cfg)
    torch.cuda.synchronize()
    launches = read_counts()
    want = {"fbank": N_BATCHES, "bilstm_fwd": N_BATCHES * LAYERS,
            "ctc_beam": N_BATCHES}
    require(launches == want, f"beam slice launches {launches}, want {want}")
    for s in served:
        plain = beam_search_plain(torch.log_softmax(s.logits.float(), -1),
                                  s.feat_lengths, BEAM_SERVE_W)
        require(torch.equal(s.decoded, plain[0][:, 0])
                and torch.equal(s.lengths, plain[1][:, 0]),
                "beam slice transcripts differ from the plain twin's")
    greedy_ms = cuda_ms(run, 3, warmup=1) / N_BATCHES
    beam_ms = cuda_ms(lambda: run(cfg), 3, warmup=1) / N_BATCHES
    print(f"deep_blstm beam{BEAM_SERVE_W} slice: {N_BATCHES} batches x "
          f"{BATCH}, T={served[0].logits.shape[1]}; launches {launches}; "
          f"transcripts equal to the plain twin's on the same logits "
          f"{N_BATCHES * BATCH}/{N_BATCHES * BATCH}")
    print(f"[{card}] deep_blstm slice, beam{BEAM_SERVE_W} decode: "
          f"{beam_ms:.4f} ms/batch, {audio_s / (beam_ms * N_BATCHES / 1e3):.1f}"
          f" audio-s/s; greedy decode {greedy_ms:.4f} ms/batch, "
          f"{audio_s / (greedy_ms * N_BATCHES / 1e3):.1f} audio-s/s (pcm16 "
          f"wire, {LAYERS}x{HIDDEN} BLSTM, B={BATCH}, timed one after the "
          f"other)")
    return launches


def beam_cli_phase(dev: torch.device, card: str, manifest: str,
                   run_dir: str, tmp: str) -> tuple[dict, list]:
    """The beam phase on the corpus phase's manifest and run: ctc_beam
    against its plain twin (``check_beam_kernel``) with an order-3 LM fit
    by ``fit_ngram_lm`` on the train transcripts; then ``cli.train_lm``
    on train and valid, ``cli.eval --beam_width 16`` with that LM and with
    ``--blank_collapse 0.99`` on the test split, each with one ctc_beam
    launch a batch -> (the kernel's measurements, each eval's launches)."""
    from asr_study_torch.cli import eval as cli_eval
    from asr_study_torch.cli import train_lm
    from asr_study_torch.text.lm import fit_ngram_lm
    from asr_study_torch.text.parser import CharParser

    parser = CharParser()
    with open(manifest) as f:
        texts = [u["label"] for u in map(json.loads, f)
                 if u["split"] == "train"]
    lm = fit_ngram_lm([parser(t) for t in texts if parser.is_valid(t)], 3,
                      parser.num_classes, parser.char_to_id[" "],
                      vocab=parser.vocab)
    found = check_beam_kernel(dev, card, lm)
    for key, val in check_beam_wide(dev, card, lm).items():
        found[key].update(val)

    lm_path = os.path.join(tmp, "lm3.npz")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        require(train_lm.main(["--dataset", manifest, "--splits", "train",
                               "valid", "--order", "3", "--output",
                               lm_path]) == 0, "train_lm failed")
    print(f"corpus train_lm --splits train valid --order 3: "
          f"{out.getvalue().strip().splitlines()[-1]} "
          f"({time.perf_counter() - t0:.2f} s of host time)")
    runs = []
    for width, extra, decoder in (
            (BEAM_SERVE_W, ["--lm", lm_path], f"beam{BEAM_SERVE_W}+lm"),
            (BEAM_SERVE_W, ["--blank_collapse", "0.99"],
             f"beam{BEAM_SERVE_W}"),
            (BEAM_WIDE_W, [], f"beam{BEAM_WIDE_W}")):
        t_run = time.perf_counter()
        tap = CliTap()
        out = io.StringIO()
        reset_counts()
        with tap.record(), contextlib.redirect_stdout(out):
            require(cli_eval.main([
                "--dataset", manifest, "--split", "test", "--save", run_dir,
                "--beam_width", str(width), *extra]) == 0,
                "beam eval failed")
        torch.cuda.synchronize()
        launches = read_counts()
        res = json.loads(out.getvalue().strip().splitlines()[-1])
        n_b = dict(tap.flows)["test"].steps_per_epoch
        want = {"bilstm_fwd": TRAIN_LAYERS * n_b, "ctc_alpha": n_b,
                "ctc_beam_wide" if width == BEAM_WIDE_W else "ctc_beam": n_b}
        require(launches == want,
                f"beam eval launches {launches}, want {want}")
        require(res["decoder"] == decoder and res["num_utts"] == CORPUS_N
                // 10 and all(math.isfinite(res[k])
                               for k in ("loss", "cer", "wer")),
                f"beam eval {extra}: {res}")
        require(("lm" in res) == ("--lm" in extra)
                and ("blank_collapse_overflow_utts" in res)
                == ("--blank_collapse" in extra),
                f"beam eval {extra}: record keys {sorted(res)}")
        ms, by_t = CliTap.ms(tap.evals)
        print(f"corpus eval --split test --beam_width {width} "
              f"{' '.join(extra)}: {res}; launches {launches}")
        print(f"[{card}] corpus eval beam{width} "
              f"{' '.join(extra[:1])}, CUDA events around each of {len(ms)} "
              f"batches (B={CORPUS_B}): {np.mean(ms):.4f} ms/batch mean; "
              f"{by_t}")
        runs.append(launches)
        if width == BEAM_WIDE_W:
            add_part(f"eval --beam_width {width}", t_run)
    return found, runs



# the streaming phase (predict --stream, ROADMAP A10): the carry check's
# sequence and chunk (T=512 in chunks of 128; each batch's first row ends
# 12 frames into the last chunk, its last row is masked throughout); the
# recognizers' chunk (bench_stream.py's chunk_frames) and pushes (its
# chunk_seconds) on its 60 s utterance; 32 concurrent streams of 3-8 s
STREAM_T, STREAM_CHUNK = 512, 128
STREAM_PUSH_S, STREAM_AUDIO_S = 1.0, 60.0
MULTI_STREAMS = 32
# each forward route with a carry: family, H, B (the stream design by a
# batch past the wide design's budget, as check_stream_h512 reaches it)
CARRY_ROUTES = (("lstm", HIDDEN, BATCH), ("lstm", 512, BATCH),
                ("lstm", 512, 97), ("gru", HIDDEN, BATCH),
                ("gru", 512, BATCH), ("gru", 512, 97),
                ("ln_lstm", HIDDEN, BATCH), ("ln_lstm", 512, BATCH),
                ("mi_lstm", HIDDEN, BATCH), ("mi_lstm", 512, BATCH),
                ("zoneout_lstm", HIDDEN, BATCH),
                ("zoneout_lstm", 512, BATCH))
# the beam's stream form: (chunk, W, with the LM)
BEAM_STREAM_CASES = ((7, 16, False), (64, 16, False), (BEAM_T, 16, False),
                     (64, 4, False), (64, 64, False), (64, 16, True),
                     (64, BEAM_WIDE_W, False))
# the recognizers' models at full width: label -> (zoo model, hparams,
# kernel line row of its forward)
STREAM_MODELS = {
    "deep_gru 2x256 uni": ("deep_gru", f"num_hiddens={HIDDEN},num_layers=2,"
                           "bidirectional=false", "gru_fwd"),
    "deep_blstm 3x256 uni": ("deep_blstm", "bidirectional=false",
                             "lstm_fwd"),
    "deep_speech uni": ("deep_speech", "bidirectional=false",
                        "lstm_fwd_wide"),
}
# the layer-norm, MI and zoneout recognizers (3x256 uni, zoneout in eval
# mode) on a CELL_STREAM_S clip; the CPU check of the layer-norm one's
# logits covers its first LN_CHECK_T frames (a chaotic recurrence)
CELL_STREAM_S = 8.0
CELL_STREAM_MODELS = {
    "ln_blstm 3x256 uni": ("ln_blstm", "bidirectional=false", "ln_lstm_fwd"),
    "mi_blstm 3x256 uni": ("mi_blstm", "bidirectional=false", "mi_lstm_fwd"),
    "zoneout_blstm 3x256 uni": ("zoneout_blstm", "bidirectional=false",
                                "zoneout_lstm_fwd"),
}


def cell_carry_args(family: str, wh: torch.Tensor, b: int,
                    g: torch.Generator, dev: torch.device) -> list:
    """The op's arguments after the mask for a carry route: wh, and for
    the layer-norm LSTM its gains and bias (gh, gc, bc about 1, 1, 0), for
    the MI LSTM alpha, beta1, beta2 about 1 and b about 0, for the zoneout
    LSTM the eval-mode mix weights zh = 0.9, zc = 0.85 over STREAM_T
    frames before wh (constant, so any chunk's frames are a prefix)."""
    h = wh.shape[0]

    def near(n, centre):
        return (centre + 0.1 * torch.randn(n, generator=g)).to(dev)

    if family == "ln_lstm":
        return [wh, near(4 * h, 1.0), near(h, 1.0), near(h, 0.0)]
    if family == "mi_lstm":
        return [wh, *(near(4 * h, 1.0) for _ in range(3)),
                near(4 * h, 0.0)]
    if family == "zoneout_lstm":
        return [torch.full((STREAM_T, b, h), 0.9, device=dev),
                torch.full((STREAM_T, b, h), 0.85, device=dev), wh]
    return [wh]


def ln_carry_steps(xp, mask, rest, out, init) -> tuple:
    """The layer-norm LSTM's plain step from the kernel's own previous
    state, the carry at frame 0, at every frame at once -> (h, c)."""
    from asr_study_torch.models.cells import ln_lstm_step

    h_k, c_k = out
    t, b, h = h_k.shape
    h_prev = torch.cat([init[0][None], h_k[:-1]]).reshape(t * b, h)
    c_prev = torch.cat([init[1][None], c_k[:-1]]).reshape(t * b, h)
    h_s, c_s = ln_lstm_step(h_prev, c_prev, xp.reshape(t * b, 4 * h),
                            mask.reshape(t * b, 1), *rest)
    return h_s.view_as(h_k), c_s.view_as(c_k)


def check_stream_carries(dev: torch.device, card: str) -> None:
    """(a) Each of the twelve forward routes of CARRY_ROUTES (the LSTM's
    and the GRU's six, the layer-norm, MI and zoneout LSTMs' cluster and
    stream routes) started from a random non-zero carry: in chunks of
    STREAM_CHUNK threading h[-1] (and c[-1]) bit-equal to one launch over
    STREAM_T frames; within the forward tolerance of the plain twin
    started from the same carry (the layer-norm LSTM's chaotic
    recurrence: of its plain step from the kernel's own state, the whole
    trajectories' distance printed); no carry bit-equal to an explicit
    zero carry; ms a chunk at B=1 and at the route's batch."""
    from asr_study_torch.ops.bilstm import lstm, lstm_geometry, lstm_plain
    from asr_study_torch.ops.gru import gru, gru_geometry, gru_plain
    from asr_study_torch.ops.ln_lstm import (ln_geometry, ln_lstm,
                                             ln_lstm_plain)
    from asr_study_torch.ops.mi_lstm import (mi_geometry, mi_lstm,
                                             mi_lstm_plain)
    from asr_study_torch.ops.zoneout_lstm import (zoneout_geometry,
                                                  zoneout_lstm,
                                                  zoneout_lstm_plain)

    ops = {"lstm": (lstm, lstm_plain, lstm_geometry),
           "gru": (gru, gru_plain, gru_geometry),
           "ln_lstm": (ln_lstm, ln_lstm_plain, ln_geometry),
           "mi_lstm": (mi_lstm, mi_lstm_plain, mi_geometry),
           "zoneout_lstm": (zoneout_lstm, zoneout_lstm_plain,
                            zoneout_geometry)}
    g = torch.Generator().manual_seed(SEED + 40)
    for family, h, b in CARRY_ROUTES:
        fn, plain, geometry = ops[family]
        gates, tol = ((3, (GRU_ATOL, GRU_RTOL)) if family == "gru" else
                      (4, (BILSTM_ATOL, BILSTM_RTOL)))
        design = geometry(h, b, 1).design
        xp = torch.randn(STREAM_T, b, gates * h, generator=g).to(dev)
        wh = (torch.randn(h, gates * h, generator=g) / h ** 0.5).to(dev)
        lengths = torch.randint(1, STREAM_T + 1, (b,), generator=g)
        lengths[0], lengths[-1] = STREAM_T - 12, 0
        mask = mask_of(lengths, STREAM_T, dev)
        init = [(0.5 * torch.randn(b, h, generator=g)).to(dev)
                for _ in range(1 if family == "gru" else 2)]
        rest = cell_carry_args(family, wh, b, g, dev)

        def run(x, m, *carry):
            args = [a[: x.shape[0], : x.shape[1]].contiguous()
                    if a.dim() == 3 else a for a in rest]
            out = fn(x, m, *args, *carry)
            return out if isinstance(out, tuple) else (out,)

        with torch.inference_mode():
            whole = run(xp, mask, *init)
            chunks, carry = [], init
            for lo in range(0, STREAM_T, STREAM_CHUNK):
                out = run(xp[lo: lo + STREAM_CHUNK].contiguous(),
                          mask[lo: lo + STREAM_CHUNK].contiguous(), *carry)
                chunks.append(out)
                carry = [o[-1] for o in out]
            null = run(xp, mask)
            zeros = run(xp, mask, *[torch.zeros_like(i) for i in init])
            want = plain(xp, mask, *rest, *init)
            want = want if isinstance(want, tuple) else (want,)
            held = want
            if family == "ln_lstm":
                held = ln_carry_steps(xp, mask, rest, whole, init)
        torch.cuda.synchronize()
        require(all(torch.equal(torch.cat([c[k] for c in chunks]), seq)
                    for k, seq in enumerate(whole)),
                f"{family} {design}: the chunked carry differs from one "
                "launch")
        require(all(torch.equal(a, z) for a, z in zip(null, zeros)),
                f"{family} {design}: no carry differs from a zero carry")
        err = max(float((a - w).abs().max()) for a, w in zip(whole, held))
        require(all(within(a, w, *tol) for a, w in zip(whole, held)),
                f"{family} {design} with a carry disagrees with plain by "
                f"{err:.3e}")
        vs = "vs plain"
        if family == "ln_lstm":
            drift = max(float((a - w).abs().max())
                        for a, w in zip(whole, want))
            vs = (f"whole trajectories vs plain {drift:.3e} (not held: a "
                  f"chaotic recurrence); vs the plain step from the "
                  f"kernel's own state")
        times = []
        for rows in ((1, b) if b == BATCH else (b,)):
            args = (xp[:STREAM_CHUNK, :rows].contiguous(),
                    mask[:STREAM_CHUNK, :rows].contiguous(),
                    *[i[:rows].contiguous() for i in init])
            with torch.inference_mode():
                times.append(f"B={rows} {cuda_ms(lambda: run(*args), 10):.4f}"
                             f" ms")
        print(f"stream carry, {family}_fwd {design} design, H={h} B={b} "
              f"T={STREAM_T} in chunks of {STREAM_CHUNK} from a random "
              f"carry: chunked bit-equal to one launch, no carry bit-equal "
              f"to zeros, {vs} max_abs_err={err:.3e} (tol {tol[0]:g} + "
              f"{tol[1]:g}*|plain|)")
        print(f"[{card}] stream carry, {family}_fwd {design} design, H={h}: "
              f"a chunk of {STREAM_CHUNK} frames {', '.join(times)}")


def check_beam_stream(dev: torch.device, card: str, lm) -> None:
    """(b) The beam kernel's stream form against beam_stream_plain on the
    beam phase's emissions, chunk by chunk (BEAM_STREAM_CASES): state,
    prefixes, emits, start slots and scores bit for bit; each row's best
    prefix spliced over the chunks equal to ctc_beam's one-shot best path;
    the stream form's us a frame at W=16 (the select design) and W=256
    (the wide design) at B=1 and B=32."""
    from asr_study_torch.ops import beam

    logits, lens = beam_emissions(dev)
    lp = torch.log_softmax(logits, -1)
    for chunk, width, with_lm in BEAM_STREAM_CASES:
        t_case = time.perf_counter()
        kw = dict(lm=lm, **BEAM_LM) if with_lm else {}
        init = beam.beam_stream_init(width, lm.init_state() if with_lm
                                     else 0, dev)
        state = beam.BeamState(*(s[None].repeat(BEAM_B, 1) for s in init))
        spliced = [[[] for _ in range(width)] for _ in range(BEAM_B)]
        for lo in range(0, BEAM_T, chunk):
            n = (lens - lo).clamp(0, chunk)
            got = beam.ctc_beam_stream(lp[:, lo: lo + chunk], n, state,
                                       width, **kw)
            want = beam.beam_stream_plain(lp[:, lo: lo + chunk], n, state,
                                          width, **kw)
            require(all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
                    and all(torch.equal(a, b)
                            for a, b in zip(got[1:], want[1:])),
                    f"ctc_beam stream form, chunk {chunk} W={width}: differs"
                    f" from beam_stream_plain at frame {lo}")
            state = got[0]
            pref, emits, start = (x.cpu() for x in got[1:4])
            spliced = [[spliced[r][int(start[r, w])]
                        + pref[r, w, : int(emits[r, w])].tolist()
                        for w in range(width)] for r in range(BEAM_B)]
        one = beam.ctc_beam(lp, lens, width, **kw)
        best = beam._sort_desc(got[4])[:, 0].cpu()
        same = sum(spliced[r][int(best[r])]
                   == one[0][r, 0, : int(one[1][r, 0])].tolist()
                   for r in range(BEAM_B))
        require(same == BEAM_B, f"ctc_beam stream form, chunk {chunk} "
                f"W={width}: spliced best paths equal the one-shot beam's "
                f"in {same}/{BEAM_B} rows")
        print(f"ctc_beam stream form vs plain, chunks of {chunk} W={width}"
              f"{' LM order %d' % lm.order if with_lm else ''}: state, "
              f"prefixes, emits, start slots and scores bit-equal in every "
              f"chunk; spliced best paths equal to ctc_beam's one-shot "
              f"{same}/{BEAM_B}")
        if width == BEAM_WIDE_W:
            add_part(f"beam stream form W={width}", t_case)
    chunk = STREAM_CHUNK
    for width in (BEAM_SERVE_W, BEAM_WIDE_W):
        t_case = time.perf_counter()
        init = beam.beam_stream_init(width, 0, dev)
        for rows in (1, BEAM_B):
            state = beam.BeamState(*(s[None].repeat(rows, 1) for s in init))
            x = lp[:rows, :chunk].contiguous()
            n = lens[:rows].clamp(0, chunk)
            ms = cuda_ms(lambda: beam.ctc_beam_stream(x, n, state, width),
                         10)
            print(f"[{card}] ctc_beam stream form W={width} "
                  f"({beam.beam_design(width, BEAM_V)} design), a chunk of "
                  f"{chunk} frames at B={rows}: {ms:.4f} ms, "
                  f"{1e3 * ms / chunk:.3f} us a frame")
        if width == BEAM_WIDE_W:
            add_part(f"beam stream form W={width}", t_case)


def synth_long(seconds: float, seed: int) -> np.ndarray:
    """bench_stream.py's utterance: a 180 Hz tone and white noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    return (0.4 * np.sin(2 * np.pi * 180 * t)
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


def stream_logits(model, feats: np.ndarray, chunk: int) -> torch.Tensor:
    """apply_streaming over ``feats`` [T, F] in chunks of ``chunk`` (the
    last ragged, padded and masked) -> logits [T, V+1] on the CPU."""
    dev = next(model.parameters()).device
    carries, out = model.init_stream_carries(1), []
    for lo in range(0, len(feats), chunk):
        n = min(chunk, len(feats) - lo)
        x = np.zeros((1, chunk, feats.shape[1]), np.float32)
        x[0, :n] = feats[lo: lo + n]
        logits, carries = model.apply_streaming(
            torch.from_numpy(x).to(dev),
            torch.full((1,), n, dtype=torch.int32, device=dev), carries)
        out.append(logits[0, :n].cpu())
    return torch.cat(out)


def recognizer_runs(dev: torch.device, card: str, lm) -> tuple:
    """(c) StreamingRecognizer at full width on STREAM_AUDIO_S of audio in
    pushes of STREAM_PUSH_S (chunk_frames STREAM_CHUNK) for each of
    STREAM_MODELS, greedy, and deep_gru by beam16 with ``lm``: launches
    counted from 0 (one forward a layer and chunk, one beam a chunk), the
    transcript equal to the whole utterance's on the card
    (predict_host_features), the chunked logits against the CPU plain
    streaming path; bench_stream.py's numbers -> (the launches of each
    run, the deep_gru model)."""
    from asr_study_torch.cli.predict import predict_host_features
    from asr_study_torch.features.audio import MFCC
    from asr_study_torch.models.zoo import build_model
    from asr_study_torch.ops.beam import BeamConfig
    from asr_study_torch.streaming import StreamingRecognizer

    feature = MFCC()
    wav = synth_long(STREAM_AUDIO_S, SEED)
    feats = feature(wav)
    n_chunks = -(-len(feats) // STREAM_CHUNK)
    step = int(STREAM_PUSH_S * SR)
    runs, models = [], {}
    cases = [(label, 0) for label in STREAM_MODELS] + [
        ("deep_gru 2x256 uni", BEAM_SERVE_W)]
    for i, (label, width) in enumerate(cases):
        name, hp, row = STREAM_MODELS[label]
        if label not in models:
            models[label] = build_model(
                name, hp, num_classes=NUM_CLASSES, input_dim=39,
                generator=torch.Generator().manual_seed(SEED + 50 + i),
                device=dev).eval()
        model = models[label]
        kw = dict(beam_width=width, lm=lm, **BEAM_LM) if width else {}

        def stream(audio):
            rec = StreamingRecognizer(model, feature,
                                      chunk_frames=STREAM_CHUNK, **kw)
            t0 = time.perf_counter()
            rec.push(audio[:step])
            first = time.perf_counter() - t0
            for lo in range(step, len(audio), step):
                rec.push(audio[lo: lo + step])
            ids = rec.finish()
            torch.cuda.synchronize()
            return ids, first, time.perf_counter() - t0

        stream(wav[: 2 * STREAM_CHUNK * 160])           # warm-up
        reset_counts()
        ids, first, wall = stream(wav)
        launches = read_counts()
        want = {row: len(model.rnn.layers) * n_chunks}
        if width:
            want["ctc_beam"] = n_chunks
        require(launches == want, f"stream {label}: launches {launches}, "
                f"want {want}")
        runs.append(launches)
        beam_cfg = (BeamConfig(width, 0, lm, **BEAM_LM) if width else None)
        predict_host_features(model, feature, [wav[:step]], dev, beam_cfg)
        t0 = time.perf_counter()
        whole = predict_host_features(model, feature, [wav], dev, beam_cfg)
        torch.cuda.synchronize()
        batch_wall = time.perf_counter() - t0
        require(ids == whole[0].tolist(), f"stream {label}: transcript "
                f"differs from the whole utterance's ({len(ids)} against "
                f"{len(whole[0])} ids)")
        decoder = f"beam{width}+lm" if width else "greedy"
        err = None
        if not width:
            got = stream_logits(model, feats, STREAM_CHUNK)
            ref = stream_logits(copy.deepcopy(model).to("cpu"), feats,
                                STREAM_CHUNK)
            err = float((got - ref).abs().max())
            require(err <= LOGITS_TOL, f"stream {label}: logits differ "
                    f"from the CPU plain streaming path by {err:.3e}")
        print(f"stream {label} {decoder}: {STREAM_AUDIO_S:g} s of audio, "
              f"{len(feats)} frames in {n_chunks} chunks of {STREAM_CHUNK}, "
              f"pushes of {STREAM_PUSH_S:g} s; launches {launches}; "
              f"transcript ({len(ids)} ids) equal to the whole utterance's "
              f"on the card"
              + ("" if err is None else
                 f"; logits vs the CPU plain streaming path max_abs_err="
                 f"{err:.3e} (tol {LOGITS_TOL:g})"))
        print(f"[{card}] stream {label} {decoder} (bench_stream.py's "
              f"numbers): first_chunk_latency_ms {1e3 * first:.1f} (the "
              f"first {STREAM_PUSH_S:g} s push), stream "
              f"{STREAM_AUDIO_S / wall:.1f} audio-s/s, batch "
              f"{STREAM_AUDIO_S / batch_wall:.1f} audio-s/s (host features "
              f"+ one forward over the utterance + decode)")
    return runs, models["deep_gru 2x256 uni"]


def cell_recognizer_runs(dev: torch.device, card: str) -> list:
    """(f) StreamingRecognizer on CELL_STREAM_S of audio in pushes of
    STREAM_PUSH_S (chunk_frames STREAM_CHUNK) for each of
    CELL_STREAM_MODELS, greedy: launches counted from 0 (one forward a
    layer and chunk), the ids equal to the same model's whole-utterance
    greedy ids on the card, the chunked logits against the CPU plain
    streaming path (the layer-norm model's on its first LN_CHECK_T
    frames), stream audio-s/s -> the launches of each run."""
    from asr_study_torch.cli.predict import predict_host_features
    from asr_study_torch.features.audio import MFCC
    from asr_study_torch.models.zoo import build_model
    from asr_study_torch.streaming import StreamingRecognizer

    feature = MFCC()
    wav = synth_long(CELL_STREAM_S, SEED + 1)
    feats = feature(wav)
    n_chunks = -(-len(feats) // STREAM_CHUNK)
    step = int(STREAM_PUSH_S * SR)
    runs = []
    for i, (label, (name, hp, row)) in enumerate(
            CELL_STREAM_MODELS.items()):
        model = build_model(
            name, hp, num_classes=NUM_CLASSES, input_dim=39,
            generator=torch.Generator().manual_seed(SEED + 70 + i),
            device=dev).eval()

        def stream(audio):
            rec = StreamingRecognizer(model, feature,
                                      chunk_frames=STREAM_CHUNK)
            t0 = time.perf_counter()
            for lo in range(0, len(audio), step):
                rec.push(audio[lo: lo + step])
            ids = rec.finish()
            torch.cuda.synchronize()
            return ids, time.perf_counter() - t0

        stream(wav[: 2 * STREAM_CHUNK * 160])           # warm-up
        reset_counts()
        ids, wall = stream(wav)
        launches = read_counts()
        want = {row: len(model.rnn.layers) * n_chunks}
        require(launches == want, f"stream {label}: launches {launches}, "
                f"want {want}")
        runs.append(launches)
        whole = predict_host_features(model, feature, [wav], dev, None)
        require(ids == whole[0].tolist(), f"stream {label}: transcript "
                f"differs from the whole utterance's ({len(ids)} against "
                f"{len(whole[0])} ids)")
        n_check = LN_CHECK_T if name == "ln_blstm" else len(feats)
        got = stream_logits(model, feats[:n_check], STREAM_CHUNK)
        ref = stream_logits(copy.deepcopy(model).to("cpu"), feats[:n_check],
                            STREAM_CHUNK)
        err = float((got - ref).abs().max())
        require(err <= LOGITS_TOL, f"stream {label}: logits differ from the "
                f"CPU plain streaming path by {err:.3e}")
        print(f"stream {label} greedy: {CELL_STREAM_S:g} s of audio, "
              f"{len(feats)} frames in {n_chunks} chunks of {STREAM_CHUNK}; "
              f"launches {launches}; transcript ({len(ids)} ids) equal to "
              f"the whole utterance's on the card; logits on {n_check} "
              f"frames vs the CPU plain streaming path max_abs_err="
              f"{err:.3e} (tol {LOGITS_TOL:g})")
        print(f"[{card}] stream {label} greedy: stream "
              f"{CELL_STREAM_S / wall:.1f} audio-s/s ({STREAM_PUSH_S:g} s "
              f"pushes, host features included)")
    return runs


def multi_stream_run(dev: torch.device, card: str, model) -> dict:
    """(d) MultiStreamRecognizer, MULTI_STREAMS streams of 3-8 s at
    chunk_frames STREAM_CHUNK, pushes of 0.3-1.2 s interleaved with ticks,
    finished in a shuffled order: launches counted from 0, each stream's
    ids equal to its own StreamingRecognizer's -> the launches."""
    from asr_study_torch.features.audio import MFCC
    from asr_study_torch.streaming import (MultiStreamRecognizer,
                                           StreamingRecognizer)

    rng = np.random.RandomState(SEED + 60)
    wavs = [synth_long(rng.uniform(*SECONDS), SEED + 61 + i)
            for i in range(MULTI_STREAMS)]
    steps = [int(rng.uniform(0.3, 1.2) * SR) for _ in wavs]
    order = rng.permutation(MULTI_STREAMS)
    feature = MFCC()
    reset_counts()
    t0 = time.perf_counter()
    multi = MultiStreamRecognizer(model, feature, MULTI_STREAMS,
                                  chunk_frames=STREAM_CHUNK)
    offs = [0] * MULTI_STREAMS
    while any(o < len(w) for o, w in zip(offs, wavs)):
        for i, w in enumerate(wavs):
            if offs[i] < len(w):
                multi.push(i, w[offs[i]: offs[i] + steps[i]])
                offs[i] += steps[i]
        multi.tick()
    got = {int(i): multi.finish(int(i)) for i in order}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    require(set(launches) == {"gru_fwd"}
            and launches["gru_fwd"] % len(model.rnn.layers) == 0,
            f"multi-stream launches {launches}")
    same = 0
    for i, w in enumerate(wavs):
        rec = StreamingRecognizer(model, feature, chunk_frames=STREAM_CHUNK)
        rec.push(w)
        same += rec.finish() == got[i]
    require(same == MULTI_STREAMS, f"multi-stream: {same}/{MULTI_STREAMS} "
            "streams equal to their own recognizer's")
    audio = sum(len(w) for w in wavs) / SR
    print(f"multi-stream deep_gru 2x256 uni: {MULTI_STREAMS} streams, "
          f"{audio:.1f} s of audio, "
          f"{launches.get('gru_fwd', 0) // len(model.rnn.layers)} ticks, "
          f"finished in a shuffled order; launches {launches}; each "
          f"stream's ids equal to its own StreamingRecognizer's "
          f"{same}/{MULTI_STREAMS}")
    print(f"[{card}] multi-stream deep_gru 2x256 uni, {MULTI_STREAMS} "
          f"streams: {audio / wall:.1f} audio-s/s ({wall:.2f} s of host "
          f"time, features on the host)")
    return launches


def stream_cli_runs(card: str, tmp: str, model, lm_path: str) -> list:
    """(e) ``cli.predict --stream`` on the card, greedy (three wavs as
    concurrent streams), ``--beam_width 16 --lm`` and ``--beam_width
    256`` (the wide design), on an .npz of
    ``model``: launches counted from 0, the JSON lines equal to ``predict``
    without ``--stream`` on the same weights -> the launches."""
    from asr_study_torch.cli import predict
    from asr_study_torch.features.wav import write_wav
    from asr_study_torch.text.parser import CharParser
    from asr_study_torch.utils.weights import flat_from_params

    name, hp, _ = STREAM_MODELS["deep_gru 2x256 uni"]
    npz = os.path.join(tmp, "stream_uni.npz")
    meta = {"model": name, "params": hp, "num_feats": 39,
            "num_classes": NUM_CLASSES, "vocab": CharParser().vocab,
            "blank_id": NUM_CLASSES}
    np.savez(npz, __meta__=json.dumps(meta),
             **flat_from_params(model.state_dict()))
    rng = np.random.RandomState(SEED + 70)
    paths = []
    for i in range(3):
        paths.append(os.path.join(tmp, f"stream_{i}.wav"))
        write_wav(paths[-1], synth_long(rng.uniform(*SECONDS), SEED + 71 + i))
    runs = []
    for extra, label in (([], "greedy"),
                         (["--beam_width", str(BEAM_SERVE_W), "--lm",
                           lm_path], f"beam{BEAM_SERVE_W}+lm"),
                         (["--beam_width", str(BEAM_WIDE_W)],
                          f"beam{BEAM_WIDE_W}")):
        t_run = time.perf_counter()
        lines = {}
        for stream in (True, False):
            out = io.StringIO()
            if stream:
                reset_counts()
            with contextlib.redirect_stdout(out):
                require(predict.main(["--weights", npz, *extra, *paths,
                                      *(["--stream"] if stream else [])])
                        == 0, "predict failed")
            if stream:
                torch.cuda.synchronize()
                launches = read_counts()
                runs.append(launches)
            lines[stream] = [json.loads(x) for x in
                             out.getvalue().strip().splitlines()]
        require(lines[True] == lines[False] and len(lines[True]) == 3,
                f"predict --stream {label}: {lines[True]} against "
                f"{lines[False]}")
        beam_row = ("ctc_beam_wide" if str(BEAM_WIDE_W) in extra
                    else "ctc_beam")
        require(launches.get("gru_fwd", 0) > 0
                and (not extra or launches.get(beam_row, 0) > 0),
                f"predict --stream {label}: launches {launches}")
        print(f"cli predict --stream {label} on 3 wavs: JSON lines equal to "
              f"predict without --stream; launches {launches}")
        if beam_row == "ctc_beam_wide":
            add_part(f"predict --stream {label}", t_run)
    return runs


def streaming_phase(dev: torch.device, card: str, tmp: str) -> list:
    """The streaming phase (predict --stream): (a) the forward kernels'
    carried state on each route, (b) the beam kernel's stream form, then
    the main paths with launches counted: (c) StreamingRecognizer at full
    width, (d) MultiStreamRecognizer with MULTI_STREAMS streams, (e) the
    CLI, (f) the layer-norm, MI and zoneout recognizers -> each main
    path's launches."""
    from asr_study_torch.text.lm import CharNGramLM

    lm_path = os.path.join(tmp, "lm3.npz")
    lm = CharNGramLM.load(lm_path)
    check_stream_carries(dev, card)
    check_beam_stream(dev, card, lm)
    runs, gru_model = recognizer_runs(dev, card, lm)
    runs.append(multi_stream_run(dev, card, gru_model))
    runs += stream_cli_runs(card, tmp, gru_model, lm_path)
    runs += cell_recognizer_runs(dev, card)
    return runs


# the bfloat16 phase: label -> (zoo model, hparams, its bfloat16 forms'
# kernel line rows (forward, backward), recurrent layers, what it is)
BF16_PATHS = {
    "deep_blstm": ("deep_blstm", _CONFIG3, "bilstm_fwd_bf16",
                   "bilstm_bwd_bf16", TRAIN_LAYERS,
                   f"{TRAIN_LAYERS}x{HIDDEN} BLSTM"),
    "deep_speech": ("deep_speech", "dropout=0.0,input_dropout=0.0",
                    "bilstm_fwd_wide_bf16", "bilstm_bwd_wide_bf16", 1,
                    "3x512 dense + 1x512 BLSTM"),
    "deep_blstm uni": ("deep_blstm", _CONFIG3 + ",bidirectional=false",
                       "lstm_fwd_bf16", "lstm_bwd_bf16", TRAIN_LAYERS,
                       f"{TRAIN_LAYERS}x{HIDDEN} unidirectional LSTM"),
    "deep_speech uni": ("deep_speech", "dropout=0.0,input_dropout=0.0,"
                        "bidirectional=false", "lstm_fwd_wide_bf16",
                        "lstm_bwd_wide_bf16", 1,
                        "3x512 dense + 1x512 unidirectional LSTM"),
    "deep_gru": ("deep_gru", _CONFIG3, "bigru_fwd_bf16", "bigru_bwd_bf16",
                 TRAIN_LAYERS, f"{TRAIN_LAYERS}x{HIDDEN} BGRU"),
    "deep_gru uni": ("deep_gru", _CONFIG3 + ",bidirectional=false",
                     "gru_fwd_bf16", "gru_bwd_bf16", TRAIN_LAYERS,
                     f"{TRAIN_LAYERS}x{HIDDEN} unidirectional GRU"),
    "deep_gru 512": ("deep_gru", f"num_hiddens=512,num_layers={TRAIN_LAYERS}"
                     ",dropout=0.0", "bigru_fwd_wide_bf16",
                     "bigru_bwd_wide_bf16", TRAIN_LAYERS,
                     f"{TRAIN_LAYERS}x512 BGRU"),
    "zoneout_blstm": ("zoneout_blstm", _CONFIG3, "bi_zoneout_lstm_fwd_bf16",
                      "bi_zoneout_lstm_bwd_bf16", TRAIN_LAYERS,
                      f"{TRAIN_LAYERS}x{HIDDEN} zoneout BLSTM 0.1/0.1"),
    "zoneout_blstm uni": ("zoneout_blstm", _CONFIG3 + ",bidirectional=false",
                          "zoneout_lstm_fwd_bf16", "zoneout_lstm_bwd_bf16",
                          TRAIN_LAYERS, f"{TRAIN_LAYERS}x{HIDDEN} "
                          "unidirectional zoneout LSTM 0.1/0.1"),
    "mi_blstm": ("mi_blstm", _CONFIG3, "bi_mi_lstm_fwd_bf16",
                 "bi_mi_lstm_bwd_bf16", TRAIN_LAYERS,
                 f"{TRAIN_LAYERS}x{HIDDEN} MI BLSTM"),
    "mi_blstm uni": ("mi_blstm", _CONFIG3 + ",bidirectional=false",
                     "mi_lstm_fwd_bf16", "mi_lstm_bwd_bf16", TRAIN_LAYERS,
                     f"{TRAIN_LAYERS}x{HIDDEN} unidirectional MI LSTM"),
    "ln_blstm": ("ln_blstm", _CONFIG3, "bi_ln_lstm_fwd_bf16",
                 "bi_ln_lstm_bwd_bf16", TRAIN_LAYERS,
                 f"{TRAIN_LAYERS}x{HIDDEN} LN BLSTM"),
    "ln_blstm uni": ("ln_blstm", _CONFIG3 + ",bidirectional=false",
                     "ln_lstm_fwd_bf16", "ln_lstm_bwd_bf16", TRAIN_LAYERS,
                     f"{TRAIN_LAYERS}x{HIDDEN} unidirectional LN LSTM"),
}
BF16_STEPS = 5
# the bfloat16 phase at the stream design's batch (train --bf16
# --batch_size 64: no resident design takes B=64 in two directions at any
# width of the zoo): label -> as BF16_PATHS, trained on BF16_STREAM_B rows
BF16_STREAM_B = 64
BF16_STREAM_PATHS = {
    "deep_blstm b64": ("deep_blstm", _CONFIG3, "bilstm_fwd_stream_bf16",
                       "bilstm_bwd_stream_bf16", TRAIN_LAYERS,
                       f"{TRAIN_LAYERS}x{HIDDEN} BLSTM"),
    "deep_speech b64": ("deep_speech", "dropout=0.0,input_dropout=0.0",
                        "bilstm_fwd_stream_bf16", "bilstm_bwd_stream_bf16",
                        1, "3x512 dense + 1x512 BLSTM"),
    "deep_gru b64": ("deep_gru", _CONFIG3, "bigru_fwd_stream_bf16",
                     "bigru_bwd_stream_bf16", TRAIN_LAYERS,
                     f"{TRAIN_LAYERS}x{HIDDEN} BGRU"),
    "zoneout_blstm b64": ("zoneout_blstm", _CONFIG3,
                          "bi_zoneout_lstm_fwd_stream_bf16",
                          "bi_zoneout_lstm_bwd_stream_bf16", TRAIN_LAYERS,
                          f"{TRAIN_LAYERS}x{HIDDEN} zoneout BLSTM 0.1/0.1"),
    "mi_blstm b64": ("mi_blstm", _CONFIG3, "bi_mi_lstm_fwd_stream_bf16",
                     "bi_mi_lstm_bwd_stream_bf16", TRAIN_LAYERS,
                     f"{TRAIN_LAYERS}x{HIDDEN} MI BLSTM"),
    # one direction at B=128 (past the cluster design's B=96 there): the
    # zoneout and MI LSTMs' unidirectional stream rows of the kernels line
    "zoneout_blstm uni b128": ("zoneout_blstm", _CONFIG3 +
                               ",bidirectional=false",
                               "zoneout_lstm_fwd_stream_bf16",
                               "zoneout_lstm_bwd_stream_bf16", TRAIN_LAYERS,
                               f"{TRAIN_LAYERS}x{HIDDEN} unidirectional "
                               "zoneout LSTM 0.1/0.1"),
    "mi_blstm uni b128": ("mi_blstm", _CONFIG3 + ",bidirectional=false",
                          "mi_lstm_fwd_stream_bf16",
                          "mi_lstm_bwd_stream_bf16", TRAIN_LAYERS,
                          f"{TRAIN_LAYERS}x{HIDDEN} unidirectional MI "
                          "LSTM"),
    # the layer-norm LSTM's: B=64 in two directions, B=128 in one
    "ln_blstm b64": ("ln_blstm", _CONFIG3, "bi_ln_lstm_fwd_stream_bf16",
                     "bi_ln_lstm_bwd_stream_bf16", TRAIN_LAYERS,
                     f"{TRAIN_LAYERS}x{HIDDEN} LN BLSTM"),
    "ln_blstm uni b128": ("ln_blstm", _CONFIG3 + ",bidirectional=false",
                          "ln_lstm_fwd_stream_bf16",
                          "ln_lstm_bwd_stream_bf16", TRAIN_LAYERS,
                          f"{TRAIN_LAYERS}x{HIDDEN} unidirectional LN "
                          "LSTM"),
}
# the rows a BF16_STREAM_PATHS path trains on where not BF16_STREAM_B
BF16_STREAM_ROWS = {"zoneout_blstm uni b128": 128, "mi_blstm uni b128": 128,
                    "ln_blstm uni b128": 128}
# the bfloat16 stream forms (every cell's) held against their twins at T=TRAIN_T: (H, B, directions), two
# directions at the zoo's 256 and 512 units and B=BF16_STREAM_B, one
# direction at B=128
BF16_STREAM_CASES = ((HIDDEN, BF16_STREAM_B, (2,)), (512, BF16_STREAM_B, (2,)),
                     (HIDDEN, 128, (1,)))


def bf16_library(cell: str, hidden: int, ndir: int, t: int, b: int, dev,
                 reps: int = 5) -> tuple[float, float]:
    """cuDNN ``nn.LSTM(H, H)`` (``cell`` "lstm") or ``nn.GRU(H, H)`` ("gru")
    in bfloat16 (weights and input) at T, B, ``ndir`` directions, unpacked
    -> (forward ms, backward ms as forward + backward less forward).  It
    includes the input projection, which the port's kernels leave to
    cuBLAS."""
    ref = (torch.nn.LSTM if cell == "lstm" else torch.nn.GRU)(
        hidden, hidden, bidirectional=ndir == 2).to(dev, torch.bfloat16)
    ref.flatten_parameters()
    x = torch.randn(t, b, hidden, device=dev, dtype=torch.bfloat16)
    x_req = x.clone().requires_grad_()
    leaves = [x_req, *ref.parameters()]
    with torch.no_grad():
        fwd = cuda_ms(lambda: ref(x), reps)
    g = torch.randn(t, b, ndir * hidden, device=dev, dtype=torch.bfloat16)
    fwd_grad = cuda_ms(lambda: ref(x_req)[0], reps)
    fb = cuda_ms(lambda: torch.autograd.grad(ref(x_req)[0], leaves, g), reps)
    return fwd, fb - fwd_grad


class Bf16Family:
    """What check_bf16_kernels needs of one recurrence: the LSTM's
    (ops/bilstm.py), the GRU's (ops/gru.py), the layer-norm LSTM's
    (ops/ln_lstm.py), the zoneout LSTM's (ops/zoneout_lstm.py) or the MI
    LSTM's (ops/mi_lstm.py) wrappers, plain twins and dwh, in one shape.
    ``extras`` draws what the LN, zoneout and MI recurrences take beside xp
    and wh (the LN gains and bias gh, gc, bc; the mix weights zh, zc; the
    MI vectors), which every later call then passes; ``fwd`` -> (the h
    (and c) sequences, res); ``bwd`` -> the backward's outputs (LSTM,
    zoneout: dxp a direction; GRU: dxp, dhp a direction; LN: dpre, dcn a
    direction; MI: dpre a direction); ``dwh(xs, ws, outs, d, i)`` -> dwh
    of direction i."""

    def __init__(self, cell: str):
        from asr_study_torch.ops import bilstm as B
        from asr_study_torch.ops import gru as G
        from asr_study_torch.ops import ln_lstm as LN
        from asr_study_torch.ops import mi_lstm as MI
        from asr_study_torch.ops import zoneout_lstm as ZO

        self.cell, self.gates = cell, 3 if cell == "gru" else 4
        self.mod = {"lstm": B, "gru": G, "ln_lstm": LN, "zoneout_lstm": ZO,
                    "mi_lstm": MI}[cell]
        self.geometry = {"lstm": B.lstm_geometry, "gru": G.gru_geometry,
                         "ln_lstm": LN.ln_geometry,
                         "zoneout_lstm": ZO.zoneout_geometry,
                         "mi_lstm": MI.mi_geometry}[cell]
        self.name = {"lstm": "LSTM", "gru": "GRU", "ln_lstm": "LN LSTM",
                     "zoneout_lstm": "zoneout LSTM",
                     "mi_lstm": "MI LSTM"}[cell]
        # the wrappers' names, two directions and one; the kernels line's
        # rows are theirs
        self.names = {"lstm": ("bilstm", "lstm"), "gru": ("bigru", "gru"),
                      "ln_lstm": ("bi_ln_lstm", "ln_lstm"),
                      "zoneout_lstm": ("bi_zoneout_lstm", "zoneout_lstm"),
                      "mi_lstm": ("bi_mi_lstm", "mi_lstm")}[cell]
        # the LSTM and GRU have a wide design and a cuDNN call; the LN,
        # zoneout and MI LSTMs' rows of both directions are in the kernels
        # line
        self.resident = cell in ("ln_lstm", "zoneout_lstm", "mi_lstm")
        # the LN recurrence is chaotic at T=TRAIN_T (ROADMAP C2): held
        # step by step and row by row there, whole only at LN_CHECK_T
        self.chaotic = cell == "ln_lstm"
        self.widths = (HIDDEN,) if self.resident else (HIDDEN, 512)
        self.ex = [[], []]

    def extras(self, g: torch.Generator, t: int, b: int, hidden: int,
               dev) -> None:
        """Draw the LN gains and bias (gh, gc near 1, bc near 0), the
        zoneout mix (Bernoulli(0.9) zh and zc) or the MI vectors (alpha,
        beta1, beta2 near 1, b near 0) of each direction from ``g``, on
        the card, for every later call."""
        if self.cell == "ln_lstm":
            self.ex = [[(c + 0.3 * torch.randn(n, generator=g)).to(dev)
                        for c, n in ((1.0, 4 * hidden), (1.0, hidden),
                                     (0.0, hidden))] for _ in range(2)]
        elif self.cell == "zoneout_lstm":
            self.ex = [[(torch.rand(t, b, hidden, generator=g) < 0.9)
                        .float().to(dev) for _ in range(2)]
                       for _ in range(2)]
        elif self.cell == "mi_lstm":
            self.ex = [[(c + 0.3 * torch.randn(self.gates * hidden,
                                               generator=g)).to(dev)
                        for c in (1.0, 1.0, 1.0, 0.0)] for _ in range(2)]

    def _args(self, xs, mask, ws) -> tuple:
        """The LN, zoneout or MI wrapper's arguments before its
        outputs."""
        ex = self.ex[:len(xs)]
        inter = [t for k in range(len(ex[0])) for t in
                 (e[k] for e in ex)]
        if self.cell == "zoneout_lstm":
            return (*xs, mask, *inter, *ws)
        return (*xs, mask, *ws, *inter)

    def wrappers(self, ndir: int) -> tuple:
        name = self.names[0 if ndir == 2 else 1]
        return (getattr(self.mod, name), getattr(self.mod, f"{name}_bwd"))

    def fwd(self, xs, mask, ws, residual=False):
        f = self.wrappers(len(xs))[0]
        if self.resident:
            out = tuple(f(*self._args(xs, mask, ws)))
            return (*out, ()) if residual else out
        if len(xs) == 2:
            return f(*xs, mask, *ws, residual=residual)
        out = f(xs[0], mask, ws[0], residual=residual)
        return out if isinstance(out, tuple) else (out,)

    def bwd(self, xs, mask, ws, outs, dh, res) -> tuple:
        f = self.wrappers(len(xs))[1]
        if self.resident:
            out = f(*self._args(xs, mask, ws), *outs, *dh)
        elif len(xs) == 2:
            return tuple(f(*xs, mask, *ws, *outs, *dh, res))
        else:
            out = f(xs[0], mask, ws[0], *outs, dh[0], res)
        return out if isinstance(out, tuple) else (out,)

    def plain(self, xs, mask, ws, outs, dh, res) -> tuple:
        """(the forward's outputs with the wide design's res, the
        backward's) of the plain twins; the wide backward from res."""
        return (self.plain_fwd(xs, mask, ws, res),
                self.plain_bwd(xs, mask, ws, outs, dh, res))

    def plain_fwd(self, xs, mask, ws, res) -> tuple:
        """The forward's plain twin: its outputs, with the wide design's
        res where ``res`` is not empty."""
        m, wide, bi = self.mod, bool(res), len(xs) == 2
        if self.resident:
            name = self.names[0 if bi else 1]
            return getattr(m, f"{name}_plain")(*self._args(xs, mask, ws))
        if self.cell == "lstm":
            if bi:
                return m.bilstm_plain(*xs, mask, *ws, keep_gates=wide)
            return m.lstm_plain(xs[0], mask, ws[0], keep_gates=wide)
        if bi:
            return m.bigru_plain(*xs, mask, *ws, keep_hg=wide)
        f = m.gru_plain(xs[0], mask, ws[0], keep_hg=wide)
        return f if wide else (f,)

    def plain_bwd(self, xs, mask, ws, outs, dh, res) -> tuple:
        """The backward's plain twin from the kernel forward's ``outs``
        (the wide design's from res): its outputs."""
        m, wide, bi = self.mod, bool(res), len(xs) == 2
        if self.resident:
            name = self.names[0 if bi else 1]
            d = getattr(m, f"{name}_bwd_plain")(*self._args(xs, mask, ws),
                                                *outs, *dh)
            return d if isinstance(d, tuple) else (d,)
        if self.cell == "lstm":
            if bi:
                return (m.bilstm_bwd_gates_plain(*res, mask, *ws, outs[1],
                                                 outs[3], *dh) if wide else
                        m.bilstm_bwd_plain(*xs, mask, *ws, *outs, *dh))
            return ((m.lstm_bwd_gates_plain(*res, mask, ws[0], outs[1],
                                            dh[0]),) if wide else
                    (m.lstm_bwd_plain(xs[0], mask, ws[0], *outs, dh[0]),))
        if bi:
            return (m.bigru_bwd_res_plain(*xs, *res, mask, *ws, *outs, *dh)
                    if wide else m.bigru_bwd_plain(*xs, mask, *ws, *outs,
                                                   *dh))
        return (m.gru_bwd_res_plain(xs[0], *res, mask, ws[0], outs[0], dh[0])
                if wide else m.gru_bwd_plain(xs[0], mask, ws[0], outs[0],
                                             dh[0]))

    def dwh(self, xs, ws, outs, d, i) -> torch.Tensor:
        """dwh of direction i (bfloat16 with a bfloat16 wh) from the
        backward's outputs d, as the Functions' backward takes it."""
        from asr_study_torch.ops.bilstm import _dwh

        if self.cell == "mi_lstm":
            al, b1, b2, _ = self.ex[i]
            return self.mod.dir_grads(d[i], xs[i], outs[2 * i], ws[i], al,
                                      b1, b2, i == 1)[1]
        if self.cell == "ln_lstm":
            return self.mod._ln_param_grads(d[2 * i], d[2 * i + 1],
                                            outs[2 * i], outs[2 * i + 1],
                                            ws[i], self.ex[i][0], i == 1)[0]
        if self.cell == "gru":
            return self.mod._dwh(outs[i], d[2 * i + 1], i == 1, ws[i])
        return _dwh(outs[2 * i], d[i], i == 1, ws[i])

    def fwd_moved(self, xs, mask, ws, served) -> tuple:
        """What the forward reads and writes."""
        return (*xs, mask, *ws, *(t for e in self.ex[:len(xs)] for t in e),
                *served)

    def bwd_moved(self, xs, mask, ws, outs, dh, res, d) -> tuple:
        """What the backward reads and writes: the LSTM's wide form the kept
        gates and c, its cluster form xp, h and c; the GRU's xp, h (and the
        kept h side); the LN, zoneout and MI LSTMs' xp, h, c and the
        vectors or the mix; all the mask, wh, dh and their outputs."""
        if self.cell == "lstm":
            return (*(res if res else xs), *(outs[1::2] if res else outs),
                    mask, *ws, *dh, *d)
        return (*xs, *res, *outs, mask, *ws, *dh, *d,
                *(t for e in self.ex[:len(xs)] for t in e))


def chain_start(seqs, n: int, ndir: int) -> list:
    """The first ``n`` steps of each direction's backward chain in the
    sequences [T, B, ...] of ``seqs`` (each direction's outputs in turn,
    forward then reversed): the last n frames of the forward direction's,
    the first n of the reversed one's."""
    per = len(seqs) // ndir
    return [s[-n:] if i < per else s[:n] for i, s in enumerate(seqs)]


def ln_bf16_held(fam: Bf16Family, xs, mask, ws, dh, outs, d_k, d_p
                 ) -> tuple:
    """The LN LSTM's bfloat16 forms held as check_ln_kernels holds its
    float32 ones (ROADMAP C2), with the backward's row tolerance of
    LN_BF16_ROW_RTOL: every frame of the forward's h and c against the
    plain step from the kernel's own previous state (ln_stepwise); the
    backward's dpre and dcn of every (frame, row) of the first LN_CHECK_T
    steps of each chain against the twin's from the same states
    (rows_within), the rest printed; the backward through the kernels and
    the twins on the first LN_CHECK_T frames, from the kernel's forward
    there, by rows, and dwh there; printed beside them: the forwards'
    whole sequences there (a bfloat16 rounding of h_prev that flips
    between the two parts them as the backward's do) and the twin on the
    CPU against the twin on the card (another summation order: the plain
    path's own spread) -> (forward max err, backward max err, all held
    within, dwh max err / max abs, what was held)."""
    def max_err(got, want):
        return max(float((k - p).abs().max()) for k, p in zip(got, want))

    def worst_row(got, want):
        return max(float(((k - p).norm(dim=-1) / p.norm(dim=-1).clamp(
            min=1e-30)).max()) for k, p in zip(got, want))

    n = LN_CHECK_T
    with torch.no_grad():
        steps = ln_stepwise(fam._args(xs, mask, ws), outs)
        xs_c, mask_c, dh_c = ([a[:n].contiguous() for a in xs],
                              mask[:n].contiguous(),
                              [a[:n].contiguous() for a in dh])
        o_k = fam.fwd(xs_c, mask_c, ws)
        g_k = fam.bwd(xs_c, mask_c, ws, o_k, dh_c, ())
        o_p, g_p = fam.plain(xs_c, mask_c, ws, o_k, dh_c, ())
        cpu = lambda ts: [a.cpu() for a in ts]            # noqa: E731
        ex, fam.ex = fam.ex, [cpu(e) for e in fam.ex]
        try:
            g_cpu = fam.plain_bwd(cpu(xs_c), mask_c.cpu(), cpu(ws),
                                  cpu(o_k), cpu(dh_c), ())
        finally:
            fam.ex = ex
        dwh = [[fam.dwh(xs_c, ws, o_k, d, i) for i in range(len(xs))]
               for d in (g_k, g_p)]
    dwh_frac = max(float((k.float() - p.float()).abs().max())
                   / float(p.float().abs().max()) for k, p in zip(*dwh))
    head_k, head_p = (chain_start(d, n, len(xs)) for d in (d_k, d_p))
    ok = (all(within(k, p, BF16_ATOL, BF16_RTOL) for k, p in zip(outs, steps))
          and rows_within(head_k, head_p, BF16_ATOL, LN_BF16_ROW_RTOL)
          and rows_within(g_k, g_p, BF16_ATOL, LN_BF16_ROW_RTOL)
          and all(bool(torch.isfinite(k).all()) for k in d_k)
          and dwh_frac <= LN_BF16_DWH_FRAC)
    held = (f"; held (a chaotic recurrence): the forward every frame "
            f"against the plain step from its own state, the backward's "
            f"first {n} chain steps every (frame, row) within "
            f"{BF16_ATOL:g} + {LN_BF16_ROW_RTOL:g}*||plain|| (worst "
            f"||diff||/||plain|| {worst_row(head_k, head_p):.3e}; over all "
            f"{d_k[0].shape[0]} steps {worst_row(d_k, d_p):.3e}, printed), "
            f"the backward at T={n} by rows (worst {worst_row(g_k, g_p):.3e}"
            f"; the twin on the CPU against the twin on the card there "
            f"{worst_row(g_cpu, cpu(g_p)):.3e}, the forwards' whole "
            f"sequences {max_err(o_k, o_p):.3e}, printed) and dwh there "
            f"within {LN_BF16_DWH_FRAC:g} of its max")
    return max_err(outs, steps), max_err(d_k, d_p), ok, dwh_frac, held


def check_bf16_kernels(dev: torch.device, card: str, cell: str) -> dict:
    """The bfloat16-weight forms of the LSTM (``cell`` "lstm") or the GRU
    ("gru"): cluster and wide, at H=256 and H=512, and stream at
    BF16_STREAM_CASES, or of the zoneout, MI or layer-norm LSTM
    ("zoneout_lstm", "mi_lstm", "ln_lstm"): cluster, at H=256, and stream
    at BF16_STREAM_CASES; forward and backward, each over one and two directions (the stream cases: as
    listed), against their plain twins on the card at the training shapes
    T=TRAIN_T, B=TRAIN_B (the stream cases: their B): h (c; the wide
    design's kept gates or h side) and the
    backward's outputs (dxp; the GRU's dhp too; the LN's dpre and dcn; the
    MI dpre) within BF16_ATOL + BF16_RTOL * |plain|, dwh in bfloat16
    within BF16_DWH_FRAC of its max abs (the LN's as ln_bf16_held holds
    them); two launches bit-equal; each form timed beside its float32 form
    on the same inputs, its bound and cuDNN ``nn.LSTM`` / ``nn.GRU`` in
    bfloat16 (none for the LN, zoneout and MI LSTMs).  -> the kernel
    line's entries of the bidirectional forms (the LN, zoneout and MI
    LSTMs': of both; a row's first shape, so the stream rows' H=256,
    B=BF16_STREAM_B)."""
    fam = Bf16Family(cell)
    errs, times, bounds, library = {}, {}, {}, {}
    g = torch.Generator().manual_seed(SEED + {"lstm": 24, "gru": 26,
                                              "zoneout_lstm": 27,
                                              "mi_lstm": 28,
                                              "ln_lstm": 29}[cell])
    t, gates = TRAIN_T, fam.gates
    cases = [(hidden, TRAIN_B, (2, 1)) for hidden in fam.widths]
    cases += BF16_STREAM_CASES
    for hidden, b, ndirs in cases:
        xps = [torch.randn(t, b, gates * hidden, generator=g).to(dev)
               for _ in range(2)]
        w32 = [(torch.randn(hidden, gates * hidden, generator=g)
                / hidden ** 0.5).to(dev) for _ in range(2)]
        w16 = [w.to(torch.bfloat16) for w in w32]
        lengths = torch.randint(t // 2, t + 1, (b,), generator=g)
        lengths[0] = t
        mask = mask_of(lengths, t, dev)
        dhs = [torch.randn(t, b, hidden, generator=g).to(dev)
               for _ in range(2)]
        fam.extras(g, t, b, hidden, dev)
        lib = {n: (None, None) if fam.resident else
               bf16_library(cell, hidden, n, t, b, dev) for n in ndirs}
        for ndir in ndirs:
            geo = fam.geometry(hidden, b, ndir)
            wide = geo.design == "wide"
            # the stream forms take 10-20x the resident ones' time a call
            reps = 3 if geo.design == "stream" else 10
            xs, dh = xps[:ndir], dhs[:ndir]
            ws16, ws32 = w16[:ndir], w32[:ndir]
            key = geo.design + "_bf16"
            wrappers = fam.wrappers(ndir)
            before = [w.by_design[key] for w in wrappers]
            with torch.no_grad():
                runs = []
                for _ in range(2):
                    *outs, res = fam.fwd(xs, mask, ws16, residual=True)
                    runs.append((*outs, *res,
                                 *fam.bwd(xs, mask, ws16, outs, dh, res)))
                require([w.by_design[key] - n for w, n in
                         zip(wrappers, before)] == [2, 2],
                        f"bf16 {fam.name} H={hidden} ndir={ndir}: the "
                        f"{key} forms did not run")
                t0 = time.perf_counter()
                f_p, d_p = fam.plain(xs, mask, ws16, outs, dh, res)
                torch.cuda.synchronize()
                plain_s = time.perf_counter() - t0
                d_k = runs[0][len(outs) + len(res):]
            same = all(torch.equal(x, y) for x, y in zip(*runs))
            got = (*outs, *res)
            held = ""
            if fam.chaotic:
                err_f, err_b, ok, dwh_frac, held = ln_bf16_held(
                    fam, xs, mask, ws16, dh, outs, d_k, d_p)
            else:
                with torch.no_grad():
                    dwh = [[fam.dwh(xs, ws16, outs, d, i)
                            for i in range(ndir)] for d in (d_k, d_p)]
                err_f = max(float((k - p).abs().max())
                            for k, p in zip(got, f_p))
                err_b = max(float((k - p).abs().max())
                            for k, p in zip(d_k, d_p))
                dwh_frac = max(float((k.float() - p.float()).abs().max())
                               / float(p.float().abs().max())
                               for k, p in zip(*dwh))
                ok = (len(got) == len(f_p) and len(d_k) == len(d_p)
                      and all(within(k, p, BF16_ATOL, BF16_RTOL)
                              for k, p in zip(got, f_p))
                      and all(within(k, p, BF16_ATOL, BF16_RTOL)
                              for k, p in zip(d_k, d_p)))
            kept = ("c, gates" if cell == "lstm" else "h side") if wide else (
                "" if cell == "gru" else "c")
            d_names = {"lstm": "dxp", "gru": "dxp, dhp",
                       "ln_lstm": "dpre, dcn", "zoneout_lstm": "dxp",
                       "mi_lstm": "dpre"}[cell]
            print(f"bf16 {'bi' if ndir == 2 else 'uni'} {fam.name} kernels "
                  f"({geo.design} design, R={geo.rows}) vs plain twins at "
                  f"T={t} B={b} H={hidden}: forward max_abs_err {err_f:.3e}"
                  f" (h{', ' + kept if kept else ''}), backward {err_b:.3e}"
                  f" ({d_names}; max|{d_names.split(',')[0]}| "
                  f"{max(float(p.abs().max()) for p in d_p):.2f}), dwh "
                  f"(bfloat16) max err / max|dwh| {dwh_frac:.3e} (tol "
                  f"{BF16_ATOL:g} + {BF16_RTOL:g}*|plain|, dwh "
                  f"{BF16_DWH_FRAC:g}); two launches bit-equal {same}; "
                  f"plain twins {plain_s:.2f} s{held}")
            require(ok, f"bf16 {fam.name} kernels disagree with plain at H="
                        f"{hidden} ndir={ndir}")
            require(fam.chaotic or dwh_frac <= BF16_DWH_FRAC,
                    f"bf16 {fam.name} dwh disagrees with plain at H={hidden}")
            require(same, f"bf16 {fam.name} kernels at H={hidden} ndir="
                          f"{ndir} differ between two launches")

            # timings: each bfloat16 form beside its float32 form
            with torch.no_grad():
                *outs32, res32 = fam.fwd(xs, mask, ws32, residual=True)
                ms = {"bf16_fwd": cuda_ms(lambda: fam.fwd(xs, mask, ws16),
                                          reps),
                      "f32_fwd": cuda_ms(lambda: fam.fwd(xs, mask, ws32),
                                         reps),
                      "bf16_bwd": cuda_ms(lambda: fam.bwd(
                          xs, mask, ws16, outs, dh, res), reps),
                      "f32_bwd": cuda_ms(lambda: fam.bwd(
                          xs, mask, ws32, outs32, dh, res32), reps)}
                plain_ms = {
                    "fwd": cuda_ms(lambda: fam.plain_fwd(xs, mask, ws16,
                                                         res), 1, 0),
                    "bwd": cuda_ms(lambda: fam.plain_bwd(
                        xs, mask, ws16, outs, dh, res), 1, 0)}
            # the bound at the card's rate for bfloat16 products into
            # float32 (the tensor cores'), and at the fp32 FMA rate the
            # kernels' own products run at
            served = fam.fwd(xs, mask, ws16)
            fwd_moved = fam.fwd_moved(xs, mask, ws16, served)
            bwd_moved = fam.bwd_moved(xs, mask, ws16, outs, dh, res, d_k)
            passes = 1 if wide else 2
            b_fwd = rnn_bound(xs[0], hidden, ndir, 1, fwd_moved, PEAK_BF16)
            b_bwd = rnn_bound(xs[0], hidden, ndir, passes, bwd_moved,
                              PEAK_BF16)
            f_fwd = rnn_bound(xs[0], hidden, ndir, 1, fwd_moved)
            f_bwd = rnn_bound(xs[0], hidden, ndir, passes, bwd_moved)
            lib_f, lib_b = lib[ndir]
            library_text = (
                "no library call (cuDNN has no layer-norm, zoneout or MI "
                "cell)"
                if fam.resident else
                f"cuDNN nn.{fam.name}({hidden}, {hidden}) in bfloat16 "
                f"forward {lib_f:.4f} ms, backward {lib_b:.4f} ms")
            print(f"[{card}] bf16 {'bi' if ndir == 2 else 'uni'} {fam.name} "
                  f"{geo.design} forms at T={t} B={b} H={hidden}: forward "
                  f"{ms['bf16_fwd']:.4f} ms (float32 form "
                  f"{ms['f32_fwd']:.4f}, {ms['bf16_fwd'] / ms['f32_fwd']:.3f}"
                  f"x), backward {ms['bf16_bwd']:.4f} ms (float32 form "
                  f"{ms['f32_bwd']:.4f}, {ms['bf16_bwd'] / ms['f32_bwd']:.3f}"
                  f"x); bounds {b_fwd[0]:.4f} ({b_fwd[1]}) / {b_bwd[0]:.4f} "
                  f"ms ({b_bwd[1]}) at the bf16 tensor-core rate, "
                  f"{f_fwd[0]:.4f} / {f_bwd[0]:.4f} ms at the fp32 FMA "
                  f"rate; plain twins {plain_ms['fwd']:.4f} / "
                  f"{plain_ms['bwd']:.4f} ms; {library_text}")
            suffix = {"wide": "_wide", "stream": "_stream"}.get(geo.design,
                                                                "")
            row = f"{fam.names[2 - ndir]}_{{}}{suffix}_bf16"
            if (ndir == 2 or fam.resident) and row.format("fwd") not in errs:
                for kind, err in (("fwd", err_f), ("bwd", err_b)):
                    errs[row.format(kind)] = err
                    times[row.format(kind)] = (ms[f"bf16_{kind}"],
                                               plain_ms[kind])
                bounds[row.format("fwd")] = b_fwd
                bounds[row.format("bwd")] = b_bwd
                library[row.format("fwd")] = lib_f
                library[row.format("bwd")] = lib_b
    return {"errs": errs, "times": times, "bounds": bounds,
            "library": library}


def bf16_train_path(dev: torch.device, card: str, path: str) -> dict:
    """BF16_STEPS bfloat16 train steps (``Trainer(compute_dtype=
    torch.bfloat16)``) of one of BF16_PATHS at the config-3 shapes of
    ``training_slice`` (or of BF16_STREAM_PATHS on BF16_STREAM_B rows, or
    BF16_STREAM_ROWS: the config-3 batch and the ones train_host draws from
    the next seeds), from
    the float32 slice's initial weights, counted from 0: launches of the
    bfloat16 forms only, held to the steps; losses finite, printed beside
    BF16_STEPS float32 steps' from the same weights; two identical
    bfloat16 steps bit-equal; ms a step of each by CUDA events; the
    masters and the optimizer's state float32."""
    from asr_study_torch.models.zoo import build_model
    from asr_study_torch.train.trainer import Trainer, make_optimizer

    stream = path in BF16_STREAM_PATHS
    model_name, hp, fwd_row, bwd_row, layers, desc = (
        BF16_STREAM_PATHS if stream else BF16_PATHS)[path]
    rows = BF16_STREAM_ROWS.get(path, BF16_STREAM_B) if stream else TRAIN_B

    def make(device, seed=SEED):
        return build_model(model_name, hp, num_classes=NUM_CLASSES,
                           input_dim=FEATS,
                           generator=torch.Generator().manual_seed(seed),
                           device=device)

    spec = make_optimizer("adam", 1e-4, 400.0)
    hosts = [train_host(SEED + k) for k in range(rows // TRAIN_B)]
    batch = [torch.from_numpy(np.concatenate(parts)).to(dev)
             for parts in zip(*hosts)]
    audio_per_step = AUDIO_PER_STEP * rows / TRAIN_B
    runs = {}
    for dtype in (torch.bfloat16, None):
        trainer = Trainer(make(dev), spec, compute_dtype=dtype)
        state = trainer.init_state()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        reset_counts()
        losses = [trainer.train_step(state, *batch, gen)[1]["loss"]
                  for _ in range(BF16_STEPS)]
        torch.cuda.synchronize()
        launches = read_counts()
        check_designs(f"{path} {'bf16' if dtype else 'float32'} train",
                      trainer.model.rnn.layers[0].rnn.hidden, rows,
                      2 * TRAIN_L + 1, bf16=dtype is not None)
        ms = cuda_ms(lambda: trainer.train_step(state, *batch, gen), 5)
        runs[dtype] = (launches, torch.stack(losses).cpu(), ms, trainer,
                       state)
    launches, losses, ms, trainer, state = runs[torch.bfloat16]
    want = {fwd_row: layers * BF16_STEPS, bwd_row: layers * BF16_STEPS,
            "ctc_alpha": BF16_STEPS, "ctc_beta": BF16_STEPS}
    print(f"bf16 train: {path} {desc} B={rows} T={TRAIN_T} L={TRAIN_L},"
          f" adam 1e-4 clip 400, compute_dtype bfloat16; launches over "
          f"{BF16_STEPS} steps {launches}; the float32 run's "
          f"{runs[None][0]}")
    require(launches == want, f"bf16 {path} launches {launches}, want "
                              f"{want}")
    require(bool(torch.isfinite(losses).all()), f"bf16 {path}: non-finite "
                                                f"loss")
    require(all(p.dtype == torch.float32 for p in trainer.model.parameters())
            and all(v.dtype == torch.float32
                    for st in state.optimizer.state.values()
                    for v in st.values() if torch.is_tensor(v)
                    and v.is_floating_point()),
            f"bf16 {path}: a master or optimizer state is not float32")
    f32 = runs[None][1]
    print(f"{path} train losses, {BF16_STEPS} steps on one batch from the "
          f"same weights: bf16 {[round(float(v), 4) for v in losses]}; "
          f"float32 {[round(float(v), 4) for v in f32]} (first step rel "
          f"{abs(float(losses[0]) / float(f32[0]) - 1):.3e})")
    check_reproducible(f"{path} bf16", make, spec, batch, dev,
                       compute_dtype=torch.bfloat16)
    print(f"[{card}] {path} bf16 train step ({desc}, B={rows}, "
          f"T={TRAIN_T}, L={TRAIN_L}): {ms:.4f} ms/step, "
          f"{audio_per_step / (ms / 1e3):.1f} audio-s/s; float32 "
          f"{runs[None][2]:.4f} ms/step ({ms / runs[None][2]:.3f}x)")
    return launches


# the bidirectional recurrence wrapper of each model train --bf16 runs on
# the corpus
BF16_CLI_RNN = {"deep_blstm": "bilstm", "deep_gru": "bigru",
                "zoneout_blstm": "bi_zoneout_lstm", "mi_blstm": "bi_mi_lstm",
                "ln_blstm": "bi_ln_lstm"}


def bf16_cli_run(card: str, tmp: str, manifest: str, model: str,
                 batch: int = CORPUS_B) -> dict:
    """``train --bf16 --model <model> --batch_size <batch>`` (one of
    BF16_CLI_RNN, zoo defaults: 3x256, bidirectional) for one epoch on the
    corpus phase's manifest through ``cli.train.main``, counted from 0:
    the bfloat16 forms of the design the batch takes (cluster at
    CORPUS_B, stream at BF16_STREAM_B) launched for every train step and
    the float32 ones for the validation, finite losses,
    ``hparams["bf16"]``."""
    from asr_study_torch.cli import train as cli_train
    from asr_study_torch.ops.bilstm import lstm_geometry
    from asr_study_torch.ops.gru import gru_geometry
    from asr_study_torch.ops.ln_lstm import ln_geometry
    from asr_study_torch.ops.mi_lstm import mi_geometry
    from asr_study_torch.ops.zoneout_lstm import zoneout_geometry

    run_dir = os.path.join(tmp, f"bf16_run_{model}_b{batch}")
    tap = CliTap()
    reset_counts()
    t0 = time.perf_counter()
    with tap.record(), contextlib.redirect_stdout(io.StringIO()):
        require(cli_train.main([
            "--dataset", manifest, "--model", model, "--batch_size",
            str(batch), "--seed", str(SEED), "--log_every", "5",
            "--save", run_dir, "--epochs", "1", "--bf16"]) == 0,
            f"train --bf16 --model {model} --batch_size {batch} failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    its = dict(tap.flows)
    spe, v_b = its["train"].steps_per_epoch, its["valid"].steps_per_epoch
    rnn = BF16_CLI_RNN[model]
    # every batch is padded to its full rows: one design for all of them
    geometry = {"deep_gru": gru_geometry, "ln_blstm": ln_geometry,
                "zoneout_blstm": zoneout_geometry,
                "mi_blstm": mi_geometry}.get(model, lstm_geometry)
    suffix = "_stream" if geometry(HIDDEN, batch, 2).design == "stream" \
        else ""
    want = {f"{rnn}_fwd{suffix}_bf16": TRAIN_LAYERS * spe,
            f"{rnn}_bwd{suffix}_bf16": TRAIN_LAYERS * spe,
            f"{rnn}_fwd": TRAIN_LAYERS * v_b, "ctc_alpha": spe + v_b,
            "ctc_beta": spe}
    require(launches == want, f"train --bf16 --model {model} --batch_size "
                              f"{batch} launches {launches}, want {want}")
    with open(os.path.join(run_dir, "meta.json")) as f:
        meta = json.load(f)
    losses = [float(v) for v in tap.losses]
    require(meta["hparams"]["bf16"] is True
            and all(math.isfinite(v) for v in losses)
            and all(math.isfinite(v) for h in meta["history"]
                    for v in h.values()),
            f"train --bf16 --model {model} --batch_size {batch}: "
            f"{meta['history']}")
    step_ms, by_t = CliTap.ms(tap.steps)
    print(f"corpus train --bf16 ({model} zoo defaults, 1 epoch x {spe} "
          f"steps, B={batch}): launches {launches}; losses "
          f"{[round(v, 3) for v in losses]}; history {meta['history']}; "
          f"{wall:.1f} s wall")
    print(f"[{card}] corpus train --bf16 --model {model} --batch_size "
          f"{batch} step, CUDA events: {np.mean(step_ms[1:]):.4f} ms/step "
          f"mean after the first ({step_ms[0]:.4f}); by bucket {by_t}")
    return launches


def dp_model(dev: torch.device):
    """The dp phase's model: deep_blstm 3x256 from a seed, dropout 0 (one
    process and two ranks draw different masks otherwise)."""
    from asr_study_torch.models.zoo import deep_blstm

    return deep_blstm(f"num_hiddens={HIDDEN},num_layers={TRAIN_LAYERS},"
                      "dropout=0.0", num_classes=NUM_CLASSES,
                      input_dim=FEATS,
                      generator=torch.Generator().manual_seed(SEED + 11),
                      device=dev)


def dp_batch(real: int | None = None):
    """The dp phase's global host batch: B=32, T=512 frames padded, 256 to
    512 real, labels of 24 to 48; every row weighted, or the first
    ``real`` only."""
    from asr_study_torch.data.generator import Batch

    rng = np.random.RandomState(SEED + 12)
    weights = np.ones(TRAIN_B, np.float32)
    if real is not None:
        weights[real:] = 0.0
    return Batch(rng.randn(TRAIN_B, TRAIN_T, FEATS).astype(np.float32),
                 rng.randint(TRAIN_T // 2, TRAIN_T + 1,
                             TRAIN_B).astype(np.int32),
                 rng.randint(0, NUM_CLASSES,
                             (TRAIN_B, TRAIN_L)).astype(np.int32),
                 rng.randint(TRAIN_L // 2, TRAIN_L + 1,
                             TRAIN_B).astype(np.int32), weights)


def dp_trainer(dev: torch.device, group=None, spec=None):
    from asr_study_torch.train.trainer import Trainer, make_optimizer

    return Trainer(dp_model(dev), spec or make_optimizer("sgd", 1e-4, 400.0),
                   group=group)


def dp_step(dev: torch.device, batch, group=None) -> tuple:
    """One SGD step from the dp model's weights on ``batch`` (this rank's
    rows under ``group``) -> (loss, grad norm, {name: gradient as the
    optimizer took it, on the host})."""
    tr = dp_trainer(dev, group)
    _, m = tr.train_step(tr.init_state(), *tr.local_batch(batch),
                         torch.Generator(device=dev).manual_seed(SEED))
    return float(m["loss"]), float(m["grad_norm"]), {
        n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()}


def dp_step_ms(dev: torch.device, group=None) -> float:
    """ms a step (host clock around DP_TIME_STEPS steps ending in a
    synchronize, after one warm-up step) of the dp model on the full
    batch, this rank's rows under ``group``."""
    from asr_study_torch.parallel import dp

    tr = dp_trainer(dev, group)
    state = tr.init_state()
    batch = tr.local_batch(dp_batch())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tr.train_step(state, *batch, gen)
    if group is not None:
        dp.barrier(group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DP_TIME_STEPS):
        tr.train_step(state, *batch, gen)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / DP_TIME_STEPS


def dp_fit(dev: torch.device, train_it, run_dir: str,
           group=None) -> tuple[list, dict]:
    """``fit`` for one epoch of ``train_it`` (DP_FIT_STEPS steps) from the
    dp model's weights with the CLI's default Adam, a checkpoint at its
    end, launches counted from 0 -> (the logged losses, read from the
    run's CSV on rank 0, else [], the launches of this process)."""
    from asr_study_torch.train.checkpoint import CheckpointManager
    from asr_study_torch.train.loop import fit
    from asr_study_torch.train.trainer import make_optimizer

    tr = dp_trainer(dev, group, make_optimizer())
    reset_counts()
    with contextlib.redirect_stderr(io.StringIO()):
        fit(tr, tr.init_state(), train_it, None, epochs=1, seed=SEED,
            ckpt=CheckpointManager(run_dir, group=group), log_dir=run_dir,
            log_every=1)
    torch.cuda.synchronize()
    launches = read_counts()
    if group is not None and group.rank:
        return [], launches
    with open(os.path.join(run_dir, "train_metrics.csv")) as f:
        return [float(r["loss"]) for r in csv.DictReader(f)
                if r.get("loss")], launches


def dp_rank(group, train_it, tmp: str, t_launch: float) -> dict:
    """One rank of the dp phase's two (``parallel.dp.launch`` on cuda:0
    over gloo): (a) the full and the ragged step and the full one again,
    (d) ms a step and ms of the flat all-reduce alone, (c) fit -> their
    results and the seconds from ``t_launch`` (the parent's wall clock) to
    this body and then each part's."""
    from asr_study_torch.parallel import dp

    marks = [("start", time.time() - t_launch)]
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = group.device
    full = dp_step(dev, dp_batch(), group)
    again = dp_step(dev, dp_batch(), group)
    out = {"full": full, "ragged": dp_step(dev, dp_batch(DP_RAGGED_REAL),
                                           group),
           "repeat_equal": full[0] == again[0] and all(
               torch.equal(g, again[2][n]) for n, g in full[2].items())}
    marks.append(("(a)", time.perf_counter() - t0))
    t0 = time.perf_counter()
    out["step_ms"] = dp_step_ms(dev, group)
    flat = torch.zeros(sum(g.numel() for g in full[2].values()) + 2,
                       device=dev)
    dp.barrier(group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DP_TIME_STEPS):
        dp.all_reduce_sum(group, flat)
    torch.cuda.synchronize()
    out["allreduce_ms"] = (time.perf_counter() - t0) * 1e3 / DP_TIME_STEPS
    out["allreduce_mib"] = 4 * flat.numel() / 2**20
    marks.append(("(d)", time.perf_counter() - t0))
    t0 = time.perf_counter()
    out["fit"] = dp_fit(dev, train_it, os.path.join(tmp, "dp_fit"), group)
    marks.append(("(c)", time.perf_counter() - t0))
    out["marks"] = marks
    return out


def dp_phase(card: str, tmp: str, train_it) -> list:
    """BASELINE config 5 on the one card (the module docstring's phase 11)
    -> [the two ranks' fit launches, summed]."""
    from asr_study_torch.parallel import dp
    from asr_study_torch.train.checkpoint import CheckpointManager

    dev = torch.device("cuda", 0)
    require(train_it.steps_per_epoch == DP_FIT_STEPS,
            f"the corpus's train split gives {train_it.steps_per_epoch} "
            f"batches of {CORPUS_B}, want {DP_FIT_STEPS}")
    ref = {"full": dp_step(dev, dp_batch()),
           "ragged": dp_step(dev, dp_batch(DP_RAGGED_REAL))}
    single_ms = dp_step_ms(dev)
    # (b) one rank over NCCL, in this process
    group = dp.make_group(0, 1, dev, os.path.join(tmp, "nccl_store"))
    try:
        require(group.backend == "nccl", f"backend {group.backend}")
        nccl = dp_step(dev, dp_batch(DP_RAGGED_REAL), group)
    finally:
        torch.distributed.destroy_process_group()
    want = ref["ragged"]
    nccl_equal = nccl[:2] == want[:2] and all(
        torch.equal(g, want[2][n]) for n, g in nccl[2].items())
    print(f"dp (b): one rank over NCCL against the step without a group "
          f"(deep_blstm {TRAIN_LAYERS}x{HIDDEN}, B={TRAIN_B}, T={TRAIN_T}, "
          f"{DP_RAGGED_REAL} real rows, sgd): loss, grad norm and "
          f"{len(want[2])} gradients bit-equal {nccl_equal} (loss "
          f"{nccl[0]:.6f} vs {want[0]:.6f})")
    require(nccl_equal, "one NCCL rank differs from the step without a "
            "group")
    single_dir = os.path.join(tmp, "dp_single")
    single_losses, _ = dp_fit(dev, train_it, single_dir)

    t0 = time.perf_counter()
    ranks = dp.launch(dp_rank, [dev, dev], args=(train_it, tmp, time.time()),
                      backend="gloo", join_timeout=DP_JOIN_S)
    launch_s = time.perf_counter() - t0
    # (a)
    for name in ("full", "ragged"):
        loss, gnorm, grads = ref[name]
        for rank, r in enumerate(ranks):
            got = r[name]
            loss_rel = abs(got[0] - loss) / abs(loss)
            frac = {n: float((got[2][n] - g).abs().max()
                             / g.abs().max().clamp(min=1e-30))
                    for n, g in grads.items()}
            worst = max(frac, key=frac.get)
            print(f"dp (a) {name}: rank {rank} of 2 (B={TRAIN_B // 2} rows "
                  f"each, gloo on cuda:0) against one process at "
                  f"B={TRAIN_B}: loss {got[0]:.6f} vs {loss:.6f}, rel "
                  f"{loss_rel:.3e} (tol {DP_LOSS_RTOL:g}); grad norm "
                  f"{got[1]:.6g} vs {gnorm:.6g}; worst gradient "
                  f"|diff|/max|g| {frac[worst]:.3e} in {worst} (tol "
                  f"{DP_GRAD_FRAC:g})")
            require(loss_rel <= DP_LOSS_RTOL, f"dp {name}: loss differs")
            require(frac[worst] <= DP_GRAD_FRAC,
                    f"dp {name}: a gradient differs")
        require(all(torch.equal(g, ranks[1][name][2][n])
                    for n, g in ranks[0][name][2].items()),
                f"dp {name}: the ranks' gradients differ")
    print(f"dp (a): two identical DP steps bit-equal on each rank "
          f"{[r['repeat_equal'] for r in ranks]}; the two ranks' gradients "
          f"bit-equal")
    require(all(r["repeat_equal"] for r in ranks),
            "two identical DP steps differ")
    # (c)
    dp_losses, _ = ranks[0]["fit"]
    launches = {}
    for r in ranks:
        for k, v in r["fit"][1].items():
            launches[k] = launches.get(k, 0) + v
    per_rank = {"bilstm_fwd": TRAIN_LAYERS * DP_FIT_STEPS,
                "bilstm_bwd": TRAIN_LAYERS * DP_FIT_STEPS,
                "ctc_alpha": DP_FIT_STEPS, "ctc_beta": DP_FIT_STEPS}
    require(all(r["fit"][1] == per_rank for r in ranks),
            f"dp fit launches by rank {[r['fit'][1] for r in ranks]}, want "
            f"{per_rank} each")
    rel = [abs(a - b) / abs(b) for a, b in zip(dp_losses, single_losses)]
    ckpt = CheckpointManager(os.path.join(tmp, "dp_fit"))
    print(f"dp (c): fit, {DP_FIT_STEPS} steps of the corpus's train split "
          f"(B={CORPUS_B}, adam 1e-3) in two ranks, launches {launches} "
          f"({per_rank} a rank); losses "
          f"{[round(v, 4) for v in dp_losses[::5]]} (every 5th) vs one "
          f"process {[round(v, 4) for v in single_losses[::5]]}, worst rel "
          f"{max(rel):.3e} (tol {DP_FIT_RTOL:g}); checkpoint at step "
          f"{ckpt.latest_step}, history {len(ckpt.meta['history'])}")
    require(len(dp_losses) == len(single_losses) == DP_FIT_STEPS,
            f"{len(dp_losses)} and {len(single_losses)} losses logged")
    require(max(rel) <= DP_FIT_RTOL, "dp fit losses differ from one "
            "process's")
    require(ckpt.latest_step == DP_FIT_STEPS
            and len(ckpt.meta["history"]) == 1,
            "dp fit: not one checkpoint at its last step")
    # (d)
    print(f"[{card}] dp (d): deep_blstm {TRAIN_LAYERS}x{HIDDEN} sgd step at "
          f"B={TRAIN_B}, T={TRAIN_T}: two ranks sharing one card through "
          f"host-staged gloo (not a DP rate: one card, and gloo copies the "
          f"{ranks[0]['allreduce_mib']:.2f} MiB buffer through the host) "
          f"{ranks[0]['step_ms']:.4f} / {ranks[1]['step_ms']:.4f} ms a "
          f"step on ranks 0 / 1, the flat all-reduce alone "
          f"{ranks[0]['allreduce_ms']:.4f} ms; one process "
          f"{single_ms:.4f} ms a step; the two ranks' launch "
          f"{launch_s:.1f} s wall, rank 0's parts (s): "
          + ", ".join(f"{k} {v:.1f}" for k, v in ranks[0]["marks"]))
    return [launches]


def tp_steps(name: str, dev: torch.device, group=None) -> dict:
    """An eval step, then an SGD step, of ``name`` 3x256 (dropout 0) from
    the tp phase's seeded weights on dp_batch(), tensor-parallel on
    ``group``'s model group where given, launches counted from 0 -> their
    losses, the gradients on the host, ms of each (CUDA-synchronised host
    clock) and the launches."""
    from asr_study_torch.models.zoo import build_model
    from asr_study_torch.train.trainer import Trainer, make_optimizer

    model = build_model(name, _CONFIG3, num_classes=NUM_CLASSES,
                        input_dim=FEATS,
                        generator=torch.Generator().manual_seed(SEED + 13),
                        device=dev)
    tr = Trainer(model, make_optimizer("sgd", 1e-4, 400.0), group=group)
    state = tr.init_state()
    batch = tr.local_batch(dp_batch())
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = tr.eval_step(state, *batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, m = tr.train_step(state, *batch,
                         torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"eval_loss": float(ev["loss"]), "loss": float(m["loss"]),
            "grads": {n: p.grad.detach().cpu()
                      for n, p in tr.model.named_parameters()},
            "eval_ms": (t1 - t0) * 1e3, "step_ms": (t2 - t1) * 1e3,
            "launches": read_counts()}


def tp_rank(group, t_launch: float) -> dict:
    """One rank of the tp phase's two (``parallel.dp.launch(..., tp=2)`` on
    cuda:0 over gloo): tp_steps of each TP_MODELS model, and the seconds
    from ``t_launch`` (the parent's wall clock) to this body."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"start_s": time.time() - t_launch}
    for name in TP_MODELS:
        out[name] = tp_steps(name, group.device, group)
    return out


def tp_nccl_backward(dev: torch.device, tmp: str) -> None:
    """The NCCL form of the TP all-gather's backward (reduce_scatter_tensor)
    and tp_slice's all-reduce, in a one-rank NCCL group in this process:
    the card has no second device for a two-rank NCCL layout, so a group of
    one is where those calls run here (the gradient passes through
    unchanged)."""
    import torch.distributed as dist

    from asr_study_torch.parallel import dp
    from asr_study_torch.parallel.tp import _Gather, tp_slice

    group = dp.make_group(0, 1, dev, os.path.join(tmp, "tp_nccl_store"))
    try:
        require(group.backend == "nccl", f"backend {group.backend}")
        mg = dp.ModelGroup(0, 1, dist.group.WORLD, "nccl")
        g = torch.Generator(device=dev).manual_seed(SEED + 14)
        h = torch.randn(TRAIN_B, HIDDEN, device=dev, generator=g,
                        requires_grad=True)
        ct = torch.randn(TRAIN_B, HIDDEN, device=dev, generator=g)
        _Gather.apply(h, mg).backward(ct)
        w = torch.randn(HIDDEN, 4 * HIDDEN, device=dev, generator=g,
                        requires_grad=True)
        tp_slice(w, 4, mg, 1).backward(2 * w.detach())
        ok = torch.equal(h.grad, ct) and torch.equal(w.grad, 2 * w.detach())
    finally:
        dist.destroy_process_group()
    print(f"tp: the all-gather's NCCL backward (reduce_scatter_tensor) and "
          f"tp_slice's all-reduce in a one-rank NCCL group pass the "
          f"cotangent through bit for bit: {ok}")
    require(ok, "the NCCL form of the TP backward changed the cotangent")


def tp_phase(card: str, tmp: str) -> list:
    """The tensor-parallel path on the one card (the module docstring's
    phase 12) -> [the ranks' launches, summed]."""
    from asr_study_torch.parallel import dp

    dev = torch.device("cuda", 0)
    ref = {name: tp_steps(name, dev) for name in TP_MODELS}
    tp_nccl_backward(dev, tmp)
    t0 = time.perf_counter()
    ranks = dp.launch(tp_rank, [dev, dev], args=(time.time(),),
                      backend="gloo", join_timeout=DP_JOIN_S, tp=2)
    launch_s = time.perf_counter() - t0
    launches = {}
    for name in TP_MODELS:
        want = ref[name]
        for rank, r in enumerate(ranks):
            got = r[name]
            rel = {k: abs(got[k] - want[k]) / abs(want[k])
                   for k in ("eval_loss", "loss")}
            frac = {n: float((got["grads"][n] - g).norm()
                             / g.norm().clamp(min=1e-30))
                    for n, g in want["grads"].items()}
            worst = max(frac, key=frac.get)
            print(f"tp: {name} {TRAIN_LAYERS}x{HIDDEN}, rank {rank} of 2 "
                  f"(one data rank, two model shards, gloo on cuda:0) "
                  f"against one process on the kernels (B={TRAIN_B}, "
                  f"T={TRAIN_T}, {len(want['grads'])} parameters): eval "
                  f"loss {got['eval_loss']:.6f} vs {want['eval_loss']:.6f} "
                  f"rel {rel['eval_loss']:.3e}, train loss {got['loss']:.6f}"
                  f" vs {want['loss']:.6f} rel {rel['loss']:.3e} (tol "
                  f"{TP_LOSS_RTOL:g}); worst gradient ||diff||/||g|| "
                  f"{frac[worst]:.3e} in {worst} (tol {TP_GRAD_FRAC:g}); "
                  f"launches {got['launches']} (one process "
                  f"{want['launches']})")
            require(max(rel.values()) <= TP_LOSS_RTOL,
                    f"tp {name}: a loss differs from one process's")
            require(frac[worst] <= TP_GRAD_FRAC,
                    f"tp {name}: a gradient differs from one process's")
            require(set(got["launches"]) == {"ctc_alpha", "ctc_beta"},
                    f"tp {name}: launches {got['launches']}: a recurrence "
                    f"kernel ran in the TP path")
            for k, v in got["launches"].items():
                launches[k] = launches.get(k, 0) + v
        require(all(torch.equal(g, ranks[1][name]["grads"][n])
                    for n, g in ranks[0][name]["grads"].items()),
                f"tp {name}: the ranks' gradients differ")
        print(f"[{card}] tp: {name} {TRAIN_LAYERS}x{HIDDEN} at B={TRAIN_B}, "
              f"T={TRAIN_T} in two ranks sharing one card through "
              f"host-staged gloo (not a TP rate: one card, and gloo copies "
              f"every frame's all-gather through the host): eval "
              f"{ranks[0][name]['eval_ms']:.1f} / "
              f"{ranks[1][name]['eval_ms']:.1f} ms, sgd step "
              f"{ranks[0][name]['step_ms']:.1f} / "
              f"{ranks[1][name]['step_ms']:.1f} ms on ranks 0 / 1; one "
              f"process on the kernels: eval {want['eval_ms']:.1f} ms, step "
              f"{want['step_ms']:.1f} ms (first calls, host clock)")
    print(f"tp: the two ranks' launch {launch_s:.1f} s wall, rank 0's body "
          f"from {ranks[0]['start_s']:.1f} s; the two ranks' gradients "
          f"bit-equal")
    return [launches]


def main() -> int:
    t_start = time.perf_counter()
    clock = PhaseClock()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from asr_study_torch import _build
    from asr_study_torch.cli.predict import Served, pack_batches, serve_batch
    from asr_study_torch.data import wire
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
    clock.mark("toolchain and build")
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
    from asr_study_torch.features.fbank import fft_smem
    serve_chain = featurizer("mfcc", "cpu").chain
    print(f"  dynamic shared memory per block: fbank's FFT design "
          f"{fft_smem(serve_chain)} B (8 warps, 16 frames, nfft=512, L=400, "
          f"{serve_chain.mel_packed.numel()} band weights), its DFT design "
          f"{4 * (16 * (400 + 257 + 40) + 16)} B (16 frames, L=400, "
          f"K=257, M=40); ctc_alpha and ctc_beta, the warp design, none "
          f"({16 * -(-s_len // 32)} B static at S={s_len}; the block design "
          f"{4 * 2 * s_len} B and {4 * 4 * s_len} B)")
    print_cluster_geometry()
    from asr_study_torch.ops.bilstm import stream_smem
    from asr_study_torch.ops.gru import gru_stream_smem
    from asr_study_torch.ops.mi_lstm import mi_stream_smem
    from asr_study_torch.ops.zoneout_lstm import zoneout_stream_smem
    from asr_study_torch.ops.ln_lstm import ln_stream_smem
    for hidden in (HIDDEN, 512):
        fwd_b, bwd_b, nsplit = ln_smem(hidden)
        print(f"  dynamic shared memory per block at H={hidden} of the "
              f"layer-norm LSTM's stream route: ln_lstm_stream_fwd "
              f"(float32 / bfloat16 weights) {fwd_b} / "
              f"{ln_stream_smem(hidden, True)[0]} B (4 rows), "
              f"ln_lstm_stream_bwd {bwd_b} B (both; 4 rows, {nsplit} "
              f"partial sums), raised at each launch")
        print(f"  the same of the LSTM's and the GRU's stream forms "
              f"(float32 / bfloat16 weights): lstm_stream_fwd "
              f"{stream_smem(hidden)[0]} / {stream_smem(hidden, True)[0]} "
              f"B, lstm_stream_bwd {stream_smem(hidden)[1]} B (both), "
              f"gru_stream_fwd {gru_stream_smem(hidden)[0]} / "
              f"{gru_stream_smem(hidden, True)[0]} B, gru_stream_bwd "
              f"{gru_stream_smem(hidden)[1]} B (both)")
        print(f"  the same of the zoneout and MI LSTMs' stream forms: "
              f"zoneout_lstm_stream_fwd {zoneout_stream_smem(hidden)[0]} / "
              f"{zoneout_stream_smem(hidden, True)[0]} B, "
              f"zoneout_lstm_stream_bwd {zoneout_stream_smem(hidden)[1]} B; "
              f"mi_lstm_stream_fwd {mi_stream_smem(hidden)[0]} / "
              f"{mi_stream_smem(hidden, True)[0]} B, mi_lstm_stream_bwd "
              f"{mi_stream_smem(hidden)[1]} B (both)")

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
    fbank_kernels = check_fbank_kernel(card, feat, pre, t_out)
    print("fbank library yardstick: none; no single PyTorch call computes "
          "the framed, windowed FFT -> power -> mel -> log -> DCT chain of "
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
    check_lstm_designs(dev)
    check_gru_designs(dev)
    gru_wide_kernels = check_gru_wide(dev, card, x_serve, feat_lengths)
    ln_kernels = check_ln_kernels(dev, card, x_serve, feat_lengths)
    zo_kernels = check_cell_family(dev, card, x_serve, feat_lengths,
                                   "zoneout")
    mi_kernels = check_cell_family(dev, card, x_serve, feat_lengths, "mi")
    check_stream_h512(dev, card, x_serve)
    clock.mark("kernels against their plain versions")

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
    clock.mark("wires and the dpack decode")
    feat_cpu = featurizer("mfcc", "cpu")
    # the serving slices' models on the host, and their batches for the
    # plain path on the CPU: (label, chaotic, served on the card, the job
    # of plain_serve)
    plain_tmp = tempfile.TemporaryDirectory()
    plain_batches = []

    def serving_slice(label, model, fwd_name, layers, desc, chaotic=False,
                      codec="pcm16", vs_pcm16=None, cpu_batches=N_BATCHES):
        """One model's serving slice over the ``codec`` wire: launches
        counted from 0, ms per batch -> (launches, served); its batches
        are queued for plain_checks, which holds their logits and
        transcripts against the plain path on the CPU fed the same wire.
        For a ``chaotic`` recurrence (the layer-norm LSTM) the full
        batches' logits drift is printed there, and the logits are held
        here on the first LN_CHECK_T frames' worth of audio of one batch
        instead.  The dpack
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
        require(fbank.by_design == {"fft": N_BATCHES, "dft": 0},
                f"{label}: fbank ran {fbank.by_design}, want the FFT design "
                "only")
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
            # the plain path on the CPU runs later, in worker processes
            # (plain_checks), so that it neither holds up the card nor
            # shares the host with the slices' timings
            model_cpu = copy.deepcopy(model).to("cpu")
            path = os.path.join(plain_tmp.name,
                                label.replace(" ", "_") + ".pt")
            torch.save(model_cpu, path)
            for o, s in list(zip(w.offsets, served))[:cpu_batches]:
                plain_batches.append((label, chaotic, Served(
                    *(t.cpu() for t in s)), (path, codec, w.cpu[
                        o: o + w.cap].numpy(), w.n_pad, w.scap)))
            logits_err = 0.0            # held in plain_checks
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

    def plain_checks():
        """The serving slices' batches through the plain path on the CPU,
        in up to PLAIN_WORKERS processes of one thread each: logits and
        transcripts against the kernel path's on the card, per slice."""
        t0 = time.perf_counter()
        refs = run_plain([b[3] for b in plain_batches])
        plain_s = PARTS["serving slices' plain path on the CPU"] = (
            time.perf_counter() - t0)
        by_label = {}
        for (label, chaotic, s, _), ref in zip(plain_batches, refs):
            require(s.logits.shape == (BATCH, ref.logits.shape[1],
                                       NUM_CLASSES + 1),
                    f"logits shape {tuple(s.logits.shape)}")
            require(bool(torch.isfinite(s.logits).all()), "non-finite logits")
            require(torch.equal(s.feat_lengths, ref.feat_lengths),
                    "frame lengths differ from the plain path")
            require(bool((s.lengths <= s.feat_lengths).all()),
                    "a decode is longer than its frames")
            err, same, n = by_label.get(label, (0.0, 0, 0))
            by_label[label] = (
                max(err, float((s.logits - ref.logits).abs().max())),
                same + int((s.decoded == ref.decoded).all(1).sum()), n + 1)
        chaotic_labels = {b[0] for b in plain_batches if b[1]}
        for label, (err, same, n) in by_label.items():
            held = (", not held: a chaotic recurrence"
                    if label in chaotic_labels else "")
            print(f"{label} slice logits, kernel path on the card vs plain "
                  f"path on the CPU ({n} of {N_BATCHES} batches): "
                  f"max_abs_err={err:.3e} (tol {LOGITS_TOL:g}{held}); "
                  f"identical transcripts {same}/{n * BATCH}")
            require(held or err <= LOGITS_TOL,
                    f"{label} slice logits disagree with plain")
        print(f"the serving slices' plain path on the CPU: "
              f"{len(plain_batches)} batches in {plain_s:.1f} s "
              f"({plain_workers(len(plain_batches))} worker processes of one "
              f"thread)")

    blstm_desc = f"{LAYERS}x{HIDDEN} BLSTM"
    launches, pcm_served = serving_slice("deep_blstm", model, "bilstm_fwd",
                                         LAYERS, blstm_desc)
    features_stage_split(card, feat, wires["pcm16"].dev[: wires["pcm16"].cap],
                         wires["pcm16"].n_pad)
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
    plain_checks()
    plain_tmp.cleanup()
    clock.mark("serving slices")
    path_launches.append(beam_serving_slice(card, model, feat,
                                            wires["pcm16"], audio_s))
    clock.mark("beam serving slice")
    with torch.inference_mode():
        bl_ms = cuda_ms(lambda: bilstm(*bl_args), 10)
        bl_plain_ms = cuda_ms(lambda: bilstm_plain(*bl_args), 3, warmup=1)
    print(f"[{card}] bilstm_fwd (one layer, both directions): kernel "
          f"{bl_ms:.4f} ms/batch, plain {bl_plain_ms:.4f} ms/batch "
          f"(T={t_out}, B={BATCH}, H={HIDDEN})")

    # 6, 7. the training paths ---------------------------------------------
    checks = CpuChecks(len(TRAIN_PATHS) + len(CHAOTIC))
    timings = []
    for path in TRAIN_PATHS:
        found = training_slice(dev, card, path, checks,
                               with_fit=path == "deep_blstm")
        path_launches.append(found["launches"])
        timings.append(found["time"])
    checks.finish()
    for time_path in timings:
        time_path()
    clock.mark("training paths")
    path_launches += optimizer_phase(dev, card)
    clock.mark("optimizer phase")
    # the bfloat16 phase (train --bf16): the LSTM's and the GRU's six
    # bfloat16-weight forms and the zoneout, MI and LN LSTMs' four each
    # against their twins, then bf16 train steps of deep_blstm (cluster)
    # and deep_speech (wide), bi and uni, deep_gru 3x256 (cluster) bi and
    # uni and 3x512 (wide), zoneout_blstm, mi_blstm and ln_blstm 3x256 bi
    # and uni, of deep_blstm, deep_speech, deep_gru, zoneout_blstm,
    # mi_blstm and ln_blstm at B=64 (stream), and of zoneout_blstm,
    # mi_blstm and ln_blstm unidirectional at B=128 (stream)
    bf16_kernels = check_bf16_kernels(dev, card, "lstm")
    for cell in ("gru", "zoneout_lstm", "mi_lstm", "ln_lstm"):
        for key, found in check_bf16_kernels(dev, card, cell).items():
            bf16_kernels[key].update(found)
    for path in (*BF16_PATHS, *BF16_STREAM_PATHS):
        path_launches.append(bf16_train_path(dev, card, path))
    clock.mark("bf16 phase")

    # 8. the corpus phase: make_dataset -> train -> resume -> eval; then
    # the h5 phase on its corpus: make_dataset --output (host, --device),
    # train from the .h5 and with --device_features, eval, predict; then
    # 9. the beam phase on its manifest and run: ctc_beam against its
    # plain twin, train_lm, eval by beam search
    with tempfile.TemporaryDirectory() as tmp:
        runs, manifest, run_dir, first_epoch, train_it = corpus_phase(card,
                                                                      tmp)
        path_launches += runs
        for model in BF16_CLI_RNN:
            with part(f"train --bf16 --model {model} CLI"):
                path_launches.append(bf16_cli_run(card, tmp, manifest,
                                                  model))
        for model in ("deep_blstm", "zoneout_blstm", "ln_blstm"):
            with part(f"train --bf16 --model {model} --batch_size "
                      f"{BF16_STREAM_B} CLI"):
                path_launches.append(bf16_cli_run(card, tmp, manifest,
                                                  model, BF16_STREAM_B))
        clock.mark("corpus phase")
        # 11. the dp phase on the corpus's train split
        path_launches += dp_phase(card, tmp, train_it)
        del train_it
        clock.mark("dp phase")
        # 12. the tp phase
        path_launches += tp_phase(card, tmp)
        clock.mark("tp phase")
        path_launches += h5_phase(card, tmp, manifest, first_epoch)
        clock.mark("h5 phase")
        beam_kernel, runs = beam_cli_phase(dev, card, manifest, run_dir, tmp)
        path_launches += runs
        clock.mark("beam phase")
        # 10. the streaming phase: predict --stream's carried state
        path_launches += streaming_phase(dev, card, tmp)
    clock.mark("streaming phase")

    # the kernels line -------------------------------------------------------
    measured = {
        "bilstm_fwd": (bilstm_err, bl_ms, bl_plain_ms, bl_bound,
                       lstm_y["lib_fwd"]),
    }
    for found in (fbank_kernels, train_kernels, gru_kernels, lstm_kernels,
                  wide_kernels, gru_wide_kernels, ln_kernels, zo_kernels,
                  mi_kernels, dpack_kernels, beam_kernel, bf16_kernels):
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
          f"kernels' build included; by phase (s): {clock.summary()}; the "
          f"native library's checks, the wide beam design's cases and CLI "
          f"runs and the train --bf16 run, inside those phases (s): "
          + "; ".join(f"{n} {t:.1f}" for n, t in PARTS.items()))
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(cpu_steps_turns() if sys.argv[1:] == ["cpu_steps_turns"]
             else main())
