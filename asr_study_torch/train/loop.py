"""The training loop: epochs over length-bucketed batches, eval and a
checkpoint per epoch, logging, early stop (port of
``asr_study_tpu/train/loop.py`` ``fit``).

Host work per step is the batch hand-off: the iterator pads the next
batch and each field goes from pinned memory to the device without
blocking, on the current stream.  The epoch loss is summed on the device,
and the metrics of a logged step are fetched one log step late, so the
host never waits on the step it has just enqueued and runs ahead of the
card (a worker thread building batches ahead gained nothing: the corpus
phase of ``chip_smoke.py`` times both).

``profile=True`` traces the steps ``[profile_steps)`` with
``torch.profiler`` (host and, on a CUDA device, kernel activity) into
``<log_dir>/trace`` as a Chrome trace (Perfetto reads it), where the JAX
loop takes a ``jax.profiler`` trace of the same steps.

With a data-parallel trainer (``Trainer(group=)``) every rank runs this
loop on the same global batch stream (the same seed, the same shuffle) and
steps on its rows of each batch; dropout and the augmentations draw from
generators of (seed, step, rank); only rank 0 writes metrics, logs and the
trace and prints, and the checkpoint manager saves on rank 0 alone.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, Optional

import torch

from asr_study_torch.train.checkpoint import CheckpointManager
from asr_study_torch.train.trainer import Trainer, TrainState
from asr_study_torch.utils.metrics_writer import MetricWriter


# the augmentations' stream, apart from dropout's (the JAX step folds 0x5A
# and 0x3A into its key for them)
AUGMENT_STREAM = 0x5A
# odd 64-bit constants (the golden ratio's; splitmix64's first
# multiplier): rank r's and stream s's seeds differ from rank 0's and
# stream 0's in every bit range, the low 32 bits included
_RANK_MIX = 0x9E3779B97F4A7C15
_STREAM_MIX = 0xBF58476D1CE4E5B9


def step_generator(device: torch.device, seed: int, step: int,
                   stream: int = 0, rank: int = 0) -> torch.Generator:
    """The dropout generator of one update (``stream`` 0; the
    augmentations' is :data:`AUGMENT_STREAM`) on data-parallel rank
    ``rank``, a function of (seed, step, rank) like the JAX step's
    ``fold_in(rng, step)`` and, on a mesh, ``fold_in(rng, axis_index)``:
    a resumed run draws the masks an uninterrupted one would, and the
    ranks draw different ones (rank 0 those of one device).  The rank and
    the stream are mixed into the low 32 bits too, the only ones the CPU
    generator's Mersenne twister takes; stream 0 and rank 0 leave the seed
    ``seed * 1_000_003 + step``."""
    base = seed * 1_000_003 + step
    return torch.Generator(device=device).manual_seed(
        (base ^ (rank * _RANK_MIX) ^ (stream * _STREAM_MIX)) % (2 ** 63))


def _start_trace(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_trace(prof, device: torch.device, log_dir: str,
                steps: tuple) -> None:
    """Wait for the traced steps' kernels, stop the trace and write it to
    ``<log_dir>/trace/steps_<a>_<b>.pt.trace.json``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    out = os.path.join(log_dir, "trace")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(out, f"steps_{steps[0]}_{steps[1]}.pt.trace.json"))


def fit(
    trainer: Trainer,
    state: TrainState,
    train_iter,                      # data.generator.DatasetIterator
    valid_iter=None,
    epochs: int = 10,
    seed: int = 0,
    ckpt: Optional[CheckpointManager] = None,
    hparams: Optional[Dict[str, Any]] = None,
    log_dir: Optional[str] = None,
    log_every: int = 10,
    profile: bool = False,
    profile_steps: tuple = (10, 20),
    tensorboard: bool = False,
    early_stop_patience: int = 0,
    sortagrad: bool = False,
    monitor: str = "val_loss",
) -> TrainState:
    """Run ``epochs`` epochs; returns the final state.

    ``early_stop_patience`` > 0 stops once ``monitor`` (val_loss or val_ler,
    lower is better) has not improved for that many epochs (needs
    ``valid_iter``).  ``sortagrad=True`` runs the first epoch of a fresh
    run (``state.step == 0``) in ascending-duration order.  ``profile=True``
    with a ``log_dir`` traces the steps ``[profile_steps)``; a run that
    ends inside them closes the trace where it ends."""
    if early_stop_patience > 0 and valid_iter is None:
        raise ValueError(
            "early_stop_patience requires a validation split (val_loss "
            "drives the stopping decision) — none was provided")
    device = trainer.device
    rank = trainer.group.rank if trainer.group is not None else 0
    lead = trainer.group is None or trainer.group.lead
    if not lead:        # rank 0 writes the metrics, the logs and the trace
        log_dir, profile = None, False
    writer = MetricWriter(log_dir, "train", tensorboard=tensorboard)
    step = state.step
    first_epoch_ordered = sortagrad and step == 0
    t_last = time.time()
    last_log_step = step
    best_val = float("inf")
    stale_epochs = 0
    prof = None

    def consume_log(pending):
        """Fetch a logged step's metrics (issued at least a step late)."""
        nonlocal t_last, last_log_step
        p_step, p_metrics, p_epoch = pending
        now = time.time()
        n_steps = max(p_step - last_log_step, 1)
        writer.write(p_step, {
            "epoch": p_epoch,
            "loss": float(p_metrics["loss"]),
            "grad_norm": float(p_metrics["grad_norm"]),
            "steps_per_s": n_steps / max(now - t_last, 1e-9),
        }, echo=True)
        t_last = now
        last_log_step = p_step

    try:
        for epoch in range(epochs):
            ep_loss = torch.zeros((), device=device)
            ep_w = 0.0
            pending = None               # (step, device metrics, epoch)
            for batch in train_iter.epoch(
                    seed=seed + epoch,
                    ordered=first_epoch_ordered and epoch == 0):
                if profile and log_dir and step == profile_steps[0]:
                    prof = _start_trace(device)
                inputs, in_lens, labels, lab_lens, weights = \
                    trainer.local_batch(batch)
                aug_gen = (step_generator(device, seed, state.step,
                                          AUGMENT_STREAM, rank)
                           if trainer.augment is not None
                           or trainer.wav_augment is not None
                           else None)
                state, metrics = trainer.train_step(
                    state, inputs, in_lens, labels, lab_lens, weights,
                    step_generator(device, seed, state.step, rank=rank),
                    aug_gen)
                step = state.step
                if prof is not None and step == profile_steps[1]:
                    _stop_trace(prof, device, log_dir, profile_steps)
                    prof = None
                # the global batch's weight: the loss is its mean
                w = float(batch.weights.sum())
                ep_loss += metrics["loss"] * w
                ep_w += w
                if lead and step % log_every == 0:
                    if pending is not None:
                        consume_log(pending)
                    pending = (step, metrics, epoch)
            if pending is not None:
                consume_log(pending)

            scalars: Dict[str, float] = {
                "epoch": epoch,
                "train_loss": float(ep_loss) / max(ep_w, 1e-9),
            }
            if valid_iter is not None:
                val = trainer.run_eval(state, valid_iter.epoch())
                scalars["val_loss"] = val["loss"]
                scalars["val_ler"] = val["ler"]
            writer.write(step, scalars, echo=lead)
            if ckpt is not None:
                ckpt.save(state, metrics={k: v for k, v in scalars.items()
                                          if k != "epoch"},
                          hparams=hparams)
            if early_stop_patience > 0 and monitor in scalars:
                if scalars[monitor] < best_val - 1e-6:
                    best_val = scalars[monitor]
                    stale_epochs = 0
                else:
                    stale_epochs += 1
                    if stale_epochs >= early_stop_patience:
                        if lead:
                            print(f"early stop: {monitor} has not improved "
                                  f"for {stale_epochs} epochs (best "
                                  f"{best_val:.4g})", file=sys.stderr)
                        break
    finally:
        if prof is not None:
            # the run ended inside the window: close the trace there
            _stop_trace(prof, device, log_dir, profile_steps)
        writer.close()
    return state
