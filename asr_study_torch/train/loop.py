"""The training loop: epochs over length-bucketed batches, eval and a
checkpoint per epoch, logging, early stop (port of
``asr_study_tpu/train/loop.py`` ``fit``).

Host work per step is the batch hand-off: each field goes from pinned
memory to the device without blocking, on the current stream (the JAX
loop's ``device_prefetch``).  The epoch loss is summed on the device, and
the metrics of a logged step are fetched one log step late, so the host
never waits on the step it has just enqueued.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, Optional

import torch

from asr_study_torch.train.checkpoint import CheckpointManager
from asr_study_torch.train.trainer import Trainer, TrainState, device_batch
from asr_study_torch.utils.metrics_writer import MetricWriter


def step_generator(device: torch.device, seed: int,
                   step: int) -> torch.Generator:
    """The dropout generator of one update, a function of (seed, step)
    like the JAX step's ``fold_in(rng, step)``: a resumed run draws the
    masks an uninterrupted one would."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step) % (2 ** 63))


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
    tensorboard: bool = False,
    early_stop_patience: int = 0,
    sortagrad: bool = False,
    monitor: str = "val_loss",
) -> TrainState:
    """Run ``epochs`` epochs; returns the final state.

    ``early_stop_patience`` > 0 stops once ``monitor`` (val_loss or val_ler,
    lower is better) has not improved for that many epochs (needs
    ``valid_iter``).  ``sortagrad=True`` runs the first epoch of a fresh
    run (``state.step == 0``) in ascending-duration order."""
    if profile:
        raise NotImplementedError(
            "profile=True is not ported yet: trace the port with "
            "torch.profiler around fit instead")
    if early_stop_patience > 0 and valid_iter is None:
        raise ValueError(
            "early_stop_patience requires a validation split (val_loss "
            "drives the stopping decision) — none was provided")
    device = trainer.device
    writer = MetricWriter(log_dir, "train", tensorboard=tensorboard)
    step = state.step
    first_epoch_ordered = sortagrad and step == 0
    t_last = time.time()
    last_log_step = step
    best_val = float("inf")
    stale_epochs = 0

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
            ep_w = torch.zeros((), device=device)
            pending = None               # (step, device metrics, epoch)
            for batch in train_iter.epoch(
                    seed=seed + epoch,
                    ordered=first_epoch_ordered and epoch == 0):
                inputs, in_lens, labels, lab_lens, weights = device_batch(
                    batch, device)
                state, metrics = trainer.train_step(
                    state, inputs, in_lens, labels, lab_lens, weights,
                    step_generator(device, seed, state.step))
                step = state.step
                w = weights.sum()
                ep_loss += metrics["loss"] * w
                ep_w += w
                if step % log_every == 0:
                    if pending is not None:
                        consume_log(pending)
                    pending = (step, metrics, epoch)
            if pending is not None:
                consume_log(pending)

            scalars: Dict[str, float] = {
                "epoch": epoch,
                "train_loss": float(ep_loss) / max(float(ep_w), 1e-9),
            }
            if valid_iter is not None:
                val = trainer.run_eval(state, valid_iter.epoch())
                scalars["val_loss"] = val["loss"]
                scalars["val_ler"] = val["ler"]
            writer.write(step, scalars, echo=True)
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
                        print(f"early stop: {monitor} has not improved for "
                              f"{stale_epochs} epochs (best {best_val:.4g})",
                              file=sys.stderr)
                        break
    finally:
        writer.close()
    return state
