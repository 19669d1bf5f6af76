"""Train and eval steps on one device (port of
``asr_study_tpu/train/trainer.py``).

A train step is forward (``train=True``, dropout from a ``torch.Generator``)
-> per-sequence CTC -> the weighted sum over ``max(sum(w), 1)`` ->
backward -> clip by global norm -> Adam.  On a CUDA device the recurrent
layers and the CTC lattice run the port's kernels forward and backward; the
rest is plain torch (cuBLAS fp32 matmuls: TF32 is not turned on here).

The optimizer is optax's ``chain(clip_by_global_norm(clipnorm),
adam(lr))``: the clip scales by ``clipnorm / norm`` only where
``norm >= clipnorm`` (no epsilon, unlike ``clip_grad_norm_``), and Adam is
bias-corrected with eps 1e-8 outside the square root, which is
``torch.optim.Adam``'s form.  The staircase ``lr_decay`` multiplies the
rate by ``lr_decay`` every ``decay_steps`` updates.

With a ``featurizer`` the step takes raw padded waveforms [B, N(, 1)] with
sample counts as lengths and featurizes them on the device first (on the
card the fbank kernel, under ``torch.no_grad``: no gradient flows to the
waveform); ``wav_augment`` runs before it and ``augment`` (SpecAugment)
after it, in the train step only.

One device, no mesh: data parallelism is ROADMAP queue A item 12.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from asr_study_torch.ops import ctc
from asr_study_torch.ops.metrics import edit_distance

_TRAIN_ITEM = "ROADMAP queue A item 5"


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What :func:`make_optimizer` chose; :meth:`build` binds it to
    parameters (a torch optimizer needs them, an optax transform does
    not)."""

    lr: float
    clipnorm: float
    lr_decay: float
    decay_steps: int

    def build(self, params: Iterable[torch.Tensor]):
        """-> (torch.optim.Adam, StepLR scheduler or None)"""
        opt = torch.optim.Adam(params, lr=self.lr, betas=(0.9, 0.999),
                               eps=1e-8)
        sched = None
        if self.lr_decay:
            sched = torch.optim.lr_scheduler.StepLR(
                opt, step_size=self.decay_steps, gamma=self.lr_decay)
        return opt, sched


def make_optimizer(
    name: str = "adam",
    lr: float = 1e-3,
    clipnorm: float = 400.0,
    weight_decay: float = 0.0,
    lr_decay: float = 0.0,
    decay_steps: int = 0,
    accum_steps: int = 1,
    plateau_factor: float = 0.0,
    plateau_patience: int = 0,
    plateau_window: int = 1,
) -> OptimizerSpec:
    """The JAX factory's choices, Adam only so far.

    ``lr_decay`` in (0, 1) with ``decay_steps`` > 0 is staircase
    exponential decay indexed by the update count."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if name != "adam":
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet ({_TRAIN_ITEM}); the port "
            "has adam")
    if weight_decay:
        raise NotImplementedError(
            f"weight_decay belongs to adamw, not ported yet ({_TRAIN_ITEM})")
    if accum_steps > 1:
        raise NotImplementedError(
            f"accum_steps > 1 is not ported yet ({_TRAIN_ITEM})")
    if plateau_factor:
        raise NotImplementedError(
            f"reduce-on-plateau is not ported yet ({_TRAIN_ITEM})")
    if lr_decay:
        if not 0.0 < lr_decay < 1.0:
            raise ValueError(f"lr_decay must be in (0, 1), got {lr_decay}")
        if decay_steps <= 0:
            raise ValueError(f"lr_decay={lr_decay} needs decay_steps > 0 "
                             f"(got {decay_steps})")
    return OptimizerSpec(float(lr), float(clipnorm or 0.0), float(lr_decay),
                         int(decay_steps))


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer (and rate schedule) and the update count;
    ``train_step`` updates all of them in place."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[Any]
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": (self.scheduler.state_dict()
                          if self.scheduler is not None else None),
            "step": self.step,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (optax.global_norm)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


def device_batch(batch, device: torch.device | str
                 ) -> tuple[torch.Tensor, ...]:
    """A host ``Batch`` -> (inputs, input_lengths, labels, label_lengths,
    weights) on ``device``: from pinned memory without blocking on a CUDA
    device, on the current stream."""
    device = torch.device(device)
    out = []
    for a in (batch.inputs, batch.input_lengths, batch.labels,
              batch.label_lengths, batch.weights):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out.append(t)
    return tuple(out)


class Trainer:
    """The step functions for one (model, optimizer) pair on the model's
    device.

    ``augment`` is a ``(inputs, input_lengths, generator) -> inputs``
    transform of the feature batch (``features.augment.SpecAugment``),
    ``featurizer`` a device featurizer (``features.select.featurizer``)
    that turns raw padded waveforms into features inside both steps, and
    ``wav_augment`` a ``(wavs, wav_lengths, generator) -> wavs`` transform
    of the raw batch before it (``features.augment.WavAugment``), which
    needs the featurizer."""

    def __init__(self, model: nn.Module, optimizer: OptimizerSpec,
                 augment=None, featurizer=None, wav_augment=None):
        if wav_augment is not None and featurizer is None:
            raise ValueError(
                "wav_augment operates on raw waveforms and needs "
                "featurizer= (the inputs are features otherwise)"
            )
        self.model = model
        self.spec = optimizer
        self.augment = augment
        self.featurizer = featurizer
        self.wav_augment = wav_augment

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def init_state(self) -> TrainState:
        opt, sched = self.spec.build(self.model.parameters())
        return TrainState(self.model, opt, sched, 0)

    def _loss_sum(self, logits, input_lengths, labels, label_lengths,
                  weights):
        per_seq = ctc.ctc_loss(logits, input_lengths, labels, label_lengths,
                               blank_id=self.model.blank_id)
        w = weights.to(torch.float32)
        return (per_seq * w).sum(), torch.clamp(w.sum(), min=1.0)

    @torch.no_grad()
    def _featurize(self, inputs: torch.Tensor, input_lengths: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   train: bool = False):
        """Raw padded wavs -> (features, frame counts) when a featurizer is
        attached, after ``wav_augment`` in training; the identity
        otherwise."""
        if self.featurizer is None:
            return inputs, input_lengths
        wavs = inputs[..., 0] if inputs.dim() == 3 else inputs
        if train and self.wav_augment is not None:
            wavs = self.wav_augment(wavs, input_lengths, generator)
        return self.featurizer._transform(wavs, input_lengths)

    def train_step(self, state: TrainState, inputs: torch.Tensor,
                   input_lengths: torch.Tensor, labels: torch.Tensor,
                   label_lengths: torch.Tensor, weights: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   augment_generator: Optional[torch.Generator] = None
                   ) -> tuple[TrainState, Dict[str, torch.Tensor]]:
        """One update.  Returns the state (updated in place) and the
        step's ``loss`` (weighted mean) and ``grad_norm`` (before the
        clip), as device scalars: nothing is fetched to the host.

        ``generator`` draws the dropout masks; ``augment_generator`` (else
        ``generator``) the augmentations', WavAugment's first."""
        model = state.model
        aug_gen = augment_generator if augment_generator is not None \
            else generator
        inputs, input_lengths = self._featurize(inputs, input_lengths,
                                                aug_gen, train=True)
        if self.augment is not None:
            inputs = self.augment(inputs, input_lengths, aug_gen)
        state.optimizer.zero_grad(set_to_none=True)
        logits = model(inputs, input_lengths, train=True,
                       generator=generator)
        loss_sum, denom = self._loss_sum(logits, input_lengths, labels,
                                         label_lengths, weights)
        loss = loss_sum / denom
        loss.backward()
        gnorm = self.apply_gradients(state)
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    def apply_gradients(self, state: TrainState) -> torch.Tensor:
        """Clip the model's gradients by global norm (in place), take
        the Adam update and the schedule step, count the step; returns the
        norm before the clip."""
        grads = [p.grad for p in state.model.parameters()
                 if p.grad is not None]
        gnorm = global_norm(grads)
        if self.spec.clipnorm > 0:
            scale = torch.where(gnorm < self.spec.clipnorm, 1.0,
                                self.spec.clipnorm / gnorm)
            for g in grads:
                g.mul_(scale)
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        return gnorm

    @torch.no_grad()
    def eval_step(self, state: TrainState, inputs: torch.Tensor,
                  input_lengths: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor, weights: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        """Loss, greedy decode and edit distance, as device scalars."""
        model = state.model
        inputs, input_lengths = self._featurize(inputs, input_lengths)
        logits = model(inputs, input_lengths, train=False)
        loss_sum, num = self._loss_sum(logits, input_lengths, labels,
                                       label_lengths, weights)
        decoded, dec_lens = ctc.greedy_decode(logits, input_lengths,
                                              blank_id=model.blank_id)
        dist = edit_distance(decoded, dec_lens, labels,
                             label_lengths).to(torch.float32)
        w = weights.to(torch.float32)
        return {
            "loss": loss_sum / num,
            "edit_dist": (dist * w).sum(),
            "label_chars": torch.clamp(
                (label_lengths.to(torch.float32) * w).sum(), min=1.0),
            "num_seqs": w.sum(),
        }

    def run_eval(self, state: TrainState, batches) -> Dict[str, float]:
        """Greedy-decode LER and loss over host batches, summed on
        the device and fetched once at the end."""
        acc = None
        for b in batches:
            out = self.eval_step(state, *device_batch(b, self.device))
            vals = torch.stack([out["edit_dist"], out["label_chars"],
                                out["loss"] * out["num_seqs"],
                                out["num_seqs"]])
            acc = vals if acc is None else acc + vals
        if acc is None:
            return {"loss": 0.0, "ler": 0.0, "num_seqs": 0.0}
        tot_dist, tot_chars, tot_loss, n = acc.cpu().tolist()  # ONE fetch
        return {
            "loss": tot_loss / max(n, 1.0),
            "ler": tot_dist / max(tot_chars, 1.0),
            "num_seqs": n,
        }
