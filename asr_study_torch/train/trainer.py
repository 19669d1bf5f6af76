"""Train and eval steps on one device (port of
``asr_study_tpu/train/trainer.py``).

A train step is forward (``train=True``, dropout from a ``torch.Generator``)
-> per-sequence CTC -> backward of the weighted loss **sum** -> the
gradients, the loss sum and the weight sum summed over the data-parallel
group (none without one) -> the gradients and the loss divided by
``max(sum(w), 1)`` -> clip by global norm -> the optimizer, in the JAX
step's order.  On a CUDA device the
recurrent layers and the CTC lattice run the port's kernels forward and
backward; the rest is plain torch (cuBLAS fp32 matmuls: TF32 is not turned
on here).

The optimizer is the JAX factory's optax chain, ``clip_by_global_norm
(clipnorm)``, then the update rule, then ``reduce_on_plateau`` where asked,
all inside ``MultiSteps`` where ``accum_steps > 1``:

- the clip scales by ``clipnorm / norm`` only where ``norm >= clipnorm``
  (no epsilon, unlike ``clip_grad_norm_``);
- ``adam``: bias-corrected, eps 1e-8 outside the square root, which is
  ``torch.optim.Adam``; ``adamw``: optax adds ``weight_decay * p`` to the
  Adam direction before the rate, which is ``torch.optim.AdamW``'s ``p *=
  1 - lr * wd`` followed by the Adam step; ``sgd``: momentum 0.9, no
  dampening, which is ``torch.optim.SGD``; ``rmsprop``: optax's decay 0.9
  with eps 1e-8 inside the root (:class:`RMSprop`; torch's RMSprop is
  another rule);
- the staircase ``lr_decay`` multiplies the rate by ``lr_decay`` every
  ``decay_steps`` updates;
- reduce-on-plateau (:class:`Plateau`) averages the step's loss over
  ``plateau_window`` updates and then multiplies that update, and every
  later one, by its scale, which drops by ``plateau_factor`` after
  ``plateau_patience`` windows without improvement;
- accumulation (:class:`GradAccumulator`) keeps the running mean of
  ``accum_steps`` micro-batches' gradients and applies it, clip, decay and
  plateau included, on the last of them; the others change no weight.
  ``TrainState.step`` counts micro-steps, as the JAX state does.

All of that state lives in device tensors, so a step fetches nothing to
the host, and in ``TrainState.state_dict``, so ``--resume`` keeps it.
``check_nans`` raises ``FloatingPointError`` at the first step whose loss
or gradient norm is not finite, before the update (a host sync a step).

With a ``featurizer`` the step takes raw padded waveforms [B, N(, 1)] with
sample counts as lengths and featurizes them on the device first (on the
card the fbank kernel, under ``torch.no_grad``: no gradient flows to the
waveform); ``wav_augment`` runs before it and ``augment`` (SpecAugment)
after it, in the train step only.

``compute_dtype=torch.bfloat16`` (``train --bf16``) is the JAX trainer's
mixed precision: the train step runs the model on its parameters cast to
bfloat16 (``torch.func.functional_call``) and on the inputs rounded to
bfloat16, every product then taking bfloat16 operands into a float32
result (``models.nn.dot``, the recurrent kernels' bfloat16-weight forms)
while h, c, dropout, the skips and the CTC loss stay float32.  The cast's
autograd hands the float32 master weights gradients rounded to bfloat16;
the clip, the optimizer and its state, the eval step and checkpoints stay
float32.  Every cell of the port has the kernels for it (:data:`BF16_CELLS`);
a model holding another subclass of ``LSTMCell`` or ``GRUCell`` refuses it:
the port has no bfloat16 kernels for a cell it does not know.

Data parallelism (``Trainer(group=)``, ``train --num_devices N``) is the
JAX trainer's ``shard_map`` over a ``data`` mesh, one process a rank
(``parallel/dp.py``): ``init_state`` broadcasts rank 0's parameters, each
rank steps on its rows of the global batch (:meth:`Trainer.local_batch`),
and one all-reduce of one flat float32 buffer a step (the gradients in
parameter order, then the loss sum and the weight sum) makes the step the
one on the whole batch, zero-weight rows wherever they land; the clip, the
accumulator, the plateau (on the global loss) and ``check_nans`` (on the
global norm: every rank raises together) follow it unchanged.  The eval
step all-reduces its sums the same way.

Tensor parallelism (a group of ``dp.launch(..., tp=m)``, ``train
--tp_devices m``) is the JAX trainer's 2-D ``(data, model)`` mesh: both
steps run the model with ``tp=`` (the group's model group and its shard
count, the JAX ``_tp``), so the recurrent layers take the gate-dim-sharded
scan of ``parallel/tp.py``; the ranks of a model group step on the same
rows (those of their data index) and draw the same dropout masks, and its
``tp_slice`` leaves the gradients replicated across the model group, so
the flat all-reduce runs over the data group alone.  ``init_state``
broadcasts global rank 0's parameters to every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from asr_study_torch.models.cells import (GRUCell, LayerNormLSTMCell,
                                          LSTMCell, MILSTMCell,
                                          ZoneoutLSTMCell)
from asr_study_torch.ops import ctc
from asr_study_torch.ops.metrics import edit_distance
from asr_study_torch.parallel import dp

OPTIMIZERS = ("adam", "adamw", "rmsprop", "sgd")
# the cells whose recurrent kernels have bfloat16-weight forms
BF16_CELLS = (LSTMCell, GRUCell, LayerNormLSTMCell, ZoneoutLSTMCell,
              MILSTMCell)


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr)``: ``nu = decay * nu + (1 - decay) * g^2`` from
    zeros, then ``p -= lr * g / sqrt(nu + eps)``, eps inside the root, no
    momentum, no centring."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad,
                                                 value=1.0 - group["decay"])
                p.addcdiv_(p.grad, (nu + group["eps"]).sqrt(),
                           value=-group["lr"])


class Plateau:
    """``optax.contrib.reduce_on_plateau(factor, patience,
    accumulation_size=window)`` at rtol 1e-4, atol 0, cooldown 0 and
    min_scale 0, its state in device tensors: each update adds its loss to
    a running mean; the ``window``-th counts the window as improved only
    where ``mean < (1 - rtol) * best``, resets the mean, and at the
    ``patience``-th window in a row without improvement multiplies the
    scale by ``factor``.  :meth:`update` returns the scale that update
    and the next ones are multiplied by."""

    RTOL = 1e-4

    def __init__(self, factor: float, patience: int, window: int,
                 device: torch.device | str):
        self.factor, self.patience, self.window = factor, patience, window
        self.scale = torch.ones((), device=device)
        self.best = torch.full((), float("inf"), device=device)
        self.stale = torch.zeros((), dtype=torch.int32, device=device)
        self.mean = torch.zeros((), device=device)
        self.count = 0

    def update(self, value: torch.Tensor) -> torch.Tensor:
        count = self.count + 1
        self.mean = (self.mean * self.count + value.to(torch.float32)) \
            / count
        self.count = count
        if count == self.window:
            improved = self.mean < self.best * (1.0 - self.RTOL)
            self.best = torch.where(improved, self.mean, self.best)
            stale = torch.where(improved, 0, self.stale + 1)
            fire = stale == self.patience
            self.stale = torch.where(fire, 0, stale).to(torch.int32)
            self.scale = torch.where(fire, self.scale * self.factor,
                                     self.scale)
            self.mean = torch.zeros_like(self.mean)
            self.count = 0
        return self.scale

    def state_dict(self) -> Dict[str, Any]:
        return {"scale": self.scale, "best": self.best, "stale": self.stale,
                "mean": self.mean, "count": self.count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for k in ("scale", "best", "stale", "mean"):
            setattr(self, k, state[k].to(getattr(self, k).device))
        self.count = int(state["count"])


class GradAccumulator:
    """``optax.MultiSteps(every_k_schedule=k)``: the running mean ``acc +=
    (g - acc) / (n + 1)`` of the gradients of ``k`` micro-steps (a
    parameter without a gradient adds zeros), handed on at the last."""

    def __init__(self, params: Iterable[torch.Tensor], k: int):
        self.k = k
        self.grads = [torch.zeros_like(p) for p in params]
        self.mini_step = 0

    @torch.no_grad()
    def add(self, params: list) -> bool:
        """Fold the parameters' gradients in; at the k-th micro-step set
        each ``p.grad`` to the mean, reset, and return True."""
        n = self.mini_step
        for acc, p in zip(self.grads, params):
            g = p.grad if p.grad is not None else torch.zeros_like(acc)
            acc.add_((g - acc) / (n + 1))
        self.mini_step = (n + 1) % self.k
        if self.mini_step:
            return False
        for acc, p in zip(self.grads, params):
            p.grad = acc.clone()
            acc.zero_()
        return True

    def state_dict(self) -> Dict[str, Any]:
        return {"grads": self.grads, "mini_step": self.mini_step}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for acc, saved in zip(self.grads, state["grads"]):
            acc.copy_(saved)
        self.mini_step = int(state["mini_step"])


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What :func:`make_optimizer` chose; :meth:`build` binds it to
    parameters (a torch optimizer needs them, an optax transform does
    not)."""

    name: str
    lr: float
    clipnorm: float
    lr_decay: float
    decay_steps: int
    weight_decay: float = 0.0
    accum_steps: int = 1
    plateau_factor: float = 0.0
    plateau_patience: int = 0
    plateau_window: int = 1

    def build(self, params: Iterable[torch.Tensor]):
        """-> (the torch optimizer of the update rule, StepLR scheduler or
        None)"""
        if self.name == "adam":
            opt = torch.optim.Adam(params, lr=self.lr, betas=(0.9, 0.999),
                                   eps=1e-8)
        elif self.name == "adamw":
            opt = torch.optim.AdamW(params, lr=self.lr, betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=self.weight_decay)
        elif self.name == "sgd":
            opt = torch.optim.SGD(params, lr=self.lr, momentum=0.9)
        else:
            opt = RMSprop(params, lr=self.lr)
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
    """The JAX factory's choices and its checks (the module docstring
    says what each does).

    ``lr_decay`` in (0, 1) with ``decay_steps`` > 0 is staircase
    exponential decay indexed by the update count; ``weight_decay``
    reaches adamw only; ``accum_steps`` > 1 averages that many
    micro-batches' gradients into one update; ``plateau_factor`` in (0, 1)
    with ``plateau_patience`` > 0 scales the updates down when the loss
    averaged over ``plateau_window`` updates stops improving."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if plateau_factor and not 0.0 < plateau_factor < 1.0:
        raise ValueError(
            f"plateau_factor must be in (0, 1), got {plateau_factor}")
    if plateau_factor and plateau_patience <= 0:
        raise ValueError(
            f"plateau_factor={plateau_factor} needs plateau_patience > 0 "
            f"(got {plateau_patience})")
    if lr_decay:
        if not 0.0 < lr_decay < 1.0:
            raise ValueError(f"lr_decay must be in (0, 1), got {lr_decay}")
        if decay_steps <= 0:
            raise ValueError(
                f"lr_decay={lr_decay} needs decay_steps > 0 (got "
                f"{decay_steps}) — silently ignoring the decay would train "
                "at constant lr")
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; have "
                         f"{sorted(OPTIMIZERS)}")
    return OptimizerSpec(
        name, float(lr), float(clipnorm or 0.0), float(lr_decay),
        int(decay_steps), float(weight_decay if name == "adamw" else 0.0),
        int(accum_steps), float(plateau_factor or 0.0),
        int(plateau_patience), max(1, int(plateau_window)))


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer (and rate schedule, plateau and gradient
    accumulator where the spec has them) and the step count; ``train_step``
    updates all of them in place."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[Any]
    step: int = 0
    plateau: Optional[Plateau] = None
    accum: Optional[GradAccumulator] = None

    def state_dict(self) -> Dict[str, Any]:
        state = {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": (self.scheduler.state_dict()
                          if self.scheduler is not None else None),
            "step": self.step,
        }
        for key in ("plateau", "accum"):
            if getattr(self, key) is not None:
                state[key] = getattr(self, key).state_dict()
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(state["scheduler"])
        for key in ("plateau", "accum"):
            if getattr(self, key) is not None and key in state:
                getattr(self, key).load_state_dict(state[key])
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
    needs the featurizer.  ``check_nans`` stops training with
    ``FloatingPointError`` at the first non-finite loss or gradient norm.
    ``compute_dtype`` ``torch.bfloat16`` runs the train step in mixed
    precision (the module docstring); a model holding a cell other than
    those of :data:`BF16_CELLS` refuses it.  ``group`` (a
    ``parallel.dp.DataGroup`` on the model's device) makes the steps
    data-parallel, as the JAX trainer's ``mesh=``, and tensor-parallel
    where the group has a model group of more than one shard."""

    def __init__(self, model: nn.Module, optimizer: OptimizerSpec,
                 augment=None, featurizer=None, wav_augment=None,
                 check_nans: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 group: Optional[dp.DataGroup] = None):
        if wav_augment is not None and featurizer is None:
            raise ValueError(
                "wav_augment operates on raw waveforms and needs "
                "featurizer= (the inputs are features otherwise)"
            )
        if compute_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be torch.bfloat16 or None, "
                             f"got {compute_dtype}")
        if compute_dtype == torch.bfloat16:
            others = sorted({type(m).__name__ for m in model.modules()
                             if isinstance(m, (LSTMCell, GRUCell))
                             and type(m) not in BF16_CELLS})
            if others:
                raise ValueError(
                    f"compute_dtype=torch.bfloat16: the bfloat16 kernels "
                    f"cover {', '.join(c.__name__ for c in BF16_CELLS)} "
                    f"only, and this model holds {', '.join(others)}, a "
                    f"cell with no bfloat16 kernels")
        self.compute_dtype = (compute_dtype if compute_dtype == torch.bfloat16
                              else None)
        self.model = model
        if group is not None and group.device != self.device:
            raise ValueError(f"the model is on {self.device}, its data "
                             f"group's rank {group.rank} on {group.device}")
        self.group = group
        # (model group, shards) where the group is tensor-parallel
        self.tp = group.tp if group is not None else None
        self.spec = optimizer
        self.augment = augment
        self.featurizer = featurizer
        self.wav_augment = wav_augment
        self.check_nans = check_nans

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def init_state(self) -> TrainState:
        spec = self.spec
        opt, sched = spec.build(self.model.parameters())
        plateau = accum = None
        if spec.plateau_factor:
            plateau = Plateau(spec.plateau_factor, spec.plateau_patience,
                              spec.plateau_window, self.device)
        if spec.accum_steps > 1:
            accum = GradAccumulator(self.model.parameters(),
                                    spec.accum_steps)
        if self.group is not None:
            # every rank (both axes of a TP layout) starts from rank 0's
            # weights
            with torch.no_grad():
                params = list(self.model.parameters())
                flat = dp.broadcast(self.group, torch.cat(
                    [p.reshape(-1) for p in params]))
                for p, v in zip(params, flat.split(
                        [p.numel() for p in params])):
                    p.copy_(v.view_as(p))
        return TrainState(self.model, opt, sched, 0, plateau, accum)

    def local_batch(self, batch) -> tuple[torch.Tensor, ...]:
        """A host ``Batch`` -> this rank's rows of it on the device
        (``parallel.dp.shard_rows``; the whole batch without a group), as
        :func:`device_batch` puts them."""
        if self.group is not None:
            batch = dp.shard_rows(batch, self.group.rank, self.group.world)
        return device_batch(batch, self.device)

    def _psum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data group's ranks, in place (the identity
        without a group)."""
        return t if self.group is None else dp.all_reduce_sum(self.group, t)

    def _loss_sum(self, logits, input_lengths, labels, label_lengths,
                  weights) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (the weighted sum of the per-sequence CTC losses, the sum of
        the weights) of this rank's rows."""
        per_seq = ctc.ctc_loss(logits, input_lengths, labels, label_lengths,
                               blank_id=self.model.blank_id)
        w = weights.to(torch.float32)
        return (per_seq * w).sum(), w.sum()

    def _reduce_grads(self, params: list, loss_sum: torch.Tensor,
                      w_sum: torch.Tensor) -> torch.Tensor:
        """After the backward of the local loss sum: the gradients, the
        loss sum and the weight sum summed over the group in one flat
        float32 buffer (gradients in parameter order, then the two sums;
        one all-reduce; nothing without a group), then each gradient
        divided by ``max(weight sum, 1)`` -> the weighted mean loss."""
        if self.group is not None:
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            flat = self._psum(torch.cat(
                [p.grad.reshape(-1) for p in params]
                + [loss_sum.reshape(1), w_sum.reshape(1)]))
            for p, g in zip(params, flat[:-2].split(
                    [p.numel() for p in params])):
                p.grad = g.view_as(p)
            loss_sum, w_sum = flat[-2], flat[-1]
        denom = torch.clamp(w_sum, min=1.0)
        torch._foreach_div_([p.grad for p in params if p.grad is not None],
                            denom)
        return loss_sum / denom

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
        """One update on this rank's rows (the whole batch without a
        group).  Returns the state (updated in place) and the step's
        ``loss`` (weighted mean over the global batch) and ``grad_norm``
        (before the clip), as device scalars: nothing is fetched to the
        host.

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
        if self.compute_dtype is None:
            logits = model(inputs, input_lengths, train=True,
                           generator=generator, tp=self.tp)
        else:
            logits = self._forward_cast(model, inputs, input_lengths,
                                        generator)
        loss_sum, w_sum = self._loss_sum(logits, input_lengths, labels,
                                         label_lengths, weights)
        loss_sum.backward()
        loss = self._reduce_grads(list(model.parameters()),
                                  loss_sum.detach(), w_sum)
        gnorm = self.apply_gradients(state, loss)
        return state, {"loss": loss, "grad_norm": gnorm}

    def _forward_cast(self, model: nn.Module, inputs: torch.Tensor,
                      input_lengths: torch.Tensor,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
        """The train-mode forward in ``compute_dtype``: the model on its
        floating parameters cast (differentiably, so each gradient reaches
        its float32 master) and on the inputs rounded to it (held as
        float32: every use either rounds them again or adds them to
        float32, as the JAX cast's bfloat16 inputs are used); the logits
        float32 for the CTC loss."""
        dt = self.compute_dtype
        params = {n: p.to(dt) if p.is_floating_point() else p
                  for n, p in model.named_parameters()}
        if inputs.is_floating_point():
            inputs = inputs.to(dt).to(inputs.dtype)
        logits = torch.func.functional_call(
            model, params, (inputs, input_lengths),
            dict(train=True, generator=generator, tp=self.tp))
        return logits.float()

    def apply_gradients(self, state: TrainState,
                        loss: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """Count the step and apply the model's gradients: with an
        accumulator, fold them in and go on only at its last micro-step;
        clip by global norm (in place), take the optimizer's update and
        the schedule step, and scale the update by the plateau's scale,
        which ``loss`` (the step's, a device scalar) moves.  Returns the
        norm of the step's own gradients, before any of that."""
        params = list(state.model.parameters())
        grads = [p.grad for p in params if p.grad is not None]
        gnorm = global_norm(grads)
        if self.check_nans:
            bad = not bool(torch.isfinite(gnorm)) or (
                loss is not None and not bool(torch.isfinite(loss)))
            if bad:
                raise FloatingPointError(
                    f"step {state.step}: loss "
                    f"{'-' if loss is None else float(loss)}, grad norm "
                    f"{float(gnorm)}: not finite (check_nans; the weights "
                    "are those before this step)")
        state.step += 1
        if state.accum is not None:
            if not state.accum.add(params):
                return gnorm
            grads = [p.grad for p in params]
        if self.spec.clipnorm > 0:
            norm = gnorm if state.accum is None else global_norm(grads)
            scale = torch.where(norm < self.spec.clipnorm, 1.0,
                                self.spec.clipnorm / norm)
            for g in grads:
                g.mul_(scale)
        if state.plateau is not None:
            if loss is None:
                raise ValueError("reduce-on-plateau needs the step's loss")
            before = [p.detach().clone() for p in params]
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        if state.plateau is not None:
            scale = state.plateau.update(loss)
            with torch.no_grad():
                for p, b in zip(params, before):
                    p.sub_(b).mul_(scale).add_(b)
        return gnorm

    @torch.no_grad()
    def eval_step(self, state: TrainState, inputs: torch.Tensor,
                  input_lengths: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor, weights: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        """Loss, greedy decode and edit distance of this rank's rows, their
        sums over the group (one all-reduce), as device scalars."""
        model = state.model
        inputs, input_lengths = self._featurize(inputs, input_lengths)
        logits = model(inputs, input_lengths, train=False, tp=self.tp)
        loss_sum, num = self._loss_sum(logits, input_lengths, labels,
                                       label_lengths, weights)
        decoded, dec_lens = ctc.greedy_decode(logits, input_lengths,
                                              blank_id=model.blank_id)
        dist = edit_distance(decoded, dec_lens, labels,
                             label_lengths).to(torch.float32)
        w = weights.to(torch.float32)
        edit, chars, loss_sum, num = self._psum(torch.stack([
            (dist * w).sum(), (label_lengths.to(torch.float32) * w).sum(),
            loss_sum, num]))
        return {
            "loss": loss_sum / torch.clamp(num, min=1.0),
            "edit_dist": edit,
            "label_chars": torch.clamp(chars, min=1.0),
            "num_seqs": num,
        }

    def run_eval(self, state: TrainState, batches) -> Dict[str, float]:
        """Greedy-decode LER and loss over host batches (each rank its rows
        of each, every batch's sums all-reduced), summed on the device and
        fetched once at the end."""
        acc = None
        for b in batches:
            out = self.eval_step(state, *self.local_batch(b))
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
