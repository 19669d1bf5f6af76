"""Self-describing, resumable checkpoints (port of
``asr_study_tpu/train/checkpoint.py``).

Same directory roles as the JAX manager, with ``torch.save`` of the
:class:`TrainState` state dict (model, optimizer, schedule, step) in place
of Orbax::

    <dir>/ckpt/<step>/state.pt   latest checkpoints (recency retention)
    <dir>/best/<step>/state.pt   the best by ``best_metric``
    <dir>/meta.json              {hparams, history, last_step}

'latest' and 'best' are separate retention domains, so a newer but worse
checkpoint never displaces resume-from-latest.  Saves are synchronous.

Under data parallelism (``group=``, a ``parallel.dp.DataGroup``) rank 0
writes and a barrier follows, so every rank restores the same files.  A
checkpoint holds no topology: a run saved under N ranks resumes on one,
and the reverse.
"""

from __future__ import annotations

import json
import math
import os
import shutil
from typing import Any, Dict, Mapping, Optional

import torch

from asr_study_torch.parallel import dp
from asr_study_torch.train.trainer import TrainState

_FILE = "state.pt"


def _steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    return sorted(int(d) for d in os.listdir(root)
                  if d.isdigit() and os.path.exists(
                      os.path.join(root, d, _FILE)))


def _write(root: str, step: int, payload: Dict[str, Any],
           metrics: Dict[str, float]) -> None:
    """Write under a temporary name, then rename: a crash mid-save never
    leaves a step directory that looks complete."""
    final = os.path.join(root, str(step))
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, _FILE))
    with open(os.path.join(tmp, "metrics.json"), "w") as f:
        json.dump(metrics, f)
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)


class CheckpointManager:
    """Keeps ``latest`` (``max_to_keep`` newest) and ``best`` (one, by
    ``best_metric`` in ``mode`` 'min' or 'max'; a tie keeps the earlier)
    checkpoints under ``directory``; with a data ``group``, rank 0
    writes them."""

    def __init__(self, directory: str, max_to_keep: int = 2,
                 keep_best: bool = True, best_metric: str = "val_loss",
                 mode: str = "min", group: Optional[dp.DataGroup] = None):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.group = group
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.keep_best = keep_best
        self.best_metric = best_metric
        self.mode = mode
        self._latest_root = os.path.join(self.directory, "ckpt")
        self._best_root = os.path.join(self.directory, "best")
        os.makedirs(self._latest_root, exist_ok=True)
        if keep_best:
            os.makedirs(self._best_root, exist_ok=True)
        self._meta_path = os.path.join(self.directory, "meta.json")
        self.meta: Dict[str, Any] = {"history": [], "hparams": {}}
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self.meta = json.load(f)

    # -- save -------------------------------------------------------------
    def _best_value(self) -> Optional[float]:
        step = self.best_step
        if step is None:
            return None
        with open(os.path.join(self._best_root, str(step),
                               "metrics.json")) as f:
            return json.load(f).get(self.best_metric)

    def save(self, state: TrainState,
             metrics: Optional[Dict[str, float]] = None,
             hparams: Optional[Dict[str, Any]] = None) -> None:
        """Write ``state`` at its step (on rank 0 of a data group, the
        others waiting at a barrier until it is written)."""
        if self.group is None or self.group.lead:
            self._save(state, metrics, hparams)
        if self.group is not None:
            dp.barrier(self.group)

    def _save(self, state: TrainState, metrics: Optional[Dict[str, float]],
              hparams: Optional[Dict[str, Any]]) -> None:
        step = int(state.step)
        payload = state.state_dict()
        m = {k: float(v) for k, v in (metrics or {}).items()}
        _write(self._latest_root, step, payload, m)
        for old in _steps(self._latest_root)[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self._latest_root, str(old)))
        value = m.get(self.best_metric)
        if self.keep_best and value is not None and not math.isnan(value):
            best = self._best_value()
            better = best is None or (value < best if self.mode == "min"
                                      else value > best)
            if better:
                old = self.best_step
                _write(self._best_root, step, payload, m)
                if old is not None and old != step:
                    shutil.rmtree(os.path.join(self._best_root, str(old)))
        if hparams is not None:
            self.meta["hparams"] = dict(hparams)
        if metrics:
            self.meta["history"].append({"step": step, **m})
        self.meta["last_step"] = step
        with open(self._meta_path, "w") as f:
            json.dump(self.meta, f, indent=1)

    # -- restore ----------------------------------------------------------
    @property
    def latest_step(self) -> Optional[int]:
        steps = _steps(self._latest_root)
        return steps[-1] if steps else None

    @property
    def best_step(self) -> Optional[int]:
        steps = _steps(self._best_root) if self.keep_best else []
        return steps[-1] if steps else None

    def _load(self, step: Optional[int], best: bool,
              device: torch.device | str) -> Dict[str, Any]:
        root = self._latest_root
        if step is None:
            if best:
                step = self.best_step
                if step is None:
                    raise FileNotFoundError(
                        f"no BEST checkpoint under {self.directory} (was "
                        "the run trained without a validation metric?)")
                root = self._best_root
            else:
                step = self.latest_step
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}")
        path = os.path.join(root, str(step), _FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint at {path}")
        return torch.load(path, map_location=device, weights_only=True)

    def restore(self, state: TrainState, step: Optional[int] = None,
                best: bool = False) -> TrainState:
        """Load model, optimizer, schedule and step into ``state`` (in
        place, on its model's device) and return it."""
        device = next(state.model.parameters()).device
        state.load_state_dict(self._load(step, best, device))
        return state

    def restore_params(self, params: Mapping[str, torch.Tensor],
                       step: Optional[int] = None, best: bool = False
                       ) -> Dict[str, torch.Tensor]:
        """Warm start: ONLY the model weights, in the structure of
        ``params`` (a model ``state_dict``); the saved optimizer state is
        ignored.  Keys and shapes must match exactly."""
        saved = self._load(step, best, "cpu")["model"]
        if list(saved) != list(params):
            raise ValueError(
                f"param tree mismatch restoring from {self.directory}: "
                f"checkpoint has {sorted(saved)}, the model expects "
                f"{sorted(params)} — different architecture?")
        out = {}
        for key, want in params.items():
            got = saved[key]
            if tuple(got.shape) != tuple(want.shape):
                raise ValueError(
                    f"param shape mismatch restoring {key!r} from "
                    f"{self.directory}: checkpoint {tuple(got.shape)} vs "
                    f"model {tuple(want.shape)}")
            out[key] = got.to(device=want.device, dtype=want.dtype)
        return out
