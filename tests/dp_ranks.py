"""The port's side of tests/test_torch_dp.py (and of the data-parallel
tests of tests/test_torch_gpu.py): data-parallel train and eval steps
described by plain dicts, run by each rank of a group (``rank_main``) or
by one process without a group (``run_case``, the one-device reference).
Imports no JAX: the ranks are spawned processes.

A case is a dict:

- ``model``, ``hp``: a zoo model and its hparams;
- ``device``: where a run without a group puts it (default the CPU; a
  rank puts it on its group's device);
- ``flat``: its initial weights (tree-path keyed arrays) or None for the
  port's seeded ones;
- ``spec``: ``make_optimizer``'s positional arguments;
- ``batches``: the global batches, ``(seed, weights or None)`` each;
- ``bf16``: compute in bfloat16;
- ``resume`` / ``save``: a run directory to restore from before the steps
  / to save into after them;
- ``eval``: also the eval step on the first batch and ``run_eval`` on two;
- ``masks``: also a dropout mask drawn from the step generator of
  (seed 0, step 3, this rank).
"""

import numpy as np
import torch

from asr_study_torch.data.generator import Batch
from asr_study_torch.models.nn import dropout
from asr_study_torch.models.zoo import build_model
from asr_study_torch.train.checkpoint import CheckpointManager
from asr_study_torch.train.loop import step_generator
from asr_study_torch.train.trainer import Trainer, make_optimizer
from asr_study_torch.utils.weights import flat_from_params, params_from_flat

FEATS, CLASSES, SEED = 5, 4, 0
# 5 real rows of 8: on 4 ranks rank 2 holds one, rank 3 only padding
RAGGED = (1, 1, 1, 1, 1, 0, 0, 0)


def host_batch(seed: int, weights=None, b: int = 8, t: int = 12,
               l: int = 3) -> Batch:
    """A seeded batch of ragged frames and labels (all rows weighted
    unless ``weights``)."""
    rng = np.random.RandomState(seed)
    return Batch(rng.randn(b, t, FEATS).astype(np.float32),
                 rng.randint(t // 2, t + 1, b).astype(np.int32),
                 rng.randint(0, CLASSES, (b, l)).astype(np.int32),
                 rng.randint(1, l + 1, b).astype(np.int32),
                 np.asarray(np.ones(b) if weights is None else weights,
                            np.float32))


def make_trainer(case: dict, group=None) -> Trainer:
    device = group.device if group is not None else case.get("device",
                                                             "cpu")
    model = build_model(case["model"], case["hp"], num_classes=CLASSES,
                        input_dim=FEATS,
                        generator=torch.Generator().manual_seed(SEED),
                        device=device)
    if case.get("flat") is not None:
        model.load_state_dict(params_from_flat(case["flat"], device))
    return Trainer(model, make_optimizer(*case["spec"]), group=group,
                   compute_dtype=torch.bfloat16 if case.get("bf16")
                   else None)


def run_case(case: dict, group=None) -> dict:
    """The case's steps -> {"losses", "grad_norms", "grads" (each
    parameter's gradient as the first step applied it), "params" (after
    the last step), "step"} and, where asked, "eval", "run_eval",
    "mask"."""
    rank = group.rank if group is not None else 0
    trainer = make_trainer(case, group)
    state = trainer.init_state()
    if case.get("resume"):
        CheckpointManager(case["resume"], group=group).restore(state)
    out = {"losses": [], "grad_norms": []}
    for k, (seed, weights) in enumerate(case["batches"]):
        batch = trainer.local_batch(host_batch(seed, weights))
        state, m = trainer.train_step(
            state, *batch, step_generator(trainer.device, SEED, state.step,
                                          rank=rank))
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        if k == 0:
            out["grads"] = flat_from_params(
                {n: p.grad for n, p in state.model.named_parameters()})
    if case.get("save"):
        CheckpointManager(case["save"], group=group).save(
            state, metrics={"val_loss": 1.0})
    out["params"] = flat_from_params(state.model.state_dict())
    out["step"] = state.step
    if case.get("eval"):
        seed, weights = case["batches"][0]
        got = trainer.eval_step(state, *trainer.local_batch(
            host_batch(seed, weights)))
        out["eval"] = {k: float(v) for k, v in got.items()}
        out["run_eval"] = trainer.run_eval(
            state, [host_batch(seed, weights), host_batch(seed + 1)])
    if case.get("masks"):
        out["mask"] = dropout(torch.ones(4, 16), 0.5, True,
                              step_generator("cpu", SEED, 3,
                                             rank=rank)).numpy()
    return out


def rank_main(group, cases: dict) -> dict:
    """Every case in order (the ranks' collectives meet in that order) ->
    {case name: run_case's result on this rank}."""
    torch.set_num_threads(1)
    return {name: run_case(case, group) for name, case in cases.items()}


def raise_on_rank_one(group) -> None:
    """Rank 1 raises while rank 0 waits for it in an all-reduce."""
    if group.rank == 1:
        raise ValueError("rank one gives up")
    torch.distributed.all_reduce(torch.ones(1))
