"""The port's side of tests/test_torch_tp.py (and of the tensor-parallel
test of tests/test_torch_gpu.py): what each rank of a ``(data, model)``
layout (``parallel.dp.launch(..., tp=m)``) runs.  Imports no JAX: the
ranks are spawned processes.

``rank_main(group, cases)`` runs every case in order (the ranks'
collectives meet in that order).  A case is a dict with ``kind``:

- ``"step"``: ``dp_ranks.run_case`` of the rest of the dict (train steps,
  the eval step), the model tensor-parallel on the group;
- ``"forward"``: the logits of ``model`` / ``hp`` from ``flat`` on
  ``dp_ranks.host_batch(seed)`` in eval mode, tensor-parallel;
- ``"eval"``: the eval step from ``flat`` on this rank's rows of
  ``dp_ranks.host_batch(seed)``, its sums over the data group;
- ``"slice"``: the gradient of ``sum(tp_slice(w) ** 2)`` for a seeded ``w``
  [3, 8] of two gate blocks, and ``w`` itself.
"""

import numpy as np
import torch

import dp_ranks as R
from asr_study_torch.models.zoo import build_model
from asr_study_torch.parallel.tp import tp_slice
from asr_study_torch.utils.weights import params_from_flat


def slice_grad(group) -> dict:
    """tp_slice's gradient of sum(loc * loc) on this rank: 2 w, whole, on
    every model rank."""
    w = torch.from_numpy(np.random.RandomState(0).randn(3, 8).astype(
        np.float32)).requires_grad_()
    loc = tp_slice(w, 2, group.model, group.model.world)
    (loc * loc).sum().backward()
    return {"w": w.detach().numpy(), "grad": w.grad.numpy(),
            "loc_shape": tuple(loc.shape)}


def forward(case: dict, group=None) -> np.ndarray:
    """The case's eval-mode logits on the whole batch, tensor-parallel on
    ``group`` (one process without it)."""
    device = group.device if group is not None else "cpu"
    model = build_model(case["model"], case["hp"], num_classes=R.CLASSES,
                        input_dim=R.FEATS, device=device)
    model.load_state_dict(params_from_flat(case["flat"], device))
    b = R.host_batch(case["seed"])
    with torch.no_grad():
        logits = model(torch.from_numpy(b.inputs).to(device),
                       torch.from_numpy(b.input_lengths).to(device),
                       tp=group.tp if group is not None else None)
    return logits.cpu().numpy()


def evaluate(case: dict, group=None) -> dict:
    """The eval step of the case's weights, no step before it."""
    trainer = R.make_trainer(case, group)
    out = trainer.eval_step(trainer.init_state(), *trainer.local_batch(
        R.host_batch(case["seed"])))
    return {k: float(v) for k, v in out.items()}


def rank_main(group, cases: dict) -> dict:
    """Every case in order -> {case name: its result on this rank}."""
    torch.set_num_threads(1)
    out = {}
    for name, case in cases.items():
        kind = case["kind"]
        if kind == "slice":
            out[name] = slice_grad(group)
        elif kind == "forward":
            out[name] = forward(case, group)
        elif kind == "eval":
            out[name] = evaluate(case, group)
        else:
            out[name] = R.run_case(case, group)
    return out
