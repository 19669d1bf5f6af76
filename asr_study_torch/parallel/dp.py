"""Data parallelism over ``torch.distributed``: one process a rank, the
parameters replicated, the rows of each global batch split among the ranks
(port of the 1-D ``data`` mesh and ``shard_map`` plumbing of
``asr_study_tpu/train/trainer.py``: ``make_mesh``, ``P("data")``,
``_psum``).

    results = launch(fn, ["cuda:0", "cuda:1"])       # nccl
    results = launch(fn, ["cpu"] * 4)                # gloo

:func:`launch` starts one process a device with the ``spawn`` context.
They meet through a ``file://`` store in a fresh temporary directory (no
TCP port, so concurrent launches cannot collide), and each calls ``fn(group,
*args)`` with its :class:`DataGroup`; ``launch`` returns the ranks' return
values in rank order.  A rank that raises ends the launch: the others are
stopped and :class:`RankError` carries that rank's traceback.  The process
group has a timeout (:data:`TIMEOUT`), so a rank whose peer died fails
instead of hanging.

The backend is explicit: ``nccl`` for CUDA devices, ``gloo`` for the CPU
(:data:`BACKENDS`).  ``gloo`` on a CUDA device (it stages the tensors
through the host) is taken only where ``backend="gloo"`` is passed, as
``chip_smoke.py`` does to run two ranks on one card; it is never a fall
back.

A train step reduces one flat float32 buffer (:func:`all_reduce_sum`): the
gradients of the local weighted loss **sum** in parameter order, then the
loss sum and the weight sum; the trainer divides by ``max(weight sum, 1)``
after it, so a step on N ranks is the step on the whole batch, zero-weight
padding rows wherever they land.

With ``tp`` > 1 (``train --tp_devices``) the ranks form the JAX trainer's
2-D ``(data, model)`` mesh: ``launch(fn, devices, tp=m)`` on ``n * m``
devices makes global rank ``d * m + k`` shard ``k`` of model group ``d``
and rank ``d`` of data group ``k``.  Each rank's :class:`DataGroup` then
carries its data index and count (``rank``, ``world``, what
:func:`shard_rows` and the step generators read), its data group ``pg``
(the gradients' all-reduce: the ranks that share a model index) and its
:class:`ModelGroup` (the ranks that share a data index, on which
``parallel/tp.py`` shards the recurrence); both groups are made with
``dist.new_group``.  :func:`broadcast` and :func:`barrier` reach every
rank, and :attr:`DataGroup.lead` (global rank 0) writes and prints.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import multiprocessing.connection
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# how long a collective waits for its peers before it fails
TIMEOUT = datetime.timedelta(minutes=10)
# how long the other ranks get to stop after one failed
_STOP_GRACE_S = 5.0


class RankError(RuntimeError):
    """A rank of :func:`launch` raised, died or outlived the join timeout."""


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """This process's place in its tensor-parallel group (the JAX mesh's
    ``model`` axis): its shard index, the shard count, the process group
    and its backend."""

    rank: int
    world: int
    pg: Any
    backend: str


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """This process's place in the data-parallel group: its rank, the
    group's size, its device and the process group its collectives run
    on; with tensor parallelism, also its :class:`ModelGroup`."""

    rank: int
    world: int
    device: torch.device
    backend: str
    pg: Any = None
    model: Optional[ModelGroup] = None

    @property
    def lead(self) -> bool:
        """Global rank 0: the one that writes and prints."""
        return self.rank == 0 and (self.model is None or self.model.rank == 0)

    @property
    def tp(self) -> Optional[tuple]:
        """``(model group, shards)`` for the model's ``tp=`` (the JAX
        trainer's ``_tp``), or None without tensor parallelism."""
        if self.model is None or self.model.world <= 1:
            return None
        return self.model, self.model.world


def make_group(rank: int, world: int, device: torch.device | str,
               init_file: str, backend: Optional[str] = None,
               tp: int = 1) -> DataGroup:
    """Join the group of ``world`` ranks of this host that meets at the
    file store ``init_file`` (the counterpart of ``make_mesh``);
    ``backend`` None takes :data:`BACKENDS` of the device's type.  With
    ``tp`` > 1, ``world / tp`` data ranks of ``tp`` model shards each
    (the module docstring)."""
    device = torch.device(device)
    backend = backend or BACKENDS[device.type]
    # the ranks are processes of this host: the loopback device, and no
    # lookup of the host's name (which can wait on a name server)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world % tp:
        raise ValueError(f"{world} ranks do not split into model groups "
                         f"of {tp}")
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world, timeout=TIMEOUT)
    if tp == 1:
        return DataGroup(rank, world, device, backend, dist.group.WORLD)
    # every rank makes every group, in the same order
    n_data = world // tp
    data_pgs = [dist.new_group([d * tp + k for d in range(n_data)])
                for k in range(tp)]
    model_pgs = [dist.new_group(list(range(d * tp, (d + 1) * tp)))
                 for d in range(n_data)]
    d, k = divmod(rank, tp)
    return DataGroup(d, n_data, device, backend, data_pgs[k],
                     ModelGroup(k, tp, model_pgs[d], backend))


def all_reduce_sum(group: DataGroup, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place -> ``t``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group.pg)
    return t


def broadcast(group: DataGroup, t: torch.Tensor, src: int = 0
              ) -> torch.Tensor:
    """Global rank ``src``'s ``t`` on every rank of the launch (both axes
    of a ``(data, model)`` layout), in place -> ``t``."""
    dist.broadcast(t, src)
    return t


def all_gather_rows(group: DataGroup, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) stacked along dim 0 in
    rank order: a sharded batch's rows back in global order."""
    parts = [torch.empty_like(t) for _ in range(group.world)]
    dist.all_gather(parts, t.contiguous(), group=group.pg)
    return torch.cat(parts)


def barrier(group: DataGroup) -> None:
    """Wait until every rank of the launch got here (an all-reduce of one
    element on the group's device, the same on every backend)."""
    dist.all_reduce(torch.zeros(1, device=group.device))


def shard_rows(batch, rank: int, world: int):
    """Rank ``rank``'s rows ``[rank * B / world, (rank + 1) * B / world)``
    of a global ``data.generator.Batch``, as ``P("data")`` shards it:
    padding and T stay the global batch's (None fields stay None)."""
    if batch.size % world:
        raise ValueError(f"a batch of {batch.size} rows does not split "
                         f"among {world} ranks")
    n = batch.size // world
    rows = slice(rank * n, (rank + 1) * n)
    return dataclasses.replace(batch, **{
        f.name: None if getattr(batch, f.name) is None
        else getattr(batch, f.name)[rows]
        for f in dataclasses.fields(batch)})


def _rank_main(fn: Callable, args: tuple, rank: int, devices: list,
               backend: Optional[str], tmp: str, tp: int = 1) -> None:
    """One rank of :func:`launch`: join the group, run ``fn``, write its
    return value (or this rank's traceback) under ``tmp``."""
    try:
        device = torch.device(devices[rank])
        if device.type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // len(devices)))
        group = make_group(rank, len(devices), device,
                           os.path.join(tmp, "store"), backend, tp)
        out = fn(group, *args)
        path = os.path.join(tmp, f"rank{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".tmp", path)
        dist.destroy_process_group()
    except (Exception, SystemExit) as e:     # a CLI's refusal is the latter
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(str(e.code) if isinstance(e, SystemExit)
                    else traceback.format_exc())
        # no interpreter shutdown: a process group whose peers are gone
        # can block it
        os._exit(1)


def _wait(procs: list, join_timeout: Optional[float]) -> Optional[str]:
    """Until every rank ended well (None), one failed ("failed") or the
    join timeout passed ("timeout")."""
    deadline = (None if join_timeout is None
                else time.monotonic() + join_timeout)
    while True:
        codes = [p.exitcode for p in procs]
        if any(c not in (None, 0) for c in codes):
            return "failed"
        if all(c == 0 for c in codes):
            return None
        left = None if deadline is None else deadline - time.monotonic()
        if left is not None and left <= 0:
            return "timeout"
        mp.connection.wait([p.sentinel for p, c in zip(procs, codes)
                            if c is None], timeout=left)


def _stop(procs: list) -> None:
    procs = [p for p in procs if p.pid is not None]       # started
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(_STOP_GRACE_S)
        if p.is_alive():
            p.kill()
            p.join()


def _failure(procs: list, tmp: str, why: str,
             join_timeout: Optional[float]) -> str:
    """The message of a failed launch: the first rank's traceback to be
    written (the others' errors usually follow from it)."""
    errs = sorted((os.stat(os.path.join(tmp, f)).st_mtime_ns, f)
                  for f in os.listdir(tmp) if f.endswith(".err"))
    world = len(procs)
    if errs:
        name = errs[0][1]
        with open(os.path.join(tmp, name)) as f:
            return (f"rank {name[4:-4]} of {world} failed:\n"
                    f"{f.read().rstrip()}")
    if why == "timeout":
        alive = [r for r, p in enumerate(procs) if p.exitcode is None]
        return (f"ranks {alive} of {world} still running after "
                f"{join_timeout} s (join timeout)")
    bad = [(r, p.exitcode) for r, p in enumerate(procs)
           if p.exitcode not in (None, 0)]
    return f"rank {bad[0][0]} of {world} exited with code {bad[0][1]}"


def launch(fn: Callable, devices: Sequence[torch.device | str],
           args: tuple = (), backend: Optional[str] = None,
           join_timeout: Optional[float] = None, tp: int = 1) -> list:
    """Run ``fn(group, *args)`` in one spawned process a device (rank r on
    ``devices[r]``) -> the ranks' return values in rank order.  ``tp`` > 1
    lays the ranks out as ``len(devices) / tp`` data ranks of ``tp`` model
    shards (:func:`make_group`).

    ``fn`` and ``args`` are pickled (``fn`` by its import path), and so are
    the return values.  A CPU rank uses ``cores // len(devices)`` threads.
    :data:`TIMEOUT` bounds each collective, ``join_timeout`` (None: no
    bound) the whole launch.  Raises :class:`RankError` with the failing rank's
    traceback when a rank raises or dies, after stopping the others."""
    devices = [str(torch.device(d)) for d in devices]
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="asr_dp_") as tmp:
        procs = [ctx.Process(target=_rank_main, name=f"asr-dp-rank{r}",
                             args=(fn, tuple(args), r, devices, backend,
                                   tmp, tp))
                 for r in range(len(devices))]
        try:
            for p in procs:
                p.start()
            why = _wait(procs, join_timeout)
        finally:
            _stop(procs)
        if why is not None:
            raise RankError(_failure(procs, tmp, why, join_timeout))
        out = []
        for r in range(len(devices)):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
