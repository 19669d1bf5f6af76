"""What the recurrence ops (``ops/bilstm.py``, ``ops/gru.py``,
``ops/ln_lstm.py``, ``ops/zoneout_lstm.py``, ``ops/mi_lstm.py``) share
around their kernels: the argument check (and those of the residual the
wide designs' forwards hand their backwards and of the state a
unidirectional forward carries in), the stream, the
scan-previous state of a sequence, the cotangent of an unused output, and
the fit rules of the cluster-resident kernels (the LSTM's, the GRU's, the
layer-norm, zoneout and MI LSTMs'; the wide rule, the LSTM's and the
GRU's).  Every design of every cell has its bfloat16-weight form."""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from asr_study_torch import _build


# The fit rule.  A cluster of CLUSTER_CTAS CTAs (the portable maximum) per
# (direction, group of `rows` batch rows); CTA k owns ceil(H / 8) hidden units
# and all their gate columns, and keeps wh[:, those columns] resident: each
# of its threads holds a slice of `slice_rows` rows of one column in
# registers (so gates * U * ceil(H / slice_rows) <= threads), and the
# backward a copy in shared memory.  The launch may hold at most
# CLUSTER_BUDGET clusters, all resident at once: the kernels check that on
# the card (cudaOccupancyMaxActiveClusters) and refuse otherwise.  An H100
# SXM holds 15 clusters of 8 CTAs of these kernels (one CTA an SM; a
# cluster stays inside one GPC, and the GPCs' SM counts vary from die to
# die), so the budget keeps a margin of 3.  `rows` is the least of
# CLUSTER_ROWS that keeps the launch within the budget.
CLUSTER_CTAS = 8
CLUSTER_BUDGET = 12
CLUSTER_ROWS = (1, 2, 4, 8)
SMEM_LIMIT = 232_448         # dynamic shared memory a block can use, H100
STREAM_ROWS = 4              # batch rows per block of the stream design

# The wide rule (256 < H <= WIDE_MAX_HIDDEN, where a CTA's slice at 8 CTAs
# fits nowhere): a non-portable cluster of ceil(H / WIDE_UNITS) CTAs (16 at
# H=512) per (direction, group of `rows` batch rows), CTA k owning the
# WIDE_UNITS units [32k, 32k + 32) and their gate columns, its 512-row slice
# in registers and shared memory (the LSTM's half and half; the GRU's by its
# thread shape, ops/gru.py GRU_WIDE_SPLIT).  `rows` is the least of
# WIDE_ROWS that keeps the launch within WIDE_BUDGET clusters, all resident
# at once; an H100 SXM holds 7 clusters of 16 such CTAs (PERF.md), so the
# budget keeps a margin of 1 and a bidirectional B=32 launch takes 4.
WIDE_UNITS = 32
WIDE_MAX_HIDDEN = 512
WIDE_BUDGET = 6
WIDE_ROWS = (4, 8, 16)

CLUSTER_MAX_HIDDEN = 256     # the widest H the cluster design takes

class Geometry(NamedTuple):
    """How one launch of a recurrence's kernels is laid out."""
    design: str                     # "cluster", "wide" or "stream"
    ctas: int                       # CTAs per cluster (1: stream)
    units: int                      # hidden units per CTA
    rows: int                       # batch rows per cluster (stream: block)
    grid: tuple[int, int, int]      # (ctas, row groups, ndir)
    smem_fwd: int                   # dynamic shared memory per CTA, bytes
    smem_bwd: int


def r4(n: int) -> int:
    """``n`` rounded up to a multiple of 4 (a float4)."""
    return -(-n // 4) * 4


def cluster_geometry(hidden: int, batch: int, ndir: int, gates: int,
                     threads: int, slice_rows: int,
                     smem: Callable[[int, int, int, int], tuple[int, int]]
                     ) -> Geometry | None:
    """The cluster design's layout for a cell of ``gates`` gate columns a
    unit whose kernels run ``threads`` threads a CTA of ``slice_rows`` rows
    of a column each, or None where it does not fit: where a CTA's threads
    cannot hold its slice in registers, no row count of CLUSTER_ROWS keeps
    the launch within CLUSTER_BUDGET clusters, or the kernels' shared
    memory, ``smem(hidden, units, rows, ctas) -> (forward, backward)``
    bytes, exceeds SMEM_LIMIT at that row count."""
    units = -(-hidden // CLUSTER_CTAS)
    ctas = -(-hidden // units)
    if gates * units * -(-hidden // slice_rows) > threads:
        return None
    for rows in CLUSTER_ROWS:
        groups = -(-batch // rows)
        if ndir * groups <= CLUSTER_BUDGET:
            fwd, bwd = smem(hidden, units, rows, ctas)
            if max(fwd, bwd) > SMEM_LIMIT:
                return None
            return Geometry("cluster", ctas, units, rows,
                            (ctas, groups, ndir), fwd, bwd)
    return None


def wide_geometry(hidden: int, batch: int, ndir: int,
                  smem: Callable[[int, int], tuple[int, int]]
                  ) -> Geometry | None:
    """The wide design's layout, or None where it does not fit: outside
    256 < H <= WIDE_MAX_HIDDEN, where no row count of WIDE_ROWS keeps the
    launch within WIDE_BUDGET clusters, or where the kernels' shared memory,
    ``smem(rows, ctas) -> (forward, backward)`` bytes, exceeds SMEM_LIMIT."""
    if not CLUSTER_MAX_HIDDEN < hidden <= WIDE_MAX_HIDDEN:
        return None
    ctas = -(-hidden // WIDE_UNITS)
    for rows in WIDE_ROWS:
        groups = -(-batch // rows)
        if ndir * groups <= WIDE_BUDGET:
            fwd, bwd = smem(rows, ctas)
            if max(fwd, bwd) > SMEM_LIMIT:
                return None
            return Geometry("wide", ctas, WIDE_UNITS, rows,
                            (ctas, groups, ndir), fwd, bwd)
    return None


def design_key(geo: Geometry, wh: torch.Tensor) -> str:
    """The ``by_design`` key of a launch of the recurrence kernels: the
    design, ``_bf16`` added for the bfloat16-weight forms."""
    return geo.design + ("_bf16" if wh.dtype == torch.bfloat16 else "")


def design_counts() -> dict:
    """A fresh ``by_design`` of the LSTM, GRU, layer-norm, zoneout and MI
    LSTM wrappers (the last three have no wide design: those counts stay
    0)."""
    return {"cluster": 0, "wide": 0, "stream": 0, "cluster_bf16": 0,
            "wide_bf16": 0, "stream_bf16": 0}


def kernel_info(name: str, geo: Geometry, batch: int, hidden: int
                ) -> tuple[int, int]:
    """On the card: (dynamic shared memory per CTA the kernel sizes, clusters
    of this launch the card holds at once), from the kernel's own launch
    configuration through its C entry point ``asr_<name>``."""
    smem, fit = ctypes.c_int(0), ctypes.c_int(0)
    err = getattr(_build.lib(), f"asr_{name}")(
        batch, hidden, geo.grid[2], geo.ctas, geo.units, geo.rows,
        ctypes.addressof(smem), ctypes.addressof(fit))
    _build.check(err, name)
    return smem.value, fit.value


def check(name: str, gates: int, mask: torch.Tensor, xps: dict, whs: dict,
          seqs: dict, gate_vecs: dict | None = None,
          unit_vecs: dict | None = None) -> None:
    """Shapes [T, B, G*H] for ``xps``, [T, B, 1] for the mask, [H, G*H] for
    ``whs``, [T, B, H] for ``seqs``, [G*H] for ``gate_vecs`` and [H] for
    ``unit_vecs`` (dicts name -> tensor, G = ``gates``); float32 (or the
    ``whs`` all bfloat16: the bfloat16-weight forms), one device,
    contiguous on CUDA.  Raises ValueError."""
    first_name, first = next(iter(xps.items()))
    if first.dim() != 3 or first.shape[2] % gates:
        raise ValueError(f"{name}: {first_name} must be [T, B, {gates}H], "
                         f"got {tuple(first.shape)}")
    t_steps, batch, gh = first.shape
    hidden = gh // gates
    want = {
        **{k: (v, (t_steps, batch, gh)) for k, v in xps.items()},
        "mask": (mask, (t_steps, batch, 1)),
        **{k: (v, (hidden, gh)) for k, v in whs.items()},
        **{k: (v, (t_steps, batch, hidden)) for k, v in seqs.items()},
        **{k: (v, (gh,)) for k, v in (gate_vecs or {}).items()},
        **{k: (v, (hidden,)) for k, v in (unit_vecs or {}).items()},
    }
    wh_dtype = next(iter(whs.values())).dtype if whs else torch.float32
    if wh_dtype != torch.bfloat16:
        wh_dtype = torch.float32
    for arg, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {shape}, got "
                             f"{tuple(t.shape)}")
        dtype = wh_dtype if arg in whs else torch.float32
        if t.dtype != dtype:
            raise ValueError(
                f"{name}: {arg} must be {str(dtype)[6:]}, got {t.dtype}" + (
                    " (the directions' weights share one dtype)"
                    if arg in whs else ""))
        if t.device != first.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, "
                             f"{first_name} on {first.device}")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {first.device}")
    if first.device.type == "cuda" and not all(
            t.is_contiguous() for t, _ in want.values()):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


def check_carry(name: str, xp: torch.Tensor, gates: int, **carry) -> None:
    """The carried state a unidirectional forward starts from (``h0=``,
    and for the LSTM ``c0=``): all None, or all [B, H] float32 on xp's
    device, contiguous.  Raises ValueError."""
    given = [k for k, v in carry.items() if v is not None]
    if not given:
        return
    if len(given) != len(carry):
        raise ValueError(f"{name}: give {' and '.join(carry)} together, "
                         f"got only {', '.join(given)}")
    want = (xp.shape[1], xp.shape[2] // gates)
    for k, v in carry.items():
        if tuple(v.shape) != want or v.dtype != torch.float32:
            raise ValueError(f"{name}: {k} must be float32 {want}, got "
                             f"{v.dtype} {tuple(v.shape)}")
        if v.device != xp.device:
            raise ValueError(f"{name}: {k} is on {v.device}, xp on "
                             f"{xp.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")


def check_res(name: str, gates: int, geo: Geometry, mask: torch.Tensor,
              xps: dict, res: tuple, prefix: str) -> None:
    """``res`` is what the forward returned with ``residual`` for the design
    of ``geo``: one tensor a direction, shaped as xp [T, B, ``gates`` * H],
    where the wide design runs; nothing elsewhere.  The tensors are named
    ``prefix`` and xp's suffix in the errors (``g_f`` for ``xp_f``).
    Raises ValueError."""
    want = len(xps) if geo.design == "wide" else 0
    if len(res) != want:
        raise ValueError(
            f"{name}: res holds {len(res)} tensors, the {geo.design} "
            f"design's forward with residual=True returns {want}")
    if res:
        check(name, gates, mask,
              {f"{prefix}{k[2:]}": r for k, r in zip(xps, res)}, {}, {})


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the kernels take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def prev(seq: torch.Tensor, reverse: bool) -> torch.Tensor:
    """The scan-previous state of every frame: t-1 for a forward walk, t+1
    for a reversed one, zero past the ends."""
    zero = seq.new_zeros((1,) + tuple(seq.shape[1:]))
    return torch.cat([seq[1:], zero]) if reverse else torch.cat(
        [zero, seq[:-1]])


def cotangent(dh, h: torch.Tensor) -> torch.Tensor:
    """The cotangent autograd hands a backward for output ``h``: zeros where
    it passes None (the output was not used), else made contiguous."""
    return torch.zeros_like(h) if dh is None else dh.contiguous()
