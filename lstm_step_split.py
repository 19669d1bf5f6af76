#!/usr/bin/env python3
"""Where a step of the cluster LSTM forward kernel spends its time, on one
NVIDIA GPU.

    python3 lstm_step_split.py

Compiles ``asr_study_torch/csrc/bilstm_fwd.cu`` as it is and in variants
that each drop one part of the step (their outputs are wrong; only their
times count), into ``build/step_split/``, and times each at the main
paths' shapes (H=256, T=805, B=32; one direction, R=4 rows a cluster, and
two, R=8) with CUDA events, the unchanged kernel first and last.  The
variants:

- ``no_push``: h goes to the CTA's own buffer only, no exchange through
  distributed shared memory;
- ``no_push_no_sync``: that, and a block barrier instead of the cluster
  barrier;
- ``no_product``: no h_prev @ w;
- ``no_cell_math``: the cell's sigmoids and tanhs replaced by a sum;
- ``skeleton``: neither product nor exchange.

The difference to the unchanged kernel is the part's cost on the step's
critical path.  Prints one line per variant and the card's name and power
limit.  Without CUDA it exits 1.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

T, B, H = 805, 32, 256

PRODUCT = "for (int kk = 0; kk < kSlice; kk += 4) {"
PUSH = "cluster.map_shared_rank(hn, p)[r * HS + unit] = h;"
OWN = "if (p == rank) hn[r * HS + unit] = h;"
STEP_SYNC = "    cluster.sync();\n  }\n}"
CELL = ("      float c = fg * c_prev + ig * gg;\n"
        "      float h = og * tanhf(c);")
VARIANTS = {
    "base": [],
    "no_push": [(PUSH, OWN)],
    "no_push_no_sync": [(PUSH, OWN),
                        (STEP_SYNC, "    __syncthreads();\n  }\n}")],
    "no_product": [(PRODUCT, PRODUCT.replace("kk < kSlice", "kk < 0"))],
    "no_cell_math": [(CELL, "      float c = pre[0] + pre[1] + pre[2] + "
                            "pre[3] + c_prev;\n      float h = c;")],
    "skeleton": [(PRODUCT, PRODUCT.replace("kk < kSlice", "kk < 0")),
                 (PUSH, OWN)],
}


def build(root: Path) -> dict:
    """Each variant's source, compiled in parallel -> name -> its
    ``asr_bilstm_fwd`` entry point."""
    from asr_study_torch import _build

    src = (_build.CSRC / "bilstm_fwd.cu").read_text()
    out = root / "build" / "step_split"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the kernel no longer has "
                                   f"{old!r}")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")])
    entry = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant")
        fn = ctypes.CDLL(str(out / f"{name}.so")).asr_bilstm_fwd
        fn.argtypes = _build.SIGNATURES["asr_bilstm_fwd"]
        fn.restype = ctypes.c_int
        entry[name] = fn
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("lstm_step_split: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from asr_study_torch.ops.bilstm import lstm_geometry
    from asr_study_torch.ops.recurrence import stream

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    entry = build(Path(__file__).resolve().parent)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    xp = torch.randn(T, B, 4 * H, device=dev, generator=g)
    wh = torch.randn(H, 4 * H, device=dev, generator=g) / H ** 0.5
    mask = torch.ones(T, B, 1, device=dev)
    outs = [torch.empty(T, B, H, device=dev) for _ in range(4)]
    print(card)
    for ndir in (1, 2):
        geo = lstm_geometry(H, B, ndir)
        for name in [*VARIANTS, "base"]:
            def call(fn=entry[name]):
                err = fn(xp.data_ptr(), xp.data_ptr(), mask.data_ptr(),
                         wh.data_ptr(), wh.data_ptr(),
                         *(o.data_ptr() for o in outs), T, B, H, ndir,
                         geo.ctas, geo.units, geo.rows, stream(xp))
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
            call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                call()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / 10
            print(f"[{card}] bilstm_fwd, ndir={ndir} R={geo.rows} H={H} "
                  f"T={T} B={B}, {name}: {ms:.4f} ms, "
                  f"{1e3 * ms / T:.3f} us a step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
