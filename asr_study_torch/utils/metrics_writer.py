"""Scalar metric logging: stdout + CSV + optional TensorBoard.

Copied from ``asr_study_tpu/utils/metrics_writer.py`` so that the port
imports nothing of the JAX package; standard library only (TensorBoard's
writer is imported from torch when asked for).

The reference relied on the Keras progress bar/history; here every scalar
goes to a CSV next to the checkpoints so runs are inspectable offline, with
an optional trailing-window stdout summary.  ``tensorboard=True`` also
writes event files (lazily via torch.utils.tensorboard, which this image
ships; degrades to a one-line warning if unavailable).
"""

from __future__ import annotations

import csv
import os
import sys
import time
from typing import Dict, Optional


class MetricWriter:
    def __init__(self, directory: Optional[str] = None, name: str = "train",
                 tensorboard: bool = False):
        self._file = None
        self._writer = None
        self._fields = None
        self._t0 = time.time()
        self._tb = None
        if directory:
            os.makedirs(directory, exist_ok=True)
            self._path = os.path.join(directory, f"{name}_metrics.csv")
        else:
            self._path = None
        if tensorboard and directory:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(
                    log_dir=os.path.join(directory, "tb"),
                    filename_suffix=f".{name}",
                )
            except Exception as e:  # keep training usable without TB deps
                print(
                    f"tensorboard writer unavailable ({e}); CSV only",
                    file=sys.stderr,
                )

    def write(self, step: int, scalars: Dict[str, float], echo: bool = False):
        row = {"step": step, "wall_s": round(time.time() - self._t0, 3)}
        row.update({k: float(v) for k, v in scalars.items()})
        if self._path:
            if self._writer is None or any(k not in self._fields for k in row):
                self._reopen(list(row.keys()))
            self._writer.writerow(row)
            self._file.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), global_step=step)
        if echo:
            msg = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items()
            )
            print(msg, file=sys.stderr, flush=True)

    def _reopen(self, row_keys):
        """(Re)build the CSV writer, widening the header when rows introduce
        new scalar keys (e.g. the epoch-summary val_loss/val_ler after
        per-step rows) — previously those columns were silently dropped by
        ``extrasaction='ignore'``.  When the header widens, existing rows are
        rewritten with empty cells for the columns they lack."""
        if self._file:
            self._file.close()
            self._file = self._writer = None
        fields = list(self._fields or [])
        old_rows = []
        has_file = os.path.exists(self._path) and os.path.getsize(self._path)
        if not fields and has_file:          # resuming into an existing CSV
            with open(self._path, newline="") as f:
                fields = list(csv.DictReader(f).fieldnames or [])
        new_keys = [k for k in row_keys if k not in fields]
        if new_keys and has_file:
            with open(self._path, newline="") as f:
                old_rows = list(csv.DictReader(f))
        self._fields = fields + new_keys
        mode = "w" if (new_keys and has_file) else "a"
        self._file = open(self._path, mode, newline="")
        self._writer = csv.DictWriter(
            self._file, fieldnames=self._fields, extrasaction="ignore"
        )
        if self._file.tell() == 0:
            self._writer.writeheader()
        for r in old_rows:
            self._writer.writerow(r)

    def close(self):
        if self._file:
            self._file.close()
        if self._tb is not None:
            self._tb.close()
