"""Every module of asr_study_torch imports where jax, h5py and triton are
absent (the machine with the card has neither jax nor h5py), and importing
builds no kernel."""

import subprocess
import sys

_PROBE = r"""
import sys
before = set(sys.modules)
for name in ("jax", "jaxlib", "h5py", "triton"):
    sys.modules[name] = None          # any import of them now fails
import importlib, pkgutil
import asr_study_torch
names = [m.name for m in pkgutil.walk_packages(asr_study_torch.__path__,
                                               "asr_study_torch.")]
for name in names:
    importlib.import_module(name)
for want in ("cli.predict", "features.fbank", "ops.bilstm", "ops.ctc",
             "ops.metrics", "data.generator", "train.trainer", "train.loop",
             "train.checkpoint"):
    assert "asr_study_torch." + want in names, (want, names)
from asr_study_torch import _build
assert _build.lib.cache_info().currsize == 0, "a kernel was built at import"
bad = sorted(m for m in set(sys.modules) - before
             if m.split(".")[0] in ("jax", "jaxlib", "h5py", "triton")
             and sys.modules[m] is not None)
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax_h5py_triton():
    proc = subprocess.run([sys.executable, "-c", _PROBE],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    assert int(proc.stdout.strip()) >= 15
