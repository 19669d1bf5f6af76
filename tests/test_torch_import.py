"""Every module of asr_study_torch imports where jax, h5py, triton and the
JAX package (asr_study_tpu) are absent (the machine with the card has
neither jax nor h5py), loads no module of the JAX package, and importing
builds no kernel; neither the port nor chip_smoke.py names the JAX package
or jax in an import statement."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "h5py", "triton", "asr_study_tpu")

_PROBE = r"""
import sys
before = set(sys.modules)
BLOCKED = %r
for name in BLOCKED:
    sys.modules[name] = None          # any import of them now fails
import importlib, pkgutil
import asr_study_torch
names = [m.name for m in pkgutil.walk_packages(asr_study_torch.__path__,
                                               "asr_study_torch.")]
for name in names:
    importlib.import_module(name)
for want in ("cli.predict", "features.fbank", "features.audio",
             "features.wav", "text.parser", "utils.hparams",
             "utils.metrics_writer", "ops.bilstm", "ops.gru", "ops.ln_lstm",
             "ops.zoneout_lstm", "ops.mi_lstm", "ops.ctc", "ops.dpack",
             "data.wire",
             "ops.metrics", "data.generator", "train.trainer", "train.loop",
             "train.checkpoint"):
    assert "asr_study_torch." + want in names, (want, names)
import chip_smoke
from asr_study_torch import _build
assert _build.lib.cache_info().currsize == 0, "a kernel was built at import"
bad = sorted(m for m in set(sys.modules) - before
             if m.split(".")[0] in BLOCKED and sys.modules[m] is not None)
assert not bad, bad
print(len(names))
""" % (BLOCKED,)


def test_port_imports_without_jax_h5py_triton():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    assert int(proc.stdout.strip()) >= 20


def _imported_roots(path):
    """Top-level package of every import statement in a source file,
    function bodies included."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_import_statement_names_jax_or_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "asr_study_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [(os.path.relpath(f, ROOT), r) for f in files
           for r in _imported_roots(f) if r in ("jax", "jaxlib",
                                                "asr_study_tpu")]
    assert not bad, bad
