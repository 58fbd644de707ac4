"""gnn_tpu_torch must run without JAX: importing every one of its modules
loads neither jax nor any gnn_tpu module."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import gnn_tpu_torch

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax_and_no_gnn_tpu():
    names = ["gnn_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
        gnn_tpu_torch.__path__, prefix="gnn_tpu_torch.")]
    assert "gnn_tpu_torch.ops.fused" in names and "gnn_tpu_torch.serving" in names
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'gnn_tpu' or m.startswith('gnn_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("clean")
