"""Build and load the port's CUDA kernels.

`nvcc` compiles ops/csrc/*.cu for sm_90a into a shared library with a plain
C interface, which `ctypes` loads; the build runs at the first CUDA use in a
process, so nothing is built when the package is imported. The library goes
to build/gnn_tpu_torch/ of the source checkout the package runs from (listed
in .gitignore), or, for an installed package, to gnn_tpu_torch/ in the
user's cache directory. Its file name carries a hash of the nvcc flags, and
it is rebuilt when a source is newer than it. A failed build raises with
nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _build_dir() -> Path:
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file():      # running from a source checkout
        return root / "build" / "gnn_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "gnn_tpu_torch"


BUILD_DIR = _build_dir()
_FLAGS_HASH = hashlib.sha256(" ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
LIB_PATH = BUILD_DIR / f"libgnn_tpu_torch_kernels-{_FLAGS_HASH}.so"

_lock = threading.Lock()
_lib = None
build_log = ""   # nvcc's output (ptxas register and shared-memory report) of the last build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "gnn_tpu_torch's kernels")


def _stale(sources) -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(s.stat().st_mtime > built for s in sources)


def build(force: bool = False) -> Path:
    """Compile the kernel library if it is missing (first build, or new nvcc
    flags) or older than a source."""
    global build_log
    sources = sorted(CSRC.glob("*.cu"))
    if not (force or _stale(sources)):
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{build_log}")
    os.replace(tmp, LIB_PATH)   # atomic: a concurrent loader never sees half a file
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.gnn_propagation_loop.argtypes = [p] * 8 + [i, i, i, i, f, i, p]
            lib.gnn_propagation_loop.restype = i
            lib.gnn_propagation_step.argtypes = [p] * 7 + [i, i, i, i, i, p]
            lib.gnn_propagation_step.restype = i
            lib.gnn_cuda_error_string.argtypes = [i]
            lib.gnn_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = library().gnn_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
