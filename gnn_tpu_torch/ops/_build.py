"""Build and load the port's CUDA kernels.

`nvcc` compiles each ops/csrc/*.cu for sm_90a into an object file, all
sources at once in parallel, and links them into one shared library with a
plain C interface, which `ctypes` loads; the build runs at the first CUDA use
in a process, so nothing is built when the package is imported. The library goes
to build/gnn_tpu_torch/ of the source checkout the package runs from (listed
in .gitignore), or, for an installed package, to gnn_tpu_torch/ in the
user's cache directory. Its file name carries a hash of the nvcc flags, and
it is rebuilt when a source or a header (ops/csrc/*.cuh) is newer than
it. A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


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
build_seconds = {}   # each source's nvcc wall time in the last build, by file name


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


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return proc.returncode, proc.stdout + proc.stderr


def _timed_run(cmd):
    t0 = time.perf_counter()
    rc, log = _run(cmd)
    return rc, log, time.perf_counter() - t0


def build(force: bool = False) -> Path:
    """Compile the kernel library if it is missing (first build, or new nvcc
    flags) or older than a source."""
    global build_log
    sources = sorted(CSRC.glob("*.cu"))
    if not (force or _stale(sources + sorted(CSRC.glob("*.cuh")))):
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, s.stem + ".o") for s in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)] for s, o in zip(sources, objs)]
        with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
            results = list(pool.map(_timed_run, cmds))
        build_log = "".join(log for _, log, _ in results)
        build_seconds.clear()
        build_seconds.update((s.name, sec) for s, (_, _, sec) in zip(sources, results))
        for cmd, (rc, log, _) in zip(cmds, results):
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{log}")
        lib_tmp = os.path.join(tmpdir, LIB_PATH.name)
        link = [nvcc, "-shared", "-o", lib_tmp, *objs]
        rc, log = _run(link)
        build_log += log
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(link)}\n{log}")
        os.replace(lib_tmp, LIB_PATH)   # atomic: a concurrent loader never sees half a file
    return LIB_PATH


def _signatures():
    """{C entry: (argtypes, restype)} of the kernel library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # K1-K5, K8 and K9-K15 take their wide plan's workspace after the stream
    sig = {
        "gnn_propagation_loop": [p] * 8 + [i, i, i, i, f, i, p, p],
        "gnn_propagation_step": [p] * 7 + [i, i, i, i, i, p, p],
        "gnn_bn_forward": [p] * 14 + [i, i, i, i, i, f, i, i, f, f, p, p],
        "gnn_bn_backward": [p] * 17 + [i, i, i, i, i, i, i, f, f, p, p],
        "gnn_propagation_loop_bwd": [p] * 11 + [i, i, i, i, i, p, p],
        "gnn_train_loop": [p] * 10 + [i, i, i, i, f, i, i, f, f, p],
        "gnn_train_loop_bwd": [p] * 12 + [i, i, i, i, i, i, f, f, p, p],
        "gnn_train_step": [p] * 9 + [i, i, i, i, i, i, f, f, p],
        "gnn_propagation_loop2": [p] * 11 + [i] * 6 + [f, i, i, p, p],
        "gnn_propagation_step2": [p] * 10 + [i] * 7 + [p, p],
        "gnn_train_loop2": [p] * 13 + [i] * 6 + [f, i, i, i, f, f, p, p],
        "gnn_train_loop2_bwd": [p] * 18 + [i] * 9 + [f, f, p, p],
        "gnn_propagation_loop2_bwd": [p] * 17 + [i] * 8 + [p, p],
        "gnn_bn2_forward": [p] * 16 + [i] * 6 + [f, i, i, i, f, f, p, p],
        "gnn_bn2_backward": [p] * 21 + [i] * 9 + [f, f, p, p],
        "gnn_bnT_forward": [p] * 15 + [i] * 6 + [f, p, i, f, f, p, p],
        "gnn_bnT_backward": [p] * 18 + [i] * 6 + [p, i, f, f, p, p],
        "gnn_segment_aggregate": [p] * 5 + [i, i, p],
        # the bf16-adjacency variants of K1-K17 (no plans, no workspace)
        "gnn_propagation_loop_bf16": [p] * 8 + [i] * 4 + [f, i, p],
        "gnn_train_loop_bf16": [p] * 10 + [i] * 4 + [f, i, i, f, f, p],
        "gnn_train_loop_bwd_bf16": [p] * 12 + [i] * 6 + [f, f, p],
        "gnn_train_step_bf16": [p] * 9 + [i] * 6 + [f, f, p],
        "gnn_propagation_loop_bwd_bf16": [p] * 11 + [i] * 5 + [p],
        "gnn_train_loop2_bf16": [p] * 13 + [i] * 6 + [f, i, i, i, f, f, p],
        "gnn_train_loop2_bwd_bf16": [p] * 18 + [i] * 9 + [f, f, p],
        "gnn_propagation_step_bf16": [p] * 7 + [i] * 5 + [p],
        "gnn_bn_forward_bf16": [p] * 14 + [i] * 5 + [f, i, i, f, f, p],
        "gnn_bn_backward_bf16": [p] * 17 + [i] * 7 + [f, f, p],
        "gnn_propagation_step2_bf16": [p] * 9 + [i] * 6 + [p],
        "gnn_propagation_loop2_bf16": [p] * 10 + [i] * 5 + [f, i, i, p],
        "gnn_propagation_loop2_bwd_bf16": [p] * 15 + [i] * 7 + [p],
        "gnn_bn2_forward_bf16": [p] * 16 + [i] * 6 + [f, i, i, i, f, f, p],
        "gnn_bn2_backward_bf16": [p] * 21 + [i] * 9 + [f, f, p],
        "gnn_bnT_forward_bf16": [p] * 15 + [i] * 6 + [f, p, i, f, f, p],
        "gnn_bnT_backward_bf16": [p] * 18 + [i] * 6 + [p, i, f, f, p],
    }
    out = {name: (args, i) for name, args in sig.items()}
    # the tiled kernels', K1's-K8's, K16's and K17's plan reports (W, D, AL or
    # F or H, H1 or T, out) and K18's launch report (N, D, -, -, out); forced
    # plans of those in `planned`; the workspace floats a block row of the
    # plan K1-K5's, K8's and K9-K17's entries pick (W, D, F or H or AL, H1 or
    # T)
    planned = ("gnn_propagation_loop2_bwd", "gnn_bn2_forward", "gnn_bn2_backward",
               "gnn_train_loop2", "gnn_bn_forward", "gnn_bn_backward", "gnn_train_loop_bwd",
               "gnn_bnT_backward", "gnn_propagation_step2", "gnn_propagation_loop",
               "gnn_propagation_loop_bwd", "gnn_bnT_forward", "gnn_propagation_step",
               "gnn_train_loop", "gnn_train_step", "gnn_propagation_loop2",
               "gnn_train_loop2_bwd")
    for name in planned + ("gnn_segment_aggregate",):
        out[name + "_info"] = ([i] * 4 + [p], i)
    for name in planned:
        out[name + "_force_plan"] = ([i], None)
    for name in ("gnn_bn_forward", "gnn_bn_backward", "gnn_propagation_loop",
                 "gnn_propagation_step", "gnn_propagation_loop_bwd", "gnn_train_loop_bwd",
                 "gnn_propagation_step2", "gnn_propagation_loop2", "gnn_propagation_loop2_bwd",
                 "gnn_train_loop2", "gnn_train_loop2_bwd", "gnn_bn2_forward", "gnn_bn2_backward",
                 "gnn_bnT_forward", "gnn_bnT_backward"):
        out[name + "_workspace"] = ([i] * 4, i)
    out["gnn_cuda_error_string"] = ([i], ctypes.c_char_p)
    return out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of the C entries `lib` has (a
    library built from some of the sources has some)."""
    for name, (args, res) in _signatures().items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(build())))
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = library().gnn_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
