"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source is compiled at first use by ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes`` — no PyTorch headers,
so a build takes seconds, not minutes.  All sources are compiled
together, one ``nvcc`` process each, the first time any kernel is asked
for.  Libraries land in ``<repo>/build/repro_torch/`` (git-ignored),
named by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as is.

There is no prebuilt binary and no fallback: a missing ``nvcc`` or a
failed build raises.  Every C entry point returns ``cudaGetLastError()``
after its launch; :func:`check` turns a non-zero code into an exception.
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
from typing import Dict, Optional

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "KERNELS", "library",
           "build_all", "check", "build_log"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("l2_dist", "pq_adc", "seg_topk")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source at first use")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every kernel source not yet built, all ``nvcc`` runs in
    parallel; returns ``{name: library path}``.  Raises on any failure."""
    targets = {name: _target(name) for name in KERNELS}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, target in todo.items():
        # build to a private name, then rename: a concurrent process never
        # loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        _logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return targets


def build_log(name: str) -> Optional[str]:
    """``nvcc`` output (``-Xptxas -v``: registers, shared memory, spills)
    of ``name``'s build in this process, or None if it was loaded prebuilt."""
    return _logs.get(name)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            for n, p in paths.items():
                if n not in _libs:
                    _libs[n] = ctypes.CDLL(str(p))
                    _libs[n].error_string.argtypes = [ctypes.c_int]
                    _libs[n].error_string.restype = ctypes.c_char_p
            lib = _libs[name]
        return lib


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
