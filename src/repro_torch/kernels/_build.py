"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source is compiled at first use by ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes`` — no PyTorch headers,
so a build takes seconds, not minutes.  All sources are compiled
together, one ``nvcc`` process each, the first time any kernel is asked
for.  Libraries land in ``<repo>/build/repro_torch/`` (git-ignored),
named by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header is rebuilt and an unchanged one
is loaded as is.

There is no prebuilt binary and no fallback: a missing ``nvcc`` or a
failed build raises.  Every C entry point returns ``cudaGetLastError()``
after its launch; :func:`check` turns a non-zero code into an exception.
Each entry point's ``argtypes`` / ``restype`` (:data:`SIGNATURES`) are set
once, when its library is loaded: the ``ctypes`` function objects are
shared by every thread that launches a kernel, so no call writes them.
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

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "KERNELS", "SIGNATURES",
           "library", "build_all", "check", "build_log", "cuda_tool"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("l2_dist", "l2_top1", "pq_adc", "seg_topk", "wt_rank",
           "rans_decode")
_P, _I = ctypes.c_void_p, ctypes.c_int
# {library: {C entry point: argtypes}}; every entry point returns an int
# (a CUDA error code; wt_rank_route the route)
SIGNATURES = {
    "l2_dist": {"l2_dist_launch": [_P] * 3 + [_I] * 3 + [_P]},
    "l2_top1": {"l2_top1_launch": [_P] * 4 + [_I] * 3 + [_P]},
    "pq_adc": {"pq_adc_launch": [_P] * 3 + [_I] * 5 + [_P]},
    "seg_topk": {"seg_topk_launch": [_P] * 5 + [_I] * 3 + [_P]},
    "wt_rank": {"wt_rank_launch": [_P] * 4 + [_I] * 3 + [_P],
                "wt_rank_route": [_I] * 3},
    "rans_decode": {"rans_decode_launch": [_P] * 6 + [_I] * 4 + [_P]},
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}


def cuda_tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``); raises if
    it is not found."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / name)] if home else []
    cands += [shutil.which(name) or "", f"/usr/local/cuda/bin/{name}"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(f"{name} not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source at first use")


def _target(name: str) -> Path:
    # every header counts: a source may include any of them
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
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
    nvcc = cuda_tool()
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


def _load(path: Path, name: str) -> ctypes.CDLL:
    """Load one library and declare its entry points' signatures."""
    lib = ctypes.CDLL(str(path))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    for sym, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name`` (built on first use),
    its entry points' ``argtypes`` and ``restype`` already set."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            for n, p in paths.items():
                if n not in _libs:
                    _libs[n] = _load(p, n)
            lib = _libs[name]
        return lib


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
