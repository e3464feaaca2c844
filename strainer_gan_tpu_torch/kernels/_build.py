"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a``; the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  No PyTorch
header is compiled, so a cold build takes seconds.  The library lands in
``strainer_gan_tpu_torch/_build/`` under a name carrying the hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  Nothing here runs at import time.
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
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("bce.cu", "pairwise.cu", "zscore.cu", "gated_graph.cu")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build, if it built


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME); "
                       "the port's CUDA kernels are built with it at first use")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(COMPILE_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libsg_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the sources if this exact set has not been built yet."""
    global build_seconds
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
    try:
        procs = []
        for name in SOURCES:
            obj = work / (Path(name).stem + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for name, _, p in procs:
            out, _ = p.communicate(timeout=900)
            log.append(f"== {name}\n{out}")
            if p.returncode != 0:
                failed.append(name)
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_so = work / so.name
        link = [nvcc, *ARCH_FLAGS, "-shared", *[str(o) for _, o, _ in procs],
                "-o", str(tmp_so)]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{res.stdout}")
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return so


def build_log() -> str:
    p = BUILD_DIR / "build.log"
    return p.read_text() if p.exists() else ""


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use; argument types declared."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i32, i64, f32, vp = ctypes.c_int, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p
        lib.sg_bce_scores.argtypes = [i32, vp, vp, i64, f32, vp]
        lib.sg_bce_scores.restype = i32
        lib.sg_zscore_stats_chunks.argtypes = [i32, i64, i32]
        lib.sg_zscore_stats_chunks.restype = i64
        lib.sg_zscore_column_stats.argtypes = [i32, vp, vp, i64, i32, i32, f32, i64,
                                               vp, vp, vp, vp, vp, vp]
        lib.sg_zscore_column_stats.restype = i32
        lib.sg_zscore_row_max.argtypes = [i32, vp, vp, vp, i64, i32, vp, vp]
        lib.sg_zscore_row_max.restype = i32
        lib.sg_pairwise_feature_step.argtypes = []
        lib.sg_pairwise_feature_step.restype = i32
        lib.sg_pairwise_tile.argtypes = []
        lib.sg_pairwise_tile.restype = i32
        lib.sg_pairwise_counts.argtypes = [i32, vp, i32, i32, i32, vp, vp, vp, vp, vp, f32,
                                           f32, vp, vp, vp, vp, i32, vp, i32, vp]
        lib.sg_pairwise_counts.restype = i32
        lib.sg_dbscan_near_core.argtypes = [i32, vp, vp, i32, vp, vp]
        lib.sg_dbscan_near_core.restype = i32
        lib.sg_gated_build.argtypes = [i32, vp, i32, vp, vp, i32, ctypes.POINTER(vp),
                                       ctypes.POINTER(i32)]
        lib.sg_gated_build.restype = i32
        lib.sg_graph_launch.argtypes = [vp, vp]
        lib.sg_graph_launch.restype = i32
        lib.sg_graph_exec_destroy.argtypes = [vp]
        lib.sg_graph_exec_destroy.restype = i32
        _lib = lib
        return lib


def current_stream(device: int) -> int:
    """The handle of PyTorch's current stream on a CUDA device (the
    capturing stream inside a CUDA graph capture), as an integer."""
    return torch._C._cuda_getCurrentRawStream(device)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError {rc}")
