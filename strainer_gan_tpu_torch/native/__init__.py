"""The port's host-staging library: ctypes bindings and its build
(counterpart of `strainer_gan_tpu/native/__init__.py`).

``lib()`` compiles ``host_staging.cc`` with ``g++`` at first use into the
package's git-ignored ``_build/`` directory, under a name carrying the
hash of the source and flags, and loads it.  The build writes a temporary
file and renames it into place, so parallel processes that build at once
each see a whole library.  A failed build raises: the port has no quiet
fallback to its numpy versions, which stay in ``data/`` as the plain
versions the tests hold this library to.  Nothing here runs at import
time.

The library stages the dataset once, before training (resize, crop and
the mixture's gather, on up to 16 host threads); no training step reads
it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "host_staging.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# the JAX package's flags (`strainer_gan_tpu/native/__init__.py:37`): the
# plain versions repeat the roundings that -march=native gives on an FMA CPU
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-march=native", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libhost_staging_{h.hexdigest()[:16]}.so"


def build(compiler: str = "g++") -> Path:
    """Compile the library if this source and these flags have not been
    built yet; raises if the compiler is missing or fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}.{threading.get_ident()}")
    try:
        res = subprocess.run([compiler, *FLAGS, str(SOURCE), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"building the host-staging library needs {compiler}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{compiler} failed on {SOURCE.name}:\n{res.stderr}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The library, built on first use; argument types declared."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        L = ctypes.CDLL(str(build()))
        i64, i32 = ctypes.c_int64, ctypes.c_int
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        L.sg_resize_bilinear_u8.argtypes = [u8p, i64, i32, i32, i32, u8p, i32, i32, i32]
        L.sg_center_crop_u8.argtypes = [u8p, i64, i32, i32, i32, u8p, i32, i32]
        L.sg_gather_u8.argtypes = [u8p, i64p, i64, i64, u8p, i32]
        _lib = L
        return L


def threads() -> int:
    return max(1, min(os.cpu_count() or 1, 16))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def resize_bilinear_u8(images: np.ndarray, size: int) -> np.ndarray:
    """Triangle-filter resize of uint8 NHWC images to (size, size)."""
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, c = images.shape
    out = np.empty((n, size, size, c), np.uint8)
    lib().sg_resize_bilinear_u8(_u8p(images), n, h, w, c, _u8p(out), size, size, threads())
    return out


def center_crop_u8(images: np.ndarray, size: int) -> np.ndarray:
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, c = images.shape
    if size > h or size > w:
        raise ValueError(f"crop size {size} exceeds image extent ({h}, {w})")
    out = np.empty((n, size, size, c), np.uint8)
    lib().sg_center_crop_u8(_u8p(images), n, h, w, c, _u8p(out), size, threads())
    return out


def gather_u8(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``src[idx]`` along the first axis for a uint8 array."""
    src = np.ascontiguousarray(src, np.uint8)
    idx = np.ascontiguousarray(idx, np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= src.shape[0]):
        raise IndexError("gather index out of range")
    item = int(np.prod(src.shape[1:]))
    out = np.empty((idx.shape[0],) + src.shape[1:], np.uint8)
    lib().sg_gather_u8(_u8p(src.reshape(-1)), idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                       idx.shape[0], item, _u8p(out.reshape(-1)), threads())
    return out
