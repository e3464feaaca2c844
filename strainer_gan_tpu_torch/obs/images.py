"""Sample-grid images (counterpart of `strainer_gan_tpu/obs/images.py`).

``make_grid`` repeats the JAX package's numpy replica of
``vutils.make_grid(fake, padding=2, normalize=True)`` (`#%basic.py:301-304`)
on NHWC arrays, byte for byte.  ``save_image_grid`` writes the grid as an
8-bit PNG with the standard library (``zlib`` and ``struct``), so it needs
no imaging package.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..parallel.multihost import is_primary


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2,
              normalize: bool = True) -> np.ndarray:
    """images: (N, H, W, C) float -> (H', W', C) uint8 grid."""
    imgs = np.asarray(images, np.float32)
    if normalize:
        lo, hi = imgs.min(), imgs.max()
        imgs = (imgs - lo) / max(hi - lo, 1e-5)
    n, h, w, c = imgs.shape
    ncol = nrow
    nrows = -(-n // ncol)
    grid = np.ones(
        (nrows * (h + padding) + padding, ncol * (w + padding) + padding, c),
        np.float32,
    )
    for i in range(n):
        r, col = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y : y + h, x : x + w] = imgs[i]
    return (grid * 255).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(pixels: np.ndarray) -> bytes:
    """(H, W, 1 or 3) uint8 -> PNG bytes: greyscale or RGB, 8 bits, each
    row with filter type 0."""
    h, w, c = pixels.shape
    color = {1: 0, 3: 2}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(pixels, np.uint8).reshape(h, w * c)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_image_grid(images: np.ndarray, path: str, nrow: int = 8,
                    padding: int = 2) -> None:
    """Write the grid as a PNG (under a process group, rank 0 only)."""
    if not is_primary():
        return
    grid = make_grid(images, nrow=nrow, padding=padding)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(grid))
