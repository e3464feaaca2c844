"""Array-backed datasets (counterpart of `strainer_gan_tpu/data/datasets.py`).

Every source becomes one uint8 NHWC array at build time.  Real data is read
from ``$STRAINER_DATA_ROOT`` when it is there (CIFAR-10 pickle batches,
image folders); otherwise the deterministic synthetic generators stand in.
The generators and the resize are numpy copies of the reference's, so the
same seed gives byte-identical arrays in both packages
(tests/test_torch_slice.py).
"""
from __future__ import annotations

import os
import pickle
import random as _pyrandom
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..config import SourceSpec


@dataclass
class ArrayDataset:
    """images: uint8 NHWC; labels: int32."""

    images: np.ndarray
    labels: np.ndarray

    def __len__(self):
        return self.images.shape[0]


# ---------------------------------------------------------------------------
# host-side transforms (build-time only)


def _triangle_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) float32 matrix of the PIL-style triangle filter the
    reference's native staging library uses
    (`strainer_gan_tpu/native/host_staging.cc:51-79`): support widens with
    the scale when downsampling, weights are float32 normalised per row."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    mat = np.zeros((out_size, in_size), np.float32)
    for x in range(out_size):
        center = (x + 0.5) * scale
        xmin = max(0, int(center - support + 0.5))
        xmax = min(in_size, int(center + support + 0.5))
        vals = [max(0.0, 1.0 - abs((i + 0.5 - center) / filterscale))
                for i in range(xmin, xmax)]
        total = sum(vals)
        w = np.asarray(vals, np.float32)
        if total > 0:
            w = (w.astype(np.float64) / total).astype(np.float32)
        mat[x, xmin:xmax] = w
    return mat


def resize_bilinear_u8(images: np.ndarray, size: int) -> np.ndarray:
    """Separable triangle-filter resize of uint8 NHWC images.

    A horizontal pass into float32, then a vertical pass rounded half up,
    as `host_staging.cc:92-135` does.  The passes run as float64 matrix
    products rounded to float32, which is bit-identical to the native
    library's float32 accumulation wherever the sums are exact — always so
    for the 2x upsampling the synthetic CIFAR stand-in takes (weights 1/4
    and 3/4 of integers)."""
    n, h, w, c = images.shape
    if h == size and w == size:
        return images
    wy = _triangle_weights(h, size).astype(np.float64)
    wx = _triangle_weights(w, size).astype(np.float64)
    out = np.empty((n, size, size, c), np.uint8)
    step = 1024
    for lo in range(0, n, step):
        x = images[lo:lo + step].astype(np.float64)
        tmp = np.einsum("nhwc,ow->nhoc", x, wx).astype(np.float32)
        acc = np.einsum("nhoc,ph->npoc", tmp.astype(np.float64), wy)
        acc = acc.astype(np.float32) + np.float32(0.5)
        out[lo:lo + step] = np.clip(acc.astype(np.int32), 0, 255).astype(np.uint8)
    return out


def center_crop(images: np.ndarray, size: int) -> np.ndarray:
    h, w = images.shape[1:3]
    top = (h - size) // 2
    left = (w - size) // 2
    return np.ascontiguousarray(images[:, top:top + size, left:left + size])


def resize_shorter_then_crop(images: np.ndarray, size: int) -> np.ndarray:
    """transforms.Resize(size) + CenterCrop(size) (`#%basic.py:69-72`)."""
    h, w = images.shape[1:3]
    if h == w:
        return resize_bilinear_u8(images, size)
    from PIL import Image

    scale = size / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = np.empty((images.shape[0], nh, nw, images.shape[3]), np.uint8)
    for i in range(images.shape[0]):
        out[i] = np.asarray(Image.fromarray(images[i]).resize((nw, nh), Image.BILINEAR))
    return center_crop(out, size)


# ---------------------------------------------------------------------------
# real loaders (disk only, never downloaded)


def _find(relpaths) -> Optional[str]:
    root = os.environ.get("STRAINER_DATA_ROOT", "")
    if not root:
        return None
    for rel in relpaths:
        p = os.path.join(root, rel)
        if os.path.exists(p):
            return p
    return None


def _load_cifar10_disk() -> Optional[ArrayDataset]:
    p = _find(["cifar-10/cifar-10-batches-py", "cifar-10-batches-py"])
    if p is None:
        return None
    imgs, labels = [], []
    for i in range(1, 6):
        with open(os.path.join(p, f"data_batch_{i}"), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        labels.extend(d[b"labels"])
    return ArrayDataset(np.concatenate(imgs), np.asarray(labels, np.int32))


def _load_image_folder(names) -> Optional[ArrayDataset]:
    p = _find(names)
    if p is None:
        return None
    from PIL import Image

    paths = []
    for root, _, files in os.walk(p):
        for f in sorted(files):
            if f.lower().endswith((".jpg", ".jpeg", ".png")):
                paths.append(os.path.join(root, f))
    paths.sort()
    imgs = []
    for fp in paths:
        try:  # corrupt-image skip (#strainer gan.py:100-104)
            imgs.append(np.asarray(Image.open(fp).convert("RGB")))
        except OSError:
            continue
    if not imgs:
        return None
    if len({im.shape for im in imgs}) == 1:
        return ArrayDataset(np.stack(imgs), np.zeros(len(imgs), np.int32))
    out = np.stack(
        [np.asarray(Image.fromarray(im).resize((64, 64), Image.BILINEAR)) for im in imgs]
    )
    return ArrayDataset(out, np.zeros(len(out), np.int32))


# ---------------------------------------------------------------------------
# synthetic generators — deterministic, distribution-distinct per source


def _smooth_field(rng, n, size, ch, octaves=3):
    img = np.zeros((n, size, size, ch), np.float32)
    for o in range(octaves):
        res = 2 ** (o + 2)
        coarse = rng.standard_normal((n, res, res, ch)).astype(np.float32)
        reps = size // res
        up = np.kron(coarse, np.ones((1, reps, reps, 1), np.float32))
        img += up / (2.0**o)
    img = img / np.abs(img).max(axis=(1, 2, 3), keepdims=True).clip(1e-6)
    return img


def _synthetic(kind: str, n: int, size: int, ch: int, seed: int) -> ArrayDataset:
    """`strainer_gan_tpu/data/datasets.py:230-260`, kinds of this slice."""
    rng = np.random.default_rng(seed)
    if kind == "faces":  # smooth, warm-tinted
        x = _smooth_field(rng, n, size, ch)
        bias = np.array([0.25, 0.05, -0.05])[:ch].reshape(1, 1, 1, ch)
        img = np.clip((x * 0.5 + 0.5) * 0.8 + bias + 0.1, 0, 1)
        labels = np.zeros(n, np.int32)
    elif kind == "objects":  # high-frequency texture (CIFAR-like)
        fine = rng.standard_normal((n, size, size, ch)).astype(np.float32)
        coarse = _smooth_field(rng, n, size, ch, octaves=2)
        img = np.clip(0.5 + 0.25 * fine + 0.25 * coarse, 0, 1)
        labels = rng.integers(0, 10, n).astype(np.int32)
    else:
        raise ValueError(f"unknown synthetic kind {kind!r}")
    return ArrayDataset((img * 255).astype(np.uint8), labels)


_SYNTH_SIZES = {"faces": 20000, "objects": 50000}


def load_source(spec: SourceSpec, image_size: int, channels: int, seed: int,
                max_synth: Optional[int] = None) -> ArrayDataset:
    """`strainer_gan_tpu/data/datasets.py:270-334`: one SourceSpec -> uint8
    array at the target resolution."""
    name = spec.name
    ds: Optional[ArrayDataset] = None
    if name == "cifar10":
        ds = _load_cifar10_disk()
        kind = "objects"
    elif name == "celeba":
        ds = _load_image_folder(["celeba", "img_align_celeba"])
        kind = "faces"
    elif name.startswith("synthetic_"):
        kind = name[len("synthetic_"):]
    else:
        raise ValueError(f"source {name!r} is not ported yet")

    if ds is None:
        n = max_synth or _SYNTH_SIZES.get(kind, 20000)
        base = 32 if kind == "objects" else image_size
        # stable per-source seed offset (`datasets.py:301-307`)
        ds = _synthetic(kind, n, base, channels,
                        seed=seed + zlib.crc32(name.encode()) % 10000)

    imgs = ds.images
    if imgs.shape[3] != channels:
        if channels == 1:
            imgs = imgs.mean(axis=3, keepdims=True).astype(np.uint8)
        else:
            imgs = np.repeat(imgs, channels, axis=3)
    if imgs.shape[1] != image_size or imgs.shape[2] != image_size:
        if imgs.shape[1] == imgs.shape[2]:
            imgs = resize_bilinear_u8(imgs, image_size)
        else:
            imgs = resize_shorter_then_crop(imgs, image_size)
    ds = ArrayDataset(imgs, ds.labels)

    rng = np.random.default_rng(seed)
    if spec.class_filter is not None:
        idx = np.nonzero(np.isin(ds.labels, np.asarray(spec.class_filter)))[0]
        if spec.class_fraction is not None:
            idx = rng.choice(idx, size=int(len(idx) * spec.class_fraction),
                             replace=False)
        ds = ArrayDataset(ds.images[idx], ds.labels[idx])
    if spec.count is not None and spec.count < len(ds):
        idx = count_subset_indices(len(ds), spec.count, seed)
        ds = ArrayDataset(ds.images[idx], ds.labels[idx])
    return ds


def count_subset_indices(n: int, count: int, seed: int) -> np.ndarray:
    """``random.seed(999); random.sample(range(n), count)`` (`#z_score.py:89-91`)."""
    return np.asarray(_pyrandom.Random(seed).sample(range(n), count), np.int64)
