"""Array-backed datasets (counterpart of `strainer_gan_tpu/data/datasets.py`).

Every source becomes one uint8 NHWC array at build time.  Real data is read
from ``$STRAINER_DATA_ROOT`` or ``./data`` when it is there (CIFAR-10
pickle batches, image folders); otherwise the deterministic synthetic
generators stand in.
The generators are numpy copies of the reference's, and the resize, the
crop and the mixture's gather run through the port's own copy of the
reference's C++ staging library (``native/``), so the same seed gives
byte-identical arrays in both packages (tests/test_torch_slice.py,
tests/test_torch_native.py, tests/test_torch_mnist_data.py).  MNIST's idx
files (raw or ``.gz``) are read from the same roots.  The numpy versions of the resize and the
crop stay here as ``*_plain``, the plain versions the library is held to.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import random as _pyrandom
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import native
from ..config import SourceSpec
from ..ops.stats import fma_f32


@dataclass
class ArrayDataset:
    """images: uint8 NHWC; labels: int32."""

    images: np.ndarray
    labels: np.ndarray

    def __len__(self):
        return self.images.shape[0]


# ---------------------------------------------------------------------------
# host-side transforms (build-time only)


def _triangle_taps(in_size: int, out_size: int):
    """The PIL-style triangle filter of the host-staging library
    (``native/host_staging.cc``, `strainer_gan_tpu/native/host_staging.cc:51-79`), as taps:
    ``first`` (out,) source index of each output's first tap, ``count``
    (out,) its number of taps and ``w`` (out, taps) float32 weights,
    normalised per output, zero past an output's last tap.  Support widens
    with the scale when downsampling."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    rows = []
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
        rows.append((xmin, w))
    taps = max(len(w) for _, w in rows)
    first = np.asarray([lo for lo, _ in rows], np.int64)
    count = np.asarray([len(w) for _, w in rows], np.int64)
    weights = np.zeros((out_size, taps), np.float32)
    for x, (_, w) in enumerate(rows):
        weights[x, :len(w)] = w
    return first, count, weights


def _resample_axis(x: np.ndarray, axis: int, out_size: int,
                   grouped: bool = False) -> np.ndarray:
    """One pass of the filter along ``axis`` of a float32 array, tap by tap
    in float32 as `host_staging.cc:98-129` accumulates ``acc += w*px``.
    The library is built with ``g++ -O3 -march=native``
    (``native/__init__.py``), which on a CPU with FMA
    fuses each tap into one multiply-add.  In the vertical pass
    (``grouped``) GCC also vectorises the sum four taps at a time: it
    multiplies a group of four in one vector instruction and adds the four
    rounded products in order, and fuses only the taps left after the last
    full group.  A zero weight past an output's last tap leaves the sum as
    it is."""
    first, count, weights = _triangle_taps(x.shape[axis], out_size)
    shape = [1] * x.ndim
    shape[axis] = out_size
    fused_from = (count // 4 * 4 if grouped else np.zeros_like(count)).reshape(shape)
    acc = np.zeros(x.shape[:axis] + (out_size,) + x.shape[axis + 1:], np.float32)
    for k in range(weights.shape[1]):
        w = weights[:, k].reshape(shape)
        px = np.take(x, np.minimum(first + k, x.shape[axis] - 1), axis=axis)
        fused = fma_f32(torch.from_numpy(w), torch.from_numpy(px),
                        torch.from_numpy(acc)).numpy()
        acc = np.where(k < fused_from, acc + w * px, fused) if grouped else fused
    return acc


def resize_bilinear_u8_plain(images: np.ndarray, size: int) -> np.ndarray:
    """The plain version of ``resize_bilinear_u8``: a separable
    triangle-filter resize of uint8 NHWC images, byte-identical to the
    native library (`host_staging.cc:92-135`): a horizontal pass into
    float32, then a vertical pass, each summed tap by tap in the order and
    with the roundings of the compiled library (``_resample_axis``), and
    the result rounded half up (``(int)(v + 0.5f)``) and clamped to
    [0, 255]."""
    n, h, w, c = images.shape
    if h == size and w == size:
        return images
    out = np.empty((n, size, size, c), np.uint8)
    step = 512
    for lo in range(0, n, step):
        x = images[lo:lo + step].astype(np.float32)
        acc = _resample_axis(_resample_axis(x, 2, size), 1, size, grouped=True)
        acc = (acc + np.float32(0.5)).astype(np.int32)
        out[lo:lo + step] = np.clip(acc, 0, 255).astype(np.uint8)
    return out


def resize_bilinear_u8(images: np.ndarray, size: int) -> np.ndarray:
    """Triangle-filter resize of uint8 NHWC images to (size, size), through
    the port's host-staging library (``native``)."""
    if images.shape[1] == size and images.shape[2] == size:
        return images
    return native.resize_bilinear_u8(images, size)


def center_crop_plain(images: np.ndarray, size: int) -> np.ndarray:
    h, w = images.shape[1:3]
    top = (h - size) // 2
    left = (w - size) // 2
    return np.ascontiguousarray(images[:, top:top + size, left:left + size])


def center_crop(images: np.ndarray, size: int) -> np.ndarray:
    """The central (size, size) window of uint8 NHWC images, through the
    host-staging library."""
    return native.center_crop_u8(images, size)


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


def data_roots():
    """Where real datasets are looked for, in order: ``$STRAINER_DATA_ROOT``,
    then ``./data``, as the JAX package looks
    (`strainer_gan_tpu/data/datasets.py:31-35`; its third root, a fixed
    absolute path, is not hard-coded here: point ``$STRAINER_DATA_ROOT``
    at it)."""
    return [os.environ.get("STRAINER_DATA_ROOT", ""), "./data"]


def _find(relpaths) -> Optional[str]:
    for root in data_roots():
        if not root:
            continue
        for rel in relpaths:
            p = os.path.join(root, rel)
            if os.path.exists(p):
                return p
    return None


def _load_mnist_disk() -> Optional[ArrayDataset]:
    """MNIST's training idx files (`strainer_gan_tpu/data/datasets.py:129-152`):
    images (N, 28, 28, 1) uint8 and their int32 labels, raw or gzipped."""
    img_p = _find(["MNIST/raw/train-images-idx3-ubyte",
                   "MNIST/raw/train-images-idx3-ubyte.gz",
                   "mnist/train-images-idx3-ubyte"])
    if img_p is None:
        return None
    lbl_p = img_p.replace("images-idx3", "labels-idx1")

    def read(path):
        with (gzip.open if path.endswith(".gz") else open)(path, "rb") as f:
            return f.read()

    raw = read(img_p)
    _, n, h, w = struct.unpack(">IIII", raw[:16])
    images = np.frombuffer(raw, np.uint8, offset=16).reshape(n, h, w, 1)
    labels = np.frombuffer(read(lbl_p), np.uint8, offset=8).astype(np.int32)
    return ArrayDataset(images.copy(), labels)


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


SYNTH_CHUNK = 256  # images a host thread finishes at a time


def _field_draws(rng, n, ch, octaves):
    """The coarse normal draws of a smooth field, one (n, res, res, ch)
    float32 array an octave (res = 4, 8, 16), in the reference's order."""
    return [rng.standard_normal((n, 2 ** (o + 2), 2 ** (o + 2), ch)).astype(np.float32)
            for o in range(octaves)]


def _smooth_field(coarse, lo, hi, size):
    """Images ``lo:hi`` of the reference's low-frequency field
    (`strainer_gan_tpu/data/datasets.py:211-223`): each octave upsampled by
    pixel repetition, a broadcast equal to its ``np.kron`` with ones, summed
    octave by octave at weight 2^-o, then divided by each image's largest
    magnitude.  The same float32 operations in the same order as the
    reference's, so the same bits."""
    img = np.zeros((hi - lo, size, size, coarse[0].shape[3]), np.float32)
    for o, c in enumerate(coarse):
        c = c[lo:hi]
        m, res, _, ch = c.shape
        reps = size // res
        up = np.broadcast_to(c[:, :, None, :, None, :], (m, res, reps, res, reps, ch))
        img += up.reshape(m, size, size, ch) / (2.0**o)
    return img / np.abs(img).max(axis=(1, 2, 3), keepdims=True).clip(1e-6)


def _digit_draws(rng, m, size):
    """The next ``m`` digits' draws in the reference's order
    (`strainer_gan_tpu/data/datasets.py:246-256`): each image's centre
    ``cx, cy`` (float64), then its (size, size) float64 noise."""
    centres = np.empty((m, 2))
    noise = np.empty((m, size, size))
    for i in range(m):
        centres[i] = rng.uniform(-0.1, 0.1, 2)
        noise[i] = rng.normal(0, 0.05, (size, size))
    return centres, noise


def _digits(labels, centres, noise, size):
    """The reference's strokes for a batch of images, as uint8: its
    per-image arithmetic on the batch.  The float32 grid less each image's
    float64 centre promotes to float64 as the reference's scalar does
    (NumPy 2 typing), and every operation is element-wise, so batching
    changes no value."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size - 0.5
    d = labels.reshape(-1, 1, 1)
    cx = centres[:, 0].reshape(-1, 1, 1).astype((xx - np.float64(0.0)).dtype)
    cy = centres[:, 1].reshape(-1, 1, 1).astype((yy - np.float64(0.0)).dtype)
    r = 0.25 + 0.02 * d
    ring = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) ** 0.5 - r) ** 2 / 0.004)
    ring = np.where(d % 2 == 1, ring * (xx > cx - 0.05).astype(np.float32), ring)
    img = np.clip(ring + noise, 0, 1).astype(np.float32)
    return (img * 255).astype(np.uint8)


def _synthetic_digits(rng, n: int, size: int, ch: int) -> ArrayDataset:
    """The ``digits`` kind (strokes in channel 0, any others 0): the main
    thread makes the draws ``SYNTH_CHUNK`` images at a time, in the
    reference's order, while host threads finish the chunks already
    drawn."""
    labels = rng.integers(0, 10, n).astype(np.int32)
    out = np.zeros((n, size, size, ch), np.uint8)

    def finish(lo, hi, centres, noise):
        out[lo:hi, :, :, 0] = _digits(labels[lo:hi], centres, noise, size)

    with ThreadPoolExecutor(native.threads()) as pool:
        done = [pool.submit(finish, lo, min(lo + SYNTH_CHUNK, n),
                            *_digit_draws(rng, min(lo + SYNTH_CHUNK, n) - lo, size))
                for lo in range(0, n, SYNTH_CHUNK)]
        for f in done:
            f.result()
    return ArrayDataset(out, labels)


def _synthetic(kind: str, n: int, size: int, ch: int, seed: int) -> ArrayDataset:
    """`strainer_gan_tpu/data/datasets.py:226-260`, byte for byte.  The random draws are made first, in the
    reference's order; the images are then finished ``SYNTH_CHUNK`` at a
    time on host threads (numpy's element-wise loops release the GIL), each
    with the reference's operations, so chunking changes no byte."""
    rng = np.random.default_rng(seed)
    if kind == "faces":  # smooth, warm-tinted
        coarse = _field_draws(rng, n, ch, 3)
        bias = np.array([0.25, 0.05, -0.05])[:ch].reshape(1, 1, 1, ch)

        def finish(lo, hi):
            x = _smooth_field(coarse, lo, hi, size)
            return np.clip((x * 0.5 + 0.5) * 0.8 + bias + 0.1, 0, 1)
        labels = np.zeros(n, np.int32)
    elif kind == "objects":  # high-frequency texture (CIFAR-like)
        fine = rng.standard_normal((n, size, size, ch)).astype(np.float32)
        coarse = _field_draws(rng, n, ch, 2)

        def finish(lo, hi):
            x = _smooth_field(coarse, lo, hi, size)
            return np.clip(0.5 + 0.25 * fine[lo:hi] + 0.25 * x, 0, 1)
        labels = rng.integers(0, 10, n).astype(np.int32)
    elif kind == "anime":  # flat saturated patches
        coarse = _field_draws(rng, n, ch, 2)

        def finish(lo, hi):
            x = _smooth_field(coarse, lo, hi, size)
            return np.clip(np.round(x * 2.0) / 2.0 * 0.5 + 0.5, 0, 1)
        labels = np.zeros(n, np.int32)
    elif kind == "digits":  # sparse strokes on black (MNIST-like)
        return _synthetic_digits(rng, n, size, ch)
    else:
        raise ValueError(f"unknown synthetic kind {kind!r}")
    out = np.empty((n, size, size, ch), np.uint8)

    def run(lo):
        hi = min(lo + SYNTH_CHUNK, n)
        out[lo:hi] = (finish(lo, hi) * 255).astype(np.uint8)

    with ThreadPoolExecutor(native.threads()) as pool:
        list(pool.map(run, range(0, n, SYNTH_CHUNK)))
    return ArrayDataset(out, labels)


_SYNTH_SIZES = {"faces": 20000, "objects": 50000, "anime": 6000, "digits": 60000}


def load_source(spec: SourceSpec, image_size: int, channels: int, seed: int,
                max_synth: Optional[int] = None) -> ArrayDataset:
    """`strainer_gan_tpu/data/datasets.py:270-334`: one SourceSpec -> uint8
    array at the target resolution."""
    name = spec.name
    ds: Optional[ArrayDataset] = None
    if name == "mnist":
        ds = _load_mnist_disk()
        kind = "digits"
    elif name == "cifar10":
        ds = _load_cifar10_disk()
        kind = "objects"
    elif name == "celeba":
        ds = _load_image_folder(["celeba", "img_align_celeba"])
        kind = "faces"
    elif name == "anime":
        ds = _load_image_folder(["anime"])
        kind = "anime"
    elif name.startswith("synthetic_"):
        kind = name[len("synthetic_"):]
    else:
        raise ValueError(f"source {name!r} is not ported yet")

    if ds is None:
        n = max_synth or _SYNTH_SIZES.get(kind, 20000)
        base = 32 if kind == "objects" else (28 if kind == "digits" else image_size)
        # stable per-source seed offset (`datasets.py:301-307`)
        ds = _synthetic(kind, n, base, channels,
                        seed=seed + zlib.crc32(name.encode()) % 10000)

    # the selection below reads only labels and counts, and the transforms
    # act image by image, so selecting first gives the reference's arrays
    # while resizing only the images kept
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
    return ArrayDataset(imgs, ds.labels)


def count_subset_indices(n: int, count: int, seed: int) -> np.ndarray:
    """``random.seed(999); random.sample(range(n), count)`` (`#z_score.py:89-91`)."""
    return np.asarray(_pyrandom.Random(seed).sample(range(n), count), np.int64)
