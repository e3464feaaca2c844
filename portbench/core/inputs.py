"""Inputs and weights made on the device, in a few large calls.  The
images' content and the feature trunk's weights come from seeds that the
configuration fixes (a data set and a pretrained trunk are the same for
every run); ``--seed`` draws the images' order, G's and D's weights and
the noise.  So every seed does the same amount of work (the prefilter
keeps the same rows, the strain as many), in another order.  The same
seed gives the same bytes; the port and the reference get the same
tensors.

Images stand in for CelebA (``faces``) and CIFAR-10 (``objects``), which
are on neither machine: two visibly different distributions, each image
with its own brightness, contrast and low-frequency structure, so that
D's per-sample scores and the feature trunk's z-scores spread as they do
on real images (a set of identical statistics would put every score in
one blob).  ``faces`` are smooth, warm-tinted fields of three octaves;
``objects`` are high-frequency texture over a two-octave field.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

BLOCK = 8192  # images made by one set of calls
_TINT = (0.25, 0.05, -0.05)  # the faces' warm tint, per channel
_STREAMS = {"images": 1, "dcgan": 2, "trunk": 3, "order": 5}
_MOD = 2 ** 63 - 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    """The seeded generator of one input stream (images, weights, order),
    on ``device``; streams of one seed differ, and any whole number is a
    seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + _STREAMS[stream]) % _MOD)
    return g


def _field(gen, n: int, size: int, octaves: int, device) -> torch.Tensor:
    """(n, 3, size, size) low-frequency field in [-1, 1]: octaves of coarse
    normal draws upsampled by repetition, weighted 2^-o, each image scaled
    by its largest magnitude."""
    x = torch.zeros((n, 3, size, size), device=device)
    for o in range(octaves):
        res = 2 ** (o + 2)
        c = torch.randn((n, 3, res, res), generator=gen, device=device)
        x += F.interpolate(c, size=(size, size), mode="nearest") / (2.0 ** o)
    return x / x.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-6)


def _block(kind: str, gen, n: int, size: int, device) -> torch.Tensor:
    """(n, size, size, 3) uint8 images of one kind."""
    if kind == "faces":
        x = _field(gen, n, size, 3, device)
        tint = torch.tensor(_TINT, device=device).view(1, 3, 1, 1)
        base = ((x * 0.5 + 0.5) * 0.8 + tint + 0.1).clamp(0, 1)
    elif kind == "objects":
        fine = torch.randn((n, 3, size, size), generator=gen, device=device)
        base = (0.5 + 0.25 * fine + 0.25 * _field(gen, n, size, 2, device)).clamp(0, 1)
    else:
        raise ValueError(f"unknown image kind {kind!r}")
    contrast = torch.rand((n, 1, 1, 1), generator=gen, device=device) * 0.5 + 0.5
    offset = (torch.rand((n, 1, 1, 1), generator=gen, device=device) - 0.5) * 0.3
    y = ((base - 0.5) * contrast + 0.5 + offset).clamp(0, 1)
    return (y * 255.0).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def make_images(sources: Sequence[Dict], mixer: str, size: int, content_seed: int,
                order_seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 NHWC images and int32 source ids (0 = the primary source) of
    the configuration's sources.  The images are drawn from
    ``content_seed``: a data set is the same for every run, as CelebA is.
    ``mixer``: ``labeled`` keeps the sources in order; ``shuffled`` places
    them by a permutation drawn from ``order_seed``."""
    gen = generator(content_seed, "images", device)
    n = sum(int(s["count"]) for s in sources)
    images = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    source_id = torch.empty((n,), dtype=torch.int32, device=device)
    if mixer == "shuffled":
        rows = torch.randperm(n, generator=generator(order_seed, "order", device),
                              device=device)
    elif mixer == "labeled":
        rows = torch.arange(n, device=device)
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    lo = 0
    for sid, s in enumerate(sources):
        count = int(s["count"])
        for b in range(0, count, BLOCK):
            m = min(BLOCK, count - b)
            idx = rows[lo + b:lo + b + m]
            images.index_copy_(0, idx, _block(s["kind"], gen, m, size, device))
        source_id[rows[lo:lo + count]] = sid
        lo += count
    return images, source_id


def dcgan_shapes(nz: int, ngf: int, ndf: int, nc: int) -> Tuple[Dict, Dict]:
    """Parameter shapes of the DCGAN's G and D by their state-dict names."""
    g_convs = [(nz, ngf * 8), (ngf * 8, ngf * 4), (ngf * 4, ngf * 2), (ngf * 2, ngf), (ngf, nc)]
    d_convs = [(nc, ndf), (ndf, ndf * 2), (ndf * 2, ndf * 4), (ndf * 4, ndf * 8), (ndf * 8, 1)]
    # ConvTranspose2d weights are (in, out, k, k); Conv2d weights (out, in, k, k)
    g = {f"convs.{i}.weight": (ci, co, 4, 4) for i, (ci, co) in enumerate(g_convs)}
    d = {f"convs.{i}.weight": (co, ci, 4, 4) for i, (ci, co) in enumerate(d_convs)}
    for i, (_, co) in enumerate(g_convs[:-1]):
        g.update({f"bns.{i}.{k}": (co,) for k in ("weight", "bias", "running_mean",
                                                  "running_var")})
    for i, c in enumerate((ndf * 2, ndf * 4, ndf * 8)):
        d.update({f"bns.{i}.{k}": (c,) for k in ("weight", "bias", "running_mean",
                                                 "running_var")})
    return g, d


def _split(flat: torch.Tensor, shapes: List[Tuple[str, tuple]]) -> Dict[str, torch.Tensor]:
    out, at = {}, 0
    for name, shape in shapes:
        k = _numel(shape)
        out[name] = flat[at:at + k].view(shape).clone()
        at += k
    return out


def dcgan_weights(model: Dict, seed: int, device) -> Tuple[Dict, Dict]:
    """G's and D's weights as the DCGAN initialises them (`weights_init`:
    conv weights N(0, 0.02), BatchNorm scales N(1, 0.02), biases 0), from
    two normal draws; running statistics 0 and 1."""
    gen = generator(seed, "dcgan", device)
    gs, ds = dcgan_shapes(model["nz"], model["ngf"], model["ndf"], model["nc"])
    out = []
    for shapes in (gs, ds):
        conv = [(k, v) for k, v in shapes.items() if k.startswith("convs.")]
        scale = [(k, v) for k, v in shapes.items()
                 if k.startswith("bns.") and k.endswith(".weight")]
        w = _split(torch.randn((sum(_numel(v) for _, v in conv),), generator=gen,
                               device=device) * 0.02, conv)
        w.update(_split(1.0 + 0.02 * torch.randn((sum(_numel(v) for _, v in scale),),
                                                 generator=gen, device=device), scale))
        for k, v in shapes.items():
            if k.endswith(".bias") or k.endswith(".running_mean"):
                w[k] = torch.zeros(v, device=device)
            elif k.endswith(".running_var"):
                w[k] = torch.ones(v, device=device)
        out.append(w)
    return out[0], out[1]


def _numel(shape) -> int:
    k = 1
    for s in shape:
        k *= s
    return k


def resnet18_shapes(in_ch: int = 3) -> Dict[str, tuple]:
    """torchvision names and shapes of the ResNet18 trunk (no ``fc``)."""
    shapes = {"conv1.weight": (64, in_ch, 7, 7)}
    bn = lambda p, c: {f"{p}.{k}": (c,) for k in ("weight", "bias", "running_mean",  # noqa: E731
                                                   "running_var")}
    shapes.update(bn("bn1", 64))
    cin = 64
    for stage, w in enumerate((64, 128, 256, 512)):
        for i in range(2):
            p = f"layer{stage + 1}.{i}"
            stride = 2 if (stage > 0 and i == 0) else 1
            shapes[f"{p}.conv1.weight"] = (w, cin, 3, 3)
            shapes.update(bn(f"{p}.bn1", w))
            shapes[f"{p}.conv2.weight"] = (w, w, 3, 3)
            shapes.update(bn(f"{p}.bn2", w))
            if i == 0 and (stride != 1 or cin != w):
                shapes[f"{p}.downsample.0.weight"] = (w, cin, 1, 1)
                shapes.update(bn(f"{p}.downsample.1", w))
            cin = w
    return shapes


def resnet18_weights(seed: int, device, in_ch: int = 3) -> Dict[str, torch.Tensor]:
    """The feature trunk's weights, drawn as a torchvision ResNet18 is
    initialised (convolutions He-normal in their fan-in) with BatchNorms
    that are not the identity (scales N(1, 0.1), biases N(0, 0.05),
    running means N(0, 0.1), running variances U(0.5, 1.5)); one normal
    and one uniform draw."""
    gen = generator(seed, "trunk", device)
    shapes = list(resnet18_shapes(in_ch).items())
    normal = torch.randn((sum(_numel(v) for _, v in shapes),), generator=gen, device=device)
    unif = torch.rand((sum(_numel(v) for _, v in shapes),), generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes:
        k = _numel(shape)
        z, u = normal[at:at + k].view(shape), unif[at:at + k].view(shape)
        at += k
        if name.endswith("running_var"):
            v = 0.5 + u
        elif name.endswith("running_mean"):
            v = 0.1 * z
        elif name.endswith(".bias"):
            v = 0.05 * z
        elif len(shape) == 1:
            v = 1.0 + 0.1 * z
        else:
            v = z * (2.0 / _numel(shape[1:])) ** 0.5
        out[name] = v.clone()
    return out
