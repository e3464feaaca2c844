"""The DCGAN of Radford et al. (arXiv:1511.06434) at 64x64, as the PyTorch
DCGAN tutorial builds it, with the training step of the Strainer-GAN
scripts (`#%basic.py:237-288`, `# 상위 10% loss값...X.py:280-318`), in
plain PyTorch.

The step: D first (the real batch, then the detached fakes), D's Adam
step, then G's loss through the updated D, G's Adam step; BCE on
sigmoid outputs with torch's -100 log clamp; Adam with betas (0.5,
0.999), eps 1e-8.  With the in-step mask, a no-grad scoring forward of
the real batch in D's training mode (it updates D's running statistics
first) keeps the lanes whose sigmoid score is at or above the batch's
``q`` quantile, and both sides of D and G's BatchNorms train on the kept
lanes only.  A partial last batch is the first ``lane_count`` lanes.
Smaller batches are written as per-sample weights on full batches
(weighted means and weighted BatchNorm statistics), which is the same
arithmetic.

``Precision``: the forwards under bfloat16 autocast on the card, as the
configuration states (parameters, BatchNorm statistics, losses and Adam
in float32), or the same with every convolution's input and weight
rounded to fp8 (e4m3, one scale a tensor): the control, one precision
below the configuration's.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

EPS_BN = 1e-5
MOMENTUM = 0.1
FP8_MAX = 448.0


@dataclass(frozen=True)
class Precision:
    bf16: bool = True  # the forwards under bfloat16 autocast (on the card only)
    fp8: bool = False  # convolution inputs and weights rounded to e4m3


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to fp8 e4m3 with one scale, gradients passed straight
    through."""
    s = t.detach().abs().amax().float().clamp_min(1e-12) / FP8_MAX
    q = (t.detach().float() / s).to(torch.float8_e4m3fn).float() * s
    return t + (q.to(t.dtype) - t).detach()


def _conv(x, w, stride, pad, transpose, prec: Precision):
    if prec.fp8:
        x, w = _fp8(x), _fp8(w)
    if transpose:
        return F.conv_transpose2d(x, w, stride=stride, padding=pad)
    return F.conv2d(x, w, stride=stride, padding=pad)


def _amp(x: torch.Tensor, prec: Precision):
    if prec.bf16 and x.device.type == "cuda":
        return torch.autocast("cuda", dtype=torch.bfloat16, cache_enabled=False)
    return contextlib.nullcontext()


def batch_norm(x, p: Dict, pre: str, w: Optional[torch.Tensor], train: bool):
    """Weighted BatchNorm over every axis but the channel's; in training
    mode it updates the running statistics (unbiased variance)."""
    rm, rv = p[pre + "running_mean"], p[pre + "running_var"]
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if not train:
        mean, var = rm, rv
    else:
        xf = x.float()
        dims = (0,) + tuple(range(2, x.dim()))
        ww = (torch.ones(x.shape[0], device=x.device) if w is None else w.float())
        ww = ww.view((-1,) + (1,) * (x.dim() - 1))
        n = torch.clamp(ww.sum() * (x.numel() // (x.shape[0] * x.shape[1])), min=1.0)
        mean = (xf * ww).sum(dim=dims) / n
        var = (ww * (xf - mean.view(shape)) ** 2).sum(dim=dims) / n
        with torch.no_grad():
            unbiased = var.detach() * n / torch.clamp(n - 1.0, min=1.0)
            rm.copy_((1 - MOMENTUM) * rm + MOMENTUM * mean.detach())
            rv.copy_((1 - MOMENTUM) * rv + MOMENTUM * unbiased)
    a = p[pre + "weight"] * torch.rsqrt(var + EPS_BN)
    b = p[pre + "bias"] - mean * a
    return x * a.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)


G_SPECS = ((2, 0), (2, 1), (2, 1), (2, 1), (2, 1))  # (stride, pad) of G's convs
D_SPECS = ((2, 1), (2, 1), (2, 1), (2, 1), (1, 0))


def generator(p: Dict, z: torch.Tensor, w, prec: Precision) -> torch.Tensor:
    x = z.reshape(z.shape[0], -1, 1, 1)
    for i, (s, pad) in enumerate(G_SPECS):
        x = _conv(x, p[f"convs.{i}.weight"], s, pad, True, prec)
        if i < 4:
            x = F.relu(batch_norm(x, p, f"bns.{i}.", w, True))
    return torch.tanh(x.float()).to(x.dtype)


def d_stem(p: Dict, x, prec: Precision):
    h = F.leaky_relu(_conv(x, p["convs.0.weight"], 2, 1, False, prec), 0.2)
    return _conv(h, p["convs.1.weight"], 2, 1, False, prec)


def d_head(p: Dict, h, w, train: bool, prec: Precision):
    for i in range(3):
        h = F.leaky_relu(batch_norm(h, p, f"bns.{i}.", w, train), 0.2)
        s, pad = D_SPECS[i + 2]
        h = _conv(h, p[f"convs.{i + 2}.weight"], s, pad, False, prec)
    return h.reshape(h.shape[0]).float()


def discriminator(p: Dict, x, w, train: bool, prec: Precision):
    return d_head(p, d_stem(p, x, prec), w, train, prec)


def bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    probs = torch.sigmoid(logits.float())
    return F.binary_cross_entropy(probs, torch.full_like(probs, target), reduction="none")


def wmean(x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    if w is None:
        return x.mean()
    return (x * w).sum() / torch.clamp_min(w.sum(), 1.0)


def quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolation quantile of a 1-D tensor (``torch.quantile``)."""
    return torch.quantile(x.float(), q)


def adam_(p: Dict, names, grads: Dict, state: Dict, lr: float, b1: float, b2: float,
          eps: float = 1e-8) -> None:
    """Adam on the named leaves; ``state[name]`` = {"m", "v", "t"}."""
    with torch.no_grad():
        for n in names:
            g = grads[n]
            st = state.setdefault(n, {"m": torch.zeros_like(g), "v": torch.zeros_like(g),
                                      "t": 0})
            st["t"] += 1
            st["m"].mul_(b1).add_(g, alpha=1 - b1)
            st["v"].mul_(b2).addcmul_(g, g, value=1 - b2)
            bc1 = 1 - b1 ** st["t"]
            bc2 = 1 - b2 ** st["t"]
            denom = (st["v"].sqrt() / bc2 ** 0.5).add_(eps)
            p[n].addcdiv_(st["m"], denom, value=-lr / bc1)


def train_step(g: Dict, d: Dict, opt_g: Dict, opt_d: Dict, x: torch.Tensor,
               z: torch.Tensor, *, lr_g: float, lr_d: float, betas=(0.5, 0.999),
               d_train: bool = True, mask_q: Optional[float] = None,
               lane_count: Optional[int] = None, prec: Precision = Precision(),
               real_label: float = 1.0, fake_label: float = 0.0) -> Dict:
    """One step on the normalised NCHW batch ``x`` with noise ``z``; ``g``
    and ``d`` hold parameters and buffers by their names and are updated in
    place, ``opt_g`` and ``opt_d`` are the Adam states.  ``mask_q``: the
    in-step mask's quantile (None: no mask).  Returns the losses, the keep
    mask, the per-sample real losses and the gradients of this step."""
    b = x.shape[0]
    g_names = [n for n in g if ".running_" not in n]
    d_names = [n for n in d if ".running_" not in n]
    for p, names in ((g, g_names), (d, d_names)):
        for n in names:
            p[n].requires_grad_(True)
    valid = None if lane_count is None else torch.arange(b, device=x.device) < lane_count
    valid_w = None if valid is None else valid.float()
    keep = torch.ones(b, dtype=torch.bool, device=x.device) if valid is None else valid
    amp = _amp(x, prec)
    h_real = None
    if mask_q is not None:
        with amp:
            h_real = d_stem(d, x, prec)
            with torch.no_grad():
                logits_s = d_head(d, h_real, valid_w, d_train, prec)
        probs = torch.sigmoid(logits_s.float())
        if valid is None:
            keep = probs >= quantile(probs, mask_q)
        else:
            keep = (probs >= quantile(probs[valid], mask_q)) & valid
    w = keep.float() if mask_q is not None else valid_w
    with amp:
        fake = generator(g, z, w, prec)
    # D's update
    with amp:
        out_r = (d_head(d, h_real, w, d_train, prec) if h_real is not None
                 else discriminator(d, x, w, d_train, prec))
        out_f = discriminator(d, fake.detach(), w, d_train, prec)
    per_real, per_fake = bce(out_r, real_label), bce(out_f, fake_label)
    err_d = wmean(per_real, w) + wmean(per_fake, w)
    gd = torch.autograd.grad(err_d, [d[n] for n in d_names], allow_unused=True)
    grads_d = {n: (torch.zeros_like(d[n]) if v is None else v) for n, v in zip(d_names, gd)}
    adam_(d, d_names, grads_d, opt_d, lr_d, *betas)
    # G's update through the updated D
    with amp:
        out_g = discriminator(d, fake, w, d_train, prec)
    err_g = wmean(bce(out_g, real_label), w)
    gg = torch.autograd.grad(err_g, [g[n] for n in g_names], allow_unused=True)
    grads_g = {n: (torch.zeros_like(g[n]) if v is None else v) for n, v in zip(g_names, gg)}
    adam_(g, g_names, grads_g, opt_g, lr_g, *betas)
    for n in g_names:
        g[n].requires_grad_(False)
    for n in d_names:
        d[n].requires_grad_(False)
    return dict(errD=err_d.detach(), errG=err_g.detach(), keep=keep,
                per_real=per_real.detach(), grads_g=grads_g, grads_d=grads_d)


def d_as_trained(d: Dict, x: torch.Tensor, logit_mean: float, logit_std: float) -> Dict:
    """D's weights as a D some epochs into training stands in for them:
    each BatchNorm's running statistics set to the batch statistics that a
    training-mode float32 forward of the real batch ``x`` meets there
    (momentum 1), so that the evaluation-mode forward normalises as the
    training one does; then the last convolution scaled and moved along
    the mean of its input, so that the evaluation-mode logits of ``x``
    have mean ``logit_mean`` and spread ``logit_std`` (the per-sample
    losses of reals then spread as a trained D's do, not all at log 2)."""
    out = {k: v.clone() for k, v in d.items()}
    f32 = Precision(bf16=False)
    with torch.no_grad():
        h = d_stem(out, x, f32)
        for i in range(3):
            pre = f"bns.{i}."
            var, mean = torch.var_mean(h.float(), dim=(0, 2, 3), unbiased=True)
            out[pre + "running_mean"] = mean.clone()
            out[pre + "running_var"] = var.clone()
            h = F.leaky_relu(batch_norm(h, out, pre, None, False), 0.2)
            if i < 2:
                s, pad = D_SPECS[i + 2]
                h = _conv(h, out[f"convs.{i + 2}.weight"], s, pad, False, f32)
        w = out["convs.4.weight"]
        flat = h.reshape(h.shape[0], -1).double()
        logits = flat @ w.reshape(-1).double()
        mu = flat.mean(dim=0)
        a = logit_std / float(logits.std())
        b = logit_mean - a * float(logits.mean())
        new = a * w.reshape(-1).double() + b * mu / float(mu.dot(mu))
        out["convs.4.weight"] = new.reshape(w.shape).to(w.dtype)
    return out
