"""GAN losses (counterpart of `strainer_gan_tpu/ops/losses.py`).

The reference feeds sigmoid outputs to ``nn.BCELoss`` (`#%basic.py:205`),
whose log terms are clamped at -100.  D returns logits here, and the loss
materialises p = sigmoid(x) in float32 and takes the clamped logs the torch
way, so loss values carry the same float32 sigmoid rounding as the
reference and every loss-ordering strain decision matches.

``bce_from_logits`` is also the plain version of the K1 CUDA kernel
(``kernels/bce.py``).  Its backward is torch's ``binary_cross_entropy``
backward, ``(p - t) / max(p (1 - p), 1e-12)`` (`losses.py:39-66`), which
keeps gradients finite when D saturates (p == 0 or 1 in float32).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..parallel import mesh as M

_CLAMP = 100.0
_TINY = torch.finfo(torch.float32).tiny  # smallest normal float32

Target = Union[float, torch.Tensor]


class _BCEFromProbs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, probs, target):
        log_p = torch.clamp_min(torch.log(probs), -_CLAMP)
        log_1mp = torch.clamp_min(torch.log1p(-probs), -_CLAMP)
        ctx.save_for_backward(probs, target)
        return -(target * log_p + (1.0 - target) * log_1mp)

    @staticmethod
    def backward(ctx, grad):
        p, t = ctx.saved_tensors
        denom = torch.clamp_min(p * (1.0 - p), 1e-12)  # torch EPSILON clamp
        return grad * (p - t) / denom, None


def bce_from_probs(probs: torch.Tensor, target: Target) -> torch.Tensor:
    """``nn.BCELoss(reduction='none')`` on float32 probabilities."""
    probs = probs.to(torch.float32)
    if isinstance(target, torch.Tensor):
        t = target.to(dtype=torch.float32, device=probs.device)
    else:
        # a fill on the device, not a copy from the host: the train step
        # must stay capturable in a CUDA graph
        t = torch.full((), target, dtype=torch.float32, device=probs.device)
    return _BCEFromProbs.apply(probs, t)


def sigmoid_ftz(logits: torch.Tensor) -> torch.Tensor:
    """float32 sigmoid with a subnormal result flushed to 0, as XLA computes
    it for the JAX package (logits below about -87.3): the loss is then the
    clamp's 100, where torch's subnormal p would give up to 11.4 less."""
    p = torch.sigmoid(logits.to(torch.float32))
    return torch.where(p < _TINY, 0.0, p)


def bce_from_logits(logits: torch.Tensor, target: Target) -> torch.Tensor:
    """Per-element BCE(sigmoid(logits), target) with torch's -100 clamp."""
    return bce_from_probs(sigmoid_ftz(logits), target)


def weighted_mean(per_sample: torch.Tensor,
                  weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over weighted lanes == torch's mean over a variable-size batch.

    Inside a sharded train step (``parallel.mesh.batch_sharded``) this is
    the rank's share of the global batch's mean: its lanes' weighted sum
    over the global weight sum, or its lanes' mean over the world size
    without weights (every rank holds as many lanes).  The ranks' shares
    sum to the global mean, and their gradients to its gradient."""
    if weights is None:
        m = per_sample.mean()
        return m / M.dp_world() if M.sharded() else m
    w = weights.to(per_sample.dtype)
    wsum = w.sum()
    if M.sharded():
        wsum = M.all_reduce_(wsum.detach().clone())
    return (per_sample * w).sum() / torch.clamp_min(wsum, 1.0)


def d_loss(real_per_sample: torch.Tensor, fake_per_sample: torch.Tensor,
           reduction: str = "sum", real_weights: Optional[torch.Tensor] = None,
           fake_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """errD = real + fake (`#%basic.py:270`) or (real + fake) / 2 (`#8.py:130`)."""
    r = weighted_mean(real_per_sample, real_weights)
    f = weighted_mean(fake_per_sample, fake_weights)
    if reduction == "sum":
        return r + f
    if reduction == "half_mean":
        return (r + f) / 2.0
    raise ValueError(f"unknown reduction {reduction!r}")
