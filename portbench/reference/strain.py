"""The loss-percentile strain of `# final.py:343-374`, in plain PyTorch:
per-sample BCE(D(x), 1) with D in evaluation mode, in float32 (TF32 off:
the strain decisions are stated in float32), over the rows of the
permanent base; the threshold is the ``(1 - loss_ratio) * 100``-th
percentile of those losses (linear interpolation, in float64), and a row
is kept where its loss is below it (if none is, the lower half by rank).

``tf32`` scores in TF32: the control, one precision below float32."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .dcgan import Precision, bce, discriminator
from .resnet import matmul_precision, normalize


def d_losses(d: Dict, images: torch.Tensor, rows: torch.Tensor, batch: int = 1024,
             tf32: bool = False, real_label: float = 1.0) -> torch.Tensor:
    """(len(rows),) float32 losses of the images ``rows``."""
    out = torch.empty((rows.shape[0],), dtype=torch.float32, device=images.device)
    prec = Precision(bf16=False)
    with torch.no_grad(), matmul_precision(tf32):
        for lo in range(0, rows.shape[0], batch):
            x = normalize(images.index_select(0, rows[lo:lo + batch]))
            out[lo:lo + batch] = bce(discriminator(d, x, None, False, prec), real_label)
    return out


def percentile_keep(losses: torch.Tensor, loss_ratio: float) -> Tuple[torch.Tensor, float]:
    """(kept mask over ``losses``, threshold)."""
    q = (1.0 - loss_ratio) * 100.0
    xs = torch.sort(losses.double()).values
    n = xs.shape[0]
    pos = q / 100.0 * max(n - 1, 0)
    lo, hi = int(pos // 1), min(int(-(-pos // 1)), n - 1)
    thr = float(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))
    kept = losses.double() < thr
    if not bool(kept.any()):
        order = torch.argsort(losses, stable=True)
        kept = torch.zeros_like(kept)
        kept[order[:max(n // 2, 1)]] = True
    return kept, thr
