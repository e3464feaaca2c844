"""Console logging, loss histories and step timings (counterpart of
`strainer_gan_tpu/obs/metrics.py`).

Keeps the reference's console formats: ``[e/E][i/I]\\tLoss_D: ...`` every
``log_every`` iterations (`#%basic.py:291-294`), or for the MNIST MLPs
(``style="mnist"``) ``Epoch [e/E] Step [i/I] d_loss: ... g_loss: ...``
(`#8.py:140-141`, epoch and step counted from 1), and the strain report
``Epoch N: Removed K outliers.`` (`#z_score.py:321`), and the in-step
mask's ``Epoch N: Filtered CIFAR-10 images: a/b`` (`# 상위 10%...X.py:335-337`).  Loss histories stay
device tensors until first read, so collecting them never waits for the
card; only a console print reads scalars back: one fetch for a step's
print (``log_step``), one for all the prints of a chunk (``log_chunk``),
with the same text, each a ``host_read.log`` (``obs.profiler``).
Timings are the host's clock between consecutive ``log_step`` /
``log_chunk`` calls, kept as (seconds, steps) per call and
spread evenly over the call's steps (`metrics.py:82-84`); once the launch
queue is full they follow the device.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List, Tuple

import torch

from ..parallel.multihost import is_primary
from .profiler import host_read

PRINTED = ("errD", "errG", "D_x", "D_G_z1", "D_G_z2")


class Silent:
    """The console of a rank other than 0: writes nothing."""

    def write(self, text: str) -> int:
        return len(text)

    def flush(self) -> None:
        pass


class MetricsLogger:
    """``G_losses`` / ``D_losses`` / ``step_times`` are read-only views built
    afresh at each read (the losses with one device fetch each).

    ``collect=False`` keeps no loss series (`strainer_gan_tpu/obs/metrics.py:39-44`):
    a Trainer with such a logger also keeps no mask or per-sample loss
    history and draws no fixed-noise grids, which lets its strain epochs
    take the deferred-stats path."""

    def __init__(self, log_every: int = 50, stream=None, style: str = "dcgan",
                 collect: bool = True):
        self.log_every = log_every
        self.style = style
        self.collect = collect
        # under a process group only rank 0 prints
        self.stream = stream or (sys.stdout if is_primary() else Silent())
        self._g_parts: List[torch.Tensor] = []  # a step's 0-d loss or a chunk's (n,)
        self._d_parts: List[torch.Tensor] = []
        self._timings: List[Tuple[float, int]] = []  # (host seconds, steps) per call
        self._last = time.perf_counter()

    @staticmethod
    def _series(parts: List[torch.Tensor]) -> List[float]:
        return torch.cat([p.reshape(-1) for p in parts]).tolist() if parts else []

    @property
    def G_losses(self) -> List[float]:
        return self._series(self._g_parts)

    @property
    def D_losses(self) -> List[float]:
        return self._series(self._d_parts)

    @property
    def step_times(self) -> List[float]:
        return [dt / n for dt, n in self._timings for _ in range(n)]

    def _record(self, metrics: Dict[str, torch.Tensor], n: int) -> None:
        if self.collect:
            self._g_parts.append(metrics["errG"])
            self._d_parts.append(metrics["errD"])
        now = time.perf_counter()
        self._timings.append((now - self._last, n))
        self._last = now

    def _print(self, epoch: int, num_epochs: int, it: int, steps: int, vals) -> None:
        if self.style == "mnist":
            self.stream.write("Epoch [%d/%d] Step [%d/%d] d_loss: %.5f g_loss: %.5f\n"
                              % (epoch + 1, num_epochs, it + 1, steps, vals[0], vals[1]))
            return
        self.stream.write(
            "[%d/%d][%d/%d]\tLoss_D: %.4f\tLoss_G: %.4f\t"
            "D(x): %.4f\tD(G(z)): %.4f / %.4f\n"
            % (epoch, num_epochs, it, steps, *vals)
        )

    def log_step(self, epoch: int, num_epochs: int, it: int, steps: int,
                 metrics: Dict[str, torch.Tensor]) -> None:
        self._record(metrics, 1)
        if self.log_every and it % self.log_every == 0:
            with host_read("log"):
                vals = torch.stack([metrics[k].to(torch.float32) for k in PRINTED]).tolist()
            self._print(epoch, num_epochs, it, steps, vals)

    def log_chunk(self, epoch: int, num_epochs: int, it0: int, steps: int,
                  metrics: Dict[str, torch.Tensor], n: int) -> None:
        """Record ``n`` steps from ``it0`` whose metrics are stacked (n, ...)
        (`strainer_gan_tpu/obs/metrics.py:122-141`)."""
        self._record(metrics, n)
        if not self.log_every:
            return
        js = [j for j in range(n) if (it0 + j) % self.log_every == 0]
        if js:
            with host_read("log"):
                rows = torch.stack([metrics[k].to(torch.float32)[js] for k in PRINTED],
                                   dim=1).tolist()
            for j, vals in zip(js, rows):
                self._print(epoch, num_epochs, it0 + j, steps, vals)

    def log_strain(self, epoch: int, removed: int, remaining: int) -> None:
        self.stream.write(
            f"Epoch {epoch}: Removed {removed} outliers. "
            f"{remaining} samples remaining.\n"
        )

    def log_contamination(self, epoch: int, filtered: int, total: int) -> None:
        # `# 상위 10%...X.py:335-337`
        self.stream.write(f"Epoch {epoch}: Filtered CIFAR-10 images: {filtered}/{total}\n")

    def summary(self) -> Dict:
        """Steps, mean host seconds per step past the first two calls
        (warm-up; a call is a step or a chunk), and the last losses
        (`strainer_gan_tpu/obs/metrics.py:155-172`)."""
        g, d = self.G_losses, self.D_losses
        k = 2 if len(self._timings) > 2 else max(len(self._timings) - 1, 0)
        tail = self._timings[k:]
        return dict(
            steps=sum(n for _, n in self._timings),
            mean_step_time=(sum(dt for dt, _ in tail) / max(sum(n for _, n in tail), 1)
                            if tail else 0.0),
            last_G_loss=g[-1] if g else None,
            last_D_loss=d[-1] if d else None,
        )
