"""Parameter accounting and the finite-check rail over modules (counterpart
of `strainer_gan_tpu/utils/trees.py`, which walks the flax parameter
trees).  Each function takes one or more ``nn.Module`` and reads their
parameters, as the JAX functions read ``params`` (BatchNorm running
statistics are not parameters in either package).
"""
from __future__ import annotations

from typing import Dict, Iterator

import torch


def _params(*modules: torch.nn.Module) -> Iterator[torch.Tensor]:
    for m in modules:
        yield from m.parameters()


def param_count(*modules: torch.nn.Module) -> int:
    return sum(p.numel() for p in _params(*modules))


def tree_bytes(*modules: torch.nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in _params(*modules))


def dtype_summary(*modules: torch.nn.Module) -> Dict[str, int]:
    """Parameter count per dtype, named as numpy names it (``float32``)."""
    out: Dict[str, int] = {}
    for p in _params(*modules):
        k = str(p.dtype).removeprefix("torch.")
        out[k] = out.get(k, 0) + p.numel()
    return out


def finite_check(*modules: torch.nn.Module) -> bool:
    """True iff every floating parameter is finite (one host read)."""
    flags = [torch.isfinite(p).all() for p in _params(*modules)
             if p.is_floating_point()]
    return bool(torch.stack(flags).all()) if flags else True
