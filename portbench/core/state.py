"""Copies of a model's state, for the architectures' plug-ins
(``archs/<arch>.py``): a module's parameters and buffers by their
state-dict names, and an ``Adam``'s moments and step counts by parameter
name."""
from __future__ import annotations

from typing import Dict

import torch


def clone_module(module) -> Dict[str, torch.Tensor]:
    """A clone of ``module``'s state dict."""
    with torch.no_grad():
        return {k: v.detach().clone() for k, v in module.state_dict().items()}


def load_module(module, weights: Dict) -> None:
    """``weights`` copied into ``module``'s own tensors, in place: every
    captured graph still reads the same tensors."""
    with torch.no_grad():
        for k, t in module.state_dict().items():
            t.copy_(weights[k])


def clone_adam(opt, module) -> Dict[str, Dict]:
    """A clone of ``opt``'s state of each of ``module``'s parameters that
    has one: its moments ``m`` and ``v`` and its step count ``t``."""
    out = {}
    with torch.no_grad():
        for name, p in module.named_parameters():
            st = opt.state.get(p)
            if st:
                out[name] = {"m": st["exp_avg"].detach().clone(),
                             "v": st["exp_avg_sq"].detach().clone(),
                             "t": torch.as_tensor(st["step"]).detach().clone()}
    return out


def zero_adam(opt) -> None:
    """``opt``'s moments and step counts to nought, in place (the next step
    is a first step, as on a fresh optimizer)."""
    with torch.no_grad():
        for st in opt.state.values():
            for k in ("exp_avg", "exp_avg_sq", "step"):
                if torch.is_tensor(st.get(k)):
                    st[k].zero_()
