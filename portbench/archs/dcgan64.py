"""The 64x64 DCGAN (``models/dcgan.py`` of the port, ``arch: dcgan64``):
what the harness does that depends on the model's architecture.

A configuration file's ``model.arch`` names its plug-in,
``archs/<arch>.py`` (``spec.arch_module``), which gives:

* ``weights(model, seed, device) -> (g_w, d_w)``: G's and D's weights
  from the seed, on the device, by state-dict name;
* ``as_trained(d_w, images, d_state) -> d_w``: D's weights put in the
  state a traffic file's ``d_state`` asks for (an arch without it cannot
  run such a traffic mix);
* ``load(trainer, g_w, d_w)``: the weights into the program's models;
* ``snapshot(trainer)``: a clone of the whole training state, in the form
  the cell's judge reads; ``restart(trainer, start)``: that state put
  back in place, with the optimizers' moments and step counts to nought;
* ``step_flops(model, masked)``: model FLOPs of one image through one
  training step (``masked``: with the in-step mask's scoring forward);
  ``d_forward_flops(model)``: of one image through D's forward, a strain
  score;
* ``STYLE``: the program's console style; ``RECORDED``: the keys of a
  step's metrics that the checked epoch keeps for the judge.
"""
from __future__ import annotations

from typing import Dict, Tuple

from portbench.core import flops as FL
from portbench.core import inputs as I
from portbench.core import state as S
from portbench.reference import dcgan as RD
from portbench.reference.resnet import normalize

STYLE = "dcgan"
RECORDED = ("errD", "errG", "keep_mask", "real_loss_per_sample")


def weights(model: Dict, seed: int, device) -> Tuple[Dict, Dict]:
    """``inputs.dcgan_weights``: the DCGAN's own initialisation."""
    return I.dcgan_weights(model, seed, device)


def as_trained(d_w: Dict, images, d_state: Dict) -> Dict:
    """D with BatchNorm statistics from the first ``d_state["rows"]``
    images and its reals' logits at the mean and spread the state names
    (``reference.dcgan.d_as_trained``)."""
    sample = normalize(images[:int(d_state["rows"])])
    return RD.d_as_trained(d_w, sample, d_state["logit_mean"], d_state["logit_std"])


def load(trainer, g_w: Dict, d_w: Dict) -> None:
    S.load_module(trainer.gen, g_w)
    S.load_module(trainer.disc, d_w)


def snapshot(trainer) -> Dict:
    """G's and D's parameters and buffers and both Adam states."""
    return {"g": S.clone_module(trainer.gen), "d": S.clone_module(trainer.disc),
            "opt_g": S.clone_adam(trainer.opt_g, trainer.gen),
            "opt_d": S.clone_adam(trainer.opt_d, trainer.disc)}


def restart(trainer, start: Dict) -> None:
    """G and D back to ``start``'s, both Adam states to nought."""
    load(trainer, start["g"], start["d"])
    S.zero_adam(trainer.opt_g)
    S.zero_adam(trainer.opt_d)


def step_flops(model: Dict, masked: bool) -> int:
    return FL.dcgan_step_flops(model, masked)


def d_forward_flops(model: Dict) -> int:
    return FL.dcgan_d_forward_flops(model)
