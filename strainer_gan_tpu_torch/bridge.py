"""Carry the JAX package's weights into the port (and back, for comparison).

Inputs and outputs are nested dicts of numpy arrays in the flax layout
(``{"ConvTranspose2dTorch_0": {"kernel": ...}, "MaskedBatchNorm_0": ...}``),
so this module needs no JAX.  flax conv kernels are HWIO: a conv maps to
torch's (out, in, kh, kw), a transposed conv to (in, out, kh, kw)
(`tests/test_models_parity.py:56-81`).  BatchNorm ``scale``/``bias`` map to
``weight``/``bias`` and ``batch_stats`` ``mean``/``var`` to
``running_mean``/``running_var``.  The autoencoder's convolutions carry
biases: flax ``bias`` maps to ``bias`` (`tests/test_models_parity.py:197`).
The MLP's ``DenseTorch_k`` kernels are (in, out), torch's Linear weights
(out, in).  ``load_dcgan_from_flax``, ``dcgan_to_flax`` and the Adam
functions serve every model of the port: the DCGAN, the autoencoder and
the MLP.

The backbones: ``resnet18_state_dict_from_flax`` (3 or 1 input channels),
``resnet50_state_dict_from_flax`` and ``inception_state_dict_from_flax`` turn a flax trunk's variables into
torchvision-named state_dicts, along the JAX package's name pairs
(`strainer_gan_tpu/models/resnet.py:144-173`,
`strainer_gan_tpu/models/inception.py:194-271`).
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from .models.autoencoder import ConvAutoEncoder
from .models.dcgan import Generator64
from .models.mlp_gan import MLPDiscriminator, MLPGenerator

# (torch name, flax collection, flax path, layout)
Entry = Tuple[str, str, Tuple[str, ...], str]


def _ae_entries(module: ConvAutoEncoder) -> Iterator[Entry]:
    for names, flax, layout in (("convs", "Conv2dTorch", "conv"),
                                ("deconvs", "ConvTranspose2dTorch", "convT")):
        for i in range(len(getattr(module, names))):
            yield f"{names}.{i}.weight", "params", (f"{flax}_{i}", "kernel"), layout
            yield f"{names}.{i}.bias", "params", (f"{flax}_{i}", "bias"), "vec"


def _bn_entries(module: torch.nn.Module) -> Iterator[Entry]:
    for i in range(len(module.bns or ())):
        bn = f"MaskedBatchNorm_{i}"
        yield f"bns.{i}.weight", "params", (bn, "scale"), "vec"
        yield f"bns.{i}.bias", "params", (bn, "bias"), "vec"
        yield f"bns.{i}.running_mean", "batch_stats", (bn, "mean"), "vec"
        yield f"bns.{i}.running_var", "batch_stats", (bn, "var"), "vec"


def _entries(module: torch.nn.Module) -> Iterator[Entry]:
    if isinstance(module, ConvAutoEncoder):
        yield from _ae_entries(module)
        return
    if isinstance(module, (MLPGenerator, MLPDiscriminator)):
        for i in range(len(module.linears)):
            yield f"linears.{i}.weight", "params", (f"DenseTorch_{i}", "kernel"), "dense"
            yield f"linears.{i}.bias", "params", (f"DenseTorch_{i}", "bias"), "vec"
        if isinstance(module, MLPGenerator):
            yield from _bn_entries(module)
        return
    conv = "ConvTranspose2dTorch" if isinstance(module, Generator64) else "Conv2dTorch"
    layout = "convT" if isinstance(module, Generator64) else "conv"
    for i in range(len(module.convs)):
        yield f"convs.{i}.weight", "params", (f"{conv}_{i}", "kernel"), layout
    yield from _bn_entries(module)


def _to_torch(a: np.ndarray, layout: str) -> np.ndarray:
    a = np.asarray(a, np.float32)
    if layout == "conv":
        return np.transpose(a, (3, 2, 0, 1))
    if layout == "convT":
        return np.transpose(a, (2, 3, 0, 1))
    if layout == "dense":
        return np.ascontiguousarray(a.T)
    return a


def _to_flax(a: np.ndarray, layout: str) -> np.ndarray:
    if layout == "conv":
        return np.transpose(a, (2, 3, 1, 0))
    if layout == "convT":
        return np.transpose(a, (2, 3, 0, 1))
    if layout == "dense":
        return a.T
    return a


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _put(tree: Dict, path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def load_dcgan_from_flax(module: torch.nn.Module, params, batch_stats=None) -> torch.nn.Module:
    """Copy a flax Generator64/Discriminator64's (or ConvAutoEncoder's, or
    MLPGenerator/MLPDiscriminator's) variables into ``module``; without
    ``batch_stats`` the BatchNorm running statistics stay as they are."""
    trees = {"params": params, "batch_stats": batch_stats}
    sd = module.state_dict()
    with torch.no_grad():
        for name, coll, path, layout in _entries(module):
            if trees[coll] is not None:
                sd[name].copy_(torch.tensor(_to_torch(_get(trees[coll], path), layout)))
    return module


def dcgan_to_flax(module: torch.nn.Module) -> Dict[str, Dict]:
    """``{"params": ..., "batch_stats": ...}`` of ``module`` in the flax layout."""
    out = {"params": {}, "batch_stats": {}}
    sd = module.state_dict()
    for name, coll, path, layout in _entries(module):
        _put(out[coll], path, _to_flax(sd[name].detach().cpu().numpy(), layout))
    return out


def adam_moments_to_flax(module: torch.nn.Module, opt: torch.optim.Optimizer
                         ) -> Tuple[Dict, Dict]:
    """(mu, nu) of a torch Adam over ``module`` in the layout of optax's
    ``ScaleByAdamState`` over the flax params."""
    params = dict(module.named_parameters())
    mu, nu = {}, {}
    for name, coll, path, layout in _entries(module):
        if coll != "params":
            continue
        st = opt.state[params[name]]
        _put(mu, path, _to_flax(st["exp_avg"].cpu().numpy(), layout))
        _put(nu, path, _to_flax(st["exp_avg_sq"].cpu().numpy(), layout))
    return mu, nu


def load_adam_from_flax(module: torch.nn.Module, opt: torch.optim.Optimizer, mu, nu,
                        count: int) -> None:
    """Set a torch Adam over ``module`` to optax's ``ScaleByAdamState``
    (``mu``, ``nu`` over the flax params, ``count`` steps taken), through
    ``opt.load_state_dict``: it puts each tensor where the optimizer keeps
    it (a capturable Adam's step count on the device), and its post-hooks
    run, among them the Trainer's, which drops the CUDA graphs that read
    the replaced tensors."""
    params = dict(module.named_parameters())
    index = {id(p): i for i, p in enumerate(p for g in opt.param_groups for p in g["params"])}
    sd = opt.state_dict()
    for name, coll, path, layout in _entries(module):
        if coll != "params":
            continue
        sd["state"][index[id(params[name])]] = dict(
            step=torch.tensor(float(count)),
            exp_avg=torch.tensor(_to_torch(_get(mu, path), layout)),
            exp_avg_sq=torch.tensor(_to_torch(_get(nu, path), layout)))
    opt.load_state_dict(sd)


def resnet_name_map(block: str = "basic", stages=(2, 2, 2, 2)
                    ) -> Iterator[Tuple[Tuple[str, ...], str, str]]:
    """(flax ConvBN path, torchvision conv name, torchvision bn name), as
    `strainer_gan_tpu/models/resnet.py:144-173` names the trunk: blocks
    ``BasicBlock_k`` (two ConvBNs) or ``Bottleneck_k`` (three) counted
    across stages, the downsample unit last."""
    scope_name, n_main, expansion = (("BasicBlock", 2, 1) if block == "basic"
                                     else ("Bottleneck", 3, 4))
    yield ("_ConvBN_0",), "conv1", "bn1"
    k = 0
    in_ch = 64
    for stage, n_blocks in enumerate(stages):
        width = 64 * 2 ** stage
        for i in range(n_blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            prefix, scope = f"layer{stage + 1}.{i}", f"{scope_name}_{k}"
            for c in range(n_main):
                yield (scope, f"_ConvBN_{c}"), f"{prefix}.conv{c + 1}", f"{prefix}.bn{c + 1}"
            if i == 0 and (stride != 1 or in_ch != width * expansion):
                yield ((scope, f"_ConvBN_{n_main}"), f"{prefix}.downsample.0",
                       f"{prefix}.downsample.1")
            in_ch = width * expansion
            k += 1


def resnet18_name_map() -> Iterator[Tuple[Tuple[str, ...], str, str]]:
    return resnet_name_map("basic", (2, 2, 2, 2))


def resnet_state_dict_from_flax(variables, block: str = "basic",
                                stages=(2, 2, 2, 2)) -> Dict[str, torch.Tensor]:
    """torchvision-named state_dict of a flax ResNet trunk's variables."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    for path, conv, bn in resnet_name_map(block, stages):
        p, s = _get(params, path), _get(stats, path)
        sd[conv + ".weight"] = _to_torch(p["Conv2dTorch_0"]["kernel"], "conv")
        sd[bn + ".weight"] = p["MaskedBatchNorm_0"]["scale"]
        sd[bn + ".bias"] = p["MaskedBatchNorm_0"]["bias"]
        sd[bn + ".running_mean"] = s["MaskedBatchNorm_0"]["mean"]
        sd[bn + ".running_var"] = s["MaskedBatchNorm_0"]["var"]
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}


def resnet18_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    return resnet_state_dict_from_flax(variables, "basic", (2, 2, 2, 2))


def resnet50_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    return resnet_state_dict_from_flax(variables, "bottleneck", (3, 4, 6, 3))


# the flax scopes of InceptionV3Features' BasicConv2d units, block by block
# (`strainer_gan_tpu/models/inception.py:251-260`)
_INCEPTION_BLOCKS = (("InceptionA_0", 7), ("InceptionA_1", 7), ("InceptionA_2", 7),
                     ("InceptionB_0", 4), ("InceptionC_0", 10), ("InceptionC_1", 10),
                     ("InceptionC_2", 10), ("InceptionC_3", 10), ("InceptionD_0", 6),
                     ("InceptionE_0", 9), ("InceptionE_1", 9))


def inception_name_pairs() -> Iterator[Tuple[Tuple[str, ...], str]]:
    """(flax BasicConv2d path, torchvision module prefix), in the order both
    architectures declare their units."""
    from .models.inception import BasicConv2d, InceptionV3Features

    ours = [(f"BasicConv2d_{i}",) for i in range(5)]
    for scope, n in _INCEPTION_BLOCKS:
        ours += [(scope, f"BasicConv2d_{i}") for i in range(n)]
    tv = [name for name, m in InceptionV3Features().named_modules()
          if isinstance(m, BasicConv2d)]
    assert len(ours) == len(tv), (len(ours), len(tv))
    return zip(ours, tv)


def inception_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """torchvision-named state_dict of a flax InceptionV3Features' variables."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    for path, tv in inception_name_pairs():
        p, s = _get(params, path), _get(stats, path)
        sd[tv + ".conv.weight"] = _to_torch(p["Conv2dTorch_0"]["kernel"], "conv")
        sd[tv + ".bn.weight"] = p["MaskedBatchNorm_0"]["scale"]
        sd[tv + ".bn.bias"] = p["MaskedBatchNorm_0"]["bias"]
        sd[tv + ".bn.running_mean"] = s["MaskedBatchNorm_0"]["mean"]
        sd[tv + ".bn.running_var"] = s["MaskedBatchNorm_0"]["var"]
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}
