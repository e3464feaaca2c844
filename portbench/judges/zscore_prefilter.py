"""The judge of the z-score prefilter (traffic kind ``prefilter``): the
last pass's features (``feat_gap``, the largest difference over the
largest magnitude), max |z| scores (``z_gap``, absolute) and mask
(``mask_flips``) against the plain ResNet18 and z-score strain of
``reference/resnet.py`` over every row."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from portbench.reference import resnet as RR

FAULTS = ("half_batch", "altered_score")


def outputs(run) -> Dict:
    eng = run.last_engine
    return dict(features=getattr(eng, "_features", None), scores=eng.last_scores,
                mask=eng.base_active)


def _prefilter(run, tf32: bool) -> Dict:
    feats = RR.all_features(run.trunk, run.images, tf32=tf32)
    mask, z = RR.zscore_mask(feats, run.config["strain"]["z_threshold"])
    return dict(features=feats, scores=z, mask=mask)


def reference(run, out: Dict) -> Dict:
    return _prefilter(run, tf32=False)


def judge(run, out: Dict, ref: Dict) -> Dict[str, float]:
    nums = dict(z_gap=float((out["scores"].float() - ref["scores"]).abs().max()),
                mask_flips=float((out["mask"].bool() != ref["mask"]).sum()))
    if out.get("features") is not None:
        scale = float(ref["features"].abs().max())
        nums["feat_gap"] = float((out["features"] - ref["features"]).abs().max()) / scale
    return nums


def control(run, out: Dict) -> Dict:
    """The reference in the program's place, in TF32 (one precision below
    the stated float32)."""
    return _prefilter(run, tf32=True)


def fault(run, out: Dict, ref: Dict, name: str) -> Optional[Dict]:
    z_thr = run.config["strain"]["z_threshold"]
    if name == "half_batch":
        # every score batch's second half left out of the statistics
        f = ref["features"]
        half = (torch.arange(f.shape[0], device=f.device) % 512) < 256
        mean = f[half].double().mean(0)
        std = f[half].double().std(0)
        z = ((f.double() - mean).abs() / std).amax(1).float()
        return dict(features=f, scores=z, mask=z < z_thr)
    if name == "altered_score":
        z = ref["scores"].clone()
        z[0] += 1.0
        return dict(features=ref["features"], scores=z, mask=z < z_thr)
    raise ValueError(name)
