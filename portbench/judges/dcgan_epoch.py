"""The judge of a DCGAN training epoch (traffic kind ``epoch``): the
program's checked epoch against the plain DCGAN step of
``reference/dcgan.py`` and the percentile strain of
``reference/strain.py``.

The reference follows the program stage by stage from the program's own
state, since a GAN's steps in bfloat16 and in another kernel order drift
apart over an epoch.  Each stage is one dispatch of the checked epoch
(the set-up's epoch, the window's own call on the object the window goes
on with):

* ``first_eager``: the epoch's first eager step, the first ``Adam.step``
  of both optimizers, whose gradient the program's Adam state gives back
  (its first moment over ``1 - beta1``), and the next dispatch, when it
  is an eager step too (the first chunk's warm-up step);
* ``first_chunk``: the first replayed chunk (32 steps of one CUDA graph),
  which the reference follows whole;
* ``after_chunk``: the first single-step dispatch after a chunk: the
  gated tail (the partial last step, one launch of the key's gated tail),
  since a segment's remainder runs as one launch of the key's gated chunk
  and is recorded as a chunk stage without a role; an eager step, where
  the epoch still runs one there;
* ``last``: the epoch's last step (the partial tail batch).

The stages' starting states are the program's; the start of the epoch is
checked by itself: the prefilter's base against the reference's z-score
strain, and the strain event's kept rows and threshold against the
reference's percentile strain from D's state before the epoch.  The rows
the sampler drew are checked against the rule they keep (the first
``active`` positions hold every kept row once).  Numbers:

* ``loss_gap``: errD and errG of each stage's first step (taken from the
  program's own state), relative;
* ``loss_gap_follow``: the same of the steps after a stage's first, up to
  ``FOLLOW`` (the chunk's second and third), where the two have drifted
  apart by a step or two; later steps are judged by the chunk's whole
  change, as rounding alone moves two runs of a GAN apart within some ten
  steps, in any precision;
* ``real_gap``: the per-sample real losses of each stage's first step,
  relative to the larger of 1 and the reference's loss;
* ``grad_gap``: the first gradient, by leaf: the gap between the norms,
  over the reference's norm of that leaf or of the median leaf,
  whichever is larger; leaves whose reference gradient is under a
  thousandth of the median leaf's (nought to rounding) are left out;
* ``delta_gap``: the parameters' change over each single-step stage, by
  leaf, as ``grad_gap``;
* ``chunk_delta_gap``: the parameters' change over the whole replayed
  chunk, by leaf, as ``grad_gap`` (Adam's normalised steps keep its norm
  near the reference's while the losses drift; a chunk that leaves the
  state unchanged reads 1);
* ``chunk_v_gap``: Adam's second moment after the chunk, by leaf, as
  ``grad_gap`` (it sums the squares of all the chunk's gradients);
* ``adam_steps_bad``: leaves whose Adam step count after a stage is not
  the reference's;
* ``keep_flips``: lanes of the in-step mask that differ, at each stage's
  first step;
* ``base_flips``, ``strain_flips``, ``strain_thr_gap``, ``sampler_bad``.

A strain method this judge does not know raises: its strain would go
unjudged.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional

import torch

from portbench.core.drivers import lr_at
from portbench.reference import dcgan as RD
from portbench.reference import resnet as RR
from portbench.reference import strain as RS

FOLLOW = 3  # steps of a stage compared one by one
METHODS = ("none", "loss_percentile", "batch_quantile_mask")
FAULTS = ("unchanged", "unchanged_chunk", "stale_chunk", "half_batch", "altered_loss",
          "altered_strain")


# ------------------------------------------------------------------ outputs
def outputs(run) -> Dict:
    """What the program produced, in the form the judge reads."""
    c = run.checked
    steps = c["steps"]
    bs = run.cfg.data.batch_size
    n_active = int(c["result"]["active"])
    tail = n_active % bs if not run.cfg.data.drop_last else 0
    stages = []
    for st in c["stages"]:
        rows = [steps[i] for i in range(st["it0"], st["it0"] + st["n"])]
        stages.append(dict(
            role=st["role"], it0=st["it0"], n=st["n"], start=st["start"], end=st["end"],
            steps=[dict(errD=r["errD"], errG=r["errG"], keep=r["keep_mask"],
                        per_real=r["real_loss_per_sample"]) for r in rows]))
    return dict(base=c.get("base") if run.config.get("strain", {}).get("prefilter") else None,
                active=c["active"], threshold=c["threshold"], rows=c["rows"],
                n_active=n_active, tail=tail, n_steps=c["n_steps"], stages=stages)


# ---------------------------------------------------------------- reference
def settings(run, epoch: int):
    """(strains this epoch, loss ratio, D in training mode for the steps,
    the in-step mask's quantile or None), as the configuration states."""
    s = run.config.get("strain", {})
    method = s.get("method", "none")
    if method not in METHODS:
        raise ValueError(f"the DCGAN epoch judge knows the strain methods {METHODS}, "
                         f"not {method!r}: its strain would go unjudged")
    strains = method == "loss_percentile" and epoch >= s.get("start_epoch", 3)
    ratio = s.get("loss_ratio", 0.2)
    if s.get("final_py_ratio_inversion"):
        ratio = 1.0
        for start, r in s.get("clean_ratio_schedule") or ():
            if epoch >= start:
                ratio = r
    d_train = not (strains and s.get("bn_eval_after_score"))
    mask_q = (s.get("mask_quantile", 0.1) if method == "batch_quantile_mask"
              and epoch >= s.get("mask_start_epoch", 10) else None)
    return strains, ratio, d_train, mask_q


def _adam_state(snap: Dict) -> Dict:
    return {n: {"m": v["m"].clone(), "v": v["v"].clone(), "t": int(v["t"])}
            for n, v in snap.items()}


def _lane_count(i: int, out: Dict) -> Optional[int]:
    tail = out["tail"]
    return tail if (tail and i == out["n_steps"] - 1) else None


def follow(run, out: Dict, stage: Dict, prec: RD.Precision, lanes: Optional[int] = None,
           stale: bool = False) -> Dict:
    """The reference's run of one whole stage from the stage's starting
    state: its end state, each step's outputs and the first step's
    gradients.  Faults: ``lanes``, every step on its first ``lanes`` lanes
    only; ``stale``, every step on the rows and noise of the stage's
    first."""
    epoch = run.checked["epoch"]
    _, _, d_train, mask_q = settings(run, epoch)
    t = run.config["train"]
    start = stage["start"]
    g = {k: v.clone() for k, v in start["g"].items()}
    d = {k: v.clone() for k, v in start["d"].items()}
    opt_g, opt_d = _adam_state(start["opt_g"]), _adam_state(start["opt_d"])
    steps, grads = [], None
    for i in range(stage["it0"], stage["it0"] + stage["n"]):
        src = stage["it0"] if stale else i
        x = RR.normalize(run.images.index_select(0, out["rows"][src]))
        lane = _lane_count(i, out)
        if lanes is not None:
            lane = lanes if lane is None else min(lane, lanes)
        m = RD.train_step(g, d, opt_g, opt_d, x, run.checked["noise"][src],
                          lr_g=lr_at(t["lr_g"], epoch, t), lr_d=lr_at(t["lr_d"], epoch, t),
                          betas=(t.get("beta1", 0.5), t.get("beta2", 0.999)),
                          d_train=d_train, mask_q=mask_q, lane_count=lane, prec=prec)
        if grads is None:
            grads = dict(g=m["grads_g"], d=m["grads_d"])
        steps.append(dict(errD=m["errD"], errG=m["errG"], keep=m["keep"],
                          per_real=m["per_real"]))
    end = dict(g=g, d=d, opt_g=opt_g, opt_d=opt_d)
    return dict(role=stage["role"], it0=stage["it0"], n=stage["n"], start=start, end=end,
                steps=steps, grads=grads)


def _features(run, tf32: bool = False) -> torch.Tensor:
    return RR.all_features(run.trunk, run.images, tf32=tf32)


def reference(run, out: Dict) -> Dict:
    """The reference's readings."""
    epoch = run.checked["epoch"]
    strains, ratio, _, _ = settings(run, epoch)
    ref = dict(stages=[follow(run, out, st, RD.Precision()) for st in out["stages"]])
    s = run.config.get("strain", {})
    if out["base"] is not None:
        ref["base"], _ = RR.zscore_mask(_features(run), s["z_threshold"])
    if strains:
        ref["active"], ref["threshold"] = _strain(run, out, ratio)
    return ref


def _strain(run, out: Dict, ratio: float, tf32: bool = False):
    """(kept mask over all rows, threshold) of the percentile strain over
    the program's base (checked by itself) from D's state before the
    epoch."""
    base_rows = torch.nonzero(out["base"] if out["base"] is not None
                              else torch.ones(run.n, dtype=torch.bool,
                                              device=run.images.device)).flatten()
    d = run.checked["initial"]["d"]
    losses = RS.d_losses(d, run.images, base_rows, tf32=tf32)
    kept, thr = RS.percentile_keep(losses, ratio)
    full = torch.zeros(run.n, dtype=torch.bool, device=run.images.device)
    full[base_rows[kept]] = True
    return full, thr


# -------------------------------------------------------------------- judge
def _leaf_gaps(prog: Dict, ref: Dict, names: List[str], keep: List[str]) -> float:
    """The worst leaf's gap of norms: |‖prog‖ - ‖ref‖| over the larger of
    the leaf's reference norm and the median leaf's."""
    if not names:
        return 0.0
    pn = {n: float(prog[n].float().norm()) for n in names}
    rn = {n: float(ref[n].float().norm()) for n in names}
    med = sorted(rn.values())[len(rn) // 2]
    return max(abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30) for n in keep) if keep else 0.0


def _kept_leaves(grads: Dict) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding: at least
    a thousandth of the median leaf's."""
    norms = {n: float(v.float().norm()) for n, v in grads.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return [n for n, v in norms.items() if v >= 1e-3 * med]


def _moment(state: Dict, key: str, names: List[str], like: Dict) -> Dict:
    """Adam's ``key`` moment of each leaf; nought where it has no state."""
    return {n: (state[n][key] if n in state else torch.zeros_like(like[n])) for n in names}


def _steps_bad(prog: Dict, ref: Dict) -> int:
    """Leaves whose Adam step count differs (a leaf without state: 0)."""
    def count(state, n):
        return int(state[n]["t"]) if n in state else 0

    return sum(count(prog, n) != count(ref, n) for n in set(prog) | set(ref))


def judge(run, out: Dict, ref: Dict) -> Dict[str, float]:
    nums: Dict[str, float] = {}
    beta1 = run.config["train"].get("beta1", 0.5)
    first = next((s for s in ref["stages"] if s["role"] == "first_eager"), None)
    keep_g = _kept_leaves(first["grads"]["g"]) if first else None
    keep_d = _kept_leaves(first["grads"]["d"]) if first else None
    loss_gap = loss_gap_follow = real_gap = delta_gap = 0.0
    chunk_delta = chunk_v = None
    keep_flips = steps_bad = 0
    for ps, rs in zip(out["stages"], ref["stages"]):
        for j, (p, r) in enumerate(zip(ps["steps"][:FOLLOW], rs["steps"][:FOLLOW])):
            gap = max(abs(float(p[k]) - float(r[k])) / max(abs(float(r[k])), 1e-6)
                      for k in ("errD", "errG"))
            if j:
                # a step after the stage's first: the reference has followed
                # the program's state through the steps before it
                loss_gap_follow = max(loss_gap_follow, gap)
                continue
            loss_gap = max(loss_gap, gap)
            lane = ((p["per_real"].float() - r["per_real"]).abs()
                    / r["per_real"].abs().clamp_min(1.0))
            real_gap = max(real_gap, float(lane.max()))
            keep_flips += int((p["keep"].bool() != r["keep"].bool()).sum())
        for side, kept in (("g", keep_g), ("d", keep_d)):
            names = list(rs["grads"][side])
            dp = {n: ps["end"][side][n] - ps["start"][side][n] for n in names}
            dr = {n: rs["end"][side][n] - rs["start"][side][n] for n in names}
            gap = _leaf_gaps(dp, dr, names, kept or names)
            steps_bad += _steps_bad(ps["end"]["opt_" + side], rs["end"]["opt_" + side])
            if ps["n"] <= FOLLOW:
                delta_gap = max(delta_gap, gap)
                continue
            vp = _moment(ps["end"]["opt_" + side], "v", names, dr)
            vr = _moment(rs["end"]["opt_" + side], "v", names, dr)
            chunk_delta = max(chunk_delta or 0.0, gap)
            chunk_v = max(chunk_v or 0.0, _leaf_gaps(vp, vr, names, kept or names))
    nums.update(loss_gap=loss_gap, loss_gap_follow=loss_gap_follow, real_gap=real_gap,
                delta_gap=delta_gap)
    if chunk_delta is not None:
        nums.update(chunk_delta_gap=chunk_delta, chunk_v_gap=chunk_v)
    nums["adam_steps_bad"] = float(steps_bad)
    if first is not None and not first["start"]["opt_d"]:
        ps = next(s for s in out["stages"] if s["role"] == "first_eager")
        gap = 0.0
        for side, kept in (("g", keep_g), ("d", keep_d)):
            names = list(first["grads"][side])
            # no Adam state after the step: it never reached the optimizer
            m = _moment(ps["end"]["opt_" + side], "m", names, first["grads"][side])
            gp = {n: v / (1.0 - beta1) for n, v in m.items()}
            gap = max(gap, _leaf_gaps(gp, first["grads"][side], names, kept))
        nums["grad_gap"] = gap
    if settings(run, run.checked["epoch"])[3] is not None:
        nums["keep_flips"] = float(keep_flips)
    if "base" in ref:
        nums["base_flips"] = float((out["base"] != ref["base"]).sum())
    if "active" in ref:
        nums["strain_flips"] = float((out["active"] != ref["active"]).sum())
        thr = float(out["threshold"])
        nums["strain_thr_gap"] = abs(thr - ref["threshold"]) / max(abs(ref["threshold"]), 1e-30)
    nums["sampler_bad"] = float(sampler_violations(out))
    return nums


def sampler_violations(out: Dict) -> int:
    """Rows the sampler drew against its rule: the first ``n_active``
    positions hold each kept row once."""
    rows = out["rows"]
    if rows is None:
        return 1
    first = rows.reshape(-1)[:out["n_active"]]
    active = out["active"]
    inside = first[active[first]]
    outside = first.numel() - inside.numel()
    covered = int(torch.unique(inside).numel())
    repeated = inside.numel() - covered
    missing = int(active.sum()) - covered
    return outside + repeated + missing


# ------------------------------------------------ control and planted faults
def control(run, out: Dict) -> Dict:
    """The reference in the program's place, one precision below: fp8
    convolution operands for the bfloat16 steps, TF32 for the float32
    strain and prefilter."""
    ctrl = dict(out)
    ctrl["stages"] = [follow(run, out, st, RD.Precision(fp8=True)) for st in out["stages"]]
    strains, ratio, _, _ = settings(run, run.checked["epoch"])
    if out["base"] is not None:
        ctrl["base"], _ = RR.zscore_mask(_features(run, tf32=True),
                                         run.config["strain"]["z_threshold"])
    if strains:
        ctrl["active"], thr = _strain(run, out, ratio, tf32=True)
        ctrl["threshold"] = torch.tensor(thr)
    return ctrl


def _unchanged(stage: Dict) -> Dict:
    """The stage with its end state its start: no parameter, moment or
    step count moved."""
    return dict(stage, end=stage["start"])


def fault(run, out: Dict, ref: Dict, name: str) -> Optional[Dict]:
    """The program's outputs with one fault planted where it is made (None:
    the cell cannot have it)."""
    bad = copy.copy(out)
    chunk = [st["n"] > FOLLOW for st in out["stages"]]
    if name == "unchanged":
        bad["stages"] = [_unchanged(st) for st in out["stages"]]
    elif name == "unchanged_chunk":
        if not any(chunk):
            return None
        bad["stages"] = [_unchanged(st) if c else st for st, c in zip(out["stages"], chunk)]
    elif name == "stale_chunk":
        # every step of the replayed chunk on its first step's rows and noise
        if not any(chunk):
            return None
        bad["stages"] = [follow(run, out, st, RD.Precision(), stale=True) if c else st
                         for st, c in zip(out["stages"], chunk)]
    elif name == "half_batch":
        bs = run.cfg.data.batch_size
        bad["stages"] = [follow(run, out, st, RD.Precision(), lanes=bs // 2)
                         for st in out["stages"]]
    elif name == "altered_loss":
        bad["stages"] = [dict(st, steps=[dict(s, errD=s["errD"] * 1.01) for s in st["steps"]])
                         for st in out["stages"]]
    elif name == "altered_strain":
        if out.get("active") is None or out.get("base") is None:
            return None
        act = out["active"].clone()
        rows = torch.nonzero(out["base"]).flatten()
        flip = rows[:: max(1, rows.numel() // 100)]  # one row in a hundred of the base
        act[flip] = ~act[flip]
        bad["active"] = act
    else:
        raise ValueError(name)
    return bad
