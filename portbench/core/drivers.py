"""The one general driver of every traffic mix: it reads the cell's
configuration and traffic files, builds the port's objects from the
harness's inputs, runs the set-up, then the measured window.  Whatever
depends on the model's architecture (its weights, their load, the
training state's snapshot and restart, the console style, the recorded
metrics) comes from the plug-in the configuration's ``model.arch`` names,
``archs/<arch>.py`` (``spec.arch_module``).

A traffic file's ``kind`` names the entry the window drives:

* ``epoch``: ``Trainer.run_epoch(<epoch>)`` repeated, every epoch from
  the state the checked epoch started from (the plug-in's ``restart``),
  so that every unit does the same work.  Set-up runs the preset's
  ``Trainer.setup()`` (its prefilter, if it has one) and one epoch of the
  same index: the window's own call, which warms every
  capture key, the eager steps and the strain's shapes, pays the process's
  first ``Adam.step()``, and is the epoch whose outputs the reference
  checks (``Recorder``).  A unit of work is an epoch; the images counted
  are its live rows (``result["active"]``).
* ``prefilter``: ``StrainerEngine.prefilter()`` of a fresh engine
  repeated (a fresh engine holds no feature matrix of an earlier pass).
  Set-up runs one pass.  A unit is a pass; the images counted are the
  dataset's rows.

The window runs whole units and starts none that the previous unit's time
says would end after ``--seconds``; the first always runs.  A traced run
traces its first unit, then runs such a window of untraced ones, of
which the first always runs too: the untraced units' time is what the
device's busy time is set against (the profiler slows the host).
"""
from __future__ import annotations

import copy
import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from . import inputs as I
from . import spec
from .trace import Trace, Tracer, span


def program_config(config: Dict, seed: int):
    """The port's ``ExperimentConfig``: the preset named in the
    configuration file, with every value the file states put over it."""
    from strainer_gan_tpu_torch.config import get_preset

    cfg = get_preset(config["preset"])
    m, d, t, s = config["model"], config["data"], config["train"], config.get("strain", {})

    def over(section, values):
        names = {f.name for f in dataclasses.fields(section)}
        kw = {k: (tuple(tuple(x) for x in v) if isinstance(v, list) else v)
              for k, v in values.items() if k in names}
        return dataclasses.replace(section, **kw)

    return cfg.replace(
        model=over(cfg.model, m),
        data=over(cfg.data, {"batch_size": d["batch_size"], "drop_last": d["drop_last"]}),
        train=over(cfg.train, {**t, "seed": int(seed) % (2 ** 63 - 1)}),
        strain=over(cfg.strain, s))


def lr_at(base: float, epoch: int, train: Dict) -> float:
    e = train.get("lr_decay_epoch")
    return base * train.get("lr_decay_factor", 0.1) if e is not None and epoch >= e else base


class Recorder:
    """The console of the checked epoch's Trainer, which also keeps what
    the reference judges: each step's outputs, and the state at the edges
    of the stages it compares (``wanted``).  A stage is one dispatch: an
    eager step (``log_step``) or a replayed chunk (``log_chunk``); the
    state is cloned on the stream right after the dispatch, so it is the
    state the next dispatch starts from.  ``style``: the console's;
    ``recorded``: the keys of a step's metrics that are kept."""

    def __init__(self, logger_cls, log_every: int, stream, snapshot: Callable, style: str,
                 recorded: Sequence[str]):
        outer = self

        class _Logger(logger_cls):
            def log_step(self, epoch, num_epochs, it, steps, metrics):
                outer._on_eager()
                super().log_step(epoch, num_epochs, it, steps, metrics)
                outer._record(it, 1, steps, metrics, stacked=False)

            def log_chunk(self, epoch, num_epochs, it0, steps, metrics, n):
                super().log_chunk(epoch, num_epochs, it0, steps, metrics, n)
                outer._record(it0, n, steps, metrics, stacked=True)

        self.logger = _Logger(log_every=log_every, stream=stream, style=style)
        self._snapshot = snapshot
        self._recorded = tuple(recorded)
        self.armed = False
        self.on_eager_done: Optional[Callable] = None  # the traced run's span end
        self.steps: Dict[int, Dict] = {}
        self.stages: List[Dict] = []
        self.last: Optional[Dict] = None
        self.n_steps = None
        self._start = None

    def arm(self) -> None:
        self.armed = True
        self._start = self.start_state = self._snapshot()

    def disarm(self) -> None:
        self.armed = False
        self._start = None

    def _on_eager(self) -> None:
        if self.on_eager_done is not None:
            self.on_eager_done()

    def _wanted(self, kind: str) -> Optional[str]:
        have = {s["role"] for s in self.stages}
        if kind == "eager" and "first_eager" not in have:
            return "first_eager"
        if kind == "eager" and len(self.stages) == 1 and "first_chunk" not in have:
            return "second_eager"
        if kind == "chunk" and "first_chunk" not in have:
            return "first_chunk"
        if kind == "eager" and "first_chunk" in have and "after_chunk" not in have:
            return "after_chunk"
        return None

    def _record(self, it0: int, n: int, steps: int, m: Dict, stacked: bool) -> None:
        if not self.armed:
            return
        self.n_steps = steps
        for j in range(n):
            row = {k: (m[k][j] if stacked else m[k]) for k in self._recorded}
            self.steps[it0 + j] = row
        end = self._snapshot()
        kind = "chunk" if stacked else "eager"
        stage = dict(kind=kind, it0=it0, n=n, start=self._start, end=end)
        role = self._wanted(kind)
        if role is not None:
            self.stages.append({**stage, "role": role})
        self.last = {**stage, "role": "last"}
        self._start = end


class Run:
    """One run of a cell: set-up, window, and what the checks and the
    metric readers need afterwards."""

    def __init__(self, cell, seed: int, device, scale: Optional[Dict] = None):
        """``scale``: a smaller dataset (``n_images``) and batch
        (``batch_size``), for the CPU tests only."""
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.config, self.traffic = copy.deepcopy(cell.config), cell.traffic
        if scale:
            data = self.config["data"]
            total = sum(s["count"] for s in data["sources"])
            for s in data["sources"]:
                s["count"] = max(1, s["count"] * scale["n_images"] // total)
            data["batch_size"] = scale.get("batch_size", data["batch_size"])
        self.kind = self.traffic["kind"]
        self.arch = spec.arch_module(self.config["model"]["arch"])
        self.console_path = os.path.join(tempfile.gettempdir(), "portbench_console.txt")
        self.trace: Optional[Trace] = None
        self.traced: Dict = {}
        self.window: Dict = {}
        self.checked: Dict = {}

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from strainer_gan_tpu_torch.data.pipeline import DeviceDataset
        from strainer_gan_tpu_torch.models.features import build_feature_fn
        from strainer_gan_tpu_torch.obs.metrics import MetricsLogger
        from strainer_gan_tpu_torch.train.loop import Trainer

        cfg_file, dev, arch = self.config, self.device, self.arch
        data = cfg_file["data"]
        self.images, self.source_id = I.make_images(
            data["sources"], data["mixer"], cfg_file["model"]["image_size"],
            data["content_seed"], self.seed, dev)
        self.n = self.images.shape[0]
        g_w, d_w = arch.weights(cfg_file["model"], self.seed, dev)
        d_state = self.traffic.get("d_state")
        if d_state:
            if not hasattr(arch, "as_trained"):
                raise ValueError(f"the traffic mix has a d_state, and the architecture "
                                 f"{cfg_file['model']['arch']!r} has no as_trained")
            d_w = arch.as_trained(d_w, self.images, d_state)
        self.trunk = None
        if cfg_file.get("strain", {}).get("feature_extractor") == "resnet18":
            self.trunk = I.resnet18_weights(cfg_file["strain"]["trunk_seed"], dev)
        self.cfg = program_config(cfg_file, self.seed)
        self.console = open(self.console_path, "w")
        self.recorder = Recorder(MetricsLogger, self.cfg.train.log_every, self.console,
                                 lambda: arch.snapshot(self.trainer), arch.STYLE,
                                 arch.RECORDED)
        self.dataset = DeviceDataset.from_tensors(self.images, self.source_id, dev)
        self.trainer = tr = Trainer(self.cfg, device=dev, dataset=self.dataset,
                                    logger=self.recorder.logger)
        arch.load(tr, g_w, d_w)
        if self.trunk is not None:
            tr.engine.feature_fn = build_feature_fn(
                "resnet18", 3, dev, state_dict={k: v.cpu() for k, v in self.trunk.items()})
        if self.kind == "epoch":
            self._setup_epoch()
        elif self.kind == "prefilter":
            self._setup_prefilter()
        else:
            raise ValueError(f"unknown traffic kind {self.kind!r}")
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _setup_epoch(self) -> None:
        tr, epoch = self.trainer, int(self.traffic["epoch"])
        tr.setup()
        noise: Dict[int, torch.Tensor] = {}
        rows: List[torch.Tensor] = []
        program_indices, program_noise = tr.epoch_indices, tr.step_noise

        def step_noise(e, i):
            z = program_noise(e, i)
            noise[i] = z
            return z

        def epoch_indices(e, active, steps):
            idx = program_indices(e, active, steps)
            rows.append(idx)
            return idx

        # the checked epoch: the program's own draws of the rows and the
        # noise, recorded
        tr.step_noise, tr.epoch_indices = step_noise, epoch_indices
        self.recorder.arm()
        self.checked["initial"] = self.recorder.start_state
        try:
            result = tr.run_epoch(epoch)
        finally:
            del tr.step_noise, tr.epoch_indices
            self.recorder.disarm()
        eng = tr.engine
        self.checked.update(
            epoch=epoch, result=result, noise=noise, rows=rows[0] if rows else None,
            active=eng.active, threshold=eng.last_threshold, base=eng.base_active,
            stages=list(self.recorder.stages) + ([self.recorder.last] if self.recorder.last
                                                 else []),
            steps=self.recorder.steps, n_steps=self.recorder.n_steps)

    def _fresh_engine(self):
        from strainer_gan_tpu_torch.strain.engine import StrainerEngine

        tr = self.trainer
        return StrainerEngine(tr.cfg, tr.disc, tr.dataset, feature_fn=tr.engine.feature_fn,
                              score_batch=tr.cfg.strain.score_batch)

    def _setup_prefilter(self) -> None:
        self._fresh_engine().prefilter()

    # ------------------------------------------------------------ window
    def _unit(self) -> Callable[[], Dict]:
        if self.kind == "epoch":
            epoch = int(self.traffic["epoch"])

            def unit():
                self.arch.restart(self.trainer, self.checked["initial"])
                r = self.trainer.run_epoch(epoch)
                return dict(images=int(r["active"]), steps=int(r["steps"]),
                            counts=r.get("counts"))
            return unit

        def unit():
            eng = self._fresh_engine()
            eng.prefilter()
            self.last_engine = eng
            return dict(images=self.n, steps=0)
        return unit

    def run_window(self, seconds: float, traced: bool = False) -> None:
        from strainer_gan_tpu_torch.kernels import launch_counts

        unit = self._unit()
        launches0 = launch_counts()
        units: List[Dict] = []
        t_start = t_window = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            if traced and not units:
                with self._spans(), Tracer() as tracer, span("unit"):
                    r = unit()
                    self._sync()
                launches = launch_counts()
                r["launches"] = {k: launches[k] - launches0[k] for k in launches}
                self.traced = dict(r, engine=self._traced_engine())
                events, tracer.events = tracer.events, []
                t1 = time.perf_counter()
                r["seconds"] = t1 - t0
                units.append(r)
                t_window = t1  # the untraced window starts here
                continue
            r = unit()
            self._sync()
            t1 = time.perf_counter()
            r["seconds"] = t1 - t0
            units.append(r)
            if (t1 - t_window) + (t1 - t0) > seconds:
                break
        if traced:
            self.trace = Trace(events)
        self.window = dict(seconds=t1 - t_start, units=units)

    def _traced_engine(self) -> Dict:
        """What the traced unit's strain did: the scored base's rows and the
        band path's counts (the K1 elements)."""
        eng = self.trainer.engine if self.kind == "epoch" else self.last_engine
        base = eng.base_active
        out = dict(base_rows=int(base.sum()) if base is not None else self.n,
                   score_path=eng.last_score_path)
        band = eng.last_band_stats
        if band is not None:
            out["n_rescored"], out["fell_back"] = float(band[0]), float(band[1])
        return out

    def _spans(self):
        """The benchmark's host spans around the calls it can see into the
        program's layers, for one traced unit: the strain, the fixed-noise
        grids, the epoch's sampler and each eager step (from its batch's
        gather to its log)."""
        import contextlib

        tr, rec = self.trainer, self.recorder

        def wrap(obj, name, label):
            fn = getattr(obj, name)

            def inner(*a, **kw):
                with span(label):
                    return fn(*a, **kw)
            setattr(obj, name, inner)

        open_eager = []

        def batch(idx, _fn=self.dataset.batch):
            if not open_eager:
                rf = span("eager_step")
                rf.__enter__()
                open_eager.append(rf)
            return _fn(idx)

        def eager_done():
            while open_eager:
                open_eager.pop().__exit__(None, None, None)

        @contextlib.contextmanager
        def ctx():
            wrap(tr.engine, "on_epoch_start", "strain")
            wrap(tr, "sample", "sample_grid")
            wrap(tr, "epoch_indices", "sampler")
            self.dataset.batch = batch
            rec.on_eager_done = eager_done
            try:
                yield
            finally:
                eager_done()
                rec.on_eager_done = None
                for obj, name in ((tr.engine, "on_epoch_start"), (tr, "sample"),
                                  (tr, "epoch_indices"), (self.dataset, "batch")):
                    delattr(obj, name)

        return ctx()

    def close(self) -> None:
        self.console.close()
