"""The architectures' plug-ins (``archs/<model.arch>.py``): ``dcgan64``
draws the same weights and counts the same FLOPs as the harness's DCGAN
functions, a run of each training cell goes through it and reads what the
harness read before it had plug-ins, and a configuration whose
architecture has no plug-in is refused by name."""
import json
import re
import textwrap

import pytest
import torch

from portbench.core import checks, drivers, spec
from portbench.core import flops as FL
from portbench.core import inputs as I
from portbench.core import work as W
from test_portbench_reference import SMALL

MODEL = {"nz": 100, "ngf": 64, "ndf": 64, "nc": 3}
PARTS = ("weights", "as_trained", "load", "snapshot", "restart", "step_flops",
         "d_forward_flops")
BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())

# the plug-in counting its calls: it wraps the real one
COUNTING = textwrap.dedent('''
    import importlib.util

    from portbench.core import spec

    _at = importlib.util.spec_from_file_location("real_dcgan64",
                                                 spec.BENCH_DIR / "archs" / "dcgan64.py")
    REAL = importlib.util.module_from_spec(_at)
    _at.loader.exec_module(REAL)
    STYLE, RECORDED = REAL.STYLE, REAL.RECORDED
    CALLS = {}


    def _counted(name):
        fn = getattr(REAL, name)

        def inner(*a, **kw):
            CALLS[name] = CALLS.get(name, 0) + 1
            return fn(*a, **kw)
        return inner


    for _name in %r:
        globals()[_name] = _counted(_name)
''' % (PARTS,))

# the harness's DCGAN-only steps as they were before the plug-ins (the
# driver's ``I.dcgan_weights``, ``RD.d_as_trained``, ``_load``,
# ``snapshot_state`` and ``Run._restart``; the work's FLOP counts): what a
# run read then
BEFORE = textwrap.dedent('''
    import torch

    from portbench.core import flops as FL
    from portbench.core import inputs as I
    from portbench.reference import dcgan as RD
    from portbench.reference.resnet import normalize

    STYLE = "dcgan"
    RECORDED = ("errD", "errG", "keep_mask", "real_loss_per_sample")


    def weights(model, seed, device):
        return I.dcgan_weights(model, seed, device)


    def as_trained(d_w, images, d_state):
        sample = normalize(images[:int(d_state["rows"])])
        return RD.d_as_trained(d_w, sample, d_state["logit_mean"], d_state["logit_std"])


    def _load(module, weights):
        with torch.no_grad():
            for k, t in module.state_dict().items():
                t.copy_(weights[k])


    def load(trainer, g_w, d_w):
        _load(trainer.gen, g_w)
        _load(trainer.disc, d_w)


    def snapshot(trainer):
        def adam(opt, module):
            out = {}
            for name, p in module.named_parameters():
                st = opt.state.get(p)
                if st:
                    out[name] = {"m": st["exp_avg"].detach().clone(),
                                 "v": st["exp_avg_sq"].detach().clone(),
                                 "t": torch.as_tensor(st["step"]).detach().clone()}
            return out

        with torch.no_grad():
            return {"g": {k: v.detach().clone() for k, v in trainer.gen.state_dict().items()},
                    "d": {k: v.detach().clone() for k, v in trainer.disc.state_dict().items()},
                    "opt_g": adam(trainer.opt_g, trainer.gen),
                    "opt_d": adam(trainer.opt_d, trainer.disc)}


    def restart(tr, start):
        with torch.no_grad():
            for module, weights in ((tr.gen, start["g"]), (tr.disc, start["d"])):
                _load(module, weights)
            for opt in (tr.opt_g, tr.opt_d):
                for st in opt.state.values():
                    for k in ("exp_avg", "exp_avg_sq", "step"):
                        if torch.is_tensor(st.get(k)):
                            st[k].zero_()


    def step_flops(model, masked):
        return FL.dcgan_step_flops(model, masked)


    def d_forward_flops(model):
        return FL.dcgan_d_forward_flops(model)
''')


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(prev)


def _plugins(tmp_path, monkeypatch, source: str, name: str = "dcgan64"):
    """A plug-in folder holding ``<name>.py`` = ``source``, in place of
    ``archs/``."""
    folder = tmp_path / "archs"
    folder.mkdir(parents=True, exist_ok=True)
    (folder / f"{name}.py").write_text(source)
    monkeypatch.setattr(spec, "ARCHS", folder)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 12345])
def test_dcgan64_weights_are_the_harness_draw(seed):
    arch = spec.arch_module("dcgan64")
    drawn = I.dcgan_weights(MODEL, seed, "cpu")
    for mine, theirs in zip(arch.weights(MODEL, seed, "cpu"), drawn):
        assert list(mine) == list(theirs)
        for k in mine:
            assert mine[k].dtype == theirs[k].dtype and torch.equal(mine[k], theirs[k]), k


def test_dcgan64_flops():
    arch = spec.arch_module("dcgan64")
    assert arch.step_flops(MODEL, False) == 2_268_332_032
    assert arch.d_forward_flops(MODEL) == 207_634_432
    assert arch.step_flops(MODEL, True) == FL.dcgan_step_flops(MODEL, True)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_every_configuration_has_its_plugin(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    arch = spec.arch_module(spec.load_json(spec.ROOT / entry["file"])["model"]["arch"])
    for part in PARTS:
        assert callable(getattr(arch, part)), part
    assert isinstance(arch.STYLE, str) and arch.RECORDED


def _readings(workload: str):
    """A run of ``workload`` at the CPU tests' size: set-up, a short
    window, the traced unit's FLOPs and the judge's readings."""
    n, bs = SMALL[workload]
    run = drivers.Run(spec.load_cell(workload), 20260, "cpu",
                      scale=dict(n_images=n, batch_size=bs))
    run.setup()
    run.run_window(0.5)
    # the FLOPs of the window's first unit, as a traced run counts them
    run.traced = dict(run.window["units"][0], engine=run._traced_engine())
    flops = W.train_unit_flops(run)
    run.trainer.drop_captures()
    nums = checks.readings(run)
    run.close()
    return run, nums, flops


@pytest.mark.parametrize("workload", ["final.strain_epoch", "batch_mask.masked_epoch"])
def test_run_goes_through_the_plugin(tmp_path, monkeypatch, workload):
    _plugins(tmp_path / "before", monkeypatch, BEFORE)
    old, before, flops_before = _readings(workload)
    _plugins(tmp_path / "counting", monkeypatch, COUNTING)
    run, nums, flops = _readings(workload)
    calls = run.arch.CALLS
    units = len(run.window["units"])
    assert calls["weights"] == calls["load"] == 1
    # one D state to put in place in final's traffic, none in batch_mask's
    assert calls.get("as_trained", 0) == int(bool(run.traffic.get("d_state")))
    # a unit restarts from the checked epoch's start; the recorder
    # snapshots that start and the end of each stage
    assert calls["restart"] == units
    assert calls["snapshot"] >= 1 + len(run.checked["stages"])
    assert calls["step_flops"] == 1
    assert calls.get("d_forward_flops", 0) == int(bool(run.traced["engine"].get("score_path")))
    assert nums == before
    assert flops == flops_before > 0
    assert run.window["units"][0] == dict(old.window["units"][0],
                                          seconds=run.window["units"][0]["seconds"])
    # a restart puts back the checked epoch's start, with fresh Adam states
    start = run.checked["initial"]
    run.arch.restart(run.trainer, start)
    now = run.arch.snapshot(run.trainer)
    for side in ("g", "d"):
        assert all(torch.equal(now[side][k], v) for k, v in start[side].items())
        for st in now["opt_" + side].values():
            assert not any(bool(st[k].any()) for k in ("m", "v", "t"))


def test_missing_plugin_is_refused_by_its_path():
    with pytest.raises(FileNotFoundError, match=re.escape(str(spec.ARCHS / "no_such_arch.py"))):
        spec.arch_module("no_such_arch")
    cell = spec.load_cell("batch_mask.masked_epoch")
    cell.config = dict(cell.config, model=dict(cell.config["model"], arch="no_such_arch"))
    with pytest.raises(FileNotFoundError, match="no_such_arch.py"):
        drivers.Run(cell, 1, "cpu")


def test_d_state_needs_as_trained(tmp_path, monkeypatch):
    # an architecture that cannot put D in a trained state cannot run a
    # traffic mix that asks for one
    _plugins(tmp_path, monkeypatch, COUNTING.replace("'as_trained', ", ""))
    run = drivers.Run(spec.load_cell("final.strain_epoch"), 1, "cpu",
                      scale=dict(n_images=200, batch_size=16))
    assert run.traffic.get("d_state")
    with pytest.raises(ValueError, match="as_trained"):
        run.setup()
