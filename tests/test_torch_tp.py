"""The port's dp x tp helpers against the JAX package's (CPU, gloo, float32,
one torch thread a rank).

* Placement: ``parallel.mesh.tp_placement`` decides, leaf for leaf, what
  JAX's ``tp_sharding_for`` decides on the flax tree the bridge maps each
  torch leaf to (parameters, BatchNorm statistics and both Adam moments),
  along the torch dim that is the flax leaf's last axis.  The DCGAN at tp
  2 (every hidden width sharded, D's 1-channel and G's 3-channel last
  layers replicated) and 3 (only G's 3-channel last layer sharded); the
  MLP (``mnist8``'s and ``mnist_full``'s, whose G has BatchNorms) at tp 2
  (every hidden width and G's 784-wide output sharded, D's 1-wide output
  replicated) and 3 (nothing divides: all replicated).
  ``put_state_tp`` keeps each rank's slice of parameters, buffers and Adam
  moments in place (the optimizers keep their parameter objects), for the
  DCGAN and for the MLP with G's BatchNorms.
* A 2 x 2 grid of 4 spawned gloo ranks (tests/test_torch_tp_worker.py) runs
  one narrow ``basic`` step (ngf = ndf = 8, batch 16) from weights bridged
  out of a flax state: its metrics and its state gathered again over each
  tp group match the port's step with no group at atol 1e-5 / rtol 1e-4
  with tests/test_torch_dp.py's noise-level carve-out, and the JAX
  single-device step within tests/test_parallel.py:201-210's tolerances
  (errD and errG at rtol 2e-3 / atol 1e-4, G's parameters at atol 5e-4);
  the gathered state is bit-equal on all four ranks, and D has sharded
  kernels.
* A 1 x 3 grid (three gloo ranks: only G's 3-channel output layer
  sharded, its output gathered) matches the step with no group as above.
* A 1 x 1 grid (one gloo rank) is bit-equal to the step with no group.
* Under a grid no preset's step is refused: with no process group (a
  1 x 1 grid whose groups are never used) each preset's step is the step
  with no grid, bit for bit.

Every other step variant on the grids (the in-step keep, recycling, the
pool, the MLP steps) and the chunked executor under a grid:
tests/test_torch_tp_variants.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.config import get_preset as jax_preset
from strainer_gan_tpu.models import Discriminator64 as JDisc, Generator64 as JGen
from strainer_gan_tpu.parallel.mesh import make_mesh_2d as jax_mesh_2d, tp_sharding_for
from strainer_gan_tpu.train.loop import step_config_from as jax_step_config
from strainer_gan_tpu.train.state import create_state
from strainer_gan_tpu.train.steps import make_train_step

from strainer_gan_tpu.models import build_models as jax_build_models

from strainer_gan_tpu_torch import bridge, get_preset
from strainer_gan_tpu_torch.config import PRESETS
from strainer_gan_tpu_torch.data import normalize_u8
from strainer_gan_tpu_torch.models import Discriminator64, Generator64, build_models
from strainer_gan_tpu_torch.parallel import mesh as M
from strainer_gan_tpu_torch.train.state import make_optimizers
from strainer_gan_tpu_torch.train.steps import drop_shape, step_config_from, train_step

import test_torch_dp_worker as DW
import test_torch_tp_worker as W
import test_torch_ranks as R
from test_torch_dp import LR, _compare_ranks

JOIN_S = 120
# where each bridge layout puts the flax last axis in the torch tensor
TORCH_DIM = {"conv": 0, "convT": 1, "dense": 0, "vec": 0}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_setup():
    cfg = DW.tiny(jax_preset("basic"))
    jgen = JGen(nz=100, ngf=DW.WIDTH, compute_dtype=jnp.float32)
    jdisc = JDisc(ndf=DW.WIDTH, compute_dtype=jnp.float32)
    state = jax.jit(lambda k: create_state(cfg, jgen, jdisc, k))(jax.random.PRNGKey(3))
    rng = np.random.default_rng(1)
    batch = rng.integers(0, 256, (DW.B, 64, 64, 3)).astype(np.uint8)
    src = np.zeros((DW.B,), np.int32)
    key = jax.random.PRNGKey(9)
    z = np.asarray(jax.random.normal(jax.random.split(key, 6)[0], (DW.B, 100), jnp.float32))
    gen = bridge.load_dcgan_from_flax(Generator64(100, DW.WIDTH), _np(state.g_params),
                                      _np(state.g_stats))
    disc = bridge.load_dcgan_from_flax(Discriminator64(DW.WIDTH), _np(state.d_params),
                                       _np(state.d_stats))
    inputs = dict(gen=gen.state_dict(), disc=disc.state_dict(), batch=torch.from_numpy(batch),
                  src=torch.from_numpy(src), z=torch.from_numpy(z.copy()), lr=LR)
    return dict(cfg=cfg, jgen=jgen, jdisc=jdisc, state=state, key=key, inputs=inputs)


@pytest.mark.parametrize("tp", [2, 3])
def test_placement_is_jax_tp_sharding_for(jax_setup, tp):
    state = jax_setup["state"]
    mesh = jax_mesh_2d(1, tp, devices=jax.devices("cpu")[:tp])
    n_sharded = 0
    for module, params, stats, opt in (
            (Generator64(100, DW.WIDTH), state.g_params, state.g_stats, state.g_opt),
            (Discriminator64(DW.WIDTH), state.d_params, state.d_stats, state.d_opt)):
        placement = M.tp_placement(module, tp)
        trees = {"params": [params, opt.mu, opt.nu], "batch_stats": [stats]}
        seen = set()
        for name, coll, path, layout in bridge._entries(module):
            seen.add(name)
            for tree in trees[coll]:  # the parameter and both Adam moments
                leaf = bridge._get(tree, path)
                spec = tp_sharding_for(leaf, mesh).spec
                want = None if spec == jax.sharding.PartitionSpec() else TORCH_DIM[layout]
                assert placement[name] == want, (name, coll, spec, placement[name])
            n_sharded += placement[name] is not None
        assert seen == set(placement)
    assert n_sharded > 0
    if tp == 3:  # only G's 3-channel output layer divides by 3
        assert M.tp_placement(Generator64(100, DW.WIDTH), 3)["convs.4.weight"] == 1


def test_put_state_tp_slices_in_place(jax_setup):
    """Each coordinate's slices of parameters, buffers and Adam moments
    (after a step, so the moments exist), the parameters still the
    optimizers' objects."""
    for t in range(2):
        gen, disc, opt_g, opt_d, scfg = W.modules_and_config(jax_setup["inputs"])
        inp = jax_setup["inputs"]
        train_step(gen, disc, opt_g, opt_d, normalize_u8(inp["batch"]), inp["src"], inp["z"],
                   LR, LR, scfg)
        before = DW.state_of(gen, disc, opt_g, opt_d)
        placement = W.placement_of(gen, disc, 2)
        params = [id(p) for g in (*opt_g.param_groups, *opt_d.param_groups) for p in g["params"]]
        grid = M.Grid(dp=1, tp=2, d=0, t=t, dp_group=None, tp_group=None)
        M.put_state_tp(grid, [gen, disc], [opt_g, opt_d])
        after = DW.state_of(gen, disc, opt_g, opt_d)
        assert [id(p) for g in (*opt_g.param_groups, *opt_d.param_groups)
                for p in g["params"]] == params
        for k, v in before.items():
            dim = placement[k]
            want = v if dim is None else v.narrow(dim, t * v.shape[dim] // 2, v.shape[dim] // 2)
            assert torch.equal(after[k], want), k
        assert sum(d is not None for k, d in placement.items() if ".mu." in k) > 0


def _spawn(dp, tp, tmp, tag, inputs):
    torch.save(inputs, tmp / "inputs.pt")
    R.run(W.run_rank, dp * tp, tmp, tag, JOIN_S, args=(dp, tp, str(tmp), tag))
    return [torch.load(tmp / f"out_{tag}_{r}.pt", weights_only=False) for r in range(dp * tp)]


@pytest.fixture(scope="module")
def grid_runs(jax_setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    inputs = jax_setup["inputs"]
    return dict(plain=W.step(inputs), two=_spawn(2, 2, tmp, "2x2", inputs),
                one=_spawn(1, 1, tmp, "1x1", inputs), three=_spawn(1, 3, tmp, "1x3", inputs))


def _initial(inputs):
    init = {f"G.{k}": v for k, v in inputs["gen"].items()}
    init.update({f"D.{k}": v for k, v in inputs["disc"].items()})
    return init


def test_2x2_step_matches_no_group(grid_runs, jax_setup):
    ranks = grid_runs["two"]
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    plain = grid_runs["plain"]
    for r, out in enumerate(ranks):
        got = dict(metrics=out["step"]["metrics"], state=out["step"]["state"])
        _compare_ranks(got, dict(metrics=plain["metrics"], state=plain["shards"]),
                       f"2x2 rank {r}", _initial(jax_setup["inputs"]))
    # the state gathered again is one state on every rank, and the shards
    # of a tp group are the two halves of it
    first = ranks[0]["step"]
    for out in ranks[1:]:
        for k, v in first["state"].items():
            assert torch.equal(out["step"]["state"][k], v), k
        for k, v in first["metrics"].items():
            assert torch.equal(out["step"]["metrics"][k], v), k
    placement = W.placement_of(*W.modules_and_config(jax_setup["inputs"])[:2], 2)
    sharded_d = [k for k, d in placement.items() if k.startswith("D.convs") and d is not None]
    assert sharded_d
    for k in sharded_d:
        halves = [ranks[i]["step"]["shards"][k] for i in (0, 1)]
        assert halves[0].shape[placement[k]] * 2 == first["state"][k].shape[placement[k]]
        assert torch.equal(torch.cat(halves, placement[k]), first["state"][k]), k


def test_2x2_step_matches_jax_single_device(grid_runs, jax_setup):
    js = jax_setup
    step = make_train_step(js["jgen"], js["jdisc"], jax_step_config(js["cfg"]), donate=False)
    s1, m1 = step(js["state"], jnp.asarray(js["inputs"]["batch"].numpy()),
                  jnp.asarray(js["inputs"]["src"].numpy()), js["key"], jnp.float32(LR),
                  jnp.float32(LR), False, jnp.asarray(False), None)
    got = grid_runs["two"][0]["step"]
    for k in ("errD", "errG"):
        np.testing.assert_allclose(float(got["metrics"][k]), float(m1[k]), rtol=2e-3, atol=1e-4)
    want = bridge.load_dcgan_from_flax(Generator64(100, DW.WIDTH), _np(s1.g_params))
    for k, v in want.named_parameters():
        np.testing.assert_allclose(got["state"][f"G.{k}"].numpy(), v.detach().numpy(),
                                   atol=5e-4, err_msg=k)


def test_1x3_step_shards_the_last_layer(grid_runs, jax_setup):
    """At tp 3 only G's 3-channel output layer is sharded: its input enters
    whole and its output is gathered (the forward hook)."""
    placement = W.placement_of(*W.modules_and_config(jax_setup["inputs"])[:2], 3)
    assert [k for k, d in placement.items() if d is not None and ".mu." not in k
            and ".nu." not in k] == ["G.convs.4.weight"]
    plain = grid_runs["plain"]
    for r, out in enumerate(grid_runs["three"]):
        assert out["step"]["shards"]["G.convs.4.weight"].shape[1] == 1
        got = dict(metrics=out["step"]["metrics"], state=out["step"]["state"])
        _compare_ranks(got, dict(metrics=plain["metrics"], state=plain["shards"]),
                       f"1x3 rank {r}", _initial(jax_setup["inputs"]))


def test_1x1_grid_bit_equal_no_group(grid_runs):
    (one,) = grid_runs["one"]
    plain = grid_runs["plain"]
    for k, v in plain["metrics"].items():
        assert torch.equal(one["step"]["metrics"][k], v), k
    for k, v in plain["shards"].items():
        assert torch.equal(one["step"]["shards"][k], v), k
        assert torch.equal(one["step"]["state"][k], v), k


@pytest.mark.parametrize("tp", [2, 3])
@pytest.mark.parametrize("preset", ["mnist8", "mnist_full"])
def test_mlp_placement_is_jax_tp_sharding_for(preset, tp):
    cfg = DW.tiny(jax_preset(preset))
    jgen, jdisc = jax_build_models(cfg.model)
    state = create_state(cfg, jgen, jdisc, jax.random.PRNGKey(3))
    mesh = jax_mesh_2d(1, tp, devices=jax.devices("cpu")[:tp])
    gen, disc = build_models(W.variant_config(preset).model)
    sharded = set()
    for module, params, stats, opt in ((gen, state.g_params, state.g_stats, state.g_opt),
                                       (disc, state.d_params, state.d_stats, state.d_opt)):
        placement = M.tp_placement(module, tp)
        trees = {"params": [params, opt.mu, opt.nu], "batch_stats": [stats]}
        seen = set()
        for name, coll, path, layout in bridge._entries(module):
            seen.add(name)
            for tree in trees[coll]:
                spec = tp_sharding_for(bridge._get(tree, path), mesh).spec
                want = None if spec == jax.sharding.PartitionSpec() else TORCH_DIM[layout]
                assert placement[name] == want, (name, coll, spec, placement[name])
        assert seen == set(placement)
        tag = "G" if module is gen else "D"
        sharded |= {f"{tag}.{k}" for k, d in placement.items() if d is not None}
    if tp == 3:  # 256, 512, 1024, 784 and 1 are not multiples of 3
        assert not sharded
        return
    linears = {f"{t}.linears.{i}.{p}" for t in "GD" for i in range(4) for p in ("weight", "bias")}
    assert sharded & linears == linears - {"D.linears.3.weight", "D.linears.3.bias"}
    bns = {k for k in sharded if ".bns." in k}
    assert len(bns) == (12 if preset == "mnist_full" else 0)  # 3 BatchNorms x 4 leaves


def test_put_state_tp_slices_mlp_in_place():
    """``mnist_full``'s MLP after a step: each coordinate's slices of the
    Linears, G's BatchNorm parameters and running statistics, and the Adam
    moments."""
    cfg = DW.tiny(get_preset("mnist_full"))
    scfg = step_config_from(cfg)
    g = torch.Generator().manual_seed(0)
    x = torch.rand((DW.B, 1, 28, 28), generator=g) * 2 - 1
    z = torch.randn((DW.B, 100), generator=g)
    drop = [torch.rand(drop_shape(scfg, DW.B, w), generator=g) < 0.7 for w in scfg.drop_widths]
    for t in range(2):
        gen, disc = build_models(cfg.model)
        opt_g, opt_d = make_optimizers(cfg, gen, disc)
        train_step(gen, disc, opt_g, opt_d, x, torch.zeros(DW.B, dtype=torch.int32), z, LR, LR,
                   scfg, drop_masks=drop)
        before = DW.state_of(gen, disc, opt_g, opt_d)
        placement = W.placement_of(gen, disc, 2)
        M.put_state_tp(M.Grid(dp=1, tp=2, d=0, t=t, dp_group=None, tp_group=None),
                       [gen, disc], [opt_g, opt_d])
        after = DW.state_of(gen, disc, opt_g, opt_d)
        for k, v in before.items():
            dim = placement[k]
            want = v if dim is None else v.narrow(dim, t * v.shape[dim] // 2, v.shape[dim] // 2)
            assert torch.equal(after[k], want), k
        assert placement["G.bns.0.running_mean"] == 0 and placement["D.linears.3.weight"] is None


def _preset_inputs(cfg, scfg, g):
    mlp = cfg.model.arch == "mlp"
    shape = (DW.B, 1, 28, 28) if mlp else (DW.B, cfg.model.nc, 64, 64)
    kw = dict(mask_on=True)
    if scfg.pool_concat:
        pool = torch.randint(0, 256, (6,) + shape[2:] + shape[1:2], generator=g,
                             dtype=torch.uint8)
        kw.update(fake_pool=pool, pool_idx=torch.randint(0, 6, (DW.B,), generator=g),
                  concat_on=True)
    if scfg.dropout:
        kw["drop_masks"] = [torch.rand(drop_shape(scfg, DW.B, w), generator=g) < 0.7
                            for w in scfg.drop_widths]
    return (torch.rand(shape, generator=g) * 2 - 1, torch.zeros(DW.B, dtype=torch.int32),
            torch.randn((DW.B, scfg.nz), generator=g)), kw


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_no_preset_step_refused_under_a_grid(preset):
    cfg = DW.tiny(get_preset(preset))
    scfg = step_config_from(cfg)
    (x, src, z), kw = _preset_inputs(cfg, scfg, torch.Generator().manual_seed(1))
    runs = []
    for grid in (None, M.Grid(dp=1, tp=1, d=0, t=0, dp_group=None, tp_group=None)):
        gen, disc = build_models(cfg.model)
        opt_g, opt_d = make_optimizers(cfg, gen, disc)
        with W._grid_ctx(grid):
            m = train_step(gen, disc, opt_g, opt_d, x, src, z, LR, LR, scfg, **kw)
        runs.append((m, DW.state_of(gen, disc, opt_g, opt_d)))
    assert M.grid() is None
    (m0, s0), (m1, s1) = runs
    for k, v in m0.items():
        assert torch.equal(m1[k], v), k
    for k, v in s0.items():
        assert torch.equal(s1[k], v), k
