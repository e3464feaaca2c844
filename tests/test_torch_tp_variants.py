"""Every step variant of the port on a dp x tp grid against the port with no
group and against the JAX package (CPU, gloo, float32, one torch thread a
rank).

The variants (tests/test_torch_tp_worker.py's ``VARIANTS``), one step each
from weights bridged out of a flax state, at batch 16: ``batch_mask`` with
its in-step keep on, the same on a partial tail of 11 valid lanes
(``lane_count``: the quantile of the valid lanes only), ``in_batch_recycle``
with its keep on, ``strainer_concat_fast``'s pool step with its gate on
(pool rows from the JAX step's ``k_pool`` permutation), the DCGAN at width
8; ``mnist8`` (G first) and ``mnist_full`` (D first, G's BatchNorm1d, D's
dropout with the JAX step's own keep masks, read off the flax D) at their
published widths.  The JAX step's noise is entry 0 of
``jax.random.split(key, 6)``; the port's step gets it.

One spawn of a 2 x 2 grid (four gloo ranks; at tp 2 every hidden layer of
both architectures is sharded) and one of a 1 x 1 grid run every variant
in sequence, while this process runs the same steps with no group and the
JAX steps:

* 2 x 2 against no group: metrics and the state gathered again over each
  tp group at atol 1e-5 / rtol 1e-4 with tests/test_torch_dp.py's
  noise-level carve-out; the keep mask and the counts exactly; metrics and
  state bit-equal on all four ranks.
* 2 x 2 against the JAX single-device step, within
  tests/test_parallel.py:201-210's tolerances (errD and errG at rtol 2e-3
  / atol 1e-4, parameters at atol 5e-4), and the keep mask exactly.
* ``batch_mask`` on the 2 x 2 grid against JAX's own 2 x 2 step on a state
  placed by JAX's ``put_state_tp`` (GSPMD's in-step quantile): the keep
  mask exactly, metrics and state as against no group.
* 1 x 1 against no group: bit for bit.
* The chunked executor on the 2 x 2 grid (``chunk_runs``): a
  ``ChunkedStep`` of 4 masked steps on a sample-sharded copy of the dataset
  equals the same 4 steps one by one on the replicated dataset, bit for
  bit on every rank; so do the 3 live steps of a ``GatedChunkedStep`` of 4.

Every spawned rank is joined with a time limit and every collective times
out after 60 s, so a hang fails the tests instead of the suite.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from strainer_gan_tpu.config import get_preset as jax_preset
from strainer_gan_tpu.models import build_models as jax_build_models
from strainer_gan_tpu.parallel.mesh import make_mesh_2d as jax_mesh_2d, put_state_tp
from strainer_gan_tpu.train.loop import step_config_from as jax_step_config
from strainer_gan_tpu.train.state import create_state
from strainer_gan_tpu.train.steps import make_train_step

from strainer_gan_tpu_torch import bridge
from strainer_gan_tpu_torch.models import build_models

import test_torch_dp_worker as DW
import test_torch_tp_worker as W
import test_torch_ranks as R
from test_torch_dp import LR, _compare_ranks
from test_torch_mlp_gan import jax_drop_masks

JOIN_S = 240  # from the spawn: the ranks wait while this process runs JAX
POOL_N = 20
MASKED = ("batch_mask", "batch_mask_tail", "in_batch_recycle")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_config(preset):
    return DW.tiny(jax_preset(preset))


def _variant_inputs(v, preset, state, jdisc, seed):
    """The port's inputs of variant ``v`` and the JAX step's arguments."""
    cfg = _jax_config(preset)
    rng = np.random.default_rng(seed)
    mlp = cfg.model.arch == "mlp"
    shape = (DW.B, 28, 28, 1) if mlp else (DW.B, 64, 64, 3)
    batch = rng.integers(0, 256, shape).astype(np.uint8)
    src = (rng.uniform(size=DW.B) < 0.3).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    keys = jax.random.split(key, 6)
    z = np.asarray(jax.random.normal(keys[0], (DW.B, 100), jnp.float32))
    port = build_models(W.variant_config(preset).model)
    gen = bridge.load_dcgan_from_flax(port[0], _np(state.g_params), _np(state.g_stats) or None)
    disc = bridge.load_dcgan_from_flax(port[1], _np(state.d_params), _np(state.d_stats) or None)
    inputs = dict(gen=gen.state_dict(), disc=disc.state_dict(), batch=torch.from_numpy(batch),
                  src=torch.from_numpy(src), z=torch.from_numpy(z.copy()), lr=LR)
    gates = W.VARIANTS[v][1]
    jargs = dict(mask_on=gates.get("mask_on", False), concat_on=gates.get("concat_on", False),
                 pool=None, kw={})
    if "lane_count" in gates:
        jargs["kw"] = dict(lane_count=jnp.asarray(gates["lane_count"], jnp.int32))
    if cfg.strain.fake_concat == "pool":
        pool = rng.integers(0, 256, (POOL_N, 64, 64, 3)).astype(np.uint8)
        perm = np.asarray(jax.random.permutation(keys[5], POOL_N))
        inputs.update(pool=torch.from_numpy(pool),
                      pool_idx=torch.from_numpy(perm[np.arange(DW.B) % POOL_N].astype(np.int64)))
        jargs["pool"] = jnp.asarray(pool)
    if cfg.model.d_dropout > 0:  # D's real and fake forwards and G's update
        per_forward = [jax_drop_masks(jdisc, {"params": state.d_params}, keys[k], DW.B)
                       for k in (2, 3, 4)]
        inputs["drop"] = [torch.from_numpy(np.stack(ms)) for ms in zip(*per_forward)]
    return inputs, (batch, src, key, jargs)


def _start(dp, tp, tmp, tag, chunk):
    return R.Ranks(W.run_variants_rank, dp * tp, tmp, tag, args=(dp, tp, str(tmp), tag, chunk))


def _join(ranks, tmp, tag):
    ranks.join(JOIN_S)
    return [torch.load(tmp / f"out_{tag}_{r}.pt", weights_only=False)
            for r in range(len(ranks.procs))]


def _as_port(preset, s1) -> dict:
    """A JAX state as tests/test_torch_dp_worker.py's ``state_of`` keys it."""
    out = {}
    for name, module, params, stats, opt in (
            ("G", 0, s1.g_params, s1.g_stats, s1.g_opt),
            ("D", 1, s1.d_params, s1.d_stats, s1.d_opt)):
        m = build_models(W.variant_config(preset).model)[module]
        bridge.load_dcgan_from_flax(m, _np(params), _np(stats) or None)
        out.update({f"{name}.{k}": v.clone() for k, v in m.state_dict().items()})
        for tag, tree in (("mu", opt.mu), ("nu", opt.nu)):
            bridge.load_dcgan_from_flax(m, _np(tree))
            out.update({f"{name}.{tag}.{k}": v.detach().clone()
                        for k, v in m.named_parameters()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's results with no group (this process), on the 2 x 2 and
    1 x 1 grids (spawned), and the JAX results: single device per variant,
    and ``batch_mask`` on a 2 x 2 mesh."""
    tmp = tmp_path_factory.mktemp("tp_variants")
    states, inputs, jax_args = {}, {}, {}  # states: one a model (the DCGAN presets share)
    for seed, (v, (preset, _)) in enumerate(W.VARIANTS.items()):
        cfg = _jax_config(preset)
        if cfg.model not in states:
            jgen, jdisc = jax_build_models(cfg.model)
            states[cfg.model] = (jgen, jdisc, jax.jit(
                lambda k, cfg=cfg, g=jgen, d=jdisc: create_state(cfg, g, d, k))(
                    jax.random.PRNGKey(3)))
        jgen, jdisc, state = states[cfg.model]
        inputs[v], jax_args[v] = _variant_inputs(v, preset, state, jdisc, 40 + seed)
    rng = np.random.default_rng(7)
    inputs["chunk"] = dict(
        images=torch.from_numpy(rng.integers(0, 256, (W.N_IMAGES, 64, 64, 3)).astype(np.uint8)),
        src=torch.from_numpy((rng.uniform(size=W.N_IMAGES) < 0.3).astype(np.int32)),
        # each step's rows distinct, as an epoch's batches are
        idx=torch.from_numpy(np.stack([rng.permutation(W.N_IMAGES)[:DW.B]
                                       for _ in range(W.CHUNK)])),
        z=torch.from_numpy(rng.standard_normal((W.CHUNK, DW.B, 100)).astype(np.float32)))
    torch.save(inputs, tmp / "inputs.pt")
    spawned = {"2x2": _start(2, 2, tmp, "2x2", True), "1x1": _start(1, 1, tmp, "1x1", False)}

    def jax_step(v, mesh=None):
        preset = W.VARIANTS[v][0]
        jgen, jdisc, state = states[_jax_config(preset).model]
        batch, src, key, a = jax_args[v]
        step = make_train_step(jgen, jdisc, jax_step_config(_jax_config(preset)), donate=False)
        batch, src = jnp.asarray(batch), jnp.asarray(src)
        if mesh is not None:
            state = put_state_tp(state, mesh)
            batch, src = (jax.device_put(t, NamedSharding(mesh, P("dp"))) for t in (batch, src))
        s1, m = step(state, batch, src, key, LR, LR, a["mask_on"], jnp.asarray(a["concat_on"]),
                     a["pool"], True, **a["kw"])
        want = dict(metrics={k: torch.from_numpy(np.array(x)) for k, x in m.items()},
                    state=_as_port(preset, s1))
        return want

    mesh = jax_mesh_2d(2, 2, devices=jax.devices("cpu")[:4])
    with ThreadPoolExecutor(4) as ex:  # XLA compiles the steps side by side
        futures = {v: ex.submit(jax_step, v) for v in W.VARIANTS}
        futures["batch_mask_2x2"] = ex.submit(jax_step, "batch_mask", mesh)
        plain = W.variant_runs(inputs)
        jax_out = {k: f.result() for k, f in futures.items()}
    grids = {tag: _join(ranks, tmp, tag) for tag, ranks in spawned.items()}
    initial = {}
    for v in W.VARIANTS:
        initial[v] = {f"G.{k}": t for k, t in inputs[v]["gen"].items()}
        initial[v].update({f"D.{k}": t for k, t in inputs[v]["disc"].items()})
    return dict(plain=plain, jax=jax_out, initial=initial, **grids)


def _valid(v):
    return np.arange(DW.B) < W.VARIANTS[v][1].get("lane_count", DW.B)


@pytest.mark.parametrize("variant", list(W.VARIANTS))
def test_2x2_matches_no_group(runs, variant):
    ranks, plain = runs["2x2"], runs["plain"][variant]
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r, out in enumerate(ranks):
        got = dict(metrics=out[variant]["metrics"], state=out[variant]["state"])
        _compare_ranks(got, dict(metrics=plain["metrics"], state=plain["shards"]),
                       f"{variant} 2x2 rank {r}", runs["initial"][variant])
    # one global step on every rank: the keep too, bit for bit
    first = ranks[0][variant]
    for out in ranks[1:]:
        for part in ("metrics", "state"):
            for k, t in first[part].items():
                assert torch.equal(out[variant][part][k], t), f"{variant} {part} {k}"
    keep = first["metrics"]["keep_mask"]
    assert torch.equal(keep, plain["metrics"]["keep_mask"])
    valid = torch.from_numpy(_valid(variant))
    if variant in MASKED:
        assert 0 < int(keep.sum()) < int(valid.sum())
        assert not keep[~valid].any()
    else:
        assert torch.equal(keep, valid)
    # every hidden layer is sharded: each rank holds half of it
    sharded = [k for k, t in first["shards"].items() if t.shape != first["state"][k].shape]
    assert any(k.startswith("D.") for k in sharded) and any(k.startswith("G.") for k in sharded)


@pytest.mark.parametrize("variant", list(W.VARIANTS))
def test_2x2_matches_jax_single_device(runs, variant):
    got, want = runs["2x2"][0][variant], runs["jax"][variant]
    assert set(got["metrics"]) == set(want["metrics"])
    for k in ("errD", "errG"):
        np.testing.assert_allclose(float(got["metrics"][k]), float(want["metrics"][k]),
                                   rtol=2e-3, atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(got["metrics"]["keep_mask"].numpy(),
                                  want["metrics"]["keep_mask"].numpy())
    for k in ("n_contam", "n_filtered_contam"):
        assert int(got["metrics"][k]) == int(want["metrics"][k]), k
    params = [k for k in want["state"] if k.endswith(("weight", "bias"))
              and ".mu." not in k and ".nu." not in k]
    for k in params:
        np.testing.assert_allclose(got["state"][k].numpy(), want["state"][k].numpy(), atol=5e-4,
                                   err_msg=f"{variant} {k}")


def test_2x2_batch_mask_matches_jax_2x2_mesh(runs):
    """GSPMD's in-step quantile over the JAX 2 x 2 mesh keeps what the
    port's gathered scores keep."""
    got, want = runs["2x2"][0]["batch_mask"], runs["jax"]["batch_mask_2x2"]
    assert torch.equal(got["metrics"]["keep_mask"], want["metrics"]["keep_mask"])
    metrics = {k: t.to(got["metrics"][k].dtype) for k, t in want["metrics"].items()}
    _compare_ranks(dict(metrics=got["metrics"], state=got["state"]),
                   dict(metrics=metrics, state=want["state"]),
                   "batch_mask 2x2 vs the JAX 2x2 mesh", runs["initial"]["batch_mask"])


@pytest.mark.parametrize("variant", list(W.VARIANTS))
def test_1x1_bit_equal_no_group(runs, variant):
    (one,), plain = runs["1x1"], runs["plain"][variant]
    for k, t in plain["metrics"].items():
        assert torch.equal(one[variant]["metrics"][k], t), k
    for k, t in plain["shards"].items():
        assert torch.equal(one[variant]["shards"][k], t), k
        assert torch.equal(one[variant]["state"][k], t), k


@pytest.mark.parametrize("executor", ["chunked", "gated"])
def test_2x2_chunk_equals_per_step(runs, executor):
    live = W.CHUNK if executor == "chunked" else W.CHUNK - 1
    for r, out in enumerate(runs["2x2"]):
        c = out["chunk"]
        steps, got = c["steps"], c[executor]
        for k, t in steps["metrics"].items():
            assert torch.equal(got["metrics"][k][:live], t[:live]), f"rank {r} {k}"
        want = steps["shards"] if executor == "chunked" else c["after_gated"]
        for k, t in want.items():
            assert torch.equal(got["shards"][k], t), f"rank {r} {k}"
        assert bool(steps["metrics"]["keep_mask"].all(1).logical_not().all())
