"""The port's data-parallel rank path against one rank and against the JAX
dp mesh (CPU, gloo, float32, one torch thread a rank).

A narrow DCGAN (ngf = ndf = 8) at batch 16 takes one step from weights
bridged out of a flax state, on a fixed uint8 batch and the noise the JAX
step draws from its key (entry 0 of ``jax.random.split(key, 6)``).  The
port runs it in spawned processes (``tests/test_torch_dp_worker.py``): two gloo
ranks, one gloo rank, and in this process with no group.  Cases: a
``basic`` step, a ``batch_mask`` step with the in-step keep, the same on a
partial tail of 5 valid lanes (rank 1's lanes all padding), the sharded
eval-mode D-loss pass, and the Trainer's error for a batch the ranks
cannot share.

* World size 1 with a group is bit-equal to no group: every metric, the
  parameters, BatchNorm buffers and Adam moments, and the loss pass.
* World size 2 against world size 1, and against the JAX
  ``make_train_step(mesh=...)`` with dp=2 on two virtual CPU devices
  (``basic`` and ``batch_mask``): metrics, parameters, buffers and Adam
  moments at atol 1e-5 / rtol 1e-4 (tests/test_torch_step.py's), with its
  carve-out for the parameters only: where a gradient is at float32 noise
  level (|mu| <= 1e-6 of its tensor's largest), Adam's first step turns
  its last bits into an O(lr) update of either sign, so those elements
  are held to |update| <= lr.  The keep mask equal on both ranks and to
  world size 1's and the JAX mask, bit for bit; the contamination counts
  equal.
* The loss pass: each rank scores its block and the gathered vectors are
  equal across ranks and to the unsharded pass, bit for bit.
* The deferred-stats path under the ranks: a tiny ``final`` whose strain
  epochs 1 and 2 are deferred, bit-equal to the same run blocking, on
  every rank, with no group, one rank and two.

Every spawned rank is started through tests/test_torch_ranks.py (a
rendezvous this process holds), joined with a 120 s limit, and every
collective times out after 60 s, so a hang fails one test instead of the
suite, with each rank's traceback or stacks in the failure.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.config import get_preset as jax_preset
from strainer_gan_tpu.models import Discriminator64 as JDisc, Generator64 as JGen
from strainer_gan_tpu.parallel.mesh import make_mesh, put_batch_sharded, put_replicated
from strainer_gan_tpu.train.loop import step_config_from as jax_step_config
from strainer_gan_tpu.train.state import create_state
from strainer_gan_tpu.train.steps import make_train_step

from strainer_gan_tpu_torch import bridge
from strainer_gan_tpu_torch.models import Discriminator64, Generator64

import test_torch_dp_worker as W
import test_torch_ranks as R
from test_torch_mlp_step import ATOL, RTOL

JOIN_S = 120
LR = 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _spawn(world, tmp, tag):
    R.run(W.run_rank, world, tmp, tag, JOIN_S, args=(str(tmp), tag))
    return [torch.load(tmp / f"out_{tag}_{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX state and key, and the port's results: no group (this
    process), one gloo rank, two gloo ranks."""
    tmp = tmp_path_factory.mktemp("dp")
    cfg = W.tiny(jax_preset("basic"))
    jgen = JGen(nz=100, ngf=W.WIDTH, compute_dtype=jnp.float32)
    jdisc = JDisc(ndf=W.WIDTH, compute_dtype=jnp.float32)
    state = jax.jit(lambda k: create_state(cfg, jgen, jdisc, k))(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    batch = rng.integers(0, 256, (W.B, 64, 64, 3)).astype(np.uint8)
    src = (rng.uniform(size=W.B) < 0.3).astype(np.int32)
    key = jax.random.PRNGKey(9)
    z = np.asarray(jax.random.normal(jax.random.split(key, 6)[0], (W.B, 100), jnp.float32))
    gen = bridge.load_dcgan_from_flax(Generator64(100, W.WIDTH), _np(state.g_params),
                                      _np(state.g_stats))
    disc = bridge.load_dcgan_from_flax(Discriminator64(W.WIDTH), _np(state.d_params),
                                       _np(state.d_stats))
    inputs = dict(gen=gen.state_dict(), disc=disc.state_dict(), batch=torch.from_numpy(batch),
                  src=torch.from_numpy(src), z=torch.from_numpy(z.copy()), lr=LR,
                  score_images=rng.integers(0, 256, (37, 64, 64, 3)).astype(np.uint8))
    torch.save(inputs, tmp / "inputs.pt")
    plain = W.run_cases(inputs)
    return dict(jax=(jgen, jdisc, state, batch, src, key), plain=plain,
                one=_spawn(1, tmp, "one"), two=_spawn(2, tmp, "two"))




def _close(got, want, what, before=None, mu=None):
    """``got`` against ``want`` at ATOL/RTOL; parameters with ``mu`` (their
    Adam first moment) keep the noise-level carve-out against ``before``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    ok = np.ones(got.shape, bool)
    if mu is not None:
        m = np.abs(np.asarray(mu))
        noisy = m <= 1e-6 * m.max()
        ok = ~noisy
        for p in (got, want):
            assert np.all(np.abs(p[noisy] - np.asarray(before)[noisy]) <= LR * (1 + 1e-3)), what
    np.testing.assert_allclose(got[ok], want[ok], atol=ATOL, rtol=RTOL, err_msg=what)


def _compare_ranks(got, want, what, inputs_state):
    """A rank's case result against a reference case result."""
    for k, v in want["metrics"].items():
        if v.dtype == torch.bool or not v.is_floating_point():
            assert torch.equal(got["metrics"][k], v), f"{what} {k}"
        else:
            _close(got["metrics"][k], v, f"{what} {k}")
    st_g, st_w = got["state"], want["state"]
    for k, v in st_w.items():
        if ".mu." in k or ".nu." in k or not k.endswith(("weight", "bias")):
            _close(st_g[k], v, f"{what} {k}")
        else:
            mod, name = k.split(".", 1)
            _close(st_g[k], v, f"{what} {k}", before=inputs_state[k],
                   mu=st_w[f"{mod}.mu.{name}"])


def _initial(runs):
    gen = runs["plain"]["full"]["state"]  # any case: for the keys
    jgen, jdisc, state, *_ = runs["jax"]
    g = bridge.load_dcgan_from_flax(Generator64(100, W.WIDTH), _np(state.g_params),
                                    _np(state.g_stats))
    d = bridge.load_dcgan_from_flax(Discriminator64(W.WIDTH), _np(state.d_params),
                                    _np(state.d_stats))
    init = {f"G.{k}": v for k, v in g.state_dict().items()}
    init.update({f"D.{k}": v for k, v in d.state_dict().items()})
    assert set(init) <= set(gen)
    return init


def test_world1_group_bit_equal_no_group(runs):
    (one,), plain = runs["one"], runs["plain"]
    for case in ("full", "mask", "tail"):
        for part in ("metrics", "state"):
            for k, v in plain[case][part].items():
                assert torch.equal(one[case][part][k], v), f"{case} {part} {k}"
    assert torch.equal(one["score"], plain["score"])
    assert one["divisible"] == plain["divisible"] == ""


@pytest.mark.parametrize("case", ["full", "mask", "tail"])
def test_world2_matches_world1(runs, case):
    r0, r1 = runs["two"]
    init = _initial(runs)
    for r in (r0, r1):
        _compare_ranks(r[case], runs["plain"][case], f"{case} rank", init)
    # every rank holds the same global step: states and metrics bit-equal
    for part in ("metrics", "state"):
        for k, v in r0[case][part].items():
            assert torch.equal(r1[case][part][k], v), f"{case} {part} {k} across ranks"
    keep = r0[case]["metrics"]["keep_mask"]
    assert torch.equal(keep, runs["plain"][case]["metrics"]["keep_mask"])
    if case == "tail":
        # rank 1 held padding only: 5 valid lanes, all on rank 0
        assert int(keep.sum()) <= W.TAIL and not keep[W.B // 2:].any()
        assert r0[case]["metrics"]["real_loss_per_sample"].shape == (W.B,)
    if case != "full":
        assert 0 < int(keep.sum()) < (W.TAIL if case == "tail" else W.B)


@pytest.mark.parametrize("case,preset,mask_on", [("full", "basic", False),
                                                 ("mask", "batch_mask", True)])
def test_world2_matches_jax_mesh(runs, case, preset, mask_on):
    jgen, jdisc, state, batch, src, key = runs["jax"]
    mesh = make_mesh(2, devices=jax.devices("cpu")[:2])
    jcfg = W.tiny(jax_preset(preset))
    step = make_train_step(jgen, jdisc, jax_step_config(jcfg), donate=False, mesh=mesh)
    s1, jm = step(put_replicated(state, mesh), put_batch_sharded(jnp.asarray(batch), mesh),
                  put_batch_sharded(jnp.asarray(src), mesh), key, LR, LR, mask_on,
                  jnp.asarray(False), None, True)
    want = dict(metrics={k: torch.from_numpy(np.array(v)) for k, v in jm.items()},
                state={})
    for name, params, stats, opt in (("G", s1.g_params, s1.g_stats, s1.g_opt),
                                     ("D", s1.d_params, s1.d_stats, s1.d_opt)):
        module = (Generator64(100, W.WIDTH) if name == "G" else Discriminator64(W.WIDTH))
        bridge.load_dcgan_from_flax(module, _np(params), _np(stats))
        want["state"].update({f"{name}.{k}": v.clone() for k, v in
                              module.state_dict().items()})
        for tag, tree in (("mu", opt.mu), ("nu", opt.nu)):
            bridge.load_dcgan_from_flax(module, _np(tree))
            want["state"].update({f"{name}.{tag}.{k}": v.detach().clone() for k, v in
                                  module.named_parameters()})
    got = runs["two"][0][case]
    assert set(got["metrics"]) == set(want["metrics"])
    want["metrics"] = {k: v.to(got["metrics"][k].dtype) for k, v in want["metrics"].items()}
    _compare_ranks(got, want, f"{case} vs JAX dp=2", _initial(runs))


def test_sharded_loss_pass_equal_across_ranks(runs):
    r0, r1 = runs["two"]
    assert r0["score"].shape == (37,)
    assert torch.equal(r0["score"], r1["score"])
    assert torch.equal(r0["score"], runs["plain"]["score"])


def test_batch_not_divisible(runs):
    r0, r1 = runs["two"]
    assert r0["divisible"] == r1["divisible"] == "batch_size 15 not divisible by dp=2"


def _same(a, b):
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b[k]), k
        elif k in ("masks", "history"):
            assert len(v) == len(b[k]) and all(np.array_equal(x, y) for x, y in zip(v, b[k])), k
        elif k != "paths":
            assert v == b[k], k


@pytest.mark.parametrize("world", ["plain", "one", "two"])
def test_deferred_bit_equal_to_blocking(runs, world):
    ranks = [runs["plain"]] if world == "plain" else runs[world]
    for r in ranks:
        d, b = r["deferred"][True], r["deferred"][False]
        assert d["paths"] == (2, 1) and b["paths"] == (0, 3)
        _same(d, b)
        steps = [s for s, _ in d["results"]]
        assert steps[1] < min(steps[0], steps[2]) and all(a % 8 for _, a in d["results"])
    for r in ranks[1:]:
        _same(r["deferred"][True], ranks[0]["deferred"][True])
