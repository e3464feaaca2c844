"""``--dp`` through the command line on the CPU (gloo, spawned ranks).

* Under a launcher's environment (two processes with ``RANK`` /
  ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``), ``--dp 2`` trains a
  narrow ``batch_mask`` (ngf = ndf = 8, batch 16, a config JSON with
  ``mask_start_epoch=1``) across its gate for 2 epochs on a small
  synthetic mixture whose last batch is a partial tail.  Both ranks end
  with the same strain masks, the same in-step keep mask of every epoch's
  last step, the same per-sample losses, D losses and D weights, bit for
  bit; only rank 0 writes ``metrics.json``, whose values are rank 0's.
* Without a launcher, ``cli.run([... "--dp", "2"])`` spawns the two ranks
  itself and returns rank 0's results.

Every spawned rank is joined with a 120 s limit and every collective times
out after the group's limit, so a hang fails one test instead of the suite.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from strainer_gan_tpu_torch import cli, get_preset

import test_torch_dp_worker as W
import test_torch_ranks as R
from test_torch_dp import JOIN_S


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread here and in the ranks this process spawns."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def config_json(tmp_path_factory):
    cfg = W.tiny(get_preset("batch_mask"))
    cfg = cfg.replace(strain=dataclasses.replace(cfg.strain, mask_start_epoch=1),
                      train=dataclasses.replace(cfg.train, log_every=4, steps_per_dispatch=2))
    path = tmp_path_factory.mktemp("cfg") / "batch_mask.json"
    path.write_text(cfg.to_json())
    return str(path)


def _argv(config_json, out, epochs="2"):
    return ["--config", config_json, "--device", "cpu", "--max-synth", "90", "--epochs",
            epochs, "--dp", "2", "--out", str(out)]


def _launch(argv, tmp_path):
    """``argv`` on two launcher ranks; what each rank's Trainer held."""
    R.run(W.run_cli_rank, 2, tmp_path, "cli", JOIN_S, args=(str(tmp_path), argv))
    return [torch.load(tmp_path / f"cli_{r}.pt", weights_only=False) for r in range(2)]


def test_launcher_ranks_agree(config_json, tmp_path):
    r0, r1 = _launch(_argv(config_json, tmp_path / "run"), tmp_path)
    assert r0["results"]["epochs"] == 2 and np.isfinite(r0["results"]["summary"]["last_D_loss"])
    for a, b in zip(r0["masks"], r1["masks"]):
        np.testing.assert_array_equal(a, b)
    assert len(r0["keep"]) == 2
    for a, b in zip(r0["keep"], r1["keep"]):
        assert torch.equal(a, b)
    assert not r0["keep"][1].all()  # the gate was on in epoch 1
    for a, b in zip(r0["losses"], r1["losses"]):
        np.testing.assert_array_equal(a, b)
    assert r0["errD"] == r1["errD"]
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k
    with open(tmp_path / "run" / "metrics.json") as f:
        assert json.load(f)["summary"] == r0["results"]["summary"]
    assert (tmp_path / "run" / "samples.png").exists()


def test_spawned_ranks(config_json, tmp_path):
    results = cli.run(_argv(config_json, tmp_path / "spawned", epochs="1"))[1]
    assert results["epochs"] == 1 and np.isfinite(results["summary"]["last_G_loss"])
    with open(tmp_path / "spawned" / "metrics.json") as f:
        assert json.load(f) == results
