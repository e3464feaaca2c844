"""The strainers' decisions across two ranks on the CPU (gloo, launcher
ranks spawned through tests/test_torch_dp_cli.py's ``_launch``).

Narrow configs (ngf = ndf = 8, batch 16, ``--max-synth 48``) through the
command line with ``--dp 2``: ``final`` (4 epochs: the prefilter, then the
epoch-3 loss strain by the band path, whose scoring and re-scoring passes
are sharded by rows), ``loss_gmm`` (a GMM fitted on rank 0 and broadcast,
every epoch) and ``autoencoder`` (the AE trained on rank 0 at epoch 3 and
broadcast).  Both ranks hold the same masks, the same last strain scores
and D weights (and AE weights), bit for bit; ``final``'s strain removed
samples.
"""
import dataclasses

import numpy as np
import pytest
import torch

from strainer_gan_tpu_torch import get_preset

import test_torch_dp_worker as W
from test_torch_dp_cli import _launch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread here and in the ranks this process spawns."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("preset,epochs", [("final", 4), ("loss_gmm", 2), ("autoencoder", 4)])
def test_launcher_strain_masks_agree(tmp_path, preset, epochs):
    cfg = W.tiny(get_preset(preset))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, epochs=epochs))
    path = tmp_path / f"{preset}.json"
    path.write_text(cfg.to_json())
    r0, r1 = _launch(["--config", str(path), "--device", "cpu", "--max-synth", "48", "--dp",
                      "2"], tmp_path)
    assert len(r0["masks"]) == epochs
    for a, b in zip(r0["masks"], r1["masks"]):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(r0["scores"], r1["scores"])
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k
    if preset == "final":
        assert not r0["masks"][-1].all()  # the epoch-3 strain removed samples
    if preset == "autoencoder":
        assert all(torch.equal(v, r1["ae"][k]) for k, v in r0["ae"].items())
