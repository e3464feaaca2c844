"""The plain references agree with the port at a small size on the CPU,
and a sound run of each cell comes out correct under the committed
limits."""
import time

import pytest
import torch

from portbench.core import inputs as I
from portbench.reference import dcgan as RD
from portbench.reference import resnet as RR
from portbench.run import run_cell

# (workload, images, batch): enough rows at a small batch for a replayed
# chunk and a remainder in the training cells
SMALL = {"batch_mask.masked_epoch": (700, 16), "final.strain_epoch": (4400, 16),
         "final.prefilter": (600, 16)}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(prev)


def test_resnet18_features_match_the_port():
    from strainer_gan_tpu_torch.models.features import build_feature_fn

    w = I.resnet18_weights(5, "cpu")
    images, _ = I.make_images([{"kind": "faces", "count": 24}, {"kind": "objects", "count": 8}],
                              "shuffled", 64, 5, 6, "cpu")
    x = RR.normalize(images)
    port = build_feature_fn("resnet18", 3, "cpu", state_dict=w)(x)
    ref = RR.features(w, x)
    assert torch.allclose(port, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


def test_dcgan_step_matches_the_port():
    from strainer_gan_tpu_torch.config import get_preset
    from strainer_gan_tpu_torch.models import build_models
    from strainer_gan_tpu_torch.train.state import make_optimizers
    from strainer_gan_tpu_torch.train.steps import step_config_from, train_step

    cfg = get_preset("batch_mask")
    g_w, d_w = I.dcgan_weights({"nz": 100, "ngf": 64, "ndf": 64, "nc": 3}, 3, "cpu")
    gen, disc = build_models(cfg.model)
    for mod, w in ((gen, g_w), (disc, d_w)):
        with torch.no_grad():
            for k, t in mod.state_dict().items():
                t.copy_(w[k])
    opt_g, opt_d = make_optimizers(cfg, gen, disc)
    images, src = I.make_images([{"kind": "faces", "count": 16}], "labeled", 64, 3, 3, "cpu")
    x = RR.normalize(images)
    z = torch.randn((16, 100), generator=torch.Generator().manual_seed(0))
    m = train_step(gen, disc, opt_g, opt_d, x, src, z, 2e-4, 2e-4, step_config_from(cfg),
                   mask_on=True)
    g = {k: v.clone() for k, v in g_w.items()}
    d = {k: v.clone() for k, v in d_w.items()}
    r = RD.train_step(g, d, {}, {}, x, z, lr_g=2e-4, lr_d=2e-4, mask_q=0.1)
    assert torch.equal(m["keep_mask"], r["keep"])
    assert abs(float(m["errD"]) - float(r["errD"])) < 1e-5
    assert abs(float(m["errG"]) - float(r["errG"])) < 1e-5
    # Adam's first step moves an element by about +-lr whatever the size of
    # its gradient: an element whose gradient is nought to rounding may go
    # either way, so the change is compared by its norm, leaf by leaf
    for k, v in disc.state_dict().items():
        if ".running_" in k:
            # the third forward runs through the updated D
            assert torch.allclose(v, d[k], rtol=1e-3, atol=1e-4), k
            continue
        dp, dr = float((v - d_w[k]).norm()), float((d[k] - d_w[k]).norm())
        assert abs(dp - dr) <= 5e-3 * dr, k


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(workload):
    n, bs = SMALL[workload]
    result, rows = run_cell(workload, 20260, 0.5, False, device="cpu",
                            scale=dict(n_images=n, batch_size=bs),
                            setup_clock=time.perf_counter())
    assert result["correct"], rows
    if workload != "final.prefilter":
        # the replayed chunk was judged whole
        assert {"chunk_delta_gap", "chunk_v_gap", "adam_steps_bad"} <= {r[0] for r in rows}
