"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports neither JAX nor the JAX package, so it runs where only PyTorch and
the CUDA toolkit are installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest``: ``tests/conftest.py`` sets up JAX, which this file
does not need.)

Without a GPU every test here skips (the kernels have no CPU mode).
Tolerances are ``chip_smoke.py``'s: K1 |diff| <= 2e-6 max(1, |ref|), K2
|diff| <= 1e-5 max(1, |ref|).
"""
import numpy as np
import pytest
import torch

from strainer_gan_tpu_torch import kernels as K
from strainer_gan_tpu_torch.kernels import bce as KB
from strainer_gan_tpu_torch.kernels import zscore as KZ
from strainer_gan_tpu_torch.strain import thresholds as TH


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_bce_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(5000) * 8, rng.uniform(-110, 110, 2000),
                        [100.0, -100.0, 87.3, -87.3, -88.0, 30.0, -30.0, 0.0]])
    x = torch.from_numpy(x.astype(np.float32)).to(cuda_device)
    before = KB.bce_scores.launches
    for t in (1.0, 0.0, 0.9):
        got, ref = KB.bce_scores(x, t), KB.bce_scores_plain(x, t)
        assert torch.all((got - ref).abs() <= 2e-6 * ref.abs().clamp_min(1.0))
    assert KB.bce_scores.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("std_mode", ["torch", "numpy_eps"])
def test_zscore_kernels_match_plain(cuda_device, std_mode):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    f = torch.randn((5000, 512), generator=g, device=cuda_device) * 2.0 + 0.5
    f[:, 3] = 1.25  # zero std: z = 0
    valid = torch.rand(5000, generator=g, device=cuda_device) > 0.1
    for v in (None, valid):
        mean, std = KZ.column_stats(f, v, std_mode)
        mean_p, std_p = KZ.column_stats_plain(f, v, std_mode)
        for got, ref in ((mean, mean_p), (std, std_p)):
            assert torch.all((got - ref).abs() <= 1e-5 * ref.abs().clamp_min(1.0))
        z = KZ.row_max_abs_z(f, mean, std)
        assert torch.equal(z, KZ.row_max_abs_z_plain(f, mean, std))
        ref = TH._masked_max_abs_z(f, v, std_mode)
        got = KZ.masked_max_abs_z(f, v, std_mode)
        assert torch.all((got - ref).abs() <= 1e-5 * ref.abs().clamp_min(1.0))
    assert set(K.launch_counts()) == {"bce_scores", "zscore_column_stats", "zscore_row_max"}
