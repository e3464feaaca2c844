"""The whole-name check for JAX and the JAX package, and the run's refusal
without a card."""
import os
import subprocess
import sys

import pytest
import torch

from portbench.core import guard, spec


def test_port_passes():
    assert guard.forbidden_loaded(["strainer_gan_tpu_torch", "strainer_gan_tpu_torch.train.loop",
                                   "torch", "jaxtyping", "portbench.core"]) == []


@pytest.mark.parametrize("name,top", [("strainer_gan_tpu", "strainer_gan_tpu"),
                                      ("strainer_gan_tpu.config", "strainer_gan_tpu"),
                                      ("jax", "jax"), ("jax.numpy", "jax"),
                                      ("jaxlib.xla_client", "jaxlib"), ("flax.linen", "flax")])
def test_forbidden_fail(name, top):
    assert guard.forbidden_loaded(["torch", name]) == [top]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "final.prefilter",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 3
    assert out.stdout.strip() == ""
