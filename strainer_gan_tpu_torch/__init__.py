"""PyTorch/CUDA port of ``strainer_gan_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; every module here names
its counterpart there.  This package imports ``torch`` and never JAX, and
nothing of ``strainer_gan_tpu``: the framework-free pieces it needs
(config, synthetic data, synthetic backbone weights) are its own copies.

Entry points (``Trainer``, ``DeviceDataset``, ``build_feature_fn``) run on
``cuda`` unless the caller passes ``device="cpu"``; with no card and no
explicit ``"cpu"`` they raise.  The hand-written CUDA kernels live in
``csrc/`` and are built with ``nvcc`` at first use (``kernels/_build.py``).
"""
from .config import ExperimentConfig, get_preset  # noqa: F401
