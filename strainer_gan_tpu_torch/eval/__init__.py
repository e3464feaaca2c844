"""Evaluation: FID (counterpart of `strainer_gan_tpu/eval/`)."""
