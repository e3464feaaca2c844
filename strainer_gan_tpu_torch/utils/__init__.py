"""Small helpers (counterpart of `strainer_gan_tpu/utils/`)."""
