"""Evaluation: FID and the ResNet50 feature distances (counterpart of
`strainer_gan_tpu/eval/`)."""
