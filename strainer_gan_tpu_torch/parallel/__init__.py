"""Data parallelism over torch.distributed ranks (counterpart of
`strainer_gan_tpu/parallel/`): ``multihost`` joins the group, ``mesh`` holds
the step's collectives."""
