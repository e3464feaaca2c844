"""Time the host staging of a synthetic mixture, on the CPU it runs on.

    JAX_PLATFORMS=cpu python -m tests.staging_profile [n]

Prints, for ``n`` (default 20,000) CelebA-like images at 64x64x3:

* the JAX package's ``_synthetic("faces", n)`` under ``cProfile``, with the
  seconds of its largest parts (the port's generator was a line-for-line
  copy of it before it was chunked);
* the port's ``_synthetic("faces", n)`` (drawn in the reference's order,
  finished in chunks on host threads), and whether its bytes equal the
  reference's;
* ``n`` CIFAR-like images at 32x32 resized to 64 by the port's
  host-staging library (``native``) and the first ``n // 10`` of them by
  its numpy plain version, and whether the two agree byte for byte;
* the port's whole ``zscore_dbscan`` mixture (40,000 images).

Imports the JAX package's data module, which needs no accelerator; not a
test (pytest collects only ``test_*.py``).
"""
import cProfile
import pstats
import sys
import time

import numpy as np

from strainer_gan_tpu.data import datasets as JD

from strainer_gan_tpu_torch import get_preset
from strainer_gan_tpu_torch.data import build_mixture, datasets as PD


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def main(n: int = 20_000) -> None:
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    ref = JD._synthetic("faces", n, 64, 3, 5)
    prof.disable()
    total = time.perf_counter() - t0
    print(f"reference _synthetic('faces', {n}): {total:.2f} s; its largest parts (tottime):")
    stats = pstats.Stats(prof).sort_stats("tottime")
    for (path, line, name), (_, _, tottime, _, _) in sorted(
            stats.stats.items(), key=lambda kv: -kv[1][2])[:5]:
        print(f"  {tottime:7.2f} s  {name} ({path.rsplit('/', 1)[-1]}:{line})")
    got, t = timed(PD._synthetic, "faces", n, 64, 3, 5)
    print(f"port _synthetic('faces', {n}): {t:.2f} s, bytes equal to the reference: "
          f"{np.array_equal(got.images, ref.images)}")

    objects, t = timed(PD._synthetic, "objects", n, 32, 3, 5)
    print(f"port _synthetic('objects', {n}) at 32x32: {t:.2f} s")
    native, t_native = timed(PD.resize_bilinear_u8, objects.images, 64)
    m = n // 10
    plain, t_plain = timed(PD.resize_bilinear_u8_plain, objects.images[:m], 64)
    print(f"resize 32 -> 64: native {t_native:.3f} s for {n}; plain {t_plain:.3f} s for {m}; "
          f"bytes differing on those {m}: {int((native[:m] != plain).sum())}")

    mix, t = timed(build_mixture, get_preset("zscore_dbscan").data)
    print(f"zscore_dbscan mixture ({len(mix)} images): {t:.2f} s")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
