"""Nothing of JAX, nor the JAX package that the port was made from, may be
loaded in a run.  Names are compared by the module's top-level name (the
part before the first dot) as a whole word: ``strainer_gan_tpu_torch``
begins with ``strainer_gan_tpu`` and is allowed."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "strainer_gan_tpu")


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The top-level names among ``names`` (``sys.modules`` by default)
    that are forbidden, sorted."""
    names = sys.modules.keys() if names is None else names
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(t for t in tops if t in FORBIDDEN)
