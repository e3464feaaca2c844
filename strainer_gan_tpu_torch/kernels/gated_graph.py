"""Captured step graphs under CUDA graph IF nodes (``csrc/gated_graph.cu``).

The card's counterpart of the ``lax.cond`` gates in
`strainer_gan_tpu/train/steps.py:476-634` (``make_gated_chunked_train_step``,
``make_gated_tail_step``); no TPU kernel is replaced.  ``GatedGraph`` takes
step graphs captured by PyTorch with ``keep_graph=True`` (never
instantiated themselves) and builds one executable graph that runs step
``j`` only if ``c0 + j < bound``, the predicate computed inside the
graph from two int64 device scalars the caller fills before each launch;
``outer`` adds one IF around the whole chain, so a wholly dead chunk runs
one predicate kernel.  A build or a launch that fails raises.

Built with the other kernels by ``kernels/_build.py``; nothing runs at
import time.  ``GatedGraph.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build


class GatedGraph:
    launches = 0

    def __init__(self, graphs: Sequence["torch.cuda.CUDAGraph"], c0: torch.Tensor,
                 bound: torch.Tensor, outer: bool):
        for name, t in (("c0", c0), ("bound", bound)):
            if not t.is_cuda or t.dtype != torch.int64 or t.dim() != 0:
                raise ValueError(f"{name} must be a 0-d int64 CUDA tensor")
        if not graphs:
            raise ValueError("a gated graph needs at least one step graph")
        self._lib = _build.load_library()
        self.device = c0.get_device()
        # the step graphs own the pool memory their clones in the executable
        # graph use: they live as long as it does
        self._graphs = list(graphs)
        self._buffers = (c0, bound)
        handles = (ctypes.c_void_p * len(graphs))(*[g.raw_cuda_graph() for g in graphs])
        exec_ = ctypes.c_void_p()
        conds = ctypes.c_int()
        rc = self._lib.sg_gated_build(self.device, handles, len(graphs), c0.data_ptr(),
                                      bound.data_ptr(), int(outer), ctypes.byref(exec_),
                                      ctypes.byref(conds))
        if rc != 0:
            raise RuntimeError(f"building the gated CUDA graph failed: cudaError {rc}")
        self._exec = exec_
        self.conditionals = conds.value  # the graph's IF nodes

    def launch(self) -> None:
        """One launch on PyTorch's current stream; returns without waiting."""
        rc = self._lib.sg_graph_launch(self._exec, _build.current_stream(self.device))
        _build.check(rc, "gated graph launch")
        GatedGraph.launches += 1

    def __del__(self):
        # an executable graph still in flight is freed when it completes
        exec_ = getattr(self, "_exec", None)
        if exec_ is not None:
            self._lib.sg_graph_exec_destroy(exec_)
            self._exec = None
