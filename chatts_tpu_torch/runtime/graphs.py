"""CUDA graph capture of the engines' device loops.

The reference compiles each hot loop once per shape (a ``lax.scan`` of the
step) and runs it on the device as one program.  The port captures one step
in a CUDA graph over tensors that never move, and a loop replays it once a
step: a replay is one launch where the eager step is a few thousand.  Every
capture first runs the step once eagerly, so that each kernel is built and
loaded and the allocator is warm.  A capture that fails raises.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch


def capture(warmup: Callable[[], object], step: Callable[[], object],
            generator: torch.Generator, pool=None) -> Tuple["torch.cuda.CUDAGraph", int]:
    """Run ``warmup()`` eagerly, then capture ``step()`` in a graph that draws
    from ``generator`` (a replay advances it as the eager step would), in
    the memory pool ``pool`` (``torch.cuda.graph_pool_handle()``, shared by
    graphs that never run at once) or a pool of its own.  Returns the graph
    and the growth of the memory the allocator reserves across the capture,
    the pool's growth in bytes."""
    dev = generator.device
    warmup()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(dev)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        step()
    torch.cuda.synchronize(dev)
    return graph, torch.cuda.memory_reserved(dev) - before
