"""ray_tpu_torch.util — placement groups, scheduling strategies, actor
pools, distributed queues, metrics, trace-context propagation and step
profiling: the port's copies of the matching ``ray_tpu.util`` modules.

``multiprocessing`` (``Pool``) and ``chaos`` (``WorkerKiller``,
``NodeKiller``) are modules of this package, imported by name. The
reference's ``collective`` and ``tpu`` are not ported yet: collectives
come with the port's collective layer, and the GPU's counterpart of
``tpu`` (slice topology) with the port's accelerator helpers.

Reference parity: python/ray/util/ (placement_group.py,
scheduling_strategies.py, actor_pool.py, queue.py).
"""
import importlib

from .actor_pool import ActorPool
from .placement_group import (
    PlacementGroup,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from . import queue, scheduling_strategies

__all__ = [
    "ActorPool", "PlacementGroup", "placement_group",
    "placement_group_table", "remove_placement_group", "queue",
    "scheduling_strategies", "tracing",
]


def __getattr__(name):
    # Lazy (PEP 562): keep `import ray_tpu_torch` light for worker startup
    if name == "tracing":
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
