"""ray_tpu_torch.util — placement groups, scheduling strategies, metrics,
trace-context propagation and step profiling: the port's copies of the
matching ``ray_tpu.util`` modules.

Reference parity: python/ray/util/ (placement_group.py,
scheduling_strategies.py).
"""
import importlib

from .placement_group import (
    PlacementGroup,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from . import scheduling_strategies

__all__ = [
    "PlacementGroup", "placement_group", "placement_group_table",
    "remove_placement_group", "scheduling_strategies", "tracing",
]


def __getattr__(name):
    # Lazy (PEP 562): keep `import ray_tpu_torch` light for worker startup
    if name == "tracing":
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
