"""Scheduling strategies.

Reference parity: python/ray/util/scheduling_strategies.py:15,41,135
(PlacementGroupSchedulingStrategy, NodeAffinitySchedulingStrategy, and the
"DEFAULT"/"SPREAD" string strategies).
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: Any
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclasses.dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str          # hex
    soft: bool = False


@dataclasses.dataclass
class NodeLabelSchedulingStrategy:
    hard: dict | None = None
    soft: dict | None = None
