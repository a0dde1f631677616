"""Task and actor specifications exchanged between driver and workers.

Reference parity: TaskSpecification (src/ray/common/task/task_spec.h, built
from common.proto TaskSpec). We use plain dataclasses over the pickle-based
connection transport instead of protobuf — the head process and workers share
a Python version, and the hot path (arg payloads) bypasses these structs via
the shared-memory store.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from .ids import ActorID, ObjectID, PlacementGroupID, TaskID


@dataclasses.dataclass
class TaskSpec:
    task_id: TaskID
    func_id: str                       # registry key (hash of pickled fn)
    name: str                          # human-readable, for errors/events
    args_blob: bytes                   # cloudpickle((args, kwargs)), refs by-ref
    dep_oids: list[ObjectID]           # top-level ObjectRef args to resolve
    return_ids: list[ObjectID]
    resources: dict[str, float]
    retries_left: int = 0
    retry_exceptions: bool = False
    # actor-task fields
    actor_id: Optional[ActorID] = None
    method_name: Optional[str] = None
    seq_no: int = 0                    # per-actor submission order
    # placement
    pg_id: Optional[PlacementGroupID] = None
    pg_bundle_index: int = -1
    node_affinity: Optional[bytes] = None   # NodeID binary, soft=false only
    node_affinity_soft: bool = False
    scheduling_strategy: str = "DEFAULT"    # DEFAULT | SPREAD
    # node label requirements (reference: label_selector on tasks/actors,
    # the node-label scheduling strategy): every (k, v) must equal the
    # candidate node's labels
    label_selector: Optional[dict] = None
    owner: str = "driver"              # "driver" or worker-id hex
    # prepared runtime env (hashes, not blobs — core/runtime_env.py)
    runtime_env: Optional[dict] = None
    # num_returns="dynamic": the single return holds a list of ObjectRefs,
    # one per yielded item (reference: dynamic generators)
    dynamic_returns: bool = False
    # actor concurrency group this call runs in (transport
    # concurrency_group_manager.h analog)
    concurrency_group: Optional[str] = None
    # (trace_id, parent_span_id) — the submitter's span, so the task's
    # execution span parents correctly across processes (reference:
    # tracing_helper.py:293 injects OTel context into task metadata)
    trace_ctx: Optional[tuple] = None
    # worker retires (exits, pool respawns) after executing this function
    # this many times; 0 = unlimited (reference: @ray.remote(max_calls=N),
    # the leaked-state/GPU-memory release valve)
    max_calls: int = 0
    # submitting driver's namespace: in-task get_actor / named-actor
    # creation resolve in it, not in the worker host's default (reference:
    # tasks inherit the job's namespace)
    namespace: Optional[str] = None

    @property
    def is_actor_task(self) -> bool:
        return self.actor_id is not None and self.method_name is not None

    def __reduce__(self):
        # positional-tuple pickling: ~2.3x faster and ~half the bytes of
        # the default dataclass state-dict pickle — specs are the hottest
        # control message (every dispatch + every submit carries one).
        # Field ORDER is the wire format: any field add/remove/reorder
        # must bump protocol.PROTOCOL_VERSION (handshake-enforced).
        return (_rebuild_task_spec,
                (tuple(self.__dict__[f] for f in _TASK_FIELDS),))


@dataclasses.dataclass
class ActorSpec:
    actor_id: ActorID
    class_id: str                      # registry key for the pickled class
    name: str
    args_blob: bytes
    dep_oids: list[ObjectID]
    resources: dict[str, float]
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    pg_id: Optional[PlacementGroupID] = None
    pg_bundle_index: int = -1
    node_affinity: Optional[bytes] = None
    node_affinity_soft: bool = False
    label_selector: Optional[dict] = None
    named: Optional[str] = None        # ray.get_actor() name
    # named method pools: {"io": 2, ...} (concurrency groups)
    concurrency_groups: Optional[dict] = None
    # creation-readiness object: resolves when the actor __init__ finished
    ready_oid: Optional[ObjectID] = None
    runtime_env: Optional[dict] = None
    # creating driver's namespace — the actor's methods resolve named
    # actors in it (reference: an actor belongs to its job's namespace)
    namespace: Optional[str] = None

    def __reduce__(self):
        # see TaskSpec.__reduce__ — same wire-format/versioning contract
        return (_rebuild_actor_spec,
                (tuple(self.__dict__[f] for f in _ACTOR_FIELDS),))


_TASK_FIELDS = tuple(f.name for f in dataclasses.fields(TaskSpec))
_ACTOR_FIELDS = tuple(f.name for f in dataclasses.fields(ActorSpec))


def _rebuild_task_spec(vals):
    s = object.__new__(TaskSpec)
    s.__dict__.update(zip(_TASK_FIELDS, vals))
    return s


def _rebuild_actor_spec(vals):
    s = object.__new__(ActorSpec)
    s.__dict__.update(zip(_ACTOR_FIELDS, vals))
    return s


def validate_resources(res: dict[str, float]) -> dict[str, float]:
    out = {}
    for k, v in res.items():
        if v is None:
            continue
        v = float(v)
        if v < 0:
            raise ValueError(f"resource {k!r} must be >= 0, got {v}")
        if k == "GPU" and v != int(v):
            # a GPU is leased to one worker process as a device index
            # (core/runtime.py): fractional shares are not scheduled
            raise ValueError(f"num_gpus must be a whole number, got {v}")
        if v:
            out[k] = v
    return out
