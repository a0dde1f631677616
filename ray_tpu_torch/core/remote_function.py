"""@ray_tpu_torch.remote functions.

Reference parity: python/ray/remote_function.py:484 (RemoteFunction._remote)
— options handling, lazy pickling of the function, arg inlining vs
put-in-store threshold, and submission through the runtime.
"""
from __future__ import annotations

import hashlib
from typing import Any

import cloudpickle
import numpy as np

from .ids import ObjectID, TaskID
from .ref import ObjectRef
from .task_spec import TaskSpec, validate_resources

# args bigger than this are moved to the object store instead of riding the
# control-plane socket (reference: RayConfig max_direct_call_object_size)
INLINE_ARG_LIMIT = 100_000

_DEFAULT_TASK_OPTS = dict(
    num_cpus=1.0, num_gpus=0.0, resources=None, num_returns=1,
    max_retries=3, retry_exceptions=False, name=None,
    scheduling_strategy="DEFAULT", placement_group=None,
    placement_group_bundle_index=-1, _node_id=None, _node_soft=False,
    runtime_env=None, label_selector=None, max_calls=0,
)


def prepare_runtime_env(rt, renv: dict | None) -> dict | None:
    """Validate + pack a runtime_env option into its wire form, registering
    blobs with the head (zips content-cached, registration idempotent)."""
    if not renv:
        return None
    from . import runtime_env as renv_mod
    prepared = renv_mod.prepare(renv, rt.register_renv)
    return prepared or None


def _trace_ctx():
    """Submitter's trace context for the outgoing spec (None when tracing
    is off — util/tracing.py)."""
    from ..util.tracing import context_for_submit
    return context_for_submit()


def _runtime():
    from . import runtime as rt
    r = rt.get_runtime_if_exists()
    if r is None:
        raise RuntimeError(
            "ray_tpu_torch.init() must be called before using .remote()")
    return r


def prepare_args(rt, args: tuple, kwargs: dict):
    """Replace large array-like and bytes args with store refs; collect
    top-level refs as scheduling dependencies. (A multi-GiB pickled blob,
    such as a trainer's closure over model weights, inline in a spec
    would be written to the worker's socket by the head under its lock.)"""
    def conv(a):
        if isinstance(a, np.ndarray) and a.nbytes > INLINE_ARG_LIMIT:
            return rt.put(a, pin=False)
        if isinstance(a, (bytes, bytearray)) and len(a) > INLINE_ARG_LIMIT:
            return rt.put(a, pin=False)
        return a

    args = tuple(conv(a) for a in args)
    kwargs = {k: conv(v) for k, v in kwargs.items()}
    deps = [a.id() for a in args if isinstance(a, ObjectRef)]
    deps += [v.id() for v in kwargs.values() if isinstance(v, ObjectRef)]
    from .object_store import dumps
    blob = dumps((args, kwargs))
    return blob, deps


def resolve_strategy(opts: dict) -> dict:
    """Translate scheduling_strategy objects into spec fields."""
    from ..util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy, PlacementGroupSchedulingStrategy)
    out = dict(pg_id=None, pg_bundle_index=-1, node_affinity=None,
               node_affinity_soft=False, scheduling_strategy="DEFAULT")
    strat = opts.get("scheduling_strategy")
    if isinstance(strat, PlacementGroupSchedulingStrategy):
        out["pg_id"] = strat.placement_group.id
        out["pg_bundle_index"] = strat.placement_group_bundle_index
    elif isinstance(strat, NodeAffinitySchedulingStrategy):
        out["node_affinity"] = bytes.fromhex(strat.node_id)
        out["node_affinity_soft"] = strat.soft
    elif strat in ("DEFAULT", "SPREAD", None):
        out["scheduling_strategy"] = strat or "DEFAULT"
    else:
        raise ValueError(f"unknown scheduling strategy {strat!r}")
    if opts.get("placement_group") is not None:
        pg = opts["placement_group"]
        out["pg_id"] = pg.id
        out["pg_bundle_index"] = opts.get("placement_group_bundle_index", -1)
    if opts.get("_node_id") is not None:
        out["node_affinity"] = bytes.fromhex(opts["_node_id"])
        out["node_affinity_soft"] = opts.get("_node_soft", False)
    return out


class RemoteFunction:
    def __init__(self, fn, opts: dict):
        self._fn = fn
        self._opts = {**_DEFAULT_TASK_OPTS, **opts}
        self._blob: bytes | None = None
        self._fid: str | None = None
        self.__name__ = getattr(fn, "__name__", "remote_fn")

    def options(self, **kwargs) -> "RemoteFunction":
        bad = set(kwargs) - set(_DEFAULT_TASK_OPTS)
        if bad:
            raise ValueError(f"unknown options: {sorted(bad)}")
        rf = RemoteFunction(self._fn, {**self._opts, **kwargs})
        rf._blob, rf._fid = self._blob, self._fid
        return rf

    def _ensure_registered(self, rt):
        if self._blob is None:
            self._blob = cloudpickle.dumps(self._fn)
            self._fid = hashlib.sha1(self._blob).hexdigest()[:16]
        # once per runtime, not once per call: register_function takes the
        # (contended) runtime lock, which burst submission must not pay
        # per task. Reconnecting drivers re-ship from their own blob table
        # (client.py _fid_blobs), so skipping here stays correct across
        # head restarts; a re-init creates a NEW runtime object. Weakref:
        # this cache must not pin a shut-down runtime (and its store
        # mapping) alive for the life of a module-level @remote function.
        import weakref
        reg = getattr(self, "_reg_rt", None)
        if reg is None or reg() is not rt:
            rt.register_function(self._fid, self._blob)
            try:
                self._reg_rt = weakref.ref(rt)
            except TypeError:
                self._reg_rt = None  # unweakrefable runtime (test double)

    def remote(self, *args, **kwargs) -> Any:
        rt = _runtime()
        self._ensure_registered(rt)
        o = self._opts
        blob, deps = prepare_args(rt, args, kwargs)
        res = validate_resources({
            "CPU": o["num_cpus"], "GPU": o["num_gpus"],
            **(o["resources"] or {})})
        strat = resolve_strategy(o)
        nret = o["num_returns"]
        dynamic = nret == "dynamic"
        if dynamic:
            nret = 1  # one ref resolving to a list of per-item refs
        spec = TaskSpec(
            task_id=TaskID.from_random(),
            func_id=self._fid,
            name=o["name"] or self.__name__,
            args_blob=blob,
            dep_oids=deps,
            return_ids=[ObjectID.from_random() for _ in range(nret)],
            resources=res,
            retries_left=max(0, o["max_retries"]),
            retry_exceptions=bool(o["retry_exceptions"]),
            runtime_env=prepare_runtime_env(rt, o["runtime_env"]),
            dynamic_returns=dynamic,
            trace_ctx=_trace_ctx(),
            label_selector=(dict(o["label_selector"])
                            if o["label_selector"] else None),
            max_calls=max(0, o["max_calls"]),
            namespace=getattr(rt, "namespace", None),
            **strat,
        )
        refs = rt.submit_task(spec)
        if nret == 0:
            return None
        return refs[0] if nret == 1 else refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self.__name__} cannot be called directly; "
            f"use {self.__name__}.remote()")
