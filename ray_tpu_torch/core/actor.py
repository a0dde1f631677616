"""Actor API: @ray_tpu_torch.remote classes, handles, and method submission.

Reference parity: python/ray/actor.py (ActorClass ~:1100, method submission
:1729) with the GCS-side lifecycle living in core/runtime.py. Handles are
picklable and can be passed to tasks/other actors; calls route through the
head for ordering (reference analog: ActorTaskSubmitter sequence numbers,
transport/actor_task_submitter.h:49).
"""
from __future__ import annotations

import hashlib
from typing import Any

import cloudpickle

from .ids import ActorID, ObjectID, TaskID
from .ref import ObjectRef
from .remote_function import (_trace_ctx, prepare_args,
                              prepare_runtime_env, resolve_strategy)
from .task_spec import ActorSpec, TaskSpec, validate_resources

_DEFAULT_ACTOR_OPTS = dict(
    num_cpus=0.0, num_gpus=0.0, resources=None, name=None, namespace=None,
    max_restarts=0, max_task_retries=0, max_concurrency=1,
    max_pending_calls=-1,
    lifetime=None, scheduling_strategy="DEFAULT", placement_group=None,
    placement_group_bundle_index=-1, _node_id=None, _node_soft=False,
    runtime_env=None, concurrency_groups=None, label_selector=None,
)


def split_actor_name(qualified):
    """Inverse of qualify_actor_name for display surfaces: ``"ns/name"``
    -> (ns, name); system (``rtpu:``) and unqualified names -> ("", name)
    (reference: `ray list actors` shows name and ray_namespace as
    separate columns)."""
    if not qualified:
        return "", ""
    if qualified.startswith("rtpu:") or "/" not in qualified:
        return "", qualified
    ns, _, short = qualified.partition("/")
    return ns, short


def qualify_actor_name(name, namespace, rt):
    """Scope a user-visible actor name to a namespace (reference:
    ray.init(namespace=)/get_actor(namespace=) isolation of named actors).
    Delta from the reference, by design: the cluster-wide default
    namespace is the shared ``"default"`` (not a per-driver anonymous
    UUID) — a single-job TPU cluster wants its drivers to see each
    other's named actors unless told otherwise. ``rtpu:``-prefixed system
    actors (serve controller, proxies) stay cluster-global, the analog of
    the reference's reserved SERVE_NAMESPACE."""
    if name is None:
        return None
    if name.startswith("rtpu:"):
        return name
    ns = namespace or getattr(rt, "namespace", None) or "default"
    return f"{ns}/{name}"


def _runtime():
    from . import runtime as rt
    r = rt.get_runtime_if_exists()
    if r is None:
        raise RuntimeError("ray_tpu_torch.init() must be called first")
    return r


class ActorClass:
    def __init__(self, cls, opts: dict):
        self._cls = cls
        self._opts = {**_DEFAULT_ACTOR_OPTS, **opts}
        self._blob: bytes | None = None
        self._cid: str | None = None
        self.__name__ = getattr(cls, "__name__", "Actor")

    def options(self, **kwargs) -> "ActorClass":
        bad = set(kwargs) - set(_DEFAULT_ACTOR_OPTS)
        if bad:
            raise ValueError(f"unknown actor options: {sorted(bad)}")
        ac = ActorClass(self._cls, {**self._opts, **kwargs})
        ac._blob, ac._cid = self._blob, self._cid
        return ac

    def remote(self, *args, **kwargs) -> "ActorHandle":
        rt = _runtime()
        if self._blob is None:
            self._blob = cloudpickle.dumps(self._cls)
            self._cid = "cls_" + hashlib.sha1(self._blob).hexdigest()[:16]
        rt.register_function(self._cid, self._blob)
        o = self._opts
        blob, deps = prepare_args(rt, args, kwargs)
        res = validate_resources({
            "CPU": o["num_cpus"], "GPU": o["num_gpus"],
            **(o["resources"] or {})})
        strat = resolve_strategy(o)
        aid = ActorID.from_random()
        ready_oid = ObjectID.from_random()
        spec = ActorSpec(
            actor_id=aid,
            class_id=self._cid,
            name=o["name"] or self.__name__,
            args_blob=blob,
            dep_oids=deps,
            resources=res,
            max_restarts=o["max_restarts"],
            max_task_retries=o["max_task_retries"],
            max_concurrency=o["max_concurrency"],
            pg_id=strat["pg_id"],
            pg_bundle_index=strat["pg_bundle_index"],
            node_affinity=strat["node_affinity"],
            node_affinity_soft=strat["node_affinity_soft"],
            label_selector=(dict(o["label_selector"])
                            if o["label_selector"] else None),
            named=qualify_actor_name(o["name"], o["namespace"], rt),
            namespace=(o["namespace"]
                       or getattr(rt, "namespace", None)),
            ready_oid=ready_oid,
            runtime_env=prepare_runtime_env(rt, o["runtime_env"]),
            concurrency_groups=o["concurrency_groups"],
        )
        rt.create_actor(spec)
        methods = sorted(
            m for m in dir(self._cls)
            if callable(getattr(self._cls, m, None)) and not m.startswith("__"))
        return ActorHandle(aid, self.__name__, methods,
                           o["max_task_retries"], ready_oid,
                           o["max_pending_calls"])

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self.__name__} cannot be instantiated directly; "
            f"use {self.__name__}.remote()")


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, num_returns: int = 1,
                 concurrency_group=None):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def options(self, num_returns: int = 1, concurrency_group=None,
                **_ignored) -> "ActorMethod":
        if num_returns == "dynamic":
            raise ValueError(
                "num_returns='dynamic' is supported for TASKS only; have "
                "the actor method return a list and iterate it, or spawn "
                "a task for generator semantics")
        return ActorMethod(self._handle, self._name, num_returns,
                           concurrency_group)

    def remote(self, *args, **kwargs):
        rt = _runtime()
        h = self._handle
        h._admit_pending(rt)  # max_pending_calls backpressure
        blob, deps = prepare_args(rt, args, kwargs)
        nret = self._num_returns
        spec = TaskSpec(
            task_id=TaskID.from_random(),
            func_id="",
            name=f"{h._class_name}.{self._name}",
            args_blob=blob,
            dep_oids=deps,
            return_ids=[ObjectID.from_random() for _ in range(nret)],
            resources={},
            retries_left=max(0, h._max_task_retries),
            actor_id=h._actor_id,
            method_name=self._name,
            concurrency_group=self._concurrency_group,
            trace_ctx=_trace_ctx(),
            namespace=getattr(rt, "namespace", None),
        )
        refs = rt.submit_actor_task_spec(spec)
        h._track_pending(refs)
        if nret == 0:
            return None
        return refs[0] if nret == 1 else refs


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str,
                 methods: list[str], max_task_retries: int,
                 ready_oid: ObjectID | None = None,
                 max_pending_calls: int = -1):
        self._actor_id = actor_id
        self._class_name = class_name
        self._methods = methods
        self._max_task_retries = max_task_retries
        self._ready_oid = ready_oid
        self._max_pending_calls = max_pending_calls
        self._pending: list[ObjectRef] = []  # see _admit_pending
        # created eagerly: unpickling rebuilds the handle via __reduce__ →
        # __init__, and lazy creation would race two first .remote()s
        import threading as _t
        self._pending_lock = _t.Lock()

    def _admit_pending(self, rt):
        """Client-side backpressure (reference: ActorTaskSubmitter's
        max_pending_calls check raising PendingCallsLimitExceeded).
        A call counts as pending until its first return lands in the
        store; pruning happens on the submit path, so an idle handle
        holds only ids, no threads."""
        mp = self._max_pending_calls
        if mp is None or mp <= 0:
            return
        store = getattr(rt, "store", None)
        with self._pending_lock:
            # _pending holds STRONG ObjectRefs: the held interest keeps a
            # completed-and-consumed result from being freed before this
            # prune can observe it (a freed oid is indistinguishable from
            # a still-running call). Lifetime cost: at most mp results
            # outlive their consumers until the next submit prunes them.
            if store is not None:
                self._pending = [r for r in self._pending
                                 if not store.contains(r.id())]
            else:  # local mode executes inline; nothing can be pending
                self._pending = []
            if len(self._pending) >= mp:
                # the local store can miss settled results (remote-node
                # stores, FAILED-without-result crashes); before
                # refusing, ask the head which pending results settled —
                # ONE batched round-trip (or direct call on the head
                # driver), on the saturated path only
                try:
                    obs = [r.id().binary() for r in self._pending]
                    if hasattr(rt, "locate_many"):   # in-process head
                        done = rt.locate_many(obs)
                    elif hasattr(rt, "_rpc"):
                        done = rt._rpc("locate_many", obs, timeout=10.0)
                    else:
                        done = [False] * len(obs)
                    self._pending = [r for r, d in
                                     zip(self._pending, done) if not d]
                except Exception:
                    pass  # head unreachable: keep the conservative view
            if len(self._pending) >= mp:
                from .. import exceptions as exc
                raise exc.PendingCallsLimitExceeded(
                    f"{self._class_name} handle has {len(self._pending)} "
                    f"calls in flight (max_pending_calls={mp})")

    def _track_pending(self, refs):
        if (self._max_pending_calls or 0) > 0 and refs:
            with self._pending_lock:
                self._pending.append(refs[0])

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        if self._methods and name not in self._methods:
            raise AttributeError(
                f"actor {self._class_name} has no method {name!r}")
        return ActorMethod(self, name)

    def __ray_ready__(self) -> ObjectRef:
        """Ref that resolves when the actor's __init__ finished."""
        return ObjectRef(self._ready_oid)

    def _exec(self, fn, *args) -> ObjectRef:
        """Run ``fn(actor_instance, *args)`` inside the actor's process
        (internal; reference analog: __ray_call__). Used by compiled DAGs
        to install their execution loops."""
        import cloudpickle as _cp
        method = ActorMethod(self, "__rtpu_exec__")
        return method.remote(_cp.dumps(fn), *args)

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __reduce__(self):
        # pending-call tracking is per-handle-copy, like the reference's
        # per-caller submit queues
        return (ActorHandle, (self._actor_id, self._class_name,
                              self._methods, self._max_task_retries,
                              self._ready_oid, self._max_pending_calls))
