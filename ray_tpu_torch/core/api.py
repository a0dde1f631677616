"""Public core API: init/shutdown/remote/get/put/wait/kill/cancel/...

A copy of ``ray_tpu/core/api.py`` for the PyTorch port: ``num_gpus`` (env
``RTPU_NUM_GPUS``) takes the place of the reference's ``num_tpus``.

Reference parity: python/ray/_private/worker.py (init :1336, get :2749,
put :2885, wait :2950) and the @ray.remote decorator.
"""
from __future__ import annotations

import inspect
import os
from typing import Any, Iterable, Optional

from .. import exceptions as exc
from .actor import ActorClass, ActorHandle
from .ids import ActorID, NodeID
from .ref import ObjectRef
from .remote_function import RemoteFunction
from . import runtime as rt_mod
from .runtime import LocalModeRuntime, Runtime


def init(address: Optional[str] = None,
         num_cpus: Optional[float] = None,
         num_gpus: Optional[float] = None,
         resources: Optional[dict[str, float]] = None,
         object_store_memory: Optional[int] = None,
         local_mode: bool = False,
         labels: Optional[dict[str, str]] = None,
         ignore_reinit_error: bool = False,
         log_to_driver: bool = True,
         namespace: Optional[str] = None,
         resume_from: Optional[str] = None,
         **_compat) -> dict:
    """Start the head runtime in this process, or — with ``address`` — attach
    to a running cluster as a driver client.

    Reference: ray.init (python/ray/_private/worker.py:1336). `num_gpus`
    declares how many GPUs this host exposes as schedulable "GPU"
    resources (indices 0..n-1, leased to worker processes through
    CUDA_VISIBLE_DEVICES); None reads ``RTPU_NUM_GPUS`` (default 0). The
    head never touches CUDA: it counts indices, it does not probe them.

    ``address``: "auto" resolves the newest local cluster of this
    package (or ``$RTPU_ADDRESS``, which job drivers inherit); otherwise a
    path to a session's ``cluster.json``. None starts a new in-process
    head — unless ``RTPU_ADDRESS`` is set (so a submitted job's plain
    ``init()`` joins its cluster), matching the reference's env-driven
    auto-connect. A cluster file that a ``ray_tpu`` head wrote is refused
    with ConnectionError (core/client.py).

    ``enable_remote_nodes=True`` binds the head's TCP listener and data
    server on every interface, so node agents on other hosts can join
    (``head_address()``); by default both face loopback only.
    """
    if rt_mod.get_runtime_if_exists() is not None:
        if ignore_reinit_error:
            return {"already_initialized": True}
        raise RuntimeError("ray_tpu_torch.init() called twice "
                           "(pass ignore_reinit_error=True to allow)")
    if address is None and os.environ.get("RTPU_ADDRESS") and not local_mode:
        address = "auto"
    if address is not None and address != "local":
        from .client import connect
        return connect(address, namespace=namespace)
    if local_mode:
        rt = LocalModeRuntime()
        rt_mod.set_runtime(rt)
        return {"local_mode": True}
    if num_cpus is None:
        num_cpus = float(os.cpu_count() or 1)
    if num_gpus is None:
        num_gpus = float(os.environ.get("RTPU_NUM_GPUS", 0))
    res = {"CPU": float(num_cpus), **(resources or {})}
    if num_gpus:
        if float(num_gpus) != int(num_gpus):
            raise ValueError(f"num_gpus must be a whole number of "
                             f"devices, got {num_gpus}")
        res["GPU"] = float(num_gpus)
    # named-actor scoping (core/actor.py qualify_actor_name); set BEFORE
    # Runtime() so prestarted workers inherit it and in-task get_actor
    # resolves in the job's namespace
    os.environ["RTPU_NAMESPACE"] = namespace or "default"
    rt = Runtime(res,
                 object_store_memory=object_store_memory or None,
                 head_labels=labels,
                 enable_remote_nodes=bool(
                     _compat.get("enable_remote_nodes", False)),
                 log_to_driver=log_to_driver)
    rt.namespace = namespace or "default"
    rt_mod.set_runtime(rt)
    out = {"node_id": rt.head_node.node_id.hex(),
           "session_dir": rt.session_dir}
    if resume_from:
        # GCS-fault-tolerance analog: resurrect durable state (named
        # actors, placement groups, job table) from a previous session's
        # snapshot (core/gcs_store.py restore)
        from .gcs_store import restore
        rt.resumed_from = os.path.abspath(resume_from)
        out["restored"] = restore(rt, resume_from)
    return out


def is_initialized() -> bool:
    return rt_mod.get_runtime_if_exists() is not None


def shutdown() -> None:
    rt = rt_mod.get_runtime_if_exists()
    if rt is not None:
        rt.shutdown()


def _runtime():
    rt = rt_mod.get_runtime_if_exists()
    if rt is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return rt


def remote(*args, **kwargs):
    """@ray_tpu_torch.remote decorator for functions and classes."""
    if len(args) == 1 and not kwargs and (
            inspect.isfunction(args[0]) or inspect.isclass(args[0])):
        target = args[0]
        return (ActorClass(target, {}) if inspect.isclass(target)
                else RemoteFunction(target, {}))
    if args:
        raise TypeError("@remote only takes keyword options")

    def deco(target):
        return (ActorClass(target, kwargs) if inspect.isclass(target)
                else RemoteFunction(target, kwargs))
    return deco


def get(refs, *, timeout: Optional[float] = None):
    if isinstance(refs, ObjectRef):
        return _runtime().get(refs, timeout=timeout)
    try:
        refs = list(refs)
    except TypeError:
        raise TypeError(
            f"ray_tpu_torch.get takes an ObjectRef or a list of ObjectRefs, "
            f"got {type(refs).__name__}") from None
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"ray_tpu_torch.get takes ObjectRefs, got {type(r)}")
    return _runtime().get(refs, timeout=timeout)


def put(value: Any) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("calling put on an ObjectRef is not allowed")
    return _runtime().put(value)


def wait(refs: Iterable[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    refs = list(refs)
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"ray_tpu_torch.wait takes ObjectRefs, got {type(r)}")
    return _runtime().wait(refs, num_returns=num_returns, timeout=timeout,
                           fetch_local=fetch_local)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    if not isinstance(actor, ActorHandle):
        raise TypeError("ray_tpu_torch.kill takes an actor handle")
    _runtime().kill_actor(actor._actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False,
           recursive: bool = True) -> None:
    _runtime().cancel(ref, force=force, recursive=recursive)


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    """Look up a named actor, scoped to `namespace` (default: the
    calling driver/job's namespace — reference: ray.get_actor)."""
    from .actor import qualify_actor_name
    rt = _runtime()
    spec = rt.get_actor_by_name(qualify_actor_name(name, namespace, rt))
    return ActorHandle(spec.actor_id, spec.name, [], spec.max_task_retries,
                       spec.ready_oid)


def nodes() -> list[dict]:
    return _runtime().node_table()


def cluster_resources() -> dict[str, float]:
    return _runtime().cluster_resources()


def available_resources() -> dict[str, float]:
    return _runtime().available_resources()


def timeline(filename: Optional[str] = None):
    """Chrome-trace task timeline (reference: ray.timeline,
    _private/state.py:439)."""
    events = _runtime().timeline()
    if filename:
        import json
        with open(filename, "w") as f:
            json.dump(events, f)
        return None
    return events


# --------------------------------------------------------------------- #
# internal KV (reference: ray.experimental.internal_kv over
# gcs_kv_manager.h) — durable, cluster-visible small metadata
# --------------------------------------------------------------------- #

def _kv_call(method: str, *args):
    from .runtime import Runtime
    rt = _runtime()
    if isinstance(rt, Runtime):
        return getattr(rt, method)(*args)
    if hasattr(rt, "_rpc"):
        return rt._rpc(method, *args)
    raise RuntimeError("internal KV is not available in local_mode")


def kv_put(key: str, value: bytes) -> None:
    if isinstance(value, str):
        value = value.encode()
    _kv_call("kv_put", key, bytes(value))


def kv_get(key: str) -> Optional[bytes]:
    return _kv_call("kv_get", key)


def kv_del(key: str) -> bool:
    return _kv_call("kv_del", key)


def kv_keys() -> list[str]:
    return _kv_call("kv_keys")


class RuntimeContext:
    """Reference: python/ray/runtime_context.py."""

    def __init__(self, rt):
        self._rt = rt

    def get_job_id(self) -> str:
        return self._rt.job_id.hex() if hasattr(self._rt, "job_id") else ""

    def get_worker_id(self) -> str:
        return getattr(self._rt, "wid", "driver")

    def get_node_id(self) -> str:
        if isinstance(self._rt, Runtime):
            return self._rt.head_node.node_id.hex()
        return os.environ.get("RTPU_NODE_ID", "local")

    def get_task_name(self) -> str:
        return getattr(self._rt, "current_task_name", "")

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return False


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(_runtime())


def head_address() -> dict:
    """Connection info for joining this cluster from another host:
    `python -m ray_tpu_torch.core.node_agent --head <address>` with
    ``RTPU_AUTHKEY=<authkey>`` in its environment (reference analog: the
    bootstrap address `ray start --address=` dials)."""
    rt = _runtime()
    if not isinstance(rt, Runtime):
        raise RuntimeError("head_address() only works on the head runtime")
    return {"address": rt.head_address, "authkey": rt._authkey.hex()}
