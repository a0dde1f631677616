"""ObjectRef — a future handle to a value in the object store.

Reference parity: python/ray/_raylet.pyx ObjectRef + ownership semantics from
src/ray/core_worker/reference_count.h:73. Ownership here is simplified: the
head process (driver) is the owner of all object metadata (the directory in
core/runtime.py); the payload lives in the node-shared memory store. Lineage
(the producing TaskSpec) is kept by the head until the object is pinned or
freed, enabling reconstruction after eviction — the analog of
object_recovery_manager.h:43.

Reference counting (reference_count.h:73 analog, head-centric): every live
ObjectRef registers interest with its process runtime (__init__/__del__);
pickling a ref places a transfer pin (`ref_serialized`) that the receiving
process's deserialization releases, so an object can never be freed while a
copy of its ref is on the wire. When the head sees no interested process,
no transfer pins and no pending producer, it frees the payload, spill file
and directory entry (the fix for unbounded driver memory).
"""
from __future__ import annotations

import threading
from typing import Any

from .ids import ObjectID

_pending_runtime = None

# When serializing a value INTO the object store, inner refs must outlive
# the transfer: they become containment edges (the outer object holds
# interest in the inner) instead of one-shot transfer pins. put paths
# activate this via capture_serialized_refs().
_capture = threading.local()


class capture_serialized_refs:
    """Context manager collecting ObjectIDs pickled within; while active,
    __reduce__ records the id here instead of taking a transfer pin."""

    def __enter__(self):
        self.ids: list[ObjectID] = []
        stack = getattr(_capture, "stack", None)
        if stack is None:
            stack = _capture.stack = []
        stack.append(self.ids)
        return self.ids

    def __exit__(self, *exc_info):
        _capture.stack.pop()
        return False


def _capture_target():
    stack = getattr(_capture, "stack", None)
    return stack[-1] if stack else None


# Deserializing FROM the store (or a spill file): inner refs there are
# containment-protected, so they must register plain interest WITHOUT
# consuming a transfer pin — a stored copy's deserialize must never steal
# the pin of an unrelated in-flight message transfer.
class loading_stored_refs:
    def __enter__(self):
        _capture.loading = getattr(_capture, "loading", 0) + 1

    def __exit__(self, *exc_info):
        _capture.loading -= 1
        return False


def _loading_stored() -> bool:
    return getattr(_capture, "loading", 0) > 0


def _get_runtime():
    from . import runtime as rt
    r = rt.get_runtime_if_exists()
    if r is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return r


def _tracking_runtime():
    from . import runtime as rt
    return rt.get_runtime_if_exists()


class ObjectRef:
    __slots__ = ("_id", "_tracked", "__weakref__")

    def __init__(self, oid: ObjectID, _transfer: bool = False):
        self._id = oid
        self._tracked = False
        rt = _tracking_runtime()
        if rt is not None:
            try:
                rt.ref_created(oid, _transfer)
                self._tracked = True
            except Exception:
                pass  # runtime torn down mid-construct; ref untracked

    def __del__(self):
        if getattr(self, "_tracked", False):
            try:
                rt = _tracking_runtime()
                if rt is not None:
                    rt.ref_deleted(self._id)
            except Exception:
                pass  # interpreter shutdown / runtime gone

    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __hash__(self):
        return hash(self._id)

    def __repr__(self):
        return f"ObjectRef({self.hex()[:16]})"

    def __reduce__(self):
        cap = _capture_target()
        if cap is not None:
            cap.append(self._id)
        else:
            rt = _tracking_runtime()
            if rt is not None:
                try:
                    rt.ref_serialized(self._id)
                except Exception:
                    pass  # runtime gone: pickling for a dead cluster
        return (_deserialize_ref, (self._id.binary(),))

    # Allow `await ref` inside async actors. One shared wait_sealed
    # multiplexer thread resolves every awaited ref (core/completion.py)
    # — no per-ref executor hop, and await latency stays flat as the
    # in-flight count grows. get_running_loop (not the deprecated
    # get_event_loop) so awaiting never mis-binds a foreign loop.
    def __await__(self):
        import asyncio

        from .completion import async_future
        loop = asyncio.get_running_loop()
        return async_future(self, loop).__await__()

    def future(self):
        from .completion import sync_future
        return sync_future(self)


def _deserialize_ref(binary: bytes) -> ObjectRef:
    return ObjectRef(ObjectID(binary), _transfer=not _loading_stored())
