"""Completion multiplexer: ONE wait_sealed thread resolves every awaited
ObjectRef in the process.

The old ``await ref`` path parked one executor thread per awaited ref in
a blocking ``get`` — N in-flight awaits cost N threads, N poll loops and
N GIL contenders, so await latency grew with the in-flight count. Here
every waiter registers its oid with a single daemon thread that parks in
one ``store.wait_sealed`` call over the whole watch set (plus a doorbell
object): a seal wakes it, it deserializes the ready value once and feeds
the waiter's asyncio loop via ``call_soon_threadsafe`` (or resolves a
``concurrent.futures.Future`` for ``ref.future()``). Registration while
the thread is parked rings the doorbell — a 1-byte create+seal whose
seal-sequence bump wakes the wait instantly.

Objects that never seal locally (spilled to disk, produced on another
node, evicted and awaiting lineage re-execution) are handled between
wait slices: a spill hit resolves from disk; anything absent for more
than a beat gets the runtime's recovery machinery nudged
(``_mux_nudge``: head — ensure + schedule; worker — ensure send + pull).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

from .ids import ObjectID
from . import flight

# wait-slice length: only the re-check cadence for spill hits and
# recovery nudges — a seal (or the doorbell) wakes the thread instantly
_SLICE_MS = 200
# how long an oid may sit unsealed before the runtime's recovery
# machinery is nudged, and how often the nudge repeats per oid
_NUDGE_AFTER_S = 0.5

_create_lock = threading.Lock()


def mux_for(rt) -> Optional["CompletionMux"]:
    """The process-wide mux for a runtime (created on first use), or None
    when the runtime has no shm store (local mode)."""
    m = getattr(rt, "_completion_mux", None)
    if m is not None:
        return m
    if getattr(rt, "store", None) is None:
        return None
    with _create_lock:
        m = getattr(rt, "_completion_mux", None)
        if m is None:
            m = CompletionMux(rt)
            rt._completion_mux = m
    return m


class _Watch:
    __slots__ = ("cbs", "since", "last_nudge")

    def __init__(self, cb):
        self.cbs = [cb]
        self.since = time.monotonic()
        self.last_nudge = self.since


class CompletionMux:
    def __init__(self, rt):
        self._rt = rt
        self._store = rt.store
        self._spill = getattr(rt, "spill", None)
        self._lock = threading.Lock()
        self._watch: dict[ObjectID, _Watch] = {}  # guarded by: self._lock
        self._evt = threading.Event()
        self._bell = ObjectID.from_random()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rtpu-completions")
        self._thread.start()

    # -- registration ------------------------------------------------------

    def watch(self, oid: ObjectID, on_ready: Callable[[], None]) -> None:
        """Call `on_ready()` from the mux thread once `oid` is readable
        (sealed in shm or present in spill). Fires immediately via the
        normal loop pass when the object is already there."""
        with self._lock:
            w = self._watch.get(oid)
            if w is not None:
                w.cbs.append(on_ready)
            else:
                self._watch[oid] = _Watch(on_ready)
        self._evt.set()
        self._ring()

    def unwatch(self, oid: ObjectID, on_ready) -> None:
        """Drop one registered callback (a cancelled await); the entry
        dies with its last callback."""
        with self._lock:
            w = self._watch.get(oid)
            if w is None:
                return
            try:
                w.cbs.remove(on_ready)
            except ValueError:
                return  # already fired or never registered
            if not w.cbs:
                self._watch.pop(oid, None)

    def _ring(self) -> None:
        """Wake a parked wait_sealed: create+seal the doorbell object (its
        seal-seq bump is the wakeup; the loop deletes it)."""
        try:
            buf = self._store.create_raw(self._bell, 1)
            buf[0:1] = b"\x01"
            del buf
            self._store.seal(self._bell)
        except FileExistsError:
            pass  # already rung; the loop hasn't consumed it yet
        except Exception:
            # Store closing (loop exiting, nothing to do) — or a failed
            # write/seal, which would strand the bell UNSEALED: every
            # later ring would die on FileExistsError above and the mux
            # loop would never wake again. Drop the half-created bell so
            # the next ring re-creates it.
            try:
                self._store.delete(self._bell)
            except Exception:
                pass  # store really is closing


    # -- the mux thread ----------------------------------------------------

    def _fire(self, oid: ObjectID) -> None:
        with self._lock:
            w = self._watch.pop(oid, None)
        if w is None:
            return
        for cb in w.cbs:
            try:
                cb()
            except Exception:
                import traceback
                traceback.print_exc()  # one bad waiter must not kill the mux

    def _loop(self) -> None:
        while True:
            with self._lock:
                oids = list(self._watch)
            if not oids:
                self._evt.wait()
                self._evt.clear()
                continue
            try:
                flags = self._store.wait_sealed([self._bell] + oids, 1,
                                                _SLICE_MS)
            except Exception:
                return  # store closed: process is tearing down
            if flags[0]:
                try:
                    self._store.delete(self._bell)
                except Exception:
                    return  # store closed mid-delete: tearing down
            now = time.monotonic()
            n_fired = 0
            for oid, sealed in zip(oids, flags[1:]):
                if sealed or (self._spill is not None
                              and self._spill.contains(oid)):
                    n_fired += 1
                    self._fire(oid)
                    continue
                with self._lock:
                    w = self._watch.get(oid)
                    nudge = (w is not None
                             and now - w.since > _NUDGE_AFTER_S
                             and now - w.last_nudge > _NUDGE_AFTER_S)
                    if nudge:
                        w.last_nudge = now
                if nudge:
                    try:
                        self._rt._mux_nudge(oid)
                    except Exception:
                        pass  # recovery is best-effort; the slice retries
            if n_fired:
                flight.evt(flight.MUX_WAKE, n_fired, len(oids))


# -- waiter plumbing (used by ObjectRef.__await__ / .future()) ------------


def _resolve_now(rt, ref) -> tuple[Any, Optional[BaseException]]:
    """Materialize a ready ref in the mux thread (sealed/spilled, so this
    is a non-blocking deserialize; stored task errors surface here)."""
    try:
        return rt.get(ref), None
    except BaseException as e:  # noqa: BLE001 — delivered to the waiter
        return None, e


def async_future(ref, loop):
    """An asyncio future on `loop` resolving to the ref's value via the
    mux (or the legacy one-thread-per-await executor hop when the mux is
    unavailable or cfg.dag_ref_wait_executor forces it)."""
    import asyncio

    from .config import cfg
    from . import runtime as rt_mod
    rt = rt_mod.get_runtime_if_exists()
    mux = None
    if rt is not None and not cfg.dag_ref_wait_executor:
        mux = mux_for(rt)
    if mux is None:
        from .api import get as _get
        return loop.run_in_executor(None, lambda: _get(ref))
    fut = loop.create_future()

    def deliver(val, err):
        if fut.cancelled():
            return
        if err is not None:
            fut.set_exception(err)
        else:
            fut.set_result(val)

    def on_ready():
        val, err = _resolve_now(rt, ref)
        try:
            loop.call_soon_threadsafe(deliver, val, err)
        except RuntimeError:
            pass  # loop closed while we resolved; nobody is listening

    mux.watch(ref.id(), on_ready)
    # a cancelled await must not leave a dead callback watched forever
    fut.add_done_callback(
        lambda f: mux.unwatch(ref.id(), on_ready) if f.cancelled() else None)
    return fut


def sync_future(ref):
    """A concurrent.futures.Future for ref.future(): resolved in the mux
    thread (falls back to a dedicated thread without a store)."""
    import concurrent.futures

    from . import runtime as rt_mod
    rt = rt_mod.get_runtime_if_exists()
    mux = mux_for(rt) if rt is not None else None
    fut: concurrent.futures.Future = concurrent.futures.Future()
    if mux is None:
        from .api import get as _get

        def _resolve():
            try:
                fut.set_result(_get(ref))
            except BaseException as e:  # noqa: BLE001 — handed to waiter
                fut.set_exception(e)

        threading.Thread(target=_resolve, daemon=True).start()
        return fut

    def on_ready():
        val, err = _resolve_now(rt, ref)
        if fut.set_running_or_notify_cancel():
            if err is not None:
                fut.set_exception(err)
            else:
                fut.set_result(val)

    mux.watch(ref.id(), on_ready)
    return fut
