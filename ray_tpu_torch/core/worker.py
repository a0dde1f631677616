"""Worker process: executes tasks and hosts actors.

Reference parity: the worker side of the core worker (reference:
src/ray/core_worker/core_worker.h:166 task-execution loop, the Python hot
loop _raylet.pyx:2103 execute_task_with_cancellation_handler, and the actor
scheduling queues of transport/task_receiver.h:50 +
concurrency_group_manager.h). Differences from the reference, by design:

  - results are written straight into the node-shared mmap store and the head
    is notified with a tiny `done` message — no return-value RPC hop;
  - actor method ordering comes from head routing order + a single executor
    thread (max_concurrency=1), a thread pool for threaded actors, or an
    asyncio loop for async actors;
  - blocked-worker CPU release (`blocked`/`unblocked` messages) mirrors the
    reference's logic that returns a lease's resources while the worker waits
    in `ray.get` (raylet/local_task_manager.h).

Entry point: `python -m ray_tpu_torch.core.worker` with RTPU_* env vars set by
Runtime._spawn_worker_locked.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import ctypes
import os
import sys
import threading
import time
import traceback
from collections import deque
from multiprocessing.connection import Client

import cloudpickle

from .. import exceptions as exc
from .ids import ObjectID
from .protocol import PROTOCOL_VERSION
from .object_store import GetTimeoutError as StoreTimeout
from .object_store import ObjectStoreFullError as StoreFull
from .object_store import SharedObjectStore, SpillStore
from .ref import ObjectRef
from .task_spec import ActorSpec, TaskSpec
from . import flight
from . import stacks
from . import runtime as rt_mod


import contextvars

# active task's namespace (a ContextVar flows into coroutines too, so
# async actor methods resolve names correctly — see _run_actor_task)
_ACTIVE_NS: "contextvars.ContextVar" = contextvars.ContextVar(
    "rtpu_active_namespace", default=None)


class WorkerRuntime:
    """Worker-side implementation of the runtime interface used by the public
    API (`ray_tpu_torch.get/put/wait/...` called *inside* a task or actor)."""

    @property
    def namespace(self) -> str:
        """Namespace named-actor calls resolve in: the namespace of the
        job that submitted the RUNNING task (or created the running
        actor), falling back to the cluster default between tasks
        (reference: tasks/actors inherit their job's namespace)."""
        return _ACTIVE_NS.get() or self._default_ns

    @namespace.setter
    def namespace(self, value: str) -> None:
        # drivers (DriverRuntime) set their own default at connect
        self._default_ns = value

    def __init__(self, store: SharedObjectStore, conn, wid: str,
                 spill=None):
        from .config import cfg
        self.store = store
        self.spill = spill
        self.conn = conn
        self.wid = wid
        self.send_lock = threading.Lock()
        # adaptive flush buffer (protocol v3 batch frames), combining-lock
        # style: an async send appends and then TRY-acquires the
        # connection — uncontended it ships its own message immediately
        # (same cost as an unbuffered send: no extra thread, no wakeup
        # syscall), while under a burst the first sender becomes the
        # shipper and drains everything that accumulates during its pipe
        # writes into batch frames (one pickle + one syscall amortized
        # over N). Wire order is exactly buffer-append order: synchronous
        # send() drains the buffer in-order ahead of its own message, so
        # FIFO invariants (func_def before submit, ref_add before a later
        # drop) hold with batching on or off.
        self._batching = cfg.control_batching
        self._batch_max = max(1, cfg.send_batch_max)
        self._sbuf: list = []  # guarded by: self._sbuf_lock
        self._sbuf_lock = threading.Lock()
        self.func_registry: dict[str, object] = {}
        self._sent_fids: set[str] = set()
        self._sent_renvs: set[str] = set()
        # own-store node: misses pull via object_transfer; RPC replies come
        # over the conn into this dict instead of the (invisible) head store
        self.own_store = os.environ.get("RTPU_OWN_STORE") == "1"
        # fallback namespace when no task is executing (the head's);
        # during execution the SUBMITTING driver's namespace is active
        # (core/actor.py qualify_actor_name reads self.namespace)
        self._default_ns = os.environ.get("RTPU_NAMESPACE", "default")
        self._rpc_replies: dict[bytes, object] = {}
        self._rpc_reply_evt = threading.Event()
        self._rpc_abandoned: set[bytes] = set()
        self._last_fetch: dict = {}
        self._last_fetch_sweep = 0.0
        self.current_task_name = ""
        # process-local ObjectRef counts; 0<->1 transitions notify the head
        # (reference_count.h:73 borrower protocol, simplified)
        self._ref_counts: dict = {}  # guarded by: self._ref_lock
        self._ref_lock = threading.Lock()
        # return-ids of a task being submitted: their first ObjectRef needs
        # no ref_add send — the v2 submit/actor_call message itself carries
        # the submitter's interest (runtime._handle_msg "submit")
        self._presumed: set = set()  # guarded by: self._ref_lock
        # __del__ may fire from a GC pass triggered INSIDE send() or
        # ref_created() on the same thread; doing IPC or taking these locks
        # there would self-deadlock. Drops only enqueue (SimpleQueue.put is
        # reentrant-safe); a dedicated thread drains and notifies.
        import queue
        self._drop_q: "queue.SimpleQueue" = queue.SimpleQueue()
        threading.Thread(target=self._drop_loop, daemon=True,
                         name="ref-drops").start()

    # -- refcounting -------------------------------------------------------

    def ref_created(self, oid, from_transfer: bool):
        # the count transition and its notification must be ATOMIC per oid:
        # a drop-loop 1->0 send racing a fresh 0->1 add could otherwise
        # reach the head in the wrong order and strip live interest.
        # Holding _ref_lock across send() is safe: __del__ never takes
        # these locks (it only enqueues).
        with self._ref_lock:
            c = self._ref_counts.get(oid, 0)
            self._ref_counts[oid] = c + 1
            if c == 0 and not from_transfer and oid in self._presumed:
                self._presumed.discard(oid)
                return  # the submit message registers this interest
            if c == 0 or from_transfer:
                # async: appended under _ref_lock, so ordering against the
                # drop loop's sends (also under _ref_lock) is buffer order
                self.send_async({"t": "ref_add", "oid": oid.binary(),
                                 "transfer": from_transfer})

    def ref_deleted(self, oid):
        self._drop_q.put(oid)

    def _drop_loop(self):
        import queue as _q
        while True:
            oids = [self._drop_q.get()]
            # greedy drain: a GC pass killing a burst of refs becomes ONE
            # batched ref_drops message instead of one write per ref
            try:
                while len(oids) < 4096:
                    oids.append(self._drop_q.get_nowait())
            except _q.Empty:
                pass
            try:
                # compute + send under _ref_lock: a concurrent 0->1
                # ref_add must not land between our 1->0 decision and the
                # drop reaching the wire (same ordering rule as
                # ref_created's send-under-lock)
                with self._ref_lock:
                    dead = []
                    for oid in oids:
                        c = self._ref_counts.get(oid, 0) - 1
                        if c <= 0:
                            self._ref_counts.pop(oid, None)
                            dead.append(oid.binary())
                        else:
                            self._ref_counts[oid] = c
                    if len(dead) == 1:
                        self.send_async({"t": "ref_drop", "oid": dead[0]})
                    elif dead:
                        self.send_async({"t": "ref_drops", "oids": dead})
            except (OSError, EOFError):
                return  # connection gone: worker is exiting
            except Exception:
                # a combining drain can surface ANOTHER thread's poison-
                # message error here; this thread must keep servicing
                # drops or head-side refcounts leak for the process's life
                traceback.print_exc()

    def ref_serialized(self, oid):
        # async is safe: the xfer pin is appended BEFORE the message that
        # carries the serialized ref (same thread), so it reaches the head
        # first and the pin exists before any receiver can deserialize
        self.send_async({"t": "ref_xfer", "oid": oid.binary()})

    # -- messaging ---------------------------------------------------------

    def send(self, msg):
        """Synchronous send: drains the flush buffer in-order ahead of
        `msg` and ships everything as one frame."""
        with self._sbuf_lock:
            self._sbuf.append(msg)
        self._flush_now()

    def send_async(self, msg):
        """Buffered send: `msg` ships with this call when the connection
        is free, or rides the current shipper's next drain round when
        another thread is mid-write. Use for fire-and-forget control
        traffic; anything the caller waits on must go through send()."""
        if not self._batching:
            return self.send(msg)
        with self._sbuf_lock:
            self._sbuf.append(msg)
        self._try_flush()

    def flush(self):
        """Ship everything in the flush buffer now (no-op when empty)."""
        self._flush_now()

    def _try_flush(self):
        # Combining-lock drain. The liveness invariant: whoever sees a
        # non-empty buffer either drains it or observes send_lock held —
        # and every holder re-checks the buffer after releasing, so an
        # append racing a holder's final empty-check is picked up by that
        # holder's re-check (or by our next loop iteration). No message
        # can strand without a live shipper.
        while True:
            if not self.send_lock.acquire(blocking=False):
                return  # current holder's post-release re-check covers us
            try:
                # send_lock IS held here — via the try-acquire above,
                # which the with-block heuristic can't see
                self._drain_locked()  # graftlint: disable=GL001
            finally:
                self.send_lock.release()
            with self._sbuf_lock:
                if not self._sbuf:
                    return

    def _flush_now(self):
        while True:
            with self.send_lock:
                self._drain_locked()
            with self._sbuf_lock:
                if not self._sbuf:
                    return

    def _drain_locked(self):
        # pop + send are atomic under send_lock: a reconnecting driver
        # (client.py) holds send_lock while it replays state, so messages
        # still in the buffer are visible to (and excluded by) the replay
        while True:
            # batching off: one frame per message (the documented
            # debugging mode), still FIFO through the same buffer
            limit = self._batch_max if self._batching else 1
            with self._sbuf_lock:
                if not self._sbuf:
                    return
                if len(self._sbuf) > limit:
                    msgs = self._sbuf[:limit]
                    del self._sbuf[:limit]
                else:
                    msgs, self._sbuf = self._sbuf, []
            try:
                self.conn.send(msgs[0] if len(msgs) == 1
                               else {"t": "batch", "msgs": msgs})
                flight.evt(flight.CTRL_FLUSH, len(msgs))
            except (OSError, EOFError, KeyboardInterrupt, SystemExit):
                # transport failure (or an interrupt that may have landed
                # mid-write): put the unsent messages back at the FRONT,
                # in order — a reconnect replay (driver) or a later retry
                # must see them; re-sending individually here could
                # double-deliver bytes that already hit the wire
                with self._sbuf_lock:
                    self._sbuf[0:0] = msgs
                raise
            except BaseException as frame_err:
                if getattr(self.conn, "closed", False):
                    # e.g. ValueError from a connection torn down mid-send
                    # (a restart racing close): a transport symptom, not a
                    # bad payload — requeue for the ride/replay machinery
                    with self._sbuf_lock:
                        self._sbuf[0:0] = msgs
                    raise
                # deterministic failure (e.g. an unpicklable user payload
                # in a device_* message): Connection.send pickles BEFORE
                # writing, so nothing hit the wire — re-send individually
                # to isolate the poison message instead of requeueing a
                # frame that can never serialize (which would wedge every
                # later done/ref/put behind it forever)
                if len(msgs) == 1:
                    self._poison_dropped(msgs[0], frame_err)
                    raise frame_err
                poison = None
                for k, m in enumerate(msgs):
                    try:
                        self.conn.send(m)
                    except (OSError, EOFError, KeyboardInterrupt,
                            SystemExit):
                        with self._sbuf_lock:
                            self._sbuf[0:0] = msgs[k:]
                        raise
                    except BaseException as e:
                        if getattr(self.conn, "closed", False):
                            with self._sbuf_lock:
                                self._sbuf[0:0] = msgs[k:]
                            raise
                        if poison is None:
                            poison = e
                        traceback.print_exc()
                        self._poison_dropped(m, e)
                if poison is not None:
                    # raised to whichever thread is draining (the sender
                    # itself when uncontended); a submit's refs are made
                    # to error via _poison_dropped either way
                    raise poison

    def _poison_dropped(self, msg, err: BaseException) -> None:
        """A message was dropped because it can never serialize. If it
        was a submit, its return refs would otherwise hang every waiter
        forever (the head never learns of the task — and under combining
        the drop may surface in a DIFFERENT thread than the submitter):
        seal the error into the return oids so ray.get raises it."""
        try:
            if not isinstance(msg, dict) or \
                    msg.get("t") not in ("submit", "actor_call"):
                return
            spec = msg["spec"]
            werr = exc.RayTaskError(
                getattr(spec, "name", "task"),
                err if isinstance(err, Exception) else RuntimeError(
                    repr(err)))
            for oid in getattr(spec, "return_ids", ()):
                try:
                    self.store.put(oid, werr, is_exception=True)
                except Exception:
                    pass  # store full/closing; waiters time out
        except Exception:
            pass  # must never mask the original send error

    def _ship_func(self, fid: str, blob: bytes):
        if fid not in self._sent_fids:
            self.send_async({"t": "func_def", "fid": fid, "blob": blob})
            self._sent_fids.add(fid)

    def register_renv(self, h: str, blob: bytes):
        if h not in self._sent_renvs:
            self.send_async({"t": "renv_def", "hash": h, "blob": blob})
            self._sent_renvs.add(h)

    def register_function(self, fid: str, blob: bytes):
        self.func_registry.setdefault(fid, cloudpickle.loads(blob))
        self._ship_func(fid, blob)

    # -- object API --------------------------------------------------------

    def put(self, value, pin: bool = False):
        return self.put_at(ObjectID.from_random(), value)

    def expect(self, oid):
        """No-op (see Runtime.expect)."""

    def put_at(self, oid: ObjectID, value, is_exception: bool = False):
        self.store_or_spill(oid, value, is_exception, notify_put=True)
        return ObjectRef(oid)

    def store_or_spill(self, oid: ObjectID, value, is_exception: bool,
                       notify_put: bool):
        """Store a value, spilling the same serialized frame to disk when
        the shm store is full; refs pickled inside become containment edges
        on the head."""
        from .ref import capture_serialized_refs
        with capture_serialized_refs() as inner_ids:
            spilled = self.store.put_or_spill(oid, value, is_exception,
                                              self.spill)
        if inner_ids:
            self.send_async({"t": "contained", "oid": oid.binary(),
                             "inner": [i.binary() for i in inner_ids]})
        if spilled:
            self.send_async({"t": "put_spilled", "oid": oid.binary()})
        elif notify_put:
            self.send_async({"t": "put", "oid": oid})

    def get(self, refs, timeout: float | None = None):
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        try:
            if len(ref_list) > 1:
                # bulk fast path: one ensure for every missing ref up
                # front + one event-driven multi-oid wait, instead of a
                # per-ref ensure and a fresh poll slice per ref
                self._wait_all_present([r.id() for r in ref_list], deadline)
            for r in ref_list:
                out.append(self._get_one(r.id(), deadline,
                                         lambda: self._block(True)))
        finally:
            self._block(False)
        return out[0] if single else out

    def _sealed_is_exception(self, oid) -> bool:
        """Peek a sealed object's frame flags without deserializing."""
        view = self.store.get_raw(oid, timeout_ms=0)
        if view is None:
            return False
        try:
            from .object_store import _FLAG_EXCEPTION
            return bool(view[0] & _FLAG_EXCEPTION)
        finally:
            del view
            self.store.release(oid)

    def _spilled_is_exception(self, oid) -> bool:
        """Peek a spilled frame's flags byte (same wire framing)."""
        try:
            from .object_store import _FLAG_EXCEPTION
            with open(self.spill._path(oid), "rb") as f:
                b = f.read(1)
            return bool(b and b[0] & _FLAG_EXCEPTION)
        except OSError:
            return False

    def _present_is_exception(self, oid, sealed: bool) -> bool:
        return (self._sealed_is_exception(oid) if sealed
                else self._spilled_is_exception(oid))

    def _wait_all_present(self, oids, deadline):
        """Wait until every oid that the ordered materialization loop will
        actually reach is sealed in the store (or readable from spill),
        servicing whichever seals first via os_wait_sealed — the
        futex-on-seal notification path. Slices are only the re-check
        cadence for spill/cross-node fetches and grow exponentially; a
        seal wakes the waiter immediately regardless of slice length.
        Sequential-get parity: _get_one raises a stored task error at the
        FIRST errored index once everything before it resolved — so a
        sealed exception at index j stops this wait from blocking on
        anything at or past j (an error ahead of a never-completing ref
        must surface now, not after the hang). Returns on deadline expiry
        and leaves the per-ref timeout error (and value/error
        materialization) to _get_one."""
        flags = self.store.wait_sealed(oids, len(oids), 0)
        missing = [(i, o) for i, (o, f) in enumerate(zip(oids, flags))
                   if not f]
        if self.spill is not None and missing:
            missing = [(i, o) for i, o in missing
                       if not self.spill.contains(o)]
        if not missing:
            return  # all present: no waiting, no exception peeking
        # index of the first already-errored ref (sealed OR spilled
        # exception): only the prefix before it has to resolve before
        # _get_one can raise it in order. Peeked only now that we know
        # we'd otherwise block, and only up to the last missing index
        # (an error past every missing ref doesn't shrink the wait).
        err_before = len(oids)
        miss_idx = {i for i, _ in missing}
        for i in range(missing[-1][0]):
            if i in miss_idx:
                continue
            if self._present_is_exception(oids[i], sealed=flags[i]):
                err_before = i
                break
        missing = [(i, o) for i, o in missing if i < err_before]
        if not missing:
            return
        self._block(True)
        self.send({"t": "ensure",
                   "oids": [o.binary() for _, o in missing]})
        slice_ms = 10
        while True:
            active = [(i, o) for i, o in missing if i < err_before]
            if not active:
                return
            if deadline is not None:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    return
                slice_ms = min(slice_ms, max(1, int(remain * 1000)))
            got = self.store.wait_sealed([o for _, o in active],
                                         len(active), slice_ms)
            still = []
            for (i, o), f in zip(active, got):
                spilled = (not f and self.spill is not None
                           and self.spill.contains(o))
                if f or spilled:
                    if self._present_is_exception(o, sealed=f):
                        err_before = min(err_before, i)
                    continue
                # ANY worker may need a cross-node pull (throttled to one
                # locate per object per second inside _try_fetch)
                self._try_fetch(o)
                still.append((i, o))
            missing = still
            slice_ms = min(slice_ms * 2, 200)

    def _mux_nudge(self, oid: ObjectID):
        """Completion-mux recovery hook (core/completion.py): an awaited
        oid stayed unsealed past the nudge window — ask the head to make
        it available (lineage re-exec of evicted objects) and try a
        cross-node pull (throttled inside _try_fetch)."""
        self.send({"t": "ensure", "oids": [oid.binary()]})
        self._try_fetch(oid)

    _did_block = False

    def _block(self, flag: bool):
        if flag and not self._did_block:
            self._did_block = True
            self.send({"t": "blocked"})
        elif not flag and self._did_block:
            self._did_block = False
            self.send({"t": "unblocked"})

    def _get_one(self, oid: ObjectID, deadline, on_wait):
        first = True
        while True:
            slice_ms = 200
            if deadline is not None:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    raise exc.GetTimeoutError(f"timed out waiting for {oid}")
                slice_ms = max(1, min(slice_ms, int(remain * 1000)))
            try:
                return self.store.get(oid, timeout_ms=slice_ms)
            except StoreTimeout:
                if self.spill is not None and self.spill.contains(oid):
                    try:
                        return self.spill.load(oid)
                    except OSError:
                        pass  # freed between contains and load; keep waiting
                    except exc.RayTaskError as e:
                        raise e.as_instanceof_cause() from e
                if first:
                    flight.evt(flight.OBJ_MISS, flight.lo48(oid))
                    on_wait()
                    self.send({"t": "ensure", "oids": [oid.binary()]})
                    first = False
                # ANY worker may need a cross-node pull (a shared-store
                # worker can consume an own-store node's output too)
                self._try_fetch(oid)
                continue
            except exc.RayTaskError as e:
                raise e.as_instanceof_cause() from e

    def _try_fetch(self, oid: ObjectID) -> bool:
        """Pull a missing object from a holder node into the local store
        (the reference's PullManager retry loop, pull_manager.h:49 —
        throttled to one locate per object per second)."""
        now = time.monotonic()
        if now - self._last_fetch.get(oid, 0.0) < 1.0:
            return False
        self._last_fetch[oid] = now
        if len(self._last_fetch) > 1024 and \
                now - self._last_fetch_sweep > 10.0:
            # bounded: entries for refs that never fetch successfully are
            # only popped on success, so expire anything far outside the
            # 1s throttle window or a long-lived driver leaks the dict.
            # Time-gated so a bulk wait over >1024 hot refs (nothing
            # expirable yet) doesn't rebuild the dict on every attempt.
            self._last_fetch_sweep = now
            cutoff = now - 10.0
            self._last_fetch = {o: t for o, t in self._last_fetch.items()
                                if t > cutoff}
        try:
            addrs = self._rpc("locate", oid.binary(), timeout=10.0)
        except Exception:
            return False
        from .object_transfer import fetch_resilient
        try:
            if fetch_resilient(addrs, oid, self.store, self.spill):
                self._last_fetch.pop(oid, None)
                if self.own_store:
                    # the head must know this node holds a copy now
                    # (free fanout + future locates)
                    self.send({"t": "object_copied",
                               "oid": oid.binary()})
                return True
        except OSError:
            pass
        return False

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        # multi-oid wait primitive (os_wait_sealed): a seal wakes this
        # waiter immediately; the growing slice is only the fallback
        # cadence for spill re-checks and cross-node fetch retries —
        # replaces the fixed 2ms sleep poll that burned CPU and added up
        # to 2ms latency per completion
        ref_list = list(refs)
        deadline = None if timeout is None else time.monotonic() + timeout
        self.flush()  # buffered submits must ship before we park
        ready, pending = [], []
        flags = self.store.wait_sealed([r.id() for r in ref_list],
                                       len(ref_list), 0)
        for r, f in zip(ref_list, flags):
            present = f or (self.spill is not None
                            and self.spill.contains(r.id()))
            (ready if present else pending).append(r)
        notified = False
        slice_ms = 2
        while len(ready) < num_returns and pending:
            if deadline is not None:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                slice_ms = min(slice_ms, max(1, int(remain * 1000)))
            if not notified:
                # ONE ensure covering every pending ref up front (the old
                # loop also ensured once, but a later-starting wait on the
                # same refs never refreshed it)
                self.send({"t": "ensure",
                           "oids": [r.id().binary() for r in pending]})
                notified = True
            flags = self.store.wait_sealed(
                [r.id() for r in pending],
                num_returns - len(ready), slice_ms)
            still = []
            for r, f in zip(pending, flags):
                if f or (self.spill is not None
                         and self.spill.contains(r.id())):
                    ready.append(r)
                    continue
                if fetch_local:
                    self._try_fetch(r.id())
                still.append(r)
            pending = still
            slice_ms = min(slice_ms * 2, 200)  # exponential backoff
        # reference contract: at most num_returns refs in ready; extra
        # already-ready refs stay in the remaining list
        return ready[:num_returns], ready[num_returns:] + pending

    # -- task/actor API ----------------------------------------------------

    def submit_task(self, spec: TaskSpec):
        spec.owner = self.wid
        # v2: the submit message itself carries our interest in the
        # returns (head adds it before the task can run), so the local
        # refs are constructed without a ref_add send each
        with self._ref_lock:
            self._presumed.update(spec.return_ids)
        refs = [ObjectRef(o) for o in spec.return_ids]
        self.send_async({"t": "submit", "spec": spec})
        return refs

    def create_actor(self, spec: ActorSpec):
        self.send({"t": "create_actor", "spec": spec})
        # the handle can leave this process through the store before the
        # head has read that frame (a get wakes on a seal, not on the
        # head's tables); a call from another process would then meet
        # an unknown actor. The head answers an rpc only after every
        # frame sent before it, so its reply means the actor is known.
        self._rpc("cluster_resources")

    def submit_actor_task_spec(self, spec: TaskSpec):
        spec.owner = self.wid
        with self._ref_lock:
            self._presumed.update(spec.return_ids)  # see submit_task
        refs = [ObjectRef(o) for o in spec.return_ids]
        self.send_async({"t": "actor_call", "spec": spec})
        return refs

    def kill_actor(self, actor_id, no_restart=True):
        self.send({"t": "kill_actor", "actor_id": actor_id.binary(),
                   "no_restart": no_restart})

    def cancel(self, ref, force=False, recursive=True):
        self.send({"t": "cancel", "oid": ref.id().binary(), "force": force})

    # -- head RPCs (reply lands in the shared store, see Runtime
    # _handle_worker_rpc) ---------------------------------------------------

    def _rpc(self, method: str, *args, timeout: float = 30.0):
        return self._rpc_frame({"t": "rpc", "m": method, "args": args},
                               method, timeout=timeout)

    def _rpc_frame(self, msg: dict, label: str, timeout: float = 30.0):
        """Send a request frame that the head answers through the rpc
        reply plumbing (a ("ok"/"err", payload) tuple at reply_oid —
        Runtime._reply_rpc), and wait for the reply. `msg` is any frame
        dict the head answers this way ("rpc" itself, "dir_query");
        the reply_oid is stamped here."""
        reply = ObjectID.from_random()
        msg = {**msg, "reply_oid": reply.binary()}
        self.send(msg)
        deadline = time.monotonic() + timeout
        rb = reply.binary()
        while True:
            got = self._rpc_replies.pop(rb, None)
            if got is not None:
                status, payload = got
                break
            if self.own_store:
                # reply arrives over the conn; park on the event
                self._rpc_reply_evt.wait(timeout=0.1)
                self._rpc_reply_evt.clear()
                if time.monotonic() > deadline:
                    self._rpc_abandoned.add(rb)
                    raise exc.GetTimeoutError(
                        f"head rpc {label} timed out") from None
                continue
            # event-driven: the reply's seal wakes this futex wait
            # immediately (was: a 100ms store.get poll slice per pass);
            # the bounded slice only re-arms against a reconnect-swapped
            # store object
            remain_ms = int((deadline - time.monotonic()) * 1000)
            if remain_ms <= 0:
                # let the head reclaim the reply if it lands later
                self.send({"t": "rpc_abandon",
                           "reply_oid": reply.binary()})
                raise exc.GetTimeoutError(
                    f"head rpc {label} timed out") from None
            sealed = self.store.wait_sealed(
                [reply], 1, min(1000, remain_ms))[0]
            if sealed:
                try:
                    status, payload = self.store.get(reply, timeout_ms=0)
                except StoreTimeout:
                    continue  # evicted between seal and read: retry
                self.store.delete(reply)
                break
        if status == "err":
            raise payload
        return payload

    def get_actor_by_name(self, name):
        return self._rpc("get_actor_by_name", name)

    def create_placement_group(self, bundles, strategy, name="",
                               same_label=None, bundle_selectors=None):
        from ..util.placement_group import PlacementGroup
        pg_id, specs = self._rpc("create_placement_group_rpc",
                                 bundles, strategy, name,
                                 same_label, bundle_selectors)
        return PlacementGroup(pg_id, specs)

    def remove_placement_group(self, pg_id):
        self._rpc("remove_placement_group_rpc", pg_id)

    def pg_wait(self, pg_id, timeout: float = 30.0) -> bool:
        return self._rpc("pg_wait", pg_id, timeout, timeout=timeout + 10.0)

    def cluster_resources(self):
        return self._rpc("cluster_resources")

    def available_resources(self):
        return self._rpc("available_resources")

    def node_table(self):
        return self._rpc("node_table")

    def timeline(self):
        return []

    def shutdown(self):
        pass


def _dial_head(addr: str, authkey: bytes, timeout_s: float = 15.0):
    """Connect to the head's control listener, retrying transient connect
    failures. Under load (single-CPU CI, a burst of worker spawns) the
    AF_UNIX connect can hit the listener's backlog and fail with EAGAIN
    (BlockingIOError) — the head's accept loop just hasn't been scheduled
    yet. Giving up on the first try killed the worker at birth, failing
    its dispatched task with WorkerCrashedError."""
    deadline = time.monotonic() + timeout_s
    delay = 0.05
    while True:
        try:
            if os.environ.get("RTPU_HEAD_FAMILY") == "AF_INET":
                host, port = addr.rsplit(":", 1)
                return Client((host, int(port)), authkey=authkey)
            return Client(addr, "AF_UNIX", authkey=authkey)
        except (BlockingIOError, InterruptedError, ConnectionRefusedError,
                ConnectionResetError):
            if time.monotonic() >= deadline:
                raise
            time.sleep(delay)
            delay = min(delay * 2, 0.5)


class WorkerLoop:
    def __init__(self):
        store_path = os.environ["RTPU_STORE_PATH"]
        addr = os.environ["RTPU_HEAD_ADDR"]
        authkey = bytes.fromhex(os.environ["RTPU_AUTHKEY"])
        self.wid = os.environ["RTPU_WORKER_ID"]
        flight.set_proc_name("worker:" + self.wid)
        self.store = SharedObjectStore(store_path)
        spill_dir = os.environ.get("RTPU_SPILL_DIR")
        spill = SpillStore(spill_dir) if spill_dir else None
        self.conn = _dial_head(addr, authkey)
        self.rt = WorkerRuntime(self.store, self.conn, self.wid, spill)
        rt_mod.set_runtime(self.rt)
        self.actor_instance = None
        self.actor_spec: ActorSpec | None = None
        self.executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="task-exec")
        self.actor_pool: concurrent.futures.ThreadPoolExecutor | None = None
        self.group_pools: dict[str, concurrent.futures.ThreadPoolExecutor] = {}
        self.aio_loop: asyncio.AbstractEventLoop | None = None
        self._exec_tid: int | None = None
        self._current_task_id = None
        self._cancel_lock = threading.Lock()
        self._renv_error: BaseException | None = None
        self._dynamic_items = None
        # dispatch nonces the head reclaimed from our pipeline (set by the
        # recv loop, checked by the exec thread before running)
        self._stolen: set[str] = set()
        # per-function execution counts for @remote(max_calls=N) retirement
        self._fn_calls: dict[str, int] = {}

    # -- arg resolution ----------------------------------------------------

    def _resolve_args(self, blob: bytes):
        args, kwargs = cloudpickle.loads(blob)
        args = [self.rt.get(a) if isinstance(a, ObjectRef) else a
                for a in args]
        kwargs = {k: (self.rt.get(v) if isinstance(v, ObjectRef) else v)
                  for k, v in kwargs.items()}
        return args, kwargs

    # -- execution ---------------------------------------------------------

    def _store_value(self, oid, value, is_exception=False):
        """Store a task output, spilling to disk when the store is full."""
        self.rt.store_or_spill(oid, value, is_exception, notify_put=False)

    def _store_returns(self, spec: TaskSpec, result):
        n = len(spec.return_ids)
        if n == 0:
            return
        if getattr(spec, "dynamic_returns", False):
            # generator task: each yielded item becomes its own object at a
            # DETERMINISTIC id derived from the task id, so a lineage
            # re-execution regenerates the SAME ids and in-hand item refs
            # resolve again (reference reconstructs dynamic returns too);
            # the declared return resolves to the list of refs (containment
            # edges keep items alive); the head links item lineage from the
            # dynamic_items field of the done message
            import hashlib as _h
            if self.store.contains(spec.return_ids[0]):
                return  # a retry re-executed an already-stored return
            item_refs = []
            for idx, item in enumerate(result):
                oid = ObjectID(_h.sha1(
                    spec.task_id.binary() + b"dyn%d" % idx).digest()[:16])
                try:
                    self.rt.put_at(oid, item)
                except FileExistsError:
                    pass  # retry: the item is already there
                item_refs.append(ObjectRef(oid))
            self._dynamic_items = [r.id().binary() for r in item_refs]
            try:
                self._store_value(spec.return_ids[0], item_refs)
            except FileExistsError:
                pass  # lost the race with another attempt; dropping
                # item_refs frees this attempt's items via refcounting
            return
        if n == 1:
            vals = [result]
        else:
            vals = list(result)
            if len(vals) != n:
                raise ValueError(
                    f"task {spec.name} declared num_returns={n} but returned "
                    f"{len(vals)} values")
        for oid, v in zip(spec.return_ids, vals):
            try:
                self._store_value(oid, v)
            except FileExistsError:
                pass  # retry re-executed an already-stored return

    def _run_task(self, spec: TaskSpec, nonce: str | None = None):
        if nonce is not None and nonce in self._stolen:
            # the head reclaimed this pipelined dispatch (we blocked or it
            # was cancelled); it runs elsewhere — no done, no returns
            self._stolen.discard(nonce)
            return
        self._current_task_id = spec.task_id
        self.rt.current_task_name = spec.name
        t0 = time.time()
        flight.evt(flight.EXEC_BEGIN, flight.lo48(spec.task_id))
        # live-stack annotation: this thread is running this task (the
        # head's stack/hang reports resolve the lo48 back to the record)
        stacks.set_task(flight.lo48(spec.task_id))
        span_rec = None
        ns_tok = _ACTIVE_NS.set(getattr(spec, "namespace", None))
        try:
            if self._renv_error is not None:
                raise self._renv_error
            fn = self.rt.func_registry[spec.func_id]
            args, kwargs = self._resolve_args(spec.args_blob)
            tctx = getattr(spec, "trace_ctx", None)
            if tctx is not None:
                # child span of the submitter; tasks submitted inside fn
                # inherit it (util/tracing.py; reference
                # tracing_helper.py:326)
                from ..util.tracing import activate
                with activate(tctx, spec.name) as span_rec:
                    span_rec["task_id"] = spec.task_id.hex()
                    result = fn(*args, **kwargs)
            else:
                result = fn(*args, **kwargs)
            self._store_returns(spec, result)
            ok, err, retryable = True, None, False
        except BaseException as e:  # noqa: BLE001
            ok = False
            retryable = spec.retries_left > 0 and (
                spec.retry_exceptions or isinstance(e, exc.WorkerCrashedError))
            err = "".join(traceback.format_exception_only(type(e), e)).strip()
            if not retryable:
                werr = e if isinstance(e, exc.RayError) else exc.RayTaskError(
                    spec.name, e)
                for oid in spec.return_ids:
                    try:
                        self.store.delete(oid)
                        self._store_value(oid, werr, is_exception=True)
                    except Exception:
                        pass  # store full/closing; done msg carries err
        finally:
            self._current_task_id = None
            stacks.set_task(0)
            _ACTIVE_NS.reset(ns_tok)
        flight.evt(flight.EXEC_END, flight.lo48(spec.task_id), int(ok))
        self.rt._did_block = False
        done_msg = {"t": "done", "task_id": spec.task_id, "ok": ok,
                    "err": err, "retryable": retryable, "name": spec.name,
                    "dur": time.time() - t0}
        if span_rec is not None:
            done_msg["span"] = span_rec
        if getattr(self, "_dynamic_items", None):
            done_msg["dynamic_items"] = self._dynamic_items
            self._dynamic_items = None
        mc = getattr(spec, "max_calls", 0)
        retire = False
        if mc:
            # @remote(max_calls=N): retire this worker after N executions
            # of the function — the release valve for user code that
            # leaks process state (reference: worker_pool's
            # max-calls-triggered worker exit). Exit AFTER the done send:
            # the head sees done, then EOF; anything pipelined behind us
            # requeues via _on_worker_death.
            n = self._fn_calls[spec.func_id] = \
                self._fn_calls.get(spec.func_id, 0) + 1
            retire = n >= mc
        if retire:
            # synchronous: the done (and everything buffered before it)
            # must be on the wire before os._exit
            self.rt.send(done_msg)
            os._exit(0)
        # async: the result is already SEALED in the store (that futex
        # wake is what unblocks a ray.get), so the done only feeds head
        # bookkeeping — back-to-back completions coalesce into one frame
        self.rt.send_async(done_msg)

    def _run_actor_create(self, spec: ActorSpec):
        # the actor lives in its creating job's namespace: __init__ AND
        # every later method call resolve names there
        self._actor_ns = getattr(spec, "namespace", None)
        ns_tok = _ACTIVE_NS.set(self._actor_ns)
        try:
            if self._renv_error is not None:
                raise self._renv_error
            cls = self.rt.func_registry[spec.class_id]
            args, kwargs = self._resolve_args(spec.args_blob)
            self.actor_instance = cls(*args, **kwargs)
            self.actor_spec = spec
            if spec.max_concurrency > 1:
                self.actor_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=spec.max_concurrency,
                    thread_name_prefix="actor-exec")
            # named concurrency groups: independent pools so one group's
            # long calls never block another's
            # (transport/concurrency_group_manager.h analog)
            for gname, width in (spec.concurrency_groups or {}).items():
                self.group_pools[gname] = \
                    concurrent.futures.ThreadPoolExecutor(
                        max_workers=max(1, int(width)),
                        thread_name_prefix=f"cg-{gname}")
            if any(asyncio.iscoroutinefunction(getattr(cls, m, None))
                   for m in dir(cls) if not m.startswith("__")):
                self.aio_loop = asyncio.new_event_loop()
                threading.Thread(target=self.aio_loop.run_forever,
                                 daemon=True, name="actor-aio").start()
            self.rt.send({"t": "actor_ready", "actor_id": spec.actor_id,
                          "ok": True})
        except BaseException as e:  # noqa: BLE001
            tb = traceback.format_exc()
            self.rt.send({"t": "actor_ready", "actor_id": spec.actor_id,
                          "ok": False, "err": tb})
        finally:
            _ACTIVE_NS.reset(ns_tok)

    def _run_actor_task(self, spec: TaskSpec):
        t0 = time.time()
        flight.evt(flight.EXEC_BEGIN, flight.lo48(spec.task_id))
        stacks.set_task(flight.lo48(spec.task_id))
        span_rec = None
        try:
            group = getattr(spec, "concurrency_group", None)
            if group is not None and group not in self.group_pools:
                raise ValueError(
                    f"unknown concurrency group {group!r}; declare it via "
                    f"Actor.options(concurrency_groups={{...}}) "
                    f"(have: {sorted(self.group_pools)})")
            if group is not None and asyncio.iscoroutinefunction(
                    getattr(type(self.actor_instance), spec.method_name,
                            None)):
                raise ValueError(
                    "concurrency groups bound sync methods only; async "
                    "methods all share the actor's event loop (use an "
                    "asyncio.Semaphore inside the actor to bound them)")
            args, kwargs = self._resolve_args(spec.args_blob)
            if spec.method_name == "__rtpu_exec__":
                # internal injection point: run an arbitrary function with
                # the actor instance (compiled-DAG loops, debugging probes;
                # reference analog: __ray_call__)
                fn = cloudpickle.loads(args[0])
                method = lambda *a, **kw: fn(self.actor_instance, *a, **kw)  # noqa: E731
                args = args[1:]
            else:
                method = getattr(self.actor_instance, spec.method_name)
            tctx = getattr(spec, "trace_ctx", None)

            # methods resolve names in the actor's CREATION namespace
            # (reference: an actor belongs to its job's namespace), not
            # the caller's; async methods get it via the coroutine
            # wrapper since a thread-local set here wouldn't cross into
            # the event loop
            actor_ns = getattr(self, "_actor_ns", None)

            async def _with_ns(coro):
                tok = _ACTIVE_NS.set(actor_ns)
                try:
                    return await coro
                finally:
                    _ACTIVE_NS.reset(tok)

            def _invoke():
                # async methods run on the actor's event loop; the span
                # wraps the synchronous wait so sync and async methods
                # both trace (reference tracing_helper.py:407 wraps all
                # actor methods regardless of kind)
                if asyncio.iscoroutinefunction(method):
                    fut = asyncio.run_coroutine_threadsafe(
                        _with_ns(method(*args, **kwargs)), self.aio_loop)
                    return fut.result()
                tok = _ACTIVE_NS.set(actor_ns)
                try:
                    return method(*args, **kwargs)
                finally:
                    _ACTIVE_NS.reset(tok)

            if tctx is not None:
                from ..util.tracing import activate
                with activate(tctx, spec.name) as span_rec:
                    span_rec["task_id"] = spec.task_id.hex()
                    result = _invoke()
            else:
                result = _invoke()
            self._store_returns(spec, result)
            ok, err = True, None
        except BaseException as e:  # noqa: BLE001
            ok = False
            err = "".join(traceback.format_exception_only(type(e), e)).strip()
            werr = e if isinstance(e, exc.RayError) else exc.RayTaskError(
                spec.name, e)
            for oid in spec.return_ids:
                try:
                    self.store.delete(oid)
                    self.store.put(oid, werr, is_exception=True)
                except Exception:
                    pass  # store full/closing; done msg carries err
        stacks.set_task(0)
        flight.evt(flight.EXEC_END, flight.lo48(spec.task_id), int(ok))
        done_msg = {"t": "done", "task_id": spec.task_id, "ok": ok,
                    "err": err, "retryable": False, "name": spec.name,
                    "dur": time.time() - t0}
        if span_rec is not None:
            done_msg["span"] = span_rec
        self.rt.send_async(done_msg)

    def _cancel_current(self, task_id):
        """Best-effort cooperative cancel: raise TaskCancelledError inside the
        executor thread (reference analog: the KeyboardInterrupt raised by
        _raylet.pyx execute_task_with_cancellation_handler)."""
        with self._cancel_lock:
            if self._current_task_id != task_id or self._exec_tid is None:
                return
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(self._exec_tid),
                ctypes.py_object(exc.TaskCancelledError))

    def _exec_wrapper(self, fn, *a):
        self._exec_tid = threading.get_ident()
        fn(*a)

    def _serve_device_get(self, msg: dict):
        # device objects (experimental/device_objects.py) are not ported:
        # the requester gets the reason instead of a payload
        try:
            self.rt.send({"t": "device_payload",
                          "reply_oid": msg["reply_oid"],
                          "requester": msg.get("requester", "driver"),
                          "payload": ("err", "device objects need "
                                      "ray_tpu_torch/experimental/"
                                      "device_objects.py, which is not "
                                      "ported yet")})
        except Exception:
            traceback.print_exc()

    def _apply_renv(self, msg: dict):
        from . import runtime_env as renv_mod
        if msg.get("missing"):
            # blobs lost head-side; poison this worker's tasks clearly
            self._renv_error = RuntimeError(
                f"runtime_env blobs missing on head: {msg['missing']}")
            return
        try:
            import tempfile
            renv_mod.apply_in_worker(
                msg["spec"], msg["blobs"],
                base_dir=os.path.join(tempfile.gettempdir(),
                                      "ray_tpu_torch", "renvs"))
        except Exception as e:  # noqa: BLE001 — surface via task errors
            self._renv_error = e

    def run(self):
        self.conn.send({"t": "register", "wid": self.wid,
                        "pid": os.getpid(), "pv": PROTOCOL_VERSION})
        backlog: deque = deque()
        while True:
            if backlog:
                msg = backlog.popleft()
            else:
                try:
                    msg = self.conn.recv()
                except (EOFError, OSError):
                    # head gone (SIGKILL/crash — not the graceful "exit"
                    # frame). A plain return would hang interpreter
                    # shutdown joining executor threads: long-lived actor
                    # loops (compiled-DAG node loops, rl rollout
                    # producers) park in channel waits whose stop flag
                    # the dead head can never seal. Nothing left to
                    # flush to — exit hard, never orphan the process.
                    if _pre_exit_hook is not None:
                        _pre_exit_hook()   # profiler dump (main() sets it)
                    os._exit(0)
            if msg["t"] == "batch":
                # one pipe write from the head's scheduling pass carrying
                # several ordered control messages; they run BEFORE any
                # already-queued batch's remainder (extendleft preserves
                # the batch's own order)
                backlog.extendleft(reversed(msg["msgs"]))
                continue
            t = msg["t"]
            if t == "func":
                self.rt.func_registry[msg["fid"]] = cloudpickle.loads(
                    msg["blob"])
                self.rt._sent_fids.add(msg["fid"])
            elif t == "renv":
                # dedicate this worker to the runtime env BEFORE the task
                # that needs it arrives (messages are ordered); application
                # runs on the exec thread so it cannot race a running task
                self.executor.submit(self._exec_wrapper, self._apply_renv,
                                     msg)
            elif t == "task":
                self.executor.submit(self._exec_wrapper, self._run_task,
                                     msg["spec"], msg.get("n"))
            elif t == "actor_create":
                self.executor.submit(self._exec_wrapper,
                                     self._run_actor_create, msg["spec"])
            elif t == "actor_task":
                group = getattr(msg["spec"], "concurrency_group", None)
                pool = (self.group_pools.get(group)
                        or self.actor_pool or self.executor)
                if self.aio_loop is not None and asyncio.iscoroutinefunction(
                        getattr(type(self.actor_instance),
                                msg["spec"].method_name, None)):
                    # async methods run concurrently on the loop; dispatch
                    # from a shim thread so the recv loop never blocks
                    threading.Thread(target=self._run_actor_task,
                                     args=(msg["spec"],), daemon=True).start()
                else:
                    pool.submit(self._exec_wrapper, self._run_actor_task,
                                msg["spec"])
            elif t == "rpc_reply":
                if msg["reply_oid"] in self.rt._rpc_abandoned:
                    self.rt._rpc_abandoned.discard(msg["reply_oid"])
                else:
                    self.rt._rpc_replies[msg["reply_oid"]] = msg["payload"]
                    self.rt._rpc_reply_evt.set()
            elif t == "device_get":
                # serve a device-object fetch; serialization can be large,
                # keep the recv loop free
                threading.Thread(
                    target=self._serve_device_get, args=(msg,),
                    daemon=True).start()
            elif t == "flight_pull":
                # head pulling this process's flight-recorder ring; the
                # snapshot samples (mono_ns, wall_ns) together for the
                # head's wall-clock-bridge offset estimate, and is a
                # buffer copy — cheap enough for this loop
                self.rt.send_async(flight.pull_reply(msg))
            elif t == "stack_dump":
                # head pulling live thread stacks (stall doctor). Handled
                # HERE, on the recv thread, exactly like flight_pull: the
                # dump must succeed even when every executor thread is
                # wedged — that is the whole point of the feature
                self.rt.send_async(stacks.dump_reply(msg))
            elif t == "cancel":
                self._cancel_current(msg["task_id"])
            elif t == "steal":
                # handled on the recv thread so it lands BEFORE the exec
                # thread reaches the stolen dispatch in its queue
                self._stolen.update(msg["nonces"])
            elif t == "exit":
                try:
                    import sys
                    # zero this process's per-proc engine gauges first:
                    # the head store is last-write-wins and no one else
                    # will ever update a dead replica's series
                    tmod = sys.modules.get("ray_tpu_torch.llm.telemetry")
                    if tmod is not None:
                        tmod.zero_proc_gauges()
                    from ..util.metrics import shutdown_flush
                    shutdown_flush()   # final counter deltas to the head
                except Exception:
                    pass  # final flush is best-effort on exit
                try:
                    self.rt.flush()    # buffered dones/refs before _exit
                except Exception:
                    pass  # conn may be gone; exiting anyway
                if _pre_exit_hook is not None:
                    _pre_exit_hook()   # profiler dump (main() sets it)
                os._exit(0)


_pre_exit_hook = None


def main():
    prof_dir = os.environ.get("RTPU_WORKER_PROFILE_DIR")
    if prof_dir:
        # per-worker cProfile dumps (reference analog: worker profiling via
        # py-spy in _private/profiling.py); enable with
        # RTPU_WORKER_PROFILE_DIR=/some/dir before init. The exit message
        # calls os._exit, so the dump runs via _pre_exit_hook.
        import cProfile
        import io
        import pstats
        pr = cProfile.Profile()

        def dump():
            pr.disable()
            s = io.StringIO()
            pstats.Stats(pr, stream=s).sort_stats(
                "tottime").print_stats(25)
            try:
                with open(os.path.join(
                        prof_dir, f"worker-{os.getpid()}.prof"), "w") as f:
                    f.write(s.getvalue())
            except OSError:
                pass

        global _pre_exit_hook
        _pre_exit_hook = dump
        pr.enable()
        try:
            main_inner()
        finally:
            dump()
    else:
        main_inner()


def main_inner():
    loop = WorkerLoop()
    try:
        loop.run()
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
