"""Driver client: attach this process to a running cluster as a driver.

Reference parity: the driver path of ``ray.init(address=...)`` — a driver
core worker dialing a live GCS (python/ray/_private/worker.py:1336 connect
branch) — and the role (not the transport) of Ray Client (util/client/):
an interactive process driving a remote cluster.

The client registers over the head's control plane as a ``driver-*``
pseudo-worker: it speaks the complete worker protocol (submit/put/get/
actors/PGs/RPCs via :class:`WorkerRuntime`) but lives outside every node's
worker pool, so the scheduler can never dispatch work to it.  Data moves
through the same shared-memory store as everyone else — zero extra copies
vs the reference's dedicated client gRPC proxy.

The port's copy of ``ray_tpu/core/client.py``. Both packages read
``RTPU_ADDRESS``, so this client attaches only to a head of this package:
a cluster file without this package's ``package`` field (as the
reference's heads write them) is refused with ``ConnectionError``, and
``"auto"`` scans only this package's session base,
``$TMPDIR/ray_tpu_torch/``.
"""
from __future__ import annotations

import json
import multiprocessing as mp
import os
import threading
from multiprocessing.connection import Client

from .object_store import SharedObjectStore, SpillStore
from .protocol import PROTOCOL_VERSION, ProtocolMismatchError
from .worker import WorkerRuntime
from . import flight
from . import stacks
from . import runtime as rt_mod


def resolve_cluster_file(address: str | None) -> str:
    """Find the cluster file for ``address``:

    - explicit path to a ``cluster.json``;
    - ``"auto"``/None: ``$RTPU_ADDRESS`` if set (exported to job drivers),
      else the most recently started session under
      ``runtime.session_base()``.

    The file must be one this package's head wrote (``_read_cluster_file``).
    """
    if address and address not in ("auto", "local"):
        if os.path.isfile(address):
            _read_cluster_file(address)
            return address
        raise ConnectionError(f"no cluster file at {address!r}")
    env = os.environ.get("RTPU_ADDRESS")
    if env:
        if not os.path.isfile(env):
            raise ConnectionError(f"RTPU_ADDRESS={env!r} does not exist")
        _read_cluster_file(env)
        return env
    base = rt_mod.session_base()
    candidates = []
    if os.path.isdir(base):
        for d in os.listdir(base):
            cf = os.path.join(base, d, "cluster.json")
            if os.path.isfile(cf) and _head_alive(cf):
                candidates.append((os.path.getmtime(cf), cf))
    if not candidates:
        raise ConnectionError(
            f"address='auto' but no running cluster found under {base} "
            f"(start one with `ray_tpu_torch.init()`)")
    return max(candidates)[1]


def _read_cluster_file(path: str) -> dict:
    """The cluster file's fields; ConnectionError unless this package's
    head wrote it (the reference package's heads use the same file name
    and the same RTPU_ADDRESS variable, but another wire and store)."""
    try:
        with open(path) as f:
            cf = json.load(f)
    except (OSError, ValueError) as e:
        raise ConnectionError(f"cannot read cluster file {path!r}: {e}")
    if cf.get("package") != rt_mod.CLUSTER_PACKAGE:
        raise ConnectionError(
            f"cluster file {path!r} was not written by a "
            f"{rt_mod.CLUSTER_PACKAGE} head (package="
            f"{cf.get('package')!r}); a {rt_mod.CLUSTER_PACKAGE} driver "
            f"attaches only to a {rt_mod.CLUSTER_PACKAGE} cluster")
    return cf


def _head_alive(cluster_file: str) -> bool:
    """Is the head process that wrote this cluster file still running?
    (Guards 'auto' against stale files from crashed heads — clean
    shutdowns delete theirs.)"""
    try:
        with open(cluster_file) as f:
            pid = json.load(f).get("pid", -1)
        os.kill(pid, 0)
        return True
    except (OSError, ValueError, TypeError):
        return False


class DriverRuntime(WorkerRuntime):
    """WorkerRuntime wired as an external driver. Adds: connection liveness
    tracking, head-pushed exit handling, a real shutdown, and — the GCS
    fault-tolerance client half (reference: the retryable GCS RPC wrappers
    under src/ray/rpc/ + redis_store_client.h:111 restore) — reconnection
    with backoff to a RESTARTED head: the driver re-registers, re-ships
    its function definitions and ref interest, resubmits its unresolved
    plain tasks, and swaps onto the new session's object store so
    in-flight ``get``s resume against the re-executed results."""

    # class-level defaults so the send pump (started by the base __init__,
    # before our fields exist) can never crash on a missing attribute
    _closing = False
    _conn_gen = 0

    def __init__(self, store, conn, wid, spill=None, address_arg=None):
        super().__init__(store, conn, wid, spill)
        flight.set_proc_name("driver:" + wid)
        self.disconnected = threading.Event()
        self._address_arg = address_arg
        self._closing = False
        self._conn_gen = 0
        # fid -> pickled function blob, for re-shipping after reconnect
        self._fid_blobs: dict = {}
        # return-oid (binary) -> plain TaskSpec not yet observed resolved;
        # resubmitted on reconnect (their results died with the old store)
        self._unresolved: dict = {}
        self._track_lock = threading.Lock()
        threading.Thread(target=self._conn_loop, daemon=True,
                         name="rtpu-driver-recv").start()

    # -- call tracking for resubmission ---------------------------------- #

    def register_function(self, fid, blob):
        self._fid_blobs[fid] = blob
        super().register_function(fid, blob)

    def submit_task(self, spec):
        refs = super().submit_task(spec)
        if not spec.is_actor_task:
            with self._track_lock:
                for o in spec.return_ids:
                    self._unresolved[o.binary()] = spec
        return refs

    def _get_one(self, oid, deadline, on_wait):
        out = super()._get_one(oid, deadline, on_wait)
        with self._track_lock:
            self._unresolved.pop(oid.binary(), None)
        return out

    def _note_outgoing(self, msg):
        # the driver released its last local ref: it can never get()
        # this result, so resubmitting its task on reconnect would be
        # pure waste — and without this hook _unresolved grows
        # unboundedly in fire-and-forget workloads
        if not isinstance(msg, dict):
            return
        t = msg.get("t")
        if t == "ref_drop":
            with self._track_lock:
                self._unresolved.pop(msg["oid"], None)
        elif t == "ref_drops":
            with self._track_lock:
                for ob in msg["oids"]:
                    self._unresolved.pop(ob, None)

    def send(self, msg):
        self._note_outgoing(msg)
        return super().send(msg)

    def send_async(self, msg):
        self._note_outgoing(msg)
        return super().send_async(msg)

    # -- liveness / reconnection ----------------------------------------- #

    def _conn_loop(self):
        # Workers drain dispatches here; a driver receives "exit" (head
        # shutting down), flight_pull (cluster flight-recorder
        # collection — the driver's ring holds the handle-side serve
        # events, and an unanswered pull would stall every collection
        # for its full timeout), stack_dump (stall-doctor live-stack
        # collection — the driver's threads hold the handle-side serve
        # waits, and its own wedged gets are half the hang picture),
        # rpc replies (handled by WorkerRuntime paths), or EOF (head
        # died -> try to reconnect).
        while True:
            try:
                while True:
                    msg = self.conn.recv()
                    if not isinstance(msg, dict):
                        continue
                    t = msg.get("t")
                    if t == "exit":
                        self.disconnected.set()
                        return
                    if t == "flight_pull":
                        self.send_async(flight.pull_reply(msg))
                    elif t == "stack_dump":
                        self.send_async(stacks.dump_reply(msg))
            except (EOFError, OSError, TypeError):
                # TypeError: the conn's fd was torn down mid-recv by
                # interpreter shutdown (read(None, ...)); same as EOF
                pass
            try:
                ok = not self._closing and self._reconnect()
            except Exception:
                ok = False  # never die silently: liveness must resolve
            if not ok:
                self.disconnected.set()
                return

    def _reconnect(self) -> bool:
        from .config import cfg
        timeout = cfg.driver_reconnect_timeout_s
        if timeout <= 0:
            return False
        import time
        deadline = time.monotonic() + timeout
        delay = 0.25
        while not self._closing and time.monotonic() < deadline:
            conn = reply = None
            # the restarted head writes a NEW session dir: try the original
            # address first (a stable path), then fall back to auto-resolve
            for addr in (self._address_arg, None):
                try:
                    cf_path = resolve_cluster_file(addr)
                    conn, reply = _dial(cf_path)
                except ProtocolMismatchError as e:
                    # deterministic refusal — retrying cannot succeed
                    print(f"driver reconnect refused: {e}", flush=True)
                    return False
                except (ConnectionError, OSError, EOFError, ValueError,
                        mp.AuthenticationError):
                    continue
                # identity check: only attach to OUR cluster — the same
                # session (transient drop) or a head that RESUMED from it
                # (restart). Auto-resolve picks the newest local cluster
                # file, which on a busy box can belong to an unrelated
                # cluster; silently hijacking onto it would cross-wire
                # two jobs (reference analog: GCS FT clients reconnect to
                # a fixed redis-backed address, never to "any GCS").
                mine = getattr(self, "_session_dir", None)
                if mine and reply.get("session_dir") != mine and \
                        reply.get("resumed_from") != mine:
                    try:
                        conn.close()
                    except Exception:
                        pass  # already closing a failed dial
                    conn = reply = None
                    continue
                break
            if conn is None:
                # reconnect backoff runs on the conn-loop thread while the
                # link is DOWN: there are no inbound frames to stall
                time.sleep(delay)  # graftlint: disable=GL013
                delay = min(delay * 2, 2.0)
                continue
            store = SharedObjectStore(reply["store_path"], create=False)
            spill = (SpillStore(reply["spill_dir"])
                     if reply.get("spill_dir") else None)
            # snapshot ref interest BEFORE send_lock: ref_created/_drop_loop
            # hold _ref_lock across send(), which parks on reconnect — taking
            # _ref_lock inside send_lock here would deadlock (lock-order
            # inversion). A ref added in the window replays itself: its own
            # parked ref_add completes after the gen bump.
            with self._ref_lock:
                live = list(self._ref_counts)
            # swap AND replay under send_lock: user threads parked in
            # send() cannot slip a submit onto the new conn before its
            # func_def replays land (ordering bug otherwise); _conn_gen
            # is bumped only after the replay succeeds, so parked senders
            # wake into a fully re-registered session
            with self.send_lock:
                self.conn = conn
                self.store = store
                self.spill = spill
                self.wid = reply["wid"]
                # restart chains: the NEW session becomes our identity,
                # so a later restart resuming from IT still matches
                self._session_dir = reply.get("session_dir") or \
                    getattr(self, "_session_dir", None)
                self._sent_fids.clear()
                self._sent_renvs.clear()
                # the new head knows nothing about us: re-ship function
                # defs, re-register ref interest, resubmit unresolved
                # plain tasks (their results died with the old store)
                try:
                    for fid, blob in list(self._fid_blobs.items()):
                        conn.send({"t": "func_def", "fid": fid,
                                   "blob": blob})
                        self._sent_fids.add(fid)
                    for oid in live:
                        conn.send({"t": "ref_add", "oid": oid.binary()})
                    with self._track_lock:
                        seen, cand = set(), []
                        for spec in self._unresolved.values():
                            if spec.task_id not in seen:
                                seen.add(spec.task_id)
                                cand.append(spec)
                    # submits still parked in the flush buffer were NEVER
                    # sent (a failed flush requeues its frame before
                    # raising, under send_lock — which we hold): they ship
                    # themselves after the swap, ORDERED AFTER the
                    # func_def replay above, so resubmitting them here
                    # would run those tasks twice. Snapshot the buffer
                    # AFTER reading _unresolved: a racing submit_task
                    # appends to _sbuf before it registers in _unresolved,
                    # so any spec the scan above saw is already visible
                    # here if it is still unsent.
                    with self._sbuf_lock:
                        buffered_tids = set()
                        for m in self._sbuf:
                            if not isinstance(m, dict) or \
                                    m.get("t") not in ("submit",
                                                       "actor_call"):
                                continue
                            # they will flush into the NEW session: re-key
                            # their owner like the replayed specs get,
                            # else device-object fetches would route to
                            # the dead session's wid
                            m["spec"].owner = self.wid
                            if m["t"] == "submit":
                                buffered_tids.add(m["spec"].task_id)
                    for spec in cand:
                        if spec.task_id in buffered_tids:
                            continue
                        spec.owner = self.wid
                        conn.send({"t": "submit", "spec": spec})
                except (OSError, ValueError, BrokenPipeError):
                    continue  # head died again mid-replay; retry dial
            self._conn_gen += 1
            # kick the flush buffer: parked rider threads retry on their
            # own, but messages whose rider already gave up (deadline)
            # would otherwise strand until the next send
            try:
                super()._try_flush()
            except Exception:
                pass  # riders retry on their own; kick is best-effort
            # the restarted head's metric store is empty: re-mark gauge
            # series dirty (last-write-wins values only live on the head)
            # and re-ship everything on the spot
            try:
                from ..util import metrics as _um
                _um.mark_gauges_dirty()
                _um.flush()
            except Exception:
                pass  # next 2s flush tick re-ships
            return True
        return False

    def _flush_now(self):
        self._ride(super()._flush_now)

    def _try_flush(self):
        self._ride(super()._try_flush)

    def _ride(self, flush_fn):
        """Flushes ride out a head restart: a failed drain has already
        requeued its messages at the front of the buffer (base class), so
        this blocks until the reconnect loop swaps in a live connection
        and then re-flushes — the replay saw the parked messages in the
        buffer and excluded them from resubmission, so a ridden-out
        restart delivers them exactly once. On give-up (ConnectionError
        after the reconnect deadline) the messages STAY queued: a later
        successful reconnect may still deliver them, so a caller that saw
        the error must treat its submits as at-most-once-PLUS-pending,
        not as never-sent, before resubmitting side-effecting work."""
        deadline = None  # computed on first failure: the happy path runs
        while True:     # flush_fn with zero per-send overhead
            gen = self._conn_gen
            try:
                return flush_fn()
            except (OSError, EOFError, ValueError, BrokenPipeError) as err:
                if self._closing:
                    raise
                if isinstance(err, ValueError) and \
                        not getattr(self.conn, "closed", True):
                    # deterministic serialization failure on a LIVE
                    # connection (the drain already isolated/dropped it):
                    # not a head restart — parking here would stall the
                    # caller for the whole reconnect deadline and then
                    # mask the real error with a bogus ConnectionError
                    raise
                import time
                from .config import cfg
                if deadline is None:
                    deadline = time.monotonic() + max(
                        cfg.driver_reconnect_timeout_s, 1.0)
                while (self._conn_gen == gen
                       and not self.disconnected.is_set()
                       and time.monotonic() < deadline):
                    time.sleep(0.05)
                if self._conn_gen == gen:
                    raise ConnectionError(
                        "head connection lost and not re-established")
                # reconnected: a flush spanning ANOTHER restart gets a
                # fresh ride budget per leg, not the first leg's remnant
                deadline = None

    def timeline(self):
        return self._rpc("timeline")

    def shutdown(self):
        # _closing FIRST: it makes _ride fail fast, so the final flush
        # ships over a live head but never stalls teardown for the
        # reconnect deadline when the head is already gone (the deltas
        # were lost with the head's store anyway)
        self._closing = True
        try:
            from ..util.metrics import shutdown_flush
            shutdown_flush()  # last counter deltas before the conn dies
        except Exception:
            pass  # deltas died with the head's store
        try:
            self.flush()  # buffered submits/drops, best effort
        except Exception:
            pass  # head may already be gone
        self.disconnected.set()
        try:
            self.conn.close()
        except Exception:
            pass  # conn already dead/closed
        try:
            self.store.close(unlink=False)
        except Exception:
            pass  # unmap is best-effort at exit
        if rt_mod.get_runtime_if_exists() is self:
            rt_mod.set_runtime(None)


def _dial(cf_path: str):
    """Open a control connection + driver registration for a cluster file.
    Returns (conn, registration reply)."""
    cf = _read_cluster_file(cf_path)
    authkey = bytes.fromhex(cf["authkey"])
    unix_addr = cf.get("unix_addr")
    if unix_addr and os.path.exists(unix_addr):
        conn = Client(unix_addr, "AF_UNIX", authkey=authkey)
    else:
        host = cf["tcp_host"]
        if host == "0.0.0.0":
            host = "127.0.0.1"
        conn = Client((host, cf["tcp_port"]), "AF_INET", authkey=authkey)
    conn.send({"t": "register_driver", "pid": os.getpid(),
               "pv": PROTOCOL_VERSION})
    # dial-time handshake: the conn loop only reaches _dial while the old
    # link is dead, so blocking on the registration reply is the point
    reply = conn.recv()  # graftlint: disable=GL013
    if reply.get("t") == "rejected":
        # structured refusal (e.g. wire-protocol mismatch): deterministic,
        # NOT retryable — reconnect loops must surface it, not back off
        conn.close()
        raise ProtocolMismatchError(reply.get("error", "rejected"))
    if reply.get("t") != "registered_driver":
        conn.close()
        raise ConnectionError(f"head rejected driver registration: {reply}")
    if reply.get("pv") != PROTOCOL_VERSION:
        # symmetric check: a pre-versioning head never sends pv
        conn.close()
        raise ProtocolMismatchError(
            f"head speaks wire-protocol version {reply.get('pv')!r}, "
            f"this driver speaks {PROTOCOL_VERSION}")
    return conn, reply


def connect(address: str | None = None,
            namespace: str | None = None) -> dict:
    """Connect as a driver; sets the process runtime. Returns init info."""
    cf_path = resolve_cluster_file(address)
    cf = _read_cluster_file(cf_path)
    conn, reply = _dial(cf_path)
    store = SharedObjectStore(reply["store_path"], create=False)
    spill = SpillStore(reply["spill_dir"]) if reply.get("spill_dir") else None
    rt = DriverRuntime(store, conn, reply["wid"], spill,
                       address_arg=address)
    # named-actor scoping: this driver's default namespace (a job driver
    # inherits the submitting cluster's via RTPU_NAMESPACE)
    rt.namespace = namespace or os.environ.get("RTPU_NAMESPACE", "default")
    # cluster identity for reconnect verification (_reconnect): the
    # session we attached to; updated on each successful reconnect so
    # restart CHAINS keep matching
    rt._session_dir = reply.get("session_dir") or cf.get("session_dir")
    rt_mod.set_runtime(rt)
    return {"address": cf_path, "wid": reply["wid"],
            "job_id": reply["job_id"], "session_dir": cf["session_dir"]}
