"""Flight recorder — always-on, sub-microsecond event tracing for the
zero-dispatch fast paths.

Why this exists: span tracing (util/tracing.py) is keyed to task
dispatches, and the control plane's fast paths have no per-item
dispatches on exactly the paths that dominate latency — batched control frames, sealed ring
channels, compiled-DAG loops, the serve static decode plan, Podracer
fragment queues. Those paths are invisible to dispatch-keyed tracing by
construction. The flight recorder is the always-on instrument for them:
a per-process, preallocated, struct-packed ring buffer whose ``evt()``
costs well under a microsecond — cheap enough to leave on in production
(TorchTitan makes built-in flight-recorder debugging a first-class
requirement for a training stack; this is that layer for ray_tpu_torch).

Design constraints, in order:

- **No locks, no allocation on the hot path.** ``evt(code, a0..a3)``
  packs one fixed 44-byte record (monotonic ns, code, thread id low
  bits, four int64 args) into a preallocated ``bytearray`` ring. The
  slot index comes from ``itertools.count`` (its ``__next__`` is a
  single C call, atomic under the GIL), so concurrent emitters never
  contend. Argument errors (non-int, overflow) drop the record and bump
  a counter — the recorder can never raise into instrumented code.
- **Bounded memory, drop-counted overflow.** The ring holds
  ``cfg.flight_ring_slots`` records (rounded to a power of two); older
  events are overwritten (evicted) and ``dropped`` counts them. The
  recorder never blocks and never grows.
- **Strings never enter the ring.** Event codes are integers resolved
  against the catalogue below at EXPORT time; args are integers (object
  ids compressed to their low 48 bits via :func:`lo48`). graftlint
  GL010 enforces this at emit sites: f-strings, %-formatting,
  ``.format()`` calls and dict/list literals passed to ``evt()`` are
  findings — the cost of formatting must never ride the hot path.

Cluster collection: the head pulls each worker's ring on demand over
the existing control plane (``flight_pull``/``flight_ring`` frames —
protocol v5) and estimates each process's monotonic-clock offset
through the WALL clock as a bridge: each snapshot samples (mono, wall)
together, the head samples its own pair at receipt, and
offset = (their mono - their wall) - (our mono - our wall) — immune to
transport queueing delay, exact whenever wall clocks agree (always on
one host, NTP-close across hosts). Same-host processes share
CLOCK_MONOTONIC, so sub-millisecond residue is clamped to zero —
cross-process edges (producer seal -> consumer wake) then line up
exactly. :func:`export_chrome` renders the stitched
timeline as Chrome-trace/Perfetto JSON with flow arrows binding each
channel seal to the wake that consumed it. Surfaced as
``state.timeline(flight=True)`` and ``python -m ray_tpu_torch.cli timeline``.

Enable/disable: on by default (``cfg.flight_recorder`` /
``RTPU_FLIGHT_RECORDER=0`` to disable — the A/B knob the overhead gate
uses). ``set_enabled(False)`` rebinds ``evt`` to a no-op, so disabled
cost is one no-op function call.
"""
from __future__ import annotations

import itertools
import os
import struct
import threading
import time
from typing import Any, Optional

# --------------------------------------------------------------------- #
# record layout
# --------------------------------------------------------------------- #

RECORD = struct.Struct("<QHHqqqq")   # ts_ns, code, tid16, a0..a3
RECSZ = RECORD.size                  # 44 bytes
_ZERO8 = bytes(8)                    # ts wipe for torn/dropped records

# --------------------------------------------------------------------- #
# event catalogue — codes are wire-stable integers; names/phases live
# here and are applied at export time only
# --------------------------------------------------------------------- #

# phases: "B"/"E" chrome begin/end (nest per thread track), "i" instant.
# flow: "s" opens a flow arrow keyed on (a0, a1); "f" closes it.

# head / scheduler
TASK_STATE = 1        # i  (task48, state_code)
SCHED_BEGIN = 2       # B  ()
SCHED_END = 3         # E  ()
BATCH_RECV = 4        # i  (n_msgs,)
TASK_STUCK = 5        # i  (task48, over_ms)  stall-doctor watchdog flag
DEADLOCK = 6          # i  (n_parties,)       wait-graph cycle reported

# worker
EXEC_BEGIN = 10       # B  (task48,)
EXEC_END = 11         # E  (task48, ok)
CTRL_FLUSH = 12       # i  (n_msgs,)
OBJ_MISS = 13         # i  (oid48,)

# object store
OBJ_CREATE = 20       # i  (oid48, size)
OBJ_SEAL = 21         # i  (oid48,)
WAIT_BEGIN = 22       # B  (n, min_count)
WAIT_END = 23         # E  (n_sealed,)

# sealed ring channels
CHAN_SEAL = 30        # i + flow s  (chan48, seq)
CHAN_WAKE = 31        # i + flow f  (chan48, seq)
CHAN_ACK = 32         # i  (ackchan48, seq)
CREDIT_BEGIN = 33     # B  (chan48, seq)
CREDIT_END = 34       # E  (chan48,)
CHAN_STOP = 35        # i  (stop48,)

# completion mux
MUX_WAKE = 40         # i  (n_fired, n_watched)

# compiled DAGs
DAG_STEP_BEGIN = 45   # B  (node_idx, seq)
DAG_STEP_END = 46     # E  (node_idx, seq)
DAG_EXEC = 47         # i  (seq,)

# serve
SRV_DISPATCH = 50     # i  (replica_idx, stream)
SRV_REQ_BEGIN = 51    # B  (req_seq,)
SRV_REQ_END = 52      # E  (req_seq, ok)
SRV_STREAM_START = 53  # i  (sid, transport)   transport: 0 poll, 1 chan
SRV_DRAIN_BEGIN = 54  # B  (sid,)
SRV_DRAIN_END = 55    # E  (sid, items)

# podracer / rl
FRAG_PUT = 60         # i  (producer_idx, seq)
FRAG_GET = 61         # i  (producer_idx,)
WEIGHT_PUB = 62       # i  (version,)
WEIGHT_FETCH = 63     # i  (version,)
SAMPLE_BEGIN = 64     # B  (producer_idx,)
SAMPLE_END = 65       # E  (producer_idx, frags)

# data streaming pipelines (data/streaming) — per-block seal/consume
# flow arrows ride the CHAN_SEAL/CHAN_WAKE records the channel layer
# already emits (chan48:seq flow ids); these add the stage spans and
# block-index annotations the timeline groups a pipeline by
DATA_STAGE_BEGIN = 80  # B  (stage_idx, worker_idx)
DATA_STAGE_END = 81    # E  (stage_idx, blocks)
DATA_BLOCK = 82        # i  (stage_idx, block_idx)

# metrics plane (obs/slo.py) — SLO alert state-machine transitions
SLO_TRANSITION = 90   # i  (slo_idx, to_state, from_state) 0 ok/1 warn/2 page

# llm prefix-cache heat plane (llm/paged_engine.py) — cache churn
PREFIX_EVICT = 91     # i  (pid, chain_slot)
PREFIX_IMPORT = 92    # i  (pages, chain_slot)

# jax step profiling (util/profiling.py)
STEP_BEGIN = 70       # B  (kind,)
STEP_END = 71         # E  (kind,)
JIT_COMPILE_BEGIN = 72  # B  (key48,)
JIT_COMPILE_END = 73  # E  (key48,)

#: code -> (name, category, phase, flow, (argname, ...))
CODES: dict[int, tuple] = {
    TASK_STATE: ("task_state", "task", "i", None, ("task", "state")),
    SCHED_BEGIN: ("sched_pass", "sched", "B", None, ()),
    SCHED_END: ("sched_pass", "sched", "E", None, ()),
    BATCH_RECV: ("batch_recv", "ctrl", "i", None, ("n",)),
    TASK_STUCK: ("task_stuck", "task", "i", None, ("task", "over_ms")),
    DEADLOCK: ("deadlock", "task", "i", None, ("parties",)),
    EXEC_BEGIN: ("task_exec", "task", "B", None, ("task",)),
    EXEC_END: ("task_exec", "task", "E", None, ("task", "ok")),
    CTRL_FLUSH: ("ctrl_flush", "ctrl", "i", None, ("n",)),
    OBJ_MISS: ("obj_miss", "store", "i", None, ("oid",)),
    OBJ_CREATE: ("obj_create", "store", "i", None, ("oid", "size")),
    OBJ_SEAL: ("obj_seal", "store", "i", None, ("oid",)),
    WAIT_BEGIN: ("store_wait", "store", "B", None, ("n", "min")),
    WAIT_END: ("store_wait", "store", "E", None, ("sealed",)),
    CHAN_SEAL: ("chan_seal", "chan", "i", "s", ("chan", "seq")),
    CHAN_WAKE: ("chan_wake", "chan", "i", "f", ("chan", "seq")),
    CHAN_ACK: ("chan_ack", "chan", "i", None, ("chan", "seq")),
    CREDIT_BEGIN: ("chan_credit", "chan", "B", None, ("chan", "seq")),
    CREDIT_END: ("chan_credit", "chan", "E", None, ("chan",)),
    CHAN_STOP: ("chan_stop", "chan", "i", None, ("stop",)),
    MUX_WAKE: ("mux_wake", "mux", "i", None, ("fired", "watched")),
    DAG_STEP_BEGIN: ("dag_step", "dag", "B", None, ("node", "seq")),
    DAG_STEP_END: ("dag_step", "dag", "E", None, ("node", "seq")),
    DAG_EXEC: ("dag_execute", "dag", "i", None, ("seq",)),
    SRV_DISPATCH: ("serve_dispatch", "serve", "i", None,
                   ("replica", "stream")),
    SRV_REQ_BEGIN: ("serve_request", "serve", "B", None, ("req",)),
    SRV_REQ_END: ("serve_request", "serve", "E", None, ("req", "ok")),
    SRV_STREAM_START: ("serve_stream", "serve", "i", None,
                       ("sid", "transport")),
    SRV_DRAIN_BEGIN: ("serve_drain", "serve", "B", None, ("sid",)),
    SRV_DRAIN_END: ("serve_drain", "serve", "E", None, ("sid", "items")),
    FRAG_PUT: ("frag_put", "rl", "i", None, ("producer", "seq")),
    FRAG_GET: ("frag_get", "rl", "i", None, ("producer",)),
    WEIGHT_PUB: ("weight_publish", "rl", "i", None, ("version",)),
    WEIGHT_FETCH: ("weight_fetch", "rl", "i", None, ("version",)),
    SAMPLE_BEGIN: ("rollout_sample", "rl", "B", None, ("producer",)),
    SAMPLE_END: ("rollout_sample", "rl", "E", None,
                 ("producer", "frags")),
    DATA_STAGE_BEGIN: ("data_stage", "data", "B", None,
                       ("stage", "worker")),
    DATA_STAGE_END: ("data_stage", "data", "E", None,
                     ("stage", "blocks")),
    DATA_BLOCK: ("data_block", "data", "i", None, ("stage", "idx")),
    SLO_TRANSITION: ("slo_transition", "obs", "i", None,
                     ("slo", "to", "from")),
    PREFIX_EVICT: ("prefix_evict", "llm", "i", None, ("pid", "chain")),
    PREFIX_IMPORT: ("prefix_import", "llm", "i", None,
                    ("pages", "chain")),
    STEP_BEGIN: ("jax_step", "jax", "B", None, ("kind",)),
    STEP_END: ("jax_step", "jax", "E", None, ("kind",)),
    JIT_COMPILE_BEGIN: ("jit_compile", "jax", "B", None, ("key",)),
    JIT_COMPILE_END: ("jit_compile", "jax", "E", None, ("key",)),
}

#: task-state strings <-> compact codes for TASK_STATE records
TASK_STATES = {"PENDING": 0, "RUNNING": 1, "FINISHED": 2, "FAILED": 3,
               "RETRYING": 4, "CANCELLED": 5}
_TASK_STATE_NAMES = {v: k for k, v in TASK_STATES.items()}


def lo48(oid: Any) -> int:
    """Compress an ObjectID/TaskID (or raw id bytes / channel base) to
    its low 48 bits — enough to correlate records without strings."""
    b = oid if isinstance(oid, bytes) else oid.binary()
    return int.from_bytes(b[:6], "little")


# --------------------------------------------------------------------- #
# the recorder
# --------------------------------------------------------------------- #

class FlightRecorder:
    """Preallocated struct-packed ring. One per process; create via the
    module functions, not directly (tests may instantiate with a small
    slot count through install_for_test)."""

    __slots__ = ("buf", "cap", "mask", "ctr", "bad", "_peeked")

    def __init__(self, slots: int):
        cap = 1 << max(6, (max(2, slots) - 1).bit_length())
        self.buf = bytearray(cap * RECSZ)
        self.cap = cap
        self.mask = cap - 1
        self.ctr = itertools.count()
        self.bad = 0
        self._peeked = 0

    def count(self) -> int:
        """Events recorded so far. itertools.count can't be peeked, so
        this consumes one ring index and compensates in the returned
        total; the consumed slot's timestamp is zeroed so decode reads
        it as empty (after the ring wraps it would otherwise still hold
        a record from one full generation earlier — a spurious ancient
        event in every export)."""
        idx = next(self.ctr)
        off = (idx & self.mask) * RECSZ
        self.buf[off:off + 8] = _ZERO8
        n = idx - self._peeked
        self._peeked += 1
        return n

    def snapshot(self, stats_only: bool = False) -> dict:
        n = self.count()
        snap = {
            "pid": os.getpid(),
            "proc": _proc_name,
            "cap": self.cap,
            "recorded": n,   # same key stats() uses — one snapshot shape
            "dropped": max(0, n - self.cap),
            "bad": self.bad,
            "mono_ns": time.monotonic_ns(),
            "wall_ns": time.time_ns(),
            "counters": dict(counters),
        }
        if not stats_only:
            snap["buf"] = bytes(self.buf)
        return snap


def decode(buf: bytes) -> list[tuple]:
    """Ring bytes -> [(ts_ns, code, tid, a0, a1, a2, a3)] sorted by ts.
    Empty slots (ts == 0) are skipped; a record mid-overwrite at capture
    time can tear (diagnostic tool, not a transactional log) — unknown
    codes are dropped at export."""
    out = []
    for off in range(0, len(buf) - RECSZ + 1, RECSZ):
        rec = RECORD.unpack_from(buf, off)
        if rec[0]:
            out.append(rec)
    out.sort(key=lambda r: r[0])
    return out


# --------------------------------------------------------------------- #
# module singleton + hot-path emit
# --------------------------------------------------------------------- #

_rec: Optional[FlightRecorder] = None
_resolved = False
_proc_name = ""

#: cheap module-level monotonic counters maintained by instrumented
#: subsystems (channel endpoints open/close feed the state.summary()
#: active-channel estimate); ints only, mutated under the GIL
counters: dict[str, int] = {"chan_open": 0, "chan_closed": 0}


def _noop(code, a0=0, a1=0, a2=0, a3=0):
    return None


def _make_evt(rec: FlightRecorder):
    # everything the hot path touches lives in closure cells: no
    # attribute lookups, no globals beyond the two clock/tid callables
    pack = RECORD.pack_into
    buf = rec.buf
    mask = rec.mask
    nxt = rec.ctr.__next__
    mono = time.monotonic_ns
    tid = threading.get_ident

    def evt(code, a0=0, a1=0, a2=0, a3=0):
        off = (nxt() & mask) * RECSZ
        try:
            pack(buf, off, mono(), code, tid() & 0xFFFF, a0, a1, a2, a3)
        except (struct.error, OverflowError, TypeError):
            # bad args drop the record, never raise; pack_into may have
            # torn a partial record into the slot — zero its timestamp
            # so decode() reads the slot as empty
            buf[off:off + 8] = _ZERO8
            rec.bad += 1

    return evt


def _ensure() -> Optional[FlightRecorder]:
    global _rec, _resolved, evt, _proc_name
    if _resolved:
        return _rec
    _resolved = True
    if not _proc_name:
        _proc_name = f"pid-{os.getpid()}"
    from .config import cfg
    if cfg.flight_recorder:
        _rec = FlightRecorder(cfg.flight_ring_slots)
        evt = _make_evt(_rec)
    else:
        evt = _noop
    return _rec


def _evt_unresolved(code, a0=0, a1=0, a2=0, a3=0):
    if _ensure() is not None:
        evt(code, a0, a1, a2, a3)


#: THE emit function. Call as ``flight.evt(CODE, a0, a1)`` — module
#: attribute lookup keeps the binding current across enable/disable.
evt = _evt_unresolved


def enabled() -> bool:
    return _ensure() is not None


def set_enabled(flag: bool) -> None:
    """Runtime toggle (tests, the overhead A/B). Enabling after a
    disable starts a fresh ring."""
    global _rec, _resolved, evt
    from .config import cfg
    cfg.override(flight_recorder=bool(flag))
    _resolved = False
    _rec = None
    evt = _evt_unresolved
    _ensure()


def install_for_test(slots: int) -> FlightRecorder:
    """Swap in a fresh recorder with a custom ring size (tests)."""
    global _rec, _resolved, evt
    _resolved = True
    _rec = FlightRecorder(slots)
    evt = _make_evt(_rec)
    return _rec


def set_proc_name(name: str) -> None:
    global _proc_name
    _proc_name = name


def proc_name() -> str:
    return _proc_name or f"pid-{os.getpid()}"


def chan_opened(n: int = 1) -> None:
    counters["chan_open"] += n


def chan_closed(n: int = 1) -> None:
    counters["chan_closed"] += n


def snapshot(stats_only: bool = False) -> Optional[dict]:
    """This process's ring + stats (None when the recorder is off)."""
    r = _ensure()
    if r is None:
        return None
    return r.snapshot(stats_only)


def pull_reply(msg: dict) -> dict:
    """The ``flight_ring`` answer to a ``flight_pull`` frame — the one
    place the protocol-v5 reply payload is built (worker loop and
    driver conn loop both send exactly this)."""
    return {"t": "flight_ring", "nonce": msg["nonce"],
            "snap": snapshot(msg.get("stats_only", False)) or stats()}


def stats() -> dict:
    """Recorder health for state.summary(): recorded/dropped/bad plus
    the channel-endpoint counters. Works (all zeros) when disabled."""
    r = _ensure()
    base = {"proc": proc_name(), "pid": os.getpid(),
            "enabled": r is not None, "recorded": 0, "dropped": 0,
            "bad": 0, "ring_slots": 0,
            "mono_ns": time.monotonic_ns(), "wall_ns": time.time_ns()}
    if r is not None:
        n = r.count()
        base.update(recorded=n, dropped=max(0, n - r.cap), bad=r.bad,
                    ring_slots=r.cap)
    base["counters"] = dict(counters)
    return base


# --------------------------------------------------------------------- #
# chrome-trace / Perfetto export
# --------------------------------------------------------------------- #

def export_chrome(snaps: list[dict], since_ns: int = 0) -> dict:
    """Stitch per-process snapshots into one Chrome-trace object.

    Each snapshot may carry ``offset_ns`` (remote monotonic minus head
    monotonic, estimated by flight_collect through the wall-clock
    bridge — (their mono − their wall) − (our mono − our wall), NOT the
    pull round-trip midpoint, which transport queueing would skew);
    exported timestamps are remote_ts - offset, i.e. head-clock
    microseconds. Channel seal/wake records additionally emit chrome
    flow events (``ph: s/f``) keyed on (chan48, seq) so Perfetto draws
    the producer->consumer arrow for every message — the per-token
    seal->wake edge on a decode stream."""
    events: list[dict] = []
    for snap in snaps:
        if snap is None or "buf" not in snap:
            continue
        pid = snap["pid"]
        off = int(snap.get("offset_ns", 0))
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": snap.get("proc") or f"pid-{pid}"}})
        for ts, code, tid, a0, a1, a2, a3 in decode(snap["buf"]):
            meta = CODES.get(code)
            if meta is None:
                continue   # torn/unknown record
            if ts - off < since_ns:
                continue   # head-clock cutoff (bench --trace windows)
            name, cat, ph, flow, argnames = meta
            us = (ts - off) / 1000.0
            args = {}
            for k, v in zip(argnames, (a0, a1, a2, a3)):
                args[k] = v
            if code == TASK_STATE:
                args["state"] = _TASK_STATE_NAMES.get(args.get("state"),
                                                      args.get("state"))
            ev = {"name": name, "cat": cat, "ph": ph, "pid": pid,
                  "tid": tid, "ts": us, "args": args}
            if ph == "i":
                ev["s"] = "t"
            events.append(ev)
            if flow is not None:
                fid = ((a0 & 0xFFFFFFFF) << 32) | (a1 & 0xFFFFFFFF)
                fev = {"name": "chan", "cat": "flow", "ph": flow,
                       "pid": pid, "tid": tid, "ts": us, "id": fid}
                if flow == "f":
                    fev["bp"] = "e"
                events.append(fev)
    events.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def capture_report(rt, since_ns: int, out_path: str) -> dict:
    """bench --trace helper: collect+export the cluster flight trace
    since ``since_ns`` (head monotonic), write it to ``out_path``, and
    return the wait/dispatch breakdown for the printed report. With no
    runtime (cluster-less benches driving an engine in-process), exports
    this process's ring alone."""
    import json
    if rt is not None:
        trace = rt.flight_timeline(since_ns=since_ns)
    else:
        snap = snapshot()
        snaps = [dict(snap, offset_ns=0)] if snap else []
        trace = export_chrome(snaps, since_ns=since_ns)
    with open(out_path, "w") as f:
        json.dump(trace, f)
    return breakdown(trace)


def breakdown(trace: dict) -> dict:
    """Wait/dispatch summary of an exported trace (the bench --trace
    report): per-category time spent parked in store waits / credit
    waits, counts of control flushes, channel messages and dispatches.
    B/E pairs are matched per (pid, tid, name); unmatched ends (ring
    truncation) are ignored."""
    waits = {"store_wait": 0.0, "chan_credit": 0.0}
    counts = {"ctrl_flush": 0, "chan_seal": 0, "chan_wake": 0,
              "serve_dispatch": 0, "task_state": 0, "sched_pass": 0}
    open_b: dict[tuple, float] = {}
    for ev in trace.get("traceEvents", []):
        name, ph = ev.get("name"), ev.get("ph")
        if name in counts and ph in ("i", "B"):
            counts[name] += 1
        if name not in waits:
            continue
        key = (ev.get("pid"), ev.get("tid"), name)
        if ph == "B":
            open_b[key] = ev["ts"]
        elif ph == "E":
            t0 = open_b.pop(key, None)
            if t0 is not None:
                waits[name] += max(0.0, ev["ts"] - t0)
    return {
        "wait_s": {k: v / 1e6 for k, v in waits.items()},
        "counts": counts,
        "events": sum(1 for e in trace.get("traceEvents", [])
                      if e.get("ph") != "M"),
    }
