"""Live stack capture + wait beacons — the "what is this process doing
RIGHT NOW" half of the observability stack (the stall doctor).

The flight recorder (core/flight.py) answers "what happened"; nothing in
it answers "why is this process hung *at this moment*" — the question
behind the repo's recurring failure class: workers parked forever in
channel waits on a dead peer, shutdown joining a wedged executor thread,
a rollout runner starved of credits. Reference parity: ``ray stack``
(py-spy over every worker) and the dashboard's hung-task views backed by
the GCS task-event store; TorchTitan makes the same case for production
training stacks — hang diagnosis must be built in and always-on.

Three pieces live here:

- **Capture** (:func:`capture`): every thread of THIS process via
  ``sys._current_frames()``, annotated with what the runtime knows —
  the task the thread is executing, the object/channel it is parked on
  (wait beacons), thread names — serialized as plain dicts so the head
  can pull them over the control plane (protocol-v6 ``stack_dump`` /
  ``stack_reply`` frames, answered from the per-connection recv threads
  exactly like ``flight_pull``, so a dump succeeds even when the
  target's executor threads are wedged).

- **Wait beacons**: each thread owns ONE preallocated 10-slot list
  (``[kind, id48, n, since_ns, task48]`` plus the continuation slots
  documented at the layout constants below) registered in a module
  table. The wait hot paths (``os_wait_sealed`` / ``os_chan_get`` call
  sites in object_store.py, the ack waits in dag/channel.py) write the
  slots before parking and zero ``kind`` after — no allocation, no
  locks, no strings on the hot path (same budget discipline as
  ``flight.evt``). A beacon turns an opaque native futex wait into
  "parked 3.2s on channel 0x8a1f… slot" in a stack report.

- **Channel endpoint tables**: producers note themselves per channel
  base (one dict store per write/ack — and at RingWriter/RingReader
  construction, so a never-written deadlocked channel still resolves).
  The head folds beacons + these tables + its object directory into a
  waiter→producer wait graph and runs cycle detection
  (Runtime.hang_report) — a constructed two-channel wait cycle names
  both parties instead of hanging silently.

Surfaced as ``state.stack_report()`` / ``state.hang_report()``,
``python -m ray_tpu_torch.cli stack [--all]`` and ``cli doctor``, dashboard
``GET /api/stacks``.
"""
from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Any, Optional

from . import flight

# --------------------------------------------------------------------- #
# wait beacons
# --------------------------------------------------------------------- #

# beacon kinds (slot 0); 0 = not waiting
WAIT_NONE = 0
WAIT_OBJ = 1    # os_wait_sealed over object ids (get/wait bulk paths)
WAIT_GET = 2    # blocking os_get on one object id
WAIT_CHAN = 3   # os_chan_get on a channel data slot
WAIT_ACK = 4    # credit/ack wait (channel ring backpressure)

KIND_NAMES = {WAIT_OBJ: "object_wait", WAIT_GET: "object_get",
              WAIT_CHAN: "channel_recv", WAIT_ACK: "channel_credit"}

# beacon slots: [kind, id48, n, since_ns, task48,
#                prev_kind, prev_id48, prev_since_ns, cleared_at_ns,
#                prev_tag]
# Slots 5-9 make `since` survive SLICED waits: the blocking call sites
# park in bounded native slices (200-500ms) and re-arm the beacon per
# slice — re-arming the SAME (kind, id48, tag) within _REARM_GAP_NS of
# the last clear is one logical wait, so it keeps the original since.
# Without this, "parked for_s" caps at one slice length and the
# deadlock detector's sustained-wait gate can never trigger. The `tag`
# disambiguates waits that share a lo48 (channel slot ids share their
# base's first 6 bytes across seqs — a healthy consumer advancing
# seq-by-seq must read as a NEW wait each message, not one ever-growing
# park, or the sustained-wait gate would see phantom deadlocks in
# saturated pipelines).
_B_KIND, _B_ID, _B_N, _B_SINCE, _B_TASK, \
    _B_PKIND, _B_PID, _B_PSINCE, _B_CLEARED, _B_PTAG = range(10)

#: max gap between clear and re-arm still counted as the same logical
#: wait (slices re-arm within microseconds; real re-waits on the same
#: channel base after USING the value take far longer than this)
_REARM_GAP_NS = 50_000_000

_tls = threading.local()
_reg_lock = threading.Lock()
#: tid -> that thread's beacon list (read by capture; written only by
#: the owning thread — slot stores are atomic under the GIL)
_beacons: dict[int, list] = {}

#: channel-base lo48 -> tid of the thread that produces into it (write
#: sites overwrite; endpoint constructors seed an initial guess so a
#: never-written channel still resolves). Acks count as production: the
#: CONSUMER seals acks, so a producer parked in an ack wait resolves to
#: the consumer thread through this same table.
_chan_producers: dict[int, int] = {}
_CHAN_TABLE_MAX = 4096


def beacon() -> list:
    """This thread's beacon (created + registered on first use; every
    later call is one thread-local attribute read)."""
    b = getattr(_tls, "b", None)
    if b is None:
        b = [0, 0, 0, 0, 0, 0, 0, 0, 0, 0]
        _tls.b = b
        with _reg_lock:
            _beacons[threading.get_ident()] = b
    return b


def wait_tag(id_bytes: bytes) -> int:
    """Continuation tag for a waited id: bytes 10:16 — for channel slot
    ids (base[:12] + uint32 seq) this covers the seq, so consecutive
    messages on one channel read as distinct logical waits."""
    return int.from_bytes(id_bytes[10:16], "little")


def set_wait(b: list, kind: int, id48: int, n: int = 1,
             tag: int = 0) -> None:
    """Arm the beacon before parking. Callers pass the list from
    beacon() so the hot path pays no repeated lookup. Re-arming the
    same (kind, id48, tag) right after a clear continues the previous
    logical wait (sliced native parks keep one honest since)."""
    now = time.monotonic_ns()
    if b[_B_PKIND] == kind and b[_B_PID] == id48 and \
            b[_B_PTAG] == tag and now - b[_B_CLEARED] < _REARM_GAP_NS:
        since = b[_B_PSINCE]
    else:
        since = now
        b[_B_PKIND] = kind
        b[_B_PID] = id48
        b[_B_PTAG] = tag
        b[_B_PSINCE] = since
    b[_B_ID] = id48
    b[_B_N] = n
    b[_B_SINCE] = since
    b[_B_KIND] = kind


def clear_wait(b: list) -> None:
    b[_B_CLEARED] = time.monotonic_ns()
    b[_B_KIND] = 0


def set_task(task48: int) -> None:
    """Executor threads mark the task they are running (worker.py task /
    actor-call paths); 0 clears. Rides the same beacon list."""
    beacon()[_B_TASK] = task48


def note_producer(base48: int) -> None:
    """Record this thread as the producer of channel `base48` (called
    per write/ack — one dict store — and at endpoint construction)."""
    if len(_chan_producers) >= _CHAN_TABLE_MAX and \
            base48 not in _chan_producers:
        # bounded: drop the oldest registration (dict preserves insertion
        # order); long-lived processes cycling many channels stay flat.
        # Eviction is rare (>=4096 live bases), so it may take the lock
        # and tolerate a concurrent writer racing the iterator — the
        # common path above stays a single GIL-atomic dict store.
        with _reg_lock:
            try:
                while len(_chan_producers) >= _CHAN_TABLE_MAX:
                    _chan_producers.pop(next(iter(_chan_producers)), None)
            except (StopIteration, RuntimeError):
                pass  # lost the race with a concurrent store; table is
                # near the cap either way, never wrong
    _chan_producers[base48] = threading.get_ident()


# --------------------------------------------------------------------- #
# capture
# --------------------------------------------------------------------- #

def capture(include_stacks: bool = True) -> dict:
    """Snapshot every thread of this process: stack frames (outermost
    first), thread name, the task it is executing, and the wait beacon
    if it is parked in an instrumented wait. Plain dicts/lists only —
    the snapshot crosses the control plane pickled."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    now = time.monotonic_ns()
    with _reg_lock:
        # prune beacons of threads that no longer exist (bounded growth
        # for pools that cycle threads), then snapshot the live ones
        for tid in list(_beacons):
            if tid not in frames:
                del _beacons[tid]
        beacons = {tid: list(b) for tid, b in _beacons.items()}
    threads = []
    for tid, frame in frames.items():
        th: dict[str, Any] = {"tid": tid, "name": names.get(tid, "")}
        b = beacons.get(tid)
        if b is not None:
            if b[_B_KIND]:
                th["wait"] = {
                    "kind": KIND_NAMES.get(b[_B_KIND], str(b[_B_KIND])),
                    "id48": b[_B_ID], "n": b[_B_N],
                    "for_s": max(0.0, (now - b[_B_SINCE]) / 1e9),
                }
            if b[_B_TASK]:
                th["task48"] = b[_B_TASK]
        if include_stacks:
            th["stack"] = [
                (fs.filename, fs.lineno, fs.name, fs.line or "")
                for fs in traceback.extract_stack(frame)]
        threads.append(th)
    threads.sort(key=lambda t: t["tid"])
    return {
        "pid": os.getpid(),
        "proc": flight.proc_name(),
        "mono_ns": now,
        "wall_ns": time.time_ns(),
        "threads": threads,
        "chan_producers": dict(_chan_producers),
    }


def dump_reply(msg: dict) -> dict:
    """The ``stack_reply`` answer to a ``stack_dump`` frame — the one
    place the protocol-v6 reply payload is built (worker recv loop and
    driver conn loop both send exactly this)."""
    return {"t": "stack_reply", "nonce": msg["nonce"],
            "snap": capture(include_stacks=not msg.get("no_stacks",
                                                       False))}


# --------------------------------------------------------------------- #
# formatting (cli stack / cli doctor)
# --------------------------------------------------------------------- #

def _interesting(th: dict) -> bool:
    """A thread worth showing by default: executing a task, parked in an
    instrumented wait, or the main thread."""
    return bool(th.get("wait") or th.get("task48")
                or th.get("name") == "MainThread")


def format_thread(th: dict, indent: str = "  ") -> str:
    head = f"{indent}thread {th['tid']}"
    if th.get("name"):
        head += f" [{th['name']}]"
    if th.get("task"):
        head += f"  task={th['task']}"
    elif th.get("task48"):
        head += f"  task48=0x{th['task48']:012x}"
    w = th.get("wait")
    if w:
        target = w.get("target") or f"0x{w['id48']:012x}"
        head += (f"  << parked {w['for_s']:.1f}s in {w['kind']} "
                 f"on {target}" + (f" (+{w['n'] - 1} more)"
                                   if w.get("n", 1) > 1 else ""))
    lines = [head]
    for fname, lineno, func, code in th.get("stack", ()):
        lines.append(f"{indent}  {fname}:{lineno} in {func}")
        if code:
            lines.append(f"{indent}    {code}")
    return "\n".join(lines)


def format_report(report: dict, show_all: bool = False) -> str:
    """Human-readable cluster stack report (Runtime.stack_report()
    shape). ``show_all`` includes idle/bookkeeping threads; the default
    shows threads executing a task, parked in an instrumented wait, or
    main threads."""
    out = []
    for snap in report.get("procs", []):
        shown = [t for t in snap.get("threads", ())
                 if show_all or _interesting(t)]
        hidden = len(snap.get("threads", ())) - len(shown)
        out.append(f"=== {snap.get('proc') or '?'} "
                   f"(pid {snap.get('pid')}) — {len(snap.get('threads', ()))}"
                   f" threads ===")
        for th in shown:
            out.append(format_thread(th))
        if hidden:
            out.append(f"  ... {hidden} idle threads hidden "
                       f"(--all shows them)")
        out.append("")
    missing = report.get("unresponsive", ())
    if missing:
        out.append("UNRESPONSIVE (no stack reply before the deadline): "
                   + ", ".join(missing))
    return "\n".join(out)


def format_hangs(hangs: dict) -> str:
    """Human-readable hang report (Runtime.hang_report() shape)."""
    out = []
    stuck = hangs.get("stuck_tasks", ())
    if stuck:
        out.append(f"STUCK TASKS ({len(stuck)}):")
        for rec in stuck:
            line = (f"  {rec.get('name')} [{rec.get('task_id', '')[:12]}] "
                    f"on {rec.get('worker')} — running "
                    f"{rec.get('running_s', 0.0):.1f}s "
                    f"(threshold {rec.get('threshold_s', 0.0):.1f}s")
            if rec.get("ewma_s") is not None:
                line += f", typical {rec['ewma_s']:.2f}s"
            out.append(line + ")")
            for th in rec.get("stack", ()):
                out.append(format_thread(th, indent="    "))
    else:
        out.append("no stuck tasks")
    cycles = hangs.get("deadlocks", ())
    if cycles:
        out.append(f"SUSPECTED DEADLOCKS ({len(cycles)}):")
        for cyc in cycles:
            out.append("  cycle:")
            for node in cyc.get("parties", ()):
                out.append(f"    {node.get('proc')} thread "
                           f"{node.get('tid')}"
                           + (f" [{node['thread_name']}]"
                              if node.get("thread_name") else "")
                           + (f" task={node['task']}"
                              if node.get("task") else "")
                           + f" waits {node.get('wait_kind')} on "
                           + f"{node.get('target')}")
    else:
        out.append("no wait-graph cycles")
    wd = hangs.get("watchdog")
    if wd:
        out.append(f"watchdog: {'enabled' if wd.get('enabled') else 'OFF'}"
                   f", {wd.get('scans', 0)} scans, "
                   f"{wd.get('stuck_running', 0)} currently stuck, "
                   f"{wd.get('flagged_total', 0)} flagged total")
    return "\n".join(out)
