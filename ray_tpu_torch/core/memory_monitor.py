"""Host memory monitor + OOM worker-killing policy.

Reference parity: the raylet memory monitor (common/memory_monitor.h:52 —
polls cgroup/system usage, fires a callback over threshold) and its
worker-killing policies (raylet/worker_killing_policy.h: prefer
RETRIABLE tasks, newest first, so the task most likely to succeed later
dies instead of long-running work).

When host usage crosses ``cfg.memory_usage_threshold`` the monitor kills
one victim per tick: the most-recently-dispatched busy worker whose task
has retries left (it will be re-queued by the normal worker-crash path);
if none is retriable, the newest busy worker dies anyway — trading one
task failure for host survival (the reference does the same, annotating
the error as an OOM kill).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional


def system_memory_usage() -> float:
    """Fraction of host memory in use, from /proc/meminfo (no psutil in
    the image). MemAvailable is the kernel's own reclaimable estimate."""
    total = avail = None
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                total = int(line.split()[1])
            elif line.startswith("MemAvailable:"):
                avail = int(line.split()[1])
            if total is not None and avail is not None:
                break
    if not total or avail is None:
        return 0.0
    return 1.0 - avail / total


def pick_victim(workers: list) -> Optional[object]:
    """Worker-killing policy over WorkerInfo-shaped objects (state,
    current TaskSpec with retries_left, dispatch order by .current
    started implicit in list order): retriable-newest first, else
    newest busy."""
    busy = [w for w in workers
            if w.state == "busy" and w.current is not None]
    if not busy:
        return None
    retriable = [w for w in busy if w.current.retries_left > 0]
    pool = retriable or busy
    return pool[-1]  # newest dispatch (callers pass dispatch-ordered)


class MemoryMonitor:
    def __init__(self, runtime, threshold: Optional[float] = None,
                 period_s: Optional[float] = None,
                 usage_fn: Callable[[], float] = system_memory_usage):
        from .config import cfg
        self.rt = runtime
        self.threshold = (cfg.memory_usage_threshold
                          if threshold is None else threshold)
        self.period_s = (cfg.memory_monitor_refresh_ms / 1000.0
                         if period_s is None else period_s)
        self.usage_fn = usage_fn
        self.kills = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MemoryMonitor":
        if self.period_s > 0 and self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="rtpu-memmon")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def _loop(self):
        while not self._stop.wait(self.period_s):
            try:
                self.tick()
            except Exception:
                pass  # monitor outlives a bad poll (/proc races)

    def tick(self) -> bool:
        """One check; returns True if a worker was killed."""
        usage = self.usage_fn()
        if usage < self.threshold:
            return False
        rt = self.rt
        with rt.lock:
            # dispatch order ≈ insertion order of the workers dict.
            # Victims come from THIS host only — the monitor reads head-
            # host /proc/meminfo, and killing a remote agent's worker
            # would not relieve it (per-node monitoring is the node
            # agent's job on a multi-host cluster)
            head_nid = rt.head_node.node_id
            victim = pick_victim([w for w in rt.workers.values()
                                  if w.node_id == head_nid])
            if victim is None:
                return False
            name = victim.current.name if victim.current else "?"
            wid = victim.wid
        self.kills += 1
        rt.pubsub.publish("oom", {
            "worker": wid, "task": name, "usage": round(usage, 4)})
        rt.events.append({"name": f"oom_kill:{name}", "cat": "oom",
                          "ph": "i", "pid": wid, "ts": time.time() * 1e6})
        try:
            victim.proc.kill()  # worker-crash path retries/report
        except Exception:
            return False
        return True
