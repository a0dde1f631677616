"""Chaos injection for fault-tolerance testing.

Reference parity: python/ray/_private/test_utils.py ResourceKillerActor
:1316 / RayletKiller :1438 and the release chaos suites — utilities that
kill random cluster components at intervals so failure-handling paths
(task retries, actor restarts, lineage reconstruction, agent failover)
get exercised under realistic, unscheduled death instead of hand-placed
kills. The port's copy of ``ray_tpu/util/chaos.py``, over the port's head
``Runtime``: a killed worker's GPU indices go back to its node when the
head's watcher sees its process end (``_release_gpus_locked``), before a
retried task or a restarted actor can lease them again.

    killer = WorkerKiller(kill_interval_s=0.5, max_kills=5)
    killer.start()
    ... run a workload with retries ...
    killer.stop()
    assert killer.stats()["kills"] > 0
"""
from __future__ import annotations

import random
import threading
import time
from typing import Optional


class _KillerBase:
    def __init__(self, kill_interval_s: float = 1.0,
                 max_kills: Optional[int] = None, seed: int = 0,
                 warmup_s: float = 0.0):
        self.kill_interval_s = kill_interval_s
        self.max_kills = max_kills
        self.warmup_s = warmup_s
        self._rng = random.Random(seed)
        self._kills: list[str] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _head(self):
        from ..core import runtime as rt_mod
        rt = rt_mod.get_runtime_if_exists()
        if rt is None or not isinstance(rt, rt_mod.Runtime):
            raise RuntimeError(
                "chaos killers run on the head driver (they pick victims "
                "from the head's component tables)")
        return rt

    def start(self) -> "_KillerBase":
        self._head()  # fail fast off-head
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=type(self).__name__)
        self._thread.start()
        return self

    def _loop(self):
        if self.warmup_s:
            time.sleep(self.warmup_s)
        while not self._stop.is_set():
            if self.max_kills is not None and \
                    len(self._kills) >= self.max_kills:
                return
            try:
                victim = self._kill_one()
            except Exception:
                victim = None
            if victim:
                self._kills.append(victim)
            self._stop.wait(self.kill_interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def stats(self) -> dict:
        return {"kills": len(self._kills), "victims": list(self._kills)}

    def _kill_one(self) -> Optional[str]:  # pragma: no cover - abstract
        raise NotImplementedError


class WorkerKiller(_KillerBase):
    """SIGKILLs a random BUSY worker (one that is executing a task or
    hosting an actor) — the analog of ResourceKillerActor targeting
    worker processes. Retries / actor restarts are what make the
    workload survive; run it with max_retries / max_restarts > 0."""

    def _kill_one(self) -> Optional[str]:
        rt = self._head()
        with rt.lock:
            victims = [w for w in rt.workers.values()
                       if w.state in ("busy", "actor")
                       and w.conn is not None]
            if not victims:
                return None
            w = self._rng.choice(victims)
            wid, proc = w.wid, w.proc
        try:
            proc.kill()
        except Exception:
            return None  # already exited: report no kill
        return wid


class NodeKiller(_KillerBase):
    """Kills a random non-head NODE AGENT process (the RayletKiller
    analog): its workers die with it, its objects become remote-lost,
    and the head's health checks + lineage reconstruction take over."""

    def _kill_one(self) -> Optional[str]:
        rt = self._head()
        with rt.lock:
            victims = [n for n in rt.nodes.values()
                       if n.alive and n.agent is not None]
            if not victims:
                return None
            n = self._rng.choice(victims)
            hexid = n.node_id.hex()
            agent = n.agent
        try:
            agent.send({"t": "shutdown"})
        except Exception:
            return None  # agent already gone: no fault was injected
        return hexid
