"""Head-side pub/sub with long-poll subscribers.

Reference parity: the GCS pubsub module (src/ray/pubsub/publisher.h:300
Publisher, subscriber.h:73 SubscriberChannel) — long-poll based fan-out of
control-plane notifications (actor/node/job lifecycle) to any process in
the cluster.

Design: the head keeps a bounded per-channel ring of (seq, message); a
subscriber long-polls with its cursor via the worker→head RPC channel and
receives everything newer (or blocks until something arrives / timeout).
Cursor-based polling makes delivery at-least-once and restart-safe; a
subscriber that lags more than the ring size observes a gap (returned in
the reply) rather than silently losing its place — same contract as the
reference's publisher buffer eviction.

Built-in channels (published by the runtime):
  actors  — {"actor_id", "state": "alive"|"restarting"|"dead", "name", ...}
  nodes   — {"node_id", "event": "added"|"removed", "name"}
  jobs    — {"job_id", "status"}
"""
from __future__ import annotations

import threading
import time
from collections import deque


class Publisher:
    RING = 1000

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._channels: dict[str, deque] = {}
        self._seq: dict[str, int] = {}

    def publish(self, channel: str, message: dict) -> int:
        with self._lock:
            ring = self._channels.setdefault(
                channel, deque(maxlen=self.RING))
            seq = self._seq.get(channel, 0) + 1
            self._seq[channel] = seq
            ring.append((seq, dict(message, _seq=seq, _ts=time.time())))
            self._cv.notify_all()
            return seq

    def poll(self, channel: str, cursor: int = 0,
             timeout_s: float = 20.0) -> dict:
        """Messages with seq > cursor; blocks up to timeout_s when none.
        Returns {"cursor", "messages", "gap"} — gap=True when the ring
        evicted messages the caller never saw."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._lock:
            while True:
                ring = self._channels.get(channel, ())
                msgs = [m for s, m in ring if s > cursor]
                if msgs:
                    oldest = ring[0][0]
                    return {"cursor": msgs[-1]["_seq"], "messages": msgs,
                            "gap": cursor + 1 < oldest}
                remain = deadline - time.monotonic()
                if remain <= 0:
                    return {"cursor": cursor, "messages": [], "gap": False}
                self._cv.wait(remain)


class Subscriber:
    """Client-side cursor wrapper; works on the head (direct) and in
    workers/driver clients (via the pubsub_poll head RPC)."""

    def __init__(self, channel: str):
        from . import runtime as rt_mod
        self.channel = channel
        self.cursor = 0
        rt = rt_mod.get_runtime_if_exists()
        if rt is None:
            raise RuntimeError("ray_tpu_torch.init() has not been called")
        self._rt = rt

    def poll(self, timeout_s: float = 20.0) -> list[dict]:
        rt = self._rt
        if hasattr(rt, "pubsub"):  # head
            reply = rt.pubsub.poll(self.channel, self.cursor, timeout_s)
        else:
            reply = rt._rpc("pubsub_poll", self.channel, self.cursor,
                            timeout_s, timeout=timeout_s + 15.0)
        self.cursor = reply["cursor"]
        return reply["messages"]
