"""Block transport for streaming pipelines: sealed-ring edges between
stage actors.

An *edge* connects the P workers of one stage to the C consumers of the
next: P x C independent (data, ack) ring channels (``dag/channel.py``
protocol — ids never reused, credit-based backpressure, one shared
pipeline-wide stop flag). Messages are ``(block_idx, block)`` pairs;
``block_idx`` is the block's position in plan order, which is what lets
a downstream consumer restore the task executor's plan-order delivery
no matter which worker produced the block.

Senders:

* ``stripe`` — block ``idx`` goes to consumer ``idx % C``. Deterministic,
  so an ordered receiver knows exactly which ring its next block arrives
  on (zero reordering state). Used everywhere order is cheap to keep:
  source stages, width-1 stages.
* ``steal`` — block goes to any consumer ring with free credit
  (round-robin preference). Push-mode work stealing: a slow consumer's
  ring fills and traffic flows to the others; when every ring is full the
  sender parks in ONE multi-oid wait over every ring's retiring ack plus
  the stop flag. Used ONLY for ``streaming_split`` shards (sinks hold no
  downstream credit, so stealing cannot form a cycle there).

Receivers:

* ``stripe`` — consumer slot ``c`` owns idxs ``c (mod C)`` and reads
  them in increasing order; idx ``n`` always sits on ring ``n % P``
  (the stripe-sender contract: producer ``p`` owns idxs ``p (mod P)``).
  In-order delivery with immediate acks and no buffering. This is the
  only ordered mode ON PURPOSE: every stage worker processing its own
  idx subsequence in order is what makes the pipeline deadlock-free —
  the worker holding the globally next undelivered idx has already had
  all its earlier outputs delivered and acked, so it always owns output
  credit. (A work-stealing feed with delivery-deferred acks can park a
  worker on output credit while the next-needed block sits unread in
  its input ring — a permanent cycle.)
* ``any`` — first available block from any ring, round-robin fair,
  immediate acks (streaming_split shards: arrival order is fine, and a
  shard is a sink — it holds no downstream credit, so stealing cannot
  cycle).

End-of-stream rides ``dag.channel.seal_eos`` — a per-ring marker object
carrying the final message count, sealed WITHOUT consuming ring credit
(an idle consumer's full ring must never block another shard's EOS). A
ring is exhausted when its EOS is sealed and the cursor reached the
count; since block idxs are contiguous 0..N-1 per edge, the first
missing idx ends an ordered stream.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Optional

from ...core import flight
from ...core import stacks
from ...core.ids import ObjectID
from ...dag.channel import (ChannelClosed, RingWriter, drain_stale_slots,
                            eos_oid, read_eos, send_ack, signal_stop,
                            slot_oid)
from . import telemetry as tm

_WAIT_SLICE_MS = 500


@dataclasses.dataclass(frozen=True)
class EdgeSpec:
    """Picklable wiring for one stage-to-stage edge: the id bases ARE
    the channel (ships to stage actors as a plain value, the
    RolloutQueueSpec pattern)."""

    bases: tuple     # P*C data id bases, row-major [p * consumers + c]
    stop: bytes      # pipeline-wide stop flag oid bytes (shared)
    producers: int
    consumers: int
    ring: int        # per-(p,c) credit window, in blocks

    @classmethod
    def create(cls, producers: int, consumers: int, ring: int,
               stop: bytes) -> "EdgeSpec":
        return cls(bases=tuple(os.urandom(16)
                               for _ in range(producers * consumers)),
                   stop=stop, producers=producers, consumers=consumers,
                   ring=max(1, ring))

    def base(self, p: int, c: int) -> bytes:
        return self.bases[p * self.consumers + c]

    def stop_oid(self) -> ObjectID:
        return ObjectID(self.stop[:ObjectID.SIZE])


class BlockSender:
    """Producer end of an edge for ONE stage worker: fans blocks out
    over this worker's C rings."""

    def __init__(self, store, edge: EdgeSpec, producer_idx: int,
                 mode: str = "stripe"):
        if mode not in ("stripe", "steal"):
            raise ValueError(f"unknown sender mode {mode!r}")
        self.edge = edge
        self.mode = mode
        self.store = store
        stop = edge.stop_oid()
        self._writers = [RingWriter(store, edge.base(producer_idx, c),
                                    stop, edge.ring)
                         for c in range(edge.consumers)]
        self._rr = 0   # steal mode: next consumer favoured
        self._stop = stop

    def closed(self) -> bool:
        return self.store.contains(self._stop)

    def send(self, idx: int, block: Any,
             timeout_s: Optional[float] = None) -> None:
        if self.mode == "stripe":
            w = self._writers[idx % self.edge.consumers]
            if not w.credit_ready():
                tm.note_backpressure()
            w.write((idx, block), timeout_s)
            return
        # steal: first consumer ring with credit, rotating from the last
        # one served so a fast consumer can't monopolize the stream
        n = len(self._writers)
        order = [(self._rr + k) % n for k in range(n)]
        for c in order:
            if self._writers[c].credit_ready():
                self._rr = (c + 1) % n
                self._writers[c].write((idx, block), timeout_s)
                return
        # every ring full: ONE multi-oid park over each ring's retiring
        # ack + the stop flag, then retry whichever freed
        tm.note_backpressure()
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        while True:
            acks = [w.pending_ack_oid() for w in self._writers]
            oids = [a for a in acks if a is not None] + [self._stop]
            slice_ms = _WAIT_SLICE_MS
            if deadline is not None:
                from ...core.object_store import GetTimeoutError
                remain = deadline - time.monotonic()
                if remain <= 0:
                    raise GetTimeoutError(
                        "timed out waiting for consumer credit")
                slice_ms = max(1, min(slice_ms, int(remain * 1000)))
            sealed = self.store.wait_sealed(oids, 1, slice_ms)
            if sealed[-1]:
                raise ChannelClosed("pipeline stop flag sealed")
            for c in order:
                if self._writers[c].credit_ready():
                    self._rr = (c + 1) % n
                    self._writers[c].write((idx, block), timeout_s)
                    return

    def finish(self, timeout_s: Optional[float] = None) -> None:
        """End the stream on every ring: TWO phases, not a per-ring
        RingWriter.finish() loop. Every consumer's EOS must seal before
        ANY consumer's acks are awaited — a sequential finish parks on
        consumer 0's trailing acks while consumer 1 has no EOS yet, so
        split shards consumed in reverse order would deadlock (the
        documented any-order contract). After both phases the edge owns
        zero store objects."""
        from ...dag.channel import seal_eos
        for w in self._writers:
            seal_eos(self.store, w.base, w.seq)
        for w in self._writers:
            w.drain_trailing(timeout_s)

    def sweep(self) -> None:
        """Teardown (stop sealed / error exit): delete this worker's
        unconsumed slots, trailing acks and EOS markers."""
        for w in self._writers:
            drain_stale_slots(self.store, [w.base, w.ack_base],
                              w.seq - self.edge.ring - 1,
                              w.seq + self.edge.ring, eos=True)


class _RingCursor:
    """Consumer-side view of one (producer, consumer) ring."""

    __slots__ = ("base", "ack_base", "seq", "count")

    def __init__(self, base: bytes):
        from ...dag.channel import ack_base_for
        self.base = base
        self.ack_base = ack_base_for(base)
        self.seq = 0
        self.count: Optional[int] = None   # final count once EOS observed

    def exhausted(self) -> bool:
        return self.count is not None and self.seq >= self.count


class BlockReceiver:
    """Consumer end of an edge for ONE consumer slot. ``mode`` is
    "stripe" / "reorder" (ordered delivery, C==1) or "any" (arrival
    order)."""

    def __init__(self, store, edge: EdgeSpec, consumer_idx: int,
                 mode: str = "stripe", zero_copy: Optional[bool] = None):
        if mode not in ("stripe", "any"):
            raise ValueError(f"unknown receiver mode {mode!r}")
        self.edge = edge
        self.mode = mode
        self.store = store
        self.zero_copy = zero_copy
        self.stop = edge.stop_oid()
        self._rings = [_RingCursor(edge.base(p, consumer_idx))
                       for p in range(edge.producers)]
        # stripe: this consumer owns idxs consumer_idx (mod C), in order
        self._next = consumer_idx
        self._step = edge.consumers
        self._rr = 0            # any: round-robin start
        self._delivered = 0
        for rc in self._rings:
            stacks.note_producer(flight.lo48(rc.ack_base))  # acks seal here

    # -- shared helpers ------------------------------------------------- #

    def _observe_eos(self, rc: _RingCursor) -> None:
        if rc.count is None:
            n = read_eos(self.store, rc.base)
            if n is not None:
                rc.count = n
                # EOS ack: tells the producer its marker was seen, so IT
                # can delete it (producer owns every object it created;
                # a consumer-side delete would race other observers)
                from ...dag.channel import EOS_SEQ
                send_ack(self.store, rc.ack_base, EOS_SEQ)

    def _read(self, rc: _RingCursor, ack: bool) -> Any:
        """Consume rc's next (already sealed) slot and delete it. A
        failing stage seals the stop flag and then sweeps the slots it
        wrote, so a slot seen sealed may be gone by the read: that read
        raises ChannelClosed, which surfaces the stage's own error."""
        from ...core.object_store import GetTimeoutError
        oid = slot_oid(rc.base, rc.seq)
        try:
            val = self.store.get(oid, timeout_ms=5000,
                                 zero_copy=self.zero_copy)
        except GetTimeoutError:
            if self.store.contains(self.stop):
                raise ChannelClosed("pipeline stop flag sealed") from None
            raise
        flight.evt(flight.CHAN_WAKE, flight.lo48(rc.base), rc.seq)
        self.store.delete(oid)
        if ack:
            send_ack(self.store, rc.ack_base, rc.seq)
        rc.seq += 1
        return val

    def _wait(self, oids: list, timeout_s, deadline, on_idle) -> list:
        slice_ms = _WAIT_SLICE_MS
        if deadline is not None:
            from ...core.object_store import GetTimeoutError
            remain = deadline - time.monotonic()
            if remain <= 0:
                raise GetTimeoutError(
                    "timed out waiting for a pipeline block")
            slice_ms = max(1, min(slice_ms, int(remain * 1000)))
        sealed = self.store.wait_sealed(oids, 1, slice_ms)
        if not any(sealed) and on_idle is not None:
            on_idle()
        return sealed

    def done(self) -> bool:
        return all(rc.exhausted() for rc in self._rings)

    # -- delivery ------------------------------------------------------- #

    def next_block(self, timeout_s: Optional[float] = None,
                   on_idle=None) -> Optional[tuple[int, Any]]:
        """The next ``(idx, block)`` pair, or None at end of stream.
        Stripe delivers this consumer's idx subsequence in ascending
        order; "any" delivers arrival order. Raises ChannelClosed when
        the pipeline stop flag seals, GetTimeoutError past the deadline;
        ``on_idle`` runs between wait slices (the driver's stage-death
        probe)."""
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        if self.mode == "stripe":
            return self._next_stripe(timeout_s, deadline, on_idle)
        return self._next_any(timeout_s, deadline, on_idle)

    def _next_stripe(self, timeout_s, deadline, on_idle):
        n = self._next
        rc = self._rings[n % len(self._rings)]
        # contiguity: global idxs are 0..N-1, so if ring (n mod P) is
        # exhausted before yielding n, idx n does not exist anywhere —
        # this consumer's stream is complete
        while True:
            self._observe_eos(rc)
            if rc.exhausted():
                self._observe_all_eos(timeout_s, deadline, on_idle)
                return None
            oids = [slot_oid(rc.base, rc.seq)]
            if rc.count is None:
                oids.append(eos_oid(rc.base))
            oids.append(self.stop)
            sealed = self._wait(oids, timeout_s, deadline, on_idle)
            if sealed[0]:
                val = self._read(rc, ack=True)
                self._next = n + self._step
                self._delivered += 1
                return val
            if sealed[-1]:
                raise ChannelClosed("pipeline stop flag sealed")
            # middle oid (EOS) sealed, or slice expired: loop re-checks

    def _next_any(self, timeout_s, deadline, on_idle):
        n = len(self._rings)
        while True:
            live_idx = []
            oids = []
            for i, rc in enumerate(self._rings):
                self._observe_eos(rc)
                if rc.exhausted():
                    continue
                live_idx.append(i)
                oids.append(slot_oid(rc.base, rc.seq))
                if rc.count is None:
                    oids.append(eos_oid(rc.base))
            if not live_idx:
                return None
            oids.append(self.stop)
            sealed = self._wait(oids, timeout_s, deadline, on_idle)
            ready = []
            pos = 0
            for i in live_idx:
                if sealed[pos]:
                    ready.append(i)
                pos += 1 if self._rings[i].count is not None else 2
            if ready:
                i = min(ready, key=lambda j: (j - self._rr) % n)
                self._rr = (i + 1) % n
                val = self._read(self._rings[i], ack=True)
                self._delivered += 1
                return val
            if sealed[-1]:
                raise ChannelClosed("pipeline stop flag sealed")

    def _observe_all_eos(self, timeout_s, deadline, on_idle) -> None:
        """Stripe end-of-stream pass: every producer's finish() parks on
        its EOS ack, so the rings the stripe cursor never returned to
        still need their markers observed and acked. By the time idx n
        is known missing, every producer has delivered its last block
        and is sealing (or has sealed) EOS — this completes promptly."""
        for rc in self._rings:
            while rc.count is None:
                self._observe_eos(rc)
                if rc.count is not None:
                    break
                sealed = self._wait([eos_oid(rc.base), self.stop],
                                    timeout_s, deadline, on_idle)
                if sealed[1] and not sealed[0]:
                    raise ChannelClosed("pipeline stop flag sealed")

    # -- introspection / teardown --------------------------------------- #

    def depth(self) -> int:
        """Sealed-but-unread blocks across this consumer's rings
        (bounded probe: ring credit per producer). Telemetry only."""
        oids = [slot_oid(rc.base, rc.seq + k)
                for rc in self._rings if not rc.exhausted()
                for k in range(self.edge.ring)]
        if not oids:
            return 0
        return len(self.store.wait_sealed_indices(oids, 0, 0))

    def sweep(self) -> None:
        """Teardown sweep around every cursor: unread slots (credit
        bounds them to the window), this consumer's trailing acks and
        EOS markers."""
        for rc in self._rings:
            drain_stale_slots(self.store, [rc.base, rc.ack_base],
                              rc.seq - self.edge.ring - 1,
                              rc.seq + self.edge.ring, eos=True)


def stop_pipeline(store, edge_or_stop) -> None:
    """Seal the shared stop flag: every parked read/credit wait in the
    pipeline wakes with ChannelClosed."""
    stop = (edge_or_stop.stop_oid()
            if isinstance(edge_or_stop, EdgeSpec) else edge_or_stop)
    signal_stop(store, stop)
