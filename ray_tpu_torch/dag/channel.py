"""Sealed ring channels — the event-driven shm transport behind compiled
DAGs and the serve static decode plan.

Protocol (replaces the delete-and-recreate polling transport):

- A channel is a pair of 12-byte id *bases* (``data``, ``ack``); message
  ``seq`` lives at ``ObjectID(base[:12] + uint32le(seq))``. Ids are unique
  for the channel's lifetime (4B seqs), so a slot is never rewritten under
  an id a stale reader might still pin — which is what makes **zero-copy**
  reads safe here (the old transport recreated the SAME id every ring pass
  and had to force the copy path; see store.get's zero_copy note).
- The producer seals slot ``seq``; the consumer parks in ONE
  ``os_wait_sealed`` futex wait over ``{data[seq], stop}`` and wakes the
  instant either seals — no 100ms ``store.get`` poll slices, no
  ``contains(stop)`` probe per slice.
- After reading, the consumer deletes the data slot (lazy if zero-copy
  views still pin it — harmless, the id is never reused).
- **Backpressure** is credit-based and optional: a FREE-RUNNING producer
  (serve decode streams) writing ``seq`` first waits on
  ``{ack[seq - ring], stop}`` — the consumer seals the tiny ack object
  for each message it reads — and deletes the observed ack; that retires
  the ring position and bounds the channel to ``ring`` in-flight
  messages without any delete-and-recreate. Driver-PACED pipelines
  (compiled DAGs) skip acks entirely: the driver only feeds input ``n``
  after draining output ``n - ring``, which already proves every edge
  consumed ``n - ring`` (all nodes are ancestors of the output node).
- Teardown seals ``stop`` in every participating store; every parked
  wait in the channel wakes and raises :class:`ChannelClosed`.

- **Multi-producer fan-in** (:class:`MultiRingReader`): N producers each
  own a (data, ack) base pair sharing one stop flag; the consumer parks
  in ONE ``os_wait_sealed`` over {every producer's next slot, stop} and
  services whichever seals first, acking per-producer so credit windows
  stay independent (rl/podracer's RolloutQueue rides this).

Cross-store edges: data pushes into the consumer's store and acks push
back into the producer's (``object_transfer.push_object``); same-store
edges are plain seals. Channel objects are invisible to the head's object
directory on purpose — lifetime is fully owned by the seal/ack handshake.

The port's copy of ``ray_tpu/dag/channel.py``, over the port's store
(``core/object_store.py``: a CUDA tensor in a message travels as its
host copy). The adapter registry (``llm/multilora/registry.py``) also
seals adapter version ``v`` at ``slot_oid(base, v)``.
"""
from __future__ import annotations

import struct
import time
from typing import Any, Optional

from ..core.ids import ObjectID
from ..core import flight
from ..core import stacks

# how long one futex park lasts before the waiter re-checks its deadline
# and (optionally) its liveness callback; a seal/stop wakes it instantly
# regardless, so this bounds failure detection latency, not throughput
_WAIT_SLICE_MS = 500


class ChannelClosed(Exception):
    """The channel's stop flag sealed while waiting (teardown/cancel)."""


def slot_oid(base: bytes, seq: int) -> ObjectID:
    return ObjectID(base[:12] + struct.pack("<I", seq & 0xFFFFFFFF))


# Sequence number reserved for the end-of-stream marker. Writers allocate
# seqs from 0 upward and a channel never lives long enough to reach it, so
# the id can't collide with a data slot.
EOS_SEQ = 0xFFFFFFFF


def eos_oid(base: bytes) -> ObjectID:
    """The end-of-stream marker id for a channel. Unlike a sentinel
    message, sealing it needs NO ring credit — a producer can always end
    a stream even when every data slot is un-acked (the data.streaming
    fan-out writers depend on that: EOS for an idle consumer must not
    wait on that consumer's credit)."""
    return slot_oid(base, EOS_SEQ)


def seal_eos(store, base: bytes, count: int,
             push_addr: Optional[str] = None) -> None:
    """Seal the end-of-stream marker carrying the final message count.
    Consumers treat a ring as exhausted once ``eos`` is sealed AND their
    cursor reached ``count``."""
    oid = eos_oid(base)
    flight.evt(flight.CHAN_SEAL, flight.lo48(base), EOS_SEQ)
    if push_addr is not None:
        from ..core.object_transfer import push_object
        push_object(push_addr, oid, value=int(count))
        return
    try:
        store.put(oid, int(count))
    except FileExistsError:
        pass  # idempotent (teardown retry)


def read_eos(store, base: bytes) -> Optional[int]:
    """Non-blocking: the final message count if EOS sealed, else None."""
    from ..core.object_store import GetTimeoutError
    try:
        return int(store.get(eos_oid(base), timeout_ms=0))
    except GetTimeoutError:
        return None


def ack_base_for(base: bytes) -> bytes:
    """The ack-channel id base paired with a data base (derived, so only
    the data base needs plumbing through plans and channel specs)."""
    import hashlib
    return hashlib.sha1(base + b"/ack").digest()[:16]


def _store_frame(store, oid: ObjectID, frame) -> None:
    """Write a pre-serialized _FramedValue under `oid` (serialize once,
    fan out to many targets)."""
    buf = store.create_raw(oid, frame.total)
    frame.write_into(buf)
    del buf
    store.seal(oid)


def write_slot(store, base: bytes, seq: int, value: Any = None,
               frame=None, push_addr: Optional[str] = None) -> None:
    """Seal message `seq` into the channel. With `push_addr`, the value
    lands in the remote store behind it (cross-store edge); `frame` is an
    optional pre-built _FramedValue shared across fan-out targets."""
    oid = slot_oid(base, seq)
    # the producer half of the per-message seal->wake flow edge: the
    # consumer's CHAN_WAKE carries the same (chan48, seq) pair, which is
    # what lets the exporter draw the cross-process arrow. Recorded
    # BEFORE the physical seal: the consumer wakes the instant the seal
    # lands, so stamping afterwards would let a descheduled producer
    # record its seal LATER than the wake that consumed it — the edge
    # must stay ordered on a shared clock
    b48 = flight.lo48(base)
    flight.evt(flight.CHAN_SEAL, b48, seq)
    # producer endpoint registration (one dict store): the wait-graph
    # deadlock fold resolves "thread X parked on channel C" to THIS
    # thread through it (stacks.py)
    stacks.note_producer(b48)
    if push_addr is not None:
        from ..core.object_store import _FramedValue
        from ..core.object_transfer import push_object
        if frame is None:
            frame = _FramedValue(value, False)
        if not push_object(push_addr, oid, frame=frame):
            raise RuntimeError(
                f"channel push to {push_addr} rejected (store full?)")
    elif frame is not None:
        _store_frame(store, oid, frame)
    else:
        store.put(oid, value)


def read_slot(store, base: bytes, seq: int, stop_oid: ObjectID,
              timeout_s: Optional[float] = None,
              zero_copy: Optional[bool] = None,
              ack_base: Optional[bytes] = None,
              ack_push_addr: Optional[str] = None, on_idle=None) -> Any:
    """Consume message `seq`: block on {data, stop}, read, delete the
    slot, optionally ack.

    The block+read is ONE stop-aware native call (os_chan_get) — same
    cost as a plain blocking get, and teardown wakes it instantly.
    Raises ChannelClosed if the stop flag seals with no data present
    (data wins over a concurrent stop: drain, then close). `on_idle`
    runs between wait slices — liveness probes ("did the producing actor
    die?") hook in there and may raise. The delete is lazy while
    zero-copy views pin the payload — safe, the id is never reused.
    With `ack_base`, the 1-byte ack for `seq` seals into the producer's
    store (free-running producers need it for ring backpressure;
    driver-paced DAGs don't — the output auto-drain already bounds every
    edge to the ring)."""
    from ..core.object_store import ChannelStopped, GetTimeoutError
    oid = slot_oid(base, seq)
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while True:
        slice_ms = _WAIT_SLICE_MS if (on_idle is not None
                                      or deadline is not None) else -1
        if deadline is not None:
            remain = deadline - time.monotonic()
            if remain <= 0:
                raise GetTimeoutError(
                    f"timed out waiting for channel slot {seq}")
            slice_ms = max(1, min(slice_ms, int(remain * 1000)))
        try:
            val = store.get_chan(oid, stop_oid, timeout_ms=slice_ms,
                                 zero_copy=zero_copy)
            break
        except ChannelStopped:
            raise ChannelClosed("channel stop flag sealed") from None
        except GetTimeoutError:
            if on_idle is not None:
                on_idle()
    flight.evt(flight.CHAN_WAKE, flight.lo48(base), seq)
    store.delete(oid)
    if ack_base is not None:
        send_ack(store, ack_base, seq, ack_push_addr)
    return val


def send_ack(store, ack_base: bytes, seq: int,
             push_addr: Optional[str] = None) -> None:
    """Seal the 1-byte ack for `seq` into the producer's store."""
    oid = slot_oid(ack_base, seq)
    a48 = flight.lo48(ack_base)
    flight.evt(flight.CHAN_ACK, a48, seq)
    # the CONSUMER produces acks: a producer parked in an ack wait
    # resolves to this thread in the wait-graph fold
    stacks.note_producer(a48)
    if push_addr is not None:
        from ..core.object_transfer import push_object
        push_object(push_addr, oid, value=True)
        return
    buf = store.create_raw(oid, 1)
    buf[0:1] = b"\x01"
    del buf
    store.seal(oid)


def await_ack(store, ack_base: bytes, seq: int, stop_oid: ObjectID,
              timeout_s: Optional[float] = None, on_idle=None) -> None:
    """Producer-side ring retirement: block until the consumer acked
    `seq`, then delete the ack object. Raises ChannelClosed on stop."""
    from ..core.object_store import GetTimeoutError
    oid = slot_oid(ack_base, seq)
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    a48 = flight.lo48(ack_base)
    flight.evt(flight.CREDIT_BEGIN, a48, seq)
    # credit-wait beacon spanning the whole retirement wait: the inner
    # wait_sealed slices see it armed and leave it in place, so a stack
    # dump reports "channel_credit on <ack chan>" instead of a generic
    # object wait per slice
    bcn = stacks.beacon()
    armed = not bcn[0]
    if armed:
        stacks.set_wait(bcn, stacks.WAIT_ACK, a48, tag=seq)
    try:
        while True:
            slice_ms = _WAIT_SLICE_MS
            if deadline is not None:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    raise GetTimeoutError(
                        f"timed out waiting for channel ack {seq}")
                slice_ms = max(1, min(slice_ms, int(remain * 1000)))
            acked, stopped = store.wait_sealed([oid, stop_oid], 1,
                                               slice_ms)
            if acked:
                store.delete(oid)
                return
            if stopped:
                raise ChannelClosed("channel stop flag sealed")
            if on_idle is not None:
                on_idle()
    finally:
        if armed:
            stacks.clear_wait(bcn)
        flight.evt(flight.CREDIT_END, a48)


def signal_stop(store, stop_oid: ObjectID) -> None:
    """Seal the stop flag locally (idempotent): every parked channel wait
    in this store wakes and raises ChannelClosed."""
    flight.evt(flight.CHAN_STOP, flight.lo48(stop_oid))
    try:
        store.put(stop_oid, True)
    except FileExistsError:
        pass  # already stopped


def drain_stale_slots(store, bases: list[bytes], lo: int, hi: int,
                      eos: bool = False) -> None:
    """Best-effort teardown sweep: delete any [lo, hi) slots still in the
    local store for the given bases. The ack handshake bounds live slots
    to the last ring positions, so callers pass a window, not the full
    history. With ``eos``, each base's end-of-stream marker is swept
    too (streams torn down before the consumer observed it)."""
    for base in bases:
        for seq in range(max(0, lo), hi):
            try:
                store.delete(slot_oid(base, seq))
            except Exception:
                return  # store closing; slots die with it
        if eos:
            try:
                store.delete(eos_oid(base))
            except Exception:
                return  # store closing; slots die with it


class MultiRingReader:
    """Fan-in consumer over N independent ring channels sharing ONE stop
    flag (multi-producer support: each producer owns its own (data, ack)
    base pair, so per-producer seqs never interleave and a slot id is
    still never reused). The consumer parks in ONE ``os_wait_sealed``
    futex wait spanning every producer's next-expected slot plus the
    stop flag and services whichever seals first — the multi-oid analog
    of ``os_chan_get``'s {data, stop} pair, with the same semantics:
    data wins over a concurrent stop (drain, then close).

    Fairness: when several producers have a sealed slot in the same
    wake, service rotates round-robin from the last producer served, so
    a fast producer can't starve the rest. Backpressure stays
    per-producer: each read acks into THAT producer's ack channel, so
    one producer's credit window never throttles another's.
    """

    def __init__(self, store, bases: list[bytes], stop_oid: ObjectID,
                 ring: int, zero_copy: Optional[bool] = None,
                 ack_push_addrs: Optional[list] = None):
        self.store = store
        self.bases = list(bases)
        self.ack_bases = [ack_base_for(b) for b in self.bases]
        self.stop = stop_oid
        self.ring = max(1, ring)
        self.zero_copy = zero_copy
        self.ack_push_addrs = (list(ack_push_addrs) if ack_push_addrs
                               else [None] * len(self.bases))
        self.seqs = [0] * len(self.bases)
        self._rr = 0  # next producer index favoured by the rotation
        self._fl_open = True
        flight.chan_opened(len(self.bases))
        for ab in self.ack_bases:
            stacks.note_producer(flight.lo48(ab))  # this end seals acks

    def _slots(self) -> list[ObjectID]:
        return [slot_oid(b, s) for b, s in zip(self.bases, self.seqs)]

    def sealed_now(self) -> list[bool]:
        """Non-blocking: which producers have their next slot sealed."""
        return self.store.wait_sealed(self._slots(), 0, 0)

    def depth(self) -> int:
        """Sealed-but-unread messages across all producers, scanning each
        producer's credit window (bounded: ring slots per producer).
        Telemetry only — one bulk non-blocking wait_sealed probe."""
        oids = [slot_oid(b, s + k)
                for b, s in zip(self.bases, self.seqs)
                for k in range(self.ring)]
        return len(self.store.wait_sealed_indices(oids, 0, 0))

    def read_any(self, timeout_s: Optional[float] = None,
                 on_idle=None) -> tuple[int, Any]:
        """Block until ANY producer's next message seals; consume it and
        return ``(producer_index, value)``. Raises ChannelClosed when the
        stop flag seals with no data pending, GetTimeoutError past the
        deadline. ``on_idle`` runs between wait slices (liveness probes
        — "did a producer actor die?" — hook in there and may raise)."""
        from ..core.object_store import GetTimeoutError
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        n = len(self.bases)
        while True:
            oids = self._slots() + [self.stop]
            slice_ms = _WAIT_SLICE_MS
            if deadline is not None:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    raise GetTimeoutError(
                        "timed out waiting for any rollout channel slot")
                slice_ms = max(1, min(slice_ms, int(remain * 1000)))
            sealed = self.store.wait_sealed(oids, 1, slice_ms)
            ready = [i for i in range(n) if sealed[i]]
            if ready:
                # round-robin among the producers that are ready NOW
                idx = min(ready, key=lambda i: (i - self._rr) % n)
                self._rr = (idx + 1) % n
                return idx, self._take(idx)
            if sealed[n]:
                raise ChannelClosed("channel stop flag sealed")
            if on_idle is not None:
                on_idle()

    def _take(self, idx: int) -> Any:
        """Consume producer `idx`'s next (already sealed) slot: read,
        delete, ack — retiring its ring position."""
        seq = self.seqs[idx]
        oid = slot_oid(self.bases[idx], seq)
        val = self.store.get(oid, timeout_ms=5000,
                             zero_copy=self.zero_copy)
        flight.evt(flight.CHAN_WAKE, flight.lo48(self.bases[idx]), seq)
        self.store.delete(oid)
        send_ack(self.store, self.ack_bases[idx], seq,
                 self.ack_push_addrs[idx])
        self.seqs[idx] = seq + 1
        return val

    def close(self) -> None:
        """Consumer-side teardown: seal the stop flag (every producer's
        parked ack wait / closed() probe aborts) and sweep the slot and
        ack windows around every cursor, in case a producer already
        exited and will never observe the stop."""
        signal_stop(self.store, self.stop)
        if self._fl_open:
            self._fl_open = False
            flight.chan_closed(len(self.bases))
        for base, ack_base, seq in zip(self.bases, self.ack_bases,
                                       self.seqs):
            drain_stale_slots(self.store, [base, ack_base],
                              seq - self.ring - 1, seq + self.ring)


class RingWriter:
    """Sequential producer end (serve decode streams; DAG edges use the
    functional API since one loop step writes many channels)."""

    def __init__(self, store, base: bytes, stop_oid: ObjectID, ring: int,
                 push_addr: Optional[str] = None,
                 ack_base: Optional[bytes] = None):
        self.store = store
        self.base = base
        self.ack_base = ack_base if ack_base is not None \
            else ack_base_for(base)
        self.stop = stop_oid
        self.ring = max(1, ring)
        self.push_addr = push_addr
        self.seq = 0
        # seed the endpoint table at construction: a deadlocked channel
        # that never got its first write still resolves to this thread
        # in the wait-graph fold (overwritten by the actual writing
        # thread on the first write_slot)
        stacks.note_producer(flight.lo48(self.base))

    def closed(self) -> bool:
        return self.store.contains(self.stop)

    def credit_ready(self) -> bool:
        """Non-blocking: would the next write() proceed without parking
        in a credit wait? True while the ring has free positions or the
        retiring ack is already sealed. Fan-out writers use this to pick
        a consumer with capacity (and to count backpressure stalls)
        before committing to a blocking write."""
        n = self.seq
        if n < self.ring:
            return True
        ack = slot_oid(self.ack_base, n - self.ring)
        return self.store.wait_sealed([ack], 0, 0)[0]

    def pending_ack_oid(self) -> Optional[ObjectID]:
        """The ack object the next write() would park on (None when the
        ring still has free positions). Lets a fan-out writer build ONE
        multi-oid wait across every full consumer ring instead of
        committing to a single consumer's credit."""
        n = self.seq
        if n < self.ring:
            return None
        return slot_oid(self.ack_base, n - self.ring)

    def write(self, value: Any, timeout_s: Optional[float] = None) -> None:
        n = self.seq
        if n >= self.ring:
            await_ack(self.store, self.ack_base, n - self.ring, self.stop,
                      timeout_s)
        write_slot(self.store, self.base, n, value,
                   push_addr=self.push_addr)
        self.seq = n + 1

    def finish(self, timeout_s: Optional[float] = None) -> None:
        """End the stream cleanly: seal EOS (carrying the final count —
        needs no ring credit), retire every still-outstanding ring
        position by consuming the consumer's trailing acks, then wait
        for the consumer's EOS ack and delete the marker. The producer
        owns every object it created, so after finish() the channel
        holds ZERO store objects — the store-returns-to-baseline
        teardown contract. (Deleting the marker without the EOS ack
        would strand a consumer that had not observed it yet: it would
        park on a data slot that never comes.) Raises ChannelClosed if
        the pipeline stop flag seals while draining.

        Same-store channels with an EOS-aware consumer only (the
        data.streaming BlockReceiver): a plain RingReader never acks
        EOS_SEQ, and on a cross-store edge the marker lives in the
        remote store where the local delete could not reach it."""
        if self.push_addr is not None:
            raise NotImplementedError(
                "RingWriter.finish() is same-store only: the EOS "
                "marker and its ack live in the remote store on a "
                "push edge")
        seal_eos(self.store, self.base, self.seq, self.push_addr)
        self.drain_trailing(timeout_s)

    def drain_trailing(self, timeout_s: Optional[float] = None) -> None:
        """The retirement half of finish(): consume the trailing data
        acks and the EOS ack, then delete the marker. Split out so
        fan-out writers can seal EOS on EVERY ring before parking on
        any single consumer's acks (data/streaming BlockSender)."""
        for seq in range(max(0, self.seq - self.ring), self.seq):
            await_ack(self.store, self.ack_base, seq, self.stop, timeout_s)
        await_ack(self.store, self.ack_base, EOS_SEQ, self.stop, timeout_s)
        try:
            self.store.delete(eos_oid(self.base))
        except Exception:
            pass  # store closing; the marker dies with it


class RingReader:
    """Sequential consumer end."""

    def __init__(self, store, base: bytes, stop_oid: ObjectID, ring: int,
                 ack_push_addr: Optional[str] = None,
                 zero_copy: Optional[bool] = None,
                 ack_base: Optional[bytes] = None):
        self.store = store
        self.base = base
        self.ack_base = ack_base if ack_base is not None \
            else ack_base_for(base)
        self.stop = stop_oid
        self.ring = max(1, ring)
        self.ack_push_addr = ack_push_addr
        self.zero_copy = zero_copy
        self.seq = 0
        self._fl_open = True
        flight.chan_opened()
        stacks.note_producer(flight.lo48(self.ack_base))  # acks originate here

    def _fl_close(self) -> None:
        if self._fl_open:
            self._fl_open = False
            flight.chan_closed()

    def read(self, timeout_s: Optional[float] = None, on_idle=None) -> Any:
        val = read_slot(self.store, self.base, self.seq, self.stop,
                        timeout_s, self.zero_copy, self.ack_base,
                        self.ack_push_addr, on_idle)
        self.seq += 1
        return val

    def retire(self) -> None:
        """Call once the stream has ENDED (final sentinel consumed): the
        producer wrote its last message at seq-1 and consumed acks only
        up to seq-1-ring, so the trailing ring of ack objects this
        reader sealed would otherwise leak one store entry each, every
        stream. Local-store readers only (pushed acks live in the
        producer's store, which sweeps on its own exit)."""
        self._fl_close()
        if self.ack_push_addr is None:
            drain_stale_slots(self.store, [self.ack_base],
                              self.seq - self.ring - 1, self.seq)

    def close(self) -> None:
        """Consumer-side cancel: seal the stop flag so the producer's
        next ack wait (or stop probe) aborts the stream and sweeps its
        window; also sweep the slots/acks around OUR cursor in case the
        producer already exited normally and will never observe the
        stop."""
        self._fl_close()
        signal_stop(self.store, self.stop)
        drain_stale_slots(self.store, [self.base, self.ack_base],
                          self.seq - self.ring - 1, self.seq + self.ring)
