"""The port's sealed ring channels (``ray_tpu_torch/dag/channel.py``) on
the port's object store, without a runtime.

The id scheme first: ``slot_oid``, ``eos_oid`` and ``ack_base_for`` give
the reference's bytes for the same inputs (the adapter registry and any
peer that derives a channel id must agree on them). Then the ring on
one store: ``RingWriter``/``RingReader`` with credit backpressure (a
writer a ring ahead parks until the reader's ack), zero-copy reads,
``MultiRingReader``'s fan-in with per-producer credit, the end-of-stream
marker (``seal_eos``/``read_eos`` and ``finish`` leaving no object
behind), ``drain_stale_slots`` and ``ChannelClosed`` when the stop flag
seals on a parked reader. Last, one channel across two stores: data
pushed into the consumer's store and acks pushed back into the
producer's, through ``object_transfer``'s data servers."""
import os
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_store import (GetTimeoutError,
                                             SharedObjectStore)
from ray_tpu_torch.core.object_transfer import ObjectDataServer
from ray_tpu_torch.dag import channel as ch


@pytest.fixture
def store(tmp_path):
    s = SharedObjectStore(str(tmp_path / "store"), capacity=32 << 20,
                          create=True)
    yield s
    s.close(unlink=True)


def _stop():
    return ObjectID.from_random()


def test_ids_match_the_reference_bytes():
    from ray_tpu.dag import channel as ref
    rng = np.random.RandomState(0)
    bases = [bytes(16), b"\xff" * 16] + [rng.bytes(16) for _ in range(6)]
    seqs = [0, 1, 2, 255, 256, 65535, 1 << 31, ch.EOS_SEQ, 1 << 32, -1]
    for base in bases:
        for seq in seqs:
            assert ch.slot_oid(base, seq).binary() == \
                ref.slot_oid(base, seq).binary(), (base, seq)
        assert ch.eos_oid(base).binary() == ref.eos_oid(base).binary()
        assert ch.ack_base_for(base) == ref.ack_base_for(base)
    assert ch.EOS_SEQ == ref.EOS_SEQ == 0xFFFFFFFF
    assert ch._WAIT_SLICE_MS == ref._WAIT_SLICE_MS


def test_ring_credit_backpressure(store):
    """A writer ring messages ahead parks in its credit wait until the
    reader consumes (and acks) the oldest; every value arrives in
    order."""
    base, stop = os.urandom(16), _stop()
    w = ch.RingWriter(store, base, stop, ring=2)
    r = ch.RingReader(store, base, stop, ring=2)
    w.write("m0")
    w.write("m1")
    assert not w.credit_ready()
    assert w.pending_ack_oid() == ch.slot_oid(ch.ack_base_for(base), 0)
    with pytest.raises(GetTimeoutError):
        w.write("m2", timeout_s=0.3)        # no credit: ring full
    third = threading.Thread(target=w.write, args=("m2",), daemon=True)
    third.start()
    time.sleep(0.2)
    assert third.is_alive()                 # parked on ack 0
    assert r.read(timeout_s=10) == "m0"     # acks 0: the write proceeds
    third.join(timeout=10)
    assert not third.is_alive()
    assert [r.read(timeout_s=10) for _ in range(2)] == ["m1", "m2"]
    assert w.seq == r.seq == 3
    r.retire()
    # the writer consumed ack 0; the reader swept its trailing acks
    # (1, 2): only the writer's un-retired acks are left to the sweep
    ch.drain_stale_slots(store, [ch.ack_base_for(base)], 0, 3)
    assert store.num_objects() == 0


def test_zero_copy_reads_survive_the_slot_delete(store):
    """A zero-copy read pins the payload; the reader's delete of the slot
    is lazy and the id is never reused, so the view stays valid, and the
    memory goes back when the view dies."""
    base, stop = os.urandom(16), _stop()
    w = ch.RingWriter(store, base, stop, ring=4)
    r = ch.RingReader(store, base, stop, ring=4, zero_copy=True)
    arrays = [np.full(1 << 16, i, dtype=np.int64) for i in range(6)]
    got = []
    for a in arrays:
        w.write(a)
        got.append(r.read(timeout_s=10))
    for a, g in zip(arrays, got):
        assert np.array_equal(a, g)
    assert store.bytes_in_use() >= 6 * (1 << 19)   # pinned by the views
    del got, g
    r.close()
    deadline = time.monotonic() + 10
    while store.bytes_in_use() >= 1 << 19:
        assert time.monotonic() < deadline, store.bytes_in_use()
        time.sleep(0.05)


def test_multi_ring_reader_fan_in(store):
    """Three producers, one consumer: every message arrives once, each
    producer's in order, service rotates among ready producers, and a
    producer's credit is its own (a full ring does not stall another)."""
    bases, stop = [os.urandom(16) for _ in range(3)], _stop()
    writers = [ch.RingWriter(store, b, stop, ring=2) for b in bases]
    reader = ch.MultiRingReader(store, bases, stop, ring=2)
    for i, w in enumerate(writers):
        for k in range(2):
            w.write((i, k))
    assert reader.sealed_now() == [True, True, True]
    assert reader.depth() == 6
    order = [reader.read_any(timeout_s=10) for _ in range(3)]
    assert [idx for idx, _ in order] == [0, 1, 2]     # round robin
    assert [v for _, v in order] == [(0, 0), (1, 0), (2, 0)]
    # producer 1 got its credit back; the others did too, independently
    assert all(w.credit_ready() for w in writers)
    writers[1].write((1, 2))
    rest = [reader.read_any(timeout_s=10) for _ in range(4)]
    per = {i: [v for idx, v in order + rest if idx == i] for i in range(3)}
    assert per == {0: [(0, 0), (0, 1)], 1: [(1, 0), (1, 1), (1, 2)],
                   2: [(2, 0), (2, 1)]}
    with pytest.raises(GetTimeoutError):
        reader.read_any(timeout_s=0.2)
    reader.close()
    with pytest.raises(ch.ChannelClosed):
        reader.read_any(timeout_s=5)
    for b in bases:
        ch.drain_stale_slots(store, [ch.ack_base_for(b)], 0, 4)
    store.delete(stop)
    assert store.num_objects() == 0


def test_eos_marker_and_finish_leave_no_object(store):
    """``seal_eos`` needs no ring credit and carries the final count;
    ``finish`` retires every ring position and the marker once the
    consumer acked it, so the channel holds no object afterwards."""
    base, stop = os.urandom(16), _stop()
    assert ch.read_eos(store, base) is None
    w = ch.RingWriter(store, base, stop, ring=2)
    r = ch.RingReader(store, base, stop, ring=2)
    w.write("a")
    w.write("b")

    def consume():
        # an EOS-aware consumer: drain to the count, then ack EOS_SEQ
        got = []
        while True:
            n = ch.read_eos(store, base)
            if n is not None and r.seq >= n:
                break
            if store.contains(ch.slot_oid(base, r.seq)):
                got.append(r.read(timeout_s=10))
            else:
                time.sleep(0.01)
        ch.send_ack(store, r.ack_base, ch.EOS_SEQ)
        out.append(got)

    out = []
    t = threading.Thread(target=consume, daemon=True)
    t.start()
    w.finish(timeout_s=10)
    t.join(timeout=10)
    assert out == [["a", "b"]]
    assert ch.read_eos(store, base) is None       # the marker is gone
    r.retire()
    assert store.num_objects() == 0
    # sealing the marker twice is idempotent
    ch.seal_eos(store, base, 5)
    ch.seal_eos(store, base, 5)
    assert ch.read_eos(store, base) == 5
    ch.drain_stale_slots(store, [base], 0, 0, eos=True)
    assert store.num_objects() == 0


def test_drain_stale_slots_sweeps_the_window(store):
    base, stop = os.urandom(16), _stop()
    for seq in range(6):
        ch.write_slot(store, base, seq, seq * 10)
    assert store.num_objects() == 6
    ch.drain_stale_slots(store, [base], 2, 4)
    assert store.num_objects() == 4
    assert not store.contains(ch.slot_oid(base, 2))
    assert ch.read_slot(store, base, 5, stop, timeout_s=5) == 50
    ch.drain_stale_slots(store, [base], -3, 6)      # clamps at 0
    assert store.num_objects() == 0


def test_stop_flag_raises_channel_closed_at_once(store):
    """A reader parked with no deadline (a single futex wait over {data,
    stop}) and a writer parked in its credit wait both raise
    ChannelClosed the moment the stop flag seals, not a slice later;
    data already sealed still wins over the stop."""
    base, stop = os.urandom(16), _stop()
    r = ch.RingReader(store, base, stop, ring=1)
    w = ch.RingWriter(store, os.urandom(16), stop, ring=1)
    w.write("fills the ring")
    raised = {}

    def park(name, fn):
        try:
            fn()
        except ch.ChannelClosed:
            raised[name] = time.monotonic()

    threads = [threading.Thread(target=park, args=("reader", r.read)),
               threading.Thread(target=park, args=("writer",
                                                   lambda: w.write("x")))]
    for t in threads:
        t.start()
    time.sleep(0.3)
    assert not raised
    t0 = time.monotonic()
    ch.signal_stop(store, stop)
    ch.signal_stop(store, stop)               # idempotent
    for t in threads:
        t.join(timeout=10)
    assert set(raised) == {"reader", "writer"}
    assert max(raised.values()) - t0 < 0.25   # well inside one 500 ms slice
    # a sealed slot is drained before the stop is honoured
    base2 = os.urandom(16)
    ch.write_slot(store, base2, 0, "last")
    assert ch.read_slot(store, base2, 0, stop) == "last"
    with pytest.raises(ch.ChannelClosed):
        ch.read_slot(store, base2, 1, stop)
    assert w.closed()


def test_channel_across_two_stores(tmp_path):
    """Producer and consumer on stores of their own: each data message is
    pushed into the consumer's store, each ack back into the producer's;
    a bf16 tensor and a numpy array arrive bit for bit, the credit wait
    works across the push, and both stores end empty."""
    a = SharedObjectStore(str(tmp_path / "a"), capacity=32 << 20,
                          create=True)
    b = SharedObjectStore(str(tmp_path / "b"), capacity=32 << 20,
                          create=True)
    srv_a, srv_b = ObjectDataServer(a), ObjectDataServer(b)
    try:
        base, stop = os.urandom(16), _stop()
        w = ch.RingWriter(a, base, stop, ring=2, push_addr=srv_b.address)
        r = ch.RingReader(b, base, stop, ring=2,
                          ack_push_addr=srv_a.address)
        g = torch.Generator().manual_seed(0)
        sent = [torch.randn(300, 129, generator=g).to(torch.bfloat16),
                np.arange(5000, dtype=np.float32), {"k": (1, "two")}]
        got = []
        for v in sent:
            w.write(v, timeout_s=10)     # the third waits on ack 0 in `a`
            got.append(r.read(timeout_s=10))
        assert torch.equal(got[0].view(torch.int16),
                           sent[0].view(torch.int16))
        assert got[0].dtype == torch.bfloat16
        assert np.array_equal(got[1], sent[1]) and got[2] == sent[2]
        assert a.num_objects() == 2          # acks 1, 2 not yet consumed
        assert b.num_objects() == 0          # every data slot read
        with pytest.raises(NotImplementedError, match="same-store only"):
            w.finish()
        ch.drain_stale_slots(a, [r.ack_base], 0, 3)
        assert a.num_objects() == 0
        # the stop flag: sealed in the consumer's store, it wakes the
        # consumer there; the producer's store has its own flag
        ch.signal_stop(b, stop)
        with pytest.raises(ch.ChannelClosed):
            r.read()
        b.delete(stop)
        assert b.num_objects() == 0
    finally:
        srv_a.stop()
        srv_b.stop()
        a.close(unlink=True)
        b.close(unlink=True)
