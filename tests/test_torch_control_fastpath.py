"""Control-plane fast path (protocol v3): batched submission ordering,
multi-oid event-driven waits, v2 handshake rejection, and batching-on/off
result equivalence. The head-restart replay interaction of the flush
buffer is covered in test_head_restart.py's harness style here as a
slow-marked test; the buffer/replay ordering invariants also get fast
unit coverage below.

The port's copy of ``tests/test_control_fastpath.py``, with its imports
pointed at ``ray_tpu_torch``.

Its ``ray_start_regular`` and ``shutdown_only`` fixtures are the port's
own, defined here under the reference's names: ``tests/conftest.py``'s
start the reference's runtime.

The reconnect case starts its heads with
``tests/test_torch_head_restart.py``'s harness.

Left out: ``test_bench_core_quick_smoke``: it runs the reference's
``bench_core.py``, a benchmark of the reference package, and tests
nothing of the port; the port's benchmark comes with its own harness.
"""
import os
import threading
import time

import pytest


@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch as ray
    if ray.is_initialized():
        ray.shutdown()
    ray.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    yield ray
    ray.shutdown()


@pytest.fixture
def shutdown_only():
    import ray_tpu_torch as ray
    yield ray
    if ray.is_initialized():
        ray.shutdown()


# --------------------------------------------------------------------- #
# native multi-oid wait primitive
# --------------------------------------------------------------------- #

def test_wait_sealed_out_of_order(tmp_path):
    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.core.object_store import SharedObjectStore

    store = SharedObjectStore(str(tmp_path / "store"), capacity=32 << 20,
                              create=True)
    try:
        oids = [ObjectID.from_random() for _ in range(4)]
        store.put(oids[2], b"early")  # sealed before the wait starts

        # non-blocking scan sees only the early seal (no sealer thread
        # running yet: deterministic on any machine)
        flags = store.wait_sealed(oids, len(oids), 0)
        assert flags == [False, False, True, False]

        # event-gated sealer: each phase seals only when released, so the
        # snapshots below can never race wall-clock scheduling
        phase2 = threading.Event()

        def sealer():
            store.put(oids[3], b"late3")   # out of list order
            phase2.wait(timeout=10)
            store.put(oids[0], b"late0")
            store.put(oids[1], b"late1")

        t = threading.Thread(target=sealer)
        t.start()
        # min_count=2 returns as soon as ONE more seals — and it must be
        # the out-of-order one (oids[3]), not list order; oids[0]/oids[1]
        # are gated on phase2, which is not set yet
        flags = store.wait_sealed(oids, 2, 5000)
        assert flags[2] and flags[3]
        assert not flags[0] and not flags[1]
        # wait for all: wakes on each seal, returns when the set is full
        phase2.set()
        t0 = time.monotonic()
        flags = store.wait_sealed(oids, len(oids), 5000)
        assert all(flags)
        assert time.monotonic() - t0 < 2.0  # event-driven, not poll-bound
        t.join()
        # timeout path: a missing oid reports unsealed, promptly
        from ray_tpu_torch.core.ids import ObjectID as OID
        t0 = time.monotonic()
        flags = store.wait_sealed([OID.from_random()], 1, 100)
        assert flags == [False]
        assert 0.05 < time.monotonic() - t0 < 1.0
    finally:
        store.close(unlink=True)


# --------------------------------------------------------------------- #
# flush-buffer ordering (unit: no cluster)
# --------------------------------------------------------------------- #

class _FakeConn:
    def __init__(self):
        self.frames = []

    def send(self, msg):
        self.frames.append(msg)


def _mini_runtime(tmp_path, name="buf"):
    from ray_tpu_torch.core.object_store import SharedObjectStore
    from ray_tpu_torch.core.worker import WorkerRuntime
    store = SharedObjectStore(str(tmp_path / name), capacity=16 << 20,
                              create=True)
    return WorkerRuntime(store, _FakeConn(), "w-test"), store


def test_batched_submit_preserves_func_def_order(tmp_path):
    """A burst flushed as one batch frame must keep func_def BEFORE the
    submits that reference it — the invariant the head relies on when it
    unpacks the frame in order."""
    rt, store = _mini_runtime(tmp_path)
    try:
        conn = rt.conn
        # hold the connection so the combining drain can't ship yet —
        # everything lands in the flush buffer like a mid-write burst
        rt.send_lock.acquire()
        rt.send_async({"t": "func_def", "fid": "f1", "blob": b"x"})
        for i in range(5):
            rt.send_async({"t": "submit", "spec": f"spec{i}"})
        assert conn.frames == []  # nothing shipped while the conn is held
        rt.send_lock.release()
        rt.flush()
        assert len(conn.frames) == 1  # ONE frame for the whole burst
        frame = conn.frames[0]
        assert frame["t"] == "batch"
        kinds = [m["t"] for m in frame["msgs"]]
        assert kinds == ["func_def"] + ["submit"] * 5
        assert [m.get("spec") for m in frame["msgs"][1:]] == \
            [f"spec{i}" for i in range(5)]
    finally:
        store.close(unlink=True)


def test_sync_send_drains_buffer_in_order(tmp_path):
    rt, store = _mini_runtime(tmp_path)
    try:
        conn = rt.conn
        # an uncontended async send ships immediately (no pump latency)
        rt.send_async({"t": "a"})
        assert [f["t"] for f in conn.frames] == ["a"]
        rt.send_lock.acquire()
        rt.send_async({"t": "b"})  # parks: the connection is held
        rt.send_lock.release()
        rt.send({"t": "c"})  # sync send must carry the parked b FIRST
        last = conn.frames[-1]
        assert last["t"] == "batch"
        assert [m["t"] for m in last["msgs"]] == ["b", "c"]
    finally:
        store.close(unlink=True)


def test_failed_flush_requeues_in_order(tmp_path):
    """A drain that dies mid-connection puts its messages back at the
    FRONT of the buffer — the invariant the driver reconnect replay
    depends on to exclude them from resubmission."""
    rt, store = _mini_runtime(tmp_path)
    try:
        class _DeadConn:
            def send(self, msg):
                raise BrokenPipeError

        rt.conn = _DeadConn()
        rt.send_lock.acquire()
        rt.send_async({"t": "m1"})
        rt.send_async({"t": "m2"})
        rt.send_lock.release()
        with pytest.raises(BrokenPipeError):
            rt.flush()
        assert [m["t"] for m in rt._sbuf] == ["m1", "m2"]
        # a later flush over a live conn delivers them, in order
        rt.conn = _FakeConn()
        rt.flush()
        assert [m["t"] for m in rt.conn.frames[0]["msgs"]] == ["m1", "m2"]
    finally:
        store.close(unlink=True)


def test_poison_message_isolated_not_wedged(tmp_path):
    """A message that deterministically fails to serialize must be
    DROPPED (raised to the sender), not requeued — otherwise it would
    wedge every later done/ref/put behind it forever."""
    rt, store = _mini_runtime(tmp_path, "poison")
    try:
        class _PickyConn:
            def __init__(self):
                self.frames = []

            def send(self, msg):
                def bad(m):
                    return isinstance(m, dict) and m.get("t") == "poison"
                if bad(msg) or (isinstance(msg, dict)
                                and msg.get("t") == "batch"
                                and any(bad(m) for m in msg["msgs"])):
                    raise TypeError("cannot pickle this")
                self.frames.append(msg)

        rt.conn = _PickyConn()
        rt.send_lock.acquire()
        rt.send_async({"t": "good1"})
        rt.send_async({"t": "poison"})
        rt.send_async({"t": "good2"})
        rt.send_lock.release()
        with pytest.raises(TypeError):
            rt.flush()
        # innocents in the same frame shipped; the poison did not requeue
        assert [f["t"] for f in rt.conn.frames] == ["good1", "good2"]
        assert rt._sbuf == []
        rt.send({"t": "after"})  # the connection still works
        assert rt.conn.frames[-1]["t"] == "after"
    finally:
        store.close(unlink=True)


def test_last_fetch_throttle_dict_is_bounded(tmp_path):
    rt, store = _mini_runtime(tmp_path)
    try:
        from ray_tpu_torch.core.ids import ObjectID
        rt._rpc = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("x"))
        stale = time.monotonic() - 60.0
        for _ in range(2000):
            rt._last_fetch[ObjectID.from_random()] = stale
        rt._try_fetch(ObjectID.from_random())
        assert len(rt._last_fetch) <= 2  # stale throttle entries expired
    finally:
        store.close(unlink=True)


# --------------------------------------------------------------------- #
# end-to-end over a live cluster
# --------------------------------------------------------------------- #

def test_protocol_v2_peer_rejected_at_handshake(ray_start_regular):
    import json
    from multiprocessing.connection import Client
    from ray_tpu_torch.core import runtime as rt_mod

    rt = rt_mod.get_runtime_if_exists()
    with open(rt.cluster_file) as f:
        cf = json.load(f)
    conn = Client(cf["unix_addr"], "AF_UNIX",
                  authkey=bytes.fromhex(cf["authkey"]))
    try:
        conn.send({"t": "register_driver", "pid": os.getpid(), "pv": 2})
        reply = conn.recv()
        assert reply["t"] == "rejected"
        assert "wire-protocol version 2" in reply["error"]
    finally:
        conn.close()


def test_bulk_get_wakes_on_out_of_order_seals(ray_start_regular):
    ray = ray_start_regular

    @ray.remote
    def delayed(i, d):
        time.sleep(d)
        return i

    # later refs complete first: the bulk wait must service seals in
    # completion order and still return values in list order
    refs = [delayed.remote(i, 0.4 - 0.12 * i) for i in range(4)]
    t0 = time.monotonic()
    assert ray.get(refs, timeout=30) == [0, 1, 2, 3]
    assert time.monotonic() - t0 < 10.0

    ready, rest = ray.wait(refs, num_returns=4, timeout=10)
    assert len(ready) == 4 and not rest


def test_bulk_get_error_before_hanging_ref(ray_start_regular):
    """Sequential-get parity: an errored ref AHEAD of a never-completing
    ref must raise promptly — the bulk wait must not block on the hanging
    ref first (worker-side WorkerRuntime.get exercises the bulk path)."""
    ray = ray_start_regular

    @ray.remote(max_retries=0)
    def boom():
        raise ValueError("early-err")

    @ray.remote
    def hang():
        time.sleep(30)
        return 1

    @ray.remote
    def inner(refs):
        # refs ride inside a list so they are NOT scheduling deps: the
        # worker's own bulk ray.get must surface the error itself
        try:
            ray.get(refs, timeout=25)
            return "no-error"
        except ValueError:
            return "raised"

    e, h = boom.remote(), hang.remote()
    t0 = time.monotonic()
    assert ray.get(inner.remote([e, h]), timeout=60) == "raised"
    assert time.monotonic() - t0 < 20  # did not wait out the hanging ref


@pytest.mark.slow  # 14s equivalence re-proof; the batching-ON path is exercised by the whole suite
def test_batching_on_off_results_identical(shutdown_only):
    ray = shutdown_only
    from ray_tpu_torch.core.config import cfg

    def workload():
        @ray.remote
        def mul(x):
            return x * 3

        @ray.remote
        class Acc:
            def __init__(self):
                self.v = 0

            def add(self, x):
                self.v += x
                return self.v

        refs = [mul.remote(i) for i in range(60)]
        vals = ray.get(refs, timeout=60)
        a = Acc.remote()
        avals = ray.get([a.add.remote(1) for _ in range(20)], timeout=60)
        r = ray.put({"k": 7})
        return vals, avals, ray.get(r, timeout=30)

    results = {}
    for mode in (True, False):
        cfg.override(control_batching=mode, worker_prestart=2)
        try:
            ray.init(num_cpus=2, object_store_memory=128 * 1024 * 1024)
            results[mode] = workload()
        finally:
            ray.shutdown()
            cfg.reset("control_batching", "worker_prestart")
    assert results[True] == results[False]
    assert results[True][0] == [i * 3 for i in range(60)]
    assert results[True][1] == list(range(1, 21))


# --------------------------------------------------------------------- #
# slow: reconnect replay with a non-empty flush buffer, bench smoke
# --------------------------------------------------------------------- #

@pytest.mark.slow
def test_reconnect_replays_buffered_submits_exactly_once(tmp_path):
    """Kill the head while submits sit unsent in the driver's flush
    buffer: after reconnect+replay every task must run EXACTLY once
    (buffered submits ship themselves after the func_def replay; the
    replay must not also resubmit them)."""
    import json
    import signal
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_head_restart import AUTHKEY, _start_head

    import ray_tpu_torch
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    os.environ["RTPU_CLUSTER_AUTHKEY"] = AUTHKEY
    marker_dir = tmp_path / "marks"
    marker_dir.mkdir()
    head1, info1 = _start_head(tmp_path)
    head2 = None
    try:
        cf = os.path.join(info1["session_dir"], "cluster.json")
        ray_tpu_torch.init(address=cf)
        from ray_tpu_torch.core import runtime as rt_mod
        rt = rt_mod.get_runtime_if_exists()

        @ray_tpu_torch.remote
        def mark(i, d):
            with open(os.path.join(d, f"{i}.{os.getpid()}.{time.time_ns()}"),
                      "w"):
                pass
            return i

        # a completed round trip ships the func_def once
        assert ray_tpu_torch.get(mark.remote(100, str(marker_dir)),
                                 timeout=60) == 100
        # park the connection so new submits stay in the flush buffer
        rt.send_lock.acquire()
        refs = [mark.remote(i, str(marker_dir)) for i in range(3)]
        assert len(rt._sbuf) >= 3  # buffered, unsent
        # kill the head with the buffer non-empty, then release
        head1.send_signal(signal.SIGKILL)
        head1.wait(timeout=10)
        rt.send_lock.release()
        time.sleep(1.0)
        head2, info2 = _start_head(
            tmp_path, resume_from=info1["session_dir"])
        vals = ray_tpu_torch.get(refs, timeout=60)
        assert vals == [0, 1, 2]
        # exactly once: one marker file per task id (pid/timestamp vary)
        for i in range(3):
            marks = [m for m in os.listdir(marker_dir)
                     if m.startswith(f"{i}.")]
            assert len(marks) == 1, (i, marks)
    finally:
        try:
            ray_tpu_torch.shutdown()
        except Exception:
            pass
        for h in (head1, head2):
            if h is not None:
                try:
                    h.kill()
                except Exception:
                    pass
