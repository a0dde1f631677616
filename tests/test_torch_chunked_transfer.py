"""Chunked / resumable / failover object transfer + spill streaming
(reference: chunked Push/Pull with retry — object_manager.h:209,217,
pull_manager.h:49).

The port's copy of ``tests/test_chunked_transfer.py``, with its imports
pointed at ``ray_tpu_torch``.

Its ``ray_start_regular`` and ``own_store_agent`` fixtures are the
port's own, defined here under the reference's names:
``tests/conftest.py``'s start the reference's runtime.

Its ``own_store_agent`` is the port's copy of conftest's helper: it
starts ``python -m ray_tpu_torch.core.node_agent --own-store``.
"""
import contextlib
import socket
import struct
import threading

import numpy as np
import pytest

from ray_tpu_torch.core.config import cfg
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_store import SharedObjectStore, SpillStore
from ray_tpu_torch.core.object_transfer import (ObjectDataServer, fetch_resilient,
                                                push_object)


@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch as ray
    if ray.is_initialized():
        ray.shutdown()
    ray.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    yield ray
    ray.shutdown()


@contextlib.contextmanager
def own_store_agent(ray, name, store_capacity=256 << 20, num_cpus=2,
                    timeout=30):
    """Spawn a REAL own-store node agent of the port joined to `ray`'s
    head; yields the registered NodeID hex; terminates the agent on
    exit."""
    import os
    import subprocess
    import sys
    import time

    info = ray.head_address()
    env = dict(os.environ)
    env["RTPU_AUTHKEY"] = info["authkey"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.core.node_agent",
         "--head", info["address"], "--num-cpus", str(num_cpus),
         "--name", name, "--own-store",
         "--store-capacity", str(store_capacity)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + timeout
        node_id = None
        while time.time() < deadline and node_id is None:
            for row in ray.nodes():
                if row["NodeName"] == name and row["Alive"]:
                    node_id = row["NodeID"]
            time.sleep(0.2)
        assert node_id, f"own-store agent {name!r} never registered"
        yield node_id
    finally:
        proc.terminate()
        proc.wait(timeout=10)


@pytest.fixture
def small_chunks():
    cfg.override(transfer_chunk_bytes=1 << 20)   # 1 MiB pieces
    yield
    cfg.reset("transfer_chunk_bytes")


def _stores(tmp_path, name, capacity=256 << 20):
    store = SharedObjectStore(str(tmp_path / name), capacity=capacity,
                              create=True)
    spill = SpillStore(str(tmp_path / f"{name}_spill"))
    return store, spill


class TestChunkedPull:
    def test_large_frame_round_trips_in_chunks(self, tmp_path,
                                               small_chunks):
        src, src_spill = _stores(tmp_path, "src")
        dst, dst_spill = _stores(tmp_path, "dst")
        server = ObjectDataServer(src, src_spill)
        try:
            oid = ObjectID.from_random()
            payload = np.random.RandomState(0).bytes(20 << 20)  # 20 chunks
            src.put(oid, payload)
            assert fetch_resilient([server.address], oid, dst, dst_spill)
            assert dst.get(oid) == payload
        finally:
            server.stop()
            src.close(unlink=True)
            dst.close(unlink=True)

    def test_failover_to_live_holder(self, tmp_path, small_chunks):
        """A dead holder in the list is skipped; the pull succeeds from
        the live one."""
        src, src_spill = _stores(tmp_path, "src")
        dst, dst_spill = _stores(tmp_path, "dst")
        server = ObjectDataServer(src, src_spill)
        # a listener that accepts then immediately closes = dead holder
        dead = socket.socket()
        dead.bind(("127.0.0.1", 0))
        dead.listen(1)
        dead_addr = f"127.0.0.1:{dead.getsockname()[1]}"

        def refuse():
            while True:
                try:
                    c, _ = dead.accept()
                    c.close()
                except OSError:
                    return
        threading.Thread(target=refuse, daemon=True).start()
        try:
            oid = ObjectID.from_random()
            payload = np.random.RandomState(1).bytes(5 << 20)
            src.put(oid, payload)
            assert fetch_resilient([dead_addr, server.address], oid, dst,
                                   dst_spill)
            assert dst.get(oid) == payload
        finally:
            dead.close()
            server.stop()
            src.close(unlink=True)
            dst.close(unlink=True)

    def test_mid_stream_failure_resumes(self, tmp_path, small_chunks):
        """A holder that dies after serving a few ranges: the pull resumes
        from the last good byte against the next holder (no restart)."""
        src, src_spill = _stores(tmp_path, "src")
        dst, dst_spill = _stores(tmp_path, "dst")

        class FlakyServer(ObjectDataServer):
            served = 0

            def _serve_range(self, conn):
                FlakyServer.served += 1
                if FlakyServer.served > 3:   # probe + 2 ranges, then die
                    conn.close()
                    return False
                return super()._serve_range(conn)

        flaky = FlakyServer(src, src_spill)
        good = ObjectDataServer(src, src_spill)
        try:
            oid = ObjectID.from_random()
            payload = np.random.RandomState(2).bytes(9 << 20)
            src.put(oid, payload)
            assert fetch_resilient([flaky.address, good.address], oid,
                                   dst, dst_spill)
            assert dst.get(oid) == payload
            assert FlakyServer.served > 3   # the flaky one actually died
        finally:
            flaky.stop()
            good.stop()
            src.close(unlink=True)
            dst.close(unlink=True)

    def test_no_holder_has_it(self, tmp_path, small_chunks):
        src, src_spill = _stores(tmp_path, "src")
        dst, dst_spill = _stores(tmp_path, "dst")
        server = ObjectDataServer(src, src_spill)
        try:
            assert not fetch_resilient([server.address],
                                       ObjectID.from_random(), dst,
                                       dst_spill)
        finally:
            server.stop()
            src.close(unlink=True)
            dst.close(unlink=True)


class TestSpillStreaming:
    def test_frame_bigger_than_dest_store_streams_to_spill(
            self, tmp_path, small_chunks):
        """A frame ~2x the destination store's capacity lands in its
        spill directory piecewise — it never fits in shm OR in one RAM
        buffer."""
        src, src_spill = _stores(tmp_path, "src", capacity=256 << 20)
        dst, dst_spill = _stores(tmp_path, "dst", capacity=8 << 20)
        server = ObjectDataServer(src, src_spill)
        try:
            oid = ObjectID.from_random()
            value = np.random.RandomState(3).bytes(16 << 20)  # 2x dst cap
            src.put(oid, value)
            assert fetch_resilient([server.address], oid, dst, dst_spill)
            assert not dst.contains(oid)        # too big for the store
            assert dst_spill.contains(oid)
            assert dst_spill.load(oid) == value
        finally:
            server.stop()
            src.close(unlink=True)
            dst.close(unlink=True)

    def test_ranged_serve_from_source_spill(self, tmp_path, small_chunks):
        """The server side also serves ranges from ITS spill dir (the
        object may only exist on disk at the holder)."""
        src, src_spill = _stores(tmp_path, "src")
        dst, dst_spill = _stores(tmp_path, "dst")
        server = ObjectDataServer(src, src_spill)
        try:
            oid = ObjectID.from_random()
            value = np.random.RandomState(4).bytes(3 << 20)
            src_spill.spill(oid, value)
            assert fetch_resilient([server.address], oid, dst, dst_spill)
            assert dst.get(oid) == value
        finally:
            server.stop()
            src.close(unlink=True)
            dst.close(unlink=True)


class TestEndToEnd:
    @pytest.mark.slow
    def test_double_store_capacity_object_crosses_nodes(
            self, ray_start_regular):
        """A task on an own-store node returns an object ~2x ITS store
        capacity (spilled locally); the driver pulls it across via ranged
        reads from the island's spill."""
        ray = ray_start_regular
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy)

        with own_store_agent(ray, "bignode",
                             store_capacity=16 << 20) as node_id:
            @ray.remote(num_cpus=1, scheduling_strategy=(
                    NodeAffinitySchedulingStrategy(node_id=node_id,
                                                   soft=False)))
            def produce():
                import numpy as _np
                return _np.ones(32 << 20, dtype=_np.uint8)  # 32MB > 16MB

            out = ray.get(produce.remote(), timeout=300)
            assert out.nbytes == 32 << 20
            assert int(out[0]) == 1 and int(out[-1]) == 1
