"""The port's object transfer between node stores
(``ray_tpu_torch/core/object_transfer.py``).

Each case of ``tests/test_object_transfer.py`` (whole-frame fetch, a
miss, a fetch from the holder's spill, pooled connections, spill when the
puller's store is full, exception frames) and the ranges and resilience
of ``tests/test_chunked_transfer.py`` (chunked pulls, failover to a live
holder, resume after a holder dies mid-stream, no holder, frames bigger
than the puller's store streamed to its spill, ranges served from the
holder's spill) run on the port's stores with the reference's
assertions. Then torch tensors cross two stores: a CPU tensor of each
dtype comes back bitwise, and a bf16 tensor keeps its bits through a
chunked pull.
"""
import socket
import threading

import numpy as np
import pytest
import torch

from ray_tpu_torch.core.config import cfg
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_store import SharedObjectStore, SpillStore
from ray_tpu_torch.core.object_transfer import (ObjectDataServer,
                                                fetch_object,
                                                fetch_resilient)


@pytest.fixture
def two_stores(tmp_path):
    a = SharedObjectStore(f"/dev/shm/ray_tpu_torch_xfer_a_{id(tmp_path)}",
                          capacity=8 << 20, create=True)
    b = SharedObjectStore(f"/dev/shm/ray_tpu_torch_xfer_b_{id(tmp_path)}",
                          capacity=8 << 20, create=True)
    spill_a = SpillStore(str(tmp_path / "spill_a"))
    spill_b = SpillStore(str(tmp_path / "spill_b"))
    server = ObjectDataServer(a, spill_a)
    yield a, b, spill_a, spill_b, server
    server.stop()
    a.close(unlink=True)
    b.close(unlink=True)


def test_fetch_roundtrip(two_stores):
    a, b, _, _, server = two_stores
    oid = ObjectID.from_random()
    value = {"arr": np.arange(1000), "tag": "hello"}
    a.put(oid, value)
    assert fetch_object(server.address, oid, b) is True
    got = b.get(oid, timeout_ms=0)
    assert got["tag"] == "hello"
    np.testing.assert_array_equal(got["arr"], value["arr"])


def test_fetch_missing_returns_false(two_stores):
    a, b, _, _, server = two_stores
    assert fetch_object(server.address, ObjectID.from_random(), b) is False


def test_fetch_from_spill(two_stores):
    a, b, spill_a, _, server = two_stores
    oid = ObjectID.from_random()
    spill_a.spill(oid, [1, 2, 3])
    assert fetch_object(server.address, oid, b) is True
    assert b.get(oid, timeout_ms=0) == [1, 2, 3]


def test_fetch_reuses_connection(two_stores):
    a, b, _, _, server = two_stores
    for i in range(5):
        oid = ObjectID.from_random()
        a.put(oid, i)
        assert fetch_object(server.address, oid, b) is True
        assert b.get(oid, timeout_ms=0) == i


def test_fetch_spills_when_local_store_full(two_stores, tmp_path):
    a, _, _, _, server = two_stores
    tiny = SharedObjectStore(
        f"/dev/shm/ray_tpu_torch_xfer_tiny_{id(tmp_path)}",
        capacity=1 << 20, max_entries=512, create=True)
    try:
        spill = SpillStore(str(tmp_path / "spill_tiny"))
        oid = ObjectID.from_random()
        a.put(oid, np.zeros(2_000_000, np.uint8))  # 2MB > tiny capacity
        assert fetch_object(server.address, oid, tiny, spill) is True
        assert spill.contains(oid)
        assert len(spill.load(oid)) == 2_000_000
    finally:
        tiny.close(unlink=True)


def test_exception_frames_transfer(two_stores):
    a, b, _, _, server = two_stores
    oid = ObjectID.from_random()
    a.put(oid, ValueError("remote error"), is_exception=True)
    assert fetch_object(server.address, oid, b) is True
    with pytest.raises(ValueError, match="remote error"):
        b.get(oid, timeout_ms=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_cross_two_stores_bitwise(two_stores, dtype):
    a, b, _, _, server = two_stores
    g = torch.Generator().manual_seed(5)
    value = {"t": torch.randn(300, 257, generator=g).to(dtype),
             "grad": torch.randn(4, 4, generator=g).to(dtype)
             .requires_grad_(True)}
    oid = ObjectID.from_random()
    a.put(oid, value)
    assert fetch_object(server.address, oid, b) is True
    got = b.get(oid, timeout_ms=0)
    for k, v in value.items():
        assert got[k].dtype == dtype and got[k].shape == v.shape
        assert got[k].requires_grad == v.requires_grad
        assert torch.equal(got[k].detach().view(torch.uint8),
                           v.detach().view(torch.uint8))


# -- chunked, resumable and failover pulls ---------------------------------

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

    def test_bf16_tensor_round_trips_in_chunks(self, tmp_path,
                                               small_chunks):
        src, src_spill = _stores(tmp_path, "src")
        dst, dst_spill = _stores(tmp_path, "dst")
        server = ObjectDataServer(src, src_spill)
        try:
            oid = ObjectID.from_random()
            g = torch.Generator().manual_seed(6)
            value = torch.randn(3 << 20, generator=g).to(torch.bfloat16)
            src.put(oid, value)                 # 6 MiB: 6 ranges
            assert fetch_resilient([server.address], oid, dst, dst_spill)
            got = dst.get(oid)
            assert got.dtype == torch.bfloat16
            assert torch.equal(got.view(torch.int16),
                               value.view(torch.int16))
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
