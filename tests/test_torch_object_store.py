"""The port's shared-memory object store: the scenarios of
``tests/test_object_store.py`` on ``ray_tpu_torch.core.object_store``,
then the port's own: the library is compiled from the port's
``objstore.cc`` into its gitignored build directory, and a put pickles
through the reducer the port registers for torch tensors on a device.

Reference parity model: src/ray/object_manager/plasma tests
(object_store_test, eviction_policy semantics).
"""
import numpy as np
import pytest

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_store import (
    GetTimeoutError,
    ObjectStoreFullError,
    SharedObjectStore,
)


@pytest.fixture
def store(tmp_path):
    s = SharedObjectStore(str(tmp_path / "store"), capacity=32 * 1024 * 1024,
                          create=True)
    yield s
    s.close(unlink=True)


def test_put_get_roundtrip(store):
    oid = ObjectID.from_random()
    val = {"x": np.arange(100), "y": [1, "two", 3.0]}
    store.put(oid, val)
    out = store.get(oid)
    assert np.array_equal(out["x"], val["x"])
    assert out["y"] == val["y"]


def test_exception_payload(store):
    oid = ObjectID.from_random()
    store.put(oid, KeyError("missing"), is_exception=True)
    with pytest.raises(KeyError):
        store.get(oid)


def test_get_timeout(store):
    with pytest.raises(GetTimeoutError):
        store.get(ObjectID.from_random(), timeout_ms=50)


def test_contains_delete(store):
    oid = ObjectID.from_random()
    store.put(oid, 42)
    assert store.contains(oid)
    store.delete(oid)
    assert not store.contains(oid)


def test_duplicate_create_rejected(store):
    oid = ObjectID.from_random()
    store.put(oid, 1)
    with pytest.raises(FileExistsError):
        store.create_raw(oid, 10)


def test_lru_eviction_under_pressure(store):
    ids = []
    for _ in range(40):  # 40 MiB into a 32 MiB store
        oid = ObjectID.from_random()
        store.put(oid, np.zeros(1024 * 1024, dtype=np.uint8))
        ids.append(oid)
    assert store.evictions() > 0
    assert store.contains(ids[-1])          # most recent survives
    assert not store.contains(ids[0])       # oldest evicted


def test_pinned_objects_survive_eviction(store):
    pinned = ObjectID.from_random()
    store.put(pinned, np.zeros(1024 * 1024, dtype=np.uint8))
    assert store.get_raw(pinned, timeout_ms=0) is not None  # pin
    for _ in range(40):
        store.put(ObjectID.from_random(),
                  np.zeros(1024 * 1024, dtype=np.uint8))
    assert store.contains(pinned)
    store.release(pinned)


def test_store_full_with_pins_raises(store):
    keep = []
    with pytest.raises(ObjectStoreFullError):
        for _ in range(40):
            oid = ObjectID.from_random()
            store.put(oid, np.zeros(2 * 1024 * 1024, dtype=np.uint8))
            assert store.get_raw(oid, timeout_ms=0) is not None
            keep.append(oid)


def test_zero_length_and_odd_sizes(store):
    for n in (0, 1, 7, 8, 9, 4095, 4097):
        oid = ObjectID.from_random()
        store.put(oid, b"x" * n)
        assert store.get(oid) == b"x" * n


# -- crash robustness (SIGKILLed clients must never wedge the store) --------
#
# The deadlock these guard against: a client SIGKILLed inside a process-shared
# pthread_cond_timedwait left its condvar group reference behind, and the
# next broadcast (os_seal, holding the store mutex) blocked forever in the
# group-switch quiesce. The store now waits on a raw futex (kernel keeps no
# per-waiter state), so a killed waiter is invisible. These tests pin that.

def _child_block_in_get(path, oid_bin, ready):
    from ray_tpu_torch.core.object_store import SharedObjectStore
    from ray_tpu_torch.core.ids import ObjectID
    s = SharedObjectStore(path, create=False)
    ready.set()
    s.get(ObjectID(oid_bin), timeout_ms=60_000)  # blocks in futex wait


def _child_pin_forever(path, oid_bin, ready):
    import time
    from ray_tpu_torch.core.object_store import SharedObjectStore
    from ray_tpu_torch.core.ids import ObjectID
    s = SharedObjectStore(path, create=False)
    assert s.get_raw(ObjectID(oid_bin), timeout_ms=1000) is not None
    ready.set()
    time.sleep(60)  # die holding the pin (parent SIGKILLs us)


def _child_create_unsealed(path, oid_bin, ready):
    import time
    from ray_tpu_torch.core.object_store import SharedObjectStore
    from ray_tpu_torch.core.ids import ObjectID
    s = SharedObjectStore(path, create=False)
    s.create_raw(ObjectID(oid_bin), 1024)
    ready.set()
    time.sleep(60)  # die before sealing


def test_sigkilled_waiter_does_not_wedge_seal(store):
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    oid = ObjectID.from_random()
    ready = ctx.Event()
    p = ctx.Process(target=_child_block_in_get,
                    args=(store.path, oid.binary(), ready))
    p.start()
    assert ready.wait(30)
    import time
    time.sleep(0.3)  # let the child reach the futex wait
    p.kill()
    p.join()
    # seal must complete promptly and wake nobody-left-behind
    t0 = time.monotonic()
    store.put(oid, 42)
    assert time.monotonic() - t0 < 5
    assert store.get(oid) == 42
    # and later seals stay healthy too
    oid2 = ObjectID.from_random()
    store.put(oid2, 43)
    assert store.get(oid2) == 43


def test_reclaim_pid_frees_dead_readers_pin(store):
    import multiprocessing as mp
    import time
    ctx = mp.get_context("spawn")
    oid = ObjectID.from_random()
    store.put(oid, np.zeros(1024, dtype=np.uint8))
    ready = ctx.Event()
    p = ctx.Process(target=_child_pin_forever,
                    args=(store.path, oid.binary(), ready))
    p.start()
    assert ready.wait(30)
    p.kill()
    p.join()
    assert store.reclaim_pid(p.pid) >= 1
    # pin is gone: delete now frees immediately and the slot is reusable
    store.delete(oid)
    assert not store.contains(oid)
    time.sleep(0)


def test_reclaim_pid_aborts_unsealed_create(store):
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    oid = ObjectID.from_random()
    ready = ctx.Event()
    p = ctx.Process(target=_child_create_unsealed,
                    args=(store.path, oid.binary(), ready))
    p.start()
    assert ready.wait(30)
    p.kill()
    p.join()
    before = store.num_objects()
    assert store.reclaim_pid(p.pid) >= 1
    assert store.num_objects() == before - 1
    # the id is free again
    store.put(oid, b"fresh")
    assert store.get(oid) == b"fresh"


class TestZeroCopyGet:
    def test_zero_copy_views_pin_then_release(self, tmp_path):
        """cfg.zero_copy_get: arrays come back read-only over store
        memory; the object stays pinned (unevictable) until the last
        array dies, then the pin releases."""
        import gc

        import numpy as np

        from ray_tpu_torch.core.config import cfg
        from ray_tpu_torch.core.ids import ObjectID
        from ray_tpu_torch.core.object_store import SharedObjectStore

        st = SharedObjectStore(str(tmp_path / "zc"), capacity=64 << 20,
                               create=True)
        cfg.override(zero_copy_get=True)
        try:
            oid = ObjectID.from_random()
            src = np.arange(1 << 20, dtype=np.float32)
            st.put(oid, {"a": src, "b": 3})
            out = st.get(oid)
            np.testing.assert_array_equal(out["a"], src)
            assert not out["a"].flags.writeable   # plasma semantics
            # the pin blocks deletion-by-eviction: delete marks it, but
            # memory is only reclaimed once consumers die. Drop the array:
            arr = out["a"]
            del out
            np.testing.assert_array_equal(arr[:4], src[:4])
            del arr
            gc.collect()
            # pin released: a delete now actually frees the entry
            st.delete(oid)
            assert not st.contains(oid)

            # small/no-buffer objects release immediately
            oid2 = ObjectID.from_random()
            st.put(oid2, "just a string")
            assert st.get(oid2) == "just a string"
            st.delete(oid2)

            # stored exceptions still raise (copy path)
            oid3 = ObjectID.from_random()
            st.put(oid3, ValueError("boom"), is_exception=True)
            with pytest.raises(ValueError, match="boom"):
                st.get(oid3)
        finally:
            cfg.reset("zero_copy_get")
            st.close(unlink=True)

    def test_zero_copy_roundtrip_through_api(self, tmp_path):
        """End-to-end put/get of a big array under zero_copy_get."""
        import numpy as np

        import ray_tpu_torch as rt
        from ray_tpu_torch.core.config import cfg

        cfg.override(zero_copy_get=True)
        try:
            rt.init(num_cpus=1, object_store_memory=256 << 20)
            src = np.arange(2 << 20, dtype=np.float64)
            ref = rt.put(src)
            out = rt.get(ref, timeout=60)
            np.testing.assert_array_equal(out, src)

            @rt.remote
            def total(a):
                return float(a.sum())

            assert rt.get(total.remote(ref), timeout=60) == \
                float(src.sum())
        finally:
            cfg.reset("zero_copy_get")
            rt.shutdown()


# -- put atomicity (graftlint GL014 burn-down regressions) ----------------


def test_put_failure_leaves_no_unsealed_object(store):
    # regression: a raise between create_raw and seal used to strand the
    # oid UNSEALED — every retry then died with FileExistsError and
    # wait_sealed callers parked forever
    oid = ObjectID.from_random()
    real_seal = store.seal

    def boom(o):
        raise RuntimeError("injected seal failure")

    store.seal = boom
    with pytest.raises(RuntimeError):
        store.put(oid, [1, 2, 3])
    store.seal = real_seal
    assert not store.contains(oid)
    store.put(oid, [1, 2, 3])  # retry must not die with FileExistsError
    assert store.get(oid) == [1, 2, 3]


def test_put_or_spill_failure_leaves_no_unsealed_object(store):
    oid = ObjectID.from_random()
    real_seal = store.seal

    def boom(o):
        raise RuntimeError("injected seal failure")

    store.seal = boom
    with pytest.raises(RuntimeError):
        store.put_or_spill(oid, "v", False, None)
    store.seal = real_seal
    assert store.put_or_spill(oid, "v", False, None) is False
    assert store.get(oid) == "v"


def test_mux_ring_seal_failure_does_not_wedge_doorbell(store):
    # regression: a failed doorbell seal left the bell UNSEALED, so every
    # later _ring died on FileExistsError and the mux loop never woke
    from types import SimpleNamespace

    from ray_tpu_torch.core.completion import CompletionMux

    mux = CompletionMux(SimpleNamespace(store=store, spill=None))
    real_seal = store.seal

    def boom(o):
        raise RuntimeError("injected seal failure")

    store.seal = boom
    mux._ring()  # swallowed; must drop the half-created bell
    store.seal = real_seal
    mux._ring()
    assert store.wait_sealed([mux._bell], 1, 0) == [True]


# -- the port's own: its library and its tensor reducer --------------------


def test_library_is_built_from_the_ports_source_into_the_build_dir(store):
    import hashlib
    import os

    import ray_tpu_torch.core.native.build as build

    native = os.path.dirname(build.__file__)
    assert build._SRC == os.path.join(native, "objstore.cc")
    lib = build.ensure_built()
    assert lib == os.path.join(native, "_build", "libobjstore.so")
    with open(build._SRC, "rb") as f:
        want = hashlib.sha256(f.read()).hexdigest()
    with open(lib + ".srchash") as f:
        assert f.read().strip() == want
    # the store this process opened (the fixture) loaded that library
    with open("/proc/self/maps") as f:
        assert lib in f.read()
    # the build directory is gitignored: no binary is committed
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, ".gitignore")) as f:
        ignored = [ln.strip() for ln in f]
    assert "ray_tpu_torch/core/native/_build/" in ignored
    assert not [n for n in os.listdir(native) if n.endswith(".so")]


def test_store_uses_a_rebuilt_library_after_a_source_change(tmp_path,
                                                            monkeypatch):
    """The content hash decides staleness: a changed source rebuilds."""
    import ray_tpu_torch.core.native.build as build
    src = tmp_path / "objstore.cc"
    with open(build._SRC) as f:
        src.write_text(f.read())
    monkeypatch.setattr(build, "_SRC", str(src))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    lib = build.ensure_built()
    first = open(lib + ".srchash").read()
    assert build.ensure_built() == lib       # cached: same hash
    src.write_text(src.read_text() + "\n// touched\n")
    build.ensure_built()
    assert open(lib + ".srchash").read() != first


def test_no_compiler_raises(tmp_path, monkeypatch):
    """No shipped binary to fall back to: without g++ the build raises."""
    import ray_tpu_torch.core.native.build as build
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setenv("PATH", str(tmp_path))   # no g++ on it
    with pytest.raises(RuntimeError, match="g\\+\\+ is needed"):
        build.ensure_built()


def test_put_pickles_tensors_through_the_ports_reducer(store, monkeypatch):
    """Every store value pickles through ``object_store.dumps``, whose
    reducer sends a device tensor through host memory. No card here, so
    the reducer is spied on: it sees each tensor of the value (and
    leaves CPU tensors to torch's own pickling), and the value comes
    back equal, dtypes and all."""
    import torch

    from ray_tpu_torch.core import object_store
    seen = []
    real = object_store._reduce_tensor

    def spy(obj):
        if isinstance(obj, torch.Tensor):
            seen.append(obj.dtype)
        return real(obj)

    monkeypatch.setattr(object_store, "_reduce_tensor", spy)
    val = {"w": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4),
           "b": torch.ones(5, dtype=torch.float32, requires_grad=True),
           "n": 7}
    oid = ObjectID.from_random()
    store.put(oid, val)
    out = store.get(oid)
    assert seen == [torch.bfloat16, torch.float32]
    assert out["n"] == 7
    for k in ("w", "b"):
        assert out[k].dtype == val[k].dtype and out[k].device.type == "cpu"
        assert torch.equal(out[k], val[k])
    assert out["b"].requires_grad



def test_delete_while_pinned_frees_at_the_last_release(tmp_path):
    """A delete of an object a zero-copy view still pins is deferred, not
    lost: the object stays readable under the view, and the last release
    frees its memory and its entry at once (the sealed ring channels
    delete every slot right after reading it, pinned or not)."""
    import gc

    from ray_tpu_torch.core.config import cfg
    st = SharedObjectStore(str(tmp_path / "pend"), capacity=64 << 20,
                           create=True)
    cfg.override(zero_copy_get=True)
    try:
        oid = ObjectID.from_random()
        src = np.arange(1 << 20, dtype=np.float32)
        st.put(oid, src)
        base = st.bytes_in_use()
        views = [st.get(oid), st.get(oid)]       # two pins
        st.delete(oid)
        assert st.num_objects() == 1 and st.bytes_in_use() == base
        np.testing.assert_array_equal(views[0], src)
        del views[0]
        gc.collect()
        assert st.num_objects() == 1             # one pin left
        np.testing.assert_array_equal(views[0][-4:], src[-4:])
        del views
        gc.collect()
        assert st.num_objects() == 0 and st.bytes_in_use() == 0
        assert st.evictions() == 0
        assert not st.contains(oid)
        # an unpinned delete still frees at once
        st.put(oid, src)
        st.delete(oid)
        assert st.num_objects() == 0
    finally:
        cfg.reset("zero_copy_get")
        st.close(unlink=True)
