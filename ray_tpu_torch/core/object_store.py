"""Python client for the native shared-memory object store.

Reference parity: python side of plasma (reference:
src/ray/object_manager/plasma/client.h + the flatbuffer protocol plasma.fbs).
Our design has no store server process — every process mmaps the same region
and synchronizes through a process-shared robust mutex (see
native/objstore.cc for rationale). Payloads are framed as:

    [1B flags][4B n_bufs][8B pickle_len][pickle bytes][(8B len, raw bytes)*]

where out-of-band pickle-5 buffers carry numpy arrays without an extra
copy on the serialize side (reference analog: _private/serialization.py:123
zero-copy numpy handling).

The port's copy of ``ray_tpu/core/object_store.py``. Values pickle through
``dumps``, whose reducer (``_reduce_tensor``) carries a torch tensor that
lives on a device through host memory: it arrives as an equal CPU tensor,
as the reference's device arrays arrive as host arrays, so a process
without the device (a CPU worker has ``CUDA_VISIBLE_DEVICES=""``) can
read it. Passing device tensors zero-copy is the later device-object
path.
"""
from __future__ import annotations

import ctypes
import mmap
import os
import pickle
import struct
import sys
import threading
from typing import Any, Optional

import cloudpickle
import numpy as np

from .ids import ObjectID
from .native.build import ensure_built
from . import flight
from . import stacks

_FLAG_NORMAL = 0
_FLAG_EXCEPTION = 1

_HEADER = struct.Struct("<BxxxIQ")  # flags, n_bufs, pickle_len

# Pieces at least this large are copied with ctypes.memmove in
# _FramedValue.write_into (see comment there); smaller ones stay on the
# simpler slice-assignment path.
_MEMMOVE_MIN = 256 * 1024

# Pieces at least this large copy on a small thread pool: ctypes.memmove
# releases the GIL, so slicing one multi-hundred-MiB memmove across
# threads tracks the machine's memory bandwidth instead of one core's
# share of it (the put-bandwidth path — bench_core
# single_client_put_gigabytes profiles as ~97% this copy).
_PARALLEL_MIN = 32 * 1024 * 1024
_COPY_THREADS_AUTO = 4
_COPY_THREADS_MAX = 16
_copy_pool = None          # guarded by: _copy_pool_lock
_copy_pool_width = 0       # guarded by: _copy_pool_lock
_copy_pool_pid = 0         # guarded by: _copy_pool_lock
_copy_pool_lock = threading.Lock()


def _ensure_copy_pool_locked(threads: int):
    """The per-process copy pool, built/regrown. CALLER HOLDS
    _copy_pool_lock — and every submit happens under the same lock
    (_copy_parallel), which is what makes the regrow swap safe: once
    this function replaces the pool, no racing put can still be between
    "fetched the old pool" and "submitted to it", so the old pool can
    be drained with shutdown(wait=False) immediately — queued slices
    finish, its threads then retire, nothing is left to GC timing.
    Fork safety: a child inheriting the parent's pool object has no
    live worker threads, so a pid change forces a rebuild (the ghost
    pool is NOT shutdown — its internal lock state is whatever the
    parent froze at fork time)."""
    global _copy_pool, _copy_pool_width, _copy_pool_pid
    if _copy_pool is None or _copy_pool_pid != os.getpid() \
            or _copy_pool_width < threads:
        import concurrent.futures as cf
        old, old_pid = _copy_pool, _copy_pool_pid
        _copy_pool = cf.ThreadPoolExecutor(
            max_workers=threads, thread_name_prefix="rtpu-copy")
        _copy_pool_width = threads
        _copy_pool_pid = os.getpid()
        if old is not None and old_pid == os.getpid():
            # drain, don't drop: in-flight futures complete, idle
            # threads exit once the queue empties (wait=False: never
            # block a put on another put's copies)
            old.shutdown(wait=False)
    return _copy_pool


def _copy_parallel(dst: int, src, n: int) -> None:
    """memmove(dst, src, n), sliced across the copy pool for large n.
    `src` is an int address or a bytes object. Slices are SUBMITTED
    under _copy_pool_lock (cheap queue puts) so a concurrent regrow
    (cfg.put_copy_threads raised mid-run) can never shut the pool down
    between our fetch and our submit; the actual copying — and the
    wait for it — happens outside the lock on the pool threads."""
    from .config import cfg
    threads = min(cfg.put_copy_threads or _COPY_THREADS_AUTO,
                  _COPY_THREADS_MAX)
    if n < _PARALLEL_MIN or threads <= 1:
        ctypes.memmove(dst, src, n)
        return
    if isinstance(src, bytes):
        # zero-copy readonly view; keeps `src` alive across the workers
        src_arr = np.frombuffer(src, np.uint8)
        src = src_arr.ctypes.data
    step = -(-n // threads)  # ceil
    with _copy_pool_lock:
        pool = _ensure_copy_pool_locked(threads)
        futs = [pool.submit(ctypes.memmove, dst + off, src + off,
                            min(step, n - off))
                for off in range(0, n, step)]
    for f in futs:
        f.result()


class ObjectStoreFullError(MemoryError):
    pass


class ObjectLostError(Exception):
    """Object was evicted and is no longer in the store (lineage needed)."""


class GetTimeoutError(TimeoutError):
    pass


class ChannelStopped(Exception):
    """A stop-aware channel get aborted: the stop flag sealed while
    waiting and the data slot never arrived (dag/channel.py teardown)."""


def _load_lib() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(ensure_built())
    except OSError:
        # a shipped .so can be source-current yet unloadable here (built
        # against a newer glibc); recompile for this host
        from .native.build import rebuild
        lib = ctypes.CDLL(rebuild())
    lib.os_store_create.restype = ctypes.c_void_p
    lib.os_store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32]
    lib.os_store_attach.restype = ctypes.c_void_p
    lib.os_store_attach.argtypes = [ctypes.c_char_p]
    lib.os_store_close.argtypes = [ctypes.c_void_p]
    lib.os_create.restype = ctypes.c_uint64
    lib.os_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.os_seal.restype = ctypes.c_int
    lib.os_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.os_get.restype = ctypes.c_int
    lib.os_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.os_contains.restype = ctypes.c_int
    lib.os_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.os_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.os_delete.restype = ctypes.c_int
    lib.os_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.os_reclaim_pid.restype = ctypes.c_int
    lib.os_reclaim_pid.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.os_wait_sealed.restype = ctypes.c_int
    lib.os_wait_sealed.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_int64, ctypes.c_char_p,
    ]
    lib.os_chan_get.restype = ctypes.c_int
    lib.os_chan_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.os_seal_seq.restype = ctypes.c_uint32
    lib.os_seal_seq.argtypes = [ctypes.c_void_p]
    lib.os_wait_seq.restype = ctypes.c_int
    lib.os_wait_seq.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                ctypes.c_int64]
    lib.os_prefault.restype = None
    lib.os_prefault.argtypes = [ctypes.c_void_p]
    lib.os_store_refresh_pid.restype = None
    lib.os_store_refresh_pid.argtypes = [ctypes.c_void_p]
    for fn in ("os_capacity", "os_bytes_in_use", "os_num_objects", "os_evictions"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    return lib


def _host_tensor(t, requires_grad: bool):
    """Unpickle side of _reduce_tensor: the host copy, as a CPU tensor."""
    return t.requires_grad_(requires_grad) if requires_grad else t


def _reduce_tensor(obj):
    """Reducer for a torch tensor on a device (CUDA): pickle its host
    copy. Anything else (CPU tensors included) pickles as usual."""
    torch = sys.modules.get("torch")
    if torch is None or not isinstance(obj, torch.Tensor) or \
            obj.device.type == "cpu":
        return NotImplemented
    return _host_tensor, (obj.detach().cpu(), bool(obj.requires_grad))


class _Pickler(cloudpickle.Pickler):
    """cloudpickle with the port's reducers (``_reduce_tensor``)."""

    def reducer_override(self, obj):
        out = _reduce_tensor(obj)
        if out is not NotImplemented:
            return out
        return super().reducer_override(obj)


def dumps(value: Any, protocol: int = 5, buffer_callback=None) -> bytes:
    """cloudpickle.dumps through the port's reducers: every value the
    store holds and every task argument is pickled here."""
    import io
    f = io.BytesIO()
    _Pickler(f, protocol=protocol,
             buffer_callback=buffer_callback).dump(value)
    return f.getvalue()


class _FramedValue:
    """One serialization of a value in the store's wire framing, writable
    to either a shm buffer or a spill file (serialize once, place anywhere).

    Copy audit (put-bandwidth path): pickle-5 out-of-band buffers are
    REFERENCED (`b.raw()` is a view into the caller's array), never copied
    at serialize time; the single copy a put pays is write_into's memmove
    from the source array into the (MADV_HUGEPAGE-advised, optionally
    prefaulted) store mapping. Spill streams the same pieces to disk
    without materializing the frame (SpillStore.spill_frame).
    """

    def __init__(self, value: Any, is_exception: bool):
        buffers: list[pickle.PickleBuffer] = []
        self.payload = dumps(value, protocol=5,
                             buffer_callback=buffers.append)
        self.raws = [b.raw() for b in buffers]
        self.flags = _FLAG_EXCEPTION if is_exception else _FLAG_NORMAL
        self.total = (_HEADER.size + len(self.payload)
                      + sum(8 + len(r) for r in self.raws))

    def write_into(self, buf) -> None:
        pos = 0
        dst_addr = None
        for piece in self.iter_wire():
            n = len(piece)
            if n >= _MEMMOVE_MIN:
                # ctypes.memmove is ~2x the bandwidth of memoryview slice
                # assignment on multi-MiB pieces (the slice path goes
                # through PyBuffer item copying; memmove is glibc's
                # vectorized copy). Only worth the address plumbing for
                # large pieces.
                if dst_addr is None:
                    dst_addr = ctypes.addressof(
                        ctypes.c_char.from_buffer(buf))
                src = piece if isinstance(piece, bytes) else \
                    np.frombuffer(piece, np.uint8).ctypes.data
                _copy_parallel(dst_addr + pos, src, n)
            else:
                buf[pos:pos + n] = piece
            pos += n

    def iter_wire(self):
        """The frame as a sequence of buffers in wire order — lets senders
        stream it (socket sendall per piece) without materializing a
        second full-size copy."""
        yield _HEADER.pack(self.flags, len(self.raws), len(self.payload))
        yield self.payload
        for r in self.raws:
            yield struct.pack("<Q", len(r))
            yield r


class _PinnedBuffer:
    """Zero-copy view of one pickle-5 buffer inside the shm store.

    Exposes the buffer protocol (PEP 688, Python >= 3.12), so numpy
    reconstructs arrays directly over store memory and keeps this object
    alive as their base. When the LAST consumer array is GC'd, the
    object's read pin is released and it becomes evictable again — the
    same lifetime rule plasma gives the reference
    (plasma/client.h Get/Release). Views are read-only, like reference
    arrays out of plasma.
    """

    __slots__ = ("_view", "_on_release")

    def __init__(self, view: memoryview, on_release):
        self._view = view.toreadonly()
        self._on_release = on_release

    def __buffer__(self, flags):
        return self._view

    def __del__(self):
        try:
            self._view.release()
        except BufferError:
            pass  # an export is mid-release; the view dies with us anyway
        finally:
            self._on_release()


def _parse_frame(view, pinned_release=None) -> Any:
    """Inverse of _FramedValue over a buffer; raises stored exceptions.

    With `pinned_release` (a callable releasing the store read pin), large
    out-of-band buffers deserialize ZERO-COPY as read-only views pinned in
    the store; `pinned_release` fires when the last one dies. Without it,
    buffers are copied out and the caller releases the pin itself.
    """
    from .ref import loading_stored_refs
    flags, n_bufs, plen = _HEADER.unpack_from(view, 0)
    pos = _HEADER.size
    payload = bytes(view[pos:pos + plen])
    pos += plen
    bufs = []
    zero_copy = pinned_release is not None and flags != _FLAG_EXCEPTION \
        and n_bufs > 0
    refcnt = {"n": 0}

    def buffer_died():
        refcnt["n"] -= 1
        if refcnt["n"] == 0:
            pinned_release()

    for _ in range(n_bufs):
        (blen,) = struct.unpack_from("<Q", view, pos)
        pos += 8
        if zero_copy:
            bufs.append(_PinnedBuffer(view[pos:pos + blen], buffer_died))
            refcnt["n"] += 1
        else:
            bufs.append(bytes(view[pos:pos + blen]))
        pos += blen
    with loading_stored_refs():
        value = pickle.loads(payload, buffers=bufs)
    del bufs  # drop parse-time references: consumers now own the pins
    if flags == _FLAG_EXCEPTION:
        raise value
    return value if pinned_release is None else (value, zero_copy)


class SpillStore:
    """Disk spill area for objects the shm store can't hold (reference:
    raylet/local_object_manager.h:42 SpillObjects :112 +
    _private/external_storage.py FileSystemStorage). One file per object in
    the store's wire framing, written atomically (tmp + rename) so readers
    never see partials."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, oid: ObjectID) -> str:
        return os.path.join(self.dir, oid.hex() + ".bin")

    def spill(self, oid: ObjectID, value: Any,
              is_exception: bool = False) -> int:
        return self.spill_frame(oid, _FramedValue(value, is_exception))

    def spill_frame(self, oid: ObjectID, frame: "_FramedValue") -> int:
        # stream the frame piecewise: materializing a full-size bytearray
        # first doubled the copy volume for multi-GiB spills (write_into +
        # write); the out-of-band buffers go straight from their owner's
        # memory to the page cache
        tmp = self._path(oid) + ".tmp"
        with open(tmp, "wb") as f:
            for piece in frame.iter_wire():
                f.write(piece)
        os.replace(tmp, self._path(oid))
        return frame.total

    def contains(self, oid: ObjectID) -> bool:
        return os.path.exists(self._path(oid))

    def load(self, oid: ObjectID) -> Any:
        with open(self._path(oid), "rb") as f:
            return _parse_frame(f.read())

    def delete(self, oid: ObjectID) -> None:
        try:
            os.unlink(self._path(oid))
        except OSError:
            pass


# Live stores in this process, so the at-fork hook can re-key their
# cached pid (the native handle pins objects under Handle.pid; a forked
# child inheriting the parent's handle must pin under ITS pid or the
# parent's exit reclaim would strip pins the child still reads through).
import weakref

_LIVE_STORES: "weakref.WeakSet[SharedObjectStore]" = weakref.WeakSet()


def _refresh_store_pids_after_fork() -> None:
    for s in list(_LIVE_STORES):
        h = s._h
        if h:
            try:
                s._lib.os_store_refresh_pid(h)
            except Exception:
                pass  # store handle mid-close in the parent


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_refresh_store_pids_after_fork)


class SharedObjectStore:
    """One per process; created by the head (driver), attached by workers."""

    def __init__(self, path: str, capacity: int = 0, max_entries: int = 65536,
                 create: bool = False):
        self._lib = _load_lib()
        self.path = path
        if create:
            self._h = self._lib.os_store_create(path.encode(), capacity, max_entries)
        else:
            self._h = self._lib.os_store_attach(path.encode())
        if not self._h:
            raise RuntimeError(f"failed to open object store at {path}")
        self._fd = os.open(path, os.O_RDWR)
        size = os.fstat(self._fd).st_size
        self._mm = mmap.mmap(self._fd, size)
        self._advise_mapping(create)
        self._view = memoryview(self._mm)
        self._owner = create
        # heap capacity is fixed for the store's lifetime: cache it so the
        # per-put spill-threshold check costs one ctypes call, not two
        self._capacity = int(self._lib.os_capacity(self._h))
        _LIVE_STORES.add(self)

    # Linux madvise constants Python's mmap module doesn't export yet.
    _MADV_HUGEPAGE = 14
    _MADV_POPULATE_READ = 22

    def _advise_mapping(self, create: bool) -> None:
        """THP always (cheap, helps TLB on multi-MiB memcpys); full
        pre-fault only when cfg.store_prefault — put/get bandwidth is
        bounded by first-touch faulting otherwise (measured ~1.8 vs ~6.4
        GiB/s for 128 MiB frames on shm), but faulting the whole capacity
        costs seconds per GiB at create, which short-lived test clusters
        don't want. The creator write-warms the heap via os_prefault's
        memset (see objstore.cc for why not MADV_POPULATE_WRITE);
        attachers populate READ-only PTEs."""
        from .config import cfg
        try:
            self._mm.madvise(getattr(mmap, "MADV_HUGEPAGE",
                                     self._MADV_HUGEPAGE))
        except (OSError, ValueError):
            pass
        if cfg.store_prefault:
            if create:
                # Creator prefault: the C side memsets the heap write-warm
                # (see os_prefault in objstore.cc for why not
                # MADV_POPULATE_WRITE). Must run before any allocation.
                self._lib.os_prefault(self._h)
            else:
                try:
                    self._mm.madvise(
                        getattr(mmap, "MADV_POPULATE_READ",
                                self._MADV_POPULATE_READ))
                except (OSError, ValueError):
                    pass  # pre-5.14 kernel: stay lazy

    # -- raw byte-level API ------------------------------------------------

    def _handle(self):
        h = self._h
        if h is None:
            raise RuntimeError("object store is closed")
        return h

    def create_raw(self, oid: ObjectID, size: int) -> memoryview:
        off = self._lib.os_create(self._handle(), oid.binary(), size)
        if off == 2**64 - 1:
            raise FileExistsError(f"object {oid} already exists")
        if off == 0:
            raise ObjectStoreFullError(
                f"object store full ({self.bytes_in_use()}/{self.capacity()} "
                f"bytes in use) while allocating {size} bytes")
        flight.evt(flight.OBJ_CREATE, flight.lo48(oid), size)
        return self._view[off:off + size]

    def seal(self, oid: ObjectID) -> None:
        if self._lib.os_seal(self._handle(), oid.binary()) != 0:
            raise RuntimeError(f"seal failed for {oid}")
        flight.evt(flight.OBJ_SEAL, flight.lo48(oid))

    def get_raw(self, oid: ObjectID, timeout_ms: int = -1) -> Optional[memoryview]:
        """Pin + return the payload view, or None on timeout. Caller must
        release(oid) when done with the view."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        if timeout_ms < 0:
            timeout_ms = 2**31  # ~24 days; effectively infinite
        # non-blocking first: the hot path (object already sealed — every
        # get of a computed result) pays NO beacon traffic and the same
        # single native call as before
        rc = self._lib.os_get(self._handle(), oid.binary(), 0,
                              ctypes.byref(off), ctypes.byref(size))
        if rc != 0 and timeout_ms != 0:
            # about to actually park: arm the wait beacon (stacks.py) so
            # a live stack dump shows WHAT the native futex wait is
            # waiting for. `armed` keeps a more specific outer beacon
            # (channel credit waits) from being overwritten.
            b = stacks.beacon()
            armed = not b[0]
            if armed:
                ob = oid.binary()
                stacks.set_wait(b, stacks.WAIT_GET, flight.lo48(ob),
                                tag=stacks.wait_tag(ob))
            try:
                rc = self._lib.os_get(self._handle(), oid.binary(),
                                      timeout_ms, ctypes.byref(off),
                                      ctypes.byref(size))
            finally:
                if armed:
                    stacks.clear_wait(b)
        if rc != 0:
            return None
        return self._view[off.value:off.value + size.value]

    def release(self, oid: ObjectID) -> None:
        h = self._h
        if h is None:
            return  # closed (teardown): zero-copy pins die with the mapping
        self._lib.os_release(h, oid.binary())

    def contains(self, oid: ObjectID) -> bool:
        return bool(self._lib.os_contains(self._handle(), oid.binary()))

    # Chunk bound for full waits: os_wait_sealed rescans the whole
    # not-yet-observed set under the store mutex on every seal event, so
    # waiting on one huge list costs O(n^2) probes while serializing other
    # processes' store ops. A full wait (min_count >= n) decomposes
    # exactly into waiting each chunk to completion in turn.
    _WAIT_CHUNK = 1024

    def wait_sealed(self, oids, min_count: int,
                    timeout_ms: int) -> list[bool]:
        """Block until at least `min_count` of `oids` are sealed (or the
        timeout fires); returns one observed-sealed flag per oid. One futex
        wait on the store header's seal-sequence word services whichever
        object seals first — the event-driven multi-object primitive behind
        bulk get()/wait() (timeout_ms=0 is a non-blocking bulk contains).
        Spilled objects never seal in shm: callers re-check their spill
        fallback between bounded slices."""
        n = len(oids)
        if n == 0:
            return []
        if timeout_ms == 0:
            # non-blocking bulk contains: no flight record — depth probes
            # and sealed_now() polls would flood the ring with non-events
            if n > self._WAIT_CHUNK:
                return self._wait_sealed_chunked(oids, min_count, 0)
            return self._wait_sealed_call(oids, min_count, 0)
        flight.evt(flight.WAIT_BEGIN, n, min_count)
        # wait beacon: this thread is about to park on these ids — a live
        # stack dump (stacks.py) names the first one + the count. An
        # already-armed beacon (an outer channel-credit wait driving this
        # wait_sealed) wins; we only arm/clear when we armed.
        b = stacks.beacon()
        armed = not b[0]
        if armed:
            ob = oids[0].binary()
            stacks.set_wait(b, stacks.WAIT_OBJ, flight.lo48(ob), n,
                            tag=stacks.wait_tag(ob))
        try:
            if n > self._WAIT_CHUNK:
                out = self._wait_sealed_chunked(oids, min_count,
                                                timeout_ms)
            else:
                out = self._wait_sealed_call(oids, min_count, timeout_ms)
        finally:
            if armed:
                stacks.clear_wait(b)
        flight.evt(flight.WAIT_END, sum(out))
        return out

    def _wait_sealed_chunked(self, oids, min_count: int,
                             timeout_ms: int) -> list[bool]:
        """wait_sealed over a huge list: seqlock-style. Scan in bounded
        chunks (each a short store-mutex hold, so other processes' store
        ops never stall behind one O(n) probe pass), then block on the
        seal-sequence word until something seals and rescan only the
        still-unmet ids."""
        import time as _time
        n = len(oids)
        deadline = _time.monotonic() + timeout_ms / 1000.0
        flags = [False] * n
        unmet = list(range(n))
        while True:
            seq = self._lib.os_seal_seq(self._handle())
            for s in range(0, len(unmet), self._WAIT_CHUNK):
                idxs = unmet[s:s + self._WAIT_CHUNK]
                got = self._wait_sealed_call([oids[i] for i in idxs], 0, 0)
                for i, f in zip(idxs, got):
                    if f:
                        flags[i] = True
            unmet = [i for i in unmet if not flags[i]]
            if n - len(unmet) >= min_count or not unmet:
                return flags
            if timeout_ms == 0:
                return flags
            remain_ms = int((deadline - _time.monotonic()) * 1000)
            if remain_ms <= 0:
                return flags
            # a seal between our seq read and this wait returns
            # immediately (seq moved); otherwise any seal/delete wakes us
            self._lib.os_wait_seq(self._handle(), seq, remain_ms)

    def wait_sealed_indices(self, oids, min_count: int,
                            timeout_ms: int) -> list[int]:
        """wait_sealed, returning the INDICES observed sealed instead of
        per-oid flags. The multi-producer fan-in consumers (rl rollout
        queue over dag/channel.MultiRingReader) park in one of these over
        {every producer's next slot, stop} and service whichever sealed —
        the multi-oid analog of os_chan_get's {data, stop} pair."""
        return [i for i, f in enumerate(
            self.wait_sealed(oids, min_count, timeout_ms)) if f]

    def _wait_sealed_call(self, oids, min_count: int,
                          timeout_ms: int) -> list[bool]:
        n = len(oids)
        ids = b"".join(o.binary() for o in oids)
        out = ctypes.create_string_buffer(n)
        self._lib.os_wait_sealed(self._handle(), ids, n,
                                 max(0, min_count), timeout_ms, out)
        return [b != 0 for b in out.raw]

    def delete(self, oid: ObjectID) -> None:
        self._lib.os_delete(self._handle(), oid.binary())

    def reclaim_pid(self, pid: int) -> int:
        """Abort unsealed creates and drop read pins leaked by a dead
        process (call when a worker is reaped)."""
        return self._lib.os_reclaim_pid(self._handle(), pid)

    # -- object-level API --------------------------------------------------

    def put(self, oid: ObjectID, value: Any, is_exception: bool = False) -> int:
        """Serialize `value` into the store under `oid`. Returns payload size.

        Atomic on failure: a raise between create_raw and seal deletes
        the half-written object, so `oid` never wedges in the unsealed
        state (a stranded unsealed object makes every retry die with
        FileExistsError and parks wait_sealed callers forever)."""
        frame = _FramedValue(value, is_exception)
        buf = self.create_raw(oid, frame.total)
        try:
            frame.write_into(buf)
            del buf
            self.seal(oid)
        except BaseException:
            buf = None  # release the view before delete, or the segment pins
            try:
                self.delete(oid)
            except Exception:
                pass  # store closing / already reclaimed
            raise
        return frame.total

    def put_or_spill(self, oid: ObjectID, value: Any, is_exception: bool,
                     spill: Optional["SpillStore"]) -> bool:
        """Store `value`, spilling the SAME serialized frame to disk when
        the store is full (one serialization either way). Returns True if
        spilled. Raises ObjectStoreFullError when full and spill is None.

        Proactive spilling (local_object_manager.h:112 analog): once the
        store passes ``cfg.object_spilling_threshold`` fill, frames at least
        ``cfg.min_spilling_size`` go straight to disk instead of forcing
        LRU eviction of hot shm objects."""
        from .config import cfg
        frame = _FramedValue(value, is_exception)
        if (spill is not None
                and frame.total >= cfg.min_spilling_size
                and self.bytes_in_use()
                    > cfg.object_spilling_threshold * self.capacity()):
            spill.spill_frame(oid, frame)
            return True
        try:
            buf = self.create_raw(oid, frame.total)
        except ObjectStoreFullError:
            if spill is None:
                raise
            spill.spill_frame(oid, frame)
            return True
        try:
            frame.write_into(buf)
            del buf
            self.seal(oid)
        except BaseException:
            buf = None
            try:
                self.delete(oid)
            except Exception:
                pass  # store closing / already reclaimed
            raise
        return False

    def get(self, oid: ObjectID, timeout_ms: int = -1,
            zero_copy: Optional[bool] = None) -> Any:
        """Deserialize the object. Raises GetTimeoutError on timeout and
        re-raises stored exceptions. With cfg.zero_copy_get, large buffers
        come back as read-only views pinned in the store until their
        arrays are GC'd (plasma semantics). Pass zero_copy=False to force
        the copy path — required by LEGACY consume-once readers (polling
        DAG channels) whose delete-then-recreate of the same id cannot
        tolerate a lazy, pin-deferred delete; sealed ring channels never
        reuse an id, so they read under the cfg default."""
        view = self.get_raw(oid, timeout_ms)
        if view is None:
            raise GetTimeoutError(f"timed out waiting for {oid}")
        return self._materialize(oid, view, zero_copy)

    def get_chan(self, oid: ObjectID, stop_oid: ObjectID,
                 timeout_ms: int = -1,
                 zero_copy: Optional[bool] = None) -> Any:
        """Stop-aware channel get (os_chan_get): one native blocking call
        that wakes on either the data seal or the stop seal. Raises
        ChannelStopped when the stop flag sealed and no data arrived;
        otherwise behaves like get()."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        if timeout_ms < 0:
            timeout_ms = 2**31  # ~24 days; effectively infinite
        # channel-wait beacon: lo48 of a slot oid equals lo48 of its
        # channel base (slot ids share the base's first 12 bytes), so the
        # stack report and the wait-graph fold resolve this directly
        # against the producer endpoint tables
        b = stacks.beacon()
        armed = not b[0]
        if armed:
            ob = oid.binary()
            stacks.set_wait(b, stacks.WAIT_CHAN, flight.lo48(ob),
                            tag=stacks.wait_tag(ob))
        try:
            rc = self._lib.os_chan_get(self._handle(), oid.binary(),
                                       stop_oid.binary(), timeout_ms,
                                       ctypes.byref(off),
                                       ctypes.byref(size))
        finally:
            if armed:
                stacks.clear_wait(b)
        if rc == -3:
            raise ChannelStopped(f"stop flag sealed while waiting for {oid}")
        if rc != 0:
            raise GetTimeoutError(f"timed out waiting for {oid}")
        view = self._view[off.value:off.value + size.value]
        return self._materialize(oid, view, zero_copy)

    def _materialize(self, oid: ObjectID, view, zero_copy: Optional[bool]):
        """Shared tail of get()/get_chan(): deserialize a pinned view and
        manage the read pin across the copy and zero-copy paths."""
        from .config import cfg
        if zero_copy is None:
            # _PinnedBuffer needs __buffer__ (PEP 688, CPython >= 3.12);
            # older interpreters silently fall back to the copy path
            zero_copy = cfg.zero_copy_get and sys.version_info >= (3, 12)
        if not zero_copy:
            try:
                return _parse_frame(view)
            finally:
                del view
                self.release(oid)
        state = {"released": False}

        def rel_once():
            # one pin, many possible release paths (error + wrapper deaths
            # of partially-consumed buffers): never unpin twice
            if not state["released"]:
                state["released"] = True
                self.release(oid)

        try:
            value, transferred = _parse_frame(view, pinned_release=rel_once)
        except BaseException:
            del view
            rel_once()
            raise
        del view
        if not transferred:   # no out-of-band buffers: nothing stayed pinned
            rel_once()
        return value

    # -- stats -------------------------------------------------------------

    def capacity(self) -> int:
        return self._capacity

    def bytes_in_use(self) -> int:
        return self._lib.os_bytes_in_use(self._handle())

    def num_objects(self) -> int:
        return self._lib.os_num_objects(self._handle())

    def evictions(self) -> int:
        return self._lib.os_evictions(self._handle())

    def close(self, unlink: bool = False) -> None:
        if self._h:
            h, self._h = self._h, None  # new calls now fail cleanly
            # let in-flight os_get slices (<=200ms waits) drain before unmap
            import time
            time.sleep(0.25)
            try:
                self._view.release()
                self._mm.close()
            except BufferError:
                pass  # a reader still holds a view; leak the map, not a SEGV
            os.close(self._fd)
            self._lib.os_store_close(h)
            if unlink and self._owner:
                try:
                    os.unlink(self.path)
                except OSError:
                    pass
