"""Node-to-node object transfer: the cross-host data plane.

Reference parity: src/ray/object_manager/object_manager.h:119 (Push :209 /
Pull :217 — chunked object movement between per-node plasma stores over
gRPC) + the ownership-based object directory locating copies.

The port's copy of ``ray_tpu/core/object_transfer.py``: one data server
per node-local store serving whole frames over a raw TCP socket. It moves
the pickled frames the store holds, so a torch tensor that was on a device
when it was put crosses as its host copy (object_store._reduce_tensor),
exactly as it reaches another process of the same host. A puller asks
the head for locations (the directory tracks which node produced each
object), dials the owner's data server, and writes the received frame
into its LOCAL store — after which the object is served locally and the
head records the new copy.

Wire protocol (per request, connections are reused; 1-byte verb first):
  G (get):  -> 'G' + 16B object id
            <- 8B little-endian frame length (0 = not here) + frame bytes
  R (range):-> 'R' + 16B object id + 8B offset + 8B max bytes
            <- 8B TOTAL frame length (0 = not here)
               + min(max, total-offset) payload bytes from offset
  P (push): -> 'P' + 16B object id + 8B frame length + frame bytes
            <- 1B status (1 = stored/already-present, 0 = failed)
Push is how producers place data INTO a peer store without a directory
round-trip — compiled-DAG channels and bulk broadcast use it (reference
Push: object_manager.h:209). Ranged gets are the chunked/resumable pull
path (reference chunked Pull: object_manager.h:217, pull_manager.h:49):
fetch_resilient pulls a large frame in cfg.transfer_chunk_bytes pieces,
resumes from the last good byte after a transport error, fails over
across every known holder, and streams frames bigger than the local
store straight to the spill directory.
"""
from __future__ import annotations

import socket
import struct
import threading
from typing import Optional

from .ids import ObjectID
from .object_store import SharedObjectStore, SpillStore


class ObjectDataServer:
    """Serves frames out of a local store (+ its spill dir)."""

    def __init__(self, store: SharedObjectStore,
                 spill: Optional[SpillStore] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.store = store
        self.spill = spill
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(32)
        self.address = f"{host}:{self._sock.getsockname()[1]}"
        self._stop = False
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="rtpu-objdata").start()

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket):
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while True:
                verb = _recv_exact(conn, 1)
                if verb is None:
                    return
                if verb == b"G":
                    if not self._serve_get(conn):
                        return
                elif verb == b"R":
                    if not self._serve_range(conn):
                        return
                elif verb == b"P":
                    if not self._serve_push(conn):
                        return
                else:
                    return  # unknown verb: drop the connection
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _serve_get(self, conn: socket.socket) -> bool:
        oid_bytes = _recv_exact(conn, ObjectID.SIZE)
        if oid_bytes is None:
            return False
        oid = ObjectID(oid_bytes)
        view = None
        try:
            view = self.store.get_raw(oid, timeout_ms=0)
            if view is not None:
                conn.sendall(struct.pack("<Q", len(view)))
                conn.sendall(view)
            elif self.spill is not None and self.spill.contains(oid):
                with open(self.spill._path(oid), "rb") as f:
                    data = f.read()
                conn.sendall(struct.pack("<Q", len(data)))
                conn.sendall(data)
            else:
                conn.sendall(struct.pack("<Q", 0))
        finally:
            if view is not None:
                del view
                self.store.release(oid)
        return True

    def _serve_range(self, conn: socket.socket) -> bool:
        hdr = _recv_exact(conn, ObjectID.SIZE + 16)
        if hdr is None:
            return False
        oid = ObjectID(hdr[:ObjectID.SIZE])
        offset, maxlen = struct.unpack("<QQ", hdr[ObjectID.SIZE:])
        view = None
        try:
            view = self.store.get_raw(oid, timeout_ms=0)
            if view is not None:
                total = len(view)
                lo = min(offset, total)
                hi = min(lo + maxlen, total)
                conn.sendall(struct.pack("<Q", total))
                if hi > lo:
                    conn.sendall(view[lo:hi])
            elif self.spill is not None and self.spill.contains(oid):
                import os as _os
                path = self.spill._path(oid)
                total = _os.path.getsize(path)
                lo = min(offset, total)
                hi = min(lo + maxlen, total)
                conn.sendall(struct.pack("<Q", total))
                if hi > lo:
                    with open(path, "rb") as f:
                        f.seek(lo)
                        conn.sendall(f.read(hi - lo))
            else:
                conn.sendall(struct.pack("<Q", 0))
        finally:
            if view is not None:
                del view
                self.store.release(oid)
        return True

    def _serve_push(self, conn: socket.socket) -> bool:
        from .object_store import ObjectStoreFullError
        hdr = _recv_exact(conn, ObjectID.SIZE + 8)
        if hdr is None:
            return False
        oid = ObjectID(hdr[:ObjectID.SIZE])
        (length,) = struct.unpack("<Q", hdr[ObjectID.SIZE:])
        # Pushed objects must land in the SHM store (consumers poll it
        # directly — a spill-file "delivery" would be invisible to them),
        # so there is no spill fallback here: full store = status 0.
        # _drain is only legal before any payload byte was consumed; late
        # failures (seal) drop the connection instead.
        try:
            buf = self.store.create_raw(oid, length)
        except FileExistsError:
            _drain(conn, length)
            conn.sendall(b"\x01")   # already present: push is idempotent
            return True
        except ObjectStoreFullError:
            _drain(conn, length)
            conn.sendall(b"\x00")
            return True
        ok = _recv_into_exact(conn, buf)
        del buf
        if not ok:
            self.store.delete(oid)
            return False
        self.store.seal(oid)
        conn.sendall(b"\x01")
        return True

    def stop(self):
        self._stop = True
        try:
            # wakes the accept loop (a close alone leaves it blocked, and
            # the port bound, until the next connection)
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


# per-process pool of puller connections, keyed by address (connections
# are serially reused; pulls are infrequent enough that one socket per
# peer is plenty)
_conn_pool: dict[str, socket.socket] = {}
_pool_lock = threading.Lock()


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def _recv_into_exact(conn: socket.socket, view: memoryview) -> bool:
    got = 0
    while got < len(view):
        n = conn.recv_into(view[got:])
        if n == 0:
            return False
        got += n
    return True


def fetch_object(addr: str, oid: ObjectID, local_store: SharedObjectStore,
                 spill: Optional[SpillStore] = None,
                 timeout_s: float = 30.0) -> bool:
    """Pull one object from `addr` into the local store (spill fallback
    when the local store can't hold it). Returns False if the peer does
    not have the object; raises OSError on transport failure."""
    conn = _checkout_conn(addr, timeout_s)
    ok = False
    try:
        conn.sendall(b"G" + oid.binary())
        hdr = _recv_exact(conn, 8)
        if hdr is None:
            raise OSError("peer closed during fetch")
        (length,) = struct.unpack("<Q", hdr)
        if length == 0:
            result = False
        elif local_store.contains(oid):
            _drain(conn, length)
            result = True
        else:
            result = _receive_frame(conn, oid, length, local_store, spill)
        ok = True   # healthy exchange: pool the connection
        return result
    finally:
        if ok:
            _checkin_conn(addr, conn)
        else:
            try:
                conn.close()
            except OSError:
                pass


def push_object(addr: str, oid: ObjectID, value=None, frame=None,
                is_exception: bool = False, timeout_s: float = 30.0) -> bool:
    """Push a value (or pre-built _FramedValue) INTO the store behind
    `addr` (reference Push, object_manager.h:209). Returns True when the
    peer stored it (or already had it)."""
    from .object_store import _FramedValue
    if frame is None:
        frame = _FramedValue(value, is_exception)
    conn = _checkout_conn(addr, timeout_s)
    ok = False
    try:
        conn.sendall(b"P" + oid.binary() + struct.pack("<Q", frame.total))
        # stream the frame piecewise: no second full-size buffer
        for piece in frame.iter_wire():
            conn.sendall(piece)
        status = _recv_exact(conn, 1)
        if status is None:
            raise OSError("peer closed during push")
        ok = True
        return status == b"\x01"
    finally:
        if ok:
            _checkin_conn(addr, conn)
        else:
            try:
                conn.close()
            except OSError:
                pass


def _checkout_conn(addr: str, timeout_s: float,
                   connect_timeout_s: Optional[float] = None,
                   ) -> socket.socket:
    with _pool_lock:
        conn = _conn_pool.pop(addr, None)
    if conn is None:
        host, port = addr.rsplit(":", 1)
        conn = socket.create_connection(
            (host, int(port)),
            timeout=connect_timeout_s or timeout_s)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    conn.settimeout(timeout_s)
    return conn


def _checkin_conn(addr: str, conn: socket.socket) -> None:
    with _pool_lock:
        if addr not in _conn_pool:
            _conn_pool[addr] = conn
            return
    try:
        conn.close()
    except OSError:
        pass


def _range_once(addr: str, oid: ObjectID, offset: int, maxlen: int,
                sink, timeout_s: float) -> Optional[int]:
    """One ranged request; `sink(view_or_bytes)` consumes the payload.
    Returns the TOTAL frame size, or None when the peer lacks the object.
    Raises OSError on transport trouble. The dial is bounded separately
    (black-holed holders must not eat the full data timeout — the caller
    sits in a synchronous ray.get loop)."""
    conn = _checkout_conn(addr, timeout_s,
                          connect_timeout_s=min(5.0, timeout_s))
    ok = False
    try:
        conn.sendall(b"R" + oid.binary() + struct.pack("<QQ", offset,
                                                       maxlen))
        hdr = _recv_exact(conn, 8)
        if hdr is None:
            raise OSError("peer closed during ranged fetch")
        (total,) = struct.unpack("<Q", hdr)
        if total == 0:
            ok = True
            return None
        want = min(maxlen, max(0, total - offset))
        left = want
        while left > 0:
            piece = conn.recv(min(1 << 20, left))
            if not piece:
                raise OSError("peer closed mid-range")
            sink(piece)
            left -= len(piece)
        ok = True
        return total
    finally:
        if ok:
            _checkin_conn(addr, conn)
        else:
            try:
                conn.close()
            except OSError:
                pass


def fetch_resilient(addrs: list[str], oid: ObjectID,
                    local_store: SharedObjectStore,
                    spill: Optional[SpillStore] = None,
                    timeout_s: float = 30.0,
                    max_rounds: int = 3) -> bool:
    """Chunked, resumable, failover pull (reference: chunked Pull with
    retry, object_manager.h:217 + pull_manager.h:49). The frame moves in
    cfg.transfer_chunk_bytes pieces; a transport error resumes from the
    last good byte against the NEXT holder; frames the local store cannot
    hold stream piecewise into the spill directory (so objects up to disk
    size cross nodes without ever fitting in shm or RAM). Returns False
    only when no holder has the object."""
    from .config import cfg
    from .object_store import ObjectStoreFullError
    if local_store.contains(oid):
        return True
    chunk = max(1 << 16, cfg.transfer_chunk_bytes)
    holders = [a for a in addrs if a]
    if not holders:
        return False

    state = {"total": None, "got": 0, "buf": None, "file": None}

    def sink(piece: bytes):
        if state["file"] is not None:
            state["file"].write(piece)
        else:
            got = state["got"]
            state["buf"][got:got + len(piece)] = piece
        state["got"] += len(piece)

    max_failures = max_rounds * len(holders)
    failures = 0          # only ERRORS consume budget, not chunk steps
    exhausted = 0
    i = 0
    done = False
    try:
        while failures < max_failures:
            addr = holders[i % len(holders)]
            try:
                if state["total"] is None:
                    # first request doubles as the size probe AND carries
                    # the first chunk (small objects stay one round trip);
                    # the prefix buffers until the destination exists
                    prefix = bytearray()
                    total = _range_once(addr, oid, 0, chunk,
                                        prefix.extend, timeout_s)
                    if total is None:
                        exhausted += 1
                        i += 1
                        if exhausted >= len(holders):
                            return False
                        continue
                    exhausted = 0
                    state["total"] = total
                    try:
                        state["buf"] = local_store.create_raw(oid, total)
                    except FileExistsError:
                        done = True   # raced: another puller created it
                        return True
                    except ObjectStoreFullError:
                        if spill is None:
                            raise
                        state["file"] = open(
                            spill._path(oid) + ".tmp", "wb")
                    sink(bytes(prefix))
                    if state["got"] < state["total"]:
                        continue
                else:
                    before = state["got"]
                    total = _range_once(addr, oid, state["got"], chunk,
                                        sink, timeout_s)
                    if total is None or state["got"] == before:
                        # holder lost the object mid-pull (eviction):
                        # others may still serve it
                        failures += 1
                        i += 1
                        continue
            except OSError:
                # transient transport trouble must not count toward the
                # all-holders-lack-it verdict
                exhausted = 0
                failures += 1
                i += 1        # failover: resume against the next holder
                if state["total"] is None and failures >= len(holders):
                    # nothing fetched yet and every holder errored once:
                    # return to the caller's 1 Hz locate/retry loop
                    # instead of burning max_rounds x timeout here
                    raise
                continue
            if state["got"] >= state["total"]:
                if state["file"] is not None:
                    state["file"].close()
                    state["file"] = None
                    import os as _os
                    _os.replace(spill._path(oid) + ".tmp",
                                spill._path(oid))
                else:
                    del state["buf"]
                    state["buf"] = None
                    local_store.seal(oid)
                done = True
                return True
        raise OSError(
            f"fetch of {oid} failed after {max_rounds} rounds over "
            f"{len(holders)} holder(s); got {state['got']} of "
            f"{state['total']} bytes")
    finally:
        if not done:
            if state["file"] is not None:
                state["file"].close()
                import os as _os
                try:   # don't leak partial multi-GB .tmp files on abort
                    _os.remove(spill._path(oid) + ".tmp")
                except OSError:
                    pass
            if state["buf"] is not None:
                del state["buf"]
                local_store.delete(oid)   # abort the unsealed create


def _receive_frame(conn, oid, length, local_store, spill) -> bool:
    from .object_store import ObjectStoreFullError
    try:
        buf = local_store.create_raw(oid, length)
    except FileExistsError:
        _drain(conn, length)
        return True
    except ObjectStoreFullError:
        if spill is None:
            raise
        data = _recv_exact(conn, length)
        if data is None:
            raise OSError("peer closed mid-frame")
        _write_spill_raw(spill, oid, data)
        return True
    ok = _recv_into_exact(conn, buf)
    del buf
    if not ok:
        local_store.delete(oid)
        raise OSError("peer closed mid-frame")
    local_store.seal(oid)
    return True


def _drain(conn: socket.socket, n: int) -> None:
    left = n
    while left > 0:
        chunk = conn.recv(min(65536, left))
        if not chunk:
            raise OSError("peer closed while draining")
        left -= len(chunk)


def _write_spill_raw(spill: SpillStore, oid: ObjectID, data: bytes) -> None:
    import os
    tmp = spill._path(oid) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, spill._path(oid))
