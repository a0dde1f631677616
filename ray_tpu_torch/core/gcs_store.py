"""GCS metadata persistence: a namespaced KV store + head-state snapshots.

Reference parity: the GCS storage backends (gcs/store_client/
redis_store_client.h, in_memory_store_client.h) and the internal KV
surface (gcs_kv_manager.h, ray.experimental.internal_kv). The reference
persists GCS tables to Redis so a restarted GCS can serve a live cluster;
here the head IS the driver, so the recovery unit is a NEW head process
resuming durable state from the previous session: named actors are
re-created from their specs, placement groups re-reserved, and the job
table carried over (running jobs marked failed — their drivers died with
the old head).

sqlite (WAL mode) replaces Redis: single-host durability without a
server, and the file rides the session dir.
"""
from __future__ import annotations

import os
import pickle
import sqlite3
import threading
import time

from .protocol import SNAPSHOT_SCHEMA_VERSION


class GcsStore:
    """Namespaced KV over sqlite. Thread-safe; every op commits."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._lock = threading.Lock()
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS kv ("
            "ns TEXT NOT NULL, k TEXT NOT NULL, v BLOB NOT NULL, "
            "PRIMARY KEY (ns, k))")
        self._db.commit()

    def put(self, ns: str, key: str, value: bytes) -> None:
        with self._lock:
            self._db.execute(
                "INSERT INTO kv (ns, k, v) VALUES (?, ?, ?) "
                "ON CONFLICT (ns, k) DO UPDATE SET v = excluded.v",
                (ns, key, value))
            self._db.commit()

    def get(self, ns: str, key: str) -> bytes | None:
        with self._lock:
            row = self._db.execute(
                "SELECT v FROM kv WHERE ns = ? AND k = ?",
                (ns, key)).fetchone()
        return None if row is None else row[0]

    def delete(self, ns: str, key: str) -> bool:
        with self._lock:
            cur = self._db.execute(
                "DELETE FROM kv WHERE ns = ? AND k = ?", (ns, key))
            self._db.commit()
            return cur.rowcount > 0

    def keys(self, ns: str) -> list[str]:
        with self._lock:
            rows = self._db.execute(
                "SELECT k FROM kv WHERE ns = ?", (ns,)).fetchall()
        return [r[0] for r in rows]

    def items(self, ns: str) -> list[tuple[str, bytes]]:
        with self._lock:
            rows = self._db.execute(
                "SELECT k, v FROM kv WHERE ns = ?", (ns,)).fetchall()
        return list(rows)

    def close(self):
        with self._lock:
            self._db.close()


# --------------------------------------------------------------------- #
# head-state snapshot / restore
# --------------------------------------------------------------------- #

def snapshot(rt) -> None:
    """Persist restorable head state (called by the snapshot loop)."""
    kv = rt.kv
    with rt.lock:
        named = []
        for name, aid in rt.named_actors.items():
            a = rt.actors.get(aid)
            if a is None or a.state == "dead":
                continue
            blob = rt.func_registry.get(a.spec.class_id)
            if blob is None:
                continue
            named.append((name, a.spec, blob))
        pgs = [(pg.pg_id, [dict(b.resources) for b in pg.bundles],
                pg.strategy, pg.name, pg.same_label,
                list(pg.bundle_selectors))
               for pg in rt.pgs.values() if pg.state != "removed"]
    jobs = rt.jobs.list()
    kv.put("snapshot", "named_actors", pickle.dumps(named))
    kv.put("snapshot", "placement_groups", pickle.dumps(pgs))
    kv.put("snapshot", "jobs", pickle.dumps(jobs))
    kv.put("snapshot", "meta", pickle.dumps(
        {"ts": time.time(), "session_dir": rt.session_dir,
         "schema_version": SNAPSHOT_SCHEMA_VERSION}))


def restore(rt, old_session_dir: str) -> dict:
    """Resume durable state from a previous session's gcs.sqlite into the
    (fresh) runtime `rt`. Returns a summary of what was restored."""
    path = os.path.join(old_session_dir, "gcs.sqlite")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no GCS snapshot at {path}")
    old = GcsStore(path)
    try:
        meta_blob = old.get("snapshot", "meta")
        if meta_blob is not None:
            sv = pickle.loads(meta_blob).get("schema_version", 0)
            if sv > SNAPSHOT_SCHEMA_VERSION:
                raise RuntimeError(
                    f"GCS snapshot at {path} has schema version {sv}, "
                    f"this build reads <= {SNAPSHOT_SCHEMA_VERSION}; "
                    f"resume with a build at least as new as the one "
                    f"that wrote it")
        named = pickle.loads(old.get("snapshot", "named_actors") or b"\x80\x04]\x94.")
        pgs = pickle.loads(old.get("snapshot", "placement_groups") or b"\x80\x04]\x94.")
        jobs = pickle.loads(old.get("snapshot", "jobs") or b"\x80\x04]\x94.")
        user_kv = old.items("user")  # durable internal KV carries over
    finally:
        old.close()

    restored = {"actors": 0, "placement_groups": 0, "jobs": 0, "kv_keys": 0}
    for row in pgs:
        # keep the OLD id: restored actor specs reference it. Rows may be
        # 4-tuples (pre-slice-scheduling snapshots) or 6-tuples.
        pg_id, bundles, strategy, name = row[:4]
        same_label = row[4] if len(row) > 4 else None
        selectors = row[5] if len(row) > 5 else None
        rt.create_placement_group(bundles, strategy, name, pg_id=pg_id,
                                  same_label=same_label,
                                  bundle_selectors=selectors)
        restored["placement_groups"] += 1
    import dataclasses
    from .ids import ActorID, ObjectID
    for name, spec, blob in named:
        # v1->v2 migration: pre-namespace snapshots stored unqualified
        # names; qualify into the shared default namespace so
        # get_actor("x") (which qualifies to "default/x") still finds
        # every restored actor (actor.py qualify_actor_name)
        if name and "/" not in name and not name.startswith("rtpu:"):
            name = f"default/{name}"
            spec = dataclasses.replace(spec, named=name)
        rt.register_function(spec.class_id, blob)
        # fresh ids: the old actor process is gone; what survives is the
        # named identity + class + init args (reference: detached actors
        # are re-created by name after GCS failover only if restartable —
        # we always re-create, the stronger contract)
        spec = dataclasses.replace(
            spec, actor_id=ActorID.from_random(),
            ready_oid=ObjectID.from_random())
        rt.create_actor(spec)
        restored["actors"] += 1
    for j in jobs:
        info = rt.jobs.import_record(j)
        if info is not None:
            restored["jobs"] += 1
    for key, value in user_kv:
        rt.kv.put("user", key, value)
        restored["kv_keys"] += 1
    return restored


def start_snapshot_loop(rt, period_s: float) -> threading.Event:
    stop = threading.Event()

    def loop():
        while not stop.wait(period_s):
            try:
                snapshot(rt)
            except Exception:
                pass  # a failed snapshot must never hurt the live cluster

    threading.Thread(target=loop, daemon=True,
                     name="rtpu-gcs-snapshot").start()
    return stop
