"""Cluster-shared directory service (protocol v7).

Head-side named maps any peer can merge into (``dir_update``, async
fire-and-forget) and read from (``dir_query``, answered inline on the
head's recv thread — a pure dict read, so lookups on request hot paths
never queue behind the rpc pool). The serve front door rides two of
these: ``serve:routes`` (the proxies' shared route table, one snapshot
entry the controller republishes on every topology change) and
``serve:prefix:<model>`` (the cluster-wide prefix-cache directory:
chained page hash -> owning replica). The prefix directories also
carry two string-keyed entry families beside the 16-byte page hashes
— ``"heat:<proc>"`` replica cache summaries and, under the tiered
KV-cache, ``"spill:<hash hex>" -> {"m": model, "oid": ref bytes}``
rows pointing at store-materialized demoted pages. String keys cannot
collide with hash keys; both families are owner-stamped like any
entry, so they sweep with their replica.

Consistency model — entries are HINTS, never correctness:

- merges are last-write-wins per key, with no cross-key atomicity;
- a reader may see an entry whose owner has since died, evicted the
  underlying state, or republished elsewhere. Readers MUST validate on
  use (call the owner; on failure drop the keys and fall back) — the
  serve prefix importer re-prefills cold when a hint goes stale, so a
  stale directory can cost latency, never wrong bytes;
- entries published by a worker are owner-stamped with its wid and
  swept when that worker disconnects, bounding how long dead hints
  survive; per-directory entry counts are capped FIFO
  (cfg.dir_max_entries), so the head's memory is bounded no matter how
  many pages the fleet publishes.

Wire shapes::

    {"t": "dir_update", "d": name, "put": {key: value}, "drop": [key]}
    {"t": "dir_query", "d": name, "keys": [key] | None,
     "reply_oid": bytes}                       # None = whole directory

The query reply rides the existing ``rpc_reply`` plumbing (worker
_rpc_frame), status-tupled like every head rpc.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Iterable, Optional


class DirectoryService:
    """The head-side store behind dir_update/dir_query frames."""

    def __init__(self, max_entries: Optional[int] = None):
        if max_entries is None:
            from .config import cfg
            max_entries = cfg.dir_max_entries
        self._max = max(int(max_entries), 1)
        self._lock = threading.Lock()
        # name -> OrderedDict{key: (value, owner)} — guarded by: self._lock
        self._dirs: dict[str, "OrderedDict[Any, tuple]"] = {}
        # name -> monotonically increasing mutation count
        self._versions: dict[str, int] = {}    # guarded by: self._lock
        self._evictions = 0                    # guarded by: self._lock

    def merge(self, name: str, put: Optional[dict] = None,
              drop: Optional[Iterable] = None,
              owner: Optional[str] = None) -> int:
        """Apply a dir_update; returns the directory's new version.
        Re-put refreshes a key's FIFO position (the eviction order is
        oldest-write-first, so live prefixes keep re-arming)."""
        with self._lock:
            d = self._dirs.get(name)
            if d is None:
                d = self._dirs[name] = OrderedDict()
            changed = False
            for k in (drop or ()):
                if d.pop(k, None) is not None:
                    changed = True
            for k, v in (put or {}).items():
                d[k] = (v, owner)
                d.move_to_end(k)
                changed = True
            while len(d) > self._max:
                d.popitem(last=False)
                self._evictions += 1
                changed = True
            if changed:
                self._versions[name] = self._versions.get(name, 0) + 1
            return self._versions.get(name, 0)

    def lookup(self, name: str, keys: Optional[Iterable] = None) -> dict:
        """-> {"v": version, "entries": {key: value}}; with keys=None the
        whole directory (route-table snapshots are single-key, so this
        stays cheap)."""
        with self._lock:
            d = self._dirs.get(name) or {}
            if keys is None:
                entries = {k: v for k, (v, _o) in d.items()}
            else:
                entries = {}
                for k in keys:
                    got = d.get(k)
                    if got is not None:
                        entries[k] = got[0]
            return {"v": self._versions.get(name, 0), "entries": entries}

    def lookup_prefix(self, name: str, prefix: str) -> dict:
        """-> {key: value} for string keys starting with `prefix`. The
        cache heat plane files one bounded per-replica summary under a
        ``"heat:<proc>"`` string key next to the (bytes-keyed) page
        entries; this reads just those summaries without copying the
        up-to-64k page hashes a full lookup() would."""
        with self._lock:
            d = self._dirs.get(name) or {}
            return {k: v for k, (v, _o) in d.items()
                    if isinstance(k, str) and k.startswith(prefix)}

    def sweep_owner(self, wid: str) -> int:
        """Drop every entry a disconnected worker published; returns the
        number of entries removed."""
        swept = 0
        with self._lock:
            for name, d in self._dirs.items():
                stale = [k for k, (_v, o) in d.items() if o == wid]
                for k in stale:
                    del d[k]
                if stale:
                    swept += len(stale)
                    self._versions[name] = self._versions.get(name, 0) + 1
        return swept

    def stats(self) -> dict:
        with self._lock:
            return {"directories": {n: len(d)
                                    for n, d in self._dirs.items()},
                    "evictions": self._evictions}


# ------------------------------------------------------------------ #
# client helpers (worker / driver / head-local)
# ------------------------------------------------------------------ #

def update(name: str, put: Optional[dict] = None,
           drop: Optional[Iterable] = None) -> bool:
    """Merge entries into a head directory. Fire-and-forget from workers
    and drivers (one async frame, owner-stamped by the head from the
    sending connection); a direct call on the head. Returns False when
    no cluster runtime exists (local mode) — callers treat the
    directory as absent, never an error."""
    from . import runtime as rt_mod
    rt = rt_mod.get_runtime_if_exists()
    if rt is None:
        return False
    if isinstance(rt, rt_mod.Runtime):
        rt.dirs.merge(name, put, drop, owner="head")
        return True
    send = getattr(rt, "send_async", None)
    if send is None:
        return False  # local-mode runtime: no control plane
    try:
        send({"t": "dir_update", "d": name,
              "put": dict(put) if put else None,
              "drop": list(drop) if drop else None})
        return True
    except Exception:
        return False  # head restarting; hints can wait for the next drain


def query(name: str, keys: Optional[Iterable] = None,
          timeout: float = 5.0) -> Optional[dict]:
    """Read entries from a head directory: {"v": int, "entries": {...}}.
    None when no cluster runtime / the head is unreachable — absence of
    the directory, not failure, per the hint contract."""
    from . import runtime as rt_mod
    rt = rt_mod.get_runtime_if_exists()
    if rt is None:
        return None
    if isinstance(rt, rt_mod.Runtime):
        return rt.dirs.lookup(name, keys)
    if not hasattr(rt, "_rpc_frame"):
        return None  # local-mode runtime
    try:
        return rt._rpc_frame(
            {"t": "dir_query", "d": name,
             "keys": list(keys) if keys is not None else None},
            f"dir_query {name}", timeout=timeout)
    except Exception:
        # head unreachable / timeout: the directory is a hint service,
        # absence is a valid answer and the caller falls back cold
        return None
