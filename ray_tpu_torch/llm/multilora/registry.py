"""Versioned adapter registry: train-side publish, serve-side live fetch
(counterpart of ``ray_tpu/llm/multilora/registry.py``).

Each (namespace, adapter_id) owns a DETERMINISTIC 12-byte id base;
version v's payload seals under ``slot_oid(base, v)`` — one store put per
publish, versions older than the keep window deleted (lazily safe: ids
are never reused). Metadata per adapter — {"version", "rank", "alpha",
"targets", "ts"} — answers "latest", so a serving replica resolves a
version with one lookup and fetches the payload with one store get.

A fetch of a version the keep window already reclaimed raises KeyError
and the caller re-resolves — by then the metadata names a newer version.

This is the reference's clusterless mode: payloads go to an in-process
store shared by the module (or to the ``store`` a caller passes, with
the objstore client's put/get/delete surface), and metadata to an
in-process dict, so train -> publish -> serve loops run in one process.
The clustered branch — the runtime's object store and the head's shared
directory service — is not ported yet.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Optional

from ...dag.channel import slot_oid

_DIR_PREFIX = "llm:lora:"


def _adapter_base(namespace: str, adapter_id: str) -> bytes:
    """Deterministic id base: publisher and consumers derive the same
    slot ids with no coordination beyond the metadata entry."""
    return hashlib.blake2b(
        f"llm:lora:{namespace}:{adapter_id}".encode(),
        digest_size=12).digest()


class _MemStore:
    """In-process store: the put/get/delete surface of the objstore
    client, module-shared so a trainer and an engine in one process see
    each other's publishes."""

    def __init__(self):
        self._d: dict = {}
        self._lock = threading.Lock()

    def put(self, oid, value, is_exception: bool = False):
        with self._lock:
            self._d[bytes(oid.binary())] = value

    def get(self, oid, timeout_ms: int = -1):
        with self._lock:
            key = bytes(oid.binary())
            if key not in self._d:
                raise KeyError("object not found")
            return self._d[key]

    def delete(self, oid):
        with self._lock:
            self._d.pop(bytes(oid.binary()), None)


_mem_store = _MemStore()
# version metadata, shared in-process
_mem_meta: dict = {}
_mem_lock = threading.Lock()


class AdapterRegistry:
    """Publish/fetch versioned LoRA adapters for one namespace (one
    served base model). Payloads are llm/lora.py adapter dicts."""

    def __init__(self, namespace: str = "default", keep: int = 4,
                 store: Optional[Any] = None):
        self.namespace = namespace
        self.dir_name = _DIR_PREFIX + namespace
        # keep >= 2: a replica that just resolved v must still be able
        # to fetch it after the trainer publishes v+1 (WeightBroadcast's
        # keep rule)
        self.keep = max(2, int(keep))
        self._store = store

    # -- plumbing --------------------------------------------------------

    def _resolve_store(self):
        if self._store is None:
            self._store = _mem_store
        return self._store

    def _meta_lookup(self, adapter_id: Optional[str] = None) -> dict:
        """{adapter_id: meta} from the in-process metadata dict."""
        with _mem_lock:
            d = _mem_meta.get(self.dir_name, {})
            if adapter_id is None:
                return dict(d)
            return ({adapter_id: d[adapter_id]}
                    if adapter_id in d else {})

    def _meta_publish(self, adapter_id: str, meta: dict) -> None:
        with _mem_lock:
            _mem_meta.setdefault(self.dir_name, {})[adapter_id] = meta

    # -- the registry surface --------------------------------------------

    def publish(self, adapter_id: str, adapter: dict,
                meta: Optional[dict] = None) -> int:
        """One store put + one metadata update; returns the new version.
        The payload is the adapter dict itself (small: two rank-r
        factors per target)."""
        store = self._resolve_store()
        base = _adapter_base(self.namespace, adapter_id)
        cur = self.latest_version(adapter_id)
        v = 0 if cur is None else cur + 1
        store.put(slot_oid(base, v), {"version": v, "ts": time.time(),
                                   "adapter": dict(adapter)})
        entry = {"version": v, "ts": time.time(),
                 "rank": int(adapter.get("rank", 4)),
                 "alpha": float(adapter.get("alpha", 0.0)),
                 "targets": sorted(k[:-2] for k in adapter
                                   if k.endswith(".A"))}
        if meta:
            entry.update(meta)
        self._meta_publish(adapter_id, entry)
        if v >= self.keep:
            try:
                store.delete(slot_oid(base, v - self.keep))
            except Exception:
                pass  # already reclaimed (store pressure / republish race)
        try:
            from .. import telemetry as lt
            lt.lora_publishes().inc(1.0, tags={"namespace": self.namespace})
        except Exception:
            pass  # telemetry must never fail a publish
        return v

    def latest_version(self, adapter_id: str) -> Optional[int]:
        entry = self._meta_lookup(adapter_id).get(adapter_id)
        return None if entry is None else int(entry["version"])

    def list(self) -> dict:
        """{adapter_id: meta} for every published adapter."""
        return self._meta_lookup()

    def fetch(self, adapter_id: str,
              version: Optional[int] = None) -> tuple:
        """-> (version, adapter dict). Raises KeyError for an unknown
        adapter or a version the keep window already reclaimed (callers
        re-resolve latest and retry — the metadata names a newer one
        by then)."""
        if version is None:
            version = self.latest_version(adapter_id)
            if version is None:
                raise KeyError(
                    f"adapter {adapter_id!r} not in registry "
                    f"{self.namespace!r}")
        store = self._resolve_store()
        base = _adapter_base(self.namespace, adapter_id)
        try:
            payload = store.get(slot_oid(base, version), timeout_ms=5000)
        except Exception as e:
            raise KeyError(
                f"adapter {adapter_id!r} v{version} is not fetchable "
                f"(reclaimed by the keep window, or never published)"
            ) from e
        if payload is None or payload.get("version") != version:
            raise KeyError(
                f"adapter {adapter_id!r} v{version} payload missing")
        return version, payload["adapter"]
