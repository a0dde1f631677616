"""Resident-adapter lifecycle: registry -> slot table, LRU, hot-swap
(counterpart of ``ray_tpu/llm/multilora/manager.py``).

One per serving engine (``llm/serving.py`` builds it when the paged
engine has a slot table). ``resolve(adapter_id)`` is the admission-time
hook:

1. the adapter's LATEST version comes from the registry, TTL-cached
   (``cfg.llm_lora_refresh_s``) so the request path pays at most one
   lookup per refresh window per adapter;
2. if (adapter_id, version) is already resident, the request rides its
   slot — and the slot's LRU position refreshes;
3. otherwise the payload is fetched and installed into a slot: a free
   one, else the least-recently-used slot with ZERO in-flight requests
   (``engine.adapter_slots_in_use`` — a live slot is never stolen, so
   in-flight requests stay pinned to their admitted version). All slots
   live -> RuntimeError, surfaced as a retryable overload by the
   serving layer.

Hot-swap is just (2)+(3) observing a newer version: the new version
lands in a DIFFERENT slot while v_old keeps serving its in-flight
requests; the old slot ages out of the LRU once they retire.

Prefix isolation: ``prefix_salt(adapter_id, version)`` seeds the
engine's page-hash chains (byte-equal to the reference's), so cached
pages are keyed per (adapter_id, version) and never cross tenants — or
versions (v2's pages must not serve a v1 request: different weights,
different K/V).
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Optional

from .registry import AdapterRegistry


def prefix_salt(adapter_id: str, version: int) -> bytes:
    """Chain seed for an adapter request's page hashes (empty for
    base). Digest-sized like the chain links, deterministic across
    processes so PD-disagg payloads and directory entries interoperate."""
    return hashlib.blake2b(
        f"lora:{adapter_id}@{version}".encode(), digest_size=16).digest()


class MultiLoraManager:
    """Maps (adapter_id, version) -> resident slot for one engine."""

    def __init__(self, engine, registry: Optional[AdapterRegistry] = None,
                 namespace: str = "default",
                 refresh_s: Optional[float] = None):
        if getattr(engine, "lora", None) is None:
            raise ValueError("engine has no adapter slot table "
                             "(PagedEngineConfig.max_adapters == 0)")
        self.engine = engine
        self.registry = registry or AdapterRegistry(namespace)
        if refresh_s is None:
            from ...core.config import cfg as rcfg
            refresh_s = rcfg.llm_lora_refresh_s
        self.refresh_s = float(refresh_s)
        self._lock = threading.Lock()
        # (adapter_id, version) -> slot            guarded by: self._lock
        self._slot_of: dict[tuple, int] = {}
        # slot -> (adapter_id, version), LRU order (oldest first)
        self._resident: "OrderedDict[int, tuple]" = OrderedDict()
        self._free = list(range(1, engine.lora.max_adapters))
        # slot -> resolve-to-submit reservation count; the eviction scan
        # treats a pinned slot exactly like a live one. Needed because
        # the engine only counts a request from submit() on, but the
        # serving layer does work (tokenize, cross-replica prefix
        # import) between resolve() and submit() — without the pin a
        # concurrent cold resolve could steal the slot in that window
        # and the request would decode with another tenant's weights.
        self._pins: dict[int, int] = {}        # guarded by: self._lock
        # adapter_id -> (expires_monotonic, version)
        self._latest_cache: dict[str, tuple] = {}
        self.stats = {"loads": 0, "evictions": 0, "swaps": 0,
                      "requests": 0, "hits": 0}

    # -- version resolution ----------------------------------------------

    def _latest(self, adapter_id: str) -> int:
        now = time.monotonic()
        hit = self._latest_cache.get(adapter_id)
        if hit is not None and hit[0] > now:
            return hit[1]
        v = self.registry.latest_version(adapter_id)
        if v is None:
            raise KeyError(
                f"adapter {adapter_id!r} is not in registry "
                f"{self.registry.namespace!r}")
        self._latest_cache[adapter_id] = (now + self.refresh_s, v)
        return v

    # -- the admission hook ----------------------------------------------

    def resolve(self, adapter_id: str, steplock=None,
                version: Optional[int] = None,
                pin: bool = False) -> tuple:
        """-> (slot, version, salt) for a request naming ``adapter_id``.
        ``steplock`` serializes a cold load's device scatter against the
        engine loop (serving passes its step lock; single-threaded
        callers may omit it). ``pin=True`` reserves the slot against
        eviction until ``unpin(slot)`` — REQUIRED for concurrent
        callers that do work between resolve and engine.submit (the
        engine's own in-flight accounting starts only at submit)."""
        if version is None:
            version = self._latest(adapter_id)
        key = (adapter_id, version)
        with self._lock:
            self.stats["requests"] += 1
            slot = self._slot_of.get(key)
            if slot is not None:
                self._resident.move_to_end(slot)
                self.stats["hits"] += 1
                if pin:
                    self._pins[slot] = self._pins.get(slot, 0) + 1
                self._telemetry()
                return slot, version, prefix_salt(adapter_id, version)
        # cold: fetch OUTSIDE the manager lock (a store get can block;
        # concurrent resolves of the same key are de-duped below)
        _, adapter = self.registry.fetch(adapter_id, version)
        with self._lock:
            raced = self._slot_of.get(key)
            if raced is not None:
                self._resident.move_to_end(raced)
                if pin:
                    self._pins[raced] = self._pins.get(raced, 0) + 1
                self._telemetry()
                return raced, version, prefix_salt(adapter_id, version)
            slot = self._claim_slot_locked()
            # the row is DIRTY from the first scatter on: unmap its old
            # resident before loading, and on a failed load clear the
            # row back to the base no-op — a partially written slot
            # must never stay addressable under any adapter's name
            prev = self._resident.pop(slot, None)
            if prev is not None:
                self._slot_of.pop(prev, None)
            try:
                if steplock is not None:
                    with steplock:
                        self.engine.load_adapter_slot(slot, adapter)
                else:
                    self.engine.load_adapter_slot(slot, adapter)
            except BaseException:
                try:
                    if steplock is not None:
                        with steplock:
                            self.engine.load_adapter_slot(slot, None)
                    else:
                        self.engine.load_adapter_slot(slot, None)
                except Exception:
                    pass  # row stays dirty but unmapped (never served)
                self._free.append(slot)
                raise
            self._slot_of[key] = slot
            self._resident[slot] = key
            if pin:
                self._pins[slot] = self._pins.get(slot, 0) + 1
            self.stats["loads"] += 1
            if any(aid == adapter_id and v != version
                   for aid, v in self._slot_of):
                # an older version is still resident (likely pinned by
                # in-flight requests): this load IS a hot-swap
                self.stats["swaps"] += 1
            self._telemetry()
            return slot, version, prefix_salt(adapter_id, version)

    def unpin(self, slot: int) -> None:
        """Drop one resolve-time reservation (call once the request has
        been submitted — the engine's in-flight count covers it from
        there — or the submit failed)."""
        with self._lock:
            n = self._pins.get(slot, 0) - 1
            if n > 0:
                self._pins[slot] = n
            else:
                self._pins.pop(slot, None)

    def _claim_slot_locked(self) -> int:
        """A slot to load into: free first, else the LRU slot with no
        in-flight requests AND no resolve-time pins. Never a live slot
        — in-flight requests are pinned to their admitted version's
        weights."""
        if self._free:
            return self._free.pop()
        live = self.engine.adapter_slots_in_use()
        for slot in self._resident:            # oldest first
            if not live.get(slot) and not self._pins.get(slot):
                self.stats["evictions"] += 1
                return slot
        raise RuntimeError(
            "overloaded: all adapter slots have in-flight requests; "
            "retry shortly (raise PagedEngineConfig.max_adapters to "
            "hold more resident adapters)")

    # -- observability ----------------------------------------------------

    def resident(self) -> dict:
        """{slot: (adapter_id, version)} currently installed."""
        with self._lock:
            return dict(self._resident)

    def _telemetry(self):
        try:
            from .. import telemetry as lt
            lt.on_lora_stats(self)
        except Exception:
            pass  # telemetry must never fail the request path
