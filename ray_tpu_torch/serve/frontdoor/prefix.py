"""Cluster-wide prefix-cache directory client (replica side).

Counterpart of ``ray_tpu/serve/frontdoor/prefix.py``; payloads are host
arrays (bf16 pages as raw ``np.uint16``), as the engine's
``export_prefix`` makes them.

Every paged engine has a per-replica prefix cache: full prompt
pages content-addressed by chained hashes, admission-matched so shared
system prompts prefill once per replica. This module makes those caches
ONE cluster cache:

- **publish**: the replica's engine loop drains newly registered /
  evicted page hashes (PagedInferenceEngine.drain_directory_delta) and
  merges them into the ``serve:prefix:<model>`` shared directory,
  valued with this replica's own actor handle;
- **import**: before submitting a prompt, a replica computes the
  prompt's chain hashes, checks local coverage, and asks the directory
  about the rest. If another replica warmed a longer run, it calls that
  replica's ``export_prefix`` (pages gathered to host arrays — the
  payload rides the object store like any large actor-call result) and
  seeds its own cache via ``import_prefix``; admission then hits
  locally as if the pages had been computed here. Greedy decoding over
  imported pages is bit-identical to a cold prefill — the pages ARE
  the cold prefill's pages, moved;
- **heat**: each publish cadence also files ONE bounded summary entry
  under the string key ``"heat:<host:pid>"`` in the same directory —
  pool occupancy, hit rate, and the engine's top-K hot chains from the
  cache heat plane (llm/chainstats.py). String keys cannot collide
  with the 16-byte page-hash keys and importers only query by hash, so
  the summaries are invisible to the import path; they ride the same
  dir_update frames (no protocol change), are owner-stamped so a dead
  replica's summary sweeps with its page entries, and feed the head's
  ``cache_report()`` / ``cli cache`` cluster heat map;
- **spill** (the tiered KV-cache, llm/tiering.py): when the engine
  runs with ``kv_spill``, the publish cadence also materializes newly
  demoted pages into the host object store (SpillTier.materialize)
  and registers them as ``"spill:<hash hex>"`` string entries valued
  ``{"m": model_id, "oid": ref_binary}``. The import path queries
  both key shapes: a LIVE peer covering at least as long a run wins
  (export_prefix is one hop, no store fetch), otherwise the importer
  fetches the spill segments straight from the store — the owner
  replica need not even be alive, only its refs (held by its tier)
  must be. So a prefix NO replica holds in device memory any more is
  still one directory query + store fetch away from a warm admit.

Spill entries are hints like everything else here: a fetched payload
is validated against the requested chain before any scatter, and a
mismatch drops the stale keys, counts ``spill_drops``, and prefills
cold — latency, never correctness.

Failure model (the consistency rule the README documents): every
directory entry is a HINT. Owner dead, pages evicted, head gone — the
importer drops the stale keys (best effort) and the request prefills
cold. Nothing on this path can corrupt an answer; it can only miss a
shortcut. Sheds and deaths mid-import surface as a cold prefill, never
an error.
"""
from __future__ import annotations

import time
from typing import Any, Optional


class PrefixDirectoryClient:
    """One per LLMServer replica, on the replica's PRIMARY paged engine.

    LoRA-merged side engines stay out (different KV for the same
    tokens, unsalted chains would collide). The batched multi-LoRA
    path shares the primary engine safely: its requests hash with a
    per-(adapter_id, version) salt (llm/multilora/manager.prefix_salt),
    so directory keys are tenant-scoped by construction — a hit can
    only come from the same adapter at the same version."""

    def __init__(self, model_id: str):
        self.dir_name = f"serve:prefix:{model_id}"
        self.model_id = model_id
        self._self_handle: Any = None
        self._self_id: Optional[bytes] = None
        self._last_publish = 0.0

    def set_replica_handle(self, handle) -> None:
        """The replica's own actor handle (injected by the controller
        right after creation) — published as every entry's value so
        importers can call export_prefix on the owner."""
        self._self_handle = handle
        self._self_id = getattr(handle, "_actor_id", None)

    # -- publish ---------------------------------------------------------

    def maybe_publish(self, engine) -> int:
        """Called from the replica's engine loop (the stepping thread —
        drain_directory_delta's contract): ship accumulated page-hash
        deltas to the head, rate-limited by cfg.serve_prefix_publish_s.
        Returns hashes published."""
        if self._self_handle is None:
            return 0    # handle not injected yet: nothing to own entries
        from ...core.config import cfg
        now = time.monotonic()
        if now - self._last_publish < cfg.serve_prefix_publish_s:
            return 0
        self._last_publish = now
        new, dropped = engine.drain_directory_delta()
        put: dict = {h: self._self_handle for h in new}
        dropped = list(dropped)
        heat = self._heat_summary(engine)
        if heat is not None:
            # refreshed every cadence even with no page deltas: last-hit
            # ages and pool occupancy move while the key set stands still
            put[heat["key"]] = heat["value"]
        spill_put, spill_drop = self._spill_delta(engine)
        put.update(spill_put)
        dropped.extend(spill_drop)
        if not put and not dropped:
            return 0
        from ...core import directory as cdir
        ok = cdir.update(self.dir_name, put=put, drop=dropped)
        if ok and new:
            try:
                from .. import metrics as sm
                sm.prefix_directory_publishes().inc(
                    float(len(new)), tags={"model": self.model_id})
            except Exception:
                pass  # telemetry must never fail the engine loop
        return len(new) if ok else 0

    def _spill_delta(self, engine) -> tuple:
        """Spill-tier directory delta for this cadence: materialize
        still-staged demoted pages into the object store and return
        ({put}, [drop]) of ``spill:<hex>`` entries. Runs on the
        stepping thread (the tier's serialization contract). Best
        effort end to end — a store/put failure leaves pages staged
        and locally promotable; they re-register on a later cadence
        via materialize's already-stored reporting."""
        tier = getattr(engine, "spill", None)
        if tier is None:
            return {}, []
        try:
            new, gone = tier.drain_publish_delta()
            drop = ["spill:" + h.hex() for h in gone]
            if not new:
                return {}, drop
            import ray_tpu_torch
            oids = tier.materialize(new, engine.cfg.page_size,
                                    ray_tpu_torch.put)
            missed = [h for h in new if h not in oids]
            if missed:
                tier.requeue_publish(missed)   # retry next cadence
            put = {"spill:" + h.hex(): {"m": self.model_id, "oid": oid}
                   for h, oid in oids.items()}
            return put, drop
        except Exception:
            return {}, []   # spill publish must never fail the loop

    def _heat_summary(self, engine) -> Optional[dict]:
        """One bounded dict describing this replica's cache heat —
        {"key": "heat:<proc>", "value": {...}} — or None when the
        engine's heat plane is off. Size is capped by construction:
        top-K chain rows + a handful of pool scalars."""
        try:
            report = engine.chain_stats_report()
            if not report:
                return None
            from ...llm.telemetry import _proc
            acct = engine.prefix_accounting()
            pool = engine.pool_stats()
            page_bytes = report["table"]["page_bytes"]
            cached = acct["cached_pages"]
            return {"key": f"heat:{_proc()}", "value": {
                "model": self.model_id,
                "proc": _proc(),
                "ts": time.time(),
                "hit_rate": acct["hit_rate"],
                "pool": {
                    "free_pages": pool["free_pages"],
                    "cached_pages": cached,
                    "total_pages": pool["total_pages"],
                    "page_bytes": page_bytes,
                    # what tiering could spill today: refcount-0 pages
                    # held only for possible reuse
                    "reclaimable_bytes": cached * page_bytes,
                    # the spill tier's host-side residence (0/0 with
                    # kv_spill off)
                    "spilled_pages": acct.get("spill_resident_pages", 0),
                    "spilled_bytes": acct.get("spill_resident_bytes", 0),
                },
                "chains": report["chains"],
            }}
        except Exception:
            return None  # heat is telemetry; never fail the engine loop

    # -- import ----------------------------------------------------------

    def maybe_import(self, engine, steplock, prompt,
                     salt: bytes = b"") -> int:
        """Admission-time cross-replica import. Returns pages imported
        (0 on local-hit, no-entry, or any failure — all of which just
        mean a cold prefill). Called on a request thread; `steplock`
        serializes the cache scatter against the engine loop (the same
        contract PD-disagg's import_prefill rides). ``salt`` must match
        the submitting request's prefix_salt (tenant-scoped chains)."""
        try:
            hashes = engine.hash_prompt(prompt, salt=salt)
        except Exception:
            return 0
        if not hashes:
            return 0
        local = engine.cached_prefix_len(hashes)
        if local >= len(hashes):
            return 0    # fully covered locally: not a directory event
        from ...core import directory as cdir
        from ...core.config import cfg
        # one query, both key shapes: live replicas own the 16-byte
        # page-hash entries, the spill tier owns "spill:<hex>" strings
        tail = hashes[local:]
        got = cdir.query(self.dir_name,
                         keys=tail + ["spill:" + h.hex() for h in tail],
                         timeout=2.0)
        entries = (got or {}).get("entries") or {}
        # longest hash the cluster claims to cover, owned by a peer
        best_i, owner = -1, None
        for i in range(len(hashes) - 1, local - 1, -1):
            cand = entries.get(hashes[i])
            if cand is None:
                continue
            if self._self_id is not None and \
                    getattr(cand, "_actor_id", None) == self._self_id:
                continue    # our own publication
            best_i, owner = i, cand
            break
        # longest consecutive run the spill tier covers from `local`
        spill_i = local - 1
        while spill_i + 1 < len(hashes) and isinstance(
                entries.get("spill:" + hashes[spill_i + 1].hex()), dict):
            spill_i += 1
        if owner is None and spill_i < local:
            self._count("misses")
            return 0
        if owner is None or spill_i > best_i:
            # no live peer, or the store covers a strictly longer run
            # (ties go to the live peer: export_prefix is one hop):
            # promote straight from the object store — works even when
            # NO replica still holds these pages in device memory, and
            # the importer needs no tier of its own (import_prefix is
            # the ordinary cross-replica scatter)
            return self._import_spilled(engine, steplock, hashes,
                                        local, spill_i, entries)
        want = hashes[:best_i + 1]
        try:
            import ray_tpu_torch
            payload = ray_tpu_torch.get(
                owner.handle_request.remote(
                    "export_prefix", (want,), {}, None),
                timeout=cfg.serve_prefix_import_timeout_s)
        except Exception:
            # owner dead/slow: drop the stale hints so the next request
            # doesn't retry a dead replica, then prefill cold
            cdir.update(self.dir_name,
                        drop=[h for h in want if h in entries])
            self._count("stale")
            return 0
        if not payload:
            cdir.update(self.dir_name,
                        drop=[h for h in want if h in entries])
            self._count("stale")
            return 0
        try:
            with steplock:
                n = engine.import_prefix(payload)
        except Exception:
            # a matching hint with an incompatible payload (same
            # model_id, different engine geometry) must cost a cold
            # prefill, never the request — per the module failure model
            cdir.update(self.dir_name,
                        drop=[h for h in want if h in entries])
            self._count("stale")
            return 0
        if n > 0:
            self._count("hits")
            try:
                from .. import metrics as sm
                sm.prefix_directory_imported_pages().inc(
                    float(n), tags={"model": self.model_id})
            except Exception:
                pass  # telemetry must never fail a request
        else:
            self._count("misses")
        return n

    def _import_spilled(self, engine, steplock, hashes, local, spill_i,
                        entries) -> int:
        """Promote a consecutive spilled run straight from the host
        object store: fetch each distinct segment payload once, pull
        the run's rows in chain order, and seed the engine through the
        ordinary import_prefix scatter. Validate-on-promote per the
        module failure model — any stale/corrupt segment truncates the
        run there, drops the bad ``spill:`` keys, and counts
        ``spill_drops``; whatever validated before the break still
        imports. Returns pages imported (0 = cold prefill)."""
        from ...core import directory as cdir
        from ...core.config import cfg
        from ...core.ids import ObjectID
        from ...core.ref import ObjectRef
        from ...llm.tiering import _payload_ok
        import numpy as np
        import ray_tpu_torch
        run = hashes[local:spill_i + 1]
        page_size = engine.cfg.page_size
        seg_cache: dict = {}    # oid bytes -> payload | None (bad)
        rows: list = []         # (hash, [k per layer], [v per layer])
        stale: list = []        # spill:<hex> keys to drop
        for h in run:
            key = "spill:" + h.hex()
            e = entries.get(key)
            oid = e.get("oid") if isinstance(e, dict) else None
            if not isinstance(oid, (bytes, bytearray)) or \
                    e.get("m") != self.model_id:
                stale.append(key)
                break
            oid = bytes(oid)
            if oid not in seg_cache:
                try:
                    payload = ray_tpu_torch.get(
                        ObjectRef(ObjectID(oid)),
                        timeout=cfg.serve_prefix_import_timeout_s)
                except Exception:
                    payload = None
                if not _payload_ok(payload, page_size):
                    payload = None
                seg_cache[oid] = payload
            payload = seg_cache[oid]
            if payload is None:
                # the whole segment is gone/garbage: every run key that
                # points at this oid is equally stale
                stale.append(key)
                stale.extend(
                    "spill:" + hh.hex() for hh in run
                    if isinstance(entries.get("spill:" + hh.hex()), dict)
                    and entries["spill:" + hh.hex()].get("oid") == oid)
                break
            try:
                i = payload["page_hashes"].index(h)
                rows.append((h,
                             [lay["k"][i] for lay in payload["pages"]],
                             [lay["v"][i] for lay in payload["pages"]]))
            except Exception:
                stale.append(key)   # segment no longer carries the hash
                break
        n = 0
        if rows:
            try:
                n_layers = len(rows[0][1])
                combined = {
                    "page_size": page_size,
                    "page_hashes": [r[0] for r in rows],
                    "pages": [
                        {"k": np.stack([r[1][li] for r in rows]),
                         "v": np.stack([r[2][li] for r in rows])}
                        for li in range(n_layers)],
                }
                with steplock:
                    n = engine.import_prefix(combined)
            except Exception:
                # ragged geometry across segments, or an engine with
                # incompatible pools: cost a cold prefill, never the
                # request
                stale.extend("spill:" + r[0].hex() for r in rows)
                n = 0
        if stale:
            stale = [k for k in dict.fromkeys(stale) if k in entries]
            cdir.update(self.dir_name, drop=stale)
            engine.note_spill_drops(len(stale))
            self._count("stale")
        if n > 0:
            engine.note_spill_promotion(hashes[0], n)
            self._count("hits")
            try:
                from .. import metrics as sm
                sm.prefix_directory_imported_pages().inc(
                    float(n), tags={"model": self.model_id})
            except Exception:
                pass  # telemetry must never fail a request
        elif not stale:
            self._count("misses")
        return n

    def _count(self, which: str):
        try:
            from .. import metrics as sm
            fn = {"hits": sm.prefix_directory_hits,
                  "misses": sm.prefix_directory_misses,
                  "stale": sm.prefix_directory_stale}[which]
            fn().inc(1.0, tags={"model": self.model_id})
        except Exception:
            pass  # telemetry must never fail a request
