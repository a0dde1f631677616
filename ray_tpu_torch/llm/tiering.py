"""Tiered KV-cache: the host spill tier behind the paged prefix cache.

A copy of ``ray_tpu/llm/tiering.py`` (numpy only): the port keeps its
own instead of importing the reference package. When a refcount-0
cached page falls off the engine's LRU pool, the engine *demotes* a
host copy of its KV into a ``SpillTier`` (heat-gated by ``SpillPolicy``
from the per-chain stats of ``llm/chainstats.py``) instead of freeing
it, and a later request whose prompt chains into spilled pages
*promotes* them back onto the card at admission time, before any cold
prefill. The serving layer then makes the tier cluster-visible: staged
pages are packed into ``export_prefix``-format payloads, put into the
runtime's object store, and registered in the cluster prefix directory
as ``spill:<hash hex>`` entries beside the heat summaries
(``serve/frontdoor/prefix.py``) — so ANY replica can re-import a prefix
that NO replica still holds in device memory.

Tier mechanics:

- **demote** (engine, eviction site): the page's KV is copied to host
  numpy *before* the page id is handed back to the allocator — after
  that the device page gets overwritten. A page is captured at most
  once per content hash; re-evictions of content already in the tier
  only refresh recency (a "clean" eviction, vLLM-style).
- **staged → stored**: captured pages start *staged* (host arrays in
  this process). The replica's engine loop batches staged pages per
  chain into one export-format payload and ``ray_tpu_torch.put``s it
  (``materialize``) — *stored* entries keep only the ObjectRef + row
  index. Refs are held by the tier, so the store payload is refcounted
  and owner-swept on replica death: spill can never leak the store.
  Without a cluster runtime the tier simply stays staged — same budget,
  same promote path.
- **promote**: ``payload_for(hashes)`` rebuilds an export-format
  payload for a consecutive hash run from staged arrays and/or fetched
  store segments; the engine copies it into its cache pools in place
  through the same path as ``import_prefix``, so a promoted page is
  bit-identical to a never-evicted one.
- **budget**: tier bytes are capped by ``kv_spill_max_bytes``; over
  budget, the policy ranks victims coldest-first from the live
  ChainStatsTable (hits, then last-hit recency, then demote order) and
  expires them. Expiry/teardown drop segment refs as their last member
  leaves.

Every tier entry and every ``spill:`` directory row is a HINT.
Validate-on-promote — a payload whose hashes or page geometry don't
match the request's chain is dropped (counted ``spill_drops``) and the
request prefills cold. A stale or lost spill entry can cost latency,
never correctness.

The tier stores whatever arrays the engine hands it: the port's engine
hands it float32 pages, or bfloat16 pages as their raw 16-bit patterns
(``np.uint16``), since numpy has no bfloat16 of its own.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass
class SpillPolicy:
    """Heat-driven demote/expire/re-warm decisions, read from the
    ChainStatsTable. The default knobs admit everything and let the
    byte budget govern — at long-tail working sets the cheapest page to
    re-create is the one you never dropped — while ``min_hits`` /
    ``max_idle_s`` let deployments refuse tier residence to one-shot or
    long-idle chains outright."""

    #: chains with fewer lifetime cache hits than this are freed, not
    #: spilled (0 = spill on first eviction: the long tail's first
    #: revisit is exactly the hit the tier exists to catch)
    min_hits: int = 0
    #: > 0: chains idle longer than this many seconds demote to the
    #: floor (freed instead of spilled)
    max_idle_s: float = 0.0
    #: proactive re-warm: only chains with at least this many hits are
    #: worth device pages before a request asks for them
    rewarm_min_hits: int = 1
    #: re-warm only while at least this fraction of the pool is free —
    #: warming must never evict, only fill idle headroom
    rewarm_free_frac: float = 0.5

    def admit(self, chains, slot: Optional[int], now: float) -> bool:
        """Spill-vs-free at the eviction site. No table or no learned
        chain means no signal — admit, and let the budget expire it
        coldest-first."""
        if chains is None or not slot:
            return True
        if self.min_hits > 0 and int(chains.hits[slot]) < self.min_hits:
            return False
        if self.max_idle_s > 0 and chains.last_hit[slot] and \
                now - chains.last_hit[slot] > self.max_idle_s:
            return False
        return True

    def victim_key(self, entry: "_SpilledPage", chains, now: float):
        """Sort key for budget expiry: lowest expires first. Cold
        chains (few hits, stale last-hit) go before hot ones; within a
        chain, demote order (FIFO) breaks ties."""
        if chains is None or not entry.chain:
            return (0, 0.0, entry.seq)
        return (int(chains.hits[entry.chain]),
                float(chains.last_hit[entry.chain]), entry.seq)

    def rewarm_slot(self, chains, spilled_slots, free_frac: float):
        """The chain most worth proactively promoting — hottest spilled
        chain above ``rewarm_min_hits`` — or None when the pool lacks
        idle headroom or nothing qualifies. ``spilled_slots`` is the
        set of chain slots with pages resident in the tier."""
        if chains is None or free_frac < self.rewarm_free_frac:
            return None
        best, best_hits = None, self.rewarm_min_hits - 1
        for s in spilled_slots:
            if s and int(chains.hits[s]) > best_hits:
                best, best_hits = s, int(chains.hits[s])
        return best


class _SpilledPage:
    """One demoted page: chain attribution + either staged host arrays
    (ks/vs, one per layer) or a pointer into a stored segment."""

    __slots__ = ("chain", "seq", "ks", "vs", "seg", "row")

    def __init__(self, chain: int, seq: int, ks, vs):
        self.chain = chain
        self.seq = seq
        self.ks = ks            # staged: list[np.ndarray] per layer
        self.vs = vs
        self.seg: Optional[str] = None   # stored: segment id
        self.row: int = -1               # row inside the segment payload


class _Segment:
    """One store payload holding several pages of one chain. The ref is
    the ONLY pin on the payload: dropping it (expiry of the last
    member, teardown, replica death) frees the store object."""

    __slots__ = ("ref", "hashes", "live")

    def __init__(self, ref, hashes: list):
        self.ref = ref
        self.hashes = list(hashes)
        self.live = set(hashes)


class SpillTier:
    """Hash-keyed host tier for demoted prefix pages, byte-budgeted.

    NOT thread-safe by itself: demote/promote run on the engine's
    stepping thread under its pool lock, and the serving loop's
    materialize/publish runs on that same thread — the identical
    serialization contract as the engine structures it shadows. The
    cross-replica READ path never touches a peer's SpillTier object;
    it fetches the refcounted store payload directly."""

    def __init__(self, max_bytes: int, page_nbytes: int,
                 policy: Optional[SpillPolicy] = None):
        self.max_bytes = int(max_bytes)
        self.page_nbytes = max(int(page_nbytes), 1)
        self.policy = policy or SpillPolicy()
        # insertion order = demote order (the FIFO tie-break)
        self._pages: "OrderedDict[bytes, _SpilledPage]" = OrderedDict()
        self._segs: dict[str, _Segment] = {}
        self._seq = 0
        self._next_seg = 0
        self.resident_bytes = 0
        # directory publish deltas (drained by the serving loop)
        self._pub_new: list[bytes] = []
        self._pub_gone: list[bytes] = []
        # the live ChainStatsTable the expiry ranking reads (None = no
        # heat plane; FIFO order governs). Injected by the engine so
        # the tier never imports engine internals.
        self._chains_ref: Any = None

    # -- capacity ------------------------------------------------------

    def resident_pages(self) -> int:
        return len(self._pages)

    def has(self, h: bytes) -> bool:
        return h in self._pages

    def spilled_slots(self) -> set:
        return {e.chain for e in self._pages.values()}

    # -- demote side ---------------------------------------------------

    def touch(self, h: bytes) -> None:
        """Recency refresh for a re-eviction of content already in the
        tier (the page was promoted or re-computed, then evicted again
        — a clean eviction, nothing to copy)."""
        e = self._pages.get(h)
        if e is not None:
            self._seq += 1
            e.seq = self._seq

    def add(self, h: bytes, chain: int, ks, vs,
            now: float = 0.0) -> list:
        """Stage a captured page. Returns the entries expired to fit
        the budget as ``[(hash, chain), ...]`` so the caller can keep
        chain accounting exact. A page larger than the whole budget is
        refused (returned as its own expiry)."""
        if self.page_nbytes > self.max_bytes:
            return [(h, chain)]
        self._seq += 1
        self._pages[h] = _SpilledPage(chain, self._seq, ks, vs)
        self.resident_bytes += self.page_nbytes
        self._pub_new.append(h)
        expired = []
        if self.resident_bytes > self.max_bytes:
            expired = self._expire_over_budget(now, protect=h)
        return expired

    def _expire_over_budget(self, now: float, protect: bytes) -> list:
        chains = self._chains_ref
        order = sorted(
            ((self.policy.victim_key(e, chains, now), hh)
             for hh, e in self._pages.items() if hh != protect))
        out = []
        for _key, hh in order:
            if self.resident_bytes <= self.max_bytes:
                break
            out.append((hh, self._pages[hh].chain))
            self._drop(hh)
        return out

    def bind_chains(self, chains) -> None:
        self._chains_ref = chains

    def _drop(self, h: bytes) -> None:
        e = self._pages.pop(h, None)
        if e is None:
            return
        self.resident_bytes -= self.page_nbytes
        self._pub_gone.append(h)
        if e.seg is not None:
            seg = self._segs.get(e.seg)
            if seg is not None:
                seg.live.discard(h)
                if not seg.live:
                    del self._segs[e.seg]   # last member: drop the ref
        else:
            e.ks = e.vs = None

    def discard(self, hashes) -> list:
        """Drop entries outright (validate-on-promote failures, expiry
        sweeps). Returns ``[(hash, chain), ...]`` actually removed."""
        out = []
        for h in hashes:
            e = self._pages.get(h)
            if e is not None:
                out.append((h, e.chain))
                self._drop(h)
        return out

    def clear(self) -> list:
        """Teardown: drop everything (and thus every segment ref) so
        the store drains to exact baseline. Returns removed entries
        for accounting, like discard()."""
        return self.discard(list(self._pages))

    # -- promote side --------------------------------------------------

    def chain_of(self, h: bytes) -> int:
        e = self._pages.get(h)
        return e.chain if e is not None else 0

    def covered_run(self, hashes) -> int:
        """How many consecutive hashes from the front the tier holds."""
        n = 0
        for h in hashes:
            if h not in self._pages:
                break
            n += 1
        return n

    def payload_for(self, hashes, page_size: int, fetch=None) -> tuple:
        """-> (payload, dropped). Export-format payload for a
        consecutive run of tier-resident hashes — None when nothing
        usable (caller prefills cold). ``dropped`` lists the
        ``(hash, chain)`` entries purged by validate-on-promote
        (stale/corrupt tier content; caller counts them). ``fetch``
        resolves a stored segment's ref to its payload (the object
        store's get; None = staged-only, the engine-local default —
        stored entries just end the run there)."""
        rows: list = []           # (hash, list[k_layer], list[v_layer])
        seg_cache: dict[str, Any] = {}
        bad: list[bytes] = []
        for h in hashes:
            e = self._pages.get(h)
            if e is None:
                break
            if e.seg is None:
                if e.ks is None or e.vs is None:
                    bad.append(h)
                    break
                rows.append((h, e.ks, e.vs))
                continue
            seg = self._segs.get(e.seg)
            payload = seg_cache.get(e.seg)
            if payload is None:
                if seg is None or fetch is None:
                    break           # stored but unfetchable here: stop
                try:
                    payload = fetch(seg.ref)
                except Exception:
                    payload = None
                if not _payload_ok(payload, page_size):
                    bad.extend(seg.live)
                    break
                seg_cache[e.seg] = payload
            try:
                i = payload["page_hashes"].index(h)
                rows.append((h,
                             [lay["k"][i] for lay in payload["pages"]],
                             [lay["v"][i] for lay in payload["pages"]]))
            except (ValueError, KeyError, IndexError, TypeError):
                bad.append(h)       # segment no longer carries the hash
                break
        if bad:
            # stale/corrupt tier content: purge so the next request
            # doesn't re-validate the same garbage
            return None, self.discard(bad)
        if not rows:
            return None, []
        n_layers = len(rows[0][1])
        shapes = [np.shape(k) for k in rows[0][1]]
        for _h, ks, vs in rows:
            if len(ks) != n_layers or \
                    any(np.shape(k) != s for k, s in zip(ks, shapes)):
                return None, self.discard([_h])  # geometry drift:
                # never scatter it into the live cache pools
        return {
            "page_size": page_size,
            "page_hashes": [r[0] for r in rows],
            "pages": [{"k": np.stack([r[1][li] for r in rows]),
                       "v": np.stack([r[2][li] for r in rows])}
                      for li in range(n_layers)],
        }, []

    # -- cluster materialization (serving loop) ------------------------

    def drain_publish_delta(self) -> tuple:
        """-> (new_hashes, gone_hashes) since the last drain, filtered
        to current residence (an add-then-expire nets out)."""
        if not self._pub_new and not self._pub_gone:
            return (), ()
        new, self._pub_new = self._pub_new, []
        gone, self._pub_gone = self._pub_gone, []
        new = [h for h in dict.fromkeys(new) if h in self._pages]
        gone = [h for h in dict.fromkeys(gone) if h not in self._pages]
        return new, gone

    def requeue_publish(self, hashes) -> None:
        """Put drained hashes back on the new-delta queue — the serving
        loop's retry path when materialization (no store yet, put
        failure) couldn't mint a ref this cadence."""
        self._pub_new.extend(h for h in hashes if h in self._pages)

    def materialize(self, hashes, page_size: int, put) -> dict:
        """Pack still-staged entries among ``hashes`` into one store
        payload per chain via ``put`` (the object store's put) and
        flip them staged→stored, freeing the host copies.
        Returns {hash: ref_binary} for every requested hash resident
        in the tier (already-stored entries report their existing
        segment's ref). Failures leave entries staged — materializing
        is an optimization, never a correctness step."""
        out: dict = {}
        by_chain: dict[int, list] = {}
        for h in hashes:
            e = self._pages.get(h)
            if e is None:
                continue
            if e.seg is not None:
                seg = self._segs.get(e.seg)
                if seg is not None:
                    out[h] = seg.ref.binary()
                continue
            by_chain.setdefault(e.chain, []).append(h)
        for _chain, group in by_chain.items():
            entries = [self._pages[h] for h in group]
            n_layers = len(entries[0].ks)
            payload = {
                "page_size": page_size,
                "page_hashes": list(group),
                "pages": [{"k": np.stack([e.ks[li] for e in entries]),
                           "v": np.stack([e.vs[li] for e in entries])}
                          for li in range(n_layers)],
            }
            try:
                ref = put(payload)
            except Exception:
                continue            # no store today: stay staged
            seg_id = f"s{self._next_seg}"
            self._next_seg += 1
            self._segs[seg_id] = _Segment(ref, group)
            for i, h in enumerate(group):
                e = self._pages[h]
                e.seg, e.row = seg_id, i
                e.ks = e.vs = None
                out[h] = ref.binary()
        return out

    def stats(self) -> dict:
        return {
            "resident_pages": len(self._pages),
            "resident_bytes": self.resident_bytes,
            "max_bytes": self.max_bytes,
            "page_bytes": self.page_nbytes,
            "staged_pages": sum(1 for e in self._pages.values()
                                if e.seg is None),
            "stored_segments": len(self._segs),
        }


def _payload_ok(payload, page_size: int) -> bool:
    """Structural validation of a fetched spill payload — the
    validate-on-promote gate for store-fetched segments."""
    try:
        return (isinstance(payload, dict)
                and payload["page_size"] == page_size
                and isinstance(payload["page_hashes"], list)
                and len(payload["pages"]) > 0)
    except Exception:
        return False
