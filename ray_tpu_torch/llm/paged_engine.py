"""Paged-KV continuous-batching engine in PyTorch (counterpart of
``ray_tpu/llm/paged_engine.py``, the reference's production serving path).

The KV cache is a pool of fixed-size pages shared by all sequences; each
request owns a block table of page ids, so cache capacity is bounded by
tokens in flight, and attention (``ops.ragged_paged_attention``: the
Hopper kernel on the card) reads only the pages a sequence uses.

Three dispatch families, as in the reference:
  - chunked prefill: up to ``prefill_rows`` page-aligned chunk-rows per
    dispatch, run in order so consecutive rows may be consecutive chunks
    of one prompt (a long prompt never stalls every decode slot);
  - windowed decode: ``decode_window`` tokens for every decode-ready slot
    per dispatch, each step's sampled tokens fed straight back ON THE
    DEVICE; only the [B, w] token block crosses to the host, once per
    dispatch (window 1 while prompts are pending keeps TTFT low);
  - speculative verify: prompt-lookup drafts checked in one dispatch.

Sampling runs on the device inside each dispatch. The Python loop does
admission, page allocation, the prefix cache and retirement. Forwards
write K/V into the persistent per-layer cache tensors in place.

PyTorch runs eagerly, so nothing is compiled per shape: dispatches carry
exactly their real rows (the reference padded row counts to powers of
two to bound its compiled programs). Block tables are still sliced to
power-of-two page buckets (``_page_bucket``): the width bounds the plain
version's gather and keeps every write inside the table.

Observability as in the reference: the telemetry hooks
(``llm/telemetry.py``: the ``rtpu_llm_*`` series), ``PREFIX_EVICT``
flight events on eviction, and a step profiler (``util/profiling.py``)
around every dispatch, with ``estimate_flops()`` and
``profile_summary()``.

Not ported yet (the config fields raise NotImplementedError when set):
multi-LoRA (``max_adapters``, ``lora_*``), the host spill tier
(``kv_spill*``) and mesh-parallel serving (``mesh``). Also absent: PD
export/import, cross-replica prefix import/export and the prefix
directory's publish tracking (``prefix_imported_pages`` and
``prefix_exported_pages`` stay 0).
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Optional

import numpy as np
import torch

from ..core import flight
from ..models import llama
from ..util.profiling import StepProfiler, compiled_flops
from . import telemetry
from .engine import (  # noqa: F401 — SamplingParams re-exported
    SamplingParams, _EngineBase, _Request, sample_logits_batch,
    step_generator,
)
from .tokenizer import get_tokenizer

#: config fields of engine features not ported yet: field -> feature
_NOT_PORTED = {
    "max_adapters": "batched multi-LoRA",
    "lora_rank": "batched multi-LoRA",
    "lora_targets": "batched multi-LoRA",
    "kv_spill": "the tiered KV spill cache",
    "kv_spill_max_bytes": "the tiered KV spill cache",
    "kv_spill_min_hits": "the tiered KV spill cache",
    "kv_spill_max_idle_s": "the tiered KV spill cache",
    "mesh": "mesh-parallel serving",
}

#: prefix_accounting()'s spill-tier keys (0: the tier is not ported)
_SPILL_KEYS = ("spill_pages", "spill_bytes", "spill_demotions",
               "spill_promotions", "spill_expired", "spill_drops",
               "spill_resident_pages", "spill_resident_bytes")


@dataclasses.dataclass
class PagedEngineConfig:
    model: llama.LlamaConfig
    max_batch_size: int = 8
    page_size: int = 16
    num_pages: int = 512
    max_pages_per_seq: int = 64
    # prefill chunk (page multiple); up to prefill_rows chunks per step
    chunk_size: int = 128
    # chunk-rows per prefill dispatch and decode steps per decode
    # dispatch; the window applies only when no prefill is pending
    prefill_rows: int = 4
    decode_window: int = 8
    # speculative decoding (prompt-lookup n-gram drafts, greedy only):
    # propose up to spec_tokens tokens by matching the last spec_ngram
    # tokens against the sequence's own history, verify them in ONE
    # dispatch and accept the longest agreeing prefix (exact greedy).
    # An acceptance EMA falls back to windowed decode when drafts stop
    # landing. 0 disables.
    spec_tokens: int = 0
    spec_ngram: int = 2
    # block-table page bucketing: each dispatch slices its tables to the
    # smallest power-of-two page count (floor 4, clamped to
    # max_pages_per_seq) covering live pages PLUS the dispatch's writes.
    # "auto" engages at max_pages_per_seq >= 48; "on"/"off" force it.
    page_buckets: str = "auto"
    # not ported yet: must stay at their defaults (see _NOT_PORTED)
    max_adapters: int = 0
    lora_rank: int = 8
    lora_targets: tuple = ("wq", "wk", "wv", "wo", "lm_head")
    # automatic prefix caching (vLLM-style block-hash reuse): retired
    # requests park their full KV pages in a content-addressed LRU pool;
    # a later prompt sharing a page-aligned prefix maps those pages into
    # its table and starts prefill at the first uncached chunk. Shared
    # pages are refcounted and read-only; the LRU pool is reclaimed
    # page by page under allocation pressure.
    enable_prefix_caching: bool = True
    # per-chain prefix-cache stats (llm/chainstats.py), fixed memory,
    # observation only. 0 disables.
    chain_stats_slots: int = 256
    chain_stats_top_k: int = 8
    kv_spill: bool = False
    kv_spill_max_bytes: int = 64 << 20
    kv_spill_min_hits: int = 0
    kv_spill_max_idle_s: float = 0.0
    mesh: Any = None
    tokenizer: Any = None

    def __post_init__(self):
        for f in dataclasses.fields(self):
            if f.name in _NOT_PORTED and \
                    getattr(self, f.name) != f.default:
                raise NotImplementedError(
                    f"PagedEngineConfig.{f.name}: {_NOT_PORTED[f.name]} "
                    f"is not ported to ray_tpu_torch yet")
        if self.chunk_size % self.page_size:
            raise ValueError("chunk_size must be a multiple of page_size")
        if self.prefill_rows < 1 or self.decode_window < 1:
            raise ValueError("prefill_rows and decode_window must be >= 1")
        if self.page_buckets not in ("auto", "on", "off"):
            raise ValueError("page_buckets must be 'auto', 'on' or 'off'")
        if self.chain_stats_slots < 0 or self.chain_stats_top_k < 1:
            raise ValueError("chain_stats_slots must be >= 0 and "
                             "chain_stats_top_k >= 1")

    @property
    def max_seq_len(self) -> int:
        return self.max_pages_per_seq * self.page_size


class PagedInferenceEngine(_EngineBase):
    """Synchronous paged engine. ``device`` defaults to CUDA and raises
    when it is absent; pass ``device="cpu"`` for the plain versions."""

    telemetry_kind = "paged"

    def __init__(self, cfg: PagedEngineConfig, params: Optional[dict] = None,
                 rng_seed: int = 0, device="cuda"):
        self.cfg = cfg
        mc = cfg.model
        self.device = llama.resolve_device(device)
        self.tokenizer = get_tokenizer(cfg.tokenizer)
        if params is None:
            params = llama.init(mc, seed=rng_seed, device=self.device)
        self.params = params
        self.caches = llama.init_paged_cache(mc, cfg.num_pages,
                                             cfg.page_size,
                                             device=self.device)
        # page 0 is the write sink for idle rows and pad pages (never
        # attended); it is never allocated to a sequence
        self._free_pages = list(range(1, cfg.num_pages))
        self._free_slots = deque(range(cfg.max_batch_size))
        self._block_tables = np.zeros(
            (cfg.max_batch_size, cfg.max_pages_per_seq), np.int32)
        self._lengths = np.zeros((cfg.max_batch_size,), np.int32)
        self._active: dict[int, _Request] = {}
        self._prefilling: list[_Request] = []   # admitted, prompt not done
        self._pending: deque[_Request] = deque()
        # -- prefix cache state (enable_prefix_caching) -------------------
        # Full pages are content-addressed by a chained hash
        # h_i = H(h_{i-1} || page_token_ids): a page's key encodes its
        # whole prefix. _page_refs counts live references per page; pages
        # at refcount zero that hold published content park in
        # _cached_lru (insertion order = eviction order) instead of the
        # free list, and are reclaimed LRU-first under pressure.
        self._prefix_on = bool(cfg.enable_prefix_caching)
        self._page_refs = np.zeros((cfg.num_pages,), np.int32)
        self._hash_to_page: dict[bytes, int] = {}
        self._page_to_hash: dict[int, bytes] = {}
        self._cached_lru: "OrderedDict[int, None]" = OrderedDict()
        # per-chain heat table: observation only. _chain_of maps a
        # registered page to the chain slot it was published under.
        self.chains = None
        self._chain_of: dict[int, int] = {}
        page_nbytes = sum(
            t.numel() * t.element_size()
            for layer in self.caches for t in (layer["k"], layer["v"])
        ) // max(cfg.num_pages, 1)
        if self._prefix_on and cfg.chain_stats_slots > 0:
            from .chainstats import ChainStatsTable
            self.chains = ChainStatsTable(cfg.chain_stats_slots,
                                          page_nbytes)
        self._next_rid = 0
        self._rng_seed = rng_seed ^ 0x5EED
        self._rng_ctr = 0
        self._lock = threading.Lock()
        self._bucketing = cfg.page_buckets == "on" or (
            cfg.page_buckets == "auto" and cfg.max_pages_per_seq >= 48)
        # dispatches per family, spec accept stats, prefix-cache counters
        self.stats = {"prefill_dispatches": 0, "decode_dispatches": 0,
                      "spec_dispatches": 0, "spec_proposed": 0,
                      "spec_accepted": 0, "tokens_out": 0,
                      # full prompt pages served from cache vs computed,
                      # LRU pages reclaimed under pressure, and prompt
                      # tokens whose prefill was skipped
                      "prefix_hits": 0, "prefix_misses": 0,
                      "prefix_evictions": 0, "prefix_tokens_saved": 0,
                      # pages seeded from / gathered for another replica
                      # (cross-replica prefix sharing): 0 until it is
                      # ported
                      "prefix_imported_pages": 0,
                      "prefix_exported_pages": 0}
        # speculation controller: EMA of tokens per slot per spec
        # dispatch (starts optimistic) and a cooldown of windowed
        # dispatches before re-probing
        self._spec_gain = float(cfg.spec_tokens + 1)
        self._spec_cooldown = 0
        self._spec_cooldown_len = 8    # doubles per failed probe, to 256
        # step profiler: first-dispatch-vs-later wall split per family
        # and static key; feeds profile_summary()'s MFU once
        # estimate_flops() has run
        self.profiler = StepProfiler("paged_engine", device=self.device)

    # -- host <-> device ---------------------------------------------------

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    @staticmethod
    def _sampling_mode(reqs) -> tuple:
        reqs = list(reqs)
        any_sampled = any(r.params.temperature > 0 for r in reqs)
        any_topk = any_sampled and any(
            r.params.top_k > 0 and r.params.temperature > 0 for r in reqs)
        want_logp = any(r.params.logprobs for r in reqs)
        return any_sampled, any_topk, want_logp

    # -- block-table page buckets -----------------------------------------

    _PAGE_BUCKET_FLOOR = 4

    def _page_bucket(self, need_pages: int) -> int:
        """Block-table width for a dispatch that must address
        ``need_pages`` logical pages (live prefix + every position the
        dispatch writes: a write past the width would index out of the
        table instead of landing in the zero/sink entries beyond a row's
        allocation). Power of two, floored at 4, clamped to
        max_pages_per_seq; the full width when bucketing is off."""
        maxp = self.cfg.max_pages_per_seq
        if not self._bucketing:
            return maxp
        need = max(int(need_pages), 1)
        return min(maxp, max(self._PAGE_BUCKET_FLOOR,
                             1 << (need - 1).bit_length()))

    # -- dispatch families -------------------------------------------------

    def _decode_window(self, w: int, mode: tuple, tokens, bt, lengths,
                       temps, top_ks):
        """One dispatch = w decode steps for every slot, each step's
        sampled tokens fed back on the device. Returns host arrays
        (tokens [B, w], logprobs [B, w] or None)."""
        any_sampled, any_topk, want_logp = mode
        mc, page = self.cfg.model, self.cfg.page_size
        toks, bt_d, lens = self._dev(tokens), self._dev(bt), \
            self._dev(lengths)
        temps_d, topks_d = self._dev(temps), self._dev(top_ks)
        outs, lps = [], []
        for i in range(w):
            logits, _ = llama.decode_paged(
                self.params, toks[:, None], self.caches, bt_d, lens, mc,
                page_size=page)
            gen = (step_generator(self._rng_seed, self._rng_ctr, i,
                                  self.device) if any_sampled else None)
            toks, lp = sample_logits_batch(
                logits, gen, temps_d, topks_d, any_sampled=any_sampled,
                any_topk=any_topk, want_logp=want_logp)
            lens = lens + 1
            outs.append(toks)
            lps.append(lp)
        out = torch.stack(outs, dim=1).cpu().numpy()
        if not want_logp:
            return out, None
        return out, torch.stack(lps, dim=1).cpu().numpy()

    def _prefill_rows(self, mode: tuple, chunks, bts, sps, tls, temps,
                      top_ks):
        """One dispatch = the given chunk-rows in order, then sampling of
        each row's last-token logits (used for prompt-completing rows)."""
        any_sampled, any_topk, want_logp = mode
        last, _ = llama.prefill_paged_rows(
            self.params, self._dev(chunks), self.caches, self._dev(bts),
            self._dev(sps), self._dev(tls), self.cfg.model,
            page_size=self.cfg.page_size)
        gen = (step_generator(self._rng_seed, self._rng_ctr, 0, self.device)
               if any_sampled else None)
        toks, lps = sample_logits_batch(
            last, gen, self._dev(temps), self._dev(top_ks),
            any_sampled=any_sampled, any_topk=any_topk, want_logp=want_logp)
        return (toks.cpu().numpy(),
                None if lps is None else lps.cpu().numpy())

    def _verify_rows(self, toks, bts, starts, want_logp: bool):
        """One dispatch = verify rows of s1 = 1+drafts tokens; returns the
        greedy next token AT each fed position [r, s1] (and its
        log-probability when asked)."""
        logits, _ = llama.verify_paged_rows(
            self.params, self._dev(toks), self.caches, self._dev(bts),
            self._dev(starts), self.cfg.model, page_size=self.cfg.page_size)
        y = torch.argmax(logits, dim=-1).to(torch.int32)
        if not want_logp:
            return y.cpu().numpy(), None
        lp = torch.log_softmax(logits, dim=-1).gather(
            -1, y[..., None].long())[..., 0]
        return y.cpu().numpy(), lp.cpu().numpy()

    # -- public API --------------------------------------------------------

    def warmup(self, sample_modes=((False, False),)) -> float:
        """Pay one-time costs before serving traffic; returns seconds.

        Builds (or loads) the CUDA kernel library when the engine runs on
        the card, and runs one dummy dispatch per family (verify only
        with speculation on) and sampling mode, given as (any_sampled,
        any_topk[, want_logp]), so library handles and allocator pools
        exist before the first request. Each dummy dispatch is booked in
        the step profiler through ``record_compile`` at the key it ran
        under, as the reference books its warmup compiles. Dummy
        dispatches carry zero block tables and zero true lengths: every
        write routes to sink page 0 and no visible engine state changes.
        Eager PyTorch compiles nothing per shape, so one dispatch per
        family covers every later shape."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from ..ops import _build
            _build.load("ragged_paged_attention")
        cfg = self.cfg
        modes = [tuple(m) + (False,) * (3 - len(m)) for m in sample_modes]
        kinds = [("prefill", (1, m, self._page_bucket(1))) for m in modes] \
            + [("decode", (1, m, self._page_bucket(1))) for m in modes]
        if cfg.spec_tokens > 0:
            kinds.append(("verify", (1, cfg.spec_tokens + 1,
                                     self._page_bucket(1), False)))
        for kind, key in kinds:
            tw = time.perf_counter()
            fn, *args = self._dispatch_for_key(kind, key)
            fn(*args)
            self.profiler.record_compile(time.perf_counter() - tw, kind, key)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def has_work(self) -> bool:
        return bool(self._pending or self._prefilling or self._active)

    # -- page allocation ---------------------------------------------------

    def _pages_needed(self, tokens: int) -> int:
        return (tokens + self.cfg.page_size - 1) // self.cfg.page_size

    def _pages_avail(self) -> int:
        """Pages allocatable right now: truly free + LRU-reclaimable."""
        return len(self._free_pages) + len(self._cached_lru)

    def _pop_free_page(self) -> int:
        """One allocatable page; evicts the least-recently-used
        unreferenced cached page when the free list is dry. Callers must
        check _pages_avail() first."""
        if self._free_pages:
            return self._free_pages.pop()
        pid, _ = self._cached_lru.popitem(last=False)
        self._unregister(pid)
        self.stats["prefix_evictions"] += 1
        return pid

    def _unregister(self, pid: int):
        h = self._page_to_hash.pop(pid, None)
        if h is not None and self._hash_to_page.get(h) == pid:
            del self._hash_to_page[h]
        if self.chains is not None:
            # pages whose chain was never learned fold to the overflow
            # sink, so per-chain evictions sum to prefix_evictions
            slot = self._chain_of.pop(pid, None)
            if slot is None:
                slot = 0
            else:
                self.chains.resident_sub(slot)
            self.chains.evict(slot)
            flight.evt(flight.PREFIX_EVICT, pid, slot)

    def _incref(self, pid: int):
        """Pin a page for a request; a cached (refcount-0) page leaves
        the eviction pool."""
        if self._page_refs[pid] == 0:
            self._cached_lru.pop(pid, None)
        self._page_refs[pid] += 1

    def _decref(self, pid: int):
        """Drop one reference; at zero the page parks in the cached LRU
        (published content, reusable) or returns to the free list."""
        self._page_refs[pid] -= 1
        if self._page_refs[pid] > 0:
            return
        if pid in self._page_to_hash:
            self._cached_lru[pid] = None    # most-recently-released last
        else:
            self._free_pages.append(pid)

    def _claim_pages(self, matched: list[int],
                     n_pages: int) -> Optional[list[int]]:
        """Pin `matched` (a cached prefix run), then allocate fresh pages
        up to n_pages. Returns None — with NO side effects — when the
        pool cannot cover the remainder. Matches are pinned BEFORE any
        fresh allocation (an allocation could otherwise evict a
        still-unpinned match), and claiming an unreferenced LRU page
        removes an eviction candidate, so those count against
        availability."""
        need = n_pages - len(matched)
        if need > self._pages_avail() - sum(
                1 for p in matched if self._page_refs[p] == 0):
            return None
        for pid in matched:
            self._incref(pid)
        pages = list(matched)
        for _ in range(need):
            pid = self._pop_free_page()
            self._page_refs[pid] = 1
            pages.append(pid)
        return pages

    def _ensure_pages(self, req: _Request, upto_tokens: int) -> bool:
        """Grow req's page list to cover upto_tokens; False if pool dry."""
        need = self._pages_needed(upto_tokens) - len(req.pages)
        if need <= 0:
            return True
        if self._pages_avail() < need:
            return False
        for _ in range(need):
            pid = self._pop_free_page()
            self._page_refs[pid] = 1
            req.pages.append(pid)
        bt = self._block_tables[req.slot]
        bt[:len(req.pages)] = req.pages
        return True

    def _release(self, req: _Request):
        if self._prefix_on:
            self._register_request_pages(req)
        for pid in req.pages:
            self._decref(pid)
        req.pages = []
        if req.slot >= 0:
            # zero the row so nothing stale survives into the next tenant
            # (writes through leftover entries would hit recycled pages)
            self._block_tables[req.slot, :] = 0
            self._free_slots.append(req.slot)
            self._lengths[req.slot] = 0
            req.slot = -1

    # -- prefix cache (enable_prefix_caching) ------------------------------

    def _hash_chain(self, tokens, prev: bytes = b"") -> list[bytes]:
        """Chained content hashes of `tokens`' FULL pages: each full page
        is keyed by blake2b-128(parent_digest || page tokens as int32
        bytes), byte-identical to the reference engine's chain, so
        equal keys imply equal whole prefixes and hashes carry across
        processes and packages."""
        page = self.cfg.page_size
        arr = np.asarray(tokens, np.int32)
        out = []
        for i in range(len(arr) // page):
            prev = hashlib.blake2b(
                prev + arr[i * page:(i + 1) * page].tobytes(),
                digest_size=16).digest()
            out.append(prev)
        return out

    def _prompt_hashes(self, req: _Request) -> list[bytes]:
        if req.page_hashes is None:
            # the chain SEED is the request's prefix salt (empty for base
            # traffic): salted requests hash into a disjoint key space
            req.page_hashes = self._hash_chain(req.prompt_ids,
                                               prev=req.prefix_salt)
        return req.page_hashes

    def _reuse_limit(self, req: _Request) -> int:
        """Most prompt tokens admissible from cache: chunk-aligned (so
        prefill resumes on a chunk boundary) and strictly short of the
        prompt, so at least one token always prefills — the first
        generated token is sampled from real last-position logits."""
        c = self.cfg.chunk_size
        return ((len(req.prompt_ids) - 1) // c) * c

    def _match_prefix(self, req: _Request) -> list[int]:
        """Longest cached page run covering the prompt's head, truncated
        to whole chunks and to _reuse_limit. Pure lookup — no pinning."""
        if not self._prefix_on:
            return []
        limit = self._reuse_limit(req)
        if limit <= 0:
            return []
        page = self.cfg.page_size
        hashes = self._prompt_hashes(req)
        pages: list[int] = []
        for i in range(limit // page):
            pid = self._hash_to_page.get(hashes[i])
            if pid is None:
                break
            pages.append(pid)
        per_chunk = self.cfg.chunk_size // page
        return pages[:(len(pages) // per_chunk) * per_chunk]

    def _try_reuse(self, req: _Request):
        """Mid-prefill reuse: jump req.prefill_pos over chunks whose pages
        another request has published since this one was admitted (an
        identical-prompt burst: the first request prefills, the rest map
        its pages in as they land). Swapped-out private pages go straight
        back to the free list."""
        if not self._prefix_on:
            return
        c, page = self.cfg.chunk_size, self.cfg.page_size
        pos = req.prefill_pos
        if pos % c:
            return
        limit = self._reuse_limit(req)
        hashes = self._prompt_hashes(req)
        while pos < limit:
            idxs = range(pos // page, (pos + c) // page)
            pids = [self._hash_to_page.get(hashes[i]) for i in idxs]
            if any(p is None for p in pids):
                break
            for i, pid in zip(idxs, pids):
                old = req.pages[i]
                if old == pid:
                    continue
                self._incref(pid)
                req.pages[i] = pid
                self._decref(old)
            pos += c
            self.stats["prefix_hits"] += len(pids)
            self.stats["prefix_tokens_saved"] += c
            if self.chains is not None and req.chain_slot >= 0:
                self.chains.hit(req.chain_slot, len(pids), c)
        if pos != req.prefill_pos:
            req.prefill_pos = pos
            self._block_tables[req.slot, :len(req.pages)] = req.pages

    def _register_page(self, pid: int, h: bytes, chain: int = -1):
        if pid in self._page_to_hash or h in self._hash_to_page:
            return      # already published, or duplicate content elsewhere
        self._page_to_hash[pid] = h
        self._hash_to_page[h] = pid
        if self.chains is not None and chain >= 0:
            self._chain_of[pid] = chain
            self.chains.resident_add(chain)

    def _register_request_pages(self, req: _Request):
        """Publish req's full, KV-materialized pages into the content
        index (retirement path). KV is materialized for the prompt plus
        every generated token except the last (a sampled token's K/V is
        written only when it is fed back), so pages holding generated
        text become reusable for follow-ups that embed this output."""
        page = self.cfg.page_size
        n_tok = len(req.prompt_ids) + max(len(req.out_ids) - 1, 0)
        if req.prefill_pos < len(req.prompt_ids):
            # released mid-prefill: only positions < prefill_pos hold KV
            n_tok = req.prefill_pos
        n_full = min(n_tok // page, len(req.pages))
        if n_full <= 0:
            return
        hashes = self._prompt_hashes(req)
        if n_full > len(hashes):
            tokens = (req.prompt_ids + req.out_ids)[
                len(hashes) * page:n_full * page]
            hashes = hashes + self._hash_chain(
                tokens, prev=hashes[-1] if hashes else req.prefix_salt)
        if self.chains is not None and req.chain_slot < 0 and hashes:
            # short prompts never visited the admission-time chain
            # assignment; learn the chain here so evictions attribute
            req.chain_slot = self.chains.slot_for(hashes[0],
                                                  req.prefix_salt)
        for i in range(n_full):
            self._register_page(req.pages[i], hashes[i],
                                chain=req.chain_slot)

    def hash_prompt(self, prompt, salt: bytes = b"") -> list[bytes]:
        """Chained hashes of the prompt's admission-reusable pages: the
        whole full pages inside the chunk-aligned _reuse_limit, exactly
        the run _match_prefix can admit from cache. ``salt`` must match
        the prefix_salt the request will be submitted with. Pure
        computation — no lock, no state."""
        ids = (self.tokenizer.encode(prompt) if isinstance(prompt, str)
               else list(prompt))
        c = self.cfg.chunk_size
        limit = ((len(ids) - 1) // c) * c
        if limit <= 0:
            return []
        return self._hash_chain(ids[:limit], prev=salt)

    # -- engine loop -------------------------------------------------------

    def step(self):
        """One iteration: admit, one prefill dispatch (bounded), one
        decode dispatch."""
        self._admit()
        self._prefill_step()
        self._decode_step()
        telemetry.on_step(self)

    def _admit(self):
        with self._lock:
            while self._pending and self._free_slots:
                # admission control: hold requests until the pool can cover
                # the whole prompt (avoids deadlocking a half-prefilled seq)
                req = self._pending[0]
                matched = self._match_prefix(req)
                pages = self._claim_pages(
                    matched, self._pages_needed(len(req.prompt_ids) + 1))
                if pages is None:
                    break
                self._pending.popleft()
                req.slot = self._free_slots.popleft()
                req.pages = pages
                self._block_tables[req.slot, :len(pages)] = pages
                if self.chains is not None:
                    hs = self._prompt_hashes(req)
                    if hs:
                        req.chain_slot = self.chains.slot_for(
                            hs[0], req.prefix_salt)
                if matched:
                    # chunked prefill starts at the first uncached chunk
                    req.prefill_pos = len(matched) * self.cfg.page_size
                    self.stats["prefix_hits"] += len(matched)
                    self.stats["prefix_tokens_saved"] += req.prefill_pos
                    if self.chains is not None:
                        self.chains.hit(req.chain_slot, len(matched),
                                        req.prefill_pos)
                self._prefilling.append(req)
                telemetry.on_admit(self, req)

    def _prefill_step(self):
        if not self._prefilling:
            return
        cfg = self.cfg
        c = cfg.chunk_size
        # pack up to prefill_rows chunk-rows, queue order; a request with
        # several remaining chunks occupies consecutive rows (rows run in
        # order, so later rows see earlier rows' page writes)
        rows: list[tuple] = []              # (req, start, n_tokens)
        for req in self._prefilling:
            # skip ahead over chunks published since the last step
            self._try_reuse(req)
            pos = req.prefill_pos
            while pos < len(req.prompt_ids) and len(rows) < cfg.prefill_rows:
                n = min(c, len(req.prompt_ids) - pos)
                rows.append((req, pos, n))
                pos += n
            if len(rows) >= cfg.prefill_rows:
                break
        r = len(rows)
        # block-table width bucket: widest logical page any row reads or
        # writes this dispatch (prefix + chunk = pos + n tokens)
        pg = cfg.page_size
        W = self._page_bucket(max(
            (pos + n + pg - 1) // pg for _, pos, n in rows))
        chunks = np.zeros((r, c), np.int32)
        bts = np.zeros((r, W), np.int32)
        sps = np.zeros((r,), np.int32)
        tls = np.zeros((r,), np.int32)
        temps = np.zeros((r,), np.float32)
        topks = np.zeros((r,), np.int32)
        for i, (req, pos, n) in enumerate(rows):
            chunks[i, :n] = req.prompt_ids[pos:pos + n]
            bts[i] = self._block_tables[req.slot][:W]
            sps[i], tls[i] = pos, n
            temps[i] = req.params.temperature
            topks[i] = req.params.top_k
        mode = self._sampling_mode([q for q, _, _ in rows])
        # keyed by the exact row count: the port dispatches the real rows
        # (the reference pads them to a power of two)
        with self.profiler.step("prefill", (r, mode, W)):
            toks, lps = self._prefill_rows(mode, chunks, bts, sps, tls,
                                           temps, topks)
        self._rng_ctr += 1
        self.stats["prefill_dispatches"] += 1
        if self._prefix_on:
            page = cfg.page_size
            for req, pos, n in rows:
                # full prompt pages this row computed are misses; publish
                # them now so the rest of the burst can reuse them
                lo, hi = pos // page, (pos + n) // page
                self.stats["prefix_misses"] += hi - lo
                if self.chains is not None and hi > lo \
                        and req.chain_slot >= 0:
                    self.chains.miss(req.chain_slot, hi - lo)
                hashes = self._prompt_hashes(req)
                for j in range(lo, hi):
                    self._register_page(req.pages[j], hashes[j],
                                        chain=req.chain_slot)
        for i, (req, pos, n) in enumerate(rows):
            req.prefill_pos = pos + n
            if req.prefill_pos < len(req.prompt_ids):
                continue
            # prompt done: the row's sampled token is the first generated
            tok = int(toks[i])
            req.out_ids.append(tok)
            if lps is not None:
                req.out_logps.append(float(lps[i]))
            self.stats["tokens_out"] += 1
            req.first_token_t = time.perf_counter()
            telemetry.on_first_token(self, req)
            self._lengths[req.slot] = len(req.prompt_ids)
            self._prefilling.remove(req)
            self._active[req.slot] = req
            self._maybe_finish(req, tok)

    @staticmethod
    def _propose_draft(ctx: np.ndarray, n: int, s: int) -> list[int]:
        """Prompt-lookup draft: find the most recent earlier occurrence of
        the context's final n-gram and propose the s tokens that followed
        it (reference role: vLLM's prompt-lookup speculative proposer)."""
        m = len(ctx) - n                   # candidate match positions 0..m-1
        if m <= 0 or s <= 0:
            return []
        tail = ctx[-n:]
        hits = np.flatnonzero(np.all(
            np.stack([ctx[i:m + i] for i in range(n)]) == tail[:, None],
            axis=0))
        if len(hits) == 0:
            return []
        # most recent occurrence that still has a FULL s-token
        # continuation; fall back to the earliest hit, whose continuation
        # is the longest available
        viable = hits[hits + n + s <= len(ctx)]
        start = int(viable[-1] if len(viable) else hits[0]) + n
        return [int(t) for t in ctx[start:start + s]]

    def _spec_step(self) -> bool:
        """One speculative verify dispatch over every active slot. Only
        runs when every slot is greedy (the accept rule reproduces exact
        greedy) and every slot has a draft. Returns False to fall
        through to windowed decode."""
        cfg = self.cfg
        s, page = cfg.spec_tokens, cfg.page_size
        slots = sorted(self._active)
        drafts = {}
        for slot in slots:
            req = self._active[slot]
            ctx = np.asarray(req.prompt_ids + req.out_ids, np.int32)
            drafts[slot] = self._propose_draft(ctx, cfg.spec_ngram, s)
        # a draft-less slot would emit ONE token, worse than its share of
        # a decode window; a no-draft round costs the backed-off cooldown
        if not all(drafts.values()):
            self._spec_cooldown = self._spec_cooldown_len
            self._spec_cooldown_len = min(self._spec_cooldown_len * 2, 256)
            return False
        r, s1 = len(slots), s + 1
        # table-width bucket: every row writes positions start..start+s1-1
        W = self._page_bucket(max(
            (self._lengths[sl] + s1 - 1) // page + 1 for sl in slots))
        toks = np.zeros((r, s1), np.int32)
        bts = np.zeros((r, W), np.int32)
        starts = np.zeros((r,), np.int32)
        allow: dict[int, int] = {}
        for i, slot in enumerate(slots):
            req = self._active[slot]
            allow[slot] = self._reserve(req, s1)
            toks[i, 0] = req.out_ids[-1]
            toks[i, 1:1 + len(drafts[slot])] = drafts[slot]
            bts[i] = self._block_tables[slot][:W]
            starts[i] = self._lengths[slot]
        want_lp = any(self._active[sl].params.logprobs for sl in slots)
        with self.profiler.step("verify", (r, s1, W, want_lp)):
            y, ylp = self._verify_rows(toks, bts, starts, want_lp)
        self.stats["spec_dispatches"] += 1
        emitted = 0
        for i, slot in enumerate(slots):
            req = self._active[slot]
            d = drafts[slot]
            self.stats["spec_proposed"] += len(d)
            # accept: y[i, j] is the true next token only while every
            # earlier draft matched the model's choice
            def _lp(row, col):
                return None if ylp is None else float(ylp[row, col])
            out = [(int(y[i, 0]), _lp(i, 0))]
            for j in range(len(d)):
                if d[j] != out[-1][0]:
                    break
                out.append((int(y[i, j + 1]), _lp(i, j + 1)))
                self.stats["spec_accepted"] += 1
            consumed = 0
            for tok, lp in out:
                if consumed >= allow[slot]:
                    telemetry.on_preempted(self)
                    self._retire(req)
                    break
                req.out_ids.append(tok)
                if lp is not None:
                    req.out_logps.append(lp)
                self._lengths[slot] += 1
                consumed += 1
                self.stats["tokens_out"] += 1
                if self._stop_after(req, tok):
                    self._retire(req)
                    break
            emitted += consumed
        # keep speculating only while it beats the window; on fallback,
        # re-probe after a cooldown that doubles per failed probe
        self._spec_gain = 0.5 * self._spec_gain + 0.5 * (emitted / r)
        if self._spec_gain <= self.cfg.decode_window and \
                self.cfg.decode_window > 1:
            self._spec_cooldown = self._spec_cooldown_len
            self._spec_cooldown_len = min(self._spec_cooldown_len * 2, 256)
            self._spec_gain = float(s + 1)
        else:
            self._spec_cooldown_len = 8
        return True

    def _decode_step(self):
        if not self._active:
            return
        cfg = self.cfg
        bs, page = cfg.max_batch_size, cfg.page_size
        quiet = not (self._prefilling or self._pending)
        if cfg.spec_tokens > 0 and quiet and \
                self._sampling_mode(
                    self._active.values())[:2] == (False, False):
            if self._spec_cooldown > 0:
                self._spec_cooldown -= 1
            elif self._spec_step():
                return
        # full window only when no prompt is waiting
        w = 1 if not quiet else cfg.decode_window
        # table-width bucket: the window writes positions len..len+w-1
        # per slot, so the width covers every such page
        W = self._page_bucket(max(
            (self._lengths[sl] + w - 1) // page + 1 for sl in self._active))
        tokens = np.zeros((bs,), np.int32)
        lengths = np.zeros((bs,), np.int32)
        temps = np.zeros((bs,), np.float32)
        topks = np.zeros((bs,), np.int32)
        # slots not decoding this step keep a zeroed table row: their
        # dummy writes go to sink page 0
        bt = np.zeros((bs, W), np.int32)
        allow: dict[int, int] = {}          # valid tokens per slot this window
        for slot, req in self._active.items():
            allow[slot] = self._reserve(req, w)
            tokens[slot] = req.out_ids[-1]
            lengths[slot] = self._lengths[slot]
            temps[slot] = req.params.temperature
            topks[slot] = req.params.top_k
            bt[slot] = self._block_tables[slot][:W]
        mode = self._sampling_mode(self._active.values())
        with self.profiler.step("decode", (w, mode, W)):
            out, lps = self._decode_window(w, mode, tokens, bt, lengths,
                                           temps, topks)
        self._rng_ctr += 1
        self.stats["decode_dispatches"] += 1
        for slot in list(self._active):
            req = self._active[slot]
            for j in range(w):
                if j >= allow[slot]:
                    # page pool exhausted mid-window: finish early rather
                    # than wedge (tokens past the allocation wrote to the
                    # sink page and are not trustworthy)
                    telemetry.on_preempted(self)
                    self._retire(req)
                    break
                tok = int(out[slot, j])
                req.out_ids.append(tok)
                if lps is not None:
                    req.out_logps.append(float(lps[slot, j]))
                self._lengths[slot] += 1
                self.stats["tokens_out"] += 1
                if self._stop_after(req, tok):
                    self._retire(req)
                    break

    def _reserve(self, req: _Request, width: int) -> int:
        """Pre-allocate pages for up to `width` new tokens and return how
        many of the dispatch's tokens are VALID for this request: pages
        only for tokens the request can still emit (width, max_tokens
        remainder, sequence ceiling — whichever is least). Writes past
        the allocation land on sink page 0 and those tokens are
        discarded; a dry pool keeps only the tokens its pages cover."""
        total = len(req.prompt_ids) + len(req.out_ids)
        remaining = max(req.params.max_tokens - len(req.out_ids), 1)
        target = min(total + min(width, remaining), self.cfg.max_seq_len)
        if self._ensure_pages(req, target):
            return target - total
        return max(len(req.pages) * self.cfg.page_size - total, 0)

    def _stop_after(self, req: _Request, tok: int) -> bool:
        """Stop condition evaluated after appending tok to req.out_ids."""
        total = len(req.prompt_ids) + len(req.out_ids)
        return (len(req.out_ids) >= req.params.max_tokens
                or tok == self._eos_id() or tok in req.params.stop_token_ids
                or total >= self.cfg.max_seq_len - 1)

    def _retire(self, req: _Request):
        self._finish_request(req)
        self._active.pop(req.slot, None)
        if req in self._prefilling:
            self._prefilling.remove(req)
        self._release(req)

    def _maybe_finish(self, req: _Request, tok: int):
        stop = self._stop_after(req, tok)
        if not stop:
            # growing by one token may need one more page
            total = len(req.prompt_ids) + len(req.out_ids)
            if not self._ensure_pages(req, total + 1):
                stop = True  # pool exhausted: finish early rather than wedge
                telemetry.on_preempted(self)
        if stop:
            self._retire(req)

    # -- stats -------------------------------------------------------------

    def estimate_flops(self) -> dict:
        """FLOPs per dispatch for the program families, counted by
        running one dummy dispatch per static key under
        ``FlopCounterMode`` (``util/profiling.compiled_flops``; run once,
        after traffic, not per step). The dummies are warmup's: zero
        block tables and zero true lengths, every write on sink page 0,
        and no counter, RNG position or profiler count moves.

        Length-aware, as the reference: one estimate PER static key
        — (rows/window, sampling mode, block-table page bucket) — for
        every key the profiler has executed steps under; before any
        traffic, the full-width greedy decode and prefill. The counter
        sees dispatcher ops only: the matmuls always, attention only
        where it reaches aten (the plain version, on the CPU). On the
        card the ragged kernel is a ``ctypes`` call it cannot see, so
        the estimate and profile_summary()'s MFU leave attention out —
        they understate, never inflate. Returns {family: {key: flops}}."""
        cfg = self.cfg
        maxp = cfg.max_pages_per_seq
        mode = (False, False, False)
        tags = [t for t in self.profiler.executed_tags()
                if t[0] in ("prefill", "decode", "verify")]
        if not tags:
            tags = [("decode", (cfg.decode_window, mode, maxp)),
                    ("prefill", (cfg.prefill_rows, mode, maxp))]
        out: dict[str, dict] = {}
        for kind, k in tags:
            fl = compiled_flops(*self._dispatch_for_key(kind, k))
            if fl:
                out.setdefault(kind, {})[k] = fl
                # credited only to steps at this EXACT static key
                self.profiler.attach_flops(kind, fl, key=k)
        return out

    def _dispatch_for_key(self, kind: str, key: tuple):
        """(fn, *dummy_args) reproducing the static shapes of the
        dispatch behind a profiler step tag — used by warmup and
        estimate_flops. Zero block tables and zero true lengths / starts:
        every write lands on sink page 0."""
        cfg = self.cfg
        bs, c = cfg.max_batch_size, cfg.chunk_size
        zi = lambda *s: np.zeros(s, np.int32)                  # noqa: E731
        zf = lambda *s: np.zeros(s, np.float32)                # noqa: E731
        if kind == "decode":
            w, mode, W = key
            return (self._decode_window, w, mode, zi(bs), zi(bs, W), zi(bs),
                    zf(bs), zi(bs))
        if kind == "prefill":
            r, mode, W = key
            return (self._prefill_rows, mode, zi(r, c), zi(r, W), zi(r),
                    zi(r), zf(r), zi(r))
        r, s1, W, want_lp = key                       # verify
        return self._verify_rows, zi(r, s1), zi(r, W), zi(r), want_lp

    def profile_summary(self) -> dict:
        """Step-profiler view (util/profiling.py): first-dispatch vs
        later wall split, per-step wall, and MFU once estimate_flops()
        has run. The MFU leaves out work the FLOP counter cannot see (the
        ragged kernel on the card: estimate_flops says why), so it
        understates."""
        return {**self.profiler.summary(), "dispatches": {
            "prefill": self.stats["prefill_dispatches"],
            "decode": self.stats["decode_dispatches"],
            "spec": self.stats["spec_dispatches"]}}

    def prefix_accounting(self) -> dict:
        """THE accounting source for prefix-cache counters: pool_stats()
        and the telemetry gauges (llm/telemetry.py) derive from this one
        snapshot, so the surfaces cannot drift from each other. The
        spill-tier keys stay 0 (the tier is not ported), as the
        reference reports them with the tier off."""
        hits = self.stats["prefix_hits"]
        misses = self.stats["prefix_misses"]
        return {
            "hits": hits,
            "misses": misses,
            "evictions": self.stats["prefix_evictions"],
            "tokens_saved": self.stats["prefix_tokens_saved"],
            "imported_pages": self.stats["prefix_imported_pages"],
            "exported_pages": self.stats["prefix_exported_pages"],
            "cached_pages": len(self._cached_lru),
            "hit_rate": round(hits / (hits + misses), 4)
            if hits + misses else 0.0,
            **dict.fromkeys(_SPILL_KEYS, 0),
        }

    def pool_stats(self) -> dict:
        acct = self.prefix_accounting()
        return {
            # free + cached together are the allocatable pool: cached
            # pages hold reusable prefix KV but evict on demand
            "free_pages": len(self._free_pages),
            "cached_pages": acct["cached_pages"],
            "total_pages": self.cfg.num_pages,
            "prefix_hit_rate": acct["hit_rate"],
            "active": len(self._active),
            "prefilling": len(self._prefilling),
            "pending": len(self._pending),
            **self.stats,
        }

    def chain_stats_report(self, top_k: Optional[int] = None) -> dict:
        """Heat-plane snapshot: bounded-table stats, whole-table totals
        and the top-K hot chains. Empty dict when the table is off."""
        if self.chains is None:
            return {}
        if top_k is None:
            top_k = self.cfg.chain_stats_top_k
        return self.chains.report(top_k)
