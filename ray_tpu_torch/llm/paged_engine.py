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

Each family runs as one program per static key, as the reference's
does: (window, sampling mode, table width) for decode, (rows, mode,
width) for prefill and (rows, tokens per row, width, logprobs) for
verify. Row counts are padded to powers of two (pad rows have true
length 0 or a zero table, so their writes land on sink page 0) and
block tables are sliced to power-of-two page buckets (``_page_bucket``),
so the set of programs stays bounded; ``warmup`` builds it over the whole
key ladder before traffic. On the card a program is a CUDA graph
(``llm/graphs.py``): a dispatch copies its host arrays into the graph's
static buffers, replays it and reads the ``[B, w]`` or ``[R]`` outputs
back once. The sampling counter is one of those inputs, so a replay
draws fresh numbers (``engine.fold_in``). A key first met in traffic is
captured at its first dispatch, as the reference's jit compiles a new
key. On the CPU each dispatch runs its body eagerly. ``_eager = True``
runs the same body eagerly on the card too (tests and the smoke compare
the two); nothing switches to it by itself.

Multi-tenant and KV-mobility paths, as in the reference:
  - batched multi-LoRA (``max_adapters > 0``): a fixed-shape adapter
    slot table (``llm/multilora/slots.py``) and per-row slot ids, one
    more int32 input of every program (so the programs stay one per
    static key, whatever the tenant mix); slot loads write the table in
    place between dispatches;
  - the host spill tier (``kv_spill``, ``llm/tiering.py``): an evicted
    cached page is demoted to host memory (one gather per layer, one
    device-to-host copy, between dispatches) and promoted back at
    admission or by ``maybe_rewarm``;
  - KV payloads: ``prefill_export`` / ``import_prefill`` (prefill and
    decode on different engines) and ``export_prefix`` /
    ``import_prefix`` (a prefix cached on one engine seeded into
    another), with the prefix directory's publish tracking. Payload
    pages are host numpy arrays per layer, ``[n, page, KVH, D]``:
    float32 for an f32 cache, and for a bf16 cache the raw 16-bit
    patterns as ``np.uint16`` (numpy has no bfloat16; the reference's
    ``ml_dtypes`` bfloat16 arrays are read through the same view).
Every import, promote and slot load writes the existing tensors in
place: the captured programs read the addresses they were captured
with.

Observability as in the reference: the telemetry hooks
(``llm/telemetry.py``: the ``rtpu_llm_*`` series), ``PREFIX_EVICT`` and
``PREFIX_IMPORT`` flight events, and a step profiler
(``util/profiling.py``) around every dispatch, with ``estimate_flops()``
and ``profile_summary()``.

Tensor-parallel serving (``mesh``, as the reference's): weights, the
KV pool and the slot table are cut into one shard per tp rank
(``parallel/sharding.py``: heads, kv_heads and mlp over tp, the vocab
over tp, the pool over kv_heads) and every dispatch runs the model's
tp forward over them from this one process (``models/llama.py``), each
rank on its mesh device; block tables and the other host inputs stay
as they are. ``stats["mesh_*"]`` counts each dispatch's declared host
bytes, as the reference's, and ``mesh_reshard_bytes`` the bytes of any
shard found moved off its pinned placement after a dispatch (it must
stay 0). KV payloads stay mesh-agnostic: pages gather and scatter
along kv_heads. Only tp may exceed 1, and every shard sits on one
device (two shards may share it); a transport between distinct cards
and the other axes are queue A9.2's.
"""
from __future__ import annotations

import dataclasses
import functools
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
    SamplingParams, _EngineBase, _Request, fold_in, root_key,
    sample_logits_batch,
)
from .graphs import GraphCache
from .tokenizer import get_tokenizer

def _raw_pages(a: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """A payload's page array in the host form of a ``dtype`` cache:
    float32 for f32; for bf16 the raw 16-bit patterns (as int16, which
    torch takes from numpy) — the port's own bf16 export (``np.uint16``)
    and the reference's ``ml_dtypes`` bfloat16 arrays both read through
    this view."""
    if dtype == torch.bfloat16:
        if a.dtype.name not in ("uint16", "bfloat16"):
            raise TypeError(f"bf16 cache: payload pages are {a.dtype}")
        return a.view(np.int16)
    want = torch.empty((), dtype=dtype).numpy().dtype
    if a.dtype != want:
        raise TypeError(f"{dtype} cache: payload pages are {a.dtype}")
    return a


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
    # batched multi-LoRA (llm/multilora): > 0 builds a resident-adapter
    # slot table of this many slots (slot 0 = base) and threads per-row
    # slot ids through every dispatch; 0 disables (the programs then
    # run exactly the base math)
    max_adapters: int = 0
    # rank ceiling of the slot table; lower-rank adapters zero-pad
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
    # host spill tier (llm/tiering.py): demote an evicted refcount-0
    # cached page's KV to host memory instead of freeing it, and promote
    # spilled runs back at admission before cold prefill. Heat-gated by
    # the chain-stats table (min_hits / max_idle_s) and byte-budgeted.
    kv_spill: bool = False
    kv_spill_max_bytes: int = 64 << 20
    kv_spill_min_hits: int = 0
    kv_spill_max_idle_s: float = 0.0
    # tensor-parallel serving: a parallel.mesh MeshSpec, its dict form
    # ({"tp": 2}) or a parallel.mesh.Mesh naming the devices. None = one
    # device, exactly the pre-mesh programs
    mesh: Any = None
    tokenizer: Any = None

    def __post_init__(self):
        if self.chunk_size % self.page_size:
            raise ValueError("chunk_size must be a multiple of page_size")
        if self.prefill_rows < 1 or self.decode_window < 1:
            raise ValueError("prefill_rows and decode_window must be >= 1")
        if self.page_buckets not in ("auto", "on", "off"):
            raise ValueError("page_buckets must be 'auto', 'on' or 'off'")
        if self.chain_stats_slots < 0 or self.chain_stats_top_k < 1:
            raise ValueError("chain_stats_slots must be >= 0 and "
                             "chain_stats_top_k >= 1")
        if self.kv_spill and not self.enable_prefix_caching:
            raise ValueError("kv_spill requires enable_prefix_caching "
                             "(the tier holds content-hashed pages)")
        if self.kv_spill and self.kv_spill_max_bytes <= 0:
            raise ValueError("kv_spill_max_bytes must be > 0")

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
        # resident-adapter slot table (cfg.max_adapters): every dispatch
        # gathers its rows by slot id; loads write it in place
        self.lora = None
        if cfg.max_adapters > 0:
            from .multilora.slots import AdapterSlotTable
            self.lora = AdapterSlotTable(mc, cfg.max_adapters,
                                         cfg.lora_rank, cfg.lora_targets,
                                         device=self.device)
        # tensor-parallel placement (cfg.mesh): per-rank shards of the
        # weights, the KV pool and the slot table, and the placements
        # every dispatch's walk checks them against
        self.mesh = None
        self._pinned = None
        if cfg.mesh is not None:
            self._init_mesh(params)
        else:
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
        # prefix-directory delta tracking: hashes registered/unregistered
        # since the last drain (drain_directory_delta), appended only when
        # track_page_publish is on, from the stepping thread
        self.track_page_publish = False
        self._dir_new: list[bytes] = []
        self._dir_dropped: list[bytes] = []
        # per-chain heat table: observation only. _chain_of maps a
        # registered page to the chain slot it was published under.
        self.chains = None
        self._chain_of: dict[int, int] = {}
        page_nbytes = sum(
            t.numel() * t.element_size()
            for layer in self._layers() for t in (layer["k"], layer["v"])
        ) // max(cfg.num_pages, 1)
        if self._prefix_on and cfg.chain_stats_slots > 0:
            from .chainstats import ChainStatsTable
            self.chains = ChainStatsTable(cfg.chain_stats_slots,
                                          page_nbytes)
        # host spill tier (cfg.kv_spill): mutated under self._lock on the
        # paths that mutate the prefix cache
        self.spill = None
        # longest known head-rooted hash run per chain slot: what
        # maybe_rewarm promotes
        self._chain_runs: dict[int, list[bytes]] = {}
        if self._prefix_on and cfg.kv_spill:
            from .tiering import SpillPolicy, SpillTier
            self.spill = SpillTier(
                cfg.kv_spill_max_bytes, page_nbytes,
                SpillPolicy(min_hits=cfg.kv_spill_min_hits,
                            max_idle_s=cfg.kv_spill_max_idle_s))
            self.spill.bind_chains(self.chains)
        self._next_rid = 0
        self._rng_key = root_key(rng_seed ^ 0x5EED, self.device)
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
                      # pages seeded from another engine's export
                      # (import_prefix) and cached pages gathered for one
                      # (export_prefix)
                      "prefix_imported_pages": 0,
                      "prefix_exported_pages": 0,
                      # spill tier (cfg.kv_spill): pages/bytes captured
                      # into the host tier, demote decisions that kept a
                      # tier copy (captures + clean re-evictions), pages
                      # promoted back, pages expired (budget/teardown),
                      # validate-on-promote drops; all 0 with it off
                      "spill_pages": 0, "spill_bytes": 0,
                      "spill_demotions": 0, "spill_promotions": 0,
                      "spill_expired": 0, "spill_drops": 0,
                      # tensor-parallel dispatches (cfg.mesh): declared
                      # host input / output bytes, and bytes of shards
                      # found off their pinned placement (must stay 0);
                      # all 0 with the mesh off
                      "mesh_dispatches": 0, "mesh_input_bytes": 0,
                      "mesh_output_bytes": 0, "mesh_reshard_bytes": 0}
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
        # one captured program per (family, static key) on the card;
        # _eager runs the dispatch bodies eagerly there instead
        self._graphs = (GraphCache(self.device)
                        if self.device.type == "cuda" else None)
        self._eager = False

    # -- tensor-parallel placement (cfg.mesh) -------------------------------

    def _init_mesh(self, params: dict) -> None:
        """Build the mesh and cut the weights (``llama.logical_axes``),
        the KV pool (over kv_heads, made per rank) and the slot table
        into per-rank shards, then pin every shard's placement: device,
        shape and storage (the reference's committed NamedShardings)."""
        from ..parallel import sharding as shardlib
        from ..parallel.mesh import Mesh, MeshSpec, build_mesh, \
            default_devices
        cfg, mc = self.cfg, self.cfg.model
        spec = cfg.mesh
        if isinstance(spec, Mesh):
            self.mesh = spec
        else:
            if isinstance(spec, dict):
                spec = MeshSpec(**spec)
            # the spec names how many devices the engine WANTS: the
            # leading ones of this engine's kind
            self.mesh = build_mesh(spec, devices=default_devices(
                spec.wanted(), self.device.type))
        sizes = dict(self.mesh.shape)
        tp = sizes.get("tp", 1)
        if mc.n_kv_heads % tp or mc.n_heads % tp or mc.mlp_dim % tp:
            raise ValueError(
                f"mesh tp={tp} must divide n_heads={mc.n_heads}, "
                f"n_kv_heads={mc.n_kv_heads} and mlp_dim={mc.mlp_dim}")
        vocab_ways = tp * sizes.get("fsdp", 1)
        if mc.vocab_size % vocab_ways:
            raise ValueError(
                f"mesh tp*fsdp={vocab_ways} must divide "
                f"vocab_size={mc.vocab_size}")
        other = {a: n for a, n in sizes.items() if a != "tp" and n > 1}
        if other:
            raise NotImplementedError(
                f"mesh axes {other}: only tp serves in ray_tpu_torch "
                f"(dp/fsdp/ep/sp/pp in the engine are queue A9.2)")
        devices = self.mesh.axis_devices("tp")
        if len(set(devices)) > 1:
            raise NotImplementedError(
                f"tp shards on {len(set(devices))} distinct devices: the "
                f"transport between cards and captures spanning them are "
                f"queue A9.2 (put every shard on one device)")
        if devices[0].type != self.device.type:
            raise ValueError(f"mesh devices {devices} for an engine on "
                             f"{self.device}")
        self.device = devices[0]
        axes = llama.logical_axes(mc)
        shards = [{"layers": {}} for _ in devices]
        for name, t in params.items():
            if name == "layers":
                for n, w in t.items():
                    for sh, part in zip(shards, shardlib.shard_tensor(
                            w, axes["layers"][n], self.mesh)):
                        sh["layers"][n] = part
                continue
            for sh, part in zip(shards, shardlib.shard_tensor(
                    t, axes[name], self.mesh)):
                sh[name] = part
        self.params = shards
        shard_mc = dataclasses.replace(mc, n_kv_heads=mc.n_kv_heads // tp)
        self.caches = [llama.init_paged_cache(shard_mc, cfg.num_pages,
                                              cfg.page_size, device=d)
                       for d in devices]
        if self.lora is not None:
            self.lora.shard(self.mesh)
        self._pinned = [(t.device, tuple(t.shape), t.data_ptr())
                        for t in self._committed()]

    def whole_params(self) -> dict:
        """The weights as one dict: ``self.params`` on one device, the
        shards put back together (on the first rank's device) on a
        mesh."""
        if self.mesh is None:
            return self.params
        from ..parallel.sharding import unshard
        axes = llama.logical_axes(self.cfg.model)
        out = {k: unshard([sh[k] for sh in self.params], axes[k], self.mesh)
               for k in self.params[0] if k != "layers"}
        out["layers"] = {
            n: unshard([sh["layers"][n] for sh in self.params],
                       axes["layers"][n], self.mesh)
            for n in self.params[0]["layers"]}
        return out

    def _committed(self) -> list:
        """Every committed shard: params, KV pools, slot table."""
        out = [t for sh in self.params for t in (
            *sh["layers"].values(),
            *(v for k, v in sh.items() if k != "layers"))]
        out += [t for layer in self._layers() for t in layer.values()]
        if self.lora is not None:
            out += [t for tree in self.lora.tree for t in tree.values()]
        return out

    def _shards(self) -> list:
        """The KV pools per tp rank (one rank off-mesh): [[{k, v}] per
        layer] per rank."""
        return [self.caches] if self.mesh is None else self.caches

    def _layers(self) -> list:
        """Every per-layer KV pool dict, of every tp rank."""
        return [layer for shard in self._shards() for layer in shard]

    def _mesh_account(self, host_in: int, host_out: int) -> None:
        """Per-dispatch accounting (mesh on only), as the reference's:
        the declared host->device input and device->host output bytes,
        and a walk of every committed shard: one whose device, shape or
        storage moved off its pinned placement counts its bytes as
        involuntary-reshard traffic."""
        if self.mesh is None:
            return
        st = self.stats
        st["mesh_dispatches"] += 1
        st["mesh_input_bytes"] += int(host_in)
        st["mesh_output_bytes"] += int(host_out)
        st["mesh_reshard_bytes"] += sum(
            t.numel() * t.element_size()
            for t, want in zip(self._committed(), self._pinned)
            if (t.device, tuple(t.shape), t.data_ptr()) != want)

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

    def _page_bucket_ladder(self) -> list[int]:
        """Every width _page_bucket can return (ascending): what warmup
        builds for traffic to meet no new key."""
        maxp = self.cfg.max_pages_per_seq
        if not self._bucketing:
            return [maxp]
        out = []
        b = self._PAGE_BUCKET_FLOOR
        while b < maxp:
            out.append(b)
            b <<= 1
        out.append(maxp)
        return out

    @staticmethod
    def _row_bucket(r: int, cap: int) -> int:
        """Rows a dispatch of r real rows carries: the next power of two,
        at most cap (pad rows write only sink page 0)."""
        return min(1 << max(r - 1, 0).bit_length(), cap)

    # -- dispatch families -------------------------------------------------

    def _run(self, tag: tuple, body, arrays) -> list:
        """One dispatch: the program captured for ``tag`` on the card,
        else ``body`` eagerly. Returns its outputs as host arrays."""
        if self._graphs is None or self._eager:
            return self._run_eager(body, *arrays)
        return self._graphs.run(tag, body, arrays)

    def _run_eager(self, body, *arrays) -> list:
        outs = body(*[self._dev(a) for a in arrays])
        return [None if t is None else t.cpu().numpy() for t in outs]

    def _ctr(self) -> np.ndarray:
        """The sampling counter as a dispatch input."""
        return np.asarray([self._rng_ctr & 0x7FFFFFFF], np.int32)

    def _lora_tree(self, slots):
        """The slot table's tensors when a dispatch carries slot ids."""
        return None if slots is None else self.lora.tree

    def _lora_args(self, slots, rows: int) -> tuple:
        """Trailing host input of a dispatch: the rows' adapter slot ids
        (``slots``, or slot 0 for every row when None), or nothing when
        the table is off (the bodies then run exactly the base math)."""
        if self.lora is None:
            return ()
        return (np.zeros((rows,), np.int32) if slots is None
                else np.asarray(slots, np.int32),)

    def _decode_body(self, w: int, mode: tuple, toks, bt, lens, temps,
                     top_ks, ctr, slots=None):
        """w decode steps for every slot on device tensors, each step's
        sampled tokens fed back on the device; step i draws with
        fold_in(fold_in(engine key, ctr), i). ``slots`` [B]: the rows'
        adapter slots (multi-LoRA only). Returns (tokens [B, w],
        logprobs [B, w] or None)."""
        any_sampled, any_topk, want_logp = mode
        mc, page = self.cfg.model, self.cfg.page_size
        key = fold_in(self._rng_key, ctr) if any_sampled else None
        lora = self._lora_tree(slots)
        outs, lps = [], []
        for i in range(w):
            logits, _ = llama.decode_paged(
                self.params, toks[:, None], self.caches, bt, lens, mc,
                page_size=page, lora=lora, slots=slots)
            toks, lp = sample_logits_batch(
                logits, None if key is None else fold_in(key, i), temps,
                top_ks, any_sampled=any_sampled, any_topk=any_topk,
                want_logp=want_logp)
            lens = lens + 1
            outs.append(toks)
            lps.append(lp)
        return (torch.stack(outs, dim=1),
                torch.stack(lps, dim=1) if want_logp else None)

    def _prefill_body(self, mode: tuple, chunks, bts, sps, tls, temps,
                      top_ks, ctr, slots=None):
        """The chunk-rows in order, then sampling of each row's last-token
        logits with fold_in(engine key, ctr). Returns (tokens [R],
        logprobs [R] or None)."""
        any_sampled, any_topk, want_logp = mode
        last, _ = llama.prefill_paged_rows(
            self.params, chunks, self.caches, bts, sps, tls, self.cfg.model,
            page_size=self.cfg.page_size, lora=self._lora_tree(slots),
            slots=slots)
        key = fold_in(self._rng_key, ctr) if any_sampled else None
        return sample_logits_batch(
            last, key, temps, top_ks, any_sampled=any_sampled,
            any_topk=any_topk, want_logp=want_logp)

    def _verify_body(self, want_logp: bool, toks, bts, starts, slots=None):
        """Verify rows of s1 tokens: the greedy next token at each fed
        position [R, s1] (and its log-probability when asked)."""
        logits, _ = llama.verify_paged_rows(
            self.params, toks, self.caches, bts, starts, self.cfg.model,
            page_size=self.cfg.page_size, lora=self._lora_tree(slots),
            slots=slots)
        y = torch.argmax(logits, dim=-1).to(torch.int32)
        if not want_logp:
            return y, None
        lp = torch.log_softmax(logits, dim=-1).gather(
            -1, y[..., None].long())[..., 0]
        return y, lp

    def _decode_window(self, w: int, mode: tuple, tokens, bt, lengths,
                       temps, top_ks, lslots=None):
        """One dispatch = w decode steps for every slot. ``lslots``: the
        rows' adapter slots (multi-LoRA; None = all base). Returns host
        arrays (tokens [B, w], logprobs [B, w] or None)."""
        return self._run(("decode", (w, mode, bt.shape[1])),
                         functools.partial(self._decode_body, w, mode),
                         (tokens, bt, lengths, temps, top_ks, self._ctr())
                         + self._lora_args(lslots, len(tokens)))

    def _prefill_rows(self, mode: tuple, chunks, bts, sps, tls, temps,
                      top_ks, lslots=None):
        """One dispatch = the given chunk-rows in order, then sampling of
        each row's last-token logits (used for prompt-completing rows)."""
        return self._run(("prefill", (chunks.shape[0], mode, bts.shape[1])),
                         functools.partial(self._prefill_body, mode),
                         (chunks, bts, sps, tls, temps, top_ks, self._ctr())
                         + self._lora_args(lslots, chunks.shape[0]))

    def _verify_rows(self, toks, bts, starts, want_logp: bool,
                     lslots=None):
        """One dispatch = verify rows of s1 = 1+drafts tokens; returns the
        greedy next token AT each fed position [r, s1] (and its
        log-probability when asked)."""
        r, s1 = toks.shape
        return self._run(("verify", (r, s1, bts.shape[1], want_logp)),
                         functools.partial(self._verify_body, want_logp),
                         (toks, bts, starts) + self._lora_args(lslots, r))

    # -- public API --------------------------------------------------------

    def warmup(self, sample_modes=((False, False),),
               families=("prefill", "decode", "verify")) -> float:
        """Build every program this engine dispatches before serving
        traffic; returns seconds. The reference compiles them here, as
        vLLM captures its execution graphs at engine start.

        Families, over the block-table page-bucket ladder: prefill at
        each power-of-two row bucket up to ``prefill_rows``, decode
        windows {1, decode_window}, and with speculation on the verify
        row buckets up to ``max_batch_size`` (logprobs off), each crossed
        with the sampling modes (any_sampled, any_topk[, want_logp]). On
        the card each key is captured as a CUDA graph (and the kernel
        library built or loaded first); on the CPU each runs eagerly
        once. Each is booked in the step profiler through
        ``record_compile`` at the reference's key. Dummy dispatches carry
        zero block tables and zero true lengths: every write routes to
        sink page 0 and no visible engine state changes. ``families``
        narrows the set for replicas that only ever run one side (a P/D
        prefill replica never decodes; a decode replica never
        prefills)."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from ..ops import _build
            _build.load("ragged_paged_attention")
        for kind, key in self._warmup_keys(sample_modes, families):
            tw = time.perf_counter()
            self._run((kind, key), *self._dummy(kind, key))
            self.profiler.record_compile(time.perf_counter() - tw, kind, key)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def _warmup_keys(self, sample_modes,
                     families=("prefill", "decode", "verify")) -> list:
        """(family, static key) of every program warmup builds for
        ``families``, in the reference's order."""
        cfg = self.cfg
        modes = [tuple(m) + (False,) * (3 - len(m)) for m in sample_modes]
        buckets = self._page_bucket_ladder()

        def rows(cap):
            rb = 1
            while True:
                rb = min(rb, cap)
                yield rb
                if rb >= cap:
                    return
                rb <<= 1
        keys = []
        for mode in modes:
            if "prefill" in families:
                keys += [("prefill", (rb, mode, maxp)) for maxp in buckets
                         for rb in rows(cfg.prefill_rows)]
            if "decode" in families:
                keys += [("decode", (w, mode, maxp)) for maxp in buckets
                         for w in sorted({1, cfg.decode_window})]
        if cfg.spec_tokens > 0 and "verify" in families:
            keys += [("verify", (rb, cfg.spec_tokens + 1, maxp, False))
                     for maxp in buckets for rb in rows(cfg.max_batch_size)]
        return keys

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
        if self.spill is not None:
            # demote: copy the page's KV to the host tier BEFORE the hash
            # mapping goes and the page id is handed to its next owner
            self._maybe_demote(pid)
        self._unregister(pid)
        self.stats["prefix_evictions"] += 1
        return pid

    def _maybe_demote(self, pid: int):
        h = self._page_to_hash.get(pid)
        if h is None or self._hash_to_page.get(h) != pid:
            return      # unpublished page: nothing content-addressed
        if self.spill.has(h):
            # content already in the tier (promoted or recomputed, then
            # evicted again): a clean eviction — refresh recency only
            self.spill.touch(h)
            self.stats["spill_demotions"] += 1
            return
        slot = self._chain_of.get(pid)
        now = time.monotonic()
        if not self.spill.policy.admit(self.chains, slot, now):
            return      # heat-gated: not worth tier residence — free
        pages = self._pages_to_host([pid])
        ks = [layer["k"][0] for layer in pages]
        vs = [layer["v"][0] for layer in pages]
        chain = slot if slot is not None else 0
        expired = self.spill.add(h, chain, ks, vs, now)
        captured = self.spill.has(h)
        if captured:
            self.stats["spill_demotions"] += 1
            self.stats["spill_pages"] += 1
            self.stats["spill_bytes"] += self.spill.page_nbytes
            if self.chains is not None:
                self.chains.spilled_add(chain)
        self._spill_expired(expired, skip_accounted=not captured)

    def _spill_expired(self, removed, skip_accounted: bool = False):
        """Account tier entries expired under the byte budget (or the
        page refused entry outright, skip_accounted: never counted in)."""
        for _h, chain in removed:
            if skip_accounted:
                skip_accounted = False
                continue
            self.stats["spill_expired"] += 1
            if self.chains is not None:
                self.chains.spilled_sub(chain)

    def _spill_dropped(self, removed):
        """Account validate-on-promote failures: stale or malformed tier
        content purged, costing the request a cold prefill only."""
        for _h, chain in removed:
            self.stats["spill_drops"] += 1
            if self.chains is not None:
                self.chains.spilled_sub(chain)

    def _unregister(self, pid: int):
        h = self._page_to_hash.pop(pid, None)
        if h is not None and self._hash_to_page.get(h) == pid:
            del self._hash_to_page[h]
            if self.track_page_publish:
                self._dir_dropped.append(h)
                if len(self._dir_dropped) > 4 * self.cfg.num_pages:
                    # nothing drains the log: drop it (stale directory
                    # entries are hints the importer validates anyway)
                    del self._dir_dropped[:]
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
        if self.track_page_publish:
            self._dir_new.append(h)
            if len(self._dir_new) > 4 * self.cfg.num_pages:
                # nothing drains the log: compress it to a full resync
                # so an undrained engine's memory stays bounded
                self._dir_new = list(self._hash_to_page)

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
                if self.spill is not None and \
                        self._promote_for_locked(req, len(matched)) > 0:
                    # promoted pages are registered and LRU-parked:
                    # re-walk so the match (and the hit accounting below)
                    # sees them like never-evicted pages
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
                        if self.spill is not None and req.chain_slot > 0:
                            # the chain's longest head-rooted hash run:
                            # what proactive re-warm promotes
                            prev = self._chain_runs.get(req.chain_slot)
                            if prev is None or len(hs) > len(prev):
                                self._chain_runs[req.chain_slot] = \
                                    list(hs[:self.cfg.max_pages_per_seq])
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
        # the row count is padded to a power of two, as the reference's
        # is, so the programs stay few: pad rows carry true length 0 and
        # write only sink page 0
        rb = self._row_bucket(len(rows), cfg.prefill_rows)
        # block-table width bucket: widest logical page any row reads or
        # writes this dispatch (prefix + chunk = pos + n tokens)
        pg = cfg.page_size
        W = self._page_bucket(max(
            (pos + n + pg - 1) // pg for _, pos, n in rows))
        chunks = np.zeros((rb, c), np.int32)
        bts = np.zeros((rb, W), np.int32)
        sps = np.zeros((rb,), np.int32)
        tls = np.zeros((rb,), np.int32)
        temps = np.zeros((rb,), np.float32)
        topks = np.zeros((rb,), np.int32)
        lslots = np.zeros((rb,), np.int32)
        for i, (req, pos, n) in enumerate(rows):
            chunks[i, :n] = req.prompt_ids[pos:pos + n]
            bts[i] = self._block_tables[req.slot][:W]
            sps[i], tls[i] = pos, n
            temps[i] = req.params.temperature
            topks[i] = req.params.top_k
            lslots[i] = req.adapter_slot
        mode = self._sampling_mode([q for q, _, _ in rows])
        with self.profiler.step("prefill", (rb, mode, W)):
            toks, lps = self._prefill_rows(mode, chunks, bts, sps, tls,
                                           temps, topks, lslots)
        self._rng_ctr += 1
        self.stats["prefill_dispatches"] += 1
        self._mesh_account(
            chunks.nbytes + bts.nbytes + sps.nbytes + tls.nbytes
            + temps.nbytes + topks.nbytes + lslots.nbytes,
            toks.nbytes + (0 if lps is None else lps.nbytes))
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
            if req.prefill_only:
                # disaggregated prefill: export the KV pages and the first
                # token instead of decoding here. Under the pool lock:
                # _release mutates the allocator a concurrent submit or
                # import also touches; the finish (telemetry) stays
                # outside it
                with self._lock:
                    req.export_payload = self._export_kv_locked(req, tok)
                    self._release(req)
                self._finish_request(req, "export")
                continue
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
        # rows padded to a power of two, as for prefill: pad rows have a
        # zero table and write only sink page 0
        r, s1 = len(slots), s + 1
        rb = self._row_bucket(r, cfg.max_batch_size)
        # table-width bucket: every row writes positions start..start+s1-1
        W = self._page_bucket(max(
            (self._lengths[sl] + s1 - 1) // page + 1 for sl in slots))
        toks = np.zeros((rb, s1), np.int32)
        bts = np.zeros((rb, W), np.int32)
        starts = np.zeros((rb,), np.int32)
        lslots = np.zeros((rb,), np.int32)
        allow: dict[int, int] = {}
        for i, slot in enumerate(slots):
            req = self._active[slot]
            allow[slot] = self._reserve(req, s1)
            toks[i, 0] = req.out_ids[-1]
            toks[i, 1:1 + len(drafts[slot])] = drafts[slot]
            bts[i] = self._block_tables[slot][:W]
            starts[i] = self._lengths[slot]
            lslots[i] = req.adapter_slot
        want_lp = any(self._active[sl].params.logprobs for sl in slots)
        with self.profiler.step("verify", (rb, s1, W, want_lp)):
            y, ylp = self._verify_rows(toks, bts, starts, want_lp, lslots)
        self.stats["spec_dispatches"] += 1
        self._mesh_account(
            toks.nbytes + bts.nbytes + starts.nbytes + lslots.nbytes,
            y.nbytes + (0 if ylp is None else ylp.nbytes))
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
        lslots = np.zeros((bs,), np.int32)
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
            lslots[slot] = req.adapter_slot
        mode = self._sampling_mode(self._active.values())
        with self.profiler.step("decode", (w, mode, W)):
            out, lps = self._decode_window(w, mode, tokens, bt, lengths,
                                           temps, topks, lslots)
        self._rng_ctr += 1
        self.stats["decode_dispatches"] += 1
        self._mesh_account(
            tokens.nbytes + bt.nbytes + lengths.nbytes + temps.nbytes
            + topks.nbytes + lslots.nbytes,
            out.nbytes + (0 if lps is None else lps.nbytes))
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

    # -- multi-LoRA slot plumbing (cfg.max_adapters; llm/multilora) --------

    def load_adapter_slot(self, slot: int, adapter) -> None:
        """Install an adapter into a slot-table row in place (None clears
        it). The caller serializes against the stepping thread (the
        serving layer's step lock), so a load lands between dispatches."""
        if self.lora is None:
            raise ValueError(
                "engine built without a slot table "
                "(PagedEngineConfig.max_adapters == 0)")
        with self._lock:
            self.lora.load(slot, adapter)

    def adapter_slots_in_use(self) -> dict:
        """{slot: live request count} over pending+prefilling+active —
        what the manager's LRU must NOT evict (a resident adapter with
        in-flight requests is pinned to its admitted version)."""
        with self._lock:
            counts: dict[int, int] = {}
            for req in (list(self._pending) + list(self._prefilling)
                        + list(self._active.values())):
                if req.adapter_slot:
                    counts[req.adapter_slot] = \
                        counts.get(req.adapter_slot, 0) + 1
            return counts

    # -- KV pages <-> host payloads -----------------------------------------

    def _pages_to_host(self, pids) -> list:
        """[{"k", "v": [n, page, KVH, D] host array}] per layer for the
        pages ``pids``: one gather per layer (per tp rank, its kv_heads
        put back in rank order) and one device-to-host copy of them all,
        between dispatches. bf16 pages come back as their raw 16-bit
        patterns (``np.uint16``)."""
        idx = torch.as_tensor(np.asarray(pids, np.int64), device=self.device)
        shards = self._shards()

        def gather(li, kv):
            parts = [s[li][kv].index_select(0, idx.to(s[li][kv].device))
                     .to(self.device) for s in shards]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)
        n_layers = self.cfg.model.n_layers
        t = torch.stack([gather(li, kv) for li in range(n_layers)
                         for kv in ("k", "v")])
        if t.dtype == torch.bfloat16:
            host = t.view(torch.int16).cpu().numpy().view(np.uint16)
        else:
            host = t.cpu().numpy()
        return [{"k": host[2 * i], "v": host[2 * i + 1]}
                for i in range(n_layers)]

    def _pages_from_host(self, pids, pages: list, sel) -> None:
        """Write rows ``sel`` of a payload's per-layer page arrays into
        the cache pages ``pids``, in place (``index_copy_`` into the
        existing pool tensors: the captured programs keep reading them),
        with one host-to-device copy. Caller holds self._lock and
        serializes against stepping. On a mesh each rank takes its slice
        of the kv_heads."""
        mc = self.cfg.model
        dtype = mc.dtype
        want = (self.cfg.page_size, mc.n_kv_heads, mc.head_dim)
        host = None
        for i, a in enumerate(np.asarray(layer[kv]) for layer in pages
                              for kv in ("k", "v")):
            if tuple(a.shape[1:]) != want:
                raise ValueError(f"payload page shape {a.shape[1:]} "
                                 f"!= this engine's {want}")
            a = _raw_pages(a, dtype)
            if host is None:
                host = np.empty((2 * len(pages), len(sel)) + want, a.dtype)
            np.take(a, sel, axis=0, out=host[i])    # the one host copy
        t = torch.from_numpy(host)
        if dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        t = t.to(self.device)
        idx = torch.as_tensor(np.asarray(pids, np.int64), device=self.device)
        shards = self._shards()
        kvh = mc.n_kv_heads // len(shards)
        for r, shard in enumerate(shards):
            for i, layer in enumerate(shard):
                for j, kv in enumerate(("k", "v")):
                    dst = layer[kv]
                    src = t[2 * i + j][:, :, r * kvh:(r + 1) * kvh]
                    dst.index_copy_(0, idx.to(dst.device), src.to(dst.device))

    # -- prefill/decode disaggregation -------------------------------------

    def _export_kv_locked(self, req: _Request, first_token: int) -> dict:
        """Gather this request's KV pages to host arrays for a decode
        engine (the role the KV connector plays in PD deployments)."""
        return {"prompt_ids": list(req.prompt_ids),
                "first_token": int(first_token),
                "page_size": self.cfg.page_size,
                # chained content hashes of the FULL prompt pages, in page
                # order: the decode side maps pages it already holds
                "page_hashes": list(self._prompt_hashes(req)),
                # the chain's seed, so the decode side's hashes land in
                # the same (tenant-scoped) key space
                "prefix_salt": req.prefix_salt,
                "pages": self._pages_to_host(req.pages)}

    def prefill_export(self, prompt, params: SamplingParams) -> dict:
        """Chunked-prefill ``prompt`` and return its exported KV payload
        (drives the engine loop until the export is ready)."""
        req = self.submit(prompt, params)
        req.prefill_only = True
        while req.export_payload is None and not req.done:
            self.step()
        if req.export_payload is None:
            raise RuntimeError("prefill finished without an export "
                               "(prompt rejected?)")
        return req.export_payload

    def import_prefill(self, payload: dict, params: SamplingParams,
                       ) -> _Request:
        """Seed a decode-ready sequence from an exported KV payload:
        allocate slot and pages, copy the page data into this engine's
        pools in place, and place the request directly in the decode
        set."""
        if payload["page_size"] != self.cfg.page_size:
            raise ValueError(
                f"page_size mismatch: payload {payload['page_size']} vs "
                f"engine {self.cfg.page_size}")
        ids = list(payload["prompt_ids"])
        with self._lock:
            req = _Request(self._next_rid, ids, params)
            req.prefix_salt = payload.get("prefix_salt", b"")
            req.submit_t = time.perf_counter()
            req.admit_t = req.submit_t
            telemetry.on_submit(self, req)
            self._next_rid += 1
            if not self._free_slots:
                raise RuntimeError("no free decode slot")
            req.slot = self._free_slots.popleft()
            n_pages = self._pages_needed(len(ids) + 1)
            n_in = len(payload["pages"][0]["k"])
            if n_in != n_pages:
                self._release(req)
                raise ValueError(
                    f"payload covers {n_in} pages but this engine "
                    f"needs {n_pages} for the same prompt")
            # dedupe: payload pages whose content hash this engine holds
            # are mapped (and pinned) instead of copied in; the chain
            # property makes the reusable run a prefix of the page list.
            # The partial tail page is always private.
            hashes = payload.get("page_hashes")
            if hashes is None and self._prefix_on:
                hashes = self._hash_chain(ids, prev=req.prefix_salt)
            matched: list[int] = []
            if self._prefix_on and hashes:
                for h in hashes:
                    pid = self._hash_to_page.get(h)
                    if pid is None:
                        break
                    matched.append(pid)
            pages = self._claim_pages(matched, n_pages)
            if pages is None:
                self._release(req)
                raise RuntimeError("page pool exhausted importing prefill")
            fresh = list(range(len(matched), n_pages))
            req.pages = pages
            self._block_tables[req.slot, :n_pages] = pages
            if self._prefix_on:
                # deduped imports save the copy, not prefill compute (the
                # prefill engine counted any skipped prefill), so
                # tokens_saved stays untouched here
                self.stats["prefix_hits"] += len(matched)
                nf = len(ids) // self.cfg.page_size   # full prompt pages
                self.stats["prefix_misses"] += nf - len(matched)
                if self.chains is not None and hashes:
                    req.chain_slot = self.chains.slot_for(
                        hashes[0], req.prefix_salt)
                    if matched:
                        self.chains.hit(req.chain_slot, len(matched))
                    if nf > len(matched):
                        self.chains.miss(req.chain_slot,
                                         nf - len(matched))
            if fresh:
                self._pages_from_host([pages[i] for i in fresh],
                                      payload["pages"], np.asarray(fresh))
                if self._prefix_on and hashes:
                    for i in fresh:
                        if i < len(hashes):
                            self._register_page(pages[i], hashes[i],
                                                chain=req.chain_slot)
            tok = int(payload["first_token"])
            req.out_ids.append(tok)
            self.stats["tokens_out"] += 1
            req.prefill_pos = len(ids)
            req.first_token_t = time.perf_counter()
            self._lengths[req.slot] = len(ids)
            self._active[req.slot] = req
            self._maybe_finish(req, tok)
        return req

    # -- cross-engine prefix import/export (the prefix directory's hooks:
    # the same chained hashes and in-place page copies as import_prefill,
    # but the imported pages seed the CACHE — refcount 0, LRU-parked) ----

    def cached_prefix_len(self, hashes) -> int:
        """How many of ``hashes`` (a chain run) this engine's cache
        covers, walking from the head until the first miss."""
        with self._lock:
            n = 0
            for h in hashes:
                if h not in self._hash_to_page:
                    break
                n += 1
            return n

    def export_prefix(self, hashes) -> Optional[dict]:
        """Gather the cached pages for a chain run of hashes to host
        arrays: the longest covered prefix run, or None when even the
        first page is gone (directory entries are hints; this engine may
        have evicted since publishing). The caller serializes against
        the stepping thread."""
        with self._lock:
            pids: list[int] = []
            for h in hashes:
                pid = self._hash_to_page.get(h)
                if pid is None:
                    break
                pids.append(pid)
            if not pids:
                return None
            pages = self._pages_to_host(pids)
            self.stats["prefix_exported_pages"] += len(pids)
            if self.chains is not None:
                # peek, never assign: the pages were registered here, so
                # the chain (or the overflow sink) exists
                self.chains.exported(self.chains.peek(hashes[0]),
                                     len(pids))
            return {"page_size": self.cfg.page_size,
                    "page_hashes": list(hashes[:len(pids)]),
                    "pages": pages}

    def import_prefix(self, payload: Optional[dict],
                      reserve_pages: Optional[int] = None) -> int:
        """Seed this engine's prefix cache with another engine's exported
        pages: allocate, copy in place, register under the payload's
        chain hashes and park refcount-0 in the cached LRU, so the next
        admission matches them like locally computed pages. Imports stop
        once the pool would drop below ``reserve_pages`` allocatable
        pages (default one per slot). Returns pages imported. The caller
        serializes against the stepping thread."""
        if payload is None or not self._prefix_on:
            return 0
        if payload["page_size"] != self.cfg.page_size:
            raise ValueError(
                f"page_size mismatch: payload {payload['page_size']} vs "
                f"engine {self.cfg.page_size}")
        with self._lock:
            if reserve_pages is None:
                reserve_pages = self.cfg.max_batch_size
            return self._import_payload_locked(payload,
                                               int(reserve_pages))

    def _import_payload_locked(self, payload: dict, reserve_pages: int,
                               chain: Optional[int] = None) -> int:
        """The allocate/copy/register/LRU-park core behind import_prefix
        and the spill tier's promotes (same payload format: a promoted
        page is bit-identical to a never-evicted one). ``chain`` pins
        the heat attribution (promotes know their chain); None means
        cross-engine import accounting: the slot from the payload's head
        hash, the imported-pages counters, a flight event. Caller holds
        self._lock and serializes against stepping."""
        hashes = payload["page_hashes"]
        take_idx: list[int] = []
        take_pids: list[int] = []
        budget = self._pages_avail() - reserve_pages
        for i, h in enumerate(hashes):
            if h in self._hash_to_page:
                continue    # already cached locally (either source)
            if budget <= 0:
                break
            pid = self._pop_free_page()
            self._page_refs[pid] = 0
            take_idx.append(i)
            take_pids.append(pid)
            budget -= 1
        if not take_pids:
            return 0
        self._pages_from_host(take_pids, payload["pages"],
                              np.asarray(take_idx))
        slot = -1
        if chain is not None:
            slot = chain
        elif self.chains is not None:
            # the exporter's head hash carries the tenant salt inside
            # the digest; cross-engine imports are keyed by content alone
            slot = self.chains.slot_for(hashes[0])
        if chain is None and self.chains is not None:
            self.chains.imported(slot, len(take_pids))
            flight.evt(flight.PREFIX_IMPORT, len(take_pids), slot)
        for i, pid in zip(take_idx, take_pids):
            self._register_page(pid, hashes[i], chain=slot)
            self._cached_lru[pid] = None
        if chain is None:
            self.stats["prefix_imported_pages"] += len(take_pids)
        return len(take_pids)

    def drain_directory_delta(self) -> tuple:
        """-> (new_hashes, dropped_hashes) since the last drain, filtered
        against the current cache so a publish-then-evict (or
        evict-then-republish) nets out. Only meaningful with
        track_page_publish on; called serialized with stepping."""
        if not self._dir_new and not self._dir_dropped:
            return (), ()
        new, self._dir_new = self._dir_new, []
        dropped, self._dir_dropped = self._dir_dropped, []
        with self._lock:
            new = [h for h in dict.fromkeys(new)
                   if h in self._hash_to_page]
            dropped = [h for h in dict.fromkeys(dropped)
                       if h not in self._hash_to_page]
        return new, dropped

    # -- spill tier (cfg.kv_spill, llm/tiering.py) -------------------------

    def _promote_for_locked(self, req: _Request, have: int) -> int:
        """Admission-time promote: when the hot cache's longest-prefix
        match ends but the tier holds the next consecutive pages of the
        request's chain, copy them back onto the card before cold
        prefill. Runs under self._lock on the stepping thread (from
        _admit). Returns pages promoted; the caller re-matches."""
        page = self.cfg.page_size
        limit = self._reuse_limit(req) // page
        if have >= limit:
            return 0
        need = self._pages_needed(len(req.prompt_ids) + 1)
        if self._pages_avail() < need:
            return 0    # admission would stall regardless: no churn
        hashes = self._prompt_hashes(req)
        run = self.spill.covered_run(hashes[have:limit])
        if run <= 0:
            return 0
        want = hashes[have:have + run]
        chain = self.spill.chain_of(want[0])
        payload, dropped = self.spill.payload_for(want, page)
        if dropped:
            self._spill_dropped(dropped)
        if payload is None:
            return 0
        n = self._import_payload_locked(payload, 0, chain=chain)
        if n > 0:
            self.stats["spill_promotions"] += n
            if self.chains is not None:
                self.chains.promoted(chain, n)
        return n

    def maybe_rewarm(self, max_pages: Optional[int] = None) -> int:
        """Proactive re-warm: promote the hottest spilled chain's known
        head run back onto the card while the pool has idle headroom
        (SpillPolicy.rewarm_slot). Called by the serving loop between
        steps; a no-op without headroom. Returns pages promoted."""
        if self.spill is None or self.chains is None:
            return 0
        with self._lock:
            pool = self.cfg.num_pages - 1
            free_frac = len(self._free_pages) / max(pool, 1)
            slot = self.spill.policy.rewarm_slot(
                self.chains, self.spill.spilled_slots(), free_frac)
            if slot is None:
                return 0
            run = self._chain_runs.get(slot)
            if not run:
                return 0
            # the head-rooted usable run: hot pages pass through,
            # tier-resident pages promote, the first page in neither
            # tier ends the run
            want: list[bytes] = []
            for h in run:
                if h in self._hash_to_page or self.spill.has(h):
                    want.append(h)
                else:
                    break
            want = [h for h in want if h not in self._hash_to_page]
            if max_pages is not None:
                want = want[:max(int(max_pages), 0)]
            if not want:
                return 0
            payload, dropped = self.spill.payload_for(
                want, self.cfg.page_size)
            if dropped:
                self._spill_dropped(dropped)
            if payload is None:
                return 0
            n = self._import_payload_locked(
                payload, self.cfg.max_batch_size, chain=slot)
            if n > 0:
                self.stats["spill_promotions"] += n
                self.chains.promoted(slot, n)
            return n

    def note_spill_promotion(self, head: bytes, pages: int) -> None:
        """Cross-engine promote accounting: pages seeded from another
        engine's spilled payload count as spill promotions here, on top
        of the imported pages the copy already counted."""
        with self._lock:
            self.stats["spill_promotions"] += int(pages)
            if self.chains is not None:
                self.chains.promoted(self.chains.peek(head), int(pages))

    def note_spill_drops(self, n: int) -> None:
        """Cross-engine validate-on-promote failures: a stale spilled
        payload cost a cold prefill."""
        with self._lock:
            self.stats["spill_drops"] += int(n)

    def spill_teardown(self) -> int:
        """Drop every tier entry with exact accounting. Returns entries
        dropped."""
        if self.spill is None:
            return 0
        with self._lock:
            removed = self.spill.clear()
            self._spill_expired(removed)
            return len(removed)

    # -- stats -------------------------------------------------------------

    def estimate_flops(self) -> dict:
        """FLOPs per dispatch for the program families, counted by
        running one dummy dispatch per static key eagerly under
        ``FlopCounterMode`` (``util/profiling.compiled_flops``: it cannot
        see a graph replay; run once, after traffic, not per step). The
        dummies are warmup's: zero block tables and zero true lengths,
        every write on sink page 0, and no counter, RNG position or
        profiler count moves.

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

    def _dummy(self, kind: str, key: tuple) -> tuple:
        """(body, host arrays) of a dispatch at a profiler tag's static
        key, with zero block tables and zero true lengths / starts:
        every write lands on sink page 0. Used by warmup."""
        cfg = self.cfg
        bs, c = cfg.max_batch_size, cfg.chunk_size
        zi = lambda *s: np.zeros(s, np.int32)                  # noqa: E731
        zf = lambda *s: np.zeros(s, np.float32)                # noqa: E731
        if kind == "decode":
            w, mode, W = key
            return (functools.partial(self._decode_body, w, mode),
                    (zi(bs), zi(bs, W), zi(bs), zf(bs), zi(bs), zi(1))
                    + self._lora_args(None, bs))
        if kind == "prefill":
            r, mode, W = key
            return (functools.partial(self._prefill_body, mode),
                    (zi(r, c), zi(r, W), zi(r), zi(r), zf(r), zi(r), zi(1))
                    + self._lora_args(None, r))
        r, s1, W, want_lp = key                       # verify
        return (functools.partial(self._verify_body, want_lp),
                (zi(r, s1), zi(r, W), zi(r)) + self._lora_args(None, r))

    def _dispatch_for_key(self, kind: str, key: tuple):
        """(fn, *args): fn(*args) runs warmup's dummy dispatch at a
        profiler tag's static key eagerly (estimate_flops counts it)."""
        body, arrays = self._dummy(kind, key)
        return (self._run_eager, body, *arrays)

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
        snapshot, so the surfaces cannot drift from each other. The spill
        keys are all 0 while the tier is off."""
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
            **{k: self.stats[k] for k in (
                "spill_pages", "spill_bytes", "spill_demotions",
                "spill_promotions", "spill_expired", "spill_drops")},
            "spill_resident_pages": self.spill.resident_pages()
            if self.spill is not None else 0,
            "spill_resident_bytes": self.spill.resident_bytes
            if self.spill is not None else 0,
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
