"""The dense-slot serving engine, and the request intake, sampling and
result shaping shared with the paged engine (counterpart of
``ray_tpu/llm/engine.py``: ``SamplingParams``, ``EngineConfig``,
``_Request``, ``sample_logits``, ``sample_logits_batch``, ``_EngineBase``
and ``InferenceEngine``). Both engines call the reference's telemetry
hooks (``llm/telemetry.py``) at the reference's sites: ``on_submit`` at
intake, ``on_admit`` / ``on_first_token`` / ``on_step`` in the loop and
``on_finish`` at retirement.

Sampling runs on the device of the logits. Random draws are counter
based, as ``jax.random``'s are: a key is one 32-bit value in an int64
tensor on the device (``root_key``), ``fold_in`` derives a key from a
key and a counter, and ``uniform`` hashes (key, element index) into
uniforms, all with integer tensor ops. A draw is a pure function of
(engine seed, dispatch counter, window step, row, vocab index), so it
needs no host-side generator state, and a captured CUDA graph that reads
the counter from a device buffer draws fresh numbers on every replay,
the same numbers the eager body draws. It does not reproduce the
reference's threefry stream. Greedy rows are exact: ``torch.argmax``
returns the first maximum, like ``jnp.argmax``.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from ..models import llama
from . import telemetry
from .tokenizer import get_tokenizer


@dataclasses.dataclass
class SamplingParams:
    """(reference: vLLM SamplingParams surface)"""
    max_tokens: int = 64
    temperature: float = 0.0          # 0 = greedy
    top_k: int = 0                    # 0 = no top-k
    stop_token_ids: tuple = ()
    seed: int = 0
    # > 0: return the chosen token's log-probability per generated token
    # (model-natural log_softmax, not temperature-scaled)
    logprobs: int = 0


@dataclasses.dataclass
class EngineConfig:
    model: llama.LlamaConfig
    max_batch_size: int = 8
    max_seq_len: int = 1024
    prefill_buckets: tuple = (32, 64, 128, 256, 512, 1024)
    tokenizer: Any = None


@dataclasses.dataclass
class _Request:
    """One in-flight generation."""
    rid: int
    prompt_ids: list[int]
    params: SamplingParams
    out_ids: list[int] = dataclasses.field(default_factory=list)
    out_logps: list[float] = dataclasses.field(default_factory=list)
    slot: int = -1
    pages: list[int] = dataclasses.field(default_factory=list)
    prefill_pos: int = 0          # prompt tokens already prefilled
    # multi-LoRA (paged engine, cfg.max_adapters): the slot-table row
    # this request's dispatches gather, 0 = base model. Pinned for the
    # request's life: a hot-swap to a newer adapter version lands in a
    # different slot, so in-flight requests finish on their version.
    adapter_slot: int = 0
    # prefix-cache chain seed: empty for base traffic; a tenant salt keeps
    # cached pages from matching across tenants
    prefix_salt: bytes = b""
    # content-hash chain of the prompt's FULL pages (prefix caching);
    # computed lazily at admission, None until then
    page_hashes: Optional[list] = None
    # chain-stats slot this request's prompt family resolved to; -1 = none
    chain_slot: int = -1
    # disaggregated prefill (paged engine, prefill_export): the request
    # stops after its prompt and leaves its KV pages in export_payload
    prefill_only: bool = False
    export_payload: Optional[dict] = None
    done: bool = False
    submit_t: float = 0.0
    first_token_t: float = 0.0    # TTFT = first_token_t - submit_t
    # telemetry (llm/telemetry.py): admission time, wall-clock submit
    # (spans use wall time), serve request id, and the submitter's trace
    # context so the engine thread can emit an llm.request span
    admit_t: float = 0.0
    submit_wall: float = 0.0
    request_id: str = ""
    trace_ctx: Optional[tuple] = None
    event: threading.Event = dataclasses.field(
        default_factory=threading.Event)


_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer hash of an int64 tensor holding values below
    2**32: two multiply-xorshift rounds whose multipliers are below
    2**31, so every product fits in int64 and nothing wraps."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def root_key(seed: int, device) -> torch.Tensor:
    """The key of an engine seed (its low 32 bits), on ``device``."""
    return torch.tensor([int(seed) & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """A new key from ``key`` and ``data`` (a Python int or an integer
    tensor of one element), the counterpart of ``jax.random.fold_in``."""
    if torch.is_tensor(data):
        data = data.to(torch.int64)
    return _mix32(_mix32(key) ^ (data & _M32))


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """f32 uniforms in (0, 1) of ``shape`` on the key's device: element i
    is a hash of (key, i), with 24 random bits."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64,
                       device=key.device).reshape(shape)
    h = _mix32(_mix32(idx ^ key) ^ _mix32(key ^ 0x5851F42D))
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def sample_logits(logits, key: Optional[torch.Tensor], temperature: float,
                  top_k: int):
    """Sampling over [B, V] logits with one set of params (greedy /
    temperature / top-k), on the logits' device. Sampled rows draw by
    Gumbel-max over ``uniform(key, ...)``; greedy ignores ``key``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, -1e30, logits)
    u = uniform(key, logits.shape)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample_logits_batch(logits, key: Optional[torch.Tensor], temps,
                        top_ks, *, any_sampled: bool = True,
                        any_topk: bool = True, want_logp: bool = True):
    """Per-ROW sampling over [B, V] f32 logits with per-row params, on the
    logits' device. Returns (tokens [B] int32, chosen logprob [B] f32 or
    None).

    temps[b] <= 0 selects greedy for that row; top_ks[b] > 0 masks to that
    row's top-k scaled logits, exactly for any k (per-row threshold from
    one full sort). Sampled rows draw by Gumbel-max over
    ``uniform(key, ...)`` (argmax of scaled logits + Gumbel noise is a
    draw from their softmax). any_sampled/any_topk/want_logp are hints
    from the batch: all-greedy batches skip the draw, no-top-k batches
    skip the sort, batches without a logprobs request skip the
    log_softmax. The logprob is the model-natural one, from the RAW
    logits."""
    def chosen_logp(tok):
        if not want_logp:
            return None
        lsm = torch.log_softmax(logits, dim=-1)
        return lsm.gather(-1, tok[:, None].long())[:, 0]

    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not any_sampled:
        return greedy, chosen_logp(greedy)
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    if any_topk:
        v = logits.shape[-1]
        svals = torch.sort(scaled, dim=-1).values              # ascending
        k_idx = v - torch.clamp(top_ks, 1, v)
        kth = svals.gather(1, k_idx[:, None].long())
        scaled = torch.where((top_ks[:, None] > 0) & (scaled < kth),
                             -1e30, scaled)
    u = uniform(key, scaled.shape)
    sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    tok = torch.where(temps <= 0.0, greedy, sampled.to(torch.int32))
    return tok, chosen_logp(tok)


class _EngineBase:
    """Request intake and result shaping. Subclasses provide step() and
    maintain self.cfg (with .max_seq_len), self._lock, self._pending,
    self._active, self._next_rid and self.tokenizer."""

    telemetry_kind = "dense"

    def generate(self, prompts, params=None) -> list[dict]:
        """Blocking batch generation; returns [{text, token_ids,
        prompt_tokens, ttft_s, finish_reason, logprobs}] in prompt
        order."""
        if params is None:
            params = SamplingParams()
        plist = params if isinstance(params, list) else \
            [params] * len(prompts)
        reqs = [self.submit(p, sp) for p, sp in zip(prompts, plist)]
        self.run_until_done(reqs)
        return [self._result(r) for r in reqs]

    def submit(self, prompt, params: SamplingParams,
               adapter_slot: int = 0,
               prefix_salt: bytes = b"") -> _Request:
        ids = (self.tokenizer.encode(prompt) if isinstance(prompt, str)
               else [int(t) for t in prompt])
        # keep the prompt (up to the cache capacity) and clamp max_tokens
        # to the remaining room — never silently discard the prompt
        ids = ids[: self.cfg.max_seq_len - 2]
        if not ids:
            raise ValueError("empty prompt")
        if adapter_slot:
            table = getattr(self, "lora", None)
            if table is None:
                raise ValueError(
                    "adapter_slot requires a paged engine with "
                    "PagedEngineConfig.max_adapters > 0")
            if not 0 < adapter_slot < table.max_adapters:
                raise ValueError(
                    f"adapter_slot {adapter_slot} outside the slot "
                    f"table [1, {table.max_adapters})")
        capacity = self.cfg.max_seq_len - 1 - len(ids)
        if params.max_tokens > capacity:
            params = dataclasses.replace(params,
                                         max_tokens=max(1, capacity))
        with self._lock:
            req = _Request(self._next_rid, ids, params)
            req.adapter_slot = int(adapter_slot)
            req.prefix_salt = bytes(prefix_salt)
            req.submit_t = time.perf_counter()
            self._next_rid += 1
            # stamp trace/request identity BEFORE publishing: once req is
            # in _pending a concurrently stepping engine thread can retire
            # a short request and emit its span/metrics immediately
            telemetry.on_submit(self, req)
            self._pending.append(req)
        return req

    def _finish_request(self, req: _Request, finish=None):
        """Retire a request: mark done, wake waiters, emit telemetry
        (TTFT/ITL/e2e observations + the request's trace span)."""
        if req.done:
            return
        req.done = True
        req.event.set()
        telemetry.on_finish(self, req, finish)

    def has_work(self) -> bool:
        return bool(self._pending or self._active)

    def run_until_done(self, reqs: list[_Request]):
        while not all(r.done for r in reqs):
            self.step()

    def _next_rng(self) -> int:
        """Counter of the next sampling draw: it advances on every draw,
        greedy or not, so a request's stream does not depend on what it
        is batched with."""
        ctr = self._rng_ctr
        self._rng_ctr += 1
        return ctr

    def _key(self, ctr: int) -> torch.Tensor:
        """The sampling key of draw ``ctr``: the engine's key folded with
        the counter, then with step 0 (the paged engine's first window
        step)."""
        return fold_in(fold_in(self._rng_key, ctr), 0)

    def _sample_one(self, logits, params: SamplingParams) -> np.ndarray:
        ctr = self._next_rng()
        key = self._key(ctr) if params.temperature > 0 else None
        return sample_logits(logits, key, params.temperature,
                             params.top_k).cpu().numpy()

    def _sample_next_tokens(self, logits, ctr: int) -> dict[int, int]:
        """Per-slot next token, batching slots that share sampling params
        (one key for the step, as the reference passes one rng to every
        group)."""
        by_params: dict[tuple, list[int]] = {}
        for slot, req in self._active.items():
            by_params.setdefault(
                (req.params.temperature, req.params.top_k), []).append(slot)
        key = (self._key(ctr) if any(t > 0 for t, _ in by_params)
               else None)
        next_tokens: dict[int, int] = {}
        for (temp, top_k), slots in by_params.items():
            rows = torch.as_tensor(slots, device=logits.device)
            sampled = sample_logits(logits[rows], key, temp, top_k)
            for s, t in zip(slots, sampled.cpu().tolist()):
                next_tokens[s] = int(t)
        return next_tokens

    def _eos_id(self):
        return getattr(self.tokenizer, "eos_id",
                       getattr(self.tokenizer, "eos_token_id", None))

    def _result(self, req: _Request) -> dict:
        eos = getattr(self.tokenizer, "eos_id", None)
        trimmed = [t for t in req.out_ids if t != eos]
        return {
            "text": self.tokenizer.decode(trimmed),
            "token_ids": req.out_ids,
            "prompt_tokens": len(req.prompt_ids),
            "ttft_s": (req.first_token_t - req.submit_t
                       if req.first_token_t else None),
            "finish_reason": ("stop" if eos is not None and eos in req.out_ids
                              else "length"),
            "logprobs": (list(req.out_logps) if req.params.logprobs
                         and req.out_logps else None),
        }


class InferenceEngine(_EngineBase):
    """Synchronous dense-slot engine: a fixed pool of batch slots backs a
    slot-indexed KV cache (``llama.init_slot_cache``). Prefill pads the
    prompt to a bucket and runs ``llama.prefill_with_kv`` (attention
    through the flash forward kernel on the card); decode advances every
    slot one token per step (``llama.decode_batched``). New requests join
    at any step and a finished slot frees at once. ``device`` defaults to
    CUDA and raises when it is absent; pass ``device="cpu"`` for the
    plain versions."""

    def __init__(self, cfg: EngineConfig, params: Optional[dict] = None,
                 rng_seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.model_cfg = cfg.model
        self.device = llama.resolve_device(device)
        self.tokenizer = get_tokenizer(cfg.tokenizer)
        if params is None:
            params = llama.init(cfg.model, seed=rng_seed, device=self.device)
        self.params = params
        self.cache = llama.init_slot_cache(cfg.model, cfg.max_batch_size,
                                           cfg.max_seq_len,
                                           device=self.device)
        # host copy of cache["lengths"]: the stop check reads it without
        # a device sync per slot
        self._lengths = np.zeros((cfg.max_batch_size,), np.int64)
        self._free_slots = deque(range(cfg.max_batch_size))
        self._active: dict[int, _Request] = {}      # slot -> request
        self._pending: deque[_Request] = deque()
        self._next_rid = 0
        self._rng_key = root_key(rng_seed ^ 0x5EED, self.device)
        self._rng_ctr = 0
        self._lock = threading.Lock()
        # dispatch/token counts (paged engine parity)
        self.stats = {"prefill_dispatches": 0, "decode_dispatches": 0,
                      "tokens_out": 0}

    def _prefill(self, tokens, slot: int, true_len: int):
        """tokens [1, S] (right-padded to a bucket) -> writes K/V of the
        whole bucket into the slot's cache row, sets its length to
        true_len, and returns the logits at the last REAL prompt position
        [1, V]. Pad positions' K/V land at and past true_len and are
        never attended (decode masks k_pos <= length) before being
        overwritten."""
        logits, ks, vs = llama.prefill_with_kv(self.params, tokens,
                                               true_len - 1, self.model_cfg)
        s = tokens.shape[1]
        self.cache["k"][:, slot, :s] = ks[:, 0]
        self.cache["v"][:, slot, :s] = vs[:, 0]
        self.cache["lengths"][slot] = true_len
        self._lengths[slot] = true_len
        return logits

    def _decode(self, tokens: np.ndarray, active: np.ndarray):
        """tokens [B] -> logits [B, V]; inactive rows don't advance their
        length, and no length passes max_seq_len - 1 (every slot writes
        at its length, so that keeps every write inside the cache)."""
        act = torch.from_numpy(active).to(self.device)
        logits, new = llama.decode_batched(
            self.params, torch.from_numpy(tokens).to(self.device)[:, None],
            self.cache, self.model_cfg)
        top = self.cfg.max_seq_len - 1
        lengths = torch.where(act, new["lengths"], self.cache["lengths"])
        self.cache["lengths"] = torch.clamp(lengths, max=top)
        self._lengths = np.minimum(
            np.where(active, self._lengths + 1, self._lengths), top)
        return logits

    # -- engine loop -------------------------------------------------------

    def step(self):
        """One engine iteration: admit pending prompts (prefill), then one
        batched decode step over all active slots."""
        self._admit()
        if not self._active:
            return
        bs = self.cfg.max_batch_size
        tokens = np.zeros((bs,), np.int32)
        active = np.zeros((bs,), bool)
        for slot, req in self._active.items():
            tokens[slot] = req.out_ids[-1]
            active[slot] = True
        ctr = self._next_rng()
        logits = self._decode(tokens, active)
        self.stats["decode_dispatches"] += 1
        self._sample_and_retire(logits, ctr)
        telemetry.on_step(self)

    def _admit(self):
        with self._lock:
            while self._pending and self._free_slots:
                req = self._pending.popleft()
                slot = self._free_slots.popleft()
                req.slot = slot
                self._active[slot] = req
                telemetry.on_admit(self, req)
                self._do_prefill(req)

    def _bucket(self, n: int) -> int:
        for b in self.cfg.prefill_buckets:
            if n <= b:
                return min(b, self.cfg.max_seq_len)
        return self.cfg.max_seq_len

    def _do_prefill(self, req: _Request):
        ids = req.prompt_ids
        padded = ids + [0] * (self._bucket(len(ids)) - len(ids))
        tokens = torch.tensor([padded], dtype=torch.int32, device=self.device)
        last_logits = self._prefill(tokens, req.slot, len(ids))
        first = self._sample_one(last_logits, req.params)
        req.out_ids.append(int(first[0]))
        req.first_token_t = time.perf_counter()
        self.stats["prefill_dispatches"] += 1
        self.stats["tokens_out"] += 1
        telemetry.on_first_token(self, req)

    def _sample_and_retire(self, logits, ctr: int):
        next_tokens = self._sample_next_tokens(logits, ctr)
        eos = self._eos_id()
        for slot in list(self._active):
            req = self._active[slot]
            tok = next_tokens[slot]
            req.out_ids.append(tok)
            self.stats["tokens_out"] += 1
            stop = (len(req.out_ids) >= req.params.max_tokens
                    or tok == eos or tok in req.params.stop_token_ids
                    or self._lengths[slot] >= self.cfg.max_seq_len - 1)
            if stop:
                self._finish_request(req)
                del self._active[slot]
                self._free_slots.append(slot)
