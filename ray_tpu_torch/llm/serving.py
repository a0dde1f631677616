"""The engine behind a Serve deployment, in process (counterpart of
``ray_tpu/llm/serving.py``: ``LLMConfig`` and ``LLMServer``).

Reference parity: llm/_internal/serve/deployments/llm/llm_server.py:409
(LLMServer — request intake feeding a background engine loop); the
response shapes match the OpenAI completions surface the reference's
router exposes (``llm/openai_api.py``).

``LLMServer`` runs its engine on a background thread; request threads
call ``completions`` / ``completions_stream`` concurrently and wait on
per-request events. On the card the paged engine's programs are CUDA
graphs (``llm/graphs.py``): warmup captures them in the constructor,
and a key first met in traffic is captured on the engine thread, in
thread-local capture mode, while request threads only queue and wait
(they touch no CUDA state). An exception inside a dispatch ends the
engine loop: every waiter wakes, ``completions`` raises
``RuntimeError("llm engine loop died")`` and ``check_health`` raises.

LoRA, two modes, as in the reference: batched multi-LoRA on a paged
engine with ``max_adapters > 0`` (a request naming ``"lora": "<id>"``
or ``model="<model_id>:<id>"`` resolves the adapter's latest version in
the registry at admission and rides a slot-table row of the shared
engine), else merged engines over ``lora_dir`` (``<id>.npz`` merged into
a weight copy, one engine per resident adapter, LRU up to
``max_loras``). With the spill tier on, the loop re-warms the hottest
spilled chain every 0.25 s; ``export_prefix`` serves another engine's
prefix import.

``build_llm_deployment`` wraps an ``LLMConfig`` as a Serve deployment
(``llm/openai_api.build_openai_app`` puts the OpenAI router in front of
one per config); ``serve.run(..., local_testing_mode=True)`` runs it in
this process, the only Serve mode the port has.

``params_ref`` is an ``ObjectRef`` of the params (as in the reference:
the server ``get``s it from the runtime's object store, then carries the
tensors onto its device), the params dict itself, or None (seeded random
weights). ``LLMServer`` runs as an actor of the port's runtime: an actor
with ``num_gpus=1`` leases one card.

Off in the port, each until its part is ported: cluster Serve, and the
cluster prefix directory (``set_replica_handle`` is a no-op).
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Optional

import torch

from .engine import EngineConfig, InferenceEngine, SamplingParams
from .paged_engine import PagedEngineConfig, PagedInferenceEngine


@dataclasses.dataclass
class LLMConfig:
    """(reference: llm/_internal/serve/configs/server_models.py LLMConfig)

    ``engine`` may be an EngineConfig (dense slot cache) or a
    PagedEngineConfig (paged-KV continuous batching — the production
    path); the default is paged. ``num_replicas``,
    ``max_ongoing_requests`` and ``tpus_per_replica`` go into the Serve
    deployment's spec (``build_llm_deployment``), as in the reference;
    local testing mode builds one instance and reads none of them. LoRA:
    batched on a paged engine with ``max_adapters > 0`` (registry
    namespace ``lora_namespace``, default the model_id), else merged
    engines over ``lora_dir``, at most ``max_loras`` resident (the module
    docstring)."""
    model_id: str = "llama-tiny"
    engine: Optional[EngineConfig | PagedEngineConfig] = None
    num_replicas: int = 1
    max_ongoing_requests: int = 64
    tpus_per_replica: float = 0.0
    lora_dir: Optional[str] = None
    max_loras: int = 2
    # registry namespace for batched multi-LoRA (None -> model_id)
    lora_namespace: Optional[str] = None
    # build every engine program at init, before the server takes
    # requests: on the card, capture the paged engine's CUDA graphs over
    # its key ladder (warmup_sampled adds the sampled and top-k modes)
    warmup: bool = True
    warmup_sampled: bool = False


def _to_device(tree, device):
    """A params tree (dicts / lists / tuples of tensors) on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


class LLMServer:
    """Deployment callable: background engine thread + request futures
    (reference: llm_server.py:409). ``params_ref`` is an ObjectRef of the
    engine's params, the params dict itself, or None (seeded random
    weights); ``device`` defaults to CUDA and raises when it is absent —
    pass ``device="cpu"`` for the plain versions."""

    def __init__(self, cfg: LLMConfig, params_ref=None, device="cuda"):
        from ..core.usage import record_library_usage
        from ..models import llama
        record_library_usage("llm")
        self.cfg = cfg
        self.device = llama.resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # pin the index: the loop thread makes it current (below)
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.engine_cfg = cfg.engine or PagedEngineConfig(
            model=llama.llama_tiny())
        params = params_ref
        # seconds of the params_ref route: the store's get, then the copy
        # onto self.device (empty for a dict or seeded weights)
        self.load_s: dict = {}
        from ..core.ref import ObjectRef
        if isinstance(params_ref, ObjectRef):
            from ..core.api import get
            t0 = time.perf_counter()
            params = get(params_ref)
            t1 = time.perf_counter()
            params = _to_device(params, self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.load_s = {"get_s": t1 - t0,
                           "to_device_s": time.perf_counter() - t1}
        self.engine = self._build_engine(params)
        self.base_params = self.engine.params
        self.model_id = cfg.model_id
        # adapter id -> engine over merged weights; the OrderedDict is the
        # LRU. _lora_lock guards every mutation and the loop's snapshot:
        # request threads race the engine thread here
        self._lora_engines: "OrderedDict[str, Any]" = OrderedDict()
        self._lora_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._last_rewarm = 0.0   # spill-tier re-warm cadence (loop)
        self._error: Optional[BaseException] = None
        # serializes engine stepping against slot loads, page imports
        # and exports: those write or read the tensors a dispatch uses
        self._steplock = threading.Lock()
        # batched multi-LoRA: the manager resolves adapter ids to
        # resident slot-table rows at admission
        self._multilora = None
        if getattr(self.engine, "lora", None) is not None:
            from .multilora import AdapterRegistry, MultiLoraManager
            self._multilora = MultiLoraManager(
                self.engine,
                AdapterRegistry(cfg.lora_namespace or cfg.model_id))
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _build_engine(self, params):
        if isinstance(self.engine_cfg, PagedEngineConfig):
            eng = PagedInferenceEngine(self.engine_cfg, params,
                                       device=self.device)
            if self.cfg.warmup:
                modes = [(False, False)]
                if self.cfg.warmup_sampled:
                    modes += [(True, False), (True, True)]
                eng.warmup(sample_modes=tuple(modes))
            return eng
        return InferenceEngine(self.engine_cfg, params, device=self.device)

    def _engines(self):
        with self._lora_lock:
            return [self.engine, *self._lora_engines.values()]

    @staticmethod
    def _lora_id(request: dict) -> Optional[str]:
        lora_id = request.get("lora")
        model = request.get("model", "")
        if not lora_id and ":" in model:
            lora_id = model.split(":", 1)[1]
        return lora_id or None

    def _engine_for(self, request: dict):
        """The engine for a request's LoRA id (None -> base): an engine
        over the adapter's merged weights, built on first use."""
        lora_id = self._lora_id(request)
        if not lora_id:
            return self.engine
        with self._lora_lock:
            eng = self._lora_engines.get(lora_id)
            if eng is not None:
                self._lora_engines.move_to_end(lora_id)
                return eng
        if not self.cfg.lora_dir:
            raise ValueError(
                f"request names LoRA {lora_id!r} but this deployment has "
                f"no lora_dir configured")
        from . import lora
        adapter = lora.load_adapter(os.path.join(self.cfg.lora_dir,
                                                 lora_id))
        eng = self._build_engine(lora.merge(self.base_params, adapter))
        with self._lora_lock:
            raced = self._lora_engines.get(lora_id)
            if raced is not None:  # another thread built it concurrently
                return raced
            self._lora_engines[lora_id] = eng
            # evict only IDLE engines: evicting one with in-flight
            # requests would orphan them; if all are busy, exceed the cap
            # for now and retry on the next load
            if len(self._lora_engines) > self.cfg.max_loras:
                for lid in list(self._lora_engines):
                    if lid == lora_id:
                        continue
                    if not self._lora_engines[lid].has_work():
                        del self._lora_engines[lid]
                        if len(self._lora_engines) <= self.cfg.max_loras:
                            break
        return eng

    def _loop(self):
        try:
            if self.device.type == "cuda":
                # a new thread starts on device 0: make the engine's
                # device current, so kernels launch where its tensors live
                torch.cuda.set_device(self.device)
            while not self._stop:
                worked = False
                for eng in self._engines():
                    if eng.has_work():
                        with self._steplock:
                            eng.step()
                        worked = True
                if getattr(self.engine, "spill", None) is not None:
                    now = time.monotonic()
                    if now - self._last_rewarm >= 0.25:
                        # promote the hottest spilled chain into idle
                        # pool headroom, a bounded run per tick, between
                        # steps (under the step lock: it writes pages)
                        self._last_rewarm = now
                        with self._steplock:
                            self.engine.maybe_rewarm(max_pages=32)
                if not worked:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
        except BaseException as e:  # noqa: BLE001 — engine died: fail fast
            self._error = e
            # unblock every waiter; completions() re-raises the error and
            # check_health reports the dead loop
            for eng in self._engines():
                for req in (list(eng._active.values()) + list(eng._pending)
                            + list(getattr(eng, "_prefilling", []))):
                    req.event.set()

    # -- OpenAI-ish surface ------------------------------------------------

    def _submit(self, request: dict):
        prompt = request.get("prompt", "")
        sp = SamplingParams(
            max_tokens=int(request.get("max_tokens", 64)),
            temperature=float(request.get("temperature", 0.0)),
            top_k=int(request.get("top_k", 0)),
            logprobs=int(request.get("logprobs") or 0),
        )
        lora_id = self._lora_id(request)
        if lora_id and self._multilora is not None:
            # batched multi-LoRA: resolve the adapter's latest version at
            # ADMISSION (in-flight requests stay pinned to it), ride a
            # slot-table row of the shared engine, and salt every
            # prefix-cache key with (adapter_id, version). pin=True holds
            # the slot against eviction until submit. Errors stay typed:
            # unknown adapter -> ValueError, all slots live ->
            # RuntimeError("overloaded: ...").
            try:
                slot, _version, salt = self._multilora.resolve(
                    lora_id, self._steplock, pin=True)
            except KeyError as e:
                raise ValueError(
                    f"unknown LoRA adapter {lora_id!r} for model "
                    f"{self.model_id!r}: {e}") from e
            eng = self.engine
            try:
                prompt = (eng.tokenizer.encode(prompt)
                          if isinstance(prompt, str) else list(prompt))
                req = eng.submit(prompt, sp, adapter_slot=slot,
                                 prefix_salt=salt)
            finally:
                self._multilora.unpin(slot)
            self._wake.set()
            return eng, req
        eng = self._engine_for(request)
        prompt = (eng.tokenizer.encode(prompt)
                  if isinstance(prompt, str) else list(prompt))
        if sp.logprobs and not isinstance(eng, PagedInferenceEngine):
            # dense InferenceEngine never fills out_logps: refuse loudly
            # instead of returning a well-formed response missing the
            # requested field (paged engine is the production path)
            raise ValueError(
                "logprobs requires the paged engine "
                "(LLMConfig(engine=PagedEngineConfig(...)))")
        # submit UNDER the lora lock: eviction (also under it) removes
        # only idle engines, so once submit lands the engine has work and
        # stays; re-insert if an eviction won the race since selection
        with self._lora_lock:
            if eng is not self.engine and \
                    eng not in self._lora_engines.values():
                self._lora_engines[lora_id] = eng
            req = eng.submit(prompt, sp)
        self._wake.set()
        return eng, req

    def completions(self, request: dict) -> dict:
        """{"prompt": str, "max_tokens": int, "temperature": float, ...}
        -> completions response."""
        eng, req = self._submit(request)
        while not req.event.wait(timeout=1.0):
            if self._error is not None:
                raise RuntimeError("llm engine loop died") from self._error
        if self._error is not None and not req.done:
            raise RuntimeError("llm engine loop died") from self._error
        out = eng._result(req)
        text = out["text"]
        if request.get("echo"):
            # OpenAI echo: the completion text is prompt + generation
            prompt = request.get("prompt", "")
            text = (prompt if isinstance(prompt, str)
                    else eng.tokenizer.decode(list(prompt))) + text
        choice = {
            "text": text,
            "finish_reason": out["finish_reason"],
            "index": 0,
        }
        if out.get("logprobs") is not None:
            # chosen-token logprobs (top-N alternatives not reported)
            choice["logprobs"] = {
                "tokens": [eng.tokenizer.decode([t])
                           for t in out["token_ids"]],
                "token_logprobs": out["logprobs"],
                "top_logprobs": None,
            }
        return {
            "object": "text_completion",
            "model": self.model_id,
            "choices": [choice],
            "usage": {
                "prompt_tokens": out["prompt_tokens"],
                "completion_tokens": len(out["token_ids"]),
            },
        }

    def completions_stream(self, request: dict):
        """Generator of token-delta dicts while the engine decodes
        (reference: the streaming response path of llm_server.py)."""
        eng, req = self._submit(request)
        sent = 0
        last_text = ""
        while True:
            if self._error is not None and not req.done:
                raise RuntimeError("llm engine loop died") from self._error
            n = len(req.out_ids)
            if n > sent:
                text = eng.tokenizer.decode(list(req.out_ids))
                delta, last_text = text[len(last_text):], text
                sent = n
                if delta:
                    yield {"object": "text_completion.chunk",
                           "model": self.model_id,
                           "choices": [{"text": delta, "index": 0,
                                        "finish_reason": None}]}
            if req.done:
                break
            req.event.wait(timeout=0.02)
        out = eng._result(req)
        tail = out["text"][len(last_text):]
        yield {"object": "text_completion.chunk", "model": self.model_id,
               "choices": [{"text": tail, "index": 0,
                            "finish_reason": out["finish_reason"]}]}

    def set_replica_handle(self, handle) -> None:
        """The reference's hook for the cluster prefix directory: a no-op
        until the directory is ported."""

    def export_prefix(self, hashes):
        """Serve another engine's prefix import: gather the cached KV
        pages for ``hashes`` (a chain run) to host arrays. None when
        nothing is cached any more (the caller prefills cold)."""
        if not getattr(self.engine, "_prefix_on", False):
            return None
        with self._steplock:
            return self.engine.export_prefix(list(hashes))

    def engine_stats(self) -> dict:
        """Counter snapshot for ops introspection: the engine's stats
        dict plus the mesh axis sizes (None: single card, the port has no
        mesh serving yet)."""
        st = dict(getattr(self.engine, "stats", {}) or {})
        st["mesh"] = None
        return st

    def loaded_loras(self) -> list:
        """Resident adapters: merged-engine ids plus the slot table's
        (adapter_id, version) pairs."""
        out = list(self._lora_engines)
        if self._multilora is not None:
            out.extend(f"{aid}@{v}" for aid, v in
                       self._multilora.resident().values())
        return out

    def __call__(self, request: dict) -> dict:
        return self.completions(request or {})

    def check_health(self):
        if self._error is not None or not self._thread.is_alive():
            raise RuntimeError("engine loop died") from self._error


def build_llm_deployment(cfg: LLMConfig, params_ref=None, device="cuda"):
    """LLMConfig -> a Serve Application over one ``LLMServer``
    (reference: build_openai_app / LLMDeployment, llm_server.py:704).
    ``params_ref`` is an ObjectRef of the params, the params dict, or
    None (seeded random weights);
    ``device`` reaches ``LLMServer`` (``"cpu"`` for the plain versions).
    The spec keeps the reference's name, replica count, request cap and
    accelerator request, which only cluster Serve reads."""
    from .. import serve
    dep = serve.deployment(
        LLMServer,
        name=f"llm:{cfg.model_id}",
        num_replicas=cfg.num_replicas,
        max_ongoing_requests=cfg.max_ongoing_requests,
        ray_actor_options=(
            {"num_tpus": cfg.tpus_per_replica}
            if cfg.tpus_per_replica else {}),
    )
    return dep.bind(cfg, params_ref, device=device)
