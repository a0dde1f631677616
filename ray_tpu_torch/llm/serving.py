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

Off in the port, each until its part is ported: the Serve deployment
(``build_llm_deployment``), usage recording and the object store
(``params_ref`` is the params dict itself, or None), the cluster prefix
directory, batched and merged multi-LoRA (a request naming a LoRA raises),
the spill tier's re-warm, and cross-replica prefix export
(``export_prefix``, ``set_replica_handle``).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import torch

from .engine import EngineConfig, InferenceEngine, SamplingParams
from .paged_engine import PagedEngineConfig, PagedInferenceEngine


@dataclasses.dataclass
class LLMConfig:
    """(reference: llm/_internal/serve/configs/server_models.py LLMConfig)

    ``engine`` may be an EngineConfig (dense slot cache) or a
    PagedEngineConfig (paged-KV continuous batching — the production
    path); the default is paged. ``tpus_per_replica`` is kept for the
    reference's surface and does nothing until the Serve deployment is
    ported. LoRA serving is not ported: a request naming a LoRA raises
    ``ValueError`` without ``lora_dir`` and ``NotImplementedError`` with
    it. The reference's ``num_replicas`` and ``max_ongoing_requests``
    (read by the Serve deployment) and ``max_loras`` and
    ``lora_namespace`` (read by LoRA serving) are left out until what
    reads them is ported."""
    model_id: str = "llama-tiny"
    engine: Optional[EngineConfig | PagedEngineConfig] = None
    tpus_per_replica: float = 0.0
    lora_dir: Optional[str] = None
    # build every engine program at init, before the server takes
    # requests: on the card, capture the paged engine's CUDA graphs over
    # its key ladder (warmup_sampled adds the sampled and top-k modes)
    warmup: bool = True
    warmup_sampled: bool = False


class LLMServer:
    """Deployment callable: background engine thread + request futures
    (reference: llm_server.py:409). ``params_ref`` is the engine's params
    dict (None: seeded random weights); ``device`` defaults to CUDA and
    raises when it is absent — pass ``device="cpu"`` for the plain
    versions."""

    def __init__(self, cfg: LLMConfig, params_ref=None, device="cuda"):
        from ..models import llama
        self.cfg = cfg
        self.device = llama.resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # pin the index: the loop thread makes it current (below)
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.engine_cfg = cfg.engine or PagedEngineConfig(
            model=llama.llama_tiny())
        self.engine = self._build_engine(params_ref)
        self.model_id = cfg.model_id
        self._wake = threading.Event()
        self._stop = False
        self._error: Optional[BaseException] = None
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

    def _loop(self):
        try:
            if self.device.type == "cuda":
                # a new thread starts on device 0: make the engine's
                # device current, so kernels launch where its tensors live
                torch.cuda.set_device(self.device)
            while not self._stop:
                worked = False
                if self.engine.has_work():
                    self.engine.step()
                    worked = True
                if not worked:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
        except BaseException as e:  # noqa: BLE001 — engine died: fail fast
            self._error = e
            # unblock every waiter; completions() re-raises the error and
            # check_health reports the dead loop
            eng = self.engine
            for req in (list(eng._active.values()) + list(eng._pending)
                        + list(getattr(eng, "_prefilling", []))):
                req.event.set()

    # -- OpenAI-ish surface ------------------------------------------------

    @staticmethod
    def _lora_id(request: dict) -> Optional[str]:
        lora_id = request.get("lora")
        model = request.get("model", "")
        if not lora_id and ":" in model:
            lora_id = model.split(":", 1)[1]
        return lora_id or None

    def _submit(self, request: dict):
        prompt = request.get("prompt", "")
        sp = SamplingParams(
            max_tokens=int(request.get("max_tokens", 64)),
            temperature=float(request.get("temperature", 0.0)),
            top_k=int(request.get("top_k", 0)),
            logprobs=int(request.get("logprobs") or 0),
        )
        lora_id = self._lora_id(request)
        if lora_id:
            if not self.cfg.lora_dir:
                raise ValueError(
                    f"request names LoRA {lora_id!r} but this deployment "
                    f"has no lora_dir configured")
            raise NotImplementedError(
                "LoRA serving is not ported to ray_tpu_torch yet")
        eng = self.engine
        prompt = (eng.tokenizer.encode(prompt)
                  if isinstance(prompt, str) else list(prompt))
        if sp.logprobs and not isinstance(eng, PagedInferenceEngine):
            # dense InferenceEngine never fills out_logps: refuse loudly
            # instead of returning a well-formed response missing the
            # requested field (paged engine is the production path)
            raise ValueError(
                "logprobs requires the paged engine "
                "(LLMConfig(engine=PagedEngineConfig(...)))")
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
        """Cross-replica prefix export is not ported yet."""
        raise NotImplementedError(
            "export_prefix (cross-replica prefix sharing) is not ported "
            "to ray_tpu_torch yet")

    def engine_stats(self) -> dict:
        """Counter snapshot for ops introspection: the engine's stats
        dict plus the mesh axis sizes (None: single card, the port has no
        mesh serving yet)."""
        st = dict(getattr(self.engine, "stats", {}) or {})
        st["mesh"] = None
        return st

    def loaded_loras(self) -> list:
        """Resident adapters: none until LoRA serving is ported."""
        return []

    def __call__(self, request: dict) -> dict:
        return self.completions(request or {})

    def check_health(self):
        if self._error is not None or not self._thread.is_alive():
            raise RuntimeError("engine loop died") from self._error
