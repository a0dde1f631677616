"""ray_tpu_torch.llm — the serving engines, the in-process server and
batch inference in PyTorch.

Counterpart of ``ray_tpu.llm``: the paged-KV production path
(``PagedInferenceEngine``), the dense-slot ``InferenceEngine``,
``LLMPredictor`` (batch inference over the dense engine, ``batch.py``),
and the serving surface — ``LLMServer`` (a background engine loop behind
OpenAI-shaped ``completions``, ``serving.py``, and its Serve deployment
``build_llm_deployment``), ``OpenAIRouter``, ``build_openai_app`` and
``apply_chat_template`` (``openai_api.py``), with the ``rtpu_llm_*``
telemetry (``telemetry.py``):

    from ray_tpu_torch.llm import (LLMConfig, LLMServer,
                                   PagedEngineConfig, SamplingParams)
    from ray_tpu_torch.models import llama

    srv = LLMServer(LLMConfig(engine=PagedEngineConfig(
        model=llama.llama3_8b())))
    out = srv.completions({"prompt": "hello", "max_tokens": 16})

    router = serve.run(build_openai_app([LLMConfig(model_id="m1")]),
                       local_testing_mode=True)       # ray_tpu_torch.serve

    pred = LLMPredictor(EngineConfig(llama.llama3_8b()))
    rows = pred({"prompt": ["hello", "world"]})

The paged engine also serves many LoRA tenants from one slot table
(``multilora/``, adapters in ``lora.py``), spills evicted prefix pages
to a host tier (``tiering.py``) and exports and imports KV payloads
(PD and cross-engine prefixes). ``build_openai_app`` and
``build_llm_deployment`` also run under cluster Serve
(``serve.run(app, http_port=...)`` over the port's runtime), and
``pd_disagg.py`` serves prefill and decode from separate replica
groups (``build_pd_openai_app``, ``build_pd_proxy``; imported from the
module, as the reference exports no PD names here). The paged engine
serves tensor-parallel over a tp mesh (``PagedEngineConfig.mesh``,
``ray_tpu_torch.parallel``). The Dataset stages of batch inference are
not ported yet.
"""
from .batch import LLMPredictor
from .engine import EngineConfig, InferenceEngine, SamplingParams
from .openai_api import OpenAIRouter, apply_chat_template, build_openai_app
from .paged_engine import PagedEngineConfig, PagedInferenceEngine
from .serving import LLMConfig, LLMServer, build_llm_deployment
from .tokenizer import ByteTokenizer, get_tokenizer

__all__ = ["EngineConfig", "InferenceEngine", "LLMPredictor",
           "SamplingParams", "PagedEngineConfig", "PagedInferenceEngine",
           "LLMConfig", "LLMServer", "build_llm_deployment", "OpenAIRouter",
           "build_openai_app", "apply_chat_template",
           "ByteTokenizer", "get_tokenizer"]
