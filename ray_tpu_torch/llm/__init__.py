"""ray_tpu_torch.llm — the serving engines, the in-process server and
batch inference in PyTorch.

Counterpart of ``ray_tpu.llm``: the paged-KV production path
(``PagedInferenceEngine``), the dense-slot ``InferenceEngine``,
``LLMPredictor`` (batch inference over the dense engine, ``batch.py``),
and the serving surface — ``LLMServer`` (a background engine loop behind
OpenAI-shaped ``completions``, ``serving.py``), ``OpenAIRouter`` and
``apply_chat_template`` (``openai_api.py``), with the ``rtpu_llm_*``
telemetry (``telemetry.py``):

    from ray_tpu_torch.llm import (LLMConfig, LLMServer,
                                   PagedEngineConfig, SamplingParams)
    from ray_tpu_torch.models import llama

    srv = LLMServer(LLMConfig(engine=PagedEngineConfig(
        model=llama.llama3_8b())))
    out = srv.completions({"prompt": "hello", "max_tokens": 16})

    pred = LLMPredictor(EngineConfig(llama.llama3_8b()))
    rows = pred({"prompt": ["hello", "world"]})

The Serve deployment and HTTP route, the Dataset stages of batch
inference and the multi-LoRA, spill-tier, mesh and PD-disaggregation
features are not ported yet.
"""
from .batch import LLMPredictor
from .engine import EngineConfig, InferenceEngine, SamplingParams
from .openai_api import OpenAIRouter, apply_chat_template
from .paged_engine import PagedEngineConfig, PagedInferenceEngine
from .serving import LLMConfig, LLMServer
from .tokenizer import ByteTokenizer, get_tokenizer

__all__ = ["EngineConfig", "InferenceEngine", "LLMPredictor",
           "SamplingParams", "PagedEngineConfig", "PagedInferenceEngine",
           "LLMConfig", "LLMServer", "OpenAIRouter", "apply_chat_template",
           "ByteTokenizer", "get_tokenizer"]
