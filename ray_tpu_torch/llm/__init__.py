"""ray_tpu_torch.llm — the serving engines and batch inference in PyTorch.

Counterpart of ``ray_tpu.llm``'s engines: the paged-KV production path
(``PagedInferenceEngine``), the dense-slot ``InferenceEngine``, and
``LLMPredictor`` (batch inference over the dense engine, ``batch.py``):

    from ray_tpu_torch.llm import (PagedEngineConfig,
                                   PagedInferenceEngine, SamplingParams)
    from ray_tpu_torch.models import llama

    eng = PagedInferenceEngine(PagedEngineConfig(model=llama.llama3_8b()))
    out = eng.generate(["hello"], SamplingParams(max_tokens=16))

    pred = LLMPredictor(EngineConfig(llama.llama3_8b()))
    rows = pred({"prompt": ["hello", "world"]})

The Serve/OpenAI surface, the Dataset stages of batch inference and the
multi-LoRA, spill-tier, mesh and PD-disaggregation features are not
ported yet.
"""
from .batch import LLMPredictor
from .engine import EngineConfig, InferenceEngine, SamplingParams
from .paged_engine import PagedEngineConfig, PagedInferenceEngine
from .tokenizer import ByteTokenizer, get_tokenizer

__all__ = ["EngineConfig", "InferenceEngine", "LLMPredictor",
           "SamplingParams", "PagedEngineConfig", "PagedInferenceEngine",
           "ByteTokenizer", "get_tokenizer"]
