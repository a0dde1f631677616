"""Batch inference over the dense-slot engine (counterpart of the engine
half of ``ray_tpu/llm/batch.py``): ``ProcessorConfig``, the per-process
engine cache, the batch -> result shaping, and ``LLMPredictor``, the
stateful callable a ``map_batches`` pool builds once per worker.

    from ray_tpu_torch.llm import EngineConfig, LLMPredictor
    from ray_tpu_torch.models import llama

    pred = LLMPredictor(EngineConfig(llama.llama3_8b()))   # on the card
    out = pred({"prompt": ["hello", "world"]})
    out["generated_text"], out["generated_ids"], out["num_generated_tokens"]

Not ported yet: the Dataset stages (``ChatTemplateStage``,
``TokenizeStage``, ``DetokenizeStage``, ``EngineStage``), ``Processor``
and ``build_llm_processor``, which need the port's data layer, and
``HttpRequestStage``, which needs the network.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .engine import EngineConfig, InferenceEngine, SamplingParams

_ENGINE_CACHE: dict[str, InferenceEngine] = {}


def _get_engine(cfg: EngineConfig, device="cuda") -> InferenceEngine:
    """One engine per (config, device) in this process: model init is
    paid once, not once per batch."""
    key = repr((cfg.model, cfg.max_batch_size, cfg.max_seq_len,
                cfg.prefill_buckets, str(device)))
    if key not in _ENGINE_CACHE:
        _ENGINE_CACHE[key] = InferenceEngine(cfg, device=device)
    return _ENGINE_CACHE[key]


@dataclasses.dataclass
class ProcessorConfig:
    """(reference: processor/base.py:21 + OfflineProcessorConfig:55)"""
    engine: Optional[EngineConfig] = None
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    prompt_column: str = "prompt"
    output_column: str = "generated_text"
    batch_size: int = 8


def _default_engine_cfg(cfg: ProcessorConfig) -> EngineConfig:
    from ..models import llama
    return cfg.engine or EngineConfig(model=llama.llama_tiny(),
                                      max_batch_size=cfg.batch_size)


def _engine_batch(engine, sampling, prompt_column, output_column,
                  batch: dict) -> dict:
    """The batch -> result shaping: the input columns, plus the generated
    text, token ids and token counts per row."""
    prompts = [str(p) for p in batch[prompt_column]]
    outs = engine.generate(prompts, sampling)
    result = dict(batch)
    result[output_column] = [o["text"] for o in outs]
    result["generated_ids"] = [list(o["token_ids"]) for o in outs]
    result["num_generated_tokens"] = [len(o["token_ids"]) for o in outs]
    return result


class LLMPredictor:
    """Stateful pool member for ``map_batches``: builds its engine ONCE
    (model init paid once per worker), then generates per batch
    (reference: vllm_engine_stage.py — one engine per stage actor).
    ``device`` defaults to CUDA and raises when it is absent."""

    def __init__(self, engine_cfg=None, sampling=None,
                 prompt_column: str = "prompt",
                 output_column: str = "generated_text", device="cuda"):
        if engine_cfg is None:
            engine_cfg = _default_engine_cfg(ProcessorConfig())
        self.engine = InferenceEngine(engine_cfg, device=device)
        self.sampling = sampling if sampling is not None \
            else SamplingParams()
        self.pc = prompt_column
        self.oc = output_column

    def __call__(self, batch: dict) -> dict:
        return _engine_batch(self.engine, self.sampling, self.pc,
                             self.oc, batch)


#: the reference's earlier name for LLMPredictor
_EngineActor = LLMPredictor
