"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's serving engines,
batch inference and Llama training step.

A second package beside ``ray_tpu``: the same Llama paged-KV serving
engine, dense-slot engine (behind ``LLMPredictor``), OpenAI app under
Serve's local testing mode and training forward/backward, for dense
and mixture-of-experts configs, written in PyTorch for one NVIDIA H100,
with every Pallas attention kernel of the TPU package replaced by a
hand-written CUDA kernel for Hopper (``ops/csrc``). The package imports
nothing of ``ray_tpu`` and never imports JAX; importing this top-level
module loads nothing heavy.

    from ray_tpu_torch.llm import (PagedEngineConfig,
                                   PagedInferenceEngine, SamplingParams)
    from ray_tpu_torch.models import llama

    eng = PagedInferenceEngine(PagedEngineConfig(model=llama.llama3_8b()))
    out = eng.generate(["hello"], SamplingParams(max_tokens=16))

Entry points run on the card (``device="cuda"``) and raise when CUDA is
absent; pass ``device="cpu"`` for the plain-PyTorch versions the tests
run.
"""

__version__ = "0.1.0"
