"""The port's dense-slot InferenceEngine and LLMPredictor against ray_tpu's.

Greedy generation must be token-identical to the reference engine (same
converted weights, same prompts), with equal dispatch and token counts,
including continuous batching over more requests than slots and prompts
that reach the cache's end. Sampled generation cannot reproduce
jax.random's stream, so it is held to its own contract: deterministic
per seed, greedy rows untouched by the seed, top-k honoured."""
import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm import EngineConfig as JaxEngineConfig
from ray_tpu.llm import InferenceEngine as JaxEngine
from ray_tpu.llm import SamplingParams as JaxSamplingParams
from ray_tpu.llm.batch import _engine_batch as jax_engine_batch
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import (EngineConfig, InferenceEngine, LLMPredictor,
                               SamplingParams)
from ray_tpu_torch.llm.batch import (ProcessorConfig, _EngineActor,
                                     _default_engine_cfg, _engine_batch,
                                     _get_engine)
from ray_tpu_torch.llm.engine import fold_in, root_key, sample_logits
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy

SHAPE = dict(vocab_size=258, max_seq_len=128)
BUCKETS = (8, 16, 32)


def _pair(**kw):
    """(reference engine, port engine) with the port on the reference's
    weights."""
    jax_eng = JaxEngine(JaxEngineConfig(model=jllama.llama_tiny(**SHAPE),
                                        prefill_buckets=BUCKETS, **kw),
                        rng_seed=0)
    cfg_t = tllama.llama_tiny(**SHAPE)
    params = params_from_numpy(jax.tree.map(np.asarray, jax_eng.params),
                               cfg_t, device="cpu")
    port = InferenceEngine(EngineConfig(model=cfg_t, prefill_buckets=BUCKETS,
                                        **kw), params=params, device="cpu")
    return jax_eng, port


def _prompts(lens, seed=11):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, 250, (n,))] for n in lens]


CASES = {
    # 2 slots for 5 requests: continuous batching and slot recycling, a
    # prompt in every bucket and one past the largest (max_seq_len pads)
    "more_requests_than_slots": (
        dict(max_batch_size=2, max_seq_len=48), (5, 20, 3, 40, 9), 10),
    # prompts truncated to max_seq_len - 2 and max_tokens clamped to the
    # room left: slots reach the cache's last position (length
    # max_seq_len - 1) and, once finished, keep writing there on every
    # later decode step; no write leaves the cache
    "max_seq_len_clamp": (
        dict(max_batch_size=3, max_seq_len=24), (30, 21, 5, 23), 12),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_generate_token_identical(case):
    kw, lens, max_tokens = CASES[case]
    jax_eng, port = _pair(**kw)
    prompts = _prompts(lens)
    a = jax_eng.generate(prompts, JaxSamplingParams(max_tokens=max_tokens))
    b = port.generate(prompts, SamplingParams(max_tokens=max_tokens))
    assert [x["token_ids"] for x in b] == [x["token_ids"] for x in a]
    assert [x["prompt_tokens"] for x in b] == [x["prompt_tokens"] for x in a]
    assert port.stats == jax_eng.stats
    limit = kw["max_seq_len"]
    assert int(port.cache["lengths"].max()) <= limit - 1
    np.testing.assert_array_equal(port._lengths,
                                  port.cache["lengths"].numpy())
    np.testing.assert_array_equal(port.cache["lengths"].numpy(),
                                  np.asarray(jax_eng.cache["lengths"]))
    # a second wave over the recycled slots still agrees
    a2 = jax_eng.generate(prompts[:2], JaxSamplingParams(max_tokens=4))
    b2 = port.generate(prompts[:2], SamplingParams(max_tokens=4))
    assert [x["token_ids"] for x in b2] == [x["token_ids"] for x in a2]
    assert port.stats == jax_eng.stats
    assert not port.has_work()


def _sampling_engine(seed):
    """Engines that differ only in their sampling seed (same weights)."""
    model = tllama.llama_tiny(**SHAPE)
    cfg = EngineConfig(model=model, max_batch_size=3, max_seq_len=64,
                       prefill_buckets=BUCKETS)
    return InferenceEngine(cfg, tllama.init(model, 0, device="cpu"),
                           rng_seed=seed, device="cpu")


def test_sampled_generation_deterministic_per_seed():
    prompts = [[5, 6, 7, 8, 9], [100, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10],
               [42] * 20]
    sp = [SamplingParams(max_tokens=10, temperature=1.0, top_k=20),
          SamplingParams(max_tokens=10, temperature=0.7),
          SamplingParams(max_tokens=10)]
    run = lambda seed: [r["token_ids"] for r in                # noqa: E731
                        _sampling_engine(seed).generate(prompts, sp)]
    first, again, other = run(1), run(1), run(2)
    assert first == again
    assert first != other
    assert first[2] == other[2]          # the greedy row ignores the seed
    greedy = _sampling_engine(1).generate(prompts[:1],
                                          SamplingParams(max_tokens=10))
    top1 = _sampling_engine(3).generate(
        prompts[:1], SamplingParams(max_tokens=10, temperature=2.0, top_k=1))
    assert top1[0]["token_ids"] == greedy[0]["token_ids"]


def test_sample_logits_top_k_and_greedy():
    logits = torch.randn(4, 30, generator=torch.Generator().manual_seed(0))
    assert torch.equal(sample_logits(logits, None, 0.0, 5),
                       torch.argmax(logits, -1))
    top3 = torch.topk(logits, 3).indices
    base = root_key(1, "cpu")
    seen = set()
    for i in range(200):
        tok = sample_logits(logits, fold_in(base, i), 1.5, 3)
        assert all(int(t) in top3[r].tolist() for r, t in enumerate(tok))
        seen.add(int(tok[0]))
    assert len(seen) > 1


def test_llm_predictor_columns_match_reference_batch():
    """LLMPredictor on the reference's weights returns the columns the
    reference's _engine_batch returns for the same rows (string prompts
    through the byte tokenizer), and equals the port's _engine_batch over
    an engine on the same weights."""
    jax_eng, port = _pair(max_batch_size=2, max_seq_len=64)
    batch = {"prompt": ["hello world", "a", "the quick brown fox"],
             "id": [7, 8, 9]}
    want = jax_engine_batch(jax_eng, JaxSamplingParams(max_tokens=6),
                            "prompt", "generated_text", batch)
    pred = LLMPredictor(EngineConfig(model=tllama.llama_tiny(**SHAPE),
                                     max_batch_size=2, max_seq_len=64,
                                     prefill_buckets=BUCKETS),
                        SamplingParams(max_tokens=6), device="cpu")
    pred.engine.params = port.params
    got = pred(batch)
    assert got == want
    assert _engine_batch(port, SamplingParams(max_tokens=6), "prompt",
                         "generated_text", batch) == want
    assert set(got) == {"prompt", "id", "generated_text", "generated_ids",
                        "num_generated_tokens"}
    assert _EngineActor is LLMPredictor


def test_processor_config_defaults_and_unported_stage():
    cfg = _default_engine_cfg(ProcessorConfig(batch_size=4))
    assert cfg.max_batch_size == 4 and cfg.model == tllama.llama_tiny()
    # one engine per (config, device) in the process
    eng = _get_engine(cfg, device="cpu")
    assert _get_engine(cfg, device="cpu") is eng
    assert eng.device.type == "cpu" and eng.cfg is cfg
    # the engine actor pool size belongs to the Dataset stages, which are
    # not ported: the port's config has no such option
    with pytest.raises(TypeError, match="concurrency"):
        ProcessorConfig(concurrency=(1, 2))
