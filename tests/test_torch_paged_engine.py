"""The port's PagedInferenceEngine against ray_tpu's, on the same weights.

Greedy generation must be token-identical to the reference engine (same
converted weights, same prompts), and the host-side bookkeeping —
dispatch counts per family, prefix-cache hits/misses/evictions,
speculative accept counts — must agree exactly. Sampled generation
cannot reproduce jax.random's stream, so it is held to its own
contract: deterministic per seed, top-k honoured. Logprobs: float32,
atol 1e-4 (both take log_softmax of f32 logits that agree to ~1e-5)."""
import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm import PagedEngineConfig as JaxConfig
from ray_tpu.llm import PagedInferenceEngine as JaxEngine
from ray_tpu.llm import SamplingParams as JaxSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import (PagedEngineConfig, PagedInferenceEngine,
                               SamplingParams)
from ray_tpu_torch.llm.engine import fold_in, root_key, sample_logits_batch
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy

SHAPE = dict(vocab_size=258, max_seq_len=512)
STAT_KEYS = ("prefill_dispatches", "decode_dispatches", "spec_dispatches",
             "spec_proposed", "spec_accepted", "tokens_out", "prefix_hits",
             "prefix_misses", "prefix_evictions", "prefix_tokens_saved")


def _pair(**kw):
    """(reference engine, port engine) with the port on the reference's
    weights."""
    jax_eng = JaxEngine(JaxConfig(model=jllama.llama_tiny(**SHAPE), **kw),
                        rng_seed=0)
    cfg_t = tllama.llama_tiny(**SHAPE)
    params = params_from_numpy(jax.tree.map(np.asarray, jax_eng.params),
                               cfg_t, device="cpu")
    port = PagedInferenceEngine(PagedEngineConfig(model=cfg_t, **kw),
                                params=params, device="cpu")
    return jax_eng, port


def _prompts():
    rng = np.random.RandomState(11)
    shared = list(rng.randint(1, 250, (40,)))
    return [list(rng.randint(1, 250, (5,))),
            list(rng.randint(1, 250, (70,))),        # 5 chunks of 16
            shared + list(rng.randint(1, 250, (9,))),
            list(rng.randint(1, 250, (21,))),
            shared + list(rng.randint(1, 250, (12,)))]  # shared prefix


CASES = {
    # 2 slots for 5 requests and a 24-page pool: continuous batching,
    # page recycling, LRU evictions, chunked prefill of the long prompt
    "batching_small_pool": dict(
        max_batch_size=2, page_size=8, num_pages=24, max_pages_per_seq=16,
        chunk_size=16, prefill_rows=2, decode_window=4),
    # power-of-two block-table buckets over a 40-page table
    "page_buckets_on": dict(
        max_batch_size=3, page_size=8, num_pages=128, max_pages_per_seq=40,
        chunk_size=16, prefill_rows=4, decode_window=3, page_buckets="on"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_generate_token_identical(case):
    kw = CASES[case]
    jax_eng, port = _pair(**kw)
    prompts = _prompts()
    a = jax_eng.generate(prompts, JaxSamplingParams(max_tokens=6))
    b = port.generate(prompts, SamplingParams(max_tokens=6))
    assert [x["token_ids"] for x in b] == [x["token_ids"] for x in a]
    assert {k: port.stats[k] for k in STAT_KEYS} == \
        {k: jax_eng.stats[k] for k in STAT_KEYS}
    assert port.stats["prefix_hits"] > 0
    if case == "batching_small_pool":
        assert port.stats["prefix_evictions"] > 0
    # a second wave over the warm cache still agrees
    a2 = jax_eng.generate(prompts[2:], JaxSamplingParams(max_tokens=3))
    b2 = port.generate(prompts[2:], SamplingParams(max_tokens=3))
    assert [x["token_ids"] for x in b2] == [x["token_ids"] for x in a2]
    assert {k: port.stats[k] for k in STAT_KEYS} == \
        {k: jax_eng.stats[k] for k in STAT_KEYS}
    assert port.pool_stats()["cached_pages"] == \
        jax_eng.pool_stats()["cached_pages"]


def test_speculative_verify_and_logprobs_match_reference():
    """A self-similar greedy prompt drives the speculative path (drafts
    from prompt lookup, verify dispatches, accept counts) in both
    engines; tokens are identical and chosen-token logprobs agree."""
    kw = dict(max_batch_size=2, page_size=8, num_pages=96,
              max_pages_per_seq=24, chunk_size=16, decode_window=4,
              spec_tokens=8, page_buckets="on")
    jax_eng, port = _pair(**kw)
    prompt = [7, 8, 9] * 5
    a = jax_eng.generate([prompt], JaxSamplingParams(max_tokens=48,
                                                     logprobs=1))[0]
    b = port.generate([prompt], SamplingParams(max_tokens=48,
                                               logprobs=1))[0]
    assert b["token_ids"] == a["token_ids"]
    np.testing.assert_allclose(b["logprobs"], a["logprobs"], atol=1e-4)
    assert port.stats["spec_dispatches"] > 0
    assert {k: port.stats[k] for k in STAT_KEYS} == \
        {k: jax_eng.stats[k] for k in STAT_KEYS}


def test_hash_prompt_chains_byte_equal():
    jax_eng, port = _pair(page_size=8, chunk_size=16, num_pages=32,
                          max_pages_per_seq=16)
    rng = np.random.RandomState(4)
    for n in (3, 17, 33, 100):
        ids = list(rng.randint(0, 258, (n,)))
        for salt in (b"", b"tenant-a:v3"):
            assert port.hash_prompt(ids, salt) == \
                jax_eng.hash_prompt(ids, salt)
    text = "the quick brown fox jumps over the lazy dog " * 3
    assert port.hash_prompt(text) == jax_eng.hash_prompt(text)
    assert len(port.hash_prompt(text)) > 0


def _sampling_engine(seed):
    """Engines that differ only in their sampling seed (same weights)."""
    model = tllama.llama_tiny(**SHAPE)
    cfg = PagedEngineConfig(model=model, max_batch_size=3, page_size=8,
                            num_pages=64, max_pages_per_seq=16,
                            chunk_size=16, decode_window=4)
    return PagedInferenceEngine(cfg, tllama.init(model, 0, device="cpu"),
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
    # the greedy row is unaffected by the seed
    assert first[2] == other[2]
    # top_k=1 sampling is greedy whatever the temperature
    greedy = _sampling_engine(1).generate(prompts[:1],
                                          SamplingParams(max_tokens=10))
    top1 = _sampling_engine(3).generate(
        prompts[:1], SamplingParams(max_tokens=10, temperature=2.0, top_k=1))
    assert top1[0]["token_ids"] == greedy[0]["token_ids"]


def test_sample_logits_batch_honours_top_k_and_softmax():
    """Per-row params in one batch: greedy, top-k=3 and plain temperature
    rows. Sampled tokens stay inside each row's top-k; the temperature
    row's frequencies follow its softmax (4000 draws, 5 sigma)."""
    v = 12
    logits = torch.randn(3, v, generator=torch.Generator().manual_seed(5)) * 2
    temps = torch.tensor([0.0, 1.0, 1.0])
    top_ks = torch.tensor([0, 3, 0], dtype=torch.int32)
    top3 = set(torch.topk(logits[1], 3).indices.tolist())
    counts = np.zeros(v)
    base = root_key(0, "cpu")
    for i in range(4000):
        tok, lp = sample_logits_batch(logits, fold_in(base, i), temps,
                                      top_ks)
        assert tok.dtype == torch.int32
        assert int(tok[0]) == int(torch.argmax(logits[0]))
        assert int(tok[1]) in top3
        counts[int(tok[2])] += 1
        want = torch.log_softmax(logits, -1).gather(1, tok[:, None].long())
        assert torch.allclose(lp, want[:, 0])
    p = torch.softmax(logits[2], -1).numpy()
    sigma = np.sqrt(4000 * p * (1 - p))
    assert np.all(np.abs(counts - 4000 * p) <= 5 * sigma + 1)


@pytest.mark.parametrize("field,value", [
    ("mesh", {"tp": 2}), ("max_adapters", 4), ("kv_spill", True),
    ("lora_rank", 16), ("kv_spill_max_bytes", 1 << 20)])
def test_unported_features_raise(field, value):
    """Every engine feature is ported now: the tp mesh, the multi-LoRA
    and the spill-tier fields are accepted and build an engine (the
    mesh's unported axes raise in tests/test_torch_mesh_engine.py)."""
    cfg = PagedEngineConfig(model=tllama.llama_tiny(), **{field: value})
    eng = PagedInferenceEngine(cfg, tllama.init(cfg.model, 0, device="cpu"),
                               device="cpu")
    if field == "mesh":
        assert dict(eng.mesh.shape)["tp"] == 2
    # the defaults themselves are accepted
    PagedEngineConfig(model=tllama.llama_tiny())
