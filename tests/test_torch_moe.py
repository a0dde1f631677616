"""Mixture-of-experts in the port's Llama against ray_tpu.models.llama.

The same numpy-seeded inputs (or the reference's own init, converted by
params_from_numpy) go through the reference and the port, f32 on the
CPU:

- ``_moe_ffn`` alone: ample capacity, overflow drops, an all-zero router
  (every probability ties: jax.lax.top_k takes the lower expert index,
  and so must the port) and a router with two equal columns. out atol
  1e-5, aux 1e-6 (f32 sums of the same products in other orders);
- ``apply_with_aux``: logits, aux and every gradient, the router's
  included, of ce + moe_aux_weight * aux against jax.grad, at
  tests/test_torch_llama_train.py's tolerances;
- the paged engine and the dense InferenceEngine on a tiny MoE config:
  the reference engines' greedy tokens, dispatch and prefix counters,
  and logprobs within 1e-4. The capacity counts every row of a call,
  padding included, so these agree only because the port pads rows and
  buckets as the reference does.

A ``cuda`` test (skipped without a card) holds an MoE paged engine's
captured programs to its eager bodies, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import EngineConfig as JaxEngineConfig
from ray_tpu.llm import InferenceEngine as JaxDenseEngine
from ray_tpu.llm import PagedEngineConfig as JaxPagedConfig
from ray_tpu.llm import PagedInferenceEngine as JaxPagedEngine
from ray_tpu.llm import SamplingParams as JaxSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import (EngineConfig, InferenceEngine,
                               PagedEngineConfig, PagedInferenceEngine,
                               SamplingParams)
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy

FFN_TOL = dict(atol=1e-5, rtol=0)
AUX_TOL = dict(atol=1e-6, rtol=0)
TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-6, rtol=1e-4)
MOE = dict(moe_experts=4, moe_top_k=2)
TRAIN_SHAPE = dict(vocab_size=64, n_heads=4, n_kv_heads=2, dim=32,
                   n_layers=2, mlp_dim=64, max_seq_len=128, **MOE)


def _ffn_inputs(router: str, seed: int = 0, b=2, s=8, d=32, f=64, e=4):
    rng = np.random.RandomState(seed)
    w_router = {"random": rng.randn(d, e),
                "zero": np.zeros((d, e)),
                # experts 1 and 2 always tie, at whatever rank they land
                "equal_columns": rng.randn(d, e)[:, [0, 1, 1, 3]]}[router]
    p = {"w_router": w_router.astype(np.float32),
         "w_gate": (rng.randn(e, d, f) * 0.1).astype(np.float32),
         "w_up": (rng.randn(e, d, f) * 0.1).astype(np.float32),
         "w_down": (rng.randn(e, f, d) * 0.1).astype(np.float32)}
    h = rng.randn(b, s, d).astype(np.float32)
    return h, p


@pytest.mark.parametrize("router,capacity,top_k", [
    ("random", 4.0, 2),            # ample: no token dropped
    ("random", 0.5, 2),            # overflow: later choices dropped
    ("random", 1.0, 1),            # top-1
    ("zero", 4.0, 2),              # every probability ties
    ("zero", 0.01, 2),             # ties and C = 1: all but 2 dropped
    ("equal_columns", 2.0, 3),     # a tie at a data-dependent rank
])
def test_moe_ffn_matches_reference(router, capacity, top_k):
    cfg_kw = dict(dim=32, mlp_dim=64, moe_experts=4, moe_top_k=top_k,
                  moe_capacity=capacity)
    h, p = _ffn_inputs(router)
    want, want_aux = jllama._moe_ffn(
        jnp.asarray(h), {k: jnp.asarray(v) for k, v in p.items()},
        jllama.llama_tiny(**cfg_kw))
    got, aux = tllama._moe_ffn(
        torch.from_numpy(h), {k: torch.from_numpy(v) for k, v in p.items()},
        tllama.llama_tiny(**cfg_kw))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, **FFN_TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), **AUX_TOL)
    dropped = np.all(want == 0, axis=-1).sum()
    if router == "zero" and capacity < 1:
        # C = 1: experts 0 and 1 take one token each, the rest get 0
        assert dropped == h.shape[0] * h.shape[1] - 1
        assert np.all(got.numpy().reshape(-1, 32)[1:] == 0)
    elif capacity >= 4:
        assert dropped == 0


def test_moe_ffn_ties_go_to_the_lower_expert():
    """An all-zero router: every token picks experts 0..k-1 with gates
    1/k (the reference's order), so with ample capacity the output is
    the mean of experts 0 and 1 applied to each token."""
    h, p = _ffn_inputs("zero")
    cfg = tllama.llama_tiny(dim=32, mlp_dim=64, moe_capacity=4.0, **MOE)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got, aux = tllama._moe_ffn(torch.from_numpy(h), tp, cfg)
    x = torch.from_numpy(h).reshape(-1, 32)
    want = sum(0.5 * ((torch.nn.functional.silu(x @ tp["w_gate"][e])
                       * (x @ tp["w_up"][e])) @ tp["w_down"][e])
               for e in (0, 1))
    torch.testing.assert_close(got.reshape(-1, 32), want, atol=1e-6,
                               rtol=1e-5)
    assert aux.item() == pytest.approx(1.0)   # E * (1/E) * 1 for expert 0


def test_param_shapes_init_and_convert_keep_the_router_f32():
    cfg_j = jllama.llama_tiny(**TRAIN_SHAPE, dtype=jnp.bfloat16)
    cfg_t = tllama.llama_tiny(**TRAIN_SHAPE, dtype=torch.bfloat16)
    ref = jllama.init(jax.random.PRNGKey(0), cfg_j)
    shapes = tllama.param_shapes(cfg_t)
    assert jax.tree.map(lambda a: tuple(a.shape), ref) == shapes
    mine = tllama.init(cfg_t, seed=1, device="cpu")
    conv = params_from_numpy(jax.tree.map(np.asarray, ref), cfg_t,
                             device="cpu")
    for params in (mine, conv):
        assert params["layers"]["w_router"].dtype == torch.float32
        assert params["layers"]["w_gate"].dtype == torch.bfloat16
        assert {k: tuple(v.shape) for k, v in params["layers"].items()} \
            == shapes["layers"]
    assert torch.equal(conv["layers"]["w_router"], torch.from_numpy(
        np.array(ref["layers"]["w_router"])))
    # N(0, 1/fan_in): the router and experts of the port's own draw
    lay = mine["layers"]
    assert abs(lay["w_router"].std().item() - 32 ** -0.5) < 0.03
    assert abs(lay["w_down"].float().std().item() - 64 ** -0.5) < 0.02
    # a dense config has no router
    dense = tllama.llama_tiny(**{k: v for k, v in TRAIN_SHAPE.items()
                                 if not k.startswith("moe")})
    assert "w_router" not in tllama.init(dense, seed=1,
                                         device="cpu")["layers"]


def test_duplicate_sink_writes_carry_the_last_rows_value():
    """MoE configs: every row of a scatter whose slot a later row also
    writes takes that later row's value (the CPU's last write wins,
    whatever order the card's threads write in); dense configs keep
    their plain scatter."""
    flat = torch.tensor([0, 5, 0, 3, 0, 5], dtype=torch.int32)
    moe = tllama.llama_tiny(**MOE)
    src = tllama._last_writer(flat, moe)
    assert src.tolist() == [4, 5, 4, 3, 4, 5]
    vals = torch.arange(6.0)[:, None].expand(6, 2)
    pool = torch.full((8, 2), -1.0)
    pool[flat.long()] = tllama._rows_from(vals, src)
    assert pool[:, 0].tolist() == [4, -1, -1, 3, -1, 5, -1, -1]
    assert tllama._last_writer(flat, tllama.llama_tiny()) is None


@pytest.fixture(scope="module")
def train_ref():
    cfg = jllama.llama_tiny(**TRAIN_SHAPE)
    params = jllama.init(jax.random.PRNGKey(0), cfg)
    tokens = np.random.RandomState(1).randint(0, 64, (2, 17)).astype(
        np.int32)
    return params, tokens


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("capacity", [2.0, 0.5])
@pytest.mark.parametrize("remat", ["off", "full", "save_attn"])
def test_apply_with_aux_logits_aux_and_gradients_match_reference(
        train_ref, capacity, remat):
    params_j, tokens = train_ref
    cfg_j = jllama.llama_tiny(**TRAIN_SHAPE, moe_capacity=capacity)
    cfg_t = tllama.llama_tiny(**TRAIN_SHAPE, moe_capacity=capacity,
                              remat=remat != "off",
                              remat_policy="full" if remat == "full"
                              else "save_attn")
    inp, tgt = jnp.asarray(tokens[:, :-1]), jnp.asarray(tokens[:, 1:])

    def loss_fn(p):
        logits, aux = jllama.apply_with_aux(p, inp, cfg_j)
        ce = jllama.cross_entropy_loss(logits, tgt)
        return ce + cfg_j.moe_aux_weight * aux, (logits, aux)

    (want_loss, (want_logits, want_aux)), want_grads = \
        jax.value_and_grad(loss_fn, has_aux=True)(params_j)
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    for t in _named(params).values():
        t.requires_grad_()
    tok = torch.from_numpy(tokens)
    logits, aux = tllama.apply_with_aux(params, tok[:, :-1], cfg_t)
    loss = tllama.cross_entropy_loss(logits, tok[:, 1:]) + \
        cfg_t.moe_aux_weight * aux
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), **AUX_TOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    assert aux.item() > 0.5          # E·Σ(mean prob · fraction) near 1
    loss.backward()
    want = _named(jax.tree.map(np.asarray, want_grads))
    got = _named(params)
    assert set(got) == set(want)
    for name, t in got.items():
        np.testing.assert_allclose(t.grad.numpy(), want[name],
                                   err_msg=name, **GRAD_TOL)
    assert got["layers.w_router"].grad.abs().max() > 0
    # apply is apply_with_aux's logits
    torch.testing.assert_close(tllama.apply(params, tok[:, :-1], cfg_t),
                               logits, atol=0, rtol=0)


# -- the engines on a tiny MoE config ---------------------------------------

ENGINE_SHAPE = dict(vocab_size=258, max_seq_len=512, **MOE)
STAT_KEYS = ("prefill_dispatches", "decode_dispatches", "spec_dispatches",
             "spec_proposed", "spec_accepted", "tokens_out", "prefix_hits",
             "prefix_misses", "prefix_evictions", "prefix_tokens_saved")


def _prompts():
    rng = np.random.RandomState(11)
    shared = list(rng.randint(1, 250, (40,)))
    return [list(rng.randint(1, 250, (5,))),
            list(rng.randint(1, 250, (70,))),        # 5 chunks of 16
            shared + list(rng.randint(1, 250, (9,))),
            list(rng.randint(1, 250, (21,))),
            shared + list(rng.randint(1, 250, (12,)))]  # shared prefix


PAGED_CASES = {
    # continuous batching over 2 slots, chunked prefill in rows of 2,
    # the prefix cache and LRU evictions; ample and tight capacity
    "batching_capacity_2": (dict(moe_capacity=2.0), dict(
        max_batch_size=2, page_size=8, num_pages=24, max_pages_per_seq=16,
        chunk_size=16, prefill_rows=2, decode_window=4)),
    "batching_capacity_0.5": (dict(moe_capacity=0.5), dict(
        max_batch_size=3, page_size=8, num_pages=128, max_pages_per_seq=40,
        chunk_size=16, prefill_rows=4, decode_window=3, page_buckets="on")),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_engine_matches_reference(case):
    moe_kw, kw = PAGED_CASES[case]
    jax_eng = JaxPagedEngine(JaxPagedConfig(
        model=jllama.llama_tiny(**ENGINE_SHAPE, **moe_kw), **kw), rng_seed=0)
    cfg_t = tllama.llama_tiny(**ENGINE_SHAPE, **moe_kw)
    params = params_from_numpy(jax.tree.map(np.asarray, jax_eng.params),
                               cfg_t, device="cpu")
    port = PagedInferenceEngine(PagedEngineConfig(model=cfg_t, **kw),
                                params=params, device="cpu")
    prompts = _prompts()
    a = jax_eng.generate(prompts, JaxSamplingParams(max_tokens=6,
                                                    logprobs=1))
    b = port.generate(prompts, SamplingParams(max_tokens=6, logprobs=1))
    assert [x["token_ids"] for x in b] == [x["token_ids"] for x in a]
    for x, y in zip(a, b):
        np.testing.assert_allclose(y["logprobs"], x["logprobs"], atol=1e-4)
    assert {k: port.stats[k] for k in STAT_KEYS} == \
        {k: jax_eng.stats[k] for k in STAT_KEYS}
    assert port.stats["prefix_hits"] > 0


def test_paged_engine_speculative_verify_matches_reference():
    """Verify dispatches (rows of 1 + 8 tokens: T = 9 per call) on an
    MoE config. Random weights seldom repeat themselves, so both engines
    draft the context's last tokens (the same drafts on both sides)."""
    kw = dict(max_batch_size=2, page_size=8, num_pages=96,
              max_pages_per_seq=24, chunk_size=16, decode_window=4,
              spec_tokens=8, page_buckets="on")
    jax_eng = JaxPagedEngine(JaxPagedConfig(
        model=jllama.llama_tiny(**ENGINE_SHAPE), **kw), rng_seed=0)
    cfg_t = tllama.llama_tiny(**ENGINE_SHAPE)
    params = params_from_numpy(jax.tree.map(np.asarray, jax_eng.params),
                               cfg_t, device="cpu")
    port = PagedInferenceEngine(PagedEngineConfig(model=cfg_t, **kw),
                                params=params, device="cpu")
    for eng in (jax_eng, port):
        eng._propose_draft = lambda ctx, n, s: [int(t) for t in ctx[-s:]]
    prompt = [7, 8, 9] * 5
    a = jax_eng.generate([prompt], JaxSamplingParams(max_tokens=32,
                                                     logprobs=1))[0]
    b = port.generate([prompt], SamplingParams(max_tokens=32,
                                               logprobs=1))[0]
    assert b["token_ids"] == a["token_ids"]
    np.testing.assert_allclose(b["logprobs"], a["logprobs"], atol=1e-4)
    assert port.stats["spec_dispatches"] > 0
    assert {k: port.stats[k] for k in STAT_KEYS} == \
        {k: jax_eng.stats[k] for k in STAT_KEYS}


def test_dense_engine_matches_reference():
    """The dense-slot engine: prefill at a bucket (pad tokens share the
    capacity), batched decode over every slot (idle ones included)."""
    kw = dict(max_batch_size=2, max_seq_len=64, prefill_buckets=(8, 16, 32))
    shape = dict(ENGINE_SHAPE, max_seq_len=128)
    jax_eng = JaxDenseEngine(JaxEngineConfig(
        model=jllama.llama_tiny(**shape), **kw), rng_seed=0)
    cfg_t = tllama.llama_tiny(**shape)
    params = params_from_numpy(jax.tree.map(np.asarray, jax_eng.params),
                               cfg_t, device="cpu")
    port = InferenceEngine(EngineConfig(model=cfg_t, **kw), params=params,
                           device="cpu")
    rng = np.random.RandomState(5)
    prompts = [[int(t) for t in rng.randint(1, 250, n)]
               for n in (5, 20, 3, 30, 9)]
    a = jax_eng.generate(prompts, JaxSamplingParams(max_tokens=8))
    b = port.generate(prompts, SamplingParams(max_tokens=8))
    assert [x["token_ids"] for x in b] == [x["token_ids"] for x in a]
    assert port.stats == jax_eng.stats


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the captured programs and the "
                    "ragged kernel run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_moe_captured_programs_equal_eager_bodies(cuda):
    """A bf16 MoE paged engine's CUDA graphs against its eager bodies on
    the same weights and seed: tokens, logprobs, counters, the ragged
    kernel's launches and every page from 1 up, bit for bit, over
    prefill, decode (greedy, sampled, top-k) and verify dispatches. 8
    experts at capacity 1 (C = T/4) drop tokens in every family, so
    idle rows and pad pages take slots from real tokens: what they read
    from the sink page must not depend on a write race."""
    from ray_tpu_torch.ops.ragged_paged_attention import \
        ragged_paged_attention
    mc = tllama.llama_tiny(vocab_size=300, dim=256, n_heads=4, n_kv_heads=2,
                           mlp_dim=512, max_seq_len=512,
                           dtype=torch.bfloat16, moe_experts=8,
                           moe_capacity=1.0)
    params = tllama.init(mc, seed=4, device=cuda)
    cfg = PagedEngineConfig(model=mc, max_batch_size=4, page_size=16,
                            num_pages=96, max_pages_per_seq=32,
                            chunk_size=32, decode_window=4, spec_tokens=4,
                            page_buckets="on")
    engines = [PagedInferenceEngine(cfg, params, rng_seed=3, device=cuda)
               for _ in range(2)]
    engines[0].warmup(sample_modes=((False, False), (True, True)))
    engines[1]._eager = True
    rng = np.random.RandomState(6)
    prompts = [[int(t) for t in rng.randint(0, 300, n)]
               for n in (70, 5, 33, 17)] + [[7, 8, 9] * 6]
    sps = [SamplingParams(max_tokens=14, logprobs=1),
           SamplingParams(max_tokens=14, temperature=0.8),
           SamplingParams(max_tokens=14),
           SamplingParams(max_tokens=14, temperature=1.2, top_k=7),
           SamplingParams(max_tokens=20)]
    runs = []
    for eng in engines:
        eng._propose_draft = lambda ctx, n, s: [int(t) for t in ctx[-s:]]
        before = ragged_paged_attention.launches
        out = eng.generate(prompts, sps)
        torch.cuda.synchronize()
        runs.append((out, ragged_paged_attention.launches - before))
    (a, la), (b, lb) = runs
    assert [x["token_ids"] for x in a] == [x["token_ids"] for x in b]
    assert [x["logprobs"] for x in a] == [x["logprobs"] for x in b]
    assert engines[0].stats == engines[1].stats
    assert la == lb > 0
    assert engines[0].stats["spec_dispatches"] > 0
    assert len(engines[0]._graphs) > 0
    for ca, ea in zip(engines[0].caches, engines[1].caches):
        assert torch.equal(ca["k"][1:], ea["k"][1:])
        assert torch.equal(ca["v"][1:], ea["v"][1:])
