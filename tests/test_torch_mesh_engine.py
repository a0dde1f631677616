"""Tensor-parallel paged serving (``PagedEngineConfig.mesh``) of the port
against the reference's mesh engine, on the same weights.

One port case per case of ``tests/test_mesh_engine.py``. The reference
runs its tp=2 / tp=4 engine on conftest's virtual CPU devices (GSPMD
partitions its programs); the port runs one engine in this process with
one shard per tp rank, all on the CPU. The bars, on the tiny f32 Llama
(weights from the reference's ``llama.init``, carried across with
``models/convert.params_from_numpy``):

- greedy tokens equal the reference's tp engine's and the port's own
  mesh-off engine's;
- logprobs within 1e-5 of both (the tp partial sums add the same f32
  products in another order: a few ulps);
- ``mesh_dispatches``, ``mesh_input_bytes`` and ``mesh_output_bytes``
  equal the reference's counters on the same traffic, and
  ``mesh_reshard_bytes`` is 0.

Beyond the reference's cases: tp=1 runs the mesh-off ops bit for bit,
an MoE config at tp=2 matches its mesh-off run and the reference's
one-device run, KV payloads cross both packages' tp=2 and mesh-off
engines, the spill tier demotes and promotes pages across both ranks
with the reference's counters, and a shard rebound behind the engine's
back is counted in ``mesh_reshard_bytes``.
"""
import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm import SamplingParams as JaxSamplingParams
from ray_tpu.llm.paged_engine import PagedEngineConfig as JaxConfig
from ray_tpu.llm.paged_engine import PagedInferenceEngine as JaxEngine
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import (PagedEngineConfig, PagedInferenceEngine,
                               SamplingParams)
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel import sharding

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="the reference needs 4 (virtual) devices")

SHAPE = dict(vocab_size=258, max_seq_len=256)
ECFG = dict(max_batch_size=4, page_size=8, num_pages=128,
            max_pages_per_seq=16, chunk_size=16)
COUNTERS = ("mesh_dispatches", "mesh_input_bytes", "mesh_output_bytes",
            "mesh_reshard_bytes")
GREEDY = dict(max_tokens=16, temperature=0.0)
GREEDY_LP = dict(max_tokens=16, temperature=0.0, logprobs=1)


def _weights(**shape):
    jp = jllama.init(jax.random.PRNGKey(0), jllama.llama_tiny(**shape))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp),
                           tllama.llama_tiny(**shape), device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def weights():
    return _weights(**SHAPE)


def _port(tp, mesh=None, shape=SHAPE, **over):
    cfg = PagedEngineConfig(model=tllama.llama_tiny(**shape), mesh=mesh,
                            **{**ECFG, **over})
    return PagedInferenceEngine(cfg, params=tp, device="cpu")


def _ref(jp, mesh=None, shape=SHAPE, **over):
    cfg = JaxConfig(model=jllama.llama_tiny(**shape), mesh=mesh,
                    **{**ECFG, **over})
    return JaxEngine(cfg, params=jp, rng_seed=0)


def _sp(eng, **kw):
    return (JaxSamplingParams if isinstance(eng, JaxEngine)
            else SamplingParams)(**kw)


def _prompts(rng, lens=(16, 32, 24)):
    return [[int(t) for t in rng.randint(1, 250, (n,))] for n in lens]


def _gen(eng, prompts, **sp):
    return eng.generate(prompts, _sp(eng, **sp))


def _assert_same(got, want, exact=False):
    assert [o["token_ids"] for o in got] == [o["token_ids"] for o in want]
    for a, b in zip(got, want):
        if a.get("logprobs") is None:
            assert b.get("logprobs") is None
        elif exact:
            assert a["logprobs"] == b["logprobs"]
        else:
            np.testing.assert_allclose(a["logprobs"], b["logprobs"],
                                       atol=1e-5)


def _counters(eng) -> dict:
    return {k: eng.stats[k] for k in COUNTERS}


def test_mesh_off_counters_stay_zero(weights):
    jp, tp = weights
    prompts = _prompts(np.random.RandomState(0))
    for eng in (_port(tp), _ref(jp)):
        _gen(eng, prompts, **GREEDY)
        assert eng.mesh is None
        assert _counters(eng) == dict.fromkeys(COUNTERS, 0)


def test_tp2_greedy_matches_reference_and_zero_reshards(weights):
    """tp=2 prefill and decode: the reference's tp=2 tokens and its
    mesh-off ones, logprobs to 1e-5, the reference's transfer counters,
    and no shard moved."""
    jp, tp = weights
    prompts = _prompts(np.random.RandomState(1))
    off = _gen(_port(tp), prompts, **GREEDY_LP)
    ref = _ref(jp, {"tp": 2})
    want = _gen(ref, prompts, **GREEDY_LP)
    eng = _port(tp, {"tp": 2})
    assert dict(eng.mesh.shape)["tp"] == 2
    assert dict(eng.mesh.shape) == dict(ref.mesh.shape)
    got = _gen(eng, prompts, **GREEDY_LP)
    _assert_same(got, want)
    _assert_same(got, off)
    assert eng.stats["mesh_dispatches"] > 0
    assert _counters(eng) == _counters(ref)
    assert eng.stats["mesh_reshard_bytes"] == 0, eng.stats
    # declared transfers: token ids in, tokens and logprobs out
    assert 0 < eng.stats["mesh_input_bytes"] < 1 << 20
    assert 0 < eng.stats["mesh_output_bytes"] < 1 << 20


def test_tp1_is_bit_identical_to_mesh_off(weights):
    """A one-rank mesh runs exactly the one-device ops: tokens, logprobs
    and every page equal bit for bit."""
    _jp, tp = weights
    prompts = _prompts(np.random.RandomState(6))
    off, one = _port(tp), _port(tp, {"tp": 1})
    _assert_same(_gen(one, prompts, **GREEDY_LP),
                 _gen(off, prompts, **GREEDY_LP), exact=True)
    for a, b in zip(off.caches, one.caches[0]):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
    assert one.stats["mesh_dispatches"] > 0
    assert one.stats["mesh_reshard_bytes"] == 0


def test_tp4_greedy_matches_reference():
    """4-way: tp must divide n_kv_heads and the vocab, so this arm runs
    the reference's 4-kv-head / 256-vocab tiny config (H 1 and KVH 1 per
    rank)."""
    shape = dict(vocab_size=256, max_seq_len=256, n_kv_heads=4)
    jp, tp = _weights(**shape)
    prompts = _prompts(np.random.RandomState(5))
    ref = _ref(jp, {"tp": 4}, shape=shape)
    want = _gen(ref, prompts, **GREEDY)
    eng = _port(tp, {"tp": 4}, shape=shape)
    got = _gen(eng, prompts, **GREEDY)
    _assert_same(got, want)
    _assert_same(got, _gen(_port(tp, shape=shape), prompts, **GREEDY))
    assert eng.caches[0][0]["k"].shape[2] == 1
    assert _counters(eng) == _counters(ref)
    assert eng.stats["mesh_reshard_bytes"] == 0


def test_tp2_placements_are_pinned(weights):
    """Every shard stays where the engine put it: the weights are the
    logical-axis shards of the whole weights (and put back, the whole
    weights), each rank's KV pool holds its kv_heads, the reference's
    own placements hold too, and a shard rebound behind the engine's
    back is counted as reshard bytes at the next dispatch."""
    jp, tp = weights
    prompts = _prompts(np.random.RandomState(2), (16,))
    ref = _ref(jp, {"tp": 2})
    _gen(ref, prompts, **GREEDY)
    kv = ref._shardings["caches"][0]["k"]
    assert all(kv.is_equivalent_to(a.sharding, a.ndim)
               for layer in ref.caches for a in layer.values())

    eng = _port(tp, {"tp": 2})
    _gen(eng, prompts, **GREEDY)
    mc = tllama.llama_tiny(**SHAPE)
    axes = tllama.logical_axes(mc)
    for name, want in tp["layers"].items():
        parts = [sh["layers"][name] for sh in eng.params]
        ref_parts = sharding.shard_tensor(want, axes["layers"][name],
                                          eng.mesh)
        assert all(torch.equal(a, b) for a, b in zip(parts, ref_parts))
    whole = eng.whole_params()
    assert torch.equal(whole["embed"], tp["embed"])
    assert torch.equal(whole["lm_head"], tp["lm_head"])
    assert all(torch.equal(whole["layers"][n], tp["layers"][n])
               for n in tp["layers"])
    for rank in eng.caches:
        for layer in rank:
            assert tuple(layer["k"].shape) == (
                ECFG["num_pages"], ECFG["page_size"], mc.n_kv_heads // 2,
                mc.head_dim)
    assert eng.stats["mesh_reshard_bytes"] == 0
    moved = eng.caches[1][0]["k"]
    eng.caches[1][0]["k"] = moved.clone()
    _gen(eng, prompts, **GREEDY)
    n_disp = eng.stats["mesh_dispatches"]
    assert eng.stats["mesh_reshard_bytes"] > 0
    assert eng.stats["mesh_reshard_bytes"] % (
        moved.numel() * moved.element_size()) == 0
    assert n_disp > 0


def test_tp2_mixed_tenant_lora_parity(weights):
    """The slot table cut like the weights its rows add onto: a mixed
    batch (base rows, a wq/wv adapter, an adapter on every target, wo's
    delta reduced with wo and lm_head's cut by vocab) gives the
    reference's tp=2 tokens and the port's mesh-off ones."""
    from ray_tpu.llm import lora as jlora
    jp, tp = weights
    mc = jllama.llama_tiny(**SHAPE)
    adapters = [
        jlora.random_adapter(jax.random.PRNGKey(7), mc, rank=4, alpha=8.0,
                             targets=("wq", "wv")),
        jlora.random_adapter(jax.random.PRNGKey(8), mc, rank=4, alpha=8.0,
                             targets=("wq", "wk", "wv", "wo", "lm_head"))]
    adapters = [{k: np.asarray(v) for k, v in a.items()} for a in adapters]
    prompts = _prompts(np.random.RandomState(3), (16, 32, 24, 20))
    over = dict(max_adapters=3, lora_rank=4)

    def run(eng):
        for slot, ad in enumerate(adapters, start=1):
            eng.lora.load(slot, ad)
        reqs = [eng.submit(p, _sp(eng, **GREEDY_LP), adapter_slot=i % 3)
                for i, p in enumerate(prompts)]
        while not all(r.done for r in reqs):
            eng.step()
        return reqs

    ref = _ref(jp, {"tp": 2}, **over)
    want = run(ref)
    eng = _port(tp, {"tp": 2}, **over)
    got = run(eng)
    off = run(_port(tp, **over))
    for a, b, c in zip(got, want, off):
        assert list(a.out_ids) == list(b.out_ids) == list(c.out_ids)
        np.testing.assert_allclose(a.out_logps, b.out_logps, atol=1e-5)
        np.testing.assert_allclose(a.out_logps, c.out_logps, atol=1e-5)
    assert _counters(eng) == _counters(ref)
    assert eng.stats["mesh_reshard_bytes"] == 0
    axes = eng.lora.logical_axes()
    assert axes == ref.lora.logical_axes()
    assert axes["wq.B"][-1] == "heads"
    d, r = mc.dim, 4
    for rank in eng.lora.tree:
        assert tuple(rank["wq.B"].shape[-2:]) == (r, d // 2)
        assert tuple(rank["wo.A"].shape[-2:]) == (d // 2, r)
        assert tuple(rank["wo.B"].shape[-2:]) == (r, d)
        assert tuple(rank["lm_head.B"].shape[-2:]) == (r, SHAPE[
            "vocab_size"] // 2)


def test_tp2_spec_decode_parity(weights):
    """The verify family under the mesh, with the reference test's
    recipe (a mixed burst, then a self-similar prompt alone so every
    slot carries a draft)."""
    jp, tp = weights
    rng = np.random.RandomState(3)
    over = dict(prefill_rows=3, decode_window=4, spec_tokens=6)
    burst = [[int(t) for t in rng.randint(1, 250, (n,))] for n in (5, 17, 33)]
    burst.append([7, 8, 9] * 6)
    sp = dict(max_tokens=24, temperature=0.0)

    def run(eng):
        _gen(eng, burst, **sp)
        return _gen(eng, [[7, 8, 9] * 6], **sp)[0]["token_ids"]

    ref = _ref(jp, {"tp": 2}, **over)
    eng = _port(tp, {"tp": 2}, **over)
    off = _port(tp, **over)
    assert run(eng) == run(ref) == run(off)
    assert eng.stats["spec_dispatches"] > 0
    assert eng.stats["spec_dispatches"] == ref.stats["spec_dispatches"]
    assert _counters(eng) == _counters(ref)
    assert eng.stats["mesh_reshard_bytes"] == 0


def test_tp2_moe_matches_mesh_off_and_reference():
    """An MoE config at tp=2 (every expert on each rank at mlp/tp
    columns, the router replicated) gives its mesh-off run's tokens and
    the reference's one-device run's."""
    shape = dict(SHAPE, moe_experts=4, moe_top_k=2)
    jp, tp = _weights(**shape)
    prompts = _prompts(np.random.RandomState(8))
    want = _gen(_ref(jp, shape=shape), prompts, **GREEDY_LP)
    eng = _port(tp, {"tp": 2}, shape=shape)
    got = _gen(eng, prompts, **GREEDY_LP)
    _assert_same(got, want)
    _assert_same(got, _gen(_port(tp, shape=shape), prompts, **GREEDY_LP))
    assert eng.stats["mesh_reshard_bytes"] == 0


def test_tp2_spill_tier_matches_reference(weights):
    """The host spill tier over a tp=2 pool: evicted pages demote
    (gathered from both ranks along kv_heads) and promote back
    (scattered to them), with the reference's tp=2 tokens and spill
    counters at every stage and the port's mesh-off tokens."""
    jp, tp = weights
    over = dict(num_pages=32, kv_spill=True)
    engines = [_ref(jp, {"tp": 2}, **over), _port(tp, {"tp": 2}, **over),
               _port(tp, **over)]
    rng = np.random.RandomState(11)
    shared = [int(t) for t in rng.randint(1, 250, 96)]
    keys = ("spill_pages", "spill_demotions", "spill_promotions",
            "mesh_dispatches", "mesh_input_bytes", "mesh_output_bytes")

    def run(eng, ids, n):
        r = eng.submit(ids, _sp(eng, max_tokens=n, temperature=0.0))
        while not r.done:
            eng.step()
        return list(r.out_ids)

    stages = [(shared + [1, 2, 3], 3), (shared + [4, 5, 6], 3)]
    stages += [([int(t) for t in rng.randint(1, 250, 96)], 2)
               for _ in range(6)]                     # evict: demote
    stages += [(shared + [7, 8, 9], 3)]               # revisit: promote
    for ids, n in stages:
        outs = [run(e, ids, n) for e in engines]
        assert outs[0] == outs[1] == outs[2]
        ref, eng = engines[0], engines[1]
        assert {k: eng.stats[k] for k in keys} == \
            {k: ref.stats[k] for k in keys}
    assert eng.stats["spill_demotions"] > 0
    assert eng.stats["spill_promotions"] > 0
    assert eng.stats["mesh_reshard_bytes"] == 0


@pytest.mark.parametrize("src,dst", [
    ("port:tp2", "port:off"), ("port:off", "port:tp2"),
    ("port:tp2", "port:tp2"), ("ref:tp2", "port:tp2"),
    ("port:tp2", "ref:tp2"), ("ref:tp2", "port:off")])
def test_prefix_export_import_across_mesh_boundary(weights, src, dst):
    """KV payloads are mesh-agnostic: pages exported from a tp engine
    import into a one-device engine and back, across both packages, and
    decode to the one-device tokens; the pages a port tp engine imports
    come back out bit for bit."""
    jp, tp = weights
    prompt = [int(t) for t in np.random.RandomState(4).randint(1, 250, 30)]
    sp = dict(max_tokens=12, temperature=0.0)
    want = _gen(_port(tp), [prompt], **sp)[0]["token_ids"]

    def make(name):
        pkg, mesh = name.split(":")
        mesh = {"tp": 2} if mesh == "tp2" else None
        return _ref(jp, mesh) if pkg == "ref" else _port(tp, mesh)

    a, b = make(src), make(dst)
    payload = a.prefill_export(prompt, _sp(a, **sp))
    req = b.import_prefill(payload, _sp(b, **sp))
    if isinstance(b, PagedInferenceEngine):
        back = b._pages_to_host(req.pages)
        for layer, sent in zip(back, payload["pages"]):
            for kv in ("k", "v"):
                np.testing.assert_array_equal(layer[kv],
                                              np.asarray(sent[kv]))
    while not req.done:
        b.step()
    assert list(req.out_ids) == want, (src, dst)
    assert b.stats["mesh_reshard_bytes"] == 0


def test_mesh_tp_must_divide_heads(weights):
    jp, tp = weights
    with pytest.raises(ValueError, match="must divide"):
        _ref(jp, {"tp": 3})
    with pytest.raises(ValueError, match="must divide"):
        _port(tp, {"tp": 3})
    # axes other than tp, and shards on distinct cards, are A9.2's
    with pytest.raises(NotImplementedError, match="A9.2"):
        _port(tp, {"dp": 2})


def test_llmserver_engine_stats_reports_mesh():
    """Both packages' LLMServer over a tp=2 engine: the same six axis
    sizes, the same completion, the same counters."""
    from ray_tpu.core.config import cfg as jax_rcfg
    from ray_tpu.llm.serving import LLMConfig as JaxLLMConfig
    from ray_tpu.llm.serving import LLMServer as JaxLLMServer
    from ray_tpu_torch.core.config import cfg as port_rcfg
    from ray_tpu_torch.llm.serving import LLMConfig, LLMServer
    jax_rcfg.override(serve_prefix_directory=False)
    port_rcfg.override(serve_prefix_directory=False)
    servers = []
    try:
        servers.append(JaxLLMServer(JaxLLMConfig(
            model_id="tiny-mesh", warmup=False,
            engine=JaxConfig(model=jllama.llama_tiny(**SHAPE),
                             mesh={"tp": 2}, **ECFG))))
        seeded = params_from_numpy(
            jax.tree.map(np.asarray, servers[0].engine.params),
            tllama.llama_tiny(**SHAPE), device="cpu")
        servers.append(LLMServer(LLMConfig(
            model_id="tiny-mesh", warmup=False,
            engine=PagedEngineConfig(model=tllama.llama_tiny(**SHAPE),
                                     mesh={"tp": 2}, **ECFG)),
            params_ref=seeded, device="cpu"))
        body = {"prompt": "tensor parallel", "max_tokens": 6,
                "temperature": 0.0}
        outs = [s.completions(dict(body)) for s in servers]
        assert outs[1]["choices"][0]["text"] == \
            outs[0]["choices"][0]["text"]
        ref_st, st = (s.engine_stats() for s in servers)
        assert st["mesh"] == ref_st["mesh"] == {
            "pp": 1, "dp": 1, "fsdp": 1, "ep": 1, "sp": 1, "tp": 2}
        assert {k: st[k] for k in COUNTERS} == {k: ref_st[k]
                                                for k in COUNTERS}
        assert st["mesh_reshard_bytes"] == 0
    finally:
        jax_rcfg.reset("serve_prefix_directory")
        port_rcfg.reset("serve_prefix_directory")
        for s in servers:
            s._stop = True
            s._wake.set()
