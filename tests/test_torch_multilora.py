"""The port's batched multi-LoRA against ray_tpu's, on the same weights
and adapters.

The reference's adapters (``ray_tpu.llm.lora.random_adapter``) and
params (converted with ``models/convert.params_from_numpy``) go through
both packages, f32, on the CPU. A mixed-tenant batch on
``PagedEngineConfig(max_adapters > 0)`` gives the reference's greedy
tokens exactly and its chosen-token logprobs within 1e-4 (both add the
same f32 low-rank delta, summed in other orders: ~1e-6); each row also
gives the tokens of an engine over that tenant's merged weights
(``lora.merge``: x@W + s·(x@A)@B against x@(W + s·AB) rounds apart at
the last bit, so logprobs within 1e-4). Base rows through a
LoRA-enabled engine equal the plain engine's bit for bit: slot 0 adds
an exact zero. ``_lora_add`` and ``merge`` agree with the reference's
at atol 1e-6.
"""
import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm import SamplingParams as JaxSamplingParams
from ray_tpu.llm import lora as jlora
from ray_tpu.llm.multilora.manager import prefix_salt as jax_prefix_salt
from ray_tpu.llm.paged_engine import PagedEngineConfig as JaxConfig
from ray_tpu.llm.paged_engine import PagedInferenceEngine as JaxEngine
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import (PagedEngineConfig, PagedInferenceEngine,
                               SamplingParams, lora)
from ray_tpu_torch.llm.multilora import (AdapterRegistry, AdapterSlotTable,
                                         MultiLoraManager, prefix_salt)
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.util import metrics

SHAPE = dict(vocab_size=258, max_seq_len=256)
ECFG = dict(max_batch_size=4, page_size=8, num_pages=128,
            max_pages_per_seq=16, chunk_size=16)


def _jax_cfg():
    return jllama.llama_tiny(**SHAPE)


def _port_cfg():
    return tllama.llama_tiny(**SHAPE)


@pytest.fixture(scope="module")
def base():
    """(reference params, the port's copy of them)."""
    jp = jllama.init(jax.random.PRNGKey(0), _jax_cfg())
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), _port_cfg(),
                           device="cpu")
    return jp, tp


def _adapters():
    cfg = _jax_cfg()
    return (jlora.random_adapter(jax.random.PRNGKey(7), cfg, rank=4,
                                 alpha=64.0,
                                 targets=("wq", "wv", "lm_head")),
            jlora.random_adapter(jax.random.PRNGKey(9), cfg, rank=2,
                                 alpha=32.0,
                                 targets=("wq", "wk", "wv", "wo")))


def _engine(params, **kw):
    return PagedInferenceEngine(
        PagedEngineConfig(model=_port_cfg(), **ECFG, **kw), params=params,
        device="cpu")


def _run(eng, reqs):
    while not all(r.done for r in reqs):
        eng.step()


def _solo(params, prompt, sp):
    eng = _engine(params)
    req = eng.submit(prompt, sp)
    _run(eng, [req])
    return list(req.out_ids), list(req.out_logps)


# ------------------------------------------------------------------ #
# the maths
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("slots", ["scalar", "batched"])
@pytest.mark.parametrize("target", ["wq", "wo", "lm_head"])
def test_lora_add_matches_reference(slots, target):
    """y + scale[slot]·(x@A[slot])@B[slot] on a 3-slot table (slot 0
    zero), one layer's view, against the reference's jnp; A and B at
    random_adapter's scale (N(0, 1) · 0.05)."""
    import jax.numpy as jnp

    from ray_tpu.models.llama import _lora_add as jax_lora_add
    rng = np.random.RandomState(3)
    din, dout, R, S = 16, 24, 4, 3
    table = {"scale": np.asarray([0.0, 2.0, 0.5], np.float32),
             f"{target}.A": (rng.randn(S, din, R) * 0.05).astype(np.float32),
             f"{target}.B": (rng.randn(S, R, dout) * 0.05).astype(np.float32)}
    table[f"{target}.A"][0] = 0
    table[f"{target}.B"][0] = 0
    if slots == "scalar":
        x = rng.randn(1, 5, din).astype(np.float32)
        y = rng.randn(1, 5, dout).astype(np.float32)
        sl = np.int32(2)
    else:
        x = rng.randn(3, 1, din).astype(np.float32)
        y = rng.randn(3, 1, dout).astype(np.float32)
        sl = np.asarray([2, 0, 1], np.int32)
    want = np.asarray(jax_lora_add(
        jnp.asarray(y), jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in table.items()}, target,
        jnp.asarray(sl)))
    got = tllama._lora_add(
        torch.from_numpy(y), torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in table.items()}, target,
        torch.from_numpy(np.asarray(sl)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    if slots == "batched":
        # the slot-0 row is y exactly
        assert torch.equal(got[1], torch.from_numpy(y[1]))


def test_merge_matches_reference(base):
    jp, tp = base
    for ad in _adapters():
        want = jlora.merge(jp, ad)
        got = lora.merge(tp, ad)
        for t in ("wq", "wk", "wv", "wo"):
            np.testing.assert_allclose(got["layers"][t].numpy(),
                                       np.asarray(want["layers"][t]),
                                       atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["lm_head"].numpy(),
                                   np.asarray(want["lm_head"]),
                                   atol=1e-6, rtol=0)
        # untouched tensors are shared, not copied
        assert got["embed"] is tp["embed"]


def test_adapter_files_cross_packages(tmp_path):
    """An adapter saved by either package loads in the other, through a
    file and through bytes; the port's random adapter has the
    reference's layout."""
    ad = _adapters()[0]
    jlora.save_adapter(ad, str(tmp_path / "ref" / "a"))
    got = lora.load_adapter(str(tmp_path / "ref" / "a"))
    assert set(got) == set(ad)
    for k in ad:
        assert np.array_equal(got[k], ad[k])
    mine = lora.random_adapter(5, _port_cfg(), rank=3, alpha=6.0,
                               targets=("wq", "wo", "lm_head"))
    lora.save_adapter(mine, str(tmp_path / "port" / "b.npz"))
    back = jlora.load_adapter(str(tmp_path / "port" / "b"))
    blob = jlora.adapter_from_bytes(lora.adapter_to_bytes(mine))
    want_ref = jlora.random_adapter(jax.random.PRNGKey(0), _jax_cfg(),
                                    rank=3, targets=("wq", "wo", "lm_head"))
    for k in mine:
        assert np.array_equal(back[k], mine[k])
        assert np.array_equal(blob[k], mine[k])
        assert back[k].shape == want_ref[k].shape
        assert back[k].dtype == want_ref[k].dtype
    # seeded: the same seed draws the same adapter
    again = lora.random_adapter(torch.Generator().manual_seed(5),
                                _port_cfg(), rank=3, alpha=6.0,
                                targets=("wq", "wo", "lm_head"))
    assert all(np.array_equal(again[k], mine[k]) for k in mine)


def test_slot_table_loads_in_place():
    """A load writes the slot's rows of the existing tensors (the
    captured programs read those addresses); slot 0 stays zero; None
    clears; bad slots, ranks and targets raise."""
    cfg = _port_cfg()
    table = AdapterSlotTable(cfg, 3, 4, device="cpu")
    ptrs = {k: t.data_ptr() for k, t in table.tree.items()}
    ad = lora.random_adapter(1, cfg, rank=2, alpha=8.0,
                             targets=("wq", "lm_head"))
    table.load(2, ad)
    assert {k: t.data_ptr() for k, t in table.tree.items()} == ptrs
    assert float(table.tree["scale"][2]) == 4.0
    assert np.array_equal(table.tree["wq.A"][2, :, :, :2].numpy(),
                          ad["wq.A"])
    assert not table.tree["wq.A"][2, :, :, 2:].any()     # rank padding
    assert not table.tree["wk.A"][2].any()               # absent target
    for t in table.tree.values():
        assert not t[0].any()
    table.load(2, None)
    assert not any(t[2].any() for t in table.tree.values())
    with pytest.raises(ValueError, match="slot 0"):
        table.load(0, ad)
    with pytest.raises(ValueError, match="max_rank"):
        table.load(1, lora.random_adapter(1, cfg, rank=8))
    small = AdapterSlotTable(cfg, 2, 4, targets=("wq",), device="cpu")
    with pytest.raises(ValueError, match="targets"):
        small.load(1, ad)


# ------------------------------------------------------------------ #
# the engine
# ------------------------------------------------------------------ #

def test_mixed_batch_parity_vs_reference_and_merged_engines(base):
    """One batch of base + two tenants (different ranks and target sets,
    one below the table's rank): the reference's batched engine's tokens
    exactly and logprobs within 1e-4, and each row the tokens of an
    engine over its tenant's merged weights."""
    jp, tp = base
    ad1, ad2 = _adapters()
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(1, 250, (n,))) for n in (20, 33, 12)]

    ref = JaxEngine(JaxConfig(model=_jax_cfg(), max_adapters=4,
                              lora_rank=8, **ECFG), params=jp)
    port = _engine(tp, max_adapters=4, lora_rank=8)
    for eng in (ref, port):
        eng.load_adapter_slot(1, ad1)
        eng.load_adapter_slot(2, ad2)

    def mix(eng, sp):
        reqs = [eng.submit(prompts[0], sp),
                eng.submit(prompts[1], sp, adapter_slot=1, prefix_salt=b"a"),
                eng.submit(prompts[2], sp, adapter_slot=2, prefix_salt=b"b")]
        _run(eng, reqs)
        return reqs

    want = mix(ref, JaxSamplingParams(max_tokens=10, logprobs=1))
    sp = SamplingParams(max_tokens=10, logprobs=1)
    got = mix(port, sp)
    for a, b in zip(want, got):
        assert b.out_ids == a.out_ids
        np.testing.assert_allclose(b.out_logps, a.out_logps, atol=1e-4)
    merged = [_solo(tp, prompts[0], sp),
              _solo(lora.merge(tp, ad1), prompts[1], sp),
              _solo(lora.merge(tp, ad2), prompts[2], sp)]
    for req, (toks, lps) in zip(got, merged):
        assert req.out_ids == toks
        np.testing.assert_allclose(req.out_logps, lps, atol=1e-4)
    assert {k: port.stats[k] for k in ("prefill_dispatches",
                                       "decode_dispatches", "tokens_out")} \
        == {k: ref.stats[k] for k in ("prefill_dispatches",
                                      "decode_dispatches", "tokens_out")}


def test_base_rows_identical_to_plain_engine(base):
    """Base traffic through a LoRA-enabled engine (adapters resident,
    tenants in the batch) gives the plain engine's tokens and logprobs
    bit for bit, on every family: prefill, decode and verify."""
    _, tp = base
    ad1, ad2 = _adapters()
    prompts = [[7, 8, 9] * 6, list(range(30, 70)), [11, 12] * 9]
    sps = [SamplingParams(max_tokens=12, logprobs=1),
           SamplingParams(max_tokens=12, logprobs=1),
           SamplingParams(max_tokens=12)]
    kw = dict(spec_tokens=3)
    plain = _engine(tp, **kw)
    ml = _engine(tp, max_adapters=3, lora_rank=4, **kw)
    ml.load_adapter_slot(1, ad1)
    ml.load_adapter_slot(2, ad2)
    for eng in (plain, ml):
        # drafts of the last tokens: verify dispatches (random weights
        # seldom repeat themselves)
        eng._propose_draft = lambda ctx, n, s: [int(t) for t in ctx[-s:]]
    a = plain.generate(prompts, sps)
    b = ml.generate(prompts, sps)
    assert [x["token_ids"] for x in b] == [x["token_ids"] for x in a]
    assert [x["logprobs"] for x in b] == [x["logprobs"] for x in a]
    assert ml.stats == plain.stats
    assert ml.stats["spec_dispatches"] > 0
    # and in a batch with a tenant row beside them
    mixed = _engine(tp, max_adapters=3, lora_rank=4, **kw)
    mixed.load_adapter_slot(1, ad1)
    reqs = [mixed.submit(p, sp) for p, sp in zip(prompts[:2], sps)]
    reqs.append(mixed.submit(prompts[2], sps[2], adapter_slot=1,
                             prefix_salt=b"t"))
    _run(mixed, reqs)
    for r, x in zip(reqs[:2], a[:2]):
        assert r.out_ids == x["token_ids"]
        assert r.out_logps == x["logprobs"]


def test_dispatches_flat_in_tenant_count(base):
    """The same batch costs the same dispatches, and the same programs
    (static keys), whether its rows are one tenant or three."""
    _, tp = base
    ads = [jlora.random_adapter(jax.random.PRNGKey(i), _jax_cfg(), rank=2,
                                alpha=8.0) for i in (1, 2, 3)]
    rng = np.random.RandomState(1)
    prompts = [list(rng.randint(1, 250, (18,))) for _ in range(3)]
    sp = SamplingParams(max_tokens=8)

    def run(slot_per_row):
        eng = _engine(tp, max_adapters=4, lora_rank=4)
        for i, ad in enumerate(ads):
            eng.load_adapter_slot(i + 1, ad)
        reqs = [eng.submit(p, sp, adapter_slot=s,
                           prefix_salt=bytes([s]) if s else b"")
                for p, s in zip(prompts, slot_per_row)]
        _run(eng, reqs)
        st = eng.stats
        return (st["prefill_dispatches"] + st["decode_dispatches"]
                + st["spec_dispatches"],
                sorted(map(repr, eng.profiler.executed_tags())))

    assert run([1, 1, 1]) == run([1, 2, 3])


def test_submit_checks_the_adapter_slot(base):
    _, tp = base
    plain = _engine(tp)
    with pytest.raises(ValueError, match="max_adapters"):
        plain.submit([1, 2, 3], SamplingParams(), adapter_slot=1)
    with pytest.raises(ValueError, match="max_adapters"):
        plain.load_adapter_slot(1, _adapters()[0])
    ml = _engine(tp, max_adapters=3, lora_rank=4)
    with pytest.raises(ValueError, match="outside the slot table"):
        ml.submit([1, 2, 3], SamplingParams(), adapter_slot=3)


# ------------------------------------------------------------------ #
# registry + manager lifecycle
# ------------------------------------------------------------------ #

def test_registry_versioning_and_keep_window():
    reg = AdapterRegistry("t-registry", keep=2)
    ad = lora.random_adapter(0, _port_cfg(), rank=2)
    for i in range(5):
        assert reg.publish("ad", ad) == i
    assert reg.latest_version("ad") == 4
    got_v, got = reg.fetch("ad")
    assert got_v == 4 and "wq.A" in got
    with pytest.raises(KeyError):
        reg.fetch("ad", version=0)       # reclaimed by the keep window
    assert reg.fetch("ad", version=3)[0] == 3
    with pytest.raises(KeyError):
        reg.fetch("missing")
    meta = reg.list()["ad"]
    assert meta["version"] == 4 and meta["rank"] == 2
    assert meta["targets"] == ["wq", "wv"]


def test_hot_swap_pins_inflight_version(base):
    """Publish v1 while a v0 request streams: the in-flight request
    finishes on v0's weights, the next resolves to v1 in another slot,
    and nothing drops."""
    _, tp = base
    cfg = _port_cfg()
    v0 = lora.random_adapter(5, cfg, rank=4, alpha=64.0,
                             targets=("wq", "wv", "lm_head"))
    v1 = lora.random_adapter(6, cfg, rank=4, alpha=64.0,
                             targets=("wq", "wv", "lm_head"))
    reg = AdapterRegistry("t-swap")
    reg.publish("ten", v0)
    eng = _engine(tp, max_adapters=4, lora_rank=8)
    mgr = MultiLoraManager(eng, reg, refresh_s=0.0)
    prompt = list(np.random.RandomState(0).randint(1, 250, (14,)))
    sp = SamplingParams(max_tokens=16)
    s0, ver0, salt0 = mgr.resolve("ten")
    assert ver0 == 0 and salt0 == jax_prefix_salt("ten", 0)
    inflight = eng.submit(prompt, sp, adapter_slot=s0, prefix_salt=salt0)
    for _ in range(2):
        eng.step()               # mid-stream
    reg.publish("ten", v1)
    s1, ver1, salt1 = mgr.resolve("ten")
    assert ver1 == 1 and s1 != s0
    assert mgr.stats["swaps"] == 1
    nxt = eng.submit(prompt, sp, adapter_slot=s1, prefix_salt=salt1)
    _run(eng, [inflight, nxt])
    assert inflight.out_ids == _solo(lora.merge(tp, v0), prompt, sp)[0]
    assert nxt.out_ids == _solo(lora.merge(tp, v1), prompt, sp)[0]
    assert inflight.done and nxt.done


def test_eviction_under_pressure_keeps_live_slots(base):
    """LRU eviction never steals a slot with in-flight requests; with
    every slot live a cold resolve fails loudly."""
    _, tp = base
    cfg = _port_cfg()
    reg = AdapterRegistry("t-evict")
    for name, seed in (("a", 1), ("b", 2), ("c", 3), ("d", 4)):
        reg.publish(name, lora.random_adapter(seed, cfg, rank=2,
                                              alpha=16.0))
    eng = _engine(tp, max_adapters=3, lora_rank=4)  # 2 usable
    mgr = MultiLoraManager(eng, reg, refresh_s=0.0)
    prompt = list(np.random.RandomState(0).randint(1, 250, (10,)))
    sp = SamplingParams(max_tokens=30)
    sa, _, salta = mgr.resolve("a")
    busy = eng.submit(prompt, sp, adapter_slot=sa, prefix_salt=salta)
    eng.step()
    sb, _, _ = mgr.resolve("b")          # fills the second slot
    sc, _, _ = mgr.resolve("c")          # must evict b (idle), never a
    assert sc == sb and sc != sa
    assert mgr.stats["evictions"] == 1
    busy2 = eng.submit(prompt, sp, adapter_slot=sc, prefix_salt=b"c")
    eng.step()
    with pytest.raises(RuntimeError, match="in-flight"):
        mgr.resolve("d")                 # both slots live now
    _run(eng, [busy, busy2])
    assert busy.out_ids == _solo(lora.merge(tp, reg.fetch("a")[1]),
                                 prompt, sp)[0]


def test_resolve_pin_blocks_eviction_before_submit(base):
    _, tp = base
    cfg = _port_cfg()
    reg = AdapterRegistry("t-pin")
    for name, seed in (("a", 1), ("b", 2)):
        reg.publish(name, lora.random_adapter(seed, cfg, rank=2,
                                              alpha=16.0))
    eng = _engine(tp, max_adapters=2, lora_rank=4)  # ONE slot
    mgr = MultiLoraManager(eng, reg, refresh_s=0.0)
    sa, _, _ = mgr.resolve("a", pin=True)     # resolved, not submitted
    with pytest.raises(RuntimeError, match="overloaded"):
        mgr.resolve("b")                      # the only slot is pinned
    mgr.unpin(sa)
    sb, _, _ = mgr.resolve("b")               # now evictable
    assert sb == sa


def test_prefix_cache_never_crosses_tenants(base):
    """Identical prompts under different (adapter_id, version) salts
    share nothing in the prefix cache; re-use within one tenant hits;
    the salts are the reference's bytes."""
    _, tp = base
    for aid, v in (("a", 0), ("b", 0), ("tenant-x", 7)):
        assert prefix_salt(aid, v) == jax_prefix_salt(aid, v)
    ad = lora.random_adapter(3, _port_cfg(), rank=2, alpha=16.0)
    eng = _engine(tp, max_adapters=3, lora_rank=4)
    eng.load_adapter_slot(1, ad)
    eng.load_adapter_slot(2, ad)
    prompt = list(np.random.RandomState(0).randint(1, 250, (40,)))
    sp = SamplingParams(max_tokens=4)
    salt_a, salt_b = prefix_salt("a", 0), prefix_salt("b", 0)

    def one(**kw):
        r = eng.submit(prompt, sp, **kw)
        _run(eng, [r])
        return eng.stats["prefix_hits"]

    assert one(adapter_slot=1, prefix_salt=salt_a) == 0
    assert one(adapter_slot=2, prefix_salt=salt_b) == 0    # no leak
    assert one(adapter_slot=1, prefix_salt=salt_a) > 0     # own pages
    hits = eng.stats["prefix_hits"]
    assert one() == hits                 # base never matches tenants


def test_lora_telemetry_series(base):
    """The manager's resolves ship the rtpu_llm_lora_* series."""
    _, tp = base
    metrics._reset_registry()
    reg = AdapterRegistry("t-telemetry")
    reg.publish("a", lora.random_adapter(1, _port_cfg(), rank=2))
    eng = _engine(tp, max_adapters=3, lora_rank=4)
    mgr = MultiLoraManager(eng, reg, refresh_s=0.0)
    for _ in range(3):
        mgr.resolve("a")
    text = "\n".join(metrics.prometheus_lines(metrics.collect_store()))
    for name, value in (("rtpu_llm_lora_requests_total", 3),
                        ("rtpu_llm_lora_hits_total", 2),
                        ("rtpu_llm_lora_loads_total", 1),
                        ("rtpu_llm_lora_resident_adapters", 1),
                        ("rtpu_llm_lora_publishes_total", 1)):
        line = next(ln for ln in text.splitlines()
                    if ln.startswith(name + "{"))
        assert float(line.rsplit(" ", 1)[1]) == value, line
