"""The port's host spill tier (``llm/tiering.py`` and the paged engine's
demote/promote paths) against ray_tpu's.

Policy and tier units run the port's copy of the module as the
reference's tests run theirs. Engine cases run the port's
PagedInferenceEngine on the CPU, f32, on the reference's weights
(``models/convert.params_from_numpy``): greedy tokens with the tier on
equal those with it off, a promoted page is bitwise the page exported
before its eviction, and every spill counter and the prefix accounting
equal the reference engine's on the same traffic. The reference's
three store-backed cases (a promote across engines through the object
store, a stale ``spill:`` entry, the store's drain at teardown) run
under both packages' runtimes, side by side in this process, with
tokens, directory keys and spill counters held to the reference's.
"""
import threading
import time

import jax
import numpy as np
import pytest

from ray_tpu.llm import SamplingParams as JaxSamplingParams
from ray_tpu.llm.paged_engine import PagedEngineConfig as JaxConfig
from ray_tpu.llm.paged_engine import PagedInferenceEngine as JaxEngine
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import (PagedEngineConfig, PagedInferenceEngine,
                               SamplingParams)
from ray_tpu_torch.llm.chainstats import ChainStatsTable
from ray_tpu_torch.llm.tiering import SpillPolicy, SpillTier, _payload_ok
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy

SHAPE = dict(vocab_size=258, max_seq_len=640)
ECFG = dict(max_batch_size=4, page_size=8, num_pages=32,
            max_pages_per_seq=16, chunk_size=16)
SPILL_KEYS = ("spill_pages", "spill_bytes", "spill_demotions",
              "spill_promotions", "spill_expired", "spill_drops")


@pytest.fixture(scope="module")
def weights():
    """(reference params, the port's copy of them)."""
    jp = jllama.init(jax.random.PRNGKey(0), jllama.llama_tiny(**SHAPE))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp),
                           tllama.llama_tiny(**SHAPE), device="cpu")
    return jp, tp


def _port(tp, **kw):
    return PagedInferenceEngine(
        PagedEngineConfig(model=tllama.llama_tiny(**SHAPE),
                          **{**ECFG, **kw}), params=tp, device="cpu")


def _ref(jp, **kw):
    return JaxEngine(JaxConfig(model=jllama.llama_tiny(**SHAPE),
                               **{**ECFG, **kw}), params=jp)


def _prompt(n, seed=0):
    return [int(t) for t in np.random.RandomState(seed).randint(1, 250, n)]


def _run_one(eng, ids, max_tokens=4):
    sp = (JaxSamplingParams if isinstance(eng, JaxEngine)
          else SamplingParams)(max_tokens=max_tokens)
    r = eng.submit(ids, sp)
    while not r.done:
        eng.step()
    return list(r.out_ids)


def _flush(eng, count=8, seed0=9000, n=96):
    """Distinct prompts until every refcount-0 page of earlier chains has
    fallen off the LRU: the demote site."""
    for i in range(count):
        _run_one(eng, _prompt(n, seed=seed0 + i), max_tokens=2)


def _assert_spill_parity(eng):
    """Chain-table sums == engine.stats == live tier residence, and
    prefix_accounting() agrees."""
    t = eng.chains.totals()
    resident = eng.spill.resident_pages() if eng.spill else 0
    assert t["spilled_pages"] == resident
    assert t["promotions"] == eng.stats["spill_promotions"]
    acct = eng.prefix_accounting()
    assert acct["spill_resident_pages"] == resident
    if eng.spill is not None:
        assert acct["spill_resident_bytes"] == eng.spill.resident_bytes
        assert acct["spill_demotions"] == eng.stats["spill_demotions"]


# ------------------------------------------------------------------ #
# config + policy/tier units
# ------------------------------------------------------------------ #

def test_kv_spill_config_validation():
    cfg = tllama.llama_tiny(**SHAPE)
    with pytest.raises(ValueError, match="enable_prefix_caching"):
        PagedEngineConfig(model=cfg, kv_spill=True,
                          enable_prefix_caching=False)
    with pytest.raises(ValueError, match="kv_spill_max_bytes"):
        PagedEngineConfig(model=cfg, kv_spill=True, kv_spill_max_bytes=0)
    PagedEngineConfig(model=cfg, kv_spill=True, kv_spill_min_hits=2,
                      kv_spill_max_idle_s=5.0)


def test_spill_policy_gates_unit():
    t = ChainStatsTable(slots=4, page_bytes=10)
    s = t.slot_for(b"a" * 16)
    now = time.monotonic()
    pol = SpillPolicy(min_hits=2)
    assert not pol.admit(t, s, now)
    t.hit(s, pages=2)
    assert pol.admit(t, s, now)
    pol2 = SpillPolicy(max_idle_s=1.0)
    t.last_hit[s] = now - 5.0
    assert not pol2.admit(t, s, now)
    t.last_hit[s] = now - 0.5
    assert pol2.admit(t, s, now)
    # no table / never-learned chain: no signal, admit (budget governs)
    assert SpillPolicy(min_hits=99).admit(None, s, now)
    assert SpillPolicy(min_hits=99).admit(t, 0, now)
    # re-warm: hottest spilled slot, only with pool headroom
    s2 = t.slot_for(b"b" * 16)
    t.hit(s2, pages=5)
    pol3 = SpillPolicy(rewarm_min_hits=1, rewarm_free_frac=0.5)
    assert pol3.rewarm_slot(t, {s, s2}, 0.9) == s2
    assert pol3.rewarm_slot(t, {s, s2}, 0.1) is None
    assert pol3.rewarm_slot(None, {s, s2}, 0.9) is None


def test_spill_tier_budget_unit():
    ks = [np.zeros((2, 2), np.float32)]
    tier = SpillTier(max_bytes=30, page_nbytes=10)
    hs = [bytes([i]) * 16 for i in range(4)]
    expired = [tier.add(h, 0, ks, ks, now=float(i))
               for i, h in enumerate(hs)]
    assert expired[:3] == [[], [], []]
    assert expired[3] == [(hs[0], 0)]      # FIFO victim without a table
    assert tier.resident_pages() == 3 and tier.resident_bytes == 30
    new, gone = tier.drain_publish_delta()
    assert set(new) == set(hs[1:]) and gone == [hs[0]]
    assert tier.drain_publish_delta() == ((), ())
    tier.requeue_publish([hs[1], hs[0]])
    assert tier.drain_publish_delta()[0] == [hs[1]]
    assert tier.covered_run(hs[1:]) == 3 and tier.covered_run(hs) == 0
    assert tier.chain_of(hs[1]) == 0
    payload, dropped = tier.payload_for(hs[1:3], page_size=2)
    assert dropped == [] and _payload_ok(payload, 2)
    assert payload["page_hashes"] == hs[1:3]
    assert payload["pages"][0]["k"].shape == (2, 2, 2)
    t2 = SpillTier(max_bytes=5, page_nbytes=10)   # page over the budget
    assert t2.add(b"h" * 16, 1, ks, ks) == [(b"h" * 16, 1)]
    assert t2.resident_pages() == 0
    assert sorted(h for h, _c in tier.clear()) == sorted(hs[1:])
    assert tier.resident_pages() == 0 and tier.resident_bytes == 0
    assert not _payload_ok({"page_size": 4}, 2)


# ------------------------------------------------------------------ #
# engine: demote/promote, tokens, budget, re-warm, counters
# ------------------------------------------------------------------ #

def test_tier_on_off_identical_tokens(weights):
    """Identical greedy tokens with the tier on and off across an
    evict-then-revisit workload; with it off every spill counter stays
    0."""
    _, tp = weights
    shared = _prompt(96, seed=3)

    def run(spill):
        eng = _port(tp, kv_spill=spill)
        outs = [_run_one(eng, shared + _prompt(16, seed=50), 8)]
        _flush(eng, seed0=9100)
        outs.append(_run_one(eng, shared + _prompt(16, seed=51), 8))
        return eng, outs

    on, outs_on = run(True)
    off, outs_off = run(False)
    assert outs_on == outs_off
    assert on.stats["spill_demotions"] > 0
    assert on.stats["spill_promotions"] > 0
    assert all(off.stats[k] == 0 for k in SPILL_KEYS)
    assert off.spill is None
    _assert_spill_parity(on)
    _assert_spill_parity(off)


def test_demote_promote_bitwise_roundtrip(weights):
    """A promoted page is bitwise the page exported before its eviction,
    and lands in the same pool tensors (written in place)."""
    _, tp = weights
    eng = _port(tp, kv_spill=True)
    ptrs = [(c["k"].data_ptr(), c["v"].data_ptr()) for c in eng.caches]
    ids = _prompt(96, seed=11)
    _run_one(eng, ids, 2)
    hashes = eng.hash_prompt(ids)
    before = eng.export_prefix(hashes)
    assert before is not None and len(before["page_hashes"]) > 0
    _flush(eng, seed0=9200)
    assert eng.cached_prefix_len(hashes) == 0   # fully evicted
    assert eng.spill.covered_run(hashes) == len(hashes)
    _run_one(eng, ids, 2)                       # admission promote
    assert eng.stats["spill_promotions"] >= len(hashes)
    after = eng.export_prefix(hashes)
    assert after["page_hashes"] == before["page_hashes"]
    for la, lb in zip(after["pages"], before["pages"]):
        assert np.array_equal(la["k"], lb["k"])
        assert np.array_equal(la["v"], lb["v"])
    assert [(c["k"].data_ptr(), c["v"].data_ptr())
            for c in eng.caches] == ptrs
    _assert_spill_parity(eng)


def test_spill_budget_eviction_under_pressure(weights):
    """Tier bytes stay within kv_spill_max_bytes under sustained
    eviction; overflow expires and is counted; outputs stay right."""
    _, tp = weights
    pnb = _port(tp, kv_spill=True).spill.page_nbytes
    eng = _port(tp, kv_spill=True, kv_spill_max_bytes=4 * pnb)
    out = _run_one(eng, _prompt(96, seed=23), 8)
    _flush(eng, count=10, seed0=9300)
    assert eng.spill.resident_bytes <= 4 * pnb
    assert eng.spill.resident_pages() <= 4
    assert eng.stats["spill_expired"] > 0
    assert eng.stats["spill_pages"] > 4
    _assert_spill_parity(eng)
    assert _run_one(_port(tp), _prompt(96, seed=23), 8) == out


def test_maybe_rewarm_promotes_hot_chain(weights):
    """The hottest spilled chain comes back into idle pool headroom
    without a request asking for it; a second call is a no-op."""
    _, tp = weights
    eng = _port(tp, kv_spill=True)
    shared = _prompt(96, seed=7)
    for i in range(3):                      # make the chain hot
        _run_one(eng, shared + _prompt(16, seed=100 + i), 2)
    _flush(eng, seed0=9400)
    hashes = eng.hash_prompt(shared)
    assert eng.cached_prefix_len(hashes) == 0
    eng.spill.policy.rewarm_free_frac = 0.0  # test the promote, not the gate
    n = eng.maybe_rewarm()
    assert n > 0
    assert eng.cached_prefix_len(hashes) > 0
    assert eng.stats["spill_promotions"] == n
    _assert_spill_parity(eng)
    assert eng.maybe_rewarm() == 0


def test_spill_teardown_engine_only(weights):
    _, tp = weights
    eng = _port(tp, kv_spill=True)
    _run_one(eng, _prompt(96, seed=29), 2)
    _flush(eng, count=4, seed0=9500)
    assert eng.spill.resident_pages() > 0
    dropped = eng.spill_teardown()
    assert dropped > 0
    assert eng.spill.resident_pages() == 0
    assert eng.spill.resident_bytes == 0
    assert eng.stats["spill_expired"] >= dropped
    _assert_spill_parity(eng)
    assert _port(tp).spill_teardown() == 0


@pytest.mark.parametrize("budget_pages", [None, 4])
def test_spill_counters_equal_reference(weights, budget_pages):
    """The same traffic (evict, revisit, re-warm, teardown) through the
    reference engine and the port: equal tokens, equal spill counters
    and prefix accounting at every stage, including spill_expired for
    pages the budget expires."""
    jp, tp = weights
    kw = {"kv_spill": True}
    if budget_pages:
        kw["kv_spill_max_bytes"] = budget_pages * _port(
            tp, kv_spill=True).spill.page_nbytes
    ref, port = _ref(jp, **kw), _port(tp, **kw)
    shared = _prompt(96, seed=7)

    def stage(fn):
        a, b = fn(ref), fn(port)
        assert a == b
        assert {k: port.stats[k] for k in SPILL_KEYS} == \
            {k: ref.stats[k] for k in SPILL_KEYS}
        assert port.prefix_accounting() == ref.prefix_accounting()

    for i in range(2):
        stage(lambda e: _run_one(e, shared + _prompt(16, seed=200 + i), 3))
    stage(lambda e: _flush(e, count=6, seed0=9600))
    stage(lambda e: _run_one(e, shared + _prompt(16, seed=300), 3))
    stage(lambda e: _flush(e, count=3, seed0=9700))

    def rewarm(e):
        e.spill.policy.rewarm_free_frac = 0.0
        return e.maybe_rewarm(max_pages=5)
    stage(rewarm)
    stage(lambda e: e.spill_teardown())
    assert port.stats["spill_demotions"] > 0
    if budget_pages:
        assert port.stats["spill_expired"] > 0
    else:
        assert port.stats["spill_promotions"] > 0


def test_cross_engine_spill_notes_equal_reference(weights):
    """note_spill_promotion / note_spill_drops (the prefix directory's
    accounting of a spilled payload another engine imported) move the
    counters and the chain table as the reference's do."""
    jp, tp = weights
    ref, port = _ref(jp, kv_spill=True), _port(tp, kv_spill=True)
    ids = _prompt(96, seed=41)
    for eng in (ref, port):
        _run_one(eng, ids, 2)
        head = eng.hash_prompt(ids)[0]
        eng.note_spill_promotion(head, 3)
        eng.note_spill_drops(2)
    assert {k: port.stats[k] for k in SPILL_KEYS} == \
        {k: ref.stats[k] for k in SPILL_KEYS}
    assert port.stats["spill_promotions"] == 3
    assert port.stats["spill_drops"] == 2
    assert port.chains.totals() == ref.chains.totals()


def test_spill_telemetry_fold(weights):
    """The rtpu_llm_prefix_spill_* counters and resident gauges carry
    the engine's prefix_accounting() (one accounting source)."""
    from ray_tpu_torch.llm import telemetry
    from ray_tpu_torch.util import metrics
    _, tp = weights
    metrics._reset_registry()
    eng = _port(tp, kv_spill=True)
    shared = _prompt(96, seed=37)
    _run_one(eng, shared, 2)
    _flush(eng, seed0=9800)
    _run_one(eng, shared, 2)        # promote
    telemetry.on_step(eng)          # ship the final stat deltas
    store = metrics.collect_store()
    acct = eng.prefix_accounting()
    assert acct["spill_demotions"] > 0 and acct["spill_promotions"] > 0
    for name, key in (("demotions", "spill_demotions"),
                      ("promotions", "spill_promotions"),
                      ("expired", "spill_expired"),
                      ("pages", "spill_pages"), ("bytes", "spill_bytes")):
        rec = store.get(f"rtpu_llm_prefix_spill_{name}_total")
        got = sum(rec["series"].values()) if rec else 0
        assert got == acct[key], name
    for name in ("resident_pages", "resident_bytes"):
        rec = store[f"rtpu_llm_prefix_spill_{name}"]
        assert list(rec["series"].values()) == [acct[f"spill_{name}"]]


def test_spill_tier_materialize_unit():
    """Staged pages packed into one payload per chain through a put
    callable (an object store's), then rebuilt by payload_for through a
    fetch; an unfetchable segment ends the run; a corrupt one is
    dropped."""
    store = {}

    class Ref:
        def __init__(self, key):
            self.key = key

        def binary(self):
            return self.key

    def put(payload):
        ref = Ref(f"seg{len(store)}".encode())
        store[ref.key] = payload
        return ref

    tier = SpillTier(max_bytes=100, page_nbytes=10)
    hs = [bytes([i]) * 16 for i in range(3)]
    for i, h in enumerate(hs):
        page = [np.full((2, 2), i, np.float32)]
        tier.add(h, 1 if i < 2 else 2, page, page)
    refs = tier.materialize(hs, page_size=2, put=put)
    assert set(refs) == set(hs) and len(store) == 2    # one per chain
    assert tier.stats()["staged_pages"] == 0
    assert tier.payload_for(hs, 2)[0] is None          # no fetch: stop
    payload, dropped = tier.payload_for(
        hs, 2, fetch=lambda ref: store[ref.binary()])
    assert dropped == [] and payload["page_hashes"] == hs
    assert [float(k[0, 0]) for k in payload["pages"][0]["k"]] == [0, 1, 2]
    store[refs[hs[2]]] = {"page_size": 4}               # corrupt segment
    payload, dropped = tier.payload_for(
        hs[2:], 2, fetch=lambda ref: store[ref.binary()])
    assert payload is None and dropped == [(hs[2], 2)]


# ------------------------------------------------------------------ #
# cluster: spill: directory entries + store promote + teardown drain
# ------------------------------------------------------------------ #

class _Handle:
    def __init__(self, actor_id=b"self"):
        self._actor_id = actor_id


@pytest.fixture
def runtimes():
    """Both packages' runtimes side by side: the engines and prefix
    clients of these cases live in this process and need only each
    head's directory and object store."""
    import ray_tpu
    import ray_tpu_torch
    for pkg in (ray_tpu, ray_tpu_torch):
        if pkg.is_initialized():
            pkg.shutdown()
    ray_tpu.init(num_cpus=1, object_store_memory=256 * 1024 * 1024)
    ray_tpu_torch.init(num_cpus=1, object_store_memory=256 * 1024 * 1024)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _sides(weights) -> dict:
    """Per package: its engine on the shared weights, its prefix client,
    its head runtime, its directory module and its put."""
    import ray_tpu
    import ray_tpu_torch
    from ray_tpu.core import directory as jdir
    from ray_tpu.core import runtime as jrt
    from ray_tpu.serve.frontdoor.prefix import PrefixDirectoryClient as JCl
    from ray_tpu_torch.core import directory as tdir
    from ray_tpu_torch.core import runtime as trt
    from ray_tpu_torch.serve.frontdoor.prefix import (
        PrefixDirectoryClient as TCl)
    jp, tp = weights
    return {
        "ref": dict(engine=lambda **kw: _ref(jp, **kw), client=JCl,
                    rt=jrt.get_runtime_if_exists(), dir=jdir,
                    put=ray_tpu.put),
        "port": dict(engine=lambda **kw: _port(tp, **kw), client=TCl,
                     rt=trt.get_runtime_if_exists(), dir=tdir,
                     put=ray_tpu_torch.put),
    }


def _spill_counts(eng) -> dict:
    return {k: eng.stats[k] for k in SPILL_KEYS}


def _cross_replica_promote(s) -> dict:
    src = s["engine"](kv_spill=True)
    src.track_page_publish = True
    dst = s["engine"](num_pages=64)
    shared = _prompt(96, seed=13)
    _run_one(src, shared, 2)
    hashes = src.hash_prompt(shared)
    assert hashes
    _flush(src, seed0=9700)
    assert src.cached_prefix_len(hashes) == 0   # NO replica holds it hot
    assert src.spill.covered_run(hashes) == len(hashes)

    ca = s["client"]("tiny-tier")
    ca.set_replica_handle(_Handle(b"replica-a"))
    ca._last_publish = -1e9
    ca.maybe_publish(src)
    spills = s["rt"].dirs.lookup_prefix("serve:prefix:tiny-tier", "spill:")
    assert set("spill:" + h.hex() for h in hashes) <= set(spills)
    val = next(iter(spills.values()))
    assert val["m"] == "tiny-tier" and isinstance(val["oid"], bytes)
    # staged -> stored flip happened: host copies freed, segments pinned
    tier = src.spill.stats()
    assert tier["staged_pages"] == 0 and tier["stored_segments"] > 0

    cb = s["client"]("tiny-tier")
    cb.set_replica_handle(_Handle(b"replica-b"))
    n = cb.maybe_import(dst, threading.Lock(), shared)
    assert n == len(hashes)
    assert dst.stats["spill_promotions"] == n
    assert dst.cached_prefix_len(hashes) == len(hashes)
    tail = shared + _prompt(16, seed=500)
    out_b = _run_one(dst, tail, 8)
    cold = s["engine"](num_pages=64)
    assert _run_one(cold, tail, 8) == out_b
    # the warm arm actually used the promoted pages
    assert dst.stats["prefix_hits"] >= n
    return {"hashes": [h.hex() for h in hashes], "spill_keys": sorted(spills),
            "tier": tier, "imported": n, "tokens": out_b,
            "src": _spill_counts(src), "dst": _spill_counts(dst),
            "src_acct": src.prefix_accounting()}


def test_cross_replica_promote_from_store(weights, runtimes):
    """Replica A demotes a prefix out of its pool entirely and publishes
    store-backed ``spill:`` entries; replica B, which never saw the
    prompt, imports it straight from the store and decodes as a cold
    prefill does. Tokens, spill keys, segments and every spill counter
    equal the reference's on the same weights."""
    sides = _sides(weights)
    ref = _cross_replica_promote(sides["ref"])
    port = _cross_replica_promote(sides["port"])
    assert port == ref


def _stale_spill_entry(s) -> dict:
    eng = s["engine"]()
    shared = _prompt(96, seed=17)
    hashes = eng.hash_prompt(shared)
    bad_ref = s["put"]({"page_size": 8, "page_hashes": [], "pages": []})
    s["dir"].update("serve:prefix:tiny-stale", put={
        "spill:" + h.hex(): {"m": "tiny-stale", "oid": bad_ref.binary()}
        for h in hashes})
    cb = s["client"]("tiny-stale")
    cb.set_replica_handle(_Handle(b"replica-b"))
    n = cb.maybe_import(eng, threading.Lock(), shared)
    assert n == 0
    assert eng.stats["spill_drops"] == len(hashes)
    assert s["rt"].dirs.lookup_prefix(
        "serve:prefix:tiny-stale", "spill:") == {}
    # the request itself: plain cold prefill, correct tokens
    out = _run_one(eng, shared, 8)
    assert _run_one(s["engine"](), shared, 8) == out
    return {"imported": n, "tokens": out, "counts": _spill_counts(eng)}


def test_stale_spill_entry_counted_drop_and_cold_prefill(weights,
                                                         runtimes):
    """``spill:`` entries pointing at a garbage store payload cost a
    counted drop and a cold prefill, never a wrong answer, and the stale
    keys leave the directory; as in the reference."""
    sides = _sides(weights)
    ref = _stale_spill_entry(sides["ref"])
    port = _stale_spill_entry(sides["port"])
    assert port == ref


def _spill_teardown_drain(s) -> dict:
    rt = s["rt"]
    eng = s["engine"](kv_spill=True)
    eng.track_page_publish = True
    base = rt.store.bytes_in_use()
    _run_one(eng, _prompt(96, seed=41), 2)
    _flush(eng, count=4, seed0=9800)
    ca = s["client"]("tiny-drain")
    ca.set_replica_handle(_Handle(b"replica-a"))
    ca._last_publish = -1e9
    ca.maybe_publish(eng)
    assert rt.store.bytes_in_use() > base
    published = rt.dirs.lookup_prefix("serve:prefix:tiny-drain", "spill:")
    assert published
    dropped = eng.spill_teardown()
    assert dropped > 0
    deadline = time.monotonic() + 5.0
    while rt.store.bytes_in_use() > base and \
            time.monotonic() < deadline:
        time.sleep(0.05)            # ref drops land asynchronously
    assert rt.store.bytes_in_use() == base
    # the retraction rides the normal publish cadence
    ca._last_publish = -1e9
    ca.maybe_publish(eng)
    assert rt.dirs.lookup_prefix("serve:prefix:tiny-drain", "spill:") == {}
    return {"published": sorted(published), "dropped": dropped,
            "counts": _spill_counts(eng)}


def test_spill_teardown_drains_store(weights, runtimes):
    """Materialized segments are store objects pinned only by the tier:
    teardown drops the refs, the store settles back to its pre-spill
    bytes, and the next publish cadence retracts the ``spill:`` entries;
    as in the reference, with the same keys and counters."""
    sides = _sides(weights)
    ref = _spill_teardown_drain(sides["ref"])
    port = _spill_teardown_drain(sides["port"])
    assert port == ref
