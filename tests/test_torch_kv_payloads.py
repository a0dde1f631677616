"""KV payloads across packages: prefill/decode export and import
(``prefill_export`` / ``import_prefill``) and cross-engine prefix
export and import (``export_prefix`` / ``import_prefix``), between the
port's PagedInferenceEngine and ray_tpu's on the same weights.

Payloads are host numpy arrays per layer, ``[n, page, KVH, D]``; f32
here, where both packages use numpy float32. Pages moved from one
engine to another compare bitwise (import, then re-export), and greedy
tokens exactly. Pages each package computes itself for the same prompt
agree within atol 1e-5 (the same f32 K/V summed in another order by
XLA and by PyTorch: a few ulps, ~2e-7 measured), with equal hashes,
shapes and dtypes. bf16 payloads round-trip within the port as raw
16-bit patterns (``np.uint16``), and the reference's ``ml_dtypes``
bfloat16 arrays read through the same view.
"""
import jax
import ml_dtypes
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

SHAPE = dict(vocab_size=258, max_seq_len=256)
ECFG = dict(max_batch_size=4, page_size=8, num_pages=64,
            max_pages_per_seq=24, chunk_size=16)
MAX_TOKENS = 10


@pytest.fixture(scope="module")
def weights():
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
    return [int(t) for t in np.random.RandomState(seed).randint(1, 257, n)]


def _sp(eng):
    return (JaxSamplingParams if isinstance(eng, JaxEngine)
            else SamplingParams)(max_tokens=MAX_TOKENS)


def _decode(eng, payload):
    req = eng.import_prefill(payload, _sp(eng))
    eng.run_until_done([req])
    return eng._result(req)["token_ids"]


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_pd_across_packages_gives_single_engine_tokens(weights, direction):
    """Prefill on one package, decode on the other: the greedy tokens of
    one engine serving the request whole, in both directions; the
    prefill engine's pool is free again afterwards."""
    jp, tp = weights
    prompt = _prompt(37)                  # several chunks and pages
    single = _port(tp).generate([prompt], SamplingParams(
        max_tokens=MAX_TOKENS))[0]["token_ids"]
    assert _ref(jp).generate([prompt], JaxSamplingParams(
        max_tokens=MAX_TOKENS))[0]["token_ids"] == single
    pre, dec = ((_ref(jp), _port(tp)) if direction == "ref_to_port"
                else (_port(tp), _ref(jp)))
    payload = pre.prefill_export(prompt, _sp(pre))
    assert payload["first_token"] == single[0]
    assert len(payload["pages"]) == 2        # layers
    assert payload["pages"][0]["k"].dtype == np.float32
    st = pre.pool_stats()
    assert st["active"] == 0
    assert st["free_pages"] + st["cached_pages"] == ECFG["num_pages"] - 1
    assert _decode(dec, payload) == single


def test_pd_payloads_equal_across_packages(weights):
    """The port's prefill export equals the reference's: prompt, first
    token, hashes, salt exactly; every page's layout exactly and its
    values within f32 atol 1e-5 (each package computed its own)."""
    jp, tp = weights
    prompt = _prompt(29, seed=3)
    a = _ref(jp).prefill_export(prompt, JaxSamplingParams(max_tokens=4))
    b = _port(tp).prefill_export(prompt, SamplingParams(max_tokens=4))
    for k in ("prompt_ids", "first_token", "page_size", "page_hashes",
              "prefix_salt"):
        assert b[k] == a[k], k
    _pages_close(a["pages"], b["pages"])


def _pages_close(want, got):
    assert len(got) == len(want)
    for la, lb in zip(want, got):
        for kv in ("k", "v"):
            assert lb[kv].shape == la[kv].shape
            assert lb[kv].dtype == la[kv].dtype
            np.testing.assert_allclose(lb[kv], la[kv], atol=1e-5, rtol=0)


def test_pd_import_dedupes_cached_pages(weights):
    """A decode engine importing a prefix it already holds maps the
    pages instead of copying them; both sequences decode right."""
    _, tp = weights
    prompt = _prompt(37, seed=4)
    expected = _port(tp).generate([prompt], SamplingParams(
        max_tokens=MAX_TOKENS))[0]["token_ids"]
    pre, dec = _port(tp), _port(tp)
    payload = pre.prefill_export(prompt, _sp(pre))
    n_full = 37 // ECFG["page_size"]
    assert len(payload["page_hashes"]) == n_full
    r1 = dec.import_prefill(payload, _sp(dec))
    assert dec.pool_stats()["prefix_hits"] == 0
    r2 = dec.import_prefill(pre.prefill_export(prompt, _sp(pre)), _sp(dec))
    assert dec.pool_stats()["prefix_hits"] == n_full
    assert r1.pages[:n_full] == r2.pages[:n_full]
    assert r1.pages[n_full:] != r2.pages[n_full:]
    dec.run_until_done([r1, r2])
    assert dec._result(r1)["token_ids"] == expected
    assert dec._result(r2)["token_ids"] == expected
    assert pre.pool_stats()["prefix_tokens_saved"] > 0


def test_export_prefix_pages_equal_reference(weights):
    """The same prompt cached in both packages exports the same hashes
    and the same pages (layout exactly, values within f32 atol 1e-5);
    a page moved from the reference into the port exports bitwise what
    the reference exported; unknown hashes export None."""
    jp, tp = weights
    prompt = list(range(1, 70))
    ref, port = _ref(jp), _port(tp)
    for eng in (ref, port):
        eng.generate([prompt], _sp(eng))
    hashes = port.hash_prompt(prompt)
    assert hashes == ref.hash_prompt(prompt)
    a, b = ref.export_prefix(hashes), port.export_prefix(hashes)
    assert b["page_hashes"] == a["page_hashes"] == hashes
    _pages_close(a["pages"], b["pages"])
    assert port.stats["prefix_exported_pages"] == \
        ref.stats["prefix_exported_pages"] == len(hashes)
    moved = _port(tp)
    assert moved.import_prefix(a) == len(hashes)
    for la, lb in zip(a["pages"], moved.export_prefix(hashes)["pages"]):
        assert np.array_equal(lb["k"], la["k"])
        assert np.array_equal(lb["v"], la["v"])
    assert port.export_prefix([b"\x00" * 16]) is None


@pytest.mark.parametrize("source", ["ref", "port"])
def test_import_prefix_then_reexport_bitwise(weights, source):
    """import_prefix registers exactly the exporter's bytes (re-export
    is bitwise equal), a re-import is a no-op, generation over imported
    pages equals cold generation, and the counters equal the reference
    engine's doing the same import."""
    jp, tp = weights
    prompt = list(range(1, 70))
    src = _ref(jp) if source == "ref" else _port(tp)
    src.generate([prompt], _sp(src))
    hashes = src.hash_prompt(prompt)
    payload = src.export_prefix(hashes)
    port, ref = _port(tp), _ref(jp)
    n = port.import_prefix(payload)
    assert n == len(hashes) == ref.import_prefix(payload)
    assert port.cached_prefix_len(hashes) == len(hashes)
    chk = port.export_prefix(hashes)
    ref.export_prefix(hashes)
    for la, lb in zip(payload["pages"], chk["pages"]):
        assert np.array_equal(la["k"], lb["k"])
        assert np.array_equal(la["v"], lb["v"])
    assert port.import_prefix(payload) == 0
    out = port.generate([prompt], _sp(port))[0]["token_ids"]
    assert out == _port(tp).generate([prompt], _sp(port))[0]["token_ids"]
    ref.generate([prompt], _sp(ref))
    assert port.stats["prefix_imported_pages"] == len(hashes)
    for k in ("prefix_imported_pages", "prefix_hits", "prefix_misses",
              "prefix_tokens_saved"):
        assert port.stats[k] == ref.stats[k], k
    a, b = ref.chain_stats_report(), port.chain_stats_report()
    assert b["totals"] == a["totals"]
    drop = ("last_hit_age_s",)         # wall-clock ages differ
    assert [{k: v for k, v in c.items() if k not in drop}
            for c in b["chains"]] == \
        [{k: v for k, v in c.items() if k not in drop} for c in a["chains"]]


def test_import_prefix_keeps_the_reserve(weights):
    """Imports stop once the pool would fall below reserve_pages
    allocatable pages, as the reference's do."""
    jp, tp = weights
    prompt = list(range(1, 70))
    src = _port(tp)
    src.generate([prompt], _sp(src))
    payload = src.export_prefix(src.hash_prompt(prompt))
    for reserve in (ECFG["num_pages"] - 3, ECFG["num_pages"] + 5):
        port, ref = _port(tp), _ref(jp)
        got = port.import_prefix(payload, reserve_pages=reserve)
        assert got == ref.import_prefix(payload, reserve_pages=reserve)
        assert got == max(0, min(len(payload["page_hashes"]),
                                 ECFG["num_pages"] - 1 - reserve))


def test_page_size_mismatch_raises(weights):
    jp, tp = weights
    pre = _ref(jp)
    payload = pre.prefill_export(_prompt(10), _sp(pre))
    payload["page_size"] = 4
    with pytest.raises(ValueError, match="page_size"):
        _port(tp).import_prefill(payload, SamplingParams())
    src = _port(tp)
    src.generate([list(range(1, 70))], _sp(src))
    prefix = src.export_prefix(src.hash_prompt(list(range(1, 70))))
    prefix["page_size"] = 16
    with pytest.raises(ValueError, match="page_size"):
        _port(tp).import_prefix(prefix)


def test_bf16_payloads_round_trip():
    """bf16 pages export as raw 16-bit patterns (np.uint16) and import
    back bitwise; a reference-style ml_dtypes bfloat16 array reads
    through the same view, and a float32 array into a bf16 pool is
    refused."""
    mc = tllama.llama_tiny(**SHAPE, dtype=torch.bfloat16)
    params = tllama.init(mc, seed=2, device="cpu")

    def eng():
        return PagedInferenceEngine(PagedEngineConfig(model=mc, **ECFG),
                                    params=params, device="cpu")
    prompt = list(range(3, 60))
    src = eng()
    src.generate([prompt], SamplingParams(max_tokens=3))
    hashes = src.hash_prompt(prompt)
    payload = src.export_prefix(hashes)
    assert payload["pages"][0]["k"].dtype == np.uint16
    dst = eng()
    assert dst.import_prefix(payload) == len(hashes)
    back = dst.export_prefix(hashes)
    for la, lb in zip(payload["pages"], back["pages"]):
        assert np.array_equal(la["k"], lb["k"])
        assert np.array_equal(la["v"], lb["v"])
    as_ml = {"page_size": payload["page_size"],
             "page_hashes": payload["page_hashes"],
             "pages": [{kv: layer[kv].view(ml_dtypes.bfloat16)
                        for kv in ("k", "v")}
                       for layer in payload["pages"]]}
    third = eng()
    assert third.import_prefix(as_ml) == len(hashes)
    for la, lb in zip(payload["pages"],
                      third.export_prefix(hashes)["pages"]):
        assert np.array_equal(la["k"], lb["k"])
    wrong = {**payload, "pages": [
        {kv: layer[kv].view(ml_dtypes.bfloat16).astype(np.float32)
         for kv in ("k", "v")} for layer in payload["pages"]]}
    with pytest.raises(TypeError, match="bf16"):
        eng().import_prefix(wrong)
    # PD in bf16: the decode engine gives the single engine's tokens
    single = eng().generate([prompt], SamplingParams(max_tokens=6))[0]
    pre, dec = eng(), eng()
    pd = pre.prefill_export(prompt, SamplingParams(max_tokens=6))
    req = dec.import_prefill(pd, SamplingParams(max_tokens=6))
    dec.run_until_done([req])
    assert dec._result(req)["token_ids"] == single["token_ids"]


def test_directory_delta_tracks_publish_and_evict(weights):
    """With track_page_publish on, drain_directory_delta nets published
    and evicted hashes against the cache, as the reference's does."""
    jp, tp = weights
    port, ref = _port(tp, num_pages=24), _ref(jp, num_pages=24)
    for eng in (port, ref):
        eng.track_page_publish = True
    deltas = []
    for eng in (ref, port):
        got = []
        for seed in range(4):
            eng.generate([_prompt(60, seed=40 + seed)], _sp(eng))
            got.append(eng.drain_directory_delta())
        deltas.append(got)
    assert deltas[1] == deltas[0]
    assert any(new for new, _ in deltas[1])
    assert any(dropped for _, dropped in deltas[1])
    assert port.drain_directory_delta() == ((), ())
