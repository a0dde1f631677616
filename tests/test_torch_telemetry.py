"""The port's engine telemetry against ray_tpu's, on the same traffic.

Sequential requests (one ``generate`` call each) go through the paged
engine of each package — a pool small enough to preempt, prompts that
share pages so the prefix cache hits — and then through each dense
engine, on the same converted weights (f32, CPU). Afterwards the two
packages' metric registries hold the same ``rtpu_llm_*`` series: every
counter by label, every histogram's observation count, and the
kv_utilization, prefix_cached_pages and batch_occupancy gauges; the
paged engines' ``prefix_accounting()`` and ``pool_stats()`` agree too,
and so do the flight-recorder events the paged engines emit (one
PREFIX_EVICT per eviction, a STEP_BEGIN/STEP_END pair per profiled
dispatch), counted by code in a fresh ring per package. Each registry is
reset around the test. Only sequential traffic can
agree counter for counter: concurrent submission batches by timing."""
import jax
import numpy as np
import pytest

from ray_tpu.core import flight as jax_flight
from ray_tpu.llm import EngineConfig as JaxEngineConfig
from ray_tpu.llm import InferenceEngine as JaxDense
from ray_tpu.llm import PagedEngineConfig as JaxPagedConfig
from ray_tpu.llm import PagedInferenceEngine as JaxPaged
from ray_tpu.llm import SamplingParams as JaxSP
from ray_tpu.models import llama as jllama
from ray_tpu.util import metrics as jax_metrics
from ray_tpu_torch.core import flight as port_flight
from ray_tpu_torch.llm import (EngineConfig, InferenceEngine,
                               PagedEngineConfig, PagedInferenceEngine,
                               SamplingParams)
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.util import metrics as port_metrics

SHAPE = dict(vocab_size=258, max_seq_len=512)
# 12 usable pages of 8 tokens: the 60-token prompt growing by 40 tokens
# outruns the pool (a preemption); the shared 32-token head hits
PAGED = dict(max_batch_size=2, page_size=8, num_pages=13,
             max_pages_per_seq=16, chunk_size=16, prefill_rows=2,
             decode_window=4)
DENSE = dict(max_batch_size=2, max_seq_len=128)
GAUGES = ("rtpu_llm_kv_utilization", "rtpu_llm_prefix_cached_pages",
          "rtpu_llm_batch_occupancy")


def _traffic():
    rng = np.random.RandomState(3)
    ids = lambda n: [int(t) for t in rng.randint(1, 250, n)]  # noqa: E731
    shared = ids(32)
    return [(shared + ids(9), 6), (ids(21), 5), (shared + ids(14), 7),
            (ids(60), 40), (shared + ids(3), 4), (ids(5), 3)]


@pytest.fixture
def registries():
    jax_metrics._reset_registry()
    port_metrics._reset_registry()
    yield
    jax_metrics._reset_registry()
    port_metrics._reset_registry()


def _series(store: dict) -> dict:
    """{name: {labels: value}} for counters and gauges, histograms as
    {labels: observation count}, rtpu_llm_* only; the per-chain heat
    gauges ship on a wall-clock rate limit, so they are left out."""
    out = {}
    for name, rec in store.items():
        if not name.startswith("rtpu_llm_") or "_chain_" in name:
            continue
        if rec["kind"] == "histogram":
            out[name] = {tuple(kv for kv in key if kv[0] != "le"): val
                         for key, val in rec["series"].items()
                         if ("le", "+Inf") in key}
        else:
            out[name] = dict(rec["series"])
    return out


def _codes(ring, flight) -> dict:
    out = {}
    for rec in flight.decode(bytes(ring.buf)):
        out[rec[1]] = out.get(rec[1], 0) + 1
    return out


def test_telemetry_series_match_reference(registries):
    rings = (jax_flight.install_for_test(1 << 14),
             port_flight.install_for_test(1 << 14))
    jax_paged = JaxPaged(JaxPagedConfig(model=jllama.llama_tiny(**SHAPE),
                                        **PAGED), rng_seed=0)
    mc = tllama.llama_tiny(**SHAPE)
    params = params_from_numpy(jax.tree.map(np.asarray, jax_paged.params),
                               mc, device="cpu")
    port_paged = PagedInferenceEngine(PagedEngineConfig(model=mc, **PAGED),
                                      params=params, device="cpu")
    for prompt, n in _traffic():
        a = jax_paged.generate([prompt], JaxSP(max_tokens=n))[0]
        b = port_paged.generate([prompt], SamplingParams(max_tokens=n))[0]
        assert b["token_ids"] == a["token_ids"]
    assert port_paged.stats["prefix_hits"] > 0
    assert port_paged.prefix_accounting() == jax_paged.prefix_accounting()
    a, b = jax_paged.pool_stats(), port_paged.pool_stats()
    assert set(b) <= set(a)
    assert b == {k: a[k] for k in b}
    a, b = _codes(rings[0], jax_flight), _codes(rings[1], port_flight)
    evictions = port_paged.stats["prefix_evictions"]
    assert evictions > 0
    assert b[port_flight.PREFIX_EVICT] == a[jax_flight.PREFIX_EVICT] == \
        evictions
    prof = port_paged.profile_summary()
    assert b[port_flight.STEP_BEGIN] == b[port_flight.STEP_END] == \
        prof["compiles"] + prof["steps"]
    assert a[jax_flight.STEP_BEGIN] == b[port_flight.STEP_BEGIN]
    paged = _series(port_metrics.local_store())
    assert paged == _series(jax_metrics.local_store())
    assert paged["rtpu_llm_preemptions_total"] == \
        {(("engine", "paged"),): 1.0}

    jax_dense = JaxDense(JaxEngineConfig(model=jllama.llama_tiny(**SHAPE),
                                         **DENSE), params=jax_paged.params)
    port_dense = InferenceEngine(EngineConfig(model=mc, **DENSE),
                                 params=params, device="cpu")
    for prompt, n in _traffic()[:3]:
        a = jax_dense.generate([prompt], JaxSP(max_tokens=n))[0]
        b = port_dense.generate([prompt], SamplingParams(max_tokens=n))[0]
        assert b["token_ids"] == a["token_ids"]
    want = _series(jax_metrics.local_store())
    got = _series(port_metrics.local_store())
    assert set(GAUGES) <= set(got)
    assert got == want
    # both engine kinds reported, and every histogram counted each
    # request exactly once per kind
    n_paged, n_dense = len(_traffic()), 3
    for hist in ("rtpu_llm_ttft_seconds", "rtpu_llm_e2e_seconds",
                 "rtpu_llm_queue_wait_seconds"):
        assert got[hist] == {(("engine", "paged"),): float(n_paged),
                             (("engine", "dense"),): float(n_dense)}, hist
    assert got["rtpu_llm_requests_total"][
        (("engine", "paged"), ("finish", "other"))] == 1.0
