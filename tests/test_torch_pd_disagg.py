"""Prefill/decode disaggregation in process: the port's
``ray_tpu_torch.llm.pd_disagg`` replicas against ray_tpu's, on the same
weights (the reference's params through ``params_from_numpy``), f32 on
the CPU.

The cases of ``tests/test_pd_disagg.py`` and the fast ones of
``tests/test_pd_streaming.py`` at the replica level, then what the port
adds:

- A ``PrefillReplica`` into a ``DecodeReplica`` gives the greedy tokens
  of the reference's single engine and of the reference's own replica
  pair, through ``decode``, ``start``/``poll``/``wait`` and
  ``decode_stream``; logprobs within 1e-4 of the reference replicas'.
- A payload crosses packages in both directions with the same tokens.
- ``warmup(families=...)`` builds exactly the reference's keys per
  family set, and the default keys are the unnarrowed ones.
- A page-size mismatch raises; a decode replica recycles its slots and
  pages over many imports.
- Concurrent prefills on one replica (the calls Serve runs at once)
  give the payloads of serial ones: the replica steps its engine under
  a lock.
- ``gpus_per_replica`` must be a whole number of devices, and lands in
  both role groups' actor options.
"""
import threading

import jax
import numpy as np
import pytest

from ray_tpu.llm import SamplingParams as JaxSP
from ray_tpu.llm import pd_disagg as jpd
from ray_tpu.llm.paged_engine import PagedEngineConfig as JaxConfig
from ray_tpu.llm.paged_engine import PagedInferenceEngine as JaxEngine
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import (PagedEngineConfig, PagedInferenceEngine,
                               SamplingParams)
from ray_tpu_torch.llm import pd_disagg as tpd
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy

SHAPE = dict(vocab_size=258, max_seq_len=256)
ECFG = dict(max_batch_size=4, page_size=8, num_pages=128,
            max_pages_per_seq=16, chunk_size=16)
MAX_TOKENS = 12


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init(jax.random.PRNGKey(0), jllama.llama_tiny(**SHAPE))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp),
                           tllama.llama_tiny(**SHAPE), device="cpu")
    return jp, tp


def _tcfg(**kw):
    return PagedEngineConfig(model=tllama.llama_tiny(**SHAPE),
                             **{**ECFG, **kw})


def _jcfg(**kw):
    return JaxConfig(model=jllama.llama_tiny(**SHAPE), **{**ECFG, **kw})


def _prompt(n, seed=0):
    return [int(t) for t in np.random.RandomState(seed).randint(1, 257, n)]


def _sp(logprobs=0):
    return SamplingParams(max_tokens=MAX_TOKENS, logprobs=logprobs)


def _jsp(logprobs=0):
    return JaxSP(max_tokens=MAX_TOKENS, logprobs=logprobs)


def _pre(tp, **kw):
    return tpd.PrefillReplica(_tcfg(**kw), tp, warmup=False, device="cpu")


def _dec(tp, **kw):
    return tpd.DecodeReplica(_tcfg(**kw), tp, warmup=False, device="cpu")


def _stop(*replicas):
    for r in replicas:
        r._stop = True
        r._wake.set()
        r._thread.join(timeout=30)


PROMPTS = [_prompt(37), _prompt(21, 1), _prompt(9, 2)]


@pytest.fixture(scope="module")
def reference(weights):
    """The reference's greedy tokens: its single engine, and its own
    replica pair (tokens and logprobs)."""
    jp, _ = weights
    single = JaxEngine(_jcfg(), params=jp)
    whole = [single.generate([p], _jsp())[0]["token_ids"] for p in PROMPTS]
    pre = jpd.PrefillReplica(_jcfg(), jp, warmup=False)
    dec = jpd.DecodeReplica(_jcfg(), jp, warmup=False)
    try:
        pd = [dec.decode(pre.prefill(p, _jsp(1)), _jsp(1))
              for p in PROMPTS]
    finally:
        _stop(dec)
    return whole, [o["token_ids"] for o in pd], [o["logprobs"] for o in pd]


def test_replicas_give_the_reference_tokens(weights, reference):
    """decode(), start/poll/wait and decode_stream on the port's pair
    all give the reference's single-engine and replica-pair tokens."""
    _, tp = weights
    whole, pair, logps = reference
    assert pair == whole
    pre, dec = _pre(tp), _dec(tp)
    try:
        for i, p in enumerate(PROMPTS):
            out = dec.decode(pre.prefill(p, _sp(1)), _sp(1))
            assert out["token_ids"] == whole[i]
            np.testing.assert_allclose(out["logprobs"], logps[i],
                                       atol=1e-4)
            rid = dec.start(pre.prefill(p, _sp()), _sp())
            polls = []
            while True:
                st = dec.poll(rid)
                polls.append(st["n_tokens"])
                if st["done"]:
                    break
            assert st["finish_reason"] in ("length", "stop")
            assert st["prompt_tokens"] == len(p)
            assert polls == sorted(polls) and polls[-1] == len(whole[i])
            rid = dec.start(pre.prefill(p, _sp()), _sp())
            assert dec.wait(rid)["token_ids"] == whole[i]
            chunks = list(dec.decode_stream(pre.prefill(p, _sp()), _sp()))
            assert chunks[-1]["done"] and \
                chunks[-1]["n_tokens"] == len(whole[i])
            assert [c["n_tokens"] for c in chunks] == \
                sorted({c["n_tokens"] for c in chunks})
        assert dec._reqs == {}
        assert dec.check_health() and pre.check_health()
    finally:
        _stop(dec)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_payload_crosses_packages(weights, reference, direction):
    """A reference PrefillReplica's payload decoded by the port's
    DecodeReplica, and the reverse: the single engine's tokens."""
    jp, tp = weights
    whole = reference[0]
    if direction == "ref_to_port":
        pre, dec = jpd.PrefillReplica(_jcfg(), jp, warmup=False), _dec(tp)
        sp = _sp()
    else:
        pre, dec = _pre(tp), jpd.DecodeReplica(_jcfg(), jp, warmup=False)
        sp = _jsp()
    try:
        for i, p in enumerate(PROMPTS):
            assert dec.decode(pre.prefill(p, sp), sp)["token_ids"] == \
                whole[i]
    finally:
        _stop(dec)


WARM = dict(max_batch_size=3, page_size=8, num_pages=64,
            max_pages_per_seq=16, chunk_size=16, prefill_rows=2,
            decode_window=4, spec_tokens=4, page_buckets="on")
FAMILY_SETS = [("prefill",), ("decode", "verify"), ("verify",)]


@pytest.mark.parametrize("families", FAMILY_SETS,
                         ids=["-".join(f) for f in FAMILY_SETS])
def test_warmup_families_build_the_reference_keys(weights, families):
    jp, tp = weights
    modes = ((False, False),)
    ref = JaxEngine(_jcfg(**WARM), params=jp)
    ref.warmup(sample_modes=modes, families=families)
    port = PagedInferenceEngine(_tcfg(**WARM), params=tp, device="cpu")
    port.warmup(sample_modes=modes, families=families)
    assert port.profiler._seen == ref.profiler._seen
    assert {k for k, _ in port.profiler._seen} == set(families)
    assert port.profiler.compiles == ref.profiler.compiles == \
        len(port._warmup_keys(modes, families))
    # the default is every family, keys unchanged
    assert port._warmup_keys(modes) == \
        port._warmup_keys(modes, ("prefill", "decode", "verify"))


def test_replica_warms_only_its_own_side(weights):
    _, tp = weights
    pre = tpd.PrefillReplica(_tcfg(**WARM), tp, device="cpu")
    dec = tpd.DecodeReplica(_tcfg(**WARM), tp, device="cpu")
    try:
        assert {k for k, _ in pre.engine.profiler._seen} == {"prefill"}
        assert {k for k, _ in dec.engine.profiler._seen} == \
            {"decode", "verify"}
    finally:
        _stop(dec)


def test_import_rejects_page_size_mismatch(weights):
    _, tp = weights
    pre, dec = _pre(tp), _dec(tp)
    try:
        payload = pre.prefill(_prompt(10), _sp())
        payload["page_size"] = 4
        with pytest.raises(ValueError, match="page_size"):
            dec.decode(payload, _sp())
    finally:
        _stop(dec)


def test_decode_replica_recycles_slots_and_pages(weights, reference):
    """More imports than slots, one after another: every slot and page
    comes back (cached prefix pages count as allocatable)."""
    _, tp = weights
    pre, dec = _pre(tp), _dec(tp)
    try:
        for rnd in range(2):
            for i, p in enumerate(PROMPTS):
                out = dec.decode(pre.prefill(p, _sp()), _sp())
                assert out["token_ids"] == reference[0][i]
        for eng in (pre.engine, dec.engine):
            st = eng.pool_stats()
            assert st["active"] == st["prefilling"] == st["pending"] == 0
            assert st["free_pages"] + st["cached_pages"] == \
                ECFG["num_pages"] - 1
        assert len(dec.engine._free_slots) == ECFG["max_batch_size"]
    finally:
        _stop(dec)


def test_concurrent_prefills_equal_serial_ones(weights):
    """Six prefills from six threads at once on one replica (as
    Serve runs a replica's calls) give the payloads one replica gives
    them in turn: same ids, first tokens and hashes, and every position
    of the prompt within f32 1e-5 in every page (concurrent prompts
    share row buckets). Positions past the prompt in the tail page hold
    whatever the pool page held; the decode side writes them."""
    _, tp = weights
    prompts = [_prompt(13 + 7 * i, 10 + i) for i in range(6)]
    serial = [_pre(tp, enable_prefix_caching=False).prefill(p, _sp())
              for p in prompts]
    pre = _pre(tp, enable_prefix_caching=False)
    out, errors = [None] * len(prompts), []
    barrier = threading.Barrier(len(prompts))

    def run(i):
        try:
            barrier.wait()
            out[i] = pre.prefill(prompts[i], _sp())
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and all(o is not None for o in out), errors
    for got, want in zip(out, serial):
        for key in ("prompt_ids", "first_token", "page_size",
                    "page_hashes"):
            assert got[key] == want[key]
        n = len(got["prompt_ids"])
        assert len(got["pages"]) == len(want["pages"])
        for lg, lw in zip(got["pages"], want["pages"]):
            for kv in ("k", "v"):
                g, w = (np.asarray(x).reshape(-1, *np.shape(x)[2:])
                        for x in (lg[kv], lw[kv]))
                assert g.shape == w.shape
                np.testing.assert_allclose(g[:n], w[:n], atol=1e-5)
    st = pre.engine.pool_stats()
    assert st["active"] == st["prefilling"] == st["pending"] == 0
    assert st["free_pages"] == ECFG["num_pages"] - 1


@pytest.mark.parametrize("n", [0.5, -1, True, "1.5"])
def test_gpus_per_replica_must_be_whole(n):
    with pytest.raises((ValueError, TypeError)):
        tpd.build_pd_openai_app("m", 1, 1, _tcfg(), device="cpu",
                                gpus_per_replica=n)
    with pytest.raises((ValueError, TypeError)):
        tpd.build_pd_proxy(1, 1, _tcfg(), device="cpu",
                           gpus_per_replica=n)


@pytest.mark.parametrize("n,want", [(1, {"num_gpus": 1}),
                                    (2, {"num_gpus": 2}), (2.0, {"num_gpus": 2}),
                                    (0, {})])
def test_gpus_per_replica_lands_in_both_role_groups(n, want):
    app = tpd.build_pd_openai_app("m", 2, 1, _tcfg(), device="cpu",
                                  gpus_per_replica=n)
    (pd,) = app.ingress.children()
    pre, dec = pd.children()
    assert (pre.spec.role, dec.spec.role) == ("prefill", "decode")
    assert (pre.spec.num_replicas, dec.spec.num_replicas) == (2, 1)
    for role in (pre, dec):
        assert role.spec.ray_actor_options == want
        assert role.spec.init_kwargs["device"] == "cpu"
    assert pd.spec.ray_actor_options == {}


def test_replica_asks_for_the_card_by_default(weights):
    """No device argument: the replica builds on CUDA, which this
    machine lacks, and raises instead of moving to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, tp = weights
    for cls in (tpd.PrefillReplica, tpd.DecodeReplica):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(_tcfg(), tp)
