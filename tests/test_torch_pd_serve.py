"""Prefill/decode disaggregation over the port's runtime and cluster
Serve: ``ray_tpu_torch.llm.pd_disagg`` replicas as actors on fake GPUs,
their KV ring handoff, ``build_pd_proxy`` and ``build_pd_openai_app``
behind the HTTP proxy, against ray_tpu's greedy tokens on the same
weights (f32, CPU).

The scenarios of ``tests/test_pd_disagg.py``
(``TestSealedChannelHandoff``, ``test_proxy_end_to_end``,
``test_proxy_chan_vs_actor_equivalence``) and
``tests/test_pd_streaming.py`` (``test_deployment_role_spec``,
``test_serve_channel_pd_completions``, the SSE half of
``test_pd_streams_through_http_proxy``), with what the port adds:

- every replica asks for one whole GPU and sees its leased index;
- the store is back at its count after ``close_kv_channel`` returns,
  and after ``serve.shutdown()`` of a paired app (the controller closes
  the rings before it kills the replicas);
- the channel counters count one write and one import per unary
  request.

One runtime serves the module (``num_cpus=2``, two fake GPUs: indices
are counted, never probed). HTTP ports are never fixed. Replica classes
are the package's, so workers import ``ray_tpu_torch`` only.
"""
import gc
import json
import socket
import time
import urllib.request

import jax
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu.llm import SamplingParams as JaxSP
from ray_tpu.llm.paged_engine import PagedEngineConfig as JaxConfig
from ray_tpu.llm.paged_engine import PagedInferenceEngine as JaxEngine
from ray_tpu.models import llama as jllama
from ray_tpu_torch import serve
from ray_tpu_torch.llm import PagedEngineConfig, SamplingParams
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


def _tcfg():
    return PagedEngineConfig(model=tllama.llama_tiny(**SHAPE), **ECFG)


def _ids(n, seed):
    return [int(t) for t in np.random.RandomState(seed).randint(1, 257, n)]


def _text(n, seed):
    return "".join(chr(c) for c in
                   np.random.RandomState(seed).randint(97, 122, (n,)))


PROMPTS = [_ids(29, 0), _ids(17, 1), _ids(40, 2)]
TEXTS = [_text(20, 3), _text(33, 4)]


@pytest.fixture(scope="module")
def reference(weights):
    """The reference engine's greedy tokens for PROMPTS and its
    completion text for TEXTS."""
    jp, _ = weights
    eng = JaxEngine(JaxConfig(model=jllama.llama_tiny(**SHAPE), **ECFG),
                    params=jp)
    sp = JaxSP(max_tokens=MAX_TOKENS)
    ids = [eng.generate([p], sp)[0]["token_ids"] for p in PROMPTS]
    texts = [eng.generate([eng.tokenizer.encode(t)], sp)[0]["text"]
             for t in TEXTS]
    return ids, texts


@pytest.fixture(scope="module")
def runtime():
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=2, num_gpus=2, object_store_memory=256 * 1024 * 1024)
    yield rt
    serve.shutdown()
    rt.shutdown()


def _store():
    from ray_tpu_torch.core import runtime as rt_mod
    return rt_mod.get_runtime_if_exists().store


def _quiesce(store, budget=10.0) -> int:
    """A stable store-object count: unchanged for one second."""
    deadline = time.monotonic() + budget
    last, since = store.num_objects(), time.monotonic()
    while time.monotonic() < deadline:
        gc.collect()
        n = store.num_objects()
        if n != last:
            last, since = n, time.monotonic()
        elif time.monotonic() - since > 1.0:
            break
        time.sleep(0.1)
    return last


def _back_to(store, base, budget=20.0) -> int:
    """The store's count once it is at or below ``base`` (or after the
    budget)."""
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        gc.collect()
        if store.num_objects() <= base:
            break
        time.sleep(0.1)
    return store.num_objects()


def _gpus_back(want=2.0, budget=30.0):
    deadline = time.monotonic() + budget
    while rt.available_resources().get("GPU") != want:
        assert time.monotonic() < deadline, rt.available_resources()
        time.sleep(0.1)


def _chan_counts() -> dict:
    """The rtpu_llm_pd_chan_* counters merged in the head's store."""
    from ray_tpu_torch.util import metrics as um
    store = um.collect_store()
    out = {}
    for name in ("kv_writes", "kv_imports", "results", "credit_stalls"):
        series = (store.get(f"rtpu_llm_pd_chan_{name}_total") or {}).get(
            "series", {})
        out[name] = sum(series.values())
    return out


def _sp():
    return SamplingParams(max_tokens=MAX_TOKENS)


def test_kv_ring_between_replica_actors(runtime, weights, reference):
    """open_kv_channel -> connect_kv_channel -> prefill_chan -> wait_cid:
    the reference's tokens; each replica on its own GPU; after
    close_kv_channel returns, the store is back at its count."""
    _, tp = weights
    Pre = rt.remote(tpd.PrefillReplica).options(num_gpus=1)
    Dec = rt.remote(tpd.DecodeReplica).options(num_gpus=1)
    pre = Pre.remote(_tcfg(), tp, device="cpu")
    dec = Dec.remote(_tcfg(), tp, device="cpu")
    try:
        assert rt.get([pre.check_health.remote(), dec.check_health.remote()],
                      timeout=300) == [True, True]
        seen = rt.get([a._exec(lambda _i: __import__("os").environ.get(
            "CUDA_VISIBLE_DEVICES")) for a in (pre, dec)], timeout=60)
        assert sorted(seen) == ["0", "1"]
        assert rt.available_resources().get("GPU") == 0.0
        store = _store()
        base = _quiesce(store)
        spec = rt.get(dec.open_kv_channel.remote(4, None), timeout=60)
        assert spec, "no shared store: the ring cannot engage"
        assert rt.get(pre.connect_kv_channel.remote(spec), timeout=60)
        assert rt.get(pre.has_kv_channel.remote(), timeout=60)
        for i, p in enumerate(PROMPTS):
            assert rt.get(pre.prefill_chan.remote(p, f"c{i}", _sp()),
                          timeout=300) == f"c{i}"
        outs = [rt.get(dec.wait_cid.remote(f"c{i}"), timeout=300)
                for i in range(len(PROMPTS))]
        assert [o["token_ids"] for o in outs] == reference[0]
        rt.get(pre.close_kv_channel.remote(), timeout=60)
        assert not rt.get(pre.has_kv_channel.remote(), timeout=60)
        assert _back_to(store, base, budget=2.0) <= base
    finally:
        rt.kill(pre)
        rt.kill(dec)
    _gpus_back()


def _proxy_replicas(proxy):
    return rt.get(proxy._exec(lambda p: p.prefill + p.decode), timeout=60)


def test_pd_proxy_with_and_without_channels(runtime, weights, reference):
    """build_pd_proxy: the same tokens over the actor-call handoff and
    over the rings; the channel arm's rings close back to the store's
    count."""
    _, tp = weights
    store = _store()
    for use_channels in (False, True):
        proxy = tpd.build_pd_proxy(1, 1, _tcfg(), params=tp,
                                   use_channels=use_channels, device="cpu")
        replicas = _proxy_replicas(proxy)
        try:
            rt.get([r.check_health.remote() for r in replicas], timeout=300)
            base = _quiesce(store)
            outs = rt.get([proxy.generate.remote(p, _sp())
                           for p in PROMPTS], timeout=300)
            assert [o["token_ids"] for o in outs] == reference[0]
            st = rt.get(proxy.proxy_stats.remote(), timeout=60)
            assert st["requests"] == len(PROMPTS)
            assert st["channels"] is use_channels
            if use_channels:
                rt.get(proxy.shutdown_channels.remote(), timeout=60)
            assert _back_to(store, base) <= base
        finally:
            for a in (proxy, *replicas):
                rt.kill(a)
        _gpus_back()


def test_deployment_role_spec():
    """role= threads through deployment()/options() — the tag the
    controller's pairing keys on."""
    class R:
        pass

    d = serve.deployment(R, name="r", role="prefill")
    assert d._spec.role == "prefill"
    assert d.options(role="decode")._spec.role == "decode"
    assert d.options(num_replicas=2)._spec.role == "prefill"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, body, timeout=300):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/pdc/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def test_pd_openai_app_under_cluster_serve(runtime, weights, reference):
    """The controller pairs the role groups; unary completions take the
    ring (one KV write and one import each) and an SSE stream the ref
    path, all with the reference's text; serve.shutdown() gives both
    GPUs back and leaves the store at its pre-deploy count."""
    from ray_tpu_torch.serve.api import CONTROLLER_NAME
    _, tp = weights
    store = _store()
    base = _quiesce(store)
    before = _chan_counts()
    app = tpd.build_pd_openai_app("pd-tiny", n_prefill=1, n_decode=1,
                                  engine_cfg=_tcfg(), params=tp,
                                  use_channels=True, device="cpu")
    for _ in range(5):
        port = _free_port()
        try:
            serve.run(app, name="pdc", http_port=port)
            break
        except Exception as e:  # noqa: BLE001 — retried on bind races
            if "address already in use" not in str(e).lower():
                raise
            serve.shutdown()
    # the pairing, probed on prefill replica 0 through the replica actor
    # (a DeploymentHandle would leave a long-poll thread behind)
    _v, (pre,) = rt.get(rt.get_actor(CONTROLLER_NAME).get_replicas.remote(
        "pdc", "pd-prefill:pd-tiny"), timeout=60)
    deadline = time.monotonic() + 60
    while not rt.get(pre.handle_request.remote("has_kv_channel", (), {},
                                               None), timeout=60):
        assert time.monotonic() < deadline, "the roles never paired"
        time.sleep(0.2)
    del pre
    assert rt.available_resources().get("GPU") == 0.0

    texts = []
    for t in TEXTS:
        out = json.loads(_post(port, {"model": "pd-tiny", "prompt": t,
                                      "max_tokens": MAX_TOKENS,
                                      "temperature": 0.0}))
        texts.append(out["choices"][0]["text"])
    assert texts == reference[1]

    raw = _post(port, {"model": "pd-tiny", "prompt": TEXTS[0],
                       "max_tokens": MAX_TOKENS, "stream": True})
    lines = [ln for ln in raw.decode().split("\n\n") if ln]
    assert lines[-1] == "data: [DONE]"
    chunks = [json.loads(ln[len("data: "):]) for ln in lines[:-1]]
    assert "".join(c["choices"][0]["text"] for c in chunks) == \
        reference[1][0]
    assert chunks[-1]["choices"][0]["finish_reason"] in ("length", "stop")

    # replicas flush their registries to the head every ~2 s
    deadline = time.monotonic() + 30
    while True:
        got = {k: v - before[k] for k, v in _chan_counts().items()}
        if got["kv_writes"] >= len(TEXTS) and \
                got["kv_imports"] >= len(TEXTS):
            break
        assert time.monotonic() < deadline, got
        time.sleep(0.2)
    assert got["kv_writes"] == got["kv_imports"] == len(TEXTS)
    assert got["results"] == 0         # no result ring under Serve

    serve.shutdown()
    _gpus_back()
    assert _back_to(store, base) <= base
