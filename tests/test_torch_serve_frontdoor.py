"""The Serve front door over the port's runtime
(``ray_tpu_torch.serve.frontdoor``): the head's shared directory, SLO-aware
admission control, the proxy fleet, the gRPC shed, the cluster-wide
prefix-cache directory, and the object store's put-copy pool.

Every case of ``tests/test_serve_frontdoor.py``, with the reference's
scenarios and assertions; the chaos case runs last, on a runtime of its
own (``num_gpus=1``), beside an LLM replica on a fake GPU SIGKILLed
under HTTP load and replaced: only typed statuses, the lease back, the
replacement on index "0" with the reference's greedy tokens on the same
weights, no prefix-directory entry of the dead replica.
``test_prefix_directory_cross_replica`` runs two replicas of the port's
tiny f32 Llama on weights made by the reference's ``llama.init`` and
carried across with ``models/convert.params_from_numpy``: replica B's
output over pages imported from A equals A's, a cold local engine's,
and the reference's cold engine's on the same weights. An ``LLMServer``
outside Serve consults the directory only once it is handed a replica
handle.

One runtime serves the module's other cases; every test that deploys
shuts Serve down after itself. HTTP ports are never fixed: the fleet
and chaos tests take a free block of consecutive ports (one per proxy)
and retry on another when a bind fails.
The deployments are defined inside the tests, so replicas unpickle them
by value and never import this module.
"""
import asyncio
import json
import os
import socket
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve


@pytest.fixture(scope="module")
def runtime():
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    yield rt
    serve.shutdown()
    rt.shutdown()


@pytest.fixture
def serve_cluster(runtime):
    yield runtime
    serve.shutdown()


def _free_block(n: int) -> int:
    """The first of n consecutive ports that are free right now."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n > 65535:
            continue
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no block of {n} free ports")


def _run_http(app, name, n_proxies=1, **kw):
    """serve.run on a free block of n_proxies ports; a bind lost to a
    race retries on another block. Returns (handle, first port)."""
    last = None
    for _ in range(5):
        port = _free_block(n_proxies)
        try:
            return serve.run(app, name=name, http_port=port,
                             num_proxies=n_proxies, **kw), port
        except Exception as e:  # noqa: BLE001 — retried on bind races
            if "address already in use" not in str(e).lower():
                raise
            last = e
            serve.shutdown()
    raise last


# ------------------------------------------------------------------ #
# core/directory.py — unit
# ------------------------------------------------------------------ #

def test_directory_service_unit():
    from ray_tpu_torch.core.directory import DirectoryService
    d = DirectoryService(max_entries=4)
    v1 = d.merge("a", put={"k1": 1, "k2": 2}, owner="w1")
    got = d.lookup("a")
    assert got["entries"] == {"k1": 1, "k2": 2} and got["v"] == v1
    # keyed lookup returns only present keys
    assert d.lookup("a", keys=["k2", "zz"])["entries"] == {"k2": 2}
    # drop + re-put bumps the version
    v2 = d.merge("a", put={"k3": 3}, drop=["k1"], owner="w2")
    assert v2 > v1
    assert d.lookup("a")["entries"] == {"k2": 2, "k3": 3}
    # FIFO cap: oldest-write evicts first; re-put re-arms position
    d.merge("a", put={"k2": 2.5}, owner="w1")     # k2 now newest
    d.merge("a", put={"k4": 4, "k5": 5, "k6": 6}, owner="w1")
    entries = d.lookup("a")["entries"]
    assert len(entries) == 4
    assert "k2" in entries and "k3" not in entries
    assert d.stats()["evictions"] == 1      # k3 (oldest write) evicted
    # owner sweep drops w1's entries only
    d.merge("b", put={"x": 1}, owner="w1")
    swept = d.sweep_owner("w1")
    assert swept >= 1
    assert d.lookup("b")["entries"] == {}
    # a no-op merge doesn't bump the version
    v = d.lookup("a")["v"]
    assert d.merge("a", drop=["never-there"]) == v


def test_directory_frames_cluster(runtime):
    """dir_update/dir_query over the protocol frames: a worker publishes,
    the head stamps ownership, the worker's death sweeps the entries."""
    from ray_tpu_torch.core import directory as cdir

    assert cdir.update("t:d1", put={"a": 1})
    assert cdir.query("t:d1")["entries"] == {"a": 1}

    @rt.remote
    class Pub:
        def pub(self):
            from ray_tpu_torch.core import directory as cd
            cd.update("t:d1", put={"b": 2}, drop=["a"])
            q = None
            for _ in range(100):
                q = cd.query("t:d1", keys=["a", "b"])
                if (q or {}).get("entries") == {"b": 2}:
                    return q
                time.sleep(0.05)
            return q

    a = Pub.remote()
    q = rt.get(a.pub.remote())
    assert q["entries"] == {"b": 2}, q
    rt.kill(a)
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        if not cdir.query("t:d1")["entries"]:
            break
        time.sleep(0.2)
    assert cdir.query("t:d1")["entries"] == {}, \
        "dead publisher's entries were not swept"


# ------------------------------------------------------------------ #
# frontdoor/admission.py — unit (asyncio, no cluster)
# ------------------------------------------------------------------ #

def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def test_admission_budget_queue_and_shed():
    from ray_tpu_torch.serve.frontdoor.admission import (AdmissionController,
                                                         ShedError)

    async def body():
        ac = AdmissionController("proxy-t")
        ac.configure("app", "dep", capacity=2, n_proxies=1,
                     queue_depth=2, timeout_s=0.5)
        r1 = await ac.acquire("app", "dep")
        r2 = await ac.acquire("app", "dep")     # budget filled
        # third parks; releasing r1 admits it FIFO
        acq3 = asyncio.ensure_future(ac.acquire("app", "dep"))
        await asyncio.sleep(0.05)
        assert not acq3.done()
        r1(0.01)
        r3 = await asyncio.wait_for(acq3, 1.0)
        # fill the queue (budget still held by r2, r3), then overflow
        acq4 = asyncio.ensure_future(ac.acquire("app", "dep"))
        acq5 = asyncio.ensure_future(ac.acquire("app", "dep"))
        await asyncio.sleep(0.05)
        with pytest.raises(ShedError) as ei:
            await ac.acquire("app", "dep")      # queue_full
        assert ei.value.reason == "queue_full"
        assert 1 <= ei.value.retry_after_s <= 60
        # parked requests past the deadline shed as "deadline"
        with pytest.raises(ShedError) as e4:
            await asyncio.wait_for(acq4, 5.0)
        assert e4.value.reason == "deadline"
        with pytest.raises(ShedError):
            await asyncio.wait_for(acq5, 5.0)
        # the budget never leaks: releases return inflight to zero
        r2(0.01)
        r3(0.01)
        g = ac.gate_for("app", "dep")
        assert g.inflight == 0 and g.parked_total() == 0
        # double-release is a no-op
        r3(0.01)
        assert g.inflight == 0
        # unconfigured deployment: admit untracked — and the returned
        # releaser must accept the duration the proxy always passes
        r = await ac.acquire("unknown", "dep")
        r(0.123)
    _run(body())


def test_admission_cancelled_waiter_unparks_and_clears_gauge():
    # a client that disconnects while parked must leave the queue (and
    # the rtpu_serve_tenant_queued gauge) exactly as it found them —
    # that gauge feeds the tenant_queue autoscale signal, so a stale
    # nonzero backlog would scale the deployment out and veto every
    # scale-down forever
    from ray_tpu_torch.serve.frontdoor.admission import AdmissionController
    from ray_tpu_torch.util import metrics as um

    def queued_value():
        rec = um.collect_store().get("rtpu_serve_tenant_queued")
        for key, v in (rec or {}).get("series", {}).items():
            if ("deployment", "dcancel") in key:
                return v
        return 0.0

    async def body():
        ac = AdmissionController("proxy-c")
        ac.configure("app", "dcancel", capacity=1, n_proxies=1,
                     queue_depth=4, timeout_s=30.0)
        hold = await ac.acquire("app", "dcancel")
        parked = asyncio.ensure_future(ac.acquire("app", "dcancel"))
        await asyncio.sleep(0.05)
        g = ac.gate_for("app", "dcancel")
        assert g.parked_total() == 1
        assert queued_value() == 1.0
        parked.cancel()
        with pytest.raises(asyncio.CancelledError):
            await parked
        # queue AND gauge are back to empty; the held slot is intact
        assert g.parked_total() == 0
        assert queued_value() == 0.0
        assert g.inflight == 1
        hold(0.01)
        assert g.inflight == 0
        # budget never leaks across the cancel: a fresh acquire admits
        r = await ac.acquire("app", "dcancel")
        r(0.01)
    _run(body())


def test_admission_slo_shed_and_prune():
    from ray_tpu_torch.serve.frontdoor.admission import (AdmissionController,
                                                         ShedError)

    async def body():
        ac = AdmissionController()
        ac.configure("app", "dep", capacity=1, n_proxies=1,
                     queue_depth=100, timeout_s=0.2)
        g = ac.gate_for("app", "dep")
        g.ewma_s = 1.0      # observed service time >> deadline
        hold = await ac.acquire("app", "dep")
        # predicted wait (1 ahead x 1s / budget 1) > 0.2s deadline:
        # shed immediately as "slo" without burning a queue slot
        with pytest.raises(ShedError) as ei:
            await ac.acquire("app", "dep")
        assert ei.value.reason == "slo"
        hold(None)
        # prune sheds parked waiters of removed deployments
        ac.configure("app2", "dep2", capacity=1, queue_depth=4,
                     timeout_s=5.0)
        h2 = await ac.acquire("app2", "dep2")
        parked = asyncio.ensure_future(ac.acquire("app2", "dep2"))
        await asyncio.sleep(0.05)
        ac.prune(live=set())
        with pytest.raises(ShedError):
            await asyncio.wait_for(parked, 1.0)
        del h2
    _run(body())


# ------------------------------------------------------------------ #
# the object store's put-copy pool: regrow under traffic
# ------------------------------------------------------------------ #

def test_put_copy_pool_regrow_safe():
    """Growing cfg.put_copy_threads mid-traffic must drain the old pool
    (shutdown after the swap, under the submit lock) — no slice may be
    lost and no put may race a dropped executor. Hammers regrows
    against concurrent parallel copies and verifies bit-equality."""
    import ctypes
    import threading

    import numpy as np

    from ray_tpu_torch.core import object_store as osm
    from ray_tpu_torch.core.config import cfg

    n = osm._PARALLEL_MIN + 12345
    src = np.random.RandomState(0).randint(
        0, 256, size=n, dtype=np.uint8).tobytes()
    old_threads = cfg.put_copy_threads
    stop = threading.Event()
    errors = []

    def copier():
        dst = bytearray(n)
        dst_addr = ctypes.addressof(
            (ctypes.c_char * n).from_buffer(dst))
        try:
            while not stop.is_set():
                osm._copy_parallel(dst_addr, src, n)
                if bytes(dst) != src:
                    errors.append("copy mismatch")
                    return
        except Exception as e:  # noqa: BLE001 — the regression signal
            errors.append(repr(e))

    def regrower():
        w = 2
        while not stop.is_set():
            cfg.override(put_copy_threads=w)
            w = 2 if w >= 8 else w + 1
            time.sleep(0.002)

    try:
        cfg.override(put_copy_threads=2)
        threads = [threading.Thread(target=copier) for _ in range(2)]
        threads.append(threading.Thread(target=regrower))
        for t in threads:
            t.start()
        time.sleep(2.0)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        # the regrown-away pools are actually shut down (drained), not
        # left to GC: the live pool is the only one accepting work
        with osm._copy_pool_lock:
            pool = osm._ensure_copy_pool_locked(4)
        assert not pool._shutdown
    finally:
        cfg.override(put_copy_threads=old_threads)


def test_put_copy_old_pool_drained_on_regrow():
    """The swap itself: after a regrow the OLD executor is shutdown —
    a submit to it raises instead of silently landing in a dropped
    pool."""
    from ray_tpu_torch.core import object_store as osm
    from ray_tpu_torch.core.config import cfg
    old_threads = cfg.put_copy_threads
    try:
        with osm._copy_pool_lock:
            small = osm._ensure_copy_pool_locked(2)
            w = osm._copy_pool_width           # whatever width it has
            assert osm._ensure_copy_pool_locked(w) is small  # no regrow
            grown = osm._ensure_copy_pool_locked(w + 2)
        assert grown is not small
        assert small._shutdown, "old pool must be drained on regrow"
        assert not grown._shutdown
        with pytest.raises(RuntimeError):
            small.submit(int, 0)
        # a narrower re-ask returns the live pool untouched
        with osm._copy_pool_lock:
            again = osm._ensure_copy_pool_locked(w)
        assert again is grown
    finally:
        cfg.override(put_copy_threads=old_threads)


# ------------------------------------------------------------------ #
# proxies + admission + prefix directory — end to end on the runtime
# ------------------------------------------------------------------ #

def _post(port, payload, path="default", timeout=30, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{path}", method="POST",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        r = urllib.request.urlopen(req, timeout=timeout)
        return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read())
        except Exception:
            body = {}
        return e.code, body, dict(e.headers)


def test_proxy_fleet_and_shed(serve_cluster):
    """Two proxies behind the shared route table; overload sheds clean
    429s with Retry-After while admitted traffic completes."""
    import threading

    @serve.deployment(num_replicas=1, max_ongoing_requests=2)
    class Slowish:
        def __call__(self, payload):
            time.sleep(float((payload or {}).get("s", 0.01)))
            return {"ok": True}

    _h, base = _run_http(Slowish.bind(), "default", n_proxies=2)
    st = serve.status()
    assert len(st["proxies"]) == 2
    ports = sorted(p["port"] for p in st["proxies"])
    assert ports == [base, base + 1]
    for port in ports:
        code, body, _h = _post(port, {"s": 0.0})
        assert code == 200 and body["ok"] is True

    results = []
    lock = threading.Lock()

    def slam():
        code, _body, headers = _post(base, {"s": 0.5}, timeout=45)
        with lock:
            results.append((code, headers.get("Retry-After")))

    threads = [threading.Thread(target=slam) for _ in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    codes = [c for c, _ in results]
    assert 429 in codes, codes                      # overload shed
    assert all(c in (200, 429) for c in codes), codes   # and NOTHING else
    assert all(ra is not None and int(ra) >= 1
               for c, ra in results if c == 429)
    # shed traffic is typed in the summary, split from errors
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        ms = serve.metrics_summary()
        if ms.get("admission", {}).get("shed", 0) > 0:
            break
        time.sleep(0.5)
    assert ms["admission"]["shed"] > 0
    assert ms["admission"]["admitted"] > 0


def test_grpc_shed_resource_exhausted(serve_cluster):
    """The gRPC front door sheds past fleet capacity with
    RESOURCE_EXHAUSTED (the 429 contract's gRPC spelling) — and
    nothing else leaks through as INTERNAL."""
    import threading

    grpc = pytest.importorskip("grpc")

    @serve.deployment(num_replicas=1, max_ongoing_requests=1)
    class Slow:
        def __call__(self, payload):
            time.sleep(float((payload or {}).get("s", 0.0)))
            return {"ok": True}

    _run_http(Slow.bind(), "default")
    _h, gport = serve.start_grpc_proxy()
    ch = grpc.insecure_channel(f"127.0.0.1:{gport}")
    call = ch.unary_unary("/raytpu.Serve/Call")
    out = json.loads(call(json.dumps(
        {"app": "default", "payload": {}}).encode(), timeout=60))
    assert out["ok"] is True
    time.sleep(1.5)     # let the proxy's snapshot TTL pick up capacity

    codes = []
    lock = threading.Lock()

    def slam():
        try:
            call(json.dumps({"app": "default",
                             "payload": {"s": 1.0}}).encode(),
                 timeout=60)
            with lock:
                codes.append("OK")
        except grpc.RpcError as e:
            with lock:
                codes.append(e.code().name)

    threads = [threading.Thread(target=slam) for _ in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    ch.close()
    from collections import Counter
    c = Counter(codes)
    assert c.get("RESOURCE_EXHAUSTED", 0) > 0, c
    assert set(c) <= {"OK", "RESOURCE_EXHAUSTED"}, c


def test_prefix_directory_cross_replica(serve_cluster):
    """Replica B admission-matches a prefix warmed on replica A via the
    cluster directory, imports the pages over the object store, and
    generates BIT-IDENTICAL output to a cold prefill — the port's cold
    engine and the reference's, on the same weights."""
    import jax
    import numpy as np
    from ray_tpu.llm import SamplingParams as JaxSamplingParams
    from ray_tpu.llm.paged_engine import PagedEngineConfig as JaxConfig
    from ray_tpu.llm.paged_engine import \
        PagedInferenceEngine as JaxEngine
    from ray_tpu.models import llama as jllama

    from ray_tpu_torch.core import directory as cdir
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm.paged_engine import (PagedEngineConfig,
                                                PagedInferenceEngine)
    from ray_tpu_torch.llm.serving import LLMConfig, build_llm_deployment
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.serve.api import CONTROLLER_NAME

    shape = dict(vocab_size=258, max_seq_len=256)
    engine = dict(max_batch_size=4, page_size=8, num_pages=128,
                  max_pages_per_seq=24, chunk_size=16)
    jparams = jllama.init(jax.random.PRNGKey(0), jllama.llama_tiny(**shape))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               llama.llama_tiny(**shape), device="cpu")
    ecfg = PagedEngineConfig(model=llama.llama_tiny(**shape), **engine)
    app = build_llm_deployment(
        LLMConfig(model_id="tiny", engine=ecfg, num_replicas=2,
                  warmup=False), params, device="cpu")
    serve.run(app, name="llm")
    ctrl = rt.get_actor(CONTROLLER_NAME)
    _v, replicas = rt.get(ctrl.get_replicas.remote("llm", "llm:tiny"))
    ra, rb = replicas

    system = "You are a helpful assistant. Answer briefly. " * 2
    p1 = system + "Q1?"
    p2 = system + "Q2 something else?"
    sp = {"max_tokens": 8, "temperature": 0.0}

    out_a = rt.get(ra.handle_request.remote(
        "completions", ({"prompt": p1, **sp},), {}, None), timeout=180)

    # A's engine loop publishes its page hashes within the publish period
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        if cdir.query("serve:prefix:tiny")["entries"]:
            break
        time.sleep(0.2)
    assert cdir.query("serve:prefix:tiny")["entries"], \
        "replica A never published"

    # B serves a DIFFERENT tail on the same system prefix: the directory
    # hit imports A's pages instead of prefilling them
    rt.get(rb.handle_request.remote(
        "completions", ({"prompt": p2, **sp},), {}, None), timeout=180)
    deadline = time.monotonic() + 10
    pd = {}
    while time.monotonic() < deadline:
        pd = serve.metrics_summary().get("prefix_directory") or {}
        if pd.get("hits", 0) > 0:
            break
        time.sleep(0.5)
    assert pd.get("hits", 0) > 0, pd
    assert pd.get("imported_pages", 0) > 0, pd
    assert pd.get("publishes", 0) > 0, pd

    # bit-identical: B over imported pages == A == a cold local engine
    # == the reference's cold engine on the same weights
    out_b1 = rt.get(rb.handle_request.remote(
        "completions", ({"prompt": p1, **sp},), {}, None), timeout=180)
    cold = PagedInferenceEngine(ecfg, params, device="cpu")
    cold_out = cold.generate([cold.tokenizer.encode(p1)],
                             SamplingParams(max_tokens=8))[0]
    jcold = JaxEngine(JaxConfig(model=jllama.llama_tiny(**shape), **engine),
                      jparams)
    jcold_out = jcold.generate([jcold.tokenizer.encode(p1)],
                               JaxSamplingParams(max_tokens=8))[0]
    assert out_b1["choices"][0]["text"] == cold_out["text"] \
        == out_a["choices"][0]["text"] == jcold_out["text"]
    assert cold_out["token_ids"] == [int(t) for t in jcold_out["token_ids"]]


def test_llm_server_uses_the_directory_only_as_a_replica():
    """An LLMServer outside Serve builds its directory client and tracks
    its page publishes, but neither publishes nor looks a prompt up
    until the controller injects its replica handle."""
    from ray_tpu_torch.llm import LLMConfig, LLMServer, PagedEngineConfig
    from ray_tpu_torch.models import llama

    srv = LLMServer(LLMConfig(model_id="solo", warmup=False,
                              engine=PagedEngineConfig(
                                  model=llama.llama_tiny(vocab_size=258,
                                                         max_seq_len=256),
                                  max_batch_size=2, page_size=8,
                                  num_pages=64, max_pages_per_seq=24,
                                  chunk_size=16)), device="cpu")
    try:
        client = srv._prefix_client
        assert client is not None and srv._prefix_dir is None
        assert srv.engine.track_page_publish
        looked_up = []
        client.maybe_import = lambda eng, lock, prompt, salt=b"": \
            looked_up.append(list(prompt)) or 0
        body = {"prompt": "a prompt long enough for two pages of eight",
                "max_tokens": 2}
        srv.completions(dict(body))
        assert looked_up == []

        class Handle:
            _actor_id = b"replica"

        srv.set_replica_handle(Handle())
        assert srv._prefix_dir is client and client._self_id == b"replica"
        srv.completions(dict(body))
        assert looked_up == [srv.engine.tokenizer.encode(body["prompt"])]
    finally:
        srv._stop = True
        srv._wake.set()
        srv._thread.join(timeout=30)
    assert not srv._thread.is_alive()


def test_engine_export_import_prefix_bitwise():
    """Engine-level contract: import_prefix registers EXACTLY the
    exporter's KV bytes, stops at the reserve floor, and tolerates a
    partial (stale) export."""
    import numpy as np

    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm.paged_engine import (PagedEngineConfig,
                                                PagedInferenceEngine)
    from ray_tpu_torch.models import llama

    ecfg = PagedEngineConfig(
        model=llama.llama_tiny(vocab_size=258, max_seq_len=256),
        max_batch_size=4, page_size=8, num_pages=64,
        max_pages_per_seq=24, chunk_size=16)
    a = PagedInferenceEngine(ecfg, rng_seed=0, device="cpu")
    b = PagedInferenceEngine(ecfg, rng_seed=0, device="cpu")
    prompt = list(range(1, 70))
    a.generate([prompt], SamplingParams(max_tokens=4))
    hashes = a.hash_prompt(prompt)
    assert hashes and a.cached_prefix_len(hashes) == len(hashes)

    payload = a.export_prefix(hashes)
    assert payload is not None
    assert len(payload["page_hashes"]) == len(hashes)
    n = b.import_prefix(payload)
    assert n == len(hashes)
    assert b.cached_prefix_len(hashes) == len(hashes)
    # the imported pages hold byte-identical KV
    chk = b.export_prefix(hashes)
    for la, lb in zip(payload["pages"], chk["pages"]):
        assert np.array_equal(la["k"], lb["k"])
        assert np.array_equal(la["v"], lb["v"])
    # re-import is a no-op (already cached)
    assert b.import_prefix(payload) == 0
    # unknown hashes export None (stale directory entry -> cold prefill)
    assert a.export_prefix([b"\x00" * 16]) is None
    # and generation over imported pages == cold generation
    out_b = b.generate([prompt], SamplingParams(max_tokens=4))[0]
    out_cold = PagedInferenceEngine(ecfg, rng_seed=0, device="cpu").generate(
        [prompt], SamplingParams(max_tokens=4))[0]
    assert out_b["token_ids"] == out_cold["token_ids"]
    assert b.stats["prefix_imported_pages"] == len(hashes)


# ------------------------------------------------------------------ #
# chaos: SIGKILLed replicas and proxies (util/chaos.py's setting). Each
# case runs on a runtime of its own, as the reference's runs on a fresh
# ray_start_regular: it shuts the module's runtime down, so these cases
# stay last in the file.
# ------------------------------------------------------------------ #

@pytest.fixture
def fresh_cluster():
    serve.shutdown()
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=2, num_gpus=1, object_store_memory=256 * 1024 * 1024)
    yield rt
    serve.shutdown()
    rt.shutdown()


def test_chaos_kill_replica_and_proxy(fresh_cluster):
    """Degradation, not collapse: SIGKILL one replica and one proxy
    mid-load. Admitted requests finish or surface TYPED errors (zero
    bare 500s), sheds stay clean 429s, the controller replaces both
    casualties, doctor comes back clean, and the store drains."""
    import signal
    import threading

    from ray_tpu_torch import state

    import gc

    from ray_tpu_torch.core import runtime as rt_mod
    head = rt_mod.get_runtime_if_exists()

    def quiesce(budget=10.0):
        # frees are async (ref-drop messages): wait for a STABLE count
        deadline = time.monotonic() + budget
        last, stable_since = head.store.num_objects(), time.monotonic()
        while time.monotonic() < deadline:
            gc.collect()
            n = head.store.num_objects()
            if n != last:
                last, stable_since = n, time.monotonic()
            elif time.monotonic() - stable_since > 1.5:
                break
            time.sleep(0.2)
        return head.store.num_objects()

    base_pre_deploy = quiesce()

    @serve.deployment(num_replicas=2, max_ongoing_requests=4)
    class Victim:
        def __call__(self, payload):
            time.sleep(0.05)
            return {"pid": os.getpid()}

    _h, base = _run_http(Victim.bind(), "default", n_proxies=2)
    fleet = (base, base + 1)
    for port in fleet:
        code, body, _h = _post(port, {})
        assert code == 200
    base_objects = quiesce()

    results = []
    lock = threading.Lock()
    stop = threading.Event()

    def load(port):
        while not stop.is_set():
            code, body, _h = _post(port, {}, timeout=45)
            with lock:
                results.append((code, body))

    threads = [threading.Thread(target=load, args=(p,))
               for p in fleet for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(1.0)

    # SIGKILL one replica (raw kill -9 on its process)...
    with lock:
        pids = {b["pid"] for c, b in results
                if c == 200 and isinstance(b, dict) and "pid" in b}
    assert pids
    os.kill(sorted(pids)[0], signal.SIGKILL)
    # ...and one proxy
    ctrl = rt.get_actor("rtpu:serve:controller")
    proxies = rt.get(ctrl.get_proxies.remote())
    ppid = rt.get(proxies[0]["actor"].ping.remote())["pid"]
    os.kill(ppid, signal.SIGKILL)

    time.sleep(4.0)     # keep loading through the failure + recovery
    stop.set()
    for t in threads:
        t.join(timeout=60)

    codes = [c for c, _b in results]
    assert codes.count(200) > 0
    bad = [c for c in codes if c not in (200, 429, 503, 504)]
    assert not bad, f"bare/untyped failures: {bad}"

    # recovery: both ports answer again (the dead proxy was respawned
    # on its port) and the deployment is back at 2 replicas
    deadline = time.monotonic() + 60
    ok = False
    while time.monotonic() < deadline:
        try:
            codes2 = [_post(p, {}, timeout=10)[0] for p in fleet]
            dep = serve.status()["applications"]["default"][
                "deployments"]["Victim"]
            if codes2 == [200, 200] and dep["running_replicas"] == 2:
                ok = True
                break
        except Exception:
            pass
        time.sleep(0.5)
    assert ok, "fleet did not recover"

    # doctor clean after recovery (what `cli doctor` gates its exit on)
    hangs = state.hang_report()
    assert not hangs["stuck_tasks"] and not hangs["deadlocks"]

    # while serving, the store sits near its post-deploy baseline: the
    # only extra live objects are in-flight control-plane long-polls
    # (one parked listen_for_change ref per live handle listener),
    # which churn on a ~30s period — allow them, catch gross leaks
    deadline = time.monotonic() + 45
    while time.monotonic() < deadline:
        gc.collect()
        if head.store.num_objects() <= base_objects + 4:
            break
        time.sleep(0.5)
    assert head.store.num_objects() <= base_objects + 4, (
        head.store.num_objects(), base_objects)

    # ...and teardown drains to the EXACT pre-deploy baseline: the
    # SIGKILLed replica and proxy leaked nothing reclaimable only by
    # restart. Drop this test's own handles to the (now dead) actors
    # first — a live handle to a killed actor legitimately pins its
    # ActorDiedError ready-object, which is interest, not a leak.
    del proxies, ctrl
    serve.shutdown()
    # +1 tolerance: under the FULL suite, backed-off long-poll listener
    # threads from earlier tests' (uncollected) handles can retry
    # against this fresh cluster during the settle window, leaving one
    # transient ~64-byte control-plane object at the sampled instant —
    # real front-door leaks (error objects / page payloads per killed
    # actor) show up as several objects and fail this bound. Standalone
    # runs settle to the exact baseline.
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        gc.collect()
        if head.store.num_objects() <= base_pre_deploy + 1:
            break
        time.sleep(0.5)
    assert head.store.num_objects() <= base_pre_deploy + 1, (
        head.store.num_objects(), base_pre_deploy,
        state.memory_summary(limit=10))


def test_chaos_kill_llm_replica_on_a_fake_gpu(fresh_cluster):
    """An LLM replica holding the (fake) GPU is SIGKILLed under HTTP
    load and replaced: every response is a 200 or a typed 429/503/504,
    the head gives the dead worker's lease back, the replacement leases
    the same index ("0") while GPU reads 0.0, serves the reference's
    greedy tokens for the same weights, and no prefix-directory entry
    names the dead replica; after ``serve.shutdown()`` GPU reads 1.0.
    The CPU rehearsal of chip_smoke.py's chaos step (phase 4h)."""
    import dataclasses
    import signal
    import threading

    import jax
    import numpy as np
    from ray_tpu.llm import SamplingParams as JaxSamplingParams
    from ray_tpu.llm.paged_engine import PagedEngineConfig as JaxConfig
    from ray_tpu.llm.paged_engine import \
        PagedInferenceEngine as JaxEngine
    from ray_tpu.models import llama as jllama

    from ray_tpu_torch import state
    from ray_tpu_torch.core import directory as cdir
    from ray_tpu_torch.core import runtime as rt_mod
    from ray_tpu_torch.llm import (LLMConfig, LLMServer, PagedEngineConfig,
                                   build_openai_app)
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.serve.api import CONTROLLER_NAME

    class Recording(LLMServer):
        """Records each request's prompt and token ids."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._served = []
            result = self.engine._result

            def recording(req):
                out = result(req)
                self._served.append((list(req.prompt_ids),
                                     [int(t) for t in out["token_ids"]]))
                return out
            self.engine._result = recording

        def served(self):
            return list(self._served)

    shape = dict(vocab_size=258, max_seq_len=256)
    engine = dict(max_batch_size=4, page_size=8, num_pages=128,
                  max_pages_per_seq=24, chunk_size=16)
    jparams = jllama.init(jax.random.PRNGKey(0), jllama.llama_tiny(**shape))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               llama.llama_tiny(**shape), device="cpu")
    app = build_openai_app([LLMConfig(
        model_id="tiny", gpus_per_replica=1, warmup=False,
        engine=PagedEngineConfig(model=llama.llama_tiny(**shape),
                                 **engine))],
        params_refs=[params], device="cpu")
    (child,) = app.ingress.children()
    child.spec = dataclasses.replace(child.spec, func_or_class=Recording)
    assert child.spec.ray_actor_options == {"num_gpus": 1}
    _h, port = _run_http(app, "llm")
    path = "llm/v1/completions"
    prompts = ["a prompt long enough for two pages of eight",
               "hello there", "the quick brown fox", "xy"]

    def body(p):
        return {"model": "tiny", "prompt": p, "max_tokens": 8,
                "temperature": 0.0}

    head = rt_mod.get_runtime_if_exists()
    ctrl = rt.get_actor(CONTROLLER_NAME)
    _v, (old,) = rt.get(ctrl.get_replicas.remote("llm", "llm:tiny"),
                        timeout=60)
    old_id = old._actor_id
    old_pid = rt.get(old._exec(lambda _i: os.getpid()), timeout=60)
    assert rt.get(old._exec(
        lambda _i: os.environ["CUDA_VISIBLE_DEVICES"]), timeout=60) == "0"

    results = []
    lock = threading.Lock()
    stop = threading.Event()
    killed = threading.Event()
    recovered = []

    def load(p):
        while not stop.is_set():
            code, _b, _hd = _post(port, body(p), path=path, timeout=60)
            with lock:
                results.append(code)
                if code == 200 and killed.is_set() and not recovered:
                    recovered.append(time.monotonic())
            if code != 200:
                time.sleep(0.05)

    threads = [threading.Thread(target=load, args=(p,)) for p in prompts]
    for t in threads:
        t.start()
    try:
        deadline = time.monotonic() + 120
        while 200 not in results and time.monotonic() < deadline:
            time.sleep(0.1)
        assert 200 in results, results
        # the replica has published its pages under its own id
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and not any(
                getattr(v, "_actor_id", None) == old_id for v in (
                    cdir.query("serve:prefix:tiny") or {}).get(
                    "entries", {}).values()):
            time.sleep(0.2)

        os.kill(old_pid, signal.SIGKILL)
        t_kill = time.monotonic()
        killed.set()
        # keep loading until the replacement answers
        while not recovered and time.monotonic() < t_kill + 120:
            time.sleep(0.1)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=90)
    assert recovered, "no 200 after the kill"
    assert 200 in results
    bad = [c for c in results if c not in (200, 429, 503, 504)]
    assert not bad, f"bare/untyped failures: {bad}"

    # the head saw the death and gave the dead worker's lease back
    with head.lock:
        dead = [w for w in head.workers.values()
                if w.proc is not None and w.proc.pid == old_pid]
        assert len(dead) == 1 and dead[0].state == "dead"
        assert dead[0].gpus == ()

    # one running replica with a new actor id and a new pid, on index "0"
    _v, (new,) = rt.get(ctrl.get_replicas.remote("llm", "llm:tiny"),
                        timeout=60)
    assert new._actor_id != old_id
    assert rt.get(new.health_check.remote(), timeout=60)
    assert rt.get(new._exec(lambda _i: os.getpid()), timeout=60) != old_pid
    assert rt.get(new._exec(
        lambda _i: os.environ["CUDA_VISIBLE_DEVICES"]), timeout=60) == "0"
    dep = serve.status()["applications"]["llm"]["deployments"]["llm:tiny"]
    assert dep["running_replicas"] == 1
    deadline = time.monotonic() + 10
    while rt.available_resources().get("GPU") != 0.0 and \
            time.monotonic() < deadline:
        time.sleep(0.2)
    assert rt.available_resources().get("GPU") == 0.0

    # the replacement's greedy tokens, one request at a time over HTTP,
    # are the reference's on the same weights
    jeng = JaxEngine(JaxConfig(model=jllama.llama_tiny(**shape), **engine),
                     jparams)
    for p in prompts:
        code, resp, _hd = _post(port, body(p), path=path, timeout=120)
        assert code == 200, (code, resp)
        ids, toks = rt.get(new.handle_request.remote(
            "served", (), {}, None), timeout=60)[-1]
        ref = jeng.generate([jeng.tokenizer.encode(p)],
                            JaxSamplingParams(max_tokens=8))[0]
        assert ids == jeng.tokenizer.encode(p)
        assert toks == [int(t) for t in ref["token_ids"]]
        assert resp["choices"][0]["text"] == ref["text"]

    # no directory entry names the dead replica, and no hang
    deadline = time.monotonic() + 15
    while True:
        entries = (cdir.query("serve:prefix:tiny") or {}).get(
            "entries", {})
        stale = [k for k, v in entries.items()
                 if getattr(v, "_actor_id", None) == old_id]
        if not stale or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    assert not stale, len(stale)
    hangs = state.hang_report()
    assert not hangs["stuck_tasks"] and not hangs["deadlocks"]

    del old, new, ctrl
    serve.shutdown()
    deadline = time.monotonic() + 30
    while rt.available_resources().get("GPU") != 1.0 and \
            time.monotonic() < deadline:
        time.sleep(0.2)
    assert rt.available_resources().get("GPU") == 1.0
