"""Serving telemetry over the port: the engine's and Serve's metrics,
``serve.metrics_summary()``, and request-scoped traces.

The five cases of ``tests/test_serve_telemetry.py`` with the reference's
assertions: the engine's series and summary, the ``llm.request`` span
parented to the span it was submitted under (a Serve replica's), the
proxy's root span ignoring an ambient context, the request-path series
of an HTTP request reaching the head's ``/metrics`` text and the
summary, and the ``@serve.batch`` histograms. The reference's last
check of the request path reads the summary back through its
dashboard's ``/api/serve_metrics``; the port has no dashboard yet, so
the port's case reads the same series through the head's Prometheus
endpoint (``state.start_metrics_server``) instead. The deployments are
defined inside the tests; the HTTP port is never fixed."""
import json
import socket
import time
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.util import metrics as um


@pytest.fixture
def fresh_registry():
    um._reset_registry()
    yield
    um._reset_registry()


@pytest.fixture(scope="module")
def engine():
    from ray_tpu_torch.llm.paged_engine import (PagedEngineConfig,
                                                PagedInferenceEngine)
    from ray_tpu_torch.models import llama
    cfg = PagedEngineConfig(
        model=llama.llama_tiny(vocab_size=258, max_seq_len=128),
        max_batch_size=4, page_size=8, num_pages=64,
        max_pages_per_seq=16, chunk_size=16)
    return PagedInferenceEngine(cfg, rng_seed=0, device="cpu")


def _drive(engine, n_requests=3, max_tokens=4):
    from ray_tpu_torch.llm import SamplingParams
    tok = engine.tokenizer
    reqs = [engine.submit(tok.encode("hello world " * (i + 1)),
                          SamplingParams(max_tokens=max_tokens))
            for i in range(n_requests)]
    while not all(r.done for r in reqs):
        engine.step()
    return reqs


def test_engine_metrics_and_summary(fresh_registry, engine):
    from ray_tpu_torch.serve import metrics_summary
    _drive(engine)
    summary = metrics_summary()
    for key in ("ttft", "queue_wait", "inter_token"):
        stats = summary[key]
        assert stats["count"] >= 3 or key == "inter_token"
        for q in ("p50", "p95", "p99"):
            assert stats[q] is not None and 0.0 <= stats[q] < 60.0
    assert summary["requests"]["llm"] >= 3
    assert summary["requests"]["llm_tokens"] >= 3
    assert "paged" in summary["kv_utilization"]

    text = "\n".join(um.prometheus_lines(um.local_store()))
    assert "rtpu_llm_ttft_seconds_bucket" in text
    assert "rtpu_llm_kv_utilization" in text
    assert 'rtpu_llm_dispatches_total{engine="paged",family="prefill"}' \
        in text
    assert 'rtpu_llm_requests_total{engine="paged",finish=' in text


def test_engine_request_span_parents_to_submitter(fresh_registry, engine):
    from ray_tpu_torch.core import runtime as rt_mod
    from ray_tpu_torch.core.config import cfg
    from ray_tpu_torch.util import tracing

    class _StubRT:
        def __init__(self):
            self.spans = []

        def record_trace_span(self, rec):
            self.spans.append(rec)

    stub = _StubRT()
    # save/restore instead of asserting None: an earlier test module
    # leaking a runtime must not fail THIS test (order independence)
    prev_rt = rt_mod.get_runtime_if_exists()
    cfg.override(tracing_enabled=True)
    rt_mod.set_runtime(stub)
    try:
        from ray_tpu_torch.serve.context import (reset_request_context,
                                                 set_request_context)
        token = set_request_context(request_id="req-abc")
        try:
            with tracing.span("serve.replica"):
                reqs = _drive(engine, n_requests=1)
        finally:
            reset_request_context(token)
        while not all(r.done for r in reqs):
            engine.step()
    finally:
        rt_mod.set_runtime(prev_rt)
        cfg.reset("tracing_enabled")

    by_name = {s["name"]: s for s in stub.spans}
    replica = by_name["serve.replica"]
    # select OUR request's span explicitly: a leftover request from an
    # earlier test sharing the module-scoped engine may retire here too
    llm = next(s for s in stub.spans if s["name"] == "llm.request"
               and s.get("request_id") == "req-abc")
    # one stitched tree: same trace id, engine span under the replica span
    assert llm["trace_id"] == replica["trace_id"]
    assert llm["parent_id"] == replica["span_id"]
    assert llm["request_id"] == "req-abc"
    assert llm["dur_s"] >= 0.0


def test_proxy_root_span_ignores_ambient_context(fresh_registry):
    from ray_tpu_torch.core.config import cfg
    from ray_tpu_torch.util import tracing
    cfg.override(tracing_enabled=True)
    try:
        with tracing.span("server.boot") as boot:
            with tracing.span("serve.proxy", root=True) as req_span:
                pass
        assert req_span["trace_id"] != boot["trace_id"]
        assert req_span["parent_id"] is None
    finally:
        cfg.reset("tracing_enabled")


@pytest.fixture(scope="module")
def runtime():
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=2, object_store_memory=128 * 1024 * 1024)
    yield rt
    rt.shutdown()


@pytest.fixture
def ray(runtime):
    from ray_tpu_torch import serve
    yield runtime
    serve.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_request_path_metrics_end_to_end(ray):
    from ray_tpu_torch import serve, state

    @serve.deployment
    def echo(payload):
        return {"got": payload["v"]}

    for attempt in range(5):
        port = _free_port()
        try:
            serve.run(echo.bind(), name="default", http_port=port)
            break
        except Exception as e:  # noqa: BLE001 — a lost bind retries
            if "address already in use" not in str(e).lower() or \
                    attempt == 4:
                raise
            serve.shutdown()
    time.sleep(0.5)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/", data=json.dumps({"v": 7}).encode(),
        headers={"Content-Type": "application/json"})
    deadline = time.monotonic() + 15
    while True:
        try:
            with urllib.request.urlopen(req, timeout=5) as resp:
                assert json.loads(resp.read()) == {"got": 7}
            break
        except Exception:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.3)

    # proxy/replica/controller series flush to the head on a ~2s cadence
    want = ("rtpu_serve_proxy_requests_total",
            "rtpu_serve_request_latency_seconds_bucket",
            "rtpu_serve_handle_requests_total",
            "rtpu_serve_replica_requests_total",
            "rtpu_serve_replica_latency_seconds_bucket",
            "rtpu_serve_queue_depth",
            "rtpu_serve_replicas")
    deadline = time.monotonic() + 20
    while True:
        text = state._prometheus_text()
        missing = [w for w in want if w not in text]
        if not missing:
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"series never reached /metrics: {missing}")
        time.sleep(0.3)
    assert 'rtpu_serve_proxy_requests_total{route="/default",' \
           'method="POST",status="200"}' in text

    summary = serve.metrics_summary()
    assert summary["requests"]["proxy"] >= 1
    assert summary["requests"]["replica"] >= 1
    assert summary["requests"]["errors"] == 0
    e2e = summary["e2e_latency"]
    for q in ("p50", "p95", "p99"):
        assert e2e[q] is not None and 0.0 <= e2e[q] < 60.0

    # the head's Prometheus endpoint serves the same series
    mport = state.start_metrics_server(port=0)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{mport}/metrics", timeout=10) as r:
            body = r.read().decode()
        assert 'rtpu_serve_proxy_requests_total{route="/default",' \
               'method="POST",status="200"}' in body
    finally:
        state.stop_metrics_server()


def test_batch_metrics(ray):
    from ray_tpu_torch import serve, state

    @serve.deployment
    class Batcher:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.02)
        async def __call__(self, xs: list) -> list:
            return [x * 2 for x in xs]

    handle = serve.run(Batcher.bind(), name="batched")
    responses = [handle.remote(i) for i in range(8)]
    assert sorted(r.result(30.0) for r in responses) == \
        sorted(i * 2 for i in range(8))

    deadline = time.monotonic() + 20
    while True:
        text = state._prometheus_text()
        if "rtpu_serve_batch_size_bucket" in text and \
                "rtpu_serve_batch_wait_seconds_bucket" in text:
            break
        if time.monotonic() > deadline:
            raise AssertionError("batch histograms never reached /metrics")
        time.sleep(0.3)
