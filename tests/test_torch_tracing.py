"""Distributed trace propagation (reference:
python/ray/util/tracing/tracing_helper.py:293,326 — trace context rides
task metadata; spans parent across processes).

The port's copy of ``tests/test_tracing.py``, with its imports pointed
at ``ray_tpu_torch``.

Its ``shutdown_only`` fixture is the port's own, defined here under the
reference's name: ``tests/conftest.py``'s start the reference's runtime.
"""
import pytest

import ray_tpu_torch
from ray_tpu_torch.core.config import cfg
from ray_tpu_torch.util import tracing


@pytest.fixture
def shutdown_only():
    import ray_tpu_torch as ray
    yield ray
    if ray.is_initialized():
        ray.shutdown()


@pytest.fixture
def traced_ray():
    cfg.override(tracing_enabled=True)
    ray_tpu_torch.init(num_cpus=2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    cfg.reset("tracing_enabled")


def _spans(ray, expect_names=(), timeout=15.0):
    """Trace events; polls until `expect_names` all appear (get() returns
    at object-seal — the done message carrying the span lands a beat
    later)."""
    import time
    deadline = time.monotonic() + timeout
    while True:
        spans = [e for e in ray.timeline() if e.get("cat") == "trace"]
        names = {s["name"] for s in spans}
        if all(any(n == want or n.endswith(want) for n in names)
               for want in expect_names) or time.monotonic() > deadline:
            return spans
        time.sleep(0.1)


def test_disabled_by_default(shutdown_only):
    ray = shutdown_only
    ray.init(num_cpus=1)

    @ray.remote
    def f():
        return 1

    assert ray.get(f.remote(), timeout=60) == 1
    assert tracing.context_for_submit() is None
    assert _spans(ray) == []


def test_task_span_parents_to_driver_span(traced_ray):
    ray = traced_ray

    @ray.remote
    def leaf():
        return 1

    with tracing.span("driver-root") as root:
        ref = leaf.remote()
    assert ray.get(ref, timeout=60) == 1

    spans = {s["name"]: s for s in _spans(ray, ("driver-root", "leaf"))}
    assert "driver-root" in spans and "leaf" in spans
    r, lf = spans["driver-root"]["args"], spans["leaf"]["args"]
    assert lf["trace_id"] == r["trace_id"]
    assert lf["parent_id"] == r["span_id"]


def test_nested_task_spans_chain_across_processes(traced_ray):
    ray = traced_ray

    @ray.remote
    def child():
        return "c"

    @ray.remote
    def parent():
        # submitted INSIDE the parent task's span: the context crossed
        # process boundaries via the TaskSpec
        return ray_tpu_torch.get(child.remote(), timeout=60)

    with tracing.span("root"):
        out = ray.get(parent.remote(), timeout=120)
    assert out == "c"

    spans = {s["name"]: s for s in _spans(ray, ("root", "parent", "child"))}
    root = spans["root"]["args"]
    par = spans["parent"]["args"]
    chi = spans["child"]["args"]
    assert par["trace_id"] == root["trace_id"] == chi["trace_id"]
    assert par["parent_id"] == root["span_id"]
    assert chi["parent_id"] == par["span_id"]


def test_actor_method_spans(traced_ray):
    ray = traced_ray

    @ray.remote
    class A:
        def m(self):
            return 7

    a = A.remote()
    with tracing.span("actor-root") as root:
        assert ray.get(a.m.remote(), timeout=60) == 7
    spans = {s["name"]: s for s in _spans(ray, ("actor-root", ".m"))}
    m = next(v for k, v in spans.items() if k.endswith(".m"))
    assert m["args"]["parent_id"] == spans["actor-root"]["args"]["span_id"]
