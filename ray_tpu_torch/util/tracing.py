"""Distributed trace-context propagation.

Reference parity: python/ray/util/tracing/tracing_helper.py:293
(_inject_tracing_into_function) and :326 (_function_hydrate_span_args) —
the reference injects the OpenTelemetry context into task metadata so a
task's span parents to its submitter's span across processes. Here the
context is a (trace_id, span_id) pair riding TaskSpec.trace_ctx: submission
captures the submitter's current span as parent, the executing worker opens
a child span around the function body, and completed spans flow back on the
done message into the head's chrome-trace timeline (ray_tpu_torch.timeline()),
where trace_id/span_id/parent_id args let tools stitch cross-process
flows. W3C-sized ids (128-bit trace, 64-bit span). If the opentelemetry
SDK is importable, spans are additionally forwarded to its tracer; the
image does not ship it, so that path is soft-gated.

Enable with cfg.override(tracing_enabled=True) (or RTPU_TRACING_ENABLED=1)
before ray_tpu_torch.init() — driver overrides propagate to workers.
"""
from __future__ import annotations

import contextlib
import contextvars
import secrets
import time
from typing import Optional

# (trace_id_hex, span_id_hex) of the ACTIVE span in this process/task
_current: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "rtpu_trace_ctx", default=None)


def tracing_enabled() -> bool:
    from ..core.config import cfg
    return bool(cfg.tracing_enabled)


def new_trace_id() -> str:
    return secrets.token_hex(16)


def new_span_id() -> str:
    return secrets.token_hex(8)


def current_context() -> Optional[tuple]:
    """(trace_id, span_id) of the active span, or None."""
    return _current.get()


def context_for_submit() -> Optional[tuple]:
    """The context to stamp on an outgoing TaskSpec: the submitter's
    active span becomes the task's parent. Submitting outside any span
    (driver top level) roots a fresh trace."""
    if not tracing_enabled():
        return None
    ctx = _current.get()
    if ctx is None:
        ctx = (new_trace_id(), new_span_id())
        _current.set(ctx)   # the driver's implicit root span
    return ctx


@contextlib.contextmanager
def activate(trace_ctx: tuple, name: str):
    """Worker-side: open a child span of `trace_ctx` around a task body.
    Yields the span record; the caller ships it home on the done message."""
    trace_id, parent_id = trace_ctx
    span_id = new_span_id()
    rec = {"trace_id": trace_id, "span_id": span_id,
           "parent_id": parent_id, "name": name,
           "start_s": time.time()}
    token = _current.set((trace_id, span_id))
    try:
        yield rec
    finally:
        _current.reset(token)
        rec["dur_s"] = time.time() - rec["start_s"]
        _export_otel(rec)


@contextlib.contextmanager
def span(name: str, root: bool = False):
    """User-facing in-process span (driver or inside a task): children
    submitted within parent to it; the span lands in the local runtime's
    timeline when one exists. ``root=True`` ignores any ambient context
    and starts a fresh trace — per-request servers use it so every
    request becomes its own span tree instead of all parenting to the
    long-lived span that happened to be active when the server booted."""
    if not tracing_enabled():
        yield None
        return
    ctx = None if root else _current.get()
    if ctx is None:
        ctx = (new_trace_id(), new_span_id())
        trace_id, parent_id = ctx[0], None
    else:
        trace_id, parent_id = ctx
    span_id = new_span_id()
    rec = {"trace_id": trace_id, "span_id": span_id,
           "parent_id": parent_id, "name": name, "start_s": time.time()}
    token = _current.set((trace_id, span_id))
    try:
        yield rec
    finally:
        _current.reset(token)
        rec["dur_s"] = time.time() - rec["start_s"]
        record_span(rec)
        _export_otel(rec)


def record_span(rec: dict) -> None:
    """Append a completed span to the local runtime's timeline (head) or
    ship it via the worker's control connection."""
    from ..core import runtime as rt_mod
    rt = rt_mod.get_runtime_if_exists()
    if rt is None:
        return
    if hasattr(rt, "record_trace_span"):
        rt.record_trace_span(rec)
    elif hasattr(rt, "send"):           # worker runtime
        try:
            rt.send({"t": "trace_span", "span": rec})
        except Exception:
            pass  # conn gone; span loss is acceptable


def _export_otel(rec: dict) -> None:
    """Forward to the OpenTelemetry SDK when it's installed (the
    reference's default exporter path); silently absent otherwise."""
    try:
        from opentelemetry import trace as _ot  # noqa: F401
    except Exception:
        return  # SDK absent: soft-gated exporter
    try:
        tracer = _ot.get_tracer("ray_tpu_torch")
        sp = tracer.start_span(rec["name"],
                               start_time=int(rec["start_s"] * 1e9))
        sp.set_attribute("rtpu.trace_id", rec["trace_id"])
        sp.set_attribute("rtpu.span_id", rec["span_id"])
        if rec.get("parent_id"):
            sp.set_attribute("rtpu.parent_id", rec["parent_id"])
        sp.end(end_time=int((rec["start_s"] + rec["dur_s"]) * 1e9))
    except Exception:
        pass  # exporter must never break traced code
