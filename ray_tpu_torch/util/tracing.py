"""Trace-context propagation.

Counterpart of ``ray_tpu/util/tracing.py`` (reference parity:
python/ray/util/tracing/tracing_helper.py:293 and :326). A context is a
(trace_id, span_id) pair held in a contextvar: the serving engine stamps
the submitter's context on each request (``llm/telemetry.on_submit``).
W3C-sized ids (128-bit trace).

The reference records spans (its ``span`` context manager and each
request's ``llm.request`` span) into its runtime's timeline. The port
has no runtime yet, so nothing records spans: they wait for the
runtime's port, and until then a request carries its context only.

Enable with ``cfg.override(tracing_enabled=True)`` (or
``RTPU_TRACING_ENABLED=1``).
"""
from __future__ import annotations

import contextvars
import secrets
from typing import Optional

# (trace_id_hex, span_id_hex) of the ACTIVE span in this context
_current: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "rtpu_trace_ctx", default=None)


def tracing_enabled() -> bool:
    from ..core.config import cfg
    return bool(cfg.tracing_enabled)


def new_trace_id() -> str:
    return secrets.token_hex(16)


def current_context() -> Optional[tuple]:
    """(trace_id, span_id) of the active span, or None."""
    return _current.get()
