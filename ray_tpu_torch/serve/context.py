"""Per-request serve context.

Counterpart of ``ray_tpu/serve/context.py`` (reference parity:
serve/context.py — _serve_request_context contextvar carrying request id
/ multiplexed model id into user code). The engine's telemetry reads the
request id from it at submit (``llm/telemetry.on_submit``).
"""
from __future__ import annotations

import contextvars
import dataclasses


@dataclasses.dataclass
class RequestContext:
    request_id: str = ""
    multiplexed_model_id: str = ""
    app_name: str = ""
    deployment: str = ""


_request_context: contextvars.ContextVar[RequestContext] = \
    contextvars.ContextVar("rtpu_serve_request_context",
                           default=RequestContext())


def get_request_context() -> RequestContext:
    return _request_context.get()


def set_request_context(**fields) -> contextvars.Token:
    return _request_context.set(RequestContext(**fields))


def reset_request_context(token: contextvars.Token) -> None:
    _request_context.reset(token)


def get_multiplexed_model_id() -> str:
    """Inside a deployment: the model id the current request was routed
    with (reference: serve.get_multiplexed_model_id)."""
    return _request_context.get().multiplexed_model_id
