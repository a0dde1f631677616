"""OpenAI-compatible request and response shaping over LLM servers.

Counterpart of ``ray_tpu/llm/openai_api.py`` (reference parity: the
ray.llm OpenAI router, llm/_internal/serve/deployments/routers/router.py
— /v1/models, /v1/completions, /v1/chat/completions with SSE
streaming), built as a plain Serve deployment. ``OpenAIRouter`` only
calls ``handle.options(method_name=...[, stream=True]).remote(body)``
and ``.result(timeout_s=...)`` on the handles it is given, so any
object with that surface drives it. ``build_openai_app`` makes it the
ingress over one ``build_llm_deployment`` per config. ``serve.run``
deploys it on the port's runtime, reachable over HTTP at
``/<app>/v1/completions`` (and the gRPC proxy's ``/raytpu.Serve/Call``);
with ``local_testing_mode=True`` it runs in this process:

    app = build_openai_app([LLMConfig(model_id="m1", engine=...,
                                      gpus_per_replica=1)])
    router = serve.run(app, name="llm", http_port=8000)
    out = router.v1_completions.remote({"model": "m1",
                                        "prompt": "hi"}).result()
"""
from __future__ import annotations

import time
from typing import Optional

from .serving import LLMConfig, build_llm_deployment


def apply_chat_template(messages: list[dict]) -> str:
    """Minimal generic chat template (the byte tokenizer has no special
    tokens; reference models bring their own via the tokenizer)."""
    parts = []
    for m in messages:
        role = m.get("role", "user")
        parts.append(f"<|{role}|>\n{m.get('content', '')}")
    parts.append("<|assistant|>\n")
    return "\n".join(parts)


class OpenAIRouter:
    """Ingress: routes by the request's ``model`` field to the LLM
    server handles it was built with."""

    def __init__(self, model_ids: list, *handles):
        self._handles = dict(zip(model_ids, handles))

    def _handle(self, body: dict):
        model = body.get("model", "")
        base = model.split(":", 1)[0] if model else ""
        if base in self._handles:
            return self._handles[base]
        if not base and len(self._handles) == 1:
            return next(iter(self._handles.values()))
        raise ValueError(
            f"unknown model {model!r}; serving: {list(self._handles)}")

    # path-routed methods (/app/v1/models -> v1_models) ------------------ #

    def v1_models(self, _body: Optional[dict] = None) -> dict:
        return {"object": "list",
                "data": [{"id": mid, "object": "model",
                          "owned_by": "ray_tpu"}
                         for mid in self._handles]}

    def v1_completions(self, body: dict):
        body = dict(body or {})
        h = self._handle(body)
        if body.get("stream"):
            return self._sse(h, body)
        out = h.options(method_name="completions").remote(body).result(
            timeout_s=300)
        out.update(id=f"cmpl-{int(time.time() * 1000)}",
                   created=int(time.time()))
        return out

    def v1_chat_completions(self, body: dict):
        body = dict(body or {})
        body["prompt"] = apply_chat_template(body.get("messages", []))
        h = self._handle(body)
        if body.get("stream"):
            return self._sse(h, body, chat=True)
        out = h.options(method_name="completions").remote(body).result(
            timeout_s=300)
        text = out["choices"][0]["text"]
        return {
            "id": f"chatcmpl-{int(time.time() * 1000)}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": out["model"],
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": text},
                "finish_reason": out["choices"][0]["finish_reason"],
            }],
            "usage": out["usage"],
        }

    def _sse(self, h, body: dict, chat: bool = False):
        """Generator of SSE lines (a proxy streams these verbatim)."""
        import json
        gen = h.options(method_name="completions_stream",
                        stream=True).remote(body)
        for chunk in gen:
            if chat:
                delta = chunk["choices"][0]["text"]
                chunk = {
                    "object": "chat.completion.chunk",
                    "model": chunk["model"],
                    "choices": [{
                        "index": 0,
                        "delta": {"content": delta},
                        "finish_reason": chunk["choices"][0][
                            "finish_reason"],
                    }],
                }
            yield f"data: {json.dumps(chunk)}\n\n"
        yield "data: [DONE]\n\n"


def build_openai_app(configs: list[LLMConfig], params_refs=None,
                     device="cuda"):
    """[LLMConfig] -> Serve Application with the OpenAI router as ingress
    (reference: build_openai_app). ``params_refs``: one params dict (or
    None) per config; ``device`` reaches every ``LLMServer``."""
    from .. import serve
    params_refs = params_refs or [None] * len(configs)
    children = [build_llm_deployment(cfg, ref, device=device)
                for cfg, ref in zip(configs, params_refs)]
    router = serve.deployment(OpenAIRouter, name="openai-router")
    return router.bind([c.model_id for c in configs], *children)
