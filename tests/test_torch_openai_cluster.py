"""The OpenAI gate under cluster Serve: the port's build_openai_app
against ray_tpu's, each deployed by its own package's ``serve.run`` on
its own runtime (one after the other), driven over HTTP through the
proxy and over the gRPC proxy, on the same weights.

The reference's replica builds its engine from its own seeded init
(``llama.init(PRNGKey(0))``, with its prefix directory on, as a
deployment runs); the port's replica gets those params carried across
with ``models/convert.params_from_numpy`` (f32 on the CPU) through
``params_refs``. The requests follow the reference's
``test_openai_completions_and_models``, ``test_openai_streaming_sse``
and ``test_openai_http_path_routing``, in the shape of
``tests/test_torch_openai_app.py``: completions go one at a time to
``/<app>/v1/completions`` and must give identical responses (text,
finish_reason, usage; chosen-token logprobs within atol 1e-4), a
chat completion identical responses, an SSE stream chunks that join
to the same text ending in ``data: [DONE]``, ``/<app>/v1/models`` and
gRPC's ``/raytpu.Serve/Call`` the same answers. The time-stamped
``id`` and ``created`` fields are left out of every comparison.
HTTP ports are never fixed (a free block per run, retried on a lost
bind)."""
import json
import socket
import urllib.request

import numpy as np
import pytest

SHAPE = dict(vocab_size=258, max_seq_len=512)
ENGINE = dict(max_batch_size=2, page_size=8, num_pages=48,
              max_pages_per_seq=16, chunk_size=16, prefill_rows=2,
              decode_window=4)
SHARED = "a shared system prompt that spans pages: " * 2
COMPLETIONS = [
    {"model": "tiny", "prompt": "hello", "max_tokens": 6},
    {"model": "tiny", "prompt": "xy", "max_tokens": 4},
    {"model": "tiny", "prompt": SHARED + "first question?",
     "max_tokens": 6, "echo": True},
    {"prompt": "tell me about pages", "max_tokens": 5, "logprobs": 1},
    {"model": "tiny", "prompt": SHARED + "second question!",
     "max_tokens": 7, "logprobs": 1},
]
CHAT = {"model": "tiny", "max_tokens": 4,
        "messages": [{"role": "user", "content": "hi"}]}
STREAM = {"model": "tiny", "prompt": "abc", "max_tokens": 5,
          "stream": True}
APP = "oai"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, path, body, timeout=300):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{APP}/{path}",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def _drive(pkg, serve, app) -> dict:
    """Deploy ``app`` under ``pkg``'s cluster Serve on a free port and
    send every request of the gate; returns what came back."""
    import grpc
    pkg.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    try:
        for attempt in range(5):
            port = _free_port()
            try:
                serve.run(app, name=APP, http_port=port)
                break
            except Exception as e:  # noqa: BLE001 — a lost bind retries
                if "address already in use" not in str(e).lower() or \
                        attempt == 4:
                    raise
                serve.shutdown()
        out = {"completions": [], "chat": None}
        for body in COMPLETIONS:
            code, _ct, raw = _post(port, "v1/completions", body)
            assert code == 200
            out["completions"].append(json.loads(raw))
        out["chat"] = json.loads(_post(port, "v1/chat/completions",
                                       CHAT)[2])
        code, ctype, raw = _post(port, "v1/completions", STREAM)
        assert code == 200
        out["sse_type"] = ctype
        out["sse"] = [ln + "\n\n" for ln in raw.decode().split("\n\n")
                      if ln]
        out["stream_whole"] = json.loads(_post(
            port, "v1/completions", dict(STREAM, stream=False))[2])
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/{APP}/v1/models",
                timeout=60) as r:
            out["models"] = json.loads(r.read())
        _h, gport = serve.start_grpc_proxy()
        with grpc.insecure_channel(f"127.0.0.1:{gport}") as ch:
            call = ch.unary_unary("/raytpu.Serve/Call")
            out["grpc"] = json.loads(call(json.dumps(
                {"app": APP, "method": "v1_completions",
                 "payload": COMPLETIONS[0]}).encode(), timeout=300))
            out["grpc_models"] = json.loads(call(json.dumps(
                {"app": APP, "method": "v1_models"}).encode(),
                timeout=60))
        return out
    finally:
        serve.shutdown()
        pkg.shutdown()


@pytest.fixture(scope="module")
def runs():
    """(reference run, port run): each package's app under its own
    cluster Serve, on the same weights."""
    import jax

    import ray_tpu
    import ray_tpu_torch
    from ray_tpu import serve as jserve
    from ray_tpu.llm import PagedEngineConfig as JaxPagedConfig
    from ray_tpu.llm.openai_api import build_openai_app as jax_build
    from ray_tpu.llm.serving import LLMConfig as JaxLLMConfig
    from ray_tpu.models import llama as jllama
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import (LLMConfig, PagedEngineConfig,
                                   build_openai_app)
    from ray_tpu_torch.models import llama as tllama
    from ray_tpu_torch.models.convert import params_from_numpy

    for pkg in (ray_tpu, ray_tpu_torch):
        if pkg.is_initialized():
            pkg.shutdown()
    ref = _drive(ray_tpu, jserve, jax_build([JaxLLMConfig(
        model_id="tiny", warmup=False,
        engine=JaxPagedConfig(model=jllama.llama_tiny(**SHAPE),
                              **ENGINE))]))
    params = params_from_numpy(
        jax.tree.map(np.asarray, jllama.init(jax.random.PRNGKey(0),
                                             jllama.llama_tiny(**SHAPE))),
        tllama.llama_tiny(**SHAPE), device="cpu")
    port = _drive(ray_tpu_torch, serve, build_openai_app([LLMConfig(
        model_id="tiny", warmup=False,
        engine=PagedEngineConfig(model=tllama.llama_tiny(**SHAPE),
                                 **ENGINE))],
        params_refs=[params], device="cpu"))
    return ref, port


def _no_stamps(resp: dict) -> dict:
    return {k: v for k, v in resp.items() if k not in ("id", "created")}


def _split_logprobs(resp):
    resp = json.loads(json.dumps(_no_stamps(resp)))
    return resp, resp["choices"][0].pop("logprobs", None)


def test_completions_over_http_match_reference(runs):
    ref, port = runs
    for body, a, b in zip(COMPLETIONS, ref["completions"],
                          port["completions"]):
        assert b["object"] == "text_completion"
        assert b["id"].startswith("cmpl-") and isinstance(b["created"], int)
        assert b["model"] == "tiny" and b["usage"]["completion_tokens"] > 0
        a, alp = _split_logprobs(a)
        b, blp = _split_logprobs(b)
        assert b == a, body
        assert (alp is None) == (blp is None) == (not body.get("logprobs"))
        if alp is not None:
            assert blp["tokens"] == alp["tokens"]
            np.testing.assert_allclose(blp["token_logprobs"],
                                       alp["token_logprobs"], atol=1e-4)


def test_chat_completion_over_http_matches_reference(runs):
    ref, port = runs
    assert port["chat"]["object"] == "chat.completion"
    assert port["chat"]["choices"][0]["message"]["role"] == "assistant"
    assert _no_stamps(port["chat"]) == _no_stamps(ref["chat"])


def test_sse_stream_joins_to_the_reference_text(runs):
    texts = []
    for run in runs:
        assert run["sse_type"].startswith("text/event-stream")
        lines = run["sse"]
        assert lines[-1] == "data: [DONE]\n\n"
        assert all(ln.startswith("data: ") for ln in lines)
        payloads = [json.loads(ln[6:]) for ln in lines[:-1]]
        assert {p["object"] for p in payloads} == {"text_completion.chunk"}
        assert payloads[-1]["choices"][0]["finish_reason"] in (
            "stop", "length")
        text = "".join(p["choices"][0]["text"] for p in payloads)
        assert len(text) > 0
        assert text == run["stream_whole"]["choices"][0]["text"]
        texts.append((text, payloads[-1]["choices"][0]["finish_reason"]))
    assert texts[1] == texts[0]


def test_models_and_grpc_route_match_reference(runs):
    ref, port = runs
    assert port["models"] == ref["models"] == {"object": "list", "data": [
        {"id": "tiny", "object": "model", "owned_by": "ray_tpu"}]}
    assert port["grpc_models"] == port["models"]
    assert ref["grpc_models"] == ref["models"]
    assert _no_stamps(port["grpc"]) == _no_stamps(ref["grpc"])
    # the gRPC route answers what the HTTP path answered
    assert _no_stamps(port["grpc"]) == _no_stamps(port["completions"][0])
