"""The port's LLMServer and OpenAIRouter against ray_tpu's, in process.

Both servers run the paged engine on the same weights (the reference's
random init, converted with ``models/convert.params_from_numpy``), f32,
on the CPU, with the reference's cluster prefix directory off (the port
has none). Sequential requests give identical responses — text,
finish_reason and usage; chosen-token logprobs within atol 1e-4 (both
take log_softmax of f32 logits that agree to ~1e-5). Concurrent
requests batch by timing, so only their tokens are compared. Router
responses are compared on their shape and content, leaving out the
time-stamped ``id`` and ``created`` fields, and streamed chunks on their
joined text (chunk boundaries follow the polling)."""
import json
import os
import sys
import threading

import jax
import numpy as np
import pytest

from ray_tpu.core.config import cfg as jax_rcfg
from ray_tpu.llm import EngineConfig as JaxEngineConfig
from ray_tpu.llm import PagedEngineConfig as JaxPagedConfig
from ray_tpu.llm.openai_api import OpenAIRouter as JaxRouter
from ray_tpu.llm.serving import LLMConfig as JaxLLMConfig
from ray_tpu.llm.serving import LLMServer as JaxLLMServer
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import (EngineConfig, LLMConfig, LLMServer,
                               OpenAIRouter, PagedEngineConfig)
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.util import metrics

SHAPE = dict(vocab_size=258, max_seq_len=512)
ENGINE = dict(max_batch_size=2, page_size=8, num_pages=48,
              max_pages_per_seq=16, chunk_size=16, prefill_rows=2,
              decode_window=4)
SHARED = "a shared system prompt that spans pages: " * 2
REQUESTS = [
    {"prompt": "the quick brown fox", "max_tokens": 8},
    {"prompt": SHARED + "first question?", "max_tokens": 6, "echo": True},
    {"prompt": "tell me about pages", "max_tokens": 5, "logprobs": 1},
    {"prompt": SHARED + "second question!", "max_tokens": 7,
     "logprobs": 1},
    {"prompt": [5, 6, 7, 8, 9, 10, 11, 12, 13], "max_tokens": 4,
     "echo": True},
]


def _stop(srv):
    srv._stop = True
    srv._wake.set()
    srv._thread.join(timeout=30)


def _port_params(jax_params):
    return params_from_numpy(jax.tree.map(np.asarray, jax_params),
                             tllama.llama_tiny(**SHAPE), device="cpu")


def _servers(model_id="tiny", **engine_kw):
    """(reference server, port server) over the same weights, with the
    reference's prefix directory off."""
    jax_rcfg.override(serve_prefix_directory=False)
    try:
        ref = JaxLLMServer(JaxLLMConfig(
            model_id=model_id, warmup=False,
            engine=JaxPagedConfig(model=jllama.llama_tiny(**SHAPE),
                                  **engine_kw)))
    finally:
        jax_rcfg.reset("serve_prefix_directory")
    port = LLMServer(LLMConfig(
        model_id=model_id, warmup=False,
        engine=PagedEngineConfig(model=tllama.llama_tiny(**SHAPE),
                                 **engine_kw)),
        params_ref=_port_params(ref.engine.params), device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def served():
    """Both servers after REQUESTS, one at a time; their responses and
    engine_stats snapshots."""
    ref, port = _servers(**ENGINE)
    try:
        out = {"ref": [ref.completions(dict(r)) for r in REQUESTS],
               "port": [port.completions(dict(r)) for r in REQUESTS]}
        out["ref_stats"] = ref.engine_stats()
        out["port_stats"] = port.engine_stats()
        yield ref, port, out
    finally:
        _stop(ref)
        _stop(port)


def _strip_logprobs(resp):
    resp = json.loads(json.dumps(resp))
    lps = resp["choices"][0].pop("logprobs", None)
    return resp, lps


def test_sequential_completions_match_reference(served):
    _, _, out = served
    for body, a, b in zip(REQUESTS, out["ref"], out["port"]):
        a, alp = _strip_logprobs(a)
        b, blp = _strip_logprobs(b)
        assert b == a, body
        assert (alp is None) == (blp is None) == (not body.get("logprobs"))
        if alp is not None:
            assert blp["tokens"] == alp["tokens"]
            assert blp["top_logprobs"] is None
            np.testing.assert_allclose(blp["token_logprobs"],
                                       alp["token_logprobs"], atol=1e-4)
    echoed = out["port"][1]["choices"][0]["text"]
    assert echoed.startswith(REQUESTS[1]["prompt"])


def test_engine_stats_agree_on_shared_keys(served):
    _, _, out = served
    a, b = out["ref_stats"], out["port_stats"]
    shared = set(a) & set(b)
    assert {"prefill_dispatches", "decode_dispatches", "tokens_out",
            "prefix_hits", "prefix_misses", "mesh"} <= shared
    assert {k: b[k] for k in shared} == {k: a[k] for k in shared}
    assert b["prefix_hits"] > 0
    assert b["mesh"] is None


def test_stream_chunks_join_to_completions_text(served):
    _, port, _ = served
    body = {"prompt": "streamed and then some", "max_tokens": 9}
    chunks = list(port.completions_stream(dict(body)))
    assert all(c["object"] == "text_completion.chunk" for c in chunks)
    assert [c["choices"][0]["finish_reason"] for c in chunks[:-1]] == \
        [None] * (len(chunks) - 1)
    whole = port.completions(dict(body))["choices"][0]
    assert "".join(c["choices"][0]["text"] for c in chunks) == whole["text"]
    assert chunks[-1]["choices"][0]["finish_reason"] == \
        whole["finish_reason"]


def test_concurrent_requests_give_the_sequential_tokens():
    """Four request threads at once batch together on the engine thread
    and still get the tokens each gets alone (greedy)."""
    cfg = LLMConfig(engine=PagedEngineConfig(
        model=tllama.llama_tiny(**SHAPE), **dict(ENGINE, max_batch_size=4)))
    params = tllama.init(tllama.llama_tiny(**SHAPE), seed=4, device="cpu")
    srv = LLMServer(cfg, params_ref=params, device="cpu")
    tokens = {}
    result = srv.engine._result

    def recording_result(req):
        tokens.setdefault(tuple(req.prompt_ids), []).append(
            list(req.out_ids))
        return result(req)
    srv.engine._result = recording_result
    bodies = [{"prompt": f"request {i}: " + "abc" * (3 * i + 1),
               "max_tokens": 6 + i} for i in range(4)]
    try:
        alone = [srv.completions(dict(b)) for b in bodies]
        together = [None] * 4

        def run(i):
            together[i] = srv.completions(dict(bodies[i]))
        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert together == alone
        assert len(tokens) == 4
        for runs in tokens.values():
            assert len(runs) == 2 and runs[0] == runs[1]
        srv.check_health()
    finally:
        _stop(srv)


def test_many_request_threads_lose_no_update():
    """Stress: more request threads than cores, with a short thread
    switch interval, against the engine thread. Every request gets a
    distinct id and a well-formed response, and the engine's token count,
    the responses' usage and the telemetry counters all agree (a lost
    update in submit or retirement would break one of them)."""
    metrics._reset_registry()
    cfg = LLMConfig(engine=PagedEngineConfig(
        model=tllama.llama_tiny(**SHAPE), **dict(ENGINE, max_batch_size=4)))
    srv = LLMServer(cfg, device="cpu")
    n = 3 * (os.cpu_count() or 8)
    rids, result = [], srv.engine._result

    def recording_result(req):
        rids.append(req.rid)
        return result(req)
    srv.engine._result = recording_result
    out = [None] * n

    def run(i):
        out[i] = srv.completions({"prompt": f"r{i} " * (i % 5 + 1),
                                  "max_tokens": 2 + i % 4})
    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
        _stop(srv)
    assert not any(t.is_alive() for t in threads)
    assert sorted(rids) == list(range(n))
    used = [r["usage"]["completion_tokens"] for r in out]
    assert all(1 <= u <= 2 + i % 4 for i, u in enumerate(used))
    assert srv.engine.stats["tokens_out"] == sum(used)
    store = metrics.local_store()
    assert sum(store["rtpu_llm_requests_total"]["series"].values()) == n
    assert sum(store["rtpu_llm_tokens_generated_total"]["series"]
               .values()) == sum(used)
    metrics._reset_registry()


def test_dense_config_refuses_logprobs_like_the_reference():
    ref = JaxLLMServer(JaxLLMConfig(engine=JaxEngineConfig(
        model=jllama.llama_tiny(**SHAPE), max_batch_size=2,
        max_seq_len=64)))
    port = LLMServer(LLMConfig(engine=EngineConfig(
        model=tllama.llama_tiny(**SHAPE), max_batch_size=2,
        max_seq_len=64)), device="cpu")
    try:
        msgs = []
        for srv in (ref, port):
            with pytest.raises(ValueError) as e:
                srv.completions({"prompt": "hi", "logprobs": 1})
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        assert "paged engine" in msgs[1]
    finally:
        _stop(ref)
        _stop(port)


def test_lora_requests_raise():
    """No lora_dir: the reference's ValueError. With one: not ported."""
    eng = PagedEngineConfig(model=tllama.llama_tiny(**SHAPE), **ENGINE)
    port = LLMServer(LLMConfig(engine=eng, warmup=False), device="cpu")
    with_dir = LLMServer(LLMConfig(engine=eng, warmup=False,
                                   lora_dir="/nonexistent"), device="cpu")
    try:
        for body in ({"prompt": "hi", "lora": "tenant-a"},
                     {"prompt": "hi", "model": "tiny:tenant-a"}):
            with pytest.raises(ValueError, match="no lora_dir configured"):
                port.completions(dict(body))
            with pytest.raises(NotImplementedError, match="LoRA"):
                with_dir.completions(dict(body))
        assert port.loaded_loras() == []
        with pytest.raises(NotImplementedError, match="export_prefix"):
            port.export_prefix([b"x"])
    finally:
        _stop(port)
        _stop(with_dir)


def test_dispatch_failure_ends_the_loop_and_raises():
    """An exception inside a dispatch ends the engine loop: completions
    raises RuntimeError("llm engine loop died"), and so does
    check_health; nothing falls back."""
    srv = LLMServer(LLMConfig(engine=PagedEngineConfig(
        model=tllama.llama_tiny(**SHAPE), **ENGINE), warmup=True),
        device="cpu")
    srv.check_health()

    def boom():
        raise RuntimeError("injected dispatch failure")
    srv.engine.step = boom
    try:
        with pytest.raises(RuntimeError, match="llm engine loop died") as e:
            srv.completions({"prompt": "hello", "max_tokens": 4})
        assert "injected dispatch failure" in str(e.value.__cause__)
        with pytest.raises(RuntimeError, match="engine loop died"):
            srv.check_health()
        srv._thread.join(timeout=30)
        assert not srv._thread.is_alive()
    finally:
        _stop(srv)


# -- OpenAIRouter over each package's server ---------------------------------

class _Result:
    def __init__(self, value):
        self._value = value

    def result(self, timeout_s=None):
        return self._value


class _Handle:
    """The slice of a Serve deployment handle the router calls:
    ``options(method_name=..., stream=...)``, ``remote(body)`` and
    ``.result(timeout_s=...)``."""

    def __init__(self, server, method="__call__", stream=False):
        self._server, self._method, self._stream = server, method, stream

    def options(self, method_name=None, stream=False):
        return _Handle(self._server, method_name or self._method, stream)

    def remote(self, body):
        out = getattr(self._server, self._method)(body)
        return out if self._stream else _Result(out)


def _no_stamps(resp: dict) -> dict:
    return {k: v for k, v in resp.items() if k not in ("id", "created")}


def _sse_chunks(lines):
    lines = list(lines)
    assert lines[-1] == "data: [DONE]\n\n"
    assert all(ln.startswith("data: ") and ln.endswith("\n\n")
               for ln in lines)
    return [json.loads(ln[len("data: "):]) for ln in lines[:-1]]


def test_openai_router_shapes_match_reference(served):
    ref, port, _ = served
    routers = (JaxRouter(["tiny"], _Handle(ref)),
               OpenAIRouter(["tiny"], _Handle(port)))
    a, b = (r.v1_models() for r in routers)
    assert b == a
    body = {"model": "tiny", "prompt": "route me", "max_tokens": 5}
    a, b = (r.v1_completions(dict(body)) for r in routers)
    assert {"id", "created"} <= set(b)
    assert b["id"].startswith("cmpl-")
    assert _no_stamps(b) == _no_stamps(a)
    chat = {"model": "tiny", "max_tokens": 6, "messages": [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": "hello?"}]}
    a, b = (r.v1_chat_completions(dict(chat)) for r in routers)
    assert b["id"].startswith("chatcmpl-")
    assert _no_stamps(b) == _no_stamps(a)
    assert b["object"] == "chat.completion"
    for call, req, obj, key in (
            ("v1_completions", body, "text_completion.chunk", "text"),
            ("v1_chat_completions", chat, "chat.completion.chunk",
             "delta")):
        texts, finals = [], []
        for r in routers:
            chunks = _sse_chunks(getattr(r, call)(dict(req, stream=True)))
            assert {c["object"] for c in chunks} == {obj}
            assert {c["model"] for c in chunks} == {"tiny"}
            pieces = [c["choices"][0][key] for c in chunks]
            if key == "delta":
                pieces = [p["content"] for p in pieces]
            texts.append("".join(pieces))
            finals.append(chunks[-1]["choices"][0]["finish_reason"])
        assert texts[1] == texts[0] and finals[1] == finals[0]
    with pytest.raises(ValueError, match="unknown model"):
        routers[1].v1_completions({"model": "other", "prompt": "x"})
