"""The port's build_openai_app against ray_tpu's, each run by its own
package's serve.run(..., local_testing_mode=True), in process, on the
same weights.

The reference app builds its replica with its own random init (each
package's cluster prefix directory off, as the reference's tests do:
local apps have no replica handle to publish under); the port's app gets
that replica's params, converted with ``models/convert.params_from_numpy``,
through ``params_refs``, f32 on the CPU. Requests go one at a time
through each ingress handle: completions give identical responses (text,
finish_reason, usage; chosen-token logprobs within atol 1e-4, as in
tests/test_torch_llm_server.py), chat completions identical responses,
and streamed SSE lines join to the same text and end in ``data:
[DONE]``. The time-stamped ``id`` and ``created`` fields are left out of
every comparison."""
import json

import jax
import numpy as np
import pytest

from ray_tpu import serve as jserve
from ray_tpu.core.config import cfg as jax_rcfg
from ray_tpu.llm import PagedEngineConfig as JaxPagedConfig
from ray_tpu.llm.openai_api import build_openai_app as jax_build_openai_app
from ray_tpu.llm.serving import LLMConfig as JaxLLMConfig
from ray_tpu.llm.serving import \
    build_llm_deployment as jax_build_llm_deployment
from ray_tpu.models import llama as jllama
from ray_tpu_torch import serve
from ray_tpu_torch.core.config import cfg as port_rcfg
from ray_tpu_torch.llm import (LLMConfig, LLMServer, OpenAIRouter,
                               PagedEngineConfig, build_llm_deployment,
                               build_openai_app)
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy

SHAPE = dict(vocab_size=258, max_seq_len=512)
ENGINE = dict(max_batch_size=2, page_size=8, num_pages=48,
              max_pages_per_seq=16, chunk_size=16, prefill_rows=2,
              decode_window=4)
SHARED = "a shared system prompt that spans pages: " * 2
COMPLETIONS = [
    {"model": "tiny", "prompt": "the quick brown fox", "max_tokens": 8},
    {"model": "tiny", "prompt": SHARED + "first question?",
     "max_tokens": 6, "echo": True},
    {"prompt": "tell me about pages", "max_tokens": 5, "logprobs": 1},
    {"model": "tiny", "prompt": SHARED + "second question!",
     "max_tokens": 7, "logprobs": 1},
    {"model": "tiny", "prompt": [5, 6, 7, 8, 9, 10, 11, 12, 13],
     "max_tokens": 4},
]
CHATS = [
    {"model": "tiny", "max_tokens": 6, "messages": [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": "hello?"}]},
    {"model": "tiny", "max_tokens": 9, "messages": [
        {"role": "user", "content": SHARED + "and a follow-up"}]},
]
APP = "openai"


def _replica(router_handle):
    """The LLMServer behind a local app's router handle."""
    return router_handle._instance._handles["tiny"]._instance


def _stop(srv):
    srv._stop = True
    srv._wake.set()
    srv._thread.join(timeout=30)


@pytest.fixture(scope="module")
def routers():
    """(reference router handle, port router handle), each an ingress
    handle of its package's local app; both replicas stopped at the
    end."""
    jax_rcfg.override(serve_prefix_directory=False)
    try:
        ref = jserve.run(jax_build_openai_app([JaxLLMConfig(
            model_id="tiny", warmup=False,
            engine=JaxPagedConfig(model=jllama.llama_tiny(**SHAPE),
                                  **ENGINE))]),
            name=APP, local_testing_mode=True)
    finally:
        jax_rcfg.reset("serve_prefix_directory")
    params = params_from_numpy(
        jax.tree.map(np.asarray, _replica(ref).engine.params),
        tllama.llama_tiny(**SHAPE), device="cpu")
    port_rcfg.override(serve_prefix_directory=False)
    try:
        port = serve.run(build_openai_app([LLMConfig(
            model_id="tiny", warmup=False,
            engine=PagedEngineConfig(model=tllama.llama_tiny(**SHAPE),
                                     **ENGINE))],
            params_refs=[params], device="cpu"),
            name=APP, local_testing_mode=True)
    finally:
        port_rcfg.reset("serve_prefix_directory")
    try:
        yield ref, port
    finally:
        for h in (ref, port):
            _stop(_replica(h))
        jserve.delete(APP)
        serve.delete(APP)


def _no_stamps(resp: dict) -> dict:
    return {k: v for k, v in resp.items() if k not in ("id", "created")}


def _split_logprobs(resp):
    resp = json.loads(json.dumps(_no_stamps(resp)))
    return resp, resp["choices"][0].pop("logprobs", None)


def test_port_app_is_a_local_openai_app(routers):
    _, port = routers
    assert serve.get_app_handle(APP) is port
    assert isinstance(port._instance, OpenAIRouter)
    srv = _replica(port)
    assert isinstance(srv, LLMServer)
    assert srv.device.type == "cpu" and srv.model_id == "tiny"


def test_completions_match_reference(routers):
    ref, port = routers
    for body in COMPLETIONS:
        a, b = (h.v1_completions.remote(dict(body)).result(timeout_s=120)
                for h in (ref, port))
        assert b["id"].startswith("cmpl-") and isinstance(b["created"], int)
        a, alp = _split_logprobs(a)
        b, blp = _split_logprobs(b)
        assert b == a, body
        assert (alp is None) == (blp is None) == (not body.get("logprobs"))
        if alp is not None:
            assert blp["tokens"] == alp["tokens"]
            np.testing.assert_allclose(blp["token_logprobs"],
                                       alp["token_logprobs"], atol=1e-4)
    stats = [_replica(h).engine_stats() for h in (ref, port)]
    shared = set(stats[0]) & set(stats[1])
    assert {k: stats[1][k] for k in shared} == \
        {k: stats[0][k] for k in shared}
    assert stats[1]["prefix_hits"] > 0


def test_chat_completions_match_reference(routers):
    ref, port = routers
    for body in CHATS:
        a, b = (h.v1_chat_completions.remote(dict(body)).result(
            timeout_s=120) for h in (ref, port))
        assert b["id"].startswith("chatcmpl-")
        assert b["object"] == "chat.completion"
        assert _no_stamps(b) == _no_stamps(a)


def _sse_chunks(lines):
    lines = list(lines)
    assert lines[-1] == "data: [DONE]\n\n"
    assert all(ln.startswith("data: ") and ln.endswith("\n\n")
               for ln in lines)
    return [json.loads(ln[len("data: "):]) for ln in lines[:-1]]


@pytest.mark.parametrize("route,body,obj,key", [
    ("v1_completions", COMPLETIONS[0], "text_completion.chunk", "text"),
    ("v1_chat_completions", CHATS[0], "chat.completion.chunk", "delta"),
])
def test_streams_join_to_the_reference_text(routers, route, body, obj, key):
    """stream=True through the ingress handle: SSE lines whose chunks
    join to the reference's text (chunk boundaries follow the polling)
    and to the port's own non-streamed answer."""
    texts, finals = [], []
    for h in routers:
        lines = h.options(method_name=route, stream=True).remote(
            dict(body, stream=True))
        chunks = _sse_chunks(lines)
        assert {c["object"] for c in chunks} == {obj}
        assert {c["model"] for c in chunks} == {"tiny"}
        pieces = [c["choices"][0][key] for c in chunks]
        if key == "delta":
            pieces = [p["content"] for p in pieces]
        texts.append("".join(pieces))
        finals.append(chunks[-1]["choices"][0]["finish_reason"])
    assert texts[1] == texts[0] and finals[1] == finals[0]
    whole = getattr(routers[1], route).remote(dict(body)).result(
        timeout_s=120)["choices"][0]
    want = whole["text"] if key == "text" else whole["message"]["content"]
    assert texts[1] == want


def test_models_and_unknown_model(routers):
    ref, port = routers
    a, b = (h.v1_models.remote().result(timeout_s=30) for h in routers)
    assert b == a == {"object": "list", "data": [
        {"id": "tiny", "object": "model", "owned_by": "ray_tpu"}]}
    with pytest.raises(ValueError, match="unknown model"):
        port.v1_completions.remote({"model": "other",
                                    "prompt": "x"}).result(timeout_s=30)


def _jax_kw(kw: dict) -> dict:
    """The reference's LLMConfig fields for the port's: one TPU for each
    GPU a replica asks for."""
    out = {k: v for k, v in kw.items() if k != "gpus_per_replica"}
    if "gpus_per_replica" in kw:
        out["tpus_per_replica"] = float(kw["gpus_per_replica"])
    return out


def _gpu_for_tpu(opts: dict) -> dict:
    """The reference's ray_actor_options with its TPU request spelled as
    the port's whole-GPU request."""
    return {("num_gpus" if k == "num_tpus" else k):
            (int(v) if k == "num_tpus" else v) for k, v in opts.items()}


@pytest.mark.parametrize("kw", [
    {}, {"model_id": "m7", "num_replicas": 3, "max_ongoing_requests": 7},
    {"model_id": "acc", "gpus_per_replica": 1}])
def test_deployment_specs_match_reference(kw):
    """build_llm_deployment's spec (name, replicas, request cap,
    accelerator request) and build_openai_app's deployments are the
    reference's, GPU for TPU: ``gpus_per_replica=1`` asks for
    ``{"num_gpus": 1}`` where ``tpus_per_replica=1.0`` asks for
    ``{"num_tpus": 1.0}``; the port's device reaches LLMServer's init
    kwargs."""
    a = jax_build_llm_deployment(JaxLLMConfig(**_jax_kw(kw))).ingress.spec
    b = build_llm_deployment(LLMConfig(**kw), device="cpu").ingress.spec
    for field in ("name", "num_replicas", "max_ongoing_requests",
                  "autoscaling_config", "user_config"):
        assert getattr(b, field) == getattr(a, field), field
    assert b.ray_actor_options == _gpu_for_tpu(a.ray_actor_options)
    if "gpus_per_replica" in kw:
        assert b.ray_actor_options == {"num_gpus": 1}
        assert a.ray_actor_options == {"num_tpus": 1.0}
    assert b.func_or_class is LLMServer
    assert b.init_args[1] is None and b.init_kwargs == {"device": "cpu"}
    assert LLMConfig().num_replicas == JaxLLMConfig().num_replicas == 1
    assert LLMConfig().max_ongoing_requests == \
        JaxLLMConfig().max_ongoing_requests == 64
    cfgs = [LLMConfig(model_id="x", **{k: v for k, v in kw.items()
                                       if k != "model_id"}),
            LLMConfig(model_id="y")]
    jcfgs = [JaxLLMConfig(model_id=c.model_id,
                          num_replicas=c.num_replicas,
                          max_ongoing_requests=c.max_ongoing_requests,
                          tpus_per_replica=float(c.gpus_per_replica))
             for c in cfgs]
    ja, pa = jax_build_openai_app(jcfgs), build_openai_app(cfgs)
    assert [(s.name, s.num_replicas, s.max_ongoing_requests)
            for s in pa.specs()] == \
        [(s.name, s.num_replicas, s.max_ongoing_requests)
         for s in ja.specs()]
    assert pa.ingress.spec.init_args[0] == ["x", "y"]
    assert all(c.spec.init_kwargs == {"device": "cuda"}
               for c in pa.ingress.children())
