"""``LLMServer`` as an actor of each package's runtime, one after the
other, on the same weights.

The reference's server gets its own params (``llama.init`` from a seed)
through an ``ObjectRef``, as its ``LLMServer`` reads ``params_ref``. The
port's gets the same params carried across by
``models/convert.params_from_numpy``, ``put`` into the port's object
store as CPU tensors and passed as an ``ObjectRef``, with
``device="cpu"`` (the plain versions of the kernels). Each actor answers
the same requests one at a time through ``completions``; the token ids
are read from the engine's results inside the actor. Greedy tokens must
be equal and the chosen-token logprobs within 1e-4 (both take the
log_softmax of f32 logits that agree to ~1e-5, as in
``tests/test_torch_llm_server.py``). The port's actor process loads
neither JAX nor the reference package.

The refs ride inside a list: a top-level ObjectRef argument is resolved
before the call, and ``LLMServer`` is to be handed the ref itself."""
import os
import time

import numpy as np
import pytest

SHAPE = dict(vocab_size=258, max_seq_len=512)
ENGINE = dict(max_batch_size=2, page_size=8, num_pages=48,
              max_pages_per_seq=16, chunk_size=16, prefill_rows=2,
              decode_window=4)
REQUESTS = [
    {"prompt": "the quick brown fox", "max_tokens": 8, "logprobs": 1},
    {"prompt": "a prompt that spans more than two pages of eight",
     "max_tokens": 6, "logprobs": 1},
    {"prompt": [5, 6, 7, 8, 9, 10, 11, 12, 13], "max_tokens": 5,
     "logprobs": 1},
]


def _host_class(pkg, server_cls):
    """An actor class around ``server_cls`` that records each request's
    token ids from the engine's results."""

    @pkg.remote(max_restarts=0)
    class Host:
        def __init__(self, cfg, refs, kw):
            self.srv = server_cls(cfg, refs[0], **kw)
            self.ids = []
            eng = self.srv.engine
            result = eng._result

            def recording(req):
                out = result(req)
                self.ids.append([int(t) for t in out["token_ids"]])
                return out
            eng._result = recording

        def complete(self, body):
            resp = self.srv.completions(dict(body))
            lp = resp["choices"][0]["logprobs"]["token_logprobs"]
            return self.ids[-1], [float(x) for x in lp], \
                resp["choices"][0]["text"]

        def process(self):
            import sys
            return os.environ.get("CUDA_VISIBLE_DEVICES"), sorted(
                m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))

        def stop(self):
            self.srv._stop = True
            self.srv._wake.set()
            self.srv._thread.join(timeout=30)
            return True

    return Host


def _serve(pkg, server_cls, cfg, params, kw) -> dict:
    pkg.init(num_cpus=1, object_store_memory=128 * 1024 * 1024)
    try:
        ref = pkg.put(params)
        h = _host_class(pkg, server_cls).remote(cfg, [ref], kw)
        t0 = time.monotonic()
        out = [pkg.get(h.complete.remote(b), timeout=300) for b in REQUESTS]
        secs = time.monotonic() - t0
        proc = pkg.get(h.process.remote(), timeout=60)
        pkg.get(h.stop.remote(), timeout=60)
        return {"out": out, "process": proc, "secs": secs}
    finally:
        pkg.shutdown()


def test_port_actor_matches_the_reference_actor():
    import jax

    import ray_tpu
    import ray_tpu_torch
    from ray_tpu.core.config import cfg as jax_rcfg
    from ray_tpu.llm import PagedEngineConfig as JaxPagedConfig
    from ray_tpu.llm.serving import LLMConfig as JaxLLMConfig
    from ray_tpu.llm.serving import LLMServer as JaxLLMServer
    from ray_tpu.models import llama as jllama
    from ray_tpu_torch.llm import LLMConfig, LLMServer, PagedEngineConfig
    from ray_tpu_torch.models import llama as tllama
    from ray_tpu_torch.models.convert import params_from_numpy

    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    jax_params = jllama.init(jax.random.PRNGKey(0),
                             jllama.llama_tiny(**SHAPE))
    # the reference's prefix directory publishes to Serve's controller,
    # which this test does not run; workers read the override from env
    jax_rcfg.override(serve_prefix_directory=False)
    try:
        ref = _serve(ray_tpu, JaxLLMServer, JaxLLMConfig(
            model_id="tiny", warmup=False,
            engine=JaxPagedConfig(model=jllama.llama_tiny(**SHAPE),
                                  **ENGINE)), jax_params, {})
    finally:
        jax_rcfg.reset("serve_prefix_directory")
    port_params = params_from_numpy(jax.tree.map(np.asarray, jax_params),
                                    tllama.llama_tiny(**SHAPE),
                                    device="cpu")
    port = _serve(ray_tpu_torch, LLMServer, LLMConfig(
        model_id="tiny", warmup=False,
        engine=PagedEngineConfig(model=tllama.llama_tiny(**SHAPE),
                                 **ENGINE)), port_params, {"device": "cpu"})

    assert port["process"] == ("", [])
    for body, (ids_r, lp_r, text_r), (ids_p, lp_p, text_p) in zip(
            REQUESTS, ref["out"], port["out"]):
        assert ids_p == ids_r, body
        assert text_p == text_r, body
        assert len(ids_p) == body["max_tokens"] or 257 in ids_p
        np.testing.assert_allclose(lp_p, lp_r, atol=1e-4)


def test_params_ref_is_carried_onto_the_servers_device():
    """An ObjectRef of CPU tensors becomes the engine's params on the
    server's device (the CPU here, as ``device="cpu"``), equal to what
    was put; a params dict passed directly still works."""
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.llm import LLMConfig, LLMServer, PagedEngineConfig
    from ray_tpu_torch.models import llama

    mc = llama.llama_tiny(**SHAPE)
    params = llama.init(mc, seed=5, device="cpu")
    cfg = LLMConfig(warmup=False, engine=PagedEngineConfig(model=mc,
                                                           **ENGINE))
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=1, object_store_memory=64 * 1024 * 1024)
    try:
        srv = LLMServer(cfg, ray_tpu_torch.put(params), device="cpu")
        direct = LLMServer(cfg, params, device="cpu")
        try:
            for got in (srv.engine.params, direct.engine.params):
                assert got["embed"].device.type == "cpu"
                assert torch.equal(got["embed"], params["embed"])
            body = {"prompt": "same weights", "max_tokens": 4}
            assert srv.completions(dict(body)) == \
                direct.completions(dict(body))
            # the ref's route is timed; a dict has no route to time
            assert sorted(srv.load_s) == ["get_s", "to_device_s"]
            assert all(t >= 0 for t in srv.load_s.values())
            assert direct.load_s == {}
        finally:
            for s in (srv, direct):
                s._stop = True
                s._wake.set()
    finally:
        ray_tpu_torch.shutdown()
    with pytest.raises(RuntimeError, match="init"):
        LLMServer(cfg, _stale_ref(), device="cpu")


def _stale_ref():
    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.core.ref import ObjectRef
    return ObjectRef(ObjectID.from_random())
