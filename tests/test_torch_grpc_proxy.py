"""The gRPC proxy over the port's runtime (``serve.start_grpc_proxy``).

The two cases of ``tests/test_grpc_proxy.py`` with the reference's
assertions: the generic ``/raytpu.Serve/Call`` and ``/CallStream``
methods (JSON envelopes) route to an app's ingress, and a deployment's
error and a private method map to gRPC statuses. The proxy binds a
free port of its own choosing (port 0). One runtime serves the module;
the deployments are defined inside the tests, so replicas never import
this module."""
import json

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve


@pytest.fixture(scope="module")
def runtime():
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=2, object_store_memory=128 * 1024 * 1024)
    yield rt
    serve.shutdown()
    rt.shutdown()


@pytest.fixture
def ray(runtime):
    yield runtime
    serve.shutdown()


def test_grpc_unary_and_stream(ray):
    grpc = pytest.importorskip("grpc")

    @serve.deployment
    class Api:
        def __call__(self, payload):
            return {"echo": payload, "n": (payload or {}).get("n", 0) * 2}

        def tokens(self, n):
            for i in range(n):
                yield {"tok": i}

    serve.run(Api.bind(), name="gapp")
    _, port = serve.start_grpc_proxy()

    ch = grpc.insecure_channel(f"127.0.0.1:{port}")
    call = ch.unary_unary("/raytpu.Serve/Call")
    out = json.loads(call(json.dumps(
        {"app": "gapp", "payload": {"n": 21}}).encode(), timeout=60))
    assert out == {"echo": {"n": 21}, "n": 42}

    stream = ch.unary_stream("/raytpu.Serve/CallStream")
    chunks = [json.loads(c) for c in stream(json.dumps(
        {"app": "gapp", "method": "tokens", "payload": 3}).encode(),
        timeout=60)]
    assert chunks == [{"tok": 0}, {"tok": 1}, {"tok": 2}]
    ch.close()


def test_grpc_errors_map_to_status(ray):
    grpc = pytest.importorskip("grpc")

    @serve.deployment
    def boom(payload=None):
        raise RuntimeError("nope")

    serve.run(boom.bind(), name="gerr")
    _, port = serve.start_grpc_proxy()
    ch = grpc.insecure_channel(f"127.0.0.1:{port}")
    call = ch.unary_unary("/raytpu.Serve/Call")
    with pytest.raises(grpc.RpcError) as ei:
        call(json.dumps({"app": "gerr"}).encode(), timeout=60)
    assert ei.value.code() == grpc.StatusCode.INTERNAL
    # private methods are not routable
    with pytest.raises(grpc.RpcError):
        call(json.dumps({"app": "gerr", "method": "_handle"}).encode(),
             timeout=60)
    ch.close()
