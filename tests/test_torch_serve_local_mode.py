"""The port's Serve in local testing mode: whole apps in process, no
cluster (the reference's tests/test_serve_local_mode.py cases that need
no cluster, run against ray_tpu_torch.serve), plus @serve.batch and
@serve.multiplexed inside local apps, and the reference's rule that a
cluster deploy (on the port's runtime) supersedes a local app of the
same name."""
import asyncio
import os

import pytest

from ray_tpu_torch import serve
from ray_tpu_torch.serve.local_mode import get_local_app


@pytest.fixture(autouse=True)
def _cleanup():
    yield
    serve.delete("default")
    serve.delete("other")


def test_local_mode_composition_and_methods():
    @serve.deployment
    class Scorer:
        def __init__(self, offset):
            self.offset = offset

        def score(self, x):
            return x * 2 + self.offset

    @serve.deployment
    class Ingress:
        def __init__(self, scorer):
            self.scorer = scorer

        def __call__(self, x):
            # nested response resolves before dispatch, like real handles
            return self.scorer.score.remote(x).result() + 1

    h = serve.run(Ingress.bind(Scorer.bind(10)), local_testing_mode=True)
    assert h.remote(5).result() == 21
    assert serve.get_app_handle("default") is h
    assert serve.status() == {"applications": {}}


def test_local_mode_async_and_function_deployments():
    @serve.deployment
    async def double(x):
        await asyncio.sleep(0.01)
        return x * 2

    h = serve.run(double.bind(), local_testing_mode=True)
    assert h.remote(21).result(timeout_s=5) == 42


def test_local_mode_streaming_and_user_config():
    @serve.deployment(user_config={"step": 3})
    class Gen:
        def __init__(self):
            self.step = 1

        def reconfigure(self, cfg):
            self.step = cfg["step"]

        def stream(self, n):
            for i in range(n):
                yield i * self.step

    h = serve.run(Gen.bind(), name="other", local_testing_mode=True)
    got = list(h.options(method_name="stream", stream=True).remote(4))
    assert got == [0, 3, 6, 9]


def test_local_mode_reference_spelling():
    @serve.deployment
    def f():
        return "ok"

    h = serve.run(f.bind(), _local_testing_mode=True)
    assert h.remote().result() == "ok"


def test_local_mode_async_composition_no_deadlock():
    """An async ingress passing a pending child response into another
    child's .remote() must not deadlock the shared loop (dispatch runs on
    the pool, never blocking the loop thread)."""
    @serve.deployment
    class Adder:
        async def add(self, x, y):
            await asyncio.sleep(0.01)
            return x + y

    @serve.deployment
    class Ingress:
        def __init__(self, a):
            self.a = a

        async def __call__(self, x):
            r1 = self.a.add.remote(x, 1)       # pending child response
            r2 = self.a.add.remote(r1, 10)     # nested composition
            return await r2

    h = serve.run(Ingress.bind(Adder.bind()), local_testing_mode=True)
    assert h.remote(5).result(timeout_s=10) == 16


def test_local_mode_async_generator_streaming():
    @serve.deployment
    class AGen:
        async def stream(self, n):
            for i in range(n):
                await asyncio.sleep(0.001)
                yield i * 2

    h = serve.run(AGen.bind(), name="other", local_testing_mode=True)
    got = list(h.options(method_name="stream", stream=True).remote(3))
    assert got == [0, 2, 4]


def test_cluster_run_supersedes_local_app():
    """A cluster deploy of the same app name clears the local-mode
    registry entry, so get_app_handle returns the CLUSTER handle (a
    replica actor of the port's runtime), not the stale in-process
    one (the reference's test_cluster_run_supersedes_local_app)."""
    import ray_tpu_torch as rt

    @serve.deployment
    def v1():
        return "local"

    @serve.deployment
    def v2():
        import os
        return "cluster", os.getpid()

    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=1, object_store_memory=64 * 1024 * 1024)
    try:
        local = serve.run(v1.bind(), local_testing_mode=True)
        assert local.remote().result() == "local"
        h = serve.run(v2.bind())
        try:
            got, pid = h.remote().result(timeout_s=60)
            assert got == "cluster" and pid != os.getpid()
            assert get_local_app("default") is None
            # the app-handle lookup now routes to the cluster app
            assert serve.get_app_handle("default").remote().result(
                timeout_s=60)[0] == "cluster"
        finally:
            serve.delete("default")
        assert "default" not in serve.status()["applications"]
    finally:
        serve.shutdown()
        rt.shutdown()
    assert get_local_app("default") is None


def test_batch_and_multiplexed_inside_a_local_app():
    """@serve.batch gathers concurrent calls into one list call on the
    shared loop; @serve.multiplexed loads a model once and keeps the
    last two used per instance."""
    loads, sizes = [], []

    @serve.deployment
    class Model:
        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            loads.append(model_id)
            return {"id": model_id, "w": len(model_id)}

        # the batch closes when all six calls are in (1 s at most)
        @serve.batch(max_batch_size=6, batch_wait_timeout_s=1.0)
        async def forward(self, xs):
            sizes.append(len(xs))
            return [x * 2 for x in xs]

        async def __call__(self, model_id, x):
            m = await self.get_model(model_id)
            return m["id"], m["w"] * await self.forward(x)

        async def load(self, model_id):
            return (await self.get_model(model_id))["id"]

    h = serve.run(Model.bind(), local_testing_mode=True)
    outs = [h.remote("ab", i) for i in range(6)]
    assert [o.result(timeout_s=10) for o in outs] == \
        [("ab", 4 * i) for i in range(6)]
    assert max(sizes) > 1, f"no batching happened: {sizes}"
    assert loads == ["ab"]
    for mid in ("abc", "ab", "abcd", "abc"):
        assert h.load.remote(mid).result(timeout_s=10) == mid
    # LRU of 2: "ab" stayed hot, "abc" was evicted by "abcd" and reloaded
    assert loads == ["ab", "abc", "abcd", "abc"]
