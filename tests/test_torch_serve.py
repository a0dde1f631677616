"""Serve over the port's runtime: the controller, replica actors,
handles and the HTTP proxy (``ray_tpu_torch.serve``).

The cases of ``tests/test_serve.py`` (deploy, methods, composition,
power-of-two routing over two replicas, autoscaling under queued load,
the HTTP proxy, delete) and the eight runtime cases of
``tests/test_serve_features.py`` (a ``@serve.batch`` deployment, sync
and async streaming, multiplexed routing with its LRU, user_config and
``update_user_config``, route prefixes) keep the reference's scenarios
and assertions. Then what the port adds: both streaming transports (the
sealed ring channel when the replica shares the head's store, the
``stream_next`` polls when it sits on an own-store node), a stream
cancelled in the middle whose ring slots are swept, and the device
request of a replica (``num_gpus`` leases a fake GPU, ``num_tpus`` is
refused at ``serve.run``, an ``LLMServer`` replica that asks for the
card without a lease fails loudly), and ``serve.shutdown()`` returning
within seconds while a replica is mid-request.

One runtime serves the module (``num_cpus=2`` and one fake GPU, whose
index is counted, never probed); every test shuts Serve down after
itself. HTTP ports are never fixed: each test takes a free block and
retries on another when a bind fails. The deployments are defined
inside the tests, so replicas unpickle them by value and never import
this module.
"""
import asyncio
import json
import socket
import time
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve


@pytest.fixture(scope="module")
def runtime():
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=2, num_gpus=1, object_store_memory=256 * 1024 * 1024)
    yield rt
    serve.shutdown()
    rt.shutdown()


@pytest.fixture
def ray(runtime):
    yield runtime
    serve.shutdown()


def _free_block(n: int) -> int:
    """The first of n consecutive ports that are free right now."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n > 65535:
            continue
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no block of {n} free ports")


def _run_http(app, name, n_proxies=1, **kw):
    """serve.run on a free block of n_proxies ports; a bind lost to a
    race retries on another block. Returns (handle, first port)."""
    last = None
    for _ in range(5):
        port = _free_block(n_proxies)
        try:
            return serve.run(app, name=name, http_port=port,
                             num_proxies=n_proxies, **kw), port
        except Exception as e:  # noqa: BLE001 — retried on bind races
            if "address already in use" not in str(e).lower():
                raise
            last = e
            serve.shutdown()
    raise last


# ------------------------------------------------------------------ #
# tests/test_serve.py
# ------------------------------------------------------------------ #

def test_function_deployment_roundtrip(ray):
    @serve.deployment
    def double(x):
        return {"y": x["x"] * 2}

    handle = serve.run(double.bind(), name="fn")
    assert handle.remote({"x": 21}).result() == {"y": 42}


def test_class_deployment_and_methods(ray):
    @serve.deployment(num_replicas=2)
    class Counter:
        def __init__(self, start):
            self.start = start

        def __call__(self, x):
            return self.start + x

        def info(self):
            return "counter"

    handle = serve.run(Counter.bind(10), name="cls")
    assert handle.remote(5).result() == 15
    assert handle.info.remote().result() == "counter"
    st = serve.status()
    dep = st["applications"]["cls"]["deployments"]["Counter"]
    assert dep["running_replicas"] == 2


def test_model_composition_handles(ray):
    @serve.deployment
    class Preprocess:
        def __call__(self, x):
            return x + 1

    @serve.deployment
    class Model:
        def __init__(self, pre):
            self.pre = pre

        def __call__(self, x):
            y = self.pre.remote(x).result()
            return y * 10

    handle = serve.run(Model.bind(Preprocess.bind()), name="comp")
    assert handle.remote(4).result() == 50


def test_replica_requests_spread(ray):
    @serve.deployment(num_replicas=2)
    class Who:
        def __call__(self, _):
            import os
            return os.getpid()

    handle = serve.run(Who.bind(), name="spread")
    pids = {handle.remote(None).result() for _ in range(16)}
    assert len(pids) == 2  # both replicas saw traffic


def test_autoscaling_up(ray):
    @serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3,
        "target_ongoing_requests": 1, "upscale_delay_s": 0.1})
    class Slow:
        def __call__(self, _):
            time.sleep(1.0)
            return "ok"

    handle = serve.run(Slow.bind(), name="auto")
    responses = [handle.remote(None) for _ in range(6)]
    deadline = time.monotonic() + 20
    scaled = False
    while time.monotonic() < deadline:
        dep = serve.status()["applications"]["auto"]["deployments"]["Slow"]
        if dep["running_replicas"] >= 2:
            scaled = True
            break
        time.sleep(0.2)
    for r in responses:
        assert r.result(timeout_s=30) == "ok"
    assert scaled, "autoscaler never scaled up under queued load"


def test_http_proxy(ray):
    @serve.deployment
    def echo(payload):
        return {"got": payload["v"]}

    _h, port = _run_http(echo.bind(), "default")
    time.sleep(0.5)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/", data=json.dumps({"v": 7}).encode(),
        headers={"Content-Type": "application/json"})
    deadline = time.monotonic() + 15
    while True:
        try:
            with urllib.request.urlopen(req, timeout=5) as resp:
                body = json.loads(resp.read())
            break
        except Exception:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.3)
    assert body == {"got": 7}


def test_delete_application(ray):
    @serve.deployment
    def f(_):
        return 1

    serve.run(f.bind(), name="gone")
    assert "gone" in serve.status()["applications"]
    serve.delete("gone")
    assert "gone" not in serve.status()["applications"]


# ------------------------------------------------------------------ #
# tests/test_serve_features.py, the runtime cases
# ------------------------------------------------------------------ #

def test_batched_deployment(ray):
    @serve.deployment(max_ongoing_requests=16)
    class Doubler:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.1)
        async def __call__(self, xs):
            self.batch_sizes.append(len(xs))
            return [x * 2 for x in xs]

        async def seen_batches(self):
            return self.batch_sizes

    h = serve.run(Doubler.bind(), name="batch-app")
    responses = [h.remote(i) for i in range(8)]
    assert sorted(r.result(timeout_s=60) for r in responses) == \
        [0, 2, 4, 6, 8, 10, 12, 14]
    sizes = h.options(method_name="seen_batches").remote().result(
        timeout_s=30)
    assert max(sizes) > 1, f"requests never batched: {sizes}"


def test_streaming_response(ray):
    @serve.deployment
    def counter(n=5):
        for i in range(int(n or 5)):
            yield {"i": i}

    h = serve.run(counter.bind(), name="stream-app")
    gen = h.options(stream=True).remote(4)
    items = list(gen)
    assert items == [{"i": 0}, {"i": 1}, {"i": 2}, {"i": 3}]


def test_streaming_async_generator(ray):
    @serve.deployment
    class Streamer:
        async def __call__(self, n):
            for i in range(n):
                await asyncio.sleep(0.01)
                yield f"tok{i}"

    h = serve.run(Streamer.bind(), name="astream-app")
    got = list(h.options(stream=True).remote(3))
    assert got == ["tok0", "tok1", "tok2"]


def test_multiplexed_routing_and_lru(ray):
    @serve.deployment(num_replicas=2)
    class MultiModel:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id):
            self.loads.append(model_id)
            return {"id": model_id, "weight": len(model_id)}

        async def __call__(self, x):
            model = await self.get_model()
            return (serve.get_multiplexed_model_id(), model["weight"], x)

        async def load_count(self):
            return len(self.loads)

    h = serve.run(MultiModel.bind(), name="mux-app")
    # same model id repeatedly: must load once (same replica, cached)
    outs = [h.options(multiplexed_model_id="modelA").remote(i)
            .result(timeout_s=60) for i in range(4)]
    assert all(o[0] == "modelA" and o[1] == 6 for o in outs)
    time.sleep(0.3)
    # each probe lands on SOME replica and reads its private counter:
    # modelA was cached after one load on one replica, so every replica
    # reports 0 or 1 loads — never more (cache hit)
    counts = [h.options(method_name="load_count",
                        multiplexed_model_id=f"probe{i}").remote()
              .result(timeout_s=30) for i in range(8)]
    assert max(counts) == 1, counts
    assert min(counts) in (0, 1)


def test_user_config_and_reconfigure(ray):
    """user_config applies at replica boot and updates live via
    reconfigure() without restarts (reference: lightweight updates)."""
    @serve.deployment(num_replicas=2, user_config={"threshold": 5})
    class Thresholder:
        def __init__(self):
            import os
            self.threshold = None
            self.pid = os.getpid()

        def reconfigure(self, config):
            self.threshold = config["threshold"]

        def __call__(self, x):
            return {"over": x > self.threshold, "pid": self.pid}

    h = serve.run(Thresholder.bind(), name="ucfg")
    assert h.remote(7).result(timeout_s=60)["over"] is True
    assert h.remote(3).result(timeout_s=60)["over"] is False
    pid0 = h.remote(0).result(timeout_s=60)["pid"]

    serve.update_user_config("ucfg", "Thresholder", {"threshold": 100})
    # under heavy suite load a replica's reconfigure can lag; poll until
    # the new threshold is observed consistently
    deadline = time.time() + 60
    outs = []
    while time.time() < deadline:
        outs = [h.remote(7).result(timeout_s=60) for _ in range(6)]
        if all(o["over"] is False for o in outs):
            break
        time.sleep(0.5)
    assert all(o["over"] is False for o in outs)   # new threshold live
    assert any(o["pid"] == pid0 for o in outs)     # same replicas (no restart)


def test_update_user_config_surfaces_errors(ray):
    """A reconfigure() that raises fails the update and does NOT persist
    the bad config for future replicas."""
    @serve.deployment(user_config={"k": 1})
    class Cfg:
        def __init__(self):
            self.k = None

        def reconfigure(self, config):
            self.k = config["k"]   # KeyError on bad config

        def __call__(self, _=None):
            return self.k

    h = serve.run(Cfg.bind(), name="ucfg-err")
    assert h.remote().result(timeout_s=60) == 1
    with pytest.raises(Exception):
        serve.update_user_config("ucfg-err", "Cfg", {"wrong": 9})
    # old config still live and still what future replicas would get
    assert h.remote().result(timeout_s=60) == 1


def test_route_prefix_http(ray):
    """Explicit route_prefix maps URL paths to apps (longest match);
    default '/' keeps app-name addressing."""
    @serve.deployment
    def api_v2(payload=None):
        return {"v": 2, "got": payload}

    @serve.deployment
    def plain(payload=None):
        return {"v": 1}

    _h, port = _run_http(api_v2.bind(), "v2app", route_prefix="/api/v2")
    serve.run(plain.bind(), name="plainapp")

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v2",
        data=json.dumps({"q": 1}).encode(),
        headers={"Content-Type": "application/json"})
    out = json.loads(urllib.request.urlopen(req, timeout=60).read())
    assert out == {"v": 2, "got": {"q": 1}}
    # app-name addressing still works for the default-prefix app
    out = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/plainapp", timeout=60).read())
    assert out == {"v": 1}


def test_route_prefix_validation(ray):
    @serve.deployment
    def f1(p=None):
        return 1

    @serve.deployment
    def f2(p=None):
        return 2

    serve.run(f1.bind(), name="rp-a", route_prefix="/shared")
    with pytest.raises(Exception, match="already used"):
        serve.run(f2.bind(), name="rp-b", route_prefix="/shared")
    with pytest.raises(Exception, match="start with"):
        serve.run(f2.bind(), name="rp-c", route_prefix="oops")


# ------------------------------------------------------------------ #
# the two streaming transports, and a cancelled stream
# ------------------------------------------------------------------ #

def _stream_counts() -> dict:
    """{transport: (dispatches, items)} in the head's merged store (this
    process's counters flush there first)."""
    from ray_tpu_torch.util import metrics as um
    out = {}
    store = um.collect_store()
    for name, i in (("rtpu_serve_stream_dispatches_total", 0),
                    ("rtpu_serve_stream_items_total", 1)):
        for key, v in (store.get(name) or {}).get("series", {}).items():
            t = dict(key).get("transport")
            cur = list(out.get(t, (0.0, 0.0)))
            cur[i] += v
            out[t] = tuple(cur)
    return out


def test_stream_rides_the_ring_channel_in_the_heads_store(ray):
    """A replica in the head's store serves a stream through the sealed
    ring channel: one setup dispatch, every item read from shared
    memory, no stream_next polls."""
    from ray_tpu_torch.serve.handle import ChannelResponseGenerator

    @serve.deployment
    def tokens(n):
        for i in range(n):
            yield {"tok": i}

    h = serve.run(tokens.bind(), name="chan-app")
    before = _stream_counts()
    gen = h.options(stream=True).remote(12)
    assert isinstance(gen, ChannelResponseGenerator)
    assert list(gen) == [{"tok": i} for i in range(12)]
    after = _stream_counts()
    chan0 = before.get("chan", (0.0, 0.0))
    assert after["chan"][1] - chan0[1] == 12
    assert after["chan"][0] - chan0[0] == 1     # the setup call only
    assert after.get("poll") == before.get("poll")


def test_stream_polls_from_an_own_store_node(ray):
    """A replica on a node with its own store cannot share a ring with
    the caller: the replica declines the channel and the handle falls
    back to stream_next polls, with the same items."""
    from ray_tpu_torch.cluster_utils import node_agent
    from ray_tpu_torch.serve.handle import DeploymentResponseGenerator

    @serve.deployment(ray_actor_options={"num_gpus": 2})
    class Remote:
        def where(self):
            import os
            return os.environ.get("RTPU_OWN_STORE"), \
                os.environ.get("CUDA_VISIBLE_DEVICES")

        def __call__(self, n):
            for i in range(n):
                yield {"tok": i}

    # the head has one GPU, the agent two: a two-GPU replica can only
    # land on the agent's node
    with node_agent("serve-own-store", num_cpus=2, num_gpus=2,
                    own_store=True):
        h = serve.run(Remote.bind(), name="poll-app")
        assert h.where.remote().result(timeout_s=60) == ("1", "0,1")
        before = _stream_counts().get("poll", (0.0, 0.0))
        gen = h.options(stream=True).remote(7)
        assert isinstance(gen, DeploymentResponseGenerator)
        assert list(gen) == [{"tok": i} for i in range(7)]
        after = _stream_counts()["poll"]
        assert after[1] - before[1] == 7
        assert after[0] - before[0] >= 1
        serve.delete("poll-app")


def test_cancelled_stream_sweeps_its_ring(ray):
    """Cancelling a channel stream in the middle seals its stop flag;
    the replica's drain thread stops pulling and sweeps every slot it
    left behind, so no object under the stream's channel ids (its data
    slots, its acks, its stop flag) is left in the head's store.

    The test counts those ids alone, not the whole store: the Serve
    controller's reconcile loop keeps one result of its replica calls
    (stats, health_check) in the store nearly all the time and none for
    moments, so a count of the whole store taken as a baseline can be
    one short of every count after it."""
    from ray_tpu_torch.core import runtime as rt_mod
    from ray_tpu_torch.dag.channel import slot_oid

    @serve.deployment
    class Endless:
        def __call__(self, _=None):
            i = 0
            while True:
                yield {"tok": i}
                i += 1

        def ping(self):
            return "ok"

    h = serve.run(Endless.bind(), name="cancel-app")
    assert h.ping.remote().result(timeout_s=60) == "ok"
    store = rt_mod.get_runtime_if_exists().store
    gen = h.options(stream=True).remote(None)
    got = [next(gen) for _ in range(5)]
    assert got == [{"tok": i} for i in range(5)]
    # the producer runs at most a ring ahead of the reader's acks
    rd = gen._reader
    ids = [rd.stop] + [slot_oid(b, s) for b in (rd.base, rd.ack_base)
                       for s in range(rd.seq + rd.ring + 1)]
    assert any(store.contains(o) for o in ids)   # acks, unread slots
    gen.cancel()
    with pytest.raises(StopIteration):
        next(gen)
    del gen
    deadline = time.monotonic() + 30
    left = [o for o in ids if store.contains(o)]
    while left and time.monotonic() < deadline:
        time.sleep(0.1)
        left = [o for o in ids if store.contains(o)]
    assert left == []
    # the replica is free again: its stream was dropped
    assert h.ping.remote().result(timeout_s=60) == "ok"


# ------------------------------------------------------------------ #
# a replica's device request
# ------------------------------------------------------------------ #

def test_num_gpus_replica_leases_a_gpu(ray):
    """ray_actor_options={"num_gpus": 1} leases the head's one (fake)
    GPU: the replica sees its index, and the lease returns on delete."""
    @serve.deployment(ray_actor_options={"num_gpus": 1})
    def visible(_=None):
        import os
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    h = serve.run(visible.bind(), name="gpu-app")
    assert h.remote().result(timeout_s=60) == "0"
    assert rt.available_resources().get("GPU", 0) == 0
    serve.delete("gpu-app")
    deadline = time.monotonic() + 20
    while rt.available_resources().get("GPU", 0) != 1 and \
            time.monotonic() < deadline:
        time.sleep(0.2)
    assert rt.available_resources().get("GPU", 0) == 1


def test_llm_deployment_gpus_per_replica_leases_the_gpu(ray):
    """build_llm_deployment(gpus_per_replica=1) asks for num_gpus: its
    LLMServer replica (on the CPU here) holds the leased index."""
    from ray_tpu_torch.llm import (LLMConfig, PagedEngineConfig,
                                   build_llm_deployment)
    from ray_tpu_torch.models import llama

    cfg = LLMConfig(model_id="leased", gpus_per_replica=1, warmup=False,
                    engine=PagedEngineConfig(
                        model=llama.llama_tiny(vocab_size=258,
                                               max_seq_len=128),
                        max_batch_size=2, page_size=8, num_pages=32,
                        max_pages_per_seq=16, chunk_size=16))
    app = build_llm_deployment(cfg, device="cpu")
    assert app.ingress.spec.ray_actor_options == {"num_gpus": 1}
    serve.run(app, name="leased")
    from ray_tpu_torch.serve.api import CONTROLLER_NAME
    ctrl = rt.get_actor(CONTROLLER_NAME)
    _v, (replica,) = rt.get(ctrl.get_replicas.remote("leased",
                                                     "llm:leased"))

    def probe(inst):
        import os
        return os.environ.get("CUDA_VISIBLE_DEVICES"), \
            str(inst._callable.device)

    assert rt.get(replica._exec(probe), timeout=60) == ("0", "cpu")
    out = rt.get(replica.handle_request.remote(
        "completions", ({"prompt": "hello", "max_tokens": 3},), {}, None),
        timeout=120)
    assert out["usage"]["completion_tokens"] >= 1


def test_num_tpus_is_refused_at_run(ray):
    """A spec that still asks for the reference's num_tpus would start
    a replica with no device lease: serve.run refuses it, naming
    num_gpus, and deploys nothing."""
    @serve.deployment(ray_actor_options={"num_tpus": 1})
    def f(_=None):
        return 1

    with pytest.raises(ValueError, match="num_gpus"):
        serve.run(f.bind(), name="tpu-app")
    assert "tpu-app" not in serve.status()["applications"]


@pytest.mark.parametrize("n", [0.5, -1, 1.5])
def test_gpus_per_replica_must_be_whole_devices(n):
    from ray_tpu_torch.llm import LLMConfig
    with pytest.raises(ValueError, match="gpus_per_replica"):
        LLMConfig(gpus_per_replica=n)


def test_cuda_replica_without_a_lease_fails_loudly(ray):
    """gpus_per_replica=0 with device="cuda": the replica sees no device
    (CUDA_VISIBLE_DEVICES is empty, and this machine has none) and its
    LLMServer raises instead of falling back to the CPU; a request
    surfaces that error."""
    from ray_tpu_torch.llm import (LLMConfig, PagedEngineConfig,
                                   build_llm_deployment)
    from ray_tpu_torch.models import llama

    cfg = LLMConfig(model_id="nolease", warmup=False, engine=PagedEngineConfig(
        model=llama.llama_tiny(vocab_size=258, max_seq_len=128),
        max_batch_size=2, page_size=8, num_pages=32, max_pages_per_seq=16,
        chunk_size=16))
    h = serve.run(build_llm_deployment(cfg, device="cuda"), name="nolease")
    with pytest.raises(Exception, match="CUDA is not available"):
        h.remote({"prompt": "hello", "max_tokens": 2}).result(timeout_s=120)
    serve.delete("nolease")


def test_shutdown_returns_with_a_request_in_flight(runtime):
    """serve.shutdown() with a live replica mid-request returns within
    seconds: the replica is killed, not drained, and the request's
    caller sees the replica's death."""
    @serve.deployment
    class Stuck:
        def __call__(self, _=None):
            time.sleep(60)
            return "late"

        def ping(self):
            return "ok"

    h = serve.run(Stuck.bind(), name="stuck")
    assert h.ping.remote().result(timeout_s=60) == "ok"
    resp = h.remote()
    time.sleep(0.5)                      # the request is inside the replica
    t0 = time.monotonic()
    serve.shutdown()
    assert time.monotonic() - t0 < 10.0
    assert serve.status() == {"applications": {}}
    with pytest.raises(Exception):
        resp.result(timeout_s=30)
