"""The port's compiled DAGs (``ray_tpu_torch.dag``): actor methods bound
into a graph, compiled onto sealed ring channels in the object store.

The cases of ``tests/test_dag.py`` (a linear pipeline, fan-in, the
ring's auto-drain, teardown freeing the actor, compiled execution
beating plain actor calls, and a pipeline across the head's store and
an own-store node agent's) and of ``tests/test_compiled_dag.py`` (the
ring's overflow under zero-copy reads, an actor that dies in its loop,
teardown leaving no channel object in the store, and equal bits from the
legacy polling transport) run on the port with the reference's
assertions. The cross-node case starts a real agent
(``cluster_utils.node_agent``) and runs here, not only under ``slow``.

Then the port's own cases: bf16 and f32 CPU tensors through a two-stage
DAG, in one store and across stores, bit for bit; teardown leaving no
channel object in either store of a DAG across stores; the stop flag waking a
loop parked on the agent's store; a death on the agent's node reaching
the driver's ``get``; a driver client's compile (it routes no edge
across stores, as the reference's does not); and one program under both
packages' compiled DAGs, whose outputs must be equal.

The remote classes are defined inside the tests, so they pickle by
value: a worker never imports this module (nor, through it, the
reference package)."""
import gc
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as ray
from ray_tpu_torch.cluster_utils import agent_env, node_agent
from ray_tpu_torch.core.config import cfg
from ray_tpu_torch.dag import InputNode
from ray_tpu_torch.util.scheduling_strategies import \
    NodeAffinitySchedulingStrategy


@pytest.fixture
def rt():
    if ray.is_initialized():
        ray.shutdown()
    ray.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    yield ray
    ray.shutdown()
    cfg.reset("dag_sealed_channels", "zero_copy_get")


def _actors(ray, n=2):
    @ray.remote
    class Stage:
        def __init__(self, scale):
            self.scale = scale
            self.calls = 0

        def step(self, x):
            self.calls += 1
            return x * self.scale

        def add(self, a, b):
            return a + b

        def count(self):
            return self.calls

    return [Stage.remote(i + 2) for i in range(n)]


def _pin(node_id):
    return NodeAffinitySchedulingStrategy(node_id=node_id, soft=False)


# -- the cases of tests/test_dag.py ----------------------------------------

def test_linear_pipeline(rt):
    s1, s2 = _actors(rt)
    with InputNode() as inp:
        mid = s1.step.bind(inp)
        out = s2.step.bind(mid)
    cdag = out.experimental_compile(max_inflight=2)
    try:
        assert cdag.execute(5).get() == 5 * 2 * 3
        assert cdag.execute(7).get() == 42
        # pipelined: submit several before reading
        refs = [cdag.execute(i) for i in range(2)]
        assert [r.get() for r in refs] == [0, 6]
    finally:
        cdag.teardown()


def test_fan_in(rt):
    s1, s2 = _actors(rt)
    with InputNode() as inp:
        a = s1.step.bind(inp)          # x*2  on actor1
        b = s2.step.bind(inp)          # x*3  on actor2
        out = s2.add.bind(a, b)        # fan-in on actor2 (local edge b)
    cdag = out.experimental_compile()
    try:
        assert cdag.execute(10).get() == 20 + 30
        assert cdag.execute(1).get() == 5
    finally:
        cdag.teardown()


def test_ring_auto_drains(rt):
    (s1,) = _actors(rt, 1)
    with InputNode() as inp:
        out = s1.step.bind(inp)
    cdag = out.experimental_compile(max_inflight=2)
    try:
        refs = [cdag.execute(i) for i in range(6)]  # > max_inflight
        # earlier refs were auto-drained; all values correct
        assert [r.get() for r in refs] == [i * 2 for i in range(6)]
    finally:
        cdag.teardown()


def test_teardown_frees_actor(rt):
    (s1,) = _actors(rt, 1)
    with InputNode() as inp:
        out = s1.step.bind(inp)
    cdag = out.experimental_compile()
    assert cdag.execute(3).get() == 6
    cdag.teardown()
    # the actor must serve normal calls again after teardown
    assert rt.get(s1.count.remote(), timeout=60) == 1
    assert rt.get(s1.step.remote(4), timeout=60) == 8


def test_compiled_faster_than_remote_calls(rt):
    """The point of compiling: repeated execution skips per-call task
    submission. Not a strict benchmark — just a sanity margin."""
    (s1,) = _actors(rt, 1)
    n = 30
    t0 = time.perf_counter()
    for i in range(n):
        rt.get(s1.step.remote(i), timeout=60)
    remote_dt = time.perf_counter() - t0

    with InputNode() as inp:
        out = s1.step.bind(inp)
    cdag = out.experimental_compile(max_inflight=2)
    try:
        cdag.execute(0).get()  # warm the loop
        t0 = time.perf_counter()
        for i in range(n):
            cdag.execute(i).get()
        dag_dt = time.perf_counter() - t0
    finally:
        cdag.teardown()
    assert dag_dt < remote_dt * 1.5, (dag_dt, remote_dt)


def test_cross_node_pipeline(rt):
    """A compiled DAG spanning the head and an own-store agent node:
    cross-store edges ride the transfer service (producer pushes into the
    consumer's store), same-store edges stay plain shm writes."""
    with node_agent("dagnode", num_cpus=2, own_store=True,
                    store_capacity=128 << 20) as agent:
        @rt.remote
        class Stage:
            def __init__(self, scale):
                self.scale = scale

            def step(self, x):
                return x * self.scale

        s1 = Stage.remote(2)  # head node
        s2 = Stage.options(scheduling_strategy=_pin(agent.node_id)).remote(
            3)  # own-store node

        with InputNode() as inp:
            mid = s1.step.bind(inp)     # head -> push to island
            out = s2.step.bind(mid)     # island -> push back to head
        cdag = out.experimental_compile(max_inflight=2)
        try:
            assert cdag.execute(5).get(timeout_s=120) == 30
            assert cdag.execute(7).get(timeout_s=120) == 42
            refs = [cdag.execute(i) for i in range(3)]
            assert [r.get(timeout_s=120) for r in refs] == [0, 6, 12]
            # both directions cross: the head's edge pushes to the agent,
            # the agent's output pushes back to the head
            assert len(cdag._push_addrs) == 1
        finally:
            cdag.teardown()


# -- the cases of tests/test_compiled_dag.py -------------------------------

def _stages(ray, n=1):
    @ray.remote
    class Stage:
        def __init__(self, scale):
            self.scale = scale

        def step(self, x):
            # np scaling keeps dtype/shape: byte-comparable outputs
            return x * self.scale

    return [Stage.remote(i + 2) for i in range(n)]


def test_ring_overflow_auto_drains_zero_copy(rt):
    """More executes than ring slots, with zero-copy reads allowed
    (cfg.zero_copy_get): the ring auto-drains the oldest execution and
    every value survives bit-exact."""
    cfg.override(zero_copy_get=True)
    (s1,) = _stages(rt, 1)
    with InputNode() as inp:
        out = s1.step.bind(inp)
    cdag = out.experimental_compile(max_inflight=2)
    try:
        arrays = [np.full((64, 64), i, dtype=np.int64) for i in range(8)]
        refs = [cdag.execute(a) for a in arrays]   # 8 > max_inflight
        got = [r.get() for r in refs]
        for a, g in zip(arrays, got):
            assert np.array_equal(g, a * 2)
    finally:
        cdag.teardown()


def test_actor_death_mid_loop_raises(rt):
    """Killing a participating actor makes the NEXT get() raise promptly
    (the liveness probe between wait slices sees the dead loop task)
    instead of hanging until the channel timeout."""
    (s1,) = _stages(rt, 1)
    with InputNode() as inp:
        out = s1.step.bind(inp)
    cdag = out.experimental_compile(max_inflight=2)
    try:
        assert cdag.execute(3).get() == 6
        rt.kill(s1)
        t0 = time.monotonic()
        with pytest.raises(Exception) as ei:
            cdag.execute(4).get(timeout_s=60)
        # well before the 60s channel timeout: the probe caught it
        assert time.monotonic() - t0 < 30
        assert not isinstance(ei.value, TimeoutError)
    finally:
        cdag.teardown(timeout_s=5)


def test_teardown_releases_channel_objects(rt):
    """Stop-flag teardown sweeps the channels: no slot objects, acks or
    stop flags stay behind in the store, and no read pins survive (the
    store drains back to its pre-compile footprint)."""
    from ray_tpu_torch.core.api import _runtime
    store = _runtime().store
    (s1,) = _stages(rt, 1)
    with InputNode() as inp:
        out = s1.step.bind(inp)
    # settle pre-existing traffic (worker boot, actor init) then snapshot
    time.sleep(0.5)
    before = store.bytes_in_use()
    cdag = out.experimental_compile(max_inflight=2)
    payload = np.zeros(1 << 20, dtype=np.uint8)   # 1 MiB per message
    refs = [cdag.execute(payload) for _ in range(4)]
    del refs  # some outputs never get()-consumed: teardown must sweep
    cdag.teardown()
    # loop-ref return objects free via refcounting once the DAG dies
    del cdag
    gc.collect()
    deadline = time.monotonic() + 15
    while store.bytes_in_use() > before + (64 << 10):
        assert time.monotonic() < deadline, (
            f"store kept {store.bytes_in_use() - before} bytes of "
            f"channel state after teardown")
        time.sleep(0.1)


def test_results_bit_identical_with_legacy_transport(rt):
    """cfg.dag_sealed_channels=False restores the polling transport;
    outputs must be byte-identical across transports."""
    rng = np.random.RandomState(0)
    inputs = [rng.standard_normal((32, 32)) for _ in range(6)]

    def run():
        s1, s2 = _stages(rt, 2)
        with InputNode() as inp:
            out = s2.step.bind(s1.step.bind(inp))
        cdag = out.experimental_compile(max_inflight=2)
        assert cdag.sealed == cfg.dag_sealed_channels
        try:
            return [cdag.execute(a).get() for a in inputs]
        finally:
            cdag.teardown()

    cfg.override(dag_sealed_channels=True)
    sealed = run()
    cfg.override(dag_sealed_channels=False)
    legacy = run()
    for a, b in zip(sealed, legacy):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# -- the port's own cases ----------------------------------------------------

def _tensors():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(37, 129, generator=g)
    return {"f32": x, "bf16": (x * 3).to(torch.bfloat16),
            "big_bf16": torch.randn(1024, 700, generator=g).to(
                torch.bfloat16)}


def _tensor_stages(ray, pin_second=None):
    @ray.remote
    class Pass:
        def step(self, t):
            import torch as torch_
            return {k: (str(v.device), str(v.dtype), v.clone())
                    if isinstance(v, torch_.Tensor) else v
                    for k, v in t.items()}

        def unwrap(self, t):
            return {k: v[2] for k, v in t.items()}

    first = Pass.remote()
    second = (Pass.options(scheduling_strategy=_pin(pin_second)).remote()
              if pin_second else Pass.remote())
    with InputNode() as inp:
        out = second.unwrap.bind(first.step.bind(inp))
    return out


def _check_tensors_back(cdag):
    sent = _tensors()
    for ref in [cdag.execute(sent) for _ in range(3)]:
        back = ref.get(timeout_s=120)
        assert sorted(back) == sorted(sent)
        for k, v in sent.items():
            assert back[k].dtype == v.dtype and back[k].device.type == "cpu"
            # bit for bit, bf16 included (compare the raw 16-bit words)
            assert torch.equal(back[k].view(torch.int16) if
                               v.dtype == torch.bfloat16 else back[k],
                               v.view(torch.int16) if
                               v.dtype == torch.bfloat16 else v), k


def test_bf16_and_f32_tensors_through_a_dag(rt):
    """CPU tensors (a bf16 one pickles in-band, an f32 one out of band)
    cross a two-stage DAG in one store and come back bit for bit."""
    cdag = _tensor_stages(rt).experimental_compile(max_inflight=2)
    try:
        assert cdag._push_addrs == []
        _check_tensors_back(cdag)
    finally:
        cdag.teardown()


def test_bf16_and_f32_tensors_across_stores(rt):
    """The same tensors through a DAG whose second stage sits on an
    own-store agent: the head pushes into the agent's store and the
    agent's output is pushed back; every bit survives both ways."""
    with node_agent("tensors", num_cpus=2, own_store=True,
                    store_capacity=128 << 20) as agent:
        cdag = _tensor_stages(rt, agent.node_id).experimental_compile(
            max_inflight=2)
        try:
            assert len(cdag._push_addrs) == 1
            _check_tensors_back(cdag)
        finally:
            cdag.teardown()


def test_teardown_releases_channel_objects_across_stores(rt):
    """A DAG from the head's store into an own-store agent's and back,
    with outputs never got: after teardown both stores hold no more
    objects than before the compile (the slots swept in each store, and
    the stop flag pushed to the agent deleted there too)."""
    from ray_tpu_torch.core.api import _runtime
    store = _runtime().store
    with node_agent("sweep", num_cpus=2, own_store=True,
                    store_capacity=128 << 20) as agent:
        @rt.remote
        class Stage:
            def step(self, x):
                return x

            def objects(self):
                from ray_tpu_torch.core import runtime as rt_mod
                return rt_mod.get_runtime_if_exists().store.num_objects()

        near = Stage.remote()
        far = Stage.options(scheduling_strategy=_pin(agent.node_id)).remote()
        assert rt.get(far.objects.remote(), timeout=60) >= 0
        time.sleep(0.5)
        before = (store.num_objects(),
                  rt.get(far.objects.remote(), timeout=60))
        with InputNode() as inp:
            out = near.step.bind(far.step.bind(near.step.bind(inp)))
        cdag = out.experimental_compile(max_inflight=2)
        payload = np.zeros(1 << 20, dtype=np.uint8)
        refs = [cdag.execute(payload) for _ in range(5)]
        assert np.array_equal(refs[0].get(timeout_s=60), payload)
        del refs                 # the last outputs are never got
        cdag.teardown()
        assert all(isinstance(n, int)
                   for n in rt.get(cdag._loop_refs, timeout=30))
        del cdag
        gc.collect()
        deadline = time.monotonic() + 15
        while True:
            after = (store.num_objects(),
                     rt.get(far.objects.remote(), timeout=60))
            if after[0] <= before[0] and after[1] <= before[1]:
                break
            assert time.monotonic() < deadline, (before, after)
            time.sleep(0.1)


def test_stop_flag_wakes_a_loop_on_the_agent_store(rt):
    """Teardown seals the stop flag in every store of the DAG: a loop
    parked in a futex wait on the agent's own store wakes at once and
    returns (ChannelClosed), well inside one liveness slice of waiting
    for the loop refs, and the agent's actor answers calls again."""
    with node_agent("stopper", num_cpus=2, own_store=True,
                    store_capacity=128 << 20) as agent:
        (s_head,) = _actors(rt, 1)

        @rt.remote
        class Far:
            def step(self, x):
                return x + 1

        far = Far.options(scheduling_strategy=_pin(agent.node_id)).remote()
        with InputNode() as inp:
            out = far.step.bind(s_head.step.bind(inp))
        cdag = out.experimental_compile(max_inflight=2)
        assert cdag.execute(4).get(timeout_s=60) == 9
        time.sleep(0.3)                 # both loops park again
        t0 = time.monotonic()
        cdag.teardown(timeout_s=30)
        assert time.monotonic() - t0 < 5.0
        # each loop returned its message count instead of raising
        assert rt.get(cdag._loop_refs, timeout=10) == [1, 1]
        assert rt.get(far.step.remote(1), timeout=60) == 2


def test_actor_death_on_the_agent_node_raises(rt):
    """An actor on an agent's node killed mid-pipeline: its death reaches
    the head through the agent, and the driver's get raises instead of
    hanging."""
    with node_agent("dying", num_cpus=2, own_store=True,
                    store_capacity=128 << 20) as agent:
        @rt.remote
        class Far:
            def step(self, x):
                return x * 5

        far = Far.options(scheduling_strategy=_pin(agent.node_id)).remote()
        with InputNode() as inp:
            out = far.step.bind(inp)
        cdag = out.experimental_compile(max_inflight=2)
        try:
            assert cdag.execute(3).get(timeout_s=60) == 15
            rt.kill(far)
            # the kill reaches an agent's worker through its agent, so the
            # loop may still answer right after it: execute until the
            # death shows, which must be a raise, well inside the timeout
            t0 = time.monotonic()
            err = None
            for i in range(100):
                try:
                    assert cdag.execute(i).get(timeout_s=60) == 5 * i
                except Exception as e:  # noqa: BLE001 — checked below
                    err = e
                    break
                time.sleep(0.1)
            assert err is not None and not isinstance(err, TimeoutError)
            assert time.monotonic() - t0 < 30
        finally:
            cdag.teardown(timeout_s=5)


_CLIENT_COMPILE = textwrap.dedent("""
    import json, sys
    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode
    rt.init(address=sys.argv[1])
    near, far = rt.get_actor("near"), rt.get_actor("far")
    with InputNode() as inp:
        out = near.step.bind(inp)
    cdag = out.experimental_compile(max_inflight=2)
    near_vals = [cdag.execute(i).get(timeout_s=60) for i in range(3)]
    cdag.teardown()
    with InputNode() as inp:
        out = far.step.bind(inp)
    cdag = out.experimental_compile(max_inflight=2)
    routes = (cdag._push_addrs, [a for _b, a in cdag.input_chans])
    try:
        cdag.execute(1).get(timeout_s=2)
        far_result = "value"
    except Exception as e:
        far_result = type(e).__name__
    cdag.teardown(timeout_s=2)
    banned = sorted(n for n in sys.modules
                    if n.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))
    rt.shutdown()
    print(json.dumps({"near": near_vals, "routes": routes,
                      "far": far_result, "banned": banned}))
""")


def test_driver_client_compile_routes_no_edge_across_stores(rt, tmp_path):
    """A driver client compiles as the reference's does: it reads no head
    table, so every edge is a plain seal in the store it shares with the
    head. A DAG over a head-node actor runs; one over an own-store
    agent's actor gets no push route, and its get times out."""
    import json
    from ray_tpu_torch.core import runtime as rt_mod
    with node_agent("client-far", num_cpus=2, own_store=True,
                    store_capacity=128 << 20) as agent:
        @rt.remote
        class Stage:
            def step(self, x):
                return x * 7

        near = Stage.options(name="near").remote()
        far = Stage.options(name="far",
                            scheduling_strategy=_pin(agent.node_id)).remote()
        assert rt.get([near.step.remote(1), far.step.remote(1)],
                      timeout=60) == [7, 7]
        script = tmp_path / "client_compile.py"
        script.write_text(_CLIENT_COMPILE)
        env = agent_env()
        out = subprocess.run(
            [sys.executable, str(script),
             rt_mod.get_runtime_if_exists().cluster_file],
            env=env, capture_output=True, text=True, timeout=180)
        assert out.returncode == 0, out.stderr[-4000:]
        got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["near"] == [0, 7, 14]
    assert got["routes"] == [[], [None]]
    assert got["far"] == "GetTimeoutError"
    assert got["banned"] == []


# -- one program under both packages ----------------------------------------

def _dag_program(pkg) -> dict:
    """Values and dtypes through a linear pipeline, fan-in and the ring's
    auto-drain, and the error class names a user meets, under one
    package's compiled DAGs."""
    dag = __import__(f"{pkg.__name__}.dag", fromlist=["InputNode"])
    out = {}
    pkg.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    try:
        @pkg.remote
        class Stage:
            def __init__(self, scale):
                self.scale = scale

            def step(self, x):
                return x * self.scale

            def add(self, a, b):
                return a + b

            def fail(self, x):
                raise KeyError(f"bad {x}")

        s1, s2 = Stage.remote(2), Stage.remote(3)
        rng = np.random.RandomState(0)
        values = [rng.randn(3, 5).astype(np.float32),
                  rng.randn(700, 400),
                  rng.randint(-100, 100, (17,)).astype(np.int8), 11, 2.5]
        with dag.InputNode() as inp:
            a = s1.step.bind(inp)
            b = s2.step.bind(inp)
            fan = s2.add.bind(a, b)
        cdag = fan.experimental_compile(max_inflight=2)
        try:
            refs = [cdag.execute(v) for v in values]    # auto-drains
            got = [r.get(timeout_s=60) for r in refs]
        finally:
            cdag.teardown()
        out["fan_in"] = [(str(g.dtype), g.shape, g.tobytes())
                         if isinstance(g, np.ndarray) else g for g in got]
        out["channels"] = cdag._n_chans
        errors = []
        try:
            cdag.execute(1)
        except Exception as e:  # noqa: BLE001 — the class is the result
            errors.append(type(e).__name__)
        try:
            with dag.InputNode() as inp:
                inp.experimental_compile()      # no actor-method node
        except Exception as e:          # noqa: BLE001
            errors.append([type(e).__name__, str(e)])
        with dag.InputNode() as inp:
            bad = s2.fail.bind(s1.step.bind(inp))
        cdag = bad.experimental_compile()
        try:
            cdag.execute(4).get(timeout_s=60)
        except Exception as e:          # noqa: BLE001
            errors.append([type(e).__name__, isinstance(e, KeyError)])
        finally:
            cdag.teardown(timeout_s=10)
        out["errors"] = errors
        with dag.InputNode() as inp:
            last = s2.step.bind(s1.step.bind(inp))
        cdag = last.experimental_compile()
        try:
            out["after_error"] = cdag.execute(5).get(timeout_s=60)
        finally:
            cdag.teardown()
        out["calls_after"] = pkg.get(s1.step.remote(1), timeout=60)
    finally:
        pkg.shutdown()
    return out


def test_dag_program_matches_the_reference():
    import ray_tpu
    if ray.is_initialized():
        ray.shutdown()
    ref = _dag_program(ray_tpu)
    port = _dag_program(ray)
    assert port == ref
    assert ref["fan_in"][3:] == [55, 12.5]
    assert ref["channels"] == 4
    assert ref["errors"][0] == "RuntimeError"
    assert ref["errors"][2] == ["KeyError", True]
