"""The port's core task/actor/object API (``ray_tpu_torch.init``,
``remote``, ``get``, ``put``, ``wait``, ``kill``, ``cancel``, ...).

Each scenario of ``tests/test_core_api.py`` runs on the port's runtime
with the reference's assertions: task chaining, put/get of numpy arrays,
errors with the remote traceback, ``num_returns``, ``wait``, get
timeouts, actors and their method order and errors, nested tasks,
handle passing, ``kill``, named actors, ``cancel``, zero-CPU tasks, the
runtime context, resources and local mode. Then one program runs under
both packages, one after the other, and its outputs are compared: values
and dtypes through ``put``/``get``, the error class names, and the
resource table keys with "GPU" in the place of "TPU".

The remote functions and classes are defined inside the tests, so they
pickle by value: a worker never imports this module (nor, through it,
the reference package)."""
import time

import numpy as np
import pytest

import ray_tpu_torch as ray


@pytest.fixture
def rt():
    if ray.is_initialized():
        ray.shutdown()
    ray.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    yield ray
    ray.shutdown()


def test_simple_task(rt):
    @rt.remote
    def add(a, b):
        return a + b

    assert rt.get(add.remote(1, 2), timeout=60) == 3


def test_task_chaining_and_deps(rt):
    @rt.remote
    def inc(x):
        return x + 1

    ref = inc.remote(0)
    for _ in range(5):
        ref = inc.remote(ref)
    assert rt.get(ref, timeout=60) == 6


def test_put_get(rt):
    arr = np.random.rand(64, 64)
    ref = rt.put(arr)
    assert np.allclose(rt.get(ref, timeout=60), arr)


def test_large_array_args_via_store(rt):
    @rt.remote
    def mean(x):
        return float(x.mean())

    arr = np.ones((512, 512))  # 2 MiB > inline limit
    assert rt.get(mean.remote(arr), timeout=60) == 1.0


def test_error_propagation(rt):
    @rt.remote(max_retries=0)
    def boom():
        raise ValueError("kaboom")

    with pytest.raises(ValueError):
        rt.get(boom.remote(), timeout=60)


def test_error_carries_remote_traceback(rt):
    import traceback

    @rt.remote(max_retries=0)
    def boom():
        raise ValueError("kaboom with context")

    try:
        rt.get(boom.remote(), timeout=60)
    except ValueError as err:
        tb = "".join(traceback.format_exception(
            type(err), err, err.__traceback__))
    else:
        pytest.fail("remote ValueError was swallowed, not raised")
    assert "in boom" in tb, tb          # the remote frame
    assert "kaboom with context" in tb
    assert "direct cause" in tb, tb     # chained, not suppressed


def test_error_propagates_through_deps(rt):
    @rt.remote(max_retries=0)
    def boom():
        raise RuntimeError("first")

    @rt.remote
    def consume(x):
        return x

    with pytest.raises(Exception):
        rt.get(consume.remote(boom.remote()), timeout=60)


def test_num_returns(rt):
    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    assert rt.get([a, b, c], timeout=60) == [1, 2, 3]


def test_wait(rt):
    @rt.remote
    def slow(t):
        time.sleep(t)
        return t

    refs = [slow.remote(0.05), slow.remote(5.0)]
    # gate on the measured completion of the fast task, as the
    # reference's test does, not on a wall-clock margin
    assert rt.get(refs[0], timeout=60) == 0.05
    t0 = time.monotonic()
    ready, pending = rt.wait(refs, num_returns=1, timeout=3.0)
    assert len(ready) == 1 and len(pending) == 1
    assert ready[0] == refs[0] and pending[0] == refs[1]
    assert time.monotonic() - t0 < 3.0
    assert rt.get(ready[0], timeout=60) == 0.05


def test_get_timeout(rt):
    @rt.remote
    def forever():
        time.sleep(60)

    with pytest.raises(rt.exceptions.GetTimeoutError):
        rt.get(forever.remote(), timeout=0.2)


def test_actor_basics(rt):
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.v = start

        def inc(self, n=1):
            self.v += n
            return self.v

    c = Counter.remote(5)
    assert rt.get([c.inc.remote() for _ in range(3)], timeout=60) == \
        [6, 7, 8]


def test_actor_method_ordering(rt):
    @rt.remote
    class Log:
        def __init__(self):
            self.items = []

        def append(self, x):
            self.items.append(x)

        def get(self):
            return self.items

    log = Log.remote()
    for i in range(20):
        log.append.remote(i)
    assert rt.get(log.get.remote(), timeout=60) == list(range(20))


def test_actor_error(rt):
    @rt.remote
    class Bad:
        def fail(self):
            raise IndexError("nope")

        def ok(self):
            return 1

    b = Bad.remote()
    with pytest.raises(IndexError):
        rt.get(b.fail.remote(), timeout=60)
    # the actor survives method errors
    assert rt.get(b.ok.remote(), timeout=60) == 1


def test_actor_init_failure(rt):
    @rt.remote
    class Broken:
        def __init__(self):
            raise RuntimeError("bad init")

        def m(self):
            return 1

    b = Broken.remote()
    with pytest.raises(rt.exceptions.RayError):
        rt.get(b.m.remote(), timeout=30)


def test_nested_tasks(rt):
    @rt.remote
    def inner(x):
        return x * 2

    @rt.remote(num_cpus=0)
    def outer(x):
        return ray.get(inner.remote(x)) + 1

    assert rt.get(outer.remote(10), timeout=60) == 21


def test_actor_handle_passing(rt):
    @rt.remote
    class Store:
        def __init__(self):
            self.v = {}

        def set(self, k, v):
            self.v[k] = v

        def get(self, k):
            return self.v.get(k)

    @rt.remote(num_cpus=0)
    def writer(store):
        ray.get(store.set.remote("k", 42))
        return True

    s = Store.remote()
    assert rt.get(writer.remote(s), timeout=60)
    assert rt.get(s.get.remote("k"), timeout=60) == 42


def test_actor_made_in_a_worker_is_known_before_its_handle_leaves(rt):
    """An actor created inside a task is registered at the head before
    ``.remote()`` returns there: its handle can leave through the store
    (a get wakes on the result's seal, not on the head's bookkeeping),
    and a call from the driver must find it even when the head reads
    the creation frame late (here: registration waits one second with
    the runtime's lock released, as a busy receive thread would)."""
    from ray_tpu_torch.core import runtime as rt_mod
    head = rt_mod.get_runtime_if_exists()
    orig = head._create_actor_locked

    def late(spec):
        head.lock.release()
        try:
            time.sleep(1.0)
        finally:
            head.lock.acquire()
        return orig(spec)

    @rt.remote
    class Echo:
        def ping(self):
            return "pong"

    @rt.remote(num_cpus=0)
    def make():
        return [Echo.remote()]

    head._create_actor_locked = late
    try:
        (h,) = rt.get(make.remote(), timeout=60)
        assert rt.get(h.ping.remote(), timeout=60) == "pong"
    finally:
        head._create_actor_locked = orig


def test_kill_actor(rt):
    @rt.remote
    class A:
        def m(self):
            return 1

    a = A.remote()
    assert rt.get(a.m.remote(), timeout=60) == 1
    rt.kill(a)
    with pytest.raises(rt.exceptions.RayError):
        rt.get(a.m.remote(), timeout=30)


def test_named_actor(rt):
    @rt.remote
    class Named:
        def who(self):
            return "me"

    Named.options(name="the-one").remote()
    h = rt.get_actor("the-one")
    assert rt.get(h.who.remote(), timeout=60) == "me"


def test_cancel_pending_task(rt):
    @rt.remote
    def block(t):
        time.sleep(t)
        return t

    # saturate both CPUs, then queue one more and cancel it
    running = [block.remote(3) for _ in range(2)]
    victim = block.remote(0)
    time.sleep(0.3)
    rt.cancel(victim)
    with pytest.raises(rt.exceptions.RayError):
        rt.get(victim, timeout=10)
    rt.get(running, timeout=60)  # the others complete


def test_zero_cpu_tasks_oversubscribe(rt):
    @rt.remote(num_cpus=0)
    def free():
        return 1

    assert sum(rt.get([free.remote() for _ in range(4)], timeout=60)) == 4


def test_runtime_context(rt):
    ctx = rt.get_runtime_context()
    assert ctx.get_job_id()
    assert ctx.get_node_id()


def test_cluster_and_available_resources(rt):
    assert rt.cluster_resources()["CPU"] == 2.0
    assert "GPU" not in rt.cluster_resources()   # RTPU_NUM_GPUS unset
    time.sleep(0.2)
    assert rt.available_resources()["CPU"] == 2.0


def test_local_mode():
    if ray.is_initialized():
        ray.shutdown()
    ray.init(local_mode=True)
    try:
        @ray.remote
        def f(x):
            return x + 1

        assert ray.get(f.remote(1)) == 2

        @ray.remote
        class C:
            def m(self):
                return "local"

        c = C.remote()
        assert ray.get(c.m.remote()) == "local"
    finally:
        ray.shutdown()


def test_state_rpcs_are_not_ported(rt):
    """The state rpcs answer through ``ray_tpu_torch.state``; of them,
    only ``autoscaler_status`` is still not ported (it names the
    autoscaler's module)."""
    from ray_tpu_torch.core import runtime
    head = runtime.get_runtime_if_exists()
    assert isinstance(head.state_list("tasks"), list)
    assert head.state_list("nodes")[0]["Alive"]
    with pytest.raises(ValueError, match="unknown state kind"):
        head.state_list("things")
    assert head.state_summary()["nodes_alive"] == 1
    assert head.memory_summary()["object_store"]["capacity"] > 0
    with pytest.raises(NotImplementedError,
                       match="ray_tpu_torch/autoscaler/"):
        head.autoscaler_status()


# -- one program under both packages --------------------------------------

def _program(pkg, res_kw: dict) -> dict:
    """Values and dtypes through put/get and through a task, the error
    class names a user meets, and the resource tables."""
    out = {}
    pkg.init(num_cpus=2, object_store_memory=256 * 1024 * 1024, **res_kw)
    try:
        rng = np.random.RandomState(0)
        values = {
            "f32": rng.randn(3, 5).astype(np.float32),
            "f64": rng.randn(700, 400),          # > inline limit: store
            "i8": rng.randint(-100, 100, (17,)).astype(np.int8),
            "u16": rng.randint(0, 60000, (4, 4)).astype(np.uint16),
            "bool": rng.rand(9) > 0.5,
            "nested": {"a": [1, 2.5, "three"], "b": (b"\x00\xff", None)},
        }

        @pkg.remote
        def describe(x):
            import numpy as np_
            if isinstance(x, np_.ndarray):
                return (str(x.dtype), x.shape, float(x.astype(
                    np_.float64).sum()))
            return repr(x)

        for name, v in values.items():
            got = pkg.get(pkg.put(v), timeout=60)
            if isinstance(v, np.ndarray):
                assert got.dtype == v.dtype and np.array_equal(got, v)
                out[f"put:{name}"] = (str(got.dtype), got.shape,
                                      got.tobytes())
            else:
                assert got == v
                out[f"put:{name}"] = repr(got)
            out[f"task:{name}"] = pkg.get(describe.remote(v), timeout=60)

        @pkg.remote(max_retries=0)
        def boom():
            raise KeyError("missing")

        @pkg.remote
        def sleepy():
            time.sleep(30)

        @pkg.remote
        class A:
            def m(self):
                return 1

        errors = []
        try:
            pkg.get(boom.remote(), timeout=60)
        except Exception as e:      # noqa: BLE001 — the class is the result
            errors.append([type(e).__name__, isinstance(e, KeyError),
                           isinstance(e, pkg.exceptions.RayTaskError)])
        try:
            pkg.get(sleepy.remote(), timeout=0.2)
        except Exception as e:      # noqa: BLE001
            errors.append(type(e).__name__)
        a = A.remote()
        pkg.get(a.m.remote(), timeout=60)
        pkg.kill(a)
        try:
            pkg.get(a.m.remote(), timeout=30)
        except Exception as e:      # noqa: BLE001
            errors.append(type(e).__name__)
        out["errors"] = errors
        out["exceptions"] = sorted(n for n in dir(pkg.exceptions)
                                   if n.endswith(("Error", "Exception")))
        out["cluster"] = pkg.cluster_resources()
        out["nodes"] = sorted(pkg.nodes()[0])
    finally:
        pkg.shutdown()
    return out


def test_put_get_and_errors_match_the_reference():
    import ray_tpu
    if ray.is_initialized():
        ray.shutdown()
    ref = _program(ray_tpu, {})
    port = _program(ray, {})
    assert port == ref
    assert ref["errors"][0][1]      # the caller catches a KeyError
    assert ref["errors"][1:] == ["GetTimeoutError", "ActorDiedError"]


def test_resource_tables_match_the_reference_with_gpu_for_tpu():
    import ray_tpu
    if ray.is_initialized():
        ray.shutdown()

    def tables(pkg, kind):
        opt = {"TPU": "num_tpus", "GPU": "num_gpus"}[kind]
        pkg.init(num_cpus=2, **{opt: 2})
        try:
            @pkg.remote(**{opt: 1})
            class Holder:
                def ok(self):
                    return True

            total = pkg.cluster_resources()
            h = Holder.remote()
            pkg.get(h.ok.remote(), timeout=60)
            time.sleep(0.5)
            held = pkg.available_resources()
            pkg.kill(h)
            deadline = time.monotonic() + 30
            while pkg.available_resources().get(kind) != 2.0 and \
                    time.monotonic() < deadline:
                time.sleep(0.1)
            back = pkg.available_resources()
            row = pkg.nodes()[0]
            return [{k.replace(kind, "ACCEL"): v for k, v in t.items()}
                    for t in (total, held, back, row["Resources"])] + \
                [sorted(row)]
        finally:
            pkg.shutdown()

    ref = tables(ray_tpu, "TPU")
    port = tables(ray, "GPU")
    assert port == ref
    assert ref[1]["ACCEL"] == 1.0 and ref[2]["ACCEL"] == 2.0
