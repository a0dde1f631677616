"""The port's multi-host data plane: own-store node agents and object
transfer, end to end.

The cases of ``tests/test_multihost_data_plane.py`` run on the port with
the reference's assertions: a node agent with its OWN store joins over
TCP, a driver-put object is pulled into the island's store as a task's
argument, a result crosses back to the driver, the island's RPC replies
ride the control connection, a chain of tasks stays on the island, and a
named actor there is reached across stores. (The reference's device
object case waits for the port's device objects.) Torch tensors cross
both ways as CPU tensors, bf16 included.

Then one two-node program runs under both packages, one after the other,
and its outputs are compared: values through a chain of tasks across the
two stores, the error class names a user meets (a get timeout and a
killed actor on the island, a task's own exception), and the ``nodes()``
rows with "GPU" in the place of "TPU".

The remote functions and classes are defined inside the tests, so they
pickle by value: a worker never imports this module.
"""
import contextlib
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as ray
from ray_tpu_torch.cluster_utils import node_agent


@pytest.fixture
def own_store_cluster():
    if ray.is_initialized():
        ray.shutdown()
    ray.init(num_cpus=2, object_store_memory=256 << 20)
    try:
        with node_agent("island", num_cpus=2, own_store=True,
                        store_capacity=256 << 20) as agent:
            yield ray, agent.node_id
    finally:
        ray.shutdown()


def _on_node(pkg, node_id):
    mod = importlib.import_module(
        f"{pkg.__name__}.util.scheduling_strategies")
    return {"scheduling_strategy": mod.NodeAffinitySchedulingStrategy(
        node_id=node_id, soft=False)}


def test_args_cross_to_own_store_node(own_store_cluster):
    """A driver-put object is pulled into the island node's store."""
    ray, node_id = own_store_cluster
    payload = np.arange(200_000)          # ~1.6MB: a real transfer
    ref = ray.put(payload)

    @ray.remote(num_cpus=1, **_on_node(ray, node_id))
    def consume(arr):
        return int(arr.sum()), os.environ.get("RTPU_OWN_STORE")

    total, flag = ray.get(consume.remote(ref), timeout=120)
    assert total == int(payload.sum())
    assert flag == "1"                     # really ran on the island


def test_results_cross_back_to_driver(own_store_cluster):
    ray, node_id = own_store_cluster

    @ray.remote(num_cpus=1, **_on_node(ray, node_id))
    def produce(n):
        import numpy as np
        return np.ones(n) * 7

    out = ray.get(produce.remote(100_000), timeout=120)
    assert out.shape == (100_000,) and float(out[0]) == 7.0


def test_island_rpcs_work(own_store_cluster):
    """Worker→head RPC replies must ride the conn (the island can't see
    the head store)."""
    ray, node_id = own_store_cluster

    @ray.remote(num_cpus=1, **_on_node(ray, node_id))
    def cluster_cpus():
        import ray_tpu_torch
        return ray_tpu_torch.cluster_resources().get("CPU", 0)

    assert ray.get(cluster_cpus.remote(), timeout=120) >= 3


def test_island_to_island_chain(own_store_cluster):
    """Task chains on the island: intermediate objects stay local."""
    ray, node_id = own_store_cluster

    @ray.remote(num_cpus=1, **_on_node(ray, node_id))
    def step1():
        return list(range(1000))

    @ray.remote(num_cpus=1, **_on_node(ray, node_id))
    def step2(xs):
        return sum(xs)

    assert ray.get(step2.remote(step1.remote()), timeout=120) == 499500


def test_named_actor_across_stores(own_store_cluster):
    ray, node_id = own_store_cluster

    @ray.remote(num_cpus=1, **_on_node(ray, node_id))
    class IslandCounter:
        def __init__(self):
            self.n = 0

        def bump(self, k):
            self.n += k
            return self.n

    c = IslandCounter.options(name="island-counter").remote()
    assert ray.get(c.bump.remote(5), timeout=120) == 5
    again = ray.get_actor("island-counter")
    assert ray.get(again.bump.remote(2), timeout=120) == 7


def test_island_task_error_reaches_its_getters(own_store_cluster):
    """A task that fails on the island seals its error frame in the
    island's store: the driver and a worker of the head's node pull it
    from there and raise the task's own exception. (The reference's head
    records no location for a failed return, so there both gets time
    out; the two-node program below raises its KeyError on the head.)"""
    ray, node_id = own_store_cluster

    @ray.remote(num_cpus=1, max_retries=0, **_on_node(ray, node_id))
    def boom():
        raise KeyError("missing")

    @ray.remote(num_cpus=1)
    def catch(refs):
        import ray_tpu_torch
        try:
            ray_tpu_torch.get(refs[0], timeout=60)
        except KeyError as e:
            return ["KeyError", os.environ.get("RTPU_OWN_STORE"), str(e)]

    ref = boom.remote()
    with pytest.raises(KeyError, match="missing"):
        ray.get(ref, timeout=60)
    got = ray.get(catch.remote([ref]), timeout=60)
    assert got[:2] == ["KeyError", None] and "missing" in got[2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tensors_cross_both_ways(own_store_cluster, dtype):
    """A CPU tensor put by the driver reaches the island bitwise, and a
    tensor made there comes back bitwise (the frames move as they are)."""
    ray, node_id = own_store_cluster
    g = torch.Generator().manual_seed(11)
    sent = torch.randn(512, 1031, generator=g).to(dtype)     # > 1 MiB

    @ray.remote(num_cpus=1, **_on_node(ray, node_id))
    def twice(t):
        return t.dtype, t.device.type, t * 2

    got_dtype, device, back = ray.get(twice.remote(ray.put(sent)),
                                      timeout=120)
    assert (got_dtype, device) == (dtype, "cpu")
    assert back.dtype == dtype
    assert torch.equal(back.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32),
                       (sent * 2).view(torch.int16 if dtype ==
                                       torch.bfloat16 else torch.int32))


# -- one two-node program under both packages -----------------------------

@contextlib.contextmanager
def _reference_island(pkg):
    """The reference's own-store agent with one TPU, as a second host."""
    info = pkg.head_address()
    env = dict(os.environ, RTPU_AUTHKEY=info["authkey"])
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu.core.node_agent",
         "--head", info["address"], "--num-cpus", "2", "--name", "island",
         "--own-store", "--store-capacity", str(256 << 20),
         "--resources", json.dumps({"TPU": 1})],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 60
        node_id = None
        while node_id is None and time.time() < deadline:
            node_id = next((n["NodeID"] for n in pkg.nodes()
                            if n["NodeName"] == "island" and n["Alive"]),
                           None)
            time.sleep(0.1)
        assert node_id, "the reference's agent never registered"
        yield node_id
    finally:
        proc.terminate()
        proc.wait(timeout=15)


@contextlib.contextmanager
def _port_island(pkg):
    with node_agent("island", num_cpus=2, num_gpus=1, own_store=True,
                    store_capacity=256 << 20) as agent:
        yield agent.node_id


def _two_node_program(pkg, island) -> dict:
    out = {}
    pkg.init(num_cpus=2, object_store_memory=256 << 20)
    try:
        with island(pkg) as node_id:
            pin = _on_node(pkg, node_id)
            rng = np.random.RandomState(0)
            arr = rng.randn(300, 700)         # > inline limit: the store

            @pkg.remote(num_cpus=1, **pin)
            def double(x):
                return x * 2

            @pkg.remote(num_cpus=1, **pin)
            def stats(x):
                return (str(x.dtype), x.shape, float(x.sum()),
                        os.environ.get("RTPU_OWN_STORE"))

            @pkg.remote(num_cpus=1)
            def head_side(x):
                return float(x[0, 0])

            r1 = double.remote(pkg.put(arr))
            out["chain"] = pkg.get(stats.remote(r1), timeout=120)
            back = pkg.get(r1, timeout=120)
            assert np.array_equal(back, arr * 2)
            out["back"] = (str(back.dtype), back.shape, back.tobytes())
            out["head_side"] = pkg.get(head_side.remote(r1), timeout=120)

            head = next(n["NodeID"] for n in pkg.nodes()
                        if n["NodeName"] == "head")

            @pkg.remote(num_cpus=1, max_retries=0, **_on_node(pkg, head))
            def boom():
                raise KeyError("missing")

            @pkg.remote(num_cpus=1, **pin)
            def sleepy():
                time.sleep(30)

            @pkg.remote(num_cpus=1, **pin)
            class A:
                def m(self):
                    return 1

            errors = []
            try:
                pkg.get(boom.remote(), timeout=60)
            except Exception as e:  # noqa: BLE001 — the class is the result
                errors.append([type(e).__name__, isinstance(e, KeyError)])
            try:
                pkg.get(sleepy.remote(), timeout=0.5)
            except Exception as e:  # noqa: BLE001
                errors.append(type(e).__name__)
            a = A.remote()
            pkg.get(a.m.remote(), timeout=60)
            pkg.kill(a)
            # the kill reaches an agent's worker through its agent, so a
            # call right after it may still run (in both packages): call
            # until the death shows
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                try:
                    pkg.get(a.m.remote(), timeout=30)
                except Exception as e:  # noqa: BLE001
                    errors.append(type(e).__name__)
                    break
                time.sleep(0.1)
            out["errors"] = errors
            rows = sorted(pkg.nodes(), key=lambda n: n["NodeName"])
            out["nodes"] = [
                (sorted(n), n["NodeName"], n["Alive"], n["Labels"],
                 {k.replace("TPU", "ACCEL").replace("GPU", "ACCEL"): v
                  for k, v in n["Resources"].items()}) for n in rows]
    finally:
        pkg.shutdown()
    return out


def test_two_node_program_matches_the_reference():
    import ray_tpu
    if ray.is_initialized():
        ray.shutdown()
    ref = _two_node_program(ray_tpu, _reference_island)
    port = _two_node_program(ray, _port_island)
    assert port == ref
    assert ref["chain"][3] == "1"       # ran on an own-store node
    assert ref["errors"] == [["KeyError", True], "GetTimeoutError",
                             "ActorDiedError"]
    assert [n[1] for n in ref["nodes"]] == ["head", "island"]
