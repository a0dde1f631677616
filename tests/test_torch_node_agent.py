"""The port's node agent (``ray_tpu_torch/core/node_agent.py``) over the
head's TCP control plane.

The cases of ``tests/test_node_agent.py`` (a task pinned to the agent's
node, an actor round trip there, the agent's death removing its node
while the head goes on serving, a hung agent found by its missed
heartbeats) and of ``tests/test_label_scheduling.py`` (label selectors
route tasks and actors to the agent's node) run on the port with the
reference's assertions, and an agent joins a head started with
``enable_remote_nodes=True``. A real agent process joins each time
(``cluster_utils.node_agent``).

Then GPU leases across the wire, with fake GPUs (indices are counted;
CUDA is never touched): an agent with ``--num-gpus 2`` beside a head with
``num_gpus=1``. A worker on each node gets that node's own indices in
``CUDA_VISIBLE_DEVICES``; a killed or reaped worker of the agent gives
its indices back to the agent's node; a dead agent's GPUs leave
``cluster_resources()`` and its workers exit. Last, ``util/gpu.py``'s
labels with and without an ``nvidia-smi`` on ``PATH``.

The remote functions and classes are defined inside the tests, so they
pickle by value: a worker never imports this module.
"""
import os
import signal
import stat
import time

import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.cluster_utils import node_agent
from ray_tpu_torch.util.scheduling_strategies import \
    NodeAffinitySchedulingStrategy


def _pin(node_id):
    return NodeAffinitySchedulingStrategy(node_id=node_id, soft=False)


def _wait(pred, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.1)


def _node(node_id):
    return next(n for n in ray.nodes() if n["NodeID"] == node_id)


@pytest.fixture
def head():
    if ray.is_initialized():
        ray.shutdown()
    ray.init(num_cpus=2, object_store_memory=256 << 20)
    yield ray
    ray.shutdown()


@pytest.fixture
def agent_cluster(head):
    with node_agent("second-host", num_cpus=2) as agent:
        yield head, agent


def test_agent_node_runs_affine_task(agent_cluster):
    ray, agent = agent_cluster

    @ray.remote
    def where():
        return (os.environ.get("RTPU_NODE_ID"), os.getpid(),
                os.environ.get("RTPU_HEAD_FAMILY"))

    got_node, got_pid, family = ray.get(
        where.options(scheduling_strategy=_pin(agent.node_id)).remote(),
        timeout=60)
    assert got_node == agent.node_id
    assert got_pid != os.getpid()
    assert family == "AF_INET"          # dialed the head over TCP


def test_agent_node_actor_roundtrip(agent_cluster):
    ray, agent = agent_cluster

    @ray.remote
    class Acc:
        def __init__(self):
            self.total = 0

        def add(self, x):
            self.total += x
            return self.total

    a = Acc.options(scheduling_strategy=_pin(agent.node_id)).remote()
    assert ray.get([a.add.remote(i) for i in range(1, 5)],
                   timeout=60)[-1] == 10


def test_agent_death_removes_node_and_fails_over(agent_cluster):
    ray, agent = agent_cluster

    @ray.remote
    def pid():
        return os.getpid()

    worker = ray.get(pid.options(
        scheduling_strategy=_pin(agent.node_id)).remote(), timeout=60)
    assert any(n["NodeID"] == agent.node_id and n["Alive"]
               for n in ray.nodes())
    agent.proc.kill()                   # SIGKILL: no teardown runs
    agent.proc.wait()
    _wait(lambda: not _node(agent.node_id)["Alive"],
          what="the dead agent's node to leave")

    @ray.remote
    def ping():
        return "pong"

    assert ray.get(ping.remote(), timeout=60) == "pong"
    # the dead agent could not kill its worker: the head ends the
    # worker's control connection and the worker exits on its EOF
    _wait(lambda: not os.path.exists(f"/proc/{worker}")
          or open(f"/proc/{worker}/stat").read().rsplit(")", 1)[1]
          .split()[0] == "Z", what="the orphaned worker to exit")


def test_hung_agent_detected_by_heartbeat_timeout():
    """A node agent that stops heartbeating (hung, not dead) is removed
    after health_check_timeout_s (gcs_health_check_manager analog)."""
    from ray_tpu_torch.core.config import cfg
    if ray.is_initialized():
        ray.shutdown()
    cfg.override(health_check_timeout_s=3.0, health_check_period_ms=500)
    ray.init(num_cpus=1, object_store_memory=256 << 20)
    try:
        with node_agent("hangable", num_cpus=1) as agent:
            os.kill(agent.proc.pid, signal.SIGSTOP)   # conn stays open
            try:
                t0 = time.monotonic()
                _wait(lambda: not _node(agent.node_id)["Alive"],
                      what="the hung agent to be declared dead")
                assert time.monotonic() - t0 < 3.0 + 5.0
            finally:
                os.kill(agent.proc.pid, signal.SIGCONT)
    finally:
        ray.shutdown()
        cfg.reset("health_check_timeout_s", "health_check_period_ms")


def test_enable_remote_nodes_faces_every_interface(monkeypatch):
    """init(enable_remote_nodes=True) binds the head's TCP listener on
    every interface and advertises this host's address, which an agent
    dials. (The host's address is pinned to loopback here, so the test
    needs no route off the machine.)"""
    import json

    from ray_tpu_torch.core import runtime
    if ray.is_initialized():
        ray.shutdown()
    monkeypatch.setattr(runtime, "host_ip", lambda: "127.0.0.1")
    ray.init(num_cpus=1, enable_remote_nodes=True,
             object_store_memory=256 << 20)
    try:
        head = runtime.get_runtime_if_exists()
        with open(head.cluster_file) as f:
            cf = json.load(f)
        assert cf["tcp_host"] == "0.0.0.0"
        assert ray.head_address()["address"] == \
            f"127.0.0.1:{cf['tcp_port']}"
        assert head.data_server.address.startswith("0.0.0.0:")
        with node_agent("remote-host", num_cpus=1) as agent:
            @ray.remote
            def where():
                return os.environ.get("RTPU_NODE_ID")

            assert ray.get(where.options(
                scheduling_strategy=_pin(agent.node_id)).remote(),
                timeout=60) == agent.node_id
    finally:
        ray.shutdown()


# -- label routing (tests/test_label_scheduling.py) ------------------------

@pytest.fixture
def labeled_cluster():
    if ray.is_initialized():
        ray.shutdown()
    ray.init(num_cpus=2, labels={"zone": "head", "disk": "ssd"},
             object_store_memory=256 << 20)
    try:
        with node_agent("lab-node", labels={"zone": "edge"}) as agent:
            yield agent.node_id
    finally:
        ray.shutdown()


def test_label_selector_routes_tasks(labeled_cluster):
    edge_node = labeled_cluster

    @ray.remote(num_cpus=1)
    def where():
        return os.environ.get("RTPU_NODE_ID")

    edge = ray.get(
        [where.options(label_selector={"zone": "edge"}).remote()
         for _ in range(4)], timeout=120)
    assert set(edge) == {edge_node}
    head = ray.get(
        [where.options(label_selector={"zone": "head"}).remote()
         for _ in range(4)], timeout=120)
    assert edge_node not in set(head)
    # a multi-key selector must match ALL labels
    ssd = ray.get(where.options(
        label_selector={"zone": "head", "disk": "ssd"}).remote(),
        timeout=120)
    assert ssd != edge_node


def test_label_selector_actor_placement(labeled_cluster):
    edge_node = labeled_cluster

    @ray.remote(num_cpus=1)
    class Pin:
        def node(self):
            return os.environ.get("RTPU_NODE_ID")

    a = Pin.options(label_selector={"zone": "edge"}).remote()
    assert ray.get(a.node.remote(), timeout=120) == edge_node


# -- GPU leases across the wire (fake GPUs) --------------------------------

@pytest.fixture
def gpu_cluster():
    if ray.is_initialized():
        ray.shutdown()
    ray.init(num_cpus=2, num_gpus=1, object_store_memory=256 << 20)
    try:
        with node_agent("gpu-host", num_cpus=2, num_gpus=2) as agent:
            yield agent
    finally:
        ray.shutdown()


def _visible_actor():
    @ray.remote
    class Visible:
        def report(self):
            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    os.environ.get("RTPU_NODE_ID"))
    return Visible


def test_each_node_leases_its_own_indices(gpu_cluster):
    agent = gpu_cluster
    head_id = next(n["NodeID"] for n in ray.nodes()
                   if n["NodeName"] == "head")
    assert ray.cluster_resources()["GPU"] == 3.0
    assert _node(agent.node_id)["Resources"]["GPU"] == 2.0
    Visible = _visible_actor()
    on_head = Visible.options(num_gpus=1,
                              scheduling_strategy=_pin(head_id)).remote()
    on_agent = Visible.options(
        num_gpus=2, scheduling_strategy=_pin(agent.node_id)).remote()
    assert ray.get(on_head.report.remote(), timeout=60) == ("0", head_id)
    assert ray.get(on_agent.report.remote(), timeout=60) == \
        ("0,1", agent.node_id)

    @ray.remote
    def cpu_task():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    assert ray.get(cpu_task.options(
        scheduling_strategy=_pin(agent.node_id)).remote(), timeout=60) == ""
    _wait(lambda: ray.available_resources().get("GPU", 0) == 0,
          what="every GPU to be held")
    ray.kill(on_head)
    ray.kill(on_agent)
    _wait(lambda: ray.available_resources().get("GPU") == 3.0,
          what="the GPUs to come back")


def test_killed_and_reaped_agent_workers_give_indices_back(gpu_cluster):
    agent = gpu_cluster
    Visible = _visible_actor()
    one = Visible.options(num_gpus=1,
                          scheduling_strategy=_pin(agent.node_id)).remote()
    assert ray.get(one.report.remote(), timeout=60)[0] == "0"
    ray.kill(one)
    _wait(lambda: _node(agent.node_id)["Available"].get("GPU") == 2.0,
          what="the agent's GPU to come back to its node")

    @ray.remote(num_gpus=1)
    def lease():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    # an idle one-GPU worker of the agent keeps its index; a two-GPU
    # request there reaps it, and the index goes back to the agent's
    # node (the head's index 0 is another card)
    assert ray.get(lease.options(
        scheduling_strategy=_pin(agent.node_id)).remote(),
        timeout=60) in ("0", "1")
    two = Visible.options(num_gpus=2,
                          scheduling_strategy=_pin(agent.node_id)).remote()
    assert ray.get(two.report.remote(), timeout=60) == ("0,1",
                                                        agent.node_id)
    head = next(n for n in ray.nodes() if n["NodeName"] == "head")
    assert head["Available"]["GPU"] == 1.0
    ray.kill(two)


def test_dead_agent_gpus_leave_the_cluster(gpu_cluster):
    agent = gpu_cluster
    Visible = _visible_actor()
    a = Visible.options(num_gpus=1,
                        scheduling_strategy=_pin(agent.node_id)).remote()
    assert ray.get(a.report.remote(), timeout=60)[0] == "0"
    agent.proc.kill()
    agent.proc.wait()
    _wait(lambda: ray.cluster_resources().get("GPU") == 1.0,
          what="the dead agent's GPUs to leave")
    assert ray.available_resources().get("GPU") == 1.0
    # the head's own index is untouched: a one-GPU actor there gets "0"
    b = Visible.options(num_gpus=1).remote()
    assert ray.get(b.report.remote(), timeout=60)[0] == "0"


# -- util/gpu.py -----------------------------------------------------------

def _fake_smi(tmp_path, body):
    d = tmp_path / "bin"
    d.mkdir(exist_ok=True)
    exe = d / "nvidia-smi"
    exe.write_text("#!/bin/sh\n" + body)
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    return str(d)


def test_gpu_labels_without_and_with_nvidia_smi(tmp_path, monkeypatch):
    from ray_tpu_torch.util import gpu
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert gpu.discover_gpu_labels() == {}
    monkeypatch.setenv("PATH", _fake_smi(
        tmp_path, 'echo "NVIDIA H100 80GB HBM3"\n'
                  'echo "NVIDIA H100 80GB HBM3"\n'))
    assert gpu.discover_gpu_labels() == {
        gpu.KIND_LABEL: "NVIDIA H100 80GB HBM3", gpu.COUNT_LABEL: "2"}
    monkeypatch.setenv("PATH", _fake_smi(tmp_path, "exit 9\n"))
    assert gpu.discover_gpu_labels() == {}
    monkeypatch.setenv("PATH", _fake_smi(tmp_path, "sleep 5\n"))
    assert gpu.discover_gpu_labels(timeout_s=0.5) == {}


def test_agent_labels_its_node_from_nvidia_smi(tmp_path, monkeypatch, head):
    from ray_tpu_torch.util import gpu
    monkeypatch.setenv("PATH", _fake_smi(
        tmp_path, 'echo "NVIDIA H100 80GB HBM3"\n') + os.pathsep +
        os.environ["PATH"])
    with node_agent("smi-host", num_gpus=1,
                    labels={"zone": "edge"}) as agent:
        labels = _node(agent.node_id)["Labels"]
        assert labels == {gpu.KIND_LABEL: "NVIDIA H100 80GB HBM3",
                          gpu.COUNT_LABEL: "1", "zone": "edge"}

        @ray.remote(num_gpus=1)
        def where():
            return os.environ.get("RTPU_NODE_ID")

        assert ray.get(where.options(label_selector={
            gpu.KIND_LABEL: "NVIDIA H100 80GB HBM3"}).remote(),
            timeout=60) == agent.node_id
