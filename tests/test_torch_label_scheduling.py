"""Task/actor label_selector scheduling (reference: the label_selector
option + node-label scheduling strategy; labels come from init(labels=)
or agent --labels).

The port's copy of ``tests/test_label_scheduling.py``, with its imports
pointed at ``ray_tpu_torch``.

Its labeled cluster's second node is the port's agent, ``python -m
ray_tpu_torch.core.node_agent``.
"""
import os
import subprocess
import sys
import time

import pytest

import ray_tpu_torch


@pytest.fixture
def labeled_cluster():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, labels={"zone": "head", "disk": "ssd"})
    info = ray_tpu_torch.head_address()
    env = dict(os.environ)
    env["RTPU_AUTHKEY"] = info["authkey"]
    agent = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.core.node_agent",
         "--head", info["address"], "--num-cpus", "2",
         "--name", "lab-node", "--labels", '{"zone": "edge"}'],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    deadline = time.time() + 30
    node_id = None
    while time.time() < deadline and node_id is None:
        for n in ray_tpu_torch.nodes():
            if n["NodeName"] == "lab-node" and n["Alive"]:
                node_id = n["NodeID"]
        time.sleep(0.1)
    assert node_id, "labeled agent never joined"
    yield node_id
    agent.terminate()
    agent.wait(timeout=10)
    ray_tpu_torch.shutdown()


def test_label_selector_routes_tasks(labeled_cluster):
    edge_node = labeled_cluster

    @ray_tpu_torch.remote(num_cpus=1)
    def where():
        return os.environ.get("RTPU_NODE_ID")

    # every labeled submit lands on the matching node
    edge = ray_tpu_torch.get(
        [where.options(label_selector={"zone": "edge"}).remote()
         for _ in range(4)], timeout=120)
    assert set(edge) == {edge_node}
    head = ray_tpu_torch.get(
        [where.options(label_selector={"zone": "head"}).remote()
         for _ in range(4)], timeout=120)
    assert edge_node not in set(head)
    # multi-key selector must match ALL labels
    ssd = ray_tpu_torch.get(where.options(
        label_selector={"zone": "head", "disk": "ssd"}).remote(),
        timeout=120)
    assert ssd != edge_node


def test_label_selector_actor_placement(labeled_cluster):
    edge_node = labeled_cluster

    @ray_tpu_torch.remote(num_cpus=1)
    class Pin:
        def node(self):
            return os.environ.get("RTPU_NODE_ID")

    a = Pin.options(label_selector={"zone": "edge"}).remote()
    assert ray_tpu_torch.get(a.node.remote(), timeout=120) == edge_node


@pytest.mark.slow
def test_unmatchable_selector_stays_pending(labeled_cluster):
    @ray_tpu_torch.remote(num_cpus=1)
    def nope():
        return 1

    ref = nope.options(label_selector={"zone": "mars"}).remote()
    with pytest.raises(ray_tpu_torch.exceptions.GetTimeoutError):
        ray_tpu_torch.get(ref, timeout=3)
