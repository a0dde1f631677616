"""The port's in-process multi-node cluster (``ray_tpu_torch.cluster_utils``)
under placement groups.

The cluster cases of ``tests/test_placement_group.py`` (PACK reserves,
STRICT_SPREAD needs two nodes, an infeasible STRICT_PACK stays pending,
a task and actors in bundles, removal returns resources, re-reservation
after node loss) run on the port's ``Cluster`` with the reference's
assertions. Then ``add_node(num_gpus=...)``: a worker of an added node
leases that node's own GPU indices (fake GPUs: CUDA is never touched),
and ``remove_node`` takes its GPUs out of the cluster.

The remote functions and classes are defined inside the tests, so they
pickle by value: a worker never imports this module.
"""
import os
import time

import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.placement_group import (placement_group,
                                                placement_group_table,
                                                remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy, PlacementGroupSchedulingStrategy)


@pytest.fixture
def cluster():
    if ray.is_initialized():
        ray.shutdown()
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    yield c
    c.shutdown()


def test_pg_pack_reserves_resources(cluster):
    cluster.add_node(num_cpus=2)
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert pg.wait(timeout_seconds=10)
    avail = ray.available_resources()
    assert avail.get("CPU", 0) == 1.0  # 3 total - 2 reserved


def test_pg_strict_spread_needs_nodes(cluster):
    cluster.add_node(num_cpus=1)
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_SPREAD")
    assert pg.wait(timeout_seconds=10)
    tbl = placement_group_table()[pg.id.hex()]
    nodes = set(tbl["bundle_nodes"].values())
    assert len(nodes) == 2  # two distinct nodes


def test_pg_strict_pack_infeasible_stays_pending(cluster):
    cluster.add_node(num_cpus=1)
    pg = placement_group([{"CPU": 2}], strategy="STRICT_PACK")
    assert not pg.wait(timeout_seconds=1)


def test_task_in_placement_group(cluster):
    cluster.add_node(num_cpus=2, resources={"pgres": 2})
    pg = placement_group([{"CPU": 1, "pgres": 1}], strategy="PACK")
    assert pg.wait(timeout_seconds=10)

    @ray.remote(num_cpus=1, resources={"pgres": 1})
    def where():
        return "in-bundle"

    ref = where.options(
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=0)).remote()
    assert ray.get(ref, timeout=60) == "in-bundle"


def test_actor_in_placement_group(cluster):
    cluster.add_node(num_cpus=2)
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert pg.wait(timeout_seconds=10)

    @ray.remote(num_cpus=1)
    class W:
        def ping(self):
            return "pong"

    actors = [
        W.options(scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=i)).remote()
        for i in range(2)
    ]
    assert ray.get([a.ping.remote() for a in actors],
                   timeout=60) == ["pong", "pong"]


def test_remove_pg_returns_resources(cluster):
    cluster.add_node(num_cpus=2)
    pg = placement_group([{"CPU": 2}], strategy="PACK")
    assert pg.wait(timeout_seconds=10)
    before = ray.available_resources().get("CPU", 0)
    remove_placement_group(pg)
    time.sleep(0.2)
    after = ray.available_resources().get("CPU", 0)
    assert after == before + 2


def test_pg_reschedules_after_node_loss(cluster):
    n1 = cluster.add_node(num_cpus=4, resources={"big": 4})
    pg = placement_group([{"CPU": 2, "big": 2}], strategy="PACK")
    assert pg.wait(timeout_seconds=10)
    cluster.remove_node(n1)
    cluster.add_node(num_cpus=4, resources={"big": 4})
    assert pg.wait(timeout_seconds=30)


def test_added_nodes_lease_their_own_gpus(cluster):
    a = cluster.add_node(num_cpus=1, num_gpus=2, name="a")
    b = cluster.add_node(num_cpus=1, num_gpus=1, name="b")
    assert ray.cluster_resources()["GPU"] == 3.0
    assert [n.node_id_hex for n in cluster.list_all_nodes()] == \
        [cluster.head_handle.node_id_hex, a.node_id_hex, b.node_id_hex]

    @ray.remote
    class Visible:
        def report(self):
            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    os.environ.get("RTPU_NODE_ID"))

    def pinned(node, n):
        return Visible.options(num_gpus=n, scheduling_strategy=(
            NodeAffinitySchedulingStrategy(node_id=node.node_id_hex,
                                           soft=False))).remote()

    on_a, on_b = pinned(a, 2), pinned(b, 1)
    assert ray.get(on_a.report.remote(), timeout=60) == ("0,1",
                                                         a.node_id_hex)
    assert ray.get(on_b.report.remote(), timeout=60) == ("0",
                                                         b.node_id_hex)
    cluster.remove_node(a)
    assert ray.cluster_resources()["GPU"] == 1.0
    ray.kill(on_b)
    deadline = time.monotonic() + 30
    while ray.available_resources().get("GPU") != 1.0:
        assert time.monotonic() < deadline, ray.available_resources()
        time.sleep(0.1)
