"""Placement group tests, on the port's runtime.

The reference's ``tests/test_placement_group.py`` with its imports
pointed at ``ray_tpu_torch``: it reaches the names through
``ray_tpu_torch.util`` as users do (the package re-exports
``placement_group``, ``remove_placement_group``, ``placement_group_table``,
``PlacementGroup`` and ``scheduling_strategies``, and loads ``tracing``
lazily). Its ``ray_start_cluster`` and ``ray_start_regular`` fixtures
are the port's: the in-process ``Cluster`` with a one-CPU head, and
``init(num_cpus=2)``. Remote functions and classes are defined inside
the tests, so a worker never imports this module.
"""
import os
import subprocess
import sys

import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.util import placement_group, remove_placement_group
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def ray_start_regular():
    if ray.is_initialized():
        ray.shutdown()
    ray.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    yield ray
    ray.shutdown()


@pytest.fixture
def ray_start_cluster():
    from ray_tpu_torch.cluster_utils import Cluster
    if ray.is_initialized():
        ray.shutdown()
    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    yield cluster
    cluster.shutdown()


_NAMES = """
import inspect, sys, types
import ray_tpu_torch.util as u
from ray_tpu_torch.util import (PlacementGroup, placement_group,
                                placement_group_table,
                                remove_placement_group,
                                scheduling_strategies)
assert inspect.isfunction(placement_group), placement_group
assert inspect.isfunction(placement_group_table)
assert inspect.isfunction(remove_placement_group)
assert inspect.isclass(PlacementGroup)
assert isinstance(scheduling_strategies, types.ModuleType)
assert "ray_tpu_torch.util.tracing" not in sys.modules
assert isinstance(u.tracing, types.ModuleType)
assert "ray_tpu_torch.util.tracing" in sys.modules
assert all(hasattr(u, n) for n in u.__all__), u.__all__
# the submodule path still reaches the module
from ray_tpu_torch.util.placement_group import PlacementGroup as P
assert P is PlacementGroup
print("OK")
"""


def test_util_reexports_the_reference_names():
    """The reference's kinds of object under the same names: functions,
    the class and the module; ``tracing`` loads on first access only
    (a fresh interpreter, so no other test has loaded it)."""
    import ray_tpu.util as ref
    import ray_tpu_torch.util as u
    for name in ("PlacementGroup", "placement_group",
                 "placement_group_table", "remove_placement_group",
                 "scheduling_strategies", "tracing"):
        assert type(getattr(u, name)) is type(getattr(ref, name)), name
    assert set(u.__all__) <= set(ref.__all__)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _NAMES], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "OK", out.stderr


def test_pg_pack_reserves_resources(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=2)
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert pg.wait(timeout_seconds=10)
    avail = ray.available_resources()
    assert avail.get("CPU", 0) == 1.0  # 3 total - 2 reserved


def test_pg_strict_spread_needs_nodes(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=1)
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_SPREAD")
    assert pg.wait(timeout_seconds=10)
    from ray_tpu_torch.util.placement_group import placement_group_table
    tbl = placement_group_table()[pg.id.hex()]
    nodes = set(tbl["bundle_nodes"].values())
    assert len(nodes) == 2  # two distinct nodes


def test_pg_strict_pack_infeasible_stays_pending(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=1)
    pg = placement_group([{"CPU": 2}], strategy="STRICT_PACK")
    assert not pg.wait(timeout_seconds=1)


def test_task_in_placement_group(ray_start_cluster):
    cluster = ray_start_cluster
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


def test_actor_in_placement_group(ray_start_cluster):
    cluster = ray_start_cluster
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


def test_remove_pg_returns_resources(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=2)
    pg = placement_group([{"CPU": 2}], strategy="PACK")
    assert pg.wait(timeout_seconds=10)
    before = ray.available_resources().get("CPU", 0)
    remove_placement_group(pg)
    import time
    time.sleep(0.2)
    after = ray.available_resources().get("CPU", 0)
    assert after == before + 2


def test_pg_reschedules_after_node_loss(ray_start_cluster):
    cluster = ray_start_cluster
    n1 = cluster.add_node(num_cpus=4, resources={"big": 4})
    pg = placement_group([{"CPU": 2, "big": 2}], strategy="PACK")
    assert pg.wait(timeout_seconds=10)
    cluster.remove_node(n1)
    cluster.add_node(num_cpus=4, resources={"big": 4})
    assert pg.wait(timeout_seconds=30)


def test_invalid_pg_args(ray_start_regular):
    with pytest.raises(ValueError):
        placement_group([], strategy="PACK")
    with pytest.raises(ValueError):
        placement_group([{"CPU": 1}], strategy="DIAGONAL")


def test_pg_task_dispatches_when_node_avail_exhausted(ray_start_regular):
    """A PG bundle reserving the whole node zeroes node.resources_avail;
    tasks against the bundle must still schedule (the saturation gate
    must not mistake bundle-held capacity for a saturated cluster)."""
    import ray_tpu_torch as ray_tpu
    from ray_tpu_torch.util import placement_group

    total = ray_tpu.cluster_resources()["CPU"]
    pg = placement_group([{"CPU": total}])
    assert pg.wait(60)

    @ray_tpu.remote(num_cpus=1)
    def inside():
        return "pg-ran"

    out = ray_tpu.get(
        inside.options(placement_group=pg).remote(), timeout=60)
    assert out == "pg-ran"
    ray_tpu.util.remove_placement_group(pg)
