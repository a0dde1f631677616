"""``ray_tpu_torch.parallel`` (mesh and sharding) against the reference's
``ray_tpu.parallel`` on conftest's virtual CPU devices: ``MeshSpec``
resolution, ``build_mesh``'s shape and axis names, and ``logical_spec``
of every logical-axis tuple of both packages' ``llama.logical_axes``
(dense and MoE) and of the slot table, equal to the reference's
``PartitionSpec`` read as a tuple. Then the port's own shards:
``shard_tensor`` / ``unshard`` round trips, ``tp_all_reduce``, and the
axes it refuses."""
import jax
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import sharding as jsharding
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import (
    LOGICAL_AXIS_RULES, MeshSpec, batch_spec, build_mesh, constrain,
    get_mesh, gpu_topology, logical_spec, shard_tensor, tp_all_reduce,
    unshard, use_mesh,
)

SPECS = [dict(tp=2), dict(tp=4), dict(dp=2, tp=2), dict(dp=-1, tp=2),
         dict(dp=2, fsdp=2, tp=2), dict(fsdp=2, tp=2),
         dict(tp=2, keep_unit_axes=False), dict(dp=-1)]


def _pair(spec: dict, n: int):
    """(reference mesh, port mesh) over n devices."""
    ref = jmesh.build_mesh(jmesh.MeshSpec(**spec), devices=jax.devices()[:n])
    port = build_mesh(MeshSpec(**spec), devices=["cpu"] * n)
    return ref, port


@pytest.mark.parametrize("spec", SPECS, ids=str)
@pytest.mark.parametrize("n", [4, 8])
def test_meshspec_and_build_mesh_match_reference(spec, n):
    try:
        want = jmesh.MeshSpec(**spec).resolved(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(",")[0][:20]):
            MeshSpec(**spec).resolved(n)
        return
    assert MeshSpec(**spec).resolved(n) == want
    ref, port = _pair(spec, n)
    assert port.axis_names == tuple(ref.axis_names)
    assert dict(port.shape) == dict(ref.shape)
    assert port.devices.shape == ref.devices.shape
    assert all(d == torch.device("cpu") for d in port.devices.flat)


def test_meshspec_errors_match_reference():
    for spec, n in ((dict(dp=3, tp=2), 8), (dict(dp=-1, tp=-1), 8),
                    (dict(dp=-1, tp=3), 8)):
        with pytest.raises(ValueError):
            jmesh.MeshSpec(**spec).resolved(n)
        with pytest.raises(ValueError):
            MeshSpec(**spec).resolved(n)


def _axes_tuples(tree):
    if isinstance(tree, tuple):
        return [tree]
    return [t for v in tree.values() for t in _axes_tuples(v)]


def _slot_table_axes(targets=("wq", "wk", "wv", "wo", "lm_head")):
    from ray_tpu_torch.llm.multilora.slots import AdapterSlotTable
    return AdapterSlotTable(tllama.llama_tiny(), 2, 4, targets,
                            device="cpu").logical_axes()


@pytest.mark.parametrize("spec", [s for s in SPECS if "dp" not in s
                                  or s.get("dp") != -1], ids=str)
@pytest.mark.parametrize("moe", [False, True])
def test_logical_spec_matches_reference_partition_spec(spec, moe):
    """Every logical-axis tuple the port shards by (its own and the
    reference's llama.logical_axes, dense or MoE, and the slot table's)
    resolves to the reference's PartitionSpec, read as a tuple."""
    kw = dict(moe_experts=4, moe_top_k=2) if moe else {}
    port_axes = tllama.logical_axes(tllama.llama_tiny(**kw))
    ref_axes = jllama.logical_axes(jllama.llama_tiny(**kw))
    assert port_axes == ref_axes
    n = MeshSpec(**spec).wanted()
    ref, port = _pair(spec, n)
    tuples = _axes_tuples(port_axes) + list(_slot_table_axes().values())
    tuples += [("batch", "sequence", "embed"), ("embed", "mlp"),
               ("vocab", "embed"), ("mlp", "vocab"),
               (None, "heads", "head_dim"), (None, "kv_heads", None)]
    for axes in tuples:
        want = tuple(jsharding.logical_spec(axes, ref))
        assert logical_spec(axes, port) == want, axes
        with use_mesh(port):
            assert logical_spec(axes) == want
    assert batch_spec(port) == tuple(jsharding.batch_spec(ref))
    assert LOGICAL_AXIS_RULES == jsharding.LOGICAL_AXIS_RULES


def test_logical_spec_rejects_unknown_axis():
    _ref, port = _pair(dict(tp=2), 2)
    with pytest.raises(ValueError, match="no sharding rule"):
        logical_spec(("nonsense",), port)


def test_use_mesh_is_thread_local_and_nests():
    import threading
    _ref, a = _pair(dict(tp=2), 2)
    _ref, b = _pair(dict(tp=4), 4)
    assert get_mesh() is None
    seen = []
    with use_mesh(a):
        with use_mesh(b):
            assert get_mesh() is b
            t = threading.Thread(target=lambda: seen.append(get_mesh()))
            t.start()
            t.join()
        assert get_mesh() is a
    assert get_mesh() is None and seen == [None]
    x = torch.ones(3)
    assert constrain(x, ("batch",)) is x


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_shard_tensor_unshard_round_trip(tp):
    """Each tp rank gets one contiguous equal slice of the split dim on
    its device (replicated tensors whole); unshard restores the tensor
    bit for bit."""
    _ref, mesh = _pair(dict(tp=tp), tp)
    mc = tllama.llama_tiny(n_kv_heads=4)
    params = tllama.init(mc, seed=1, device="cpu")
    axes = tllama.logical_axes(mc)
    cases = [(params["embed"], axes["embed"], 0),
             (params["lm_head"], axes["lm_head"], 1),
             (params["final_norm"], axes["final_norm"], None)]
    cases += [(params["layers"][n], axes["layers"][n],
               {"wq": 2, "wk": 2, "wv": 2, "wo": 1, "w_gate": 2, "w_up": 2,
                "w_down": 1}.get(n)) for n in params["layers"]]
    for t, ax, dim in cases:
        parts = shard_tensor(t, ax, mesh)
        assert len(parts) == tp
        for r, p in enumerate(parts):
            assert p.is_contiguous() and p.device == torch.device("cpu")
            if dim is None:
                assert torch.equal(p, t)
            else:
                n = t.shape[dim] // tp
                assert torch.equal(p, t.narrow(dim, r * n, n))
        assert torch.equal(unshard(parts, ax, mesh), t)


def test_shard_tensor_refuses_a_split_it_cannot_make():
    _ref, mesh = _pair(dict(tp=4), 4)
    with pytest.raises(ValueError, match="must divide"):
        shard_tensor(torch.zeros(6, 3), ("vocab", "embed"), mesh)
    _ref, dp = _pair(dict(dp=2, tp=2), 4)
    with pytest.raises(NotImplementedError, match="A9.2"):
        shard_tensor(torch.zeros(4, 4), ("embed", "mlp"), dp)


def test_tp_all_reduce_sums_in_rank_order():
    parts = [torch.full((3,), float(i + 1)) for i in range(4)]
    out = tp_all_reduce(parts)
    assert len(out) == 4
    assert all(torch.equal(o, torch.full((3,), 10.0)) for o in out)
    one = torch.ones(2)
    assert tp_all_reduce([one])[0] is one


def test_gpu_topology_on_the_cpu():
    topo = gpu_topology(["cpu", "cpu"])
    assert topo.name == "cpu" and topo.num_devices == 2
    assert topo.peak_flops_bf16 is None and topo.total_peak_flops is None
    assert jmesh.tpu_topology().num_devices == len(jax.devices())
