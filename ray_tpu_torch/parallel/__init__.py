"""ray_tpu_torch.parallel — device meshes and tensor-parallel shards
(counterpart of ``ray_tpu/parallel``).

Modules:
  mesh      — ``MeshSpec``, ``build_mesh`` (a ``Mesh`` of ``torch.device``
              in the reference's axis layout), the current-mesh context
              and the GPU topology
  sharding  — the reference's logical-axis rules, and the explicit shards
              of a tp mesh: ``shard_tensor``, ``unshard``, ``tp_all_reduce``

The paged serving engine (``llm/paged_engine.py``, ``mesh=``) serves over
a tp mesh from one process. The reference's ``ring``, ``pipeline`` and
``collective`` modules are not ported.
"""
import importlib

# Lazy (PEP 562): importing the package loads neither module.
_EXPORTS = {
    "MeshSpec": "mesh", "Mesh": "mesh", "build_mesh": "mesh",
    "get_mesh": "mesh", "use_mesh": "mesh", "gpu_topology": "mesh",
    "GpuTopology": "mesh", "default_devices": "mesh",
    "LOGICAL_AXIS_RULES": "sharding", "logical_spec": "sharding",
    "batch_spec": "sharding", "constrain": "sharding",
    "shard_tensor": "sharding", "unshard": "sharding",
    "tp_all_reduce": "sharding",
}
_MODULES = ("mesh", "sharding")

__all__ = list(_EXPORTS) + list(_MODULES)


def __getattr__(name):
    if name in _EXPORTS:
        mod = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(mod, name)
    if name in _MODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
