"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's serving engines,
batch inference, Llama training step and Train library.

A second package beside ``ray_tpu``: the same Llama paged-KV serving
engine, dense-slot engine (behind ``LLMPredictor``), OpenAI app under
Serve's local testing mode and training forward/backward, for dense
and mixture-of-experts configs, written in PyTorch for one NVIDIA H100,
with every Pallas attention kernel of the TPU package replaced by a
hand-written CUDA kernel for Hopper (``ops/csrc``). The package imports
nothing of ``ray_tpu`` and never imports JAX; importing this top-level
module loads nothing heavy.

    from ray_tpu_torch.llm import (PagedEngineConfig,
                                   PagedInferenceEngine, SamplingParams)
    from ray_tpu_torch.models import llama

    eng = PagedInferenceEngine(PagedEngineConfig(model=llama.llama3_8b()))
    out = eng.generate(["hello"], SamplingParams(max_tokens=16))

Entry points run on the card (``device="cuda"``) and raise when CUDA is
absent; pass ``device="cpu"`` for the plain-PyTorch versions the tests
run.

The runtime (``core/``: tasks, actors, the shared-memory object store,
node agents and the object transfer between their stores, driver
clients) is the reference's, with GPUs in the place of its TPUs: a spec
that asks for ``num_gpus=n`` runs in a worker process that leases n
device indices of its node through ``CUDA_VISIBLE_DEVICES``; every other
worker sees none.

    import ray_tpu_torch as rt
    rt.init(num_cpus=4, num_gpus=1)

    @rt.remote(num_gpus=1)
    class Server: ...

A second host joins with ``python -m ray_tpu_torch.core.node_agent
--head <head_address()["address"]> --num-gpus N [--own-store]``, and
another process attaches as a driver with
``rt.init(address=<session>/cluster.json)``. ``ray_tpu_torch.state``
lists the cluster's tasks, actors, objects, workers and nodes, and
``ray_tpu_torch.dag`` compiles actor methods into a graph that sealed
ring channels in the object store drive.

``ray_tpu_torch.parallel`` names device meshes and cuts tensors into
tensor-parallel shards; the paged engine serves over a tp mesh
(``PagedEngineConfig(mesh={"tp": 2})``) from one process.

``ray_tpu_torch.train`` is the Train library over this runtime:
``TorchTrainer`` gang-schedules a train loop on workers that each lease
``ScalingConfig(gpus_per_worker=n)`` GPUs (nccl across them, gloo on
CPUs), collects ``train.report`` metrics and checkpoints, and restarts
a failed gang from the latest checkpoint.

The core API below is loaded at first attribute access (PEP 562), so
``import ray_tpu_torch`` stays light.
"""
import importlib

__version__ = "0.1.0"

_CORE_API = (
    "available_resources", "cancel", "cluster_resources", "get",
    "get_actor", "get_runtime_context", "head_address", "init",
    "is_initialized", "kill", "kv_del", "kv_get", "kv_keys", "kv_put",
    "nodes", "put", "remote", "shutdown", "timeline", "wait",
)

__all__ = [
    "__version__", "exceptions", *_CORE_API, "ObjectRef", "ActorHandle",
    "util", "state", "parallel",
]


def __getattr__(name):
    if name in _CORE_API:
        return getattr(importlib.import_module(".core.api", __name__), name)
    if name == "ObjectRef":
        return importlib.import_module(".core.ref", __name__).ObjectRef
    if name == "ActorHandle":
        return importlib.import_module(".core.actor", __name__).ActorHandle
    if name in ("exceptions", "util", "state", "parallel"):
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
