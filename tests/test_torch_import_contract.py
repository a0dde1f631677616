"""Import contract of the PyTorch port.

ray_tpu_torch and chip_smoke.py import neither JAX (nor its
``ml_dtypes``) nor anything of the ray_tpu package (ray_tpu_torch's own
name shares the prefix, so the check matches module names exactly:
``ray_tpu`` or ``ray_tpu.*``), and
the entry points that default to the card raise on a machine without
one instead of running on the CPU."""
import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import ray_tpu_torch
names = ["ray_tpu_torch"]
for m in pkgutil.walk_packages(ray_tpu_torch.__path__, "ray_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
def banned(n):
    return any(n == p or n.startswith(p + ".")
               for p in ("jax", "jaxlib", "ml_dtypes", "ray_tpu"))
print("MODULES=" + ",".join(names))
print("BANNED=" + ",".join(sorted(n for n in sys.modules if banned(n))))
"""


def _banned(name: str) -> bool:
    return any(name == p or name.startswith(p + ".")
               for p in ("jax", "jaxlib", "ml_dtypes", "ray_tpu"))


def test_port_modules_load_no_jax_and_no_ray_tpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(ln.split("=", 1) for ln in out.stdout.splitlines()
                 if "=" in ln)
    modules = set(lines["MODULES"].split(","))
    for want in ("ray_tpu_torch.ops.ragged_paged_attention",
                 "ray_tpu_torch.ops.paged_attention",
                 "ray_tpu_torch.ops.flash_attention",
                 "ray_tpu_torch.ops._build", "ray_tpu_torch.models.llama",
                 "ray_tpu_torch.models.convert",
                 "ray_tpu_torch.llm.paged_engine",
                 "ray_tpu_torch.llm.engine", "ray_tpu_torch.llm.batch",
                 "ray_tpu_torch.llm.chainstats",
                 "ray_tpu_torch.llm.tokenizer",
                 "ray_tpu_torch.llm.serving", "ray_tpu_torch.llm.openai_api",
                 "ray_tpu_torch.llm.pd_disagg",
                 "ray_tpu_torch.llm.telemetry", "ray_tpu_torch.core.config",
                 "ray_tpu_torch.core.flight", "ray_tpu_torch.util.metrics",
                 "ray_tpu_torch.util.tracing",
                 "ray_tpu_torch.util.profiling",
                 "ray_tpu_torch.serve.context", "ray_tpu_torch.serve.api",
                 "ray_tpu_torch.serve.local_mode",
                 "ray_tpu_torch.serve.batching",
                 "ray_tpu_torch.serve.multiplex", "ray_tpu_torch.core.usage",
                 # Serve over the runtime
                 "ray_tpu_torch.serve.controller",
                 "ray_tpu_torch.serve.handle", "ray_tpu_torch.serve.proxy",
                 "ray_tpu_torch.serve.grpc_proxy",
                 "ray_tpu_torch.serve.metrics",
                 "ray_tpu_torch.serve.frontdoor",
                 "ray_tpu_torch.serve.frontdoor.admission",
                 "ray_tpu_torch.serve.frontdoor.prefix",
                 "ray_tpu_torch.serve.frontdoor.routetable",
                 "ray_tpu_torch.core.ids",
                 "ray_tpu_torch.dag", "ray_tpu_torch.dag.channel",
                 "ray_tpu_torch.dag.compiled", "ray_tpu_torch.dag.nodes",
                 "ray_tpu_torch.state",
                 "ray_tpu_torch.llm.lora", "ray_tpu_torch.llm.tiering",
                 "ray_tpu_torch.llm.multilora",
                 "ray_tpu_torch.llm.multilora.slots",
                 "ray_tpu_torch.llm.multilora.registry",
                 "ray_tpu_torch.llm.multilora.manager",
                 # the single-host runtime
                 "ray_tpu_torch.exceptions", "ray_tpu_torch.core.api",
                 "ray_tpu_torch.core.runtime", "ray_tpu_torch.core.worker",
                 "ray_tpu_torch.core.actor",
                 "ray_tpu_torch.core.remote_function",
                 "ray_tpu_torch.core.object_store",
                 "ray_tpu_torch.core.native.build",
                 "ray_tpu_torch.core.ref", "ray_tpu_torch.core.task_spec",
                 "ray_tpu_torch.core.protocol",
                 "ray_tpu_torch.core.completion",
                 "ray_tpu_torch.core.stacks",
                 "ray_tpu_torch.core.directory",
                 "ray_tpu_torch.core.pubsub",
                 "ray_tpu_torch.core.gcs_store",
                 "ray_tpu_torch.core.memory_monitor",
                 "ray_tpu_torch.core.job_manager",
                 "ray_tpu_torch.core.runtime_env",
                 "ray_tpu_torch.obs", "ray_tpu_torch.obs.scraper",
                 "ray_tpu_torch.obs.tsdb", "ray_tpu_torch.obs.slo",
                 "ray_tpu_torch.util.placement_group",
                 "ray_tpu_torch.util.scheduling_strategies",
                 # the runtime across hosts
                 "ray_tpu_torch.core.client",
                 "ray_tpu_torch.core.node_agent",
                 "ray_tpu_torch.core.object_transfer",
                 "ray_tpu_torch.cluster_utils", "ray_tpu_torch.util.gpu",
                 # Train over the runtime
                 "ray_tpu_torch.train", "ray_tpu_torch.train.config",
                 "ray_tpu_torch.train.session",
                 "ray_tpu_torch.train.checkpoint",
                 "ray_tpu_torch.train.trainer", "ray_tpu_torch.util.fs",
                 # the runtime's utilities
                 "ray_tpu_torch.util.actor_pool",
                 "ray_tpu_torch.util.queue",
                 "ray_tpu_torch.util.multiprocessing",
                 "ray_tpu_torch.util.chaos",
                 # tensor-parallel serving
                 "ray_tpu_torch.parallel", "ray_tpu_torch.parallel.mesh",
                 "ray_tpu_torch.parallel.sharding"):
        assert want in modules, (want, sorted(modules))
    assert lines["BANNED"] == "", lines["BANNED"]


def test_port_worker_processes_load_no_jax_and_no_ray_tpu():
    """A worker of the port's runtime (a CPU task, and an actor holding
    a fake GPU) has neither JAX nor the reference package in
    sys.modules, though the driver here (this test process) has both."""
    import jax  # noqa: F401 — loaded in the driver on purpose
    import ray_tpu  # noqa: F401
    import ray_tpu_torch
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=1, num_gpus=1,
                       object_store_memory=64 * 1024 * 1024)
    try:
        def loaded():
            import sys as _sys
            return os.environ["CUDA_VISIBLE_DEVICES"], sorted(
                n for n in _sys.modules
                if any(n == p or n.startswith(p + ".")
                       for p in ("jax", "jaxlib", "ml_dtypes", "ray_tpu")))

        task = ray_tpu_torch.remote(loaded)

        @ray_tpu_torch.remote(num_gpus=1)
        class Holder:
            def report(self):
                return loaded()

        assert ray_tpu_torch.get(task.remote(), timeout=60) == ("", [])
        assert ray_tpu_torch.get(Holder.remote().report.remote(),
                                 timeout=60) == ("0", [])
    finally:
        ray_tpu_torch.shutdown()


def test_train_and_fs_import_no_pyarrow():
    """``ray_tpu_torch.train`` and ``ray_tpu_torch.util.fs`` load neither
    JAX nor the reference package, and leave pyarrow unloaded until a
    URI or an explicit filesystem needs it."""
    probe = ("import sys, ray_tpu_torch.train, ray_tpu_torch.util.fs\n"
             "print(sorted(n for n in sys.modules if n.split('.')[0] in "
             "('jax', 'jaxlib', 'ml_dtypes', 'ray_tpu', 'pyarrow')))")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_runtime_utilities_import_no_jax_no_ray_tpu_no_torch():
    """``ray_tpu_torch.util``'s actor pool, queue, multiprocessing pool
    and chaos killers, each imported alone in a fresh process, load
    neither JAX nor the reference package nor torch (so not
    ``torch.cuda``): they reach the runtime only inside their
    functions."""
    env = dict(os.environ, PYTHONPATH=REPO)
    for name in ("actor_pool", "queue", "multiprocessing", "chaos"):
        probe = (f"import sys, ray_tpu_torch.util.{name}\n"
                 "print(sorted(n for n in sys.modules if n.split('.')[0] "
                 "in ('jax', 'jaxlib', 'ml_dtypes', 'ray_tpu', 'torch')))")
        out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "[]", (name, out.stdout)


def test_trainer_workers_load_no_jax_and_no_ray_tpu(tmp_path):
    """A TorchTrainer's worker (a gloo gang of two, and a worker holding
    a fake GPU lease) and its result bus run with neither JAX nor the
    reference package in sys.modules, though the driver here has both."""
    import jax  # noqa: F401 — loaded in the driver on purpose
    import ray_tpu  # noqa: F401
    import ray_tpu_torch
    from ray_tpu_torch import train
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, num_gpus=1,
                       object_store_memory=64 * 1024 * 1024)
    try:
        def loop(config=None):
            import sys as _sys
            import torch.distributed as dist
            train.report({
                "visible": os.environ["CUDA_VISIBLE_DEVICES"],
                "group": dist.is_initialized(),
                "banned": sorted(
                    n for n in _sys.modules
                    if any(n == p or n.startswith(p + ".")
                           for p in ("jax", "jaxlib", "ml_dtypes",
                                     "ray_tpu")))})

        for workers, gpus, want in ((2, 0, ""), (1, 1, "0")):
            r = train.TorchTrainer(
                loop, scaling_config=train.ScalingConfig(
                    num_workers=workers, gpus_per_worker=gpus),
                run_config=train.RunConfig(
                    name=f"contract{workers}",
                    storage_path=str(tmp_path))).fit()
            assert r.metrics == {"visible": want, "group": workers > 1,
                                 "banned": []}
    finally:
        ray_tpu_torch.shutdown()


def test_serve_workers_load_no_jax_and_no_ray_tpu():
    """The Serve controller, a replica, the HTTP proxy and the gRPC
    proxy of the port's cluster Serve each run in a worker with neither
    JAX nor the reference package in sys.modules, though the driver
    here has both."""
    import jax  # noqa: F401 — loaded in the driver on purpose
    import ray_tpu  # noqa: F401
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.api import CONTROLLER_NAME
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, object_store_memory=64 * 1024 * 1024)
    try:
        @serve.deployment
        def echo(x=None):
            return x

        import socket
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        assert serve.run(echo.bind(), name="contract",
                         http_port=port).remote(3).result(
            timeout_s=60) == 3
        grpc_proxy, _gport = serve.start_grpc_proxy()
        ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        _v, replicas = ray_tpu_torch.get(
            ctrl.get_replicas.remote("contract", "echo"), timeout=60)
        proxies = [p["actor"] for p in ray_tpu_torch.get(
            ctrl.get_proxies.remote(), timeout=60)]
        assert len(replicas) == 1 and len(proxies) == 1

        def loaded(_inst):
            import os as _os
            import sys as _sys
            return _os.getpid(), sorted(
                n for n in _sys.modules
                if any(n == p or n.startswith(p + ".")
                       for p in ("jax", "jaxlib", "ml_dtypes", "ray_tpu")))

        seen = [ray_tpu_torch.get(a._exec(loaded), timeout=60)
                for a in [ctrl, *replicas, *proxies, grpc_proxy]]
        assert len({pid for pid, _ in seen}) == 4
        assert all(mods == [] for _, mods in seen), seen
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


def test_compiled_dag_loop_workers_load_no_jax_and_no_ray_tpu():
    """The loop of a compiled DAG reaches its actor's worker by reference
    (``ray_tpu_torch.dag.compiled._dag_actor_loop_sealed``): that worker
    then runs the loop with neither JAX nor the reference package in
    sys.modules, though the driver here has both."""
    import jax  # noqa: F401 — loaded in the driver on purpose
    import ray_tpu  # noqa: F401
    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=1, object_store_memory=64 * 1024 * 1024)
    try:
        @ray_tpu_torch.remote
        class Stage:
            def loaded(self, x):
                import sys as _sys
                return x, sorted(
                    n for n in _sys.modules
                    if any(n == p or n.startswith(p + ".")
                           for p in ("jax", "jaxlib", "ml_dtypes",
                                     "ray_tpu"))), \
                    "ray_tpu_torch.dag.compiled" in _sys.modules

        s = Stage.remote()
        with InputNode() as inp:
            out = s.loaded.bind(inp)
        cdag = out.experimental_compile(max_inflight=2)
        try:
            assert cdag.execute(3).get(timeout_s=60) == (3, [], True)
        finally:
            cdag.teardown()
    finally:
        ray_tpu_torch.shutdown()


def test_node_agent_and_its_workers_load_no_jax_no_ray_tpu_no_cuda():
    """A node agent process (started as a second host would start it)
    maps neither torch nor CUDA nor jaxlib, though its own-store worker
    ran a task that holds a fake GPU; that worker has neither JAX nor the
    reference package in sys.modules."""
    import jax  # noqa: F401 — loaded in the driver on purpose
    import ray_tpu  # noqa: F401
    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import node_agent
    from ray_tpu_torch.util.scheduling_strategies import \
        NodeAffinitySchedulingStrategy
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=1, object_store_memory=64 * 1024 * 1024)
    try:
        with node_agent("contract", num_gpus=1, own_store=True,
                        store_capacity=64 << 20) as agent:
            def loaded():
                import sys as _sys
                return os.environ["CUDA_VISIBLE_DEVICES"], sorted(
                    n for n in _sys.modules
                    if any(n == p or n.startswith(p + ".")
                           for p in ("jax", "jaxlib", "ml_dtypes",
                                     "ray_tpu")))

            task = ray_tpu_torch.remote(num_gpus=1)(loaded)
            strat = NodeAffinitySchedulingStrategy(node_id=agent.node_id,
                                                   soft=False)
            assert ray_tpu_torch.get(task.options(
                scheduling_strategy=strat).remote(), timeout=60) == ("0", [])
            with open(f"/proc/{agent.proc.pid}/maps") as f:
                maps = f.read()
            for lib in ("libtorch", "libcuda", "libcudart", "jaxlib",
                        "xla_extension"):
                assert lib not in maps, lib
    finally:
        ray_tpu_torch.shutdown()


def test_banned_name_check_is_exact():
    assert _banned("ray_tpu") and _banned("ray_tpu.llm") and _banned("jax")
    assert not _banned("ray_tpu_torch") and not _banned("ray_tpu_torch.llm")
    assert not _banned("jaxtyping")


def _imported_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_and_chip_smoke_import_no_jax_or_ray_tpu():
    """Every import statement, including the ones inside functions."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "ray_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        bad = [n for n in _imported_names(path) if _banned(n)]
        assert not bad, (path, bad)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA: non-zero exit and no result line, both from the repository
    root and from a directory that holds chip_smoke.py alone."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: chip_smoke runs there")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, str(alone))):
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_default_device_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the defaults run there")
    from ray_tpu_torch.llm import (EngineConfig, InferenceEngine,
                                   LLMConfig, LLMPredictor, LLMServer,
                                   PagedEngineConfig, PagedInferenceEngine)
    from ray_tpu_torch.models import llama
    cfg = llama.llama_tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama.init(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama.init_paged_cache(cfg, 4, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama.init_slot_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedInferenceEngine(PagedEngineConfig(model=cfg))
    params = llama.init(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedInferenceEngine(PagedEngineConfig(model=cfg), params=params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(EngineConfig(model=cfg), params=params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LLMPredictor(EngineConfig(model=cfg))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LLMServer(LLMConfig(engine=PagedEngineConfig(model=cfg)),
                  params_ref=params)
    # device="cpu" runs the plain versions
    InferenceEngine(EngineConfig(model=cfg), params=params, device="cpu")
    LLMPredictor(EngineConfig(model=cfg), device="cpu")
