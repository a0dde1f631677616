"""The port's Train library on the port's runtime, against the reference.

1. The Llama train step under a 2-worker gloo ``TorchTrainer`` gang
   (each worker half the batch, gradients averaged with all_reduce, 3
   AdamW steps) against ``ray_tpu.models.llama`` + optax on the whole
   batch in this process, on the reference's weights converted by
   ``params_from_numpy`` (tolerances as in ``test_torch_llama_train.py``,
   whose docstring says why).
2. Crash and resume: a 1-worker run that crashes after its step-1
   checkpoint and resumes equals an uninterrupted run bit for bit.
3. The orchestration against the reference's: one loop of plain numbers
   under both packages' ``DataParallelTrainer`` (2 workers), one runtime
   after the other — metrics, history, checkpoint metadata and state, a
   restart from the latest checkpoint, and the TrainingFailedError once
   retries are exhausted (``tests/test_train.py:20``, ``:53``, ``:87``).
4. Copies of ``test_elastic_gang_downsizes`` and
   ``test_torch_trainer_gloo_gang`` (``tests/test_train.py:172``, ``:196``)
   and of ``tests/test_train_elastic.py``'s
   ``test_joining_node_grows_gang_without_failure`` (through the port's
   node agents), each ``slow`` as in the reference.
5. The choices that differ from the reference: ``gpus_per_worker`` whole
   devices, no ``jax_distributed``, nccl for GPU gangs (no fall-back to
   gloo).
6. Copies of ``test_trainer_dataset_shards`` and
   ``test_trainer_streams_real_dataset_shards`` (``tests/test_train.py:102``,
   ``:278``) on ``TorchTrainer``: a plain list dealt round-robin, and a
   ``ray_tpu_torch.data`` Dataset split by ``streaming_split``.

Left out of the reference's cases: ``test_trainer_jax_distributed_global_
mesh`` (``:119``) needs a JAX global mesh, which the port has no
counterpart of.

Train functions are defined inside the tests, so workers get them by
value and never import this module (nor JAX with it).
"""
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.models import llama as jllama
from ray_tpu_torch import train
from ray_tpu_torch.train import (RunConfig, ScalingConfig, TorchTrainer,
                                 DataParallelTrainer)

SHAPE = dict(vocab_size=64, n_heads=4, n_kv_heads=2, dim=32, n_layers=2,
             mlp_dim=64, max_seq_len=128)


@pytest.fixture
def ray_start_regular():
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=2, object_store_memory=128 * 1024 * 1024)
    yield rt
    rt.shutdown()


@pytest.fixture(scope="module")
def ref():
    cfg = jllama.llama_tiny(**SHAPE)
    params = jllama.init(jax.random.PRNGKey(0), cfg)
    tokens = np.random.RandomState(1).randint(0, 64, (4, 17)).astype(
        np.int32)
    return cfg, params, tokens


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _llama_loop(config):
    """The port's train step as a TorchTrainer loop: this rank's share of
    the batch, gradients (and the loss) averaged over the gang, AdamW;
    a checkpoint of params + optimizer + step after every step from rank
    0; with ``crash_after`` set, rank 0 raises once after that step's
    checkpoint and the restarted worker resumes from it."""
    import os as _os

    import torch as _torch
    import torch.distributed as dist
    from ray_tpu_torch import train as _train
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_numpy

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        return [tree]

    ctx = _train.get_context()
    n, rank = ctx.get_world_size(), ctx.get_world_rank()
    cfg = llama.llama_tiny(**config["shape"])
    params = params_from_numpy(config["params"], cfg, device="cpu")
    for t in leaves(params):
        t.requires_grad_()
    opt = _torch.optim.AdamW(leaves(params), lr=3e-4, weight_decay=0.0)
    start = 0
    ckpt = _train.get_checkpoint()
    if ckpt is not None:
        state = ckpt.load_state()
        with _torch.no_grad():
            for t, s in zip(leaves(params), leaves(state["params"])):
                t.copy_(s)
        opt.load_state_dict(state["opt"])
        start = state["step"] + 1
    tok = _torch.from_numpy(config["tokens"]).long()
    share = tok.shape[0] // n
    mine = tok[rank * share:(rank + 1) * share]
    for step in range(start, config["steps"]):
        opt.zero_grad()
        logits = llama.apply(params, mine[:, :-1], cfg)
        loss = llama.cross_entropy_loss(logits, mine[:, 1:])
        loss.backward()
        loss = loss.detach().clone()
        if n > 1:
            for t in leaves(params):
                dist.all_reduce(t.grad)
                t.grad /= n
            dist.all_reduce(loss)
            loss /= n
        opt.step()
        ck = None
        if rank == 0:
            ck = _train.Checkpoint.from_state(
                {"params": params, "opt": opt.state_dict(), "step": step})
        _train.report({"step": step, "loss": float(loss)}, checkpoint=ck)
        if (rank == 0 and step == config.get("crash_after")
                and not _os.path.exists(config["marker"])):
            open(config["marker"], "w").close()
            raise RuntimeError("planned crash")


def _loop_config(ref, **kw):
    _, params_j, tokens = ref
    return {"shape": SHAPE, "tokens": tokens,
            "params": jax.tree.map(np.asarray, params_j), **kw}


def test_llama_train_step_in_a_gloo_gang_matches_reference(
        ray_start_regular, ref, tmp_path):
    cfg_j, params_j, tokens = ref
    opt = optax.adamw(3e-4, weight_decay=0.0)

    def loss_fn(p):
        logits = jllama.apply(p, jnp.asarray(tokens[:, :-1]), cfg_j)
        return jllama.cross_entropy_loss(logits, jnp.asarray(tokens[:, 1:]))

    p_j, state = params_j, opt.init(params_j)
    want = []
    for _ in range(3):
        loss, g = jax.value_and_grad(loss_fn)(p_j)
        updates, state = opt.update(g, state, p_j)
        p_j = optax.apply_updates(p_j, updates)
        want.append(float(loss))

    result = TorchTrainer(
        _llama_loop, train_loop_config=_loop_config(ref, steps=3),
        scaling_config=ScalingConfig(num_workers=2, cpus_per_worker=1),
        run_config=RunConfig(name="llama", storage_path=str(tmp_path))).fit()
    got = [m["loss"] for m in result.metrics_history]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got[-1] < got[0]
    final = _named(jax.tree.map(np.asarray, p_j))
    params = _named(result.checkpoint.load_state()["params"])
    assert set(params) == set(final)
    for name, t in params.items():
        np.testing.assert_allclose(t.numpy(), final[name], atol=1e-4,
                                   rtol=0, err_msg=name)


def test_crash_and_resume_equals_an_uninterrupted_run(ray_start_regular, ref,
                                                      tmp_path):
    runs = {}
    for name, kw in (("whole", {}),
                     ("crashed", {"crash_after": 1,
                                  "marker": str(tmp_path / "crashed")})):
        runs[name] = TorchTrainer(
            _llama_loop, train_loop_config=_loop_config(ref, steps=4, **kw),
            scaling_config=ScalingConfig(num_workers=1, cpus_per_worker=1),
            run_config=RunConfig(
                name=name, storage_path=str(tmp_path),
                failure_config=train.FailureConfig(max_failures=1))).fit()
    assert os.path.exists(tmp_path / "crashed")
    whole, crashed = runs["whole"], runs["crashed"]
    assert [m["step"] for m in crashed.metrics_history] == [0, 1, 2, 3]
    assert crashed.metrics_history == whole.metrics_history
    a = crashed.checkpoint.load_state()
    b = whole.checkpoint.load_state()
    assert a["step"] == b["step"] == 3
    for x, y in zip(_named(a["params"]).values(),
                    _named(b["params"]).values()):
        assert torch.equal(x, y)
    for x, y in zip(a["opt"]["state"].values(), b["opt"]["state"].values()):
        assert all(torch.equal(x[k], y[k]) for k in x)


def _plain_loop(train_mod):
    """One train loop of plain numbers for either package's Train."""
    def loop(config):
        import os as _os
        ctx = train_mod.get_context()
        ckpt = train_mod.get_checkpoint()
        state = ckpt.load_state() if ckpt is not None else {"w": 0.0,
                                                            "step": -1}
        w = float(state["w"])
        start = int(state["step"]) + 1
        for step in range(start, config["steps"]):
            if config.get("broken"):
                raise ValueError("always broken")
            if (ctx.get_world_rank() == 0 and step == config.get("crash_at")
                    and not _os.path.exists(config["marker"])):
                open(config["marker"], "w").close()
                raise RuntimeError("boom")
            w = w + 1.5
            c = None
            if ctx.get_world_rank() == 0:
                c = train_mod.Checkpoint.from_state(
                    {"w": w, "step": step},
                    metadata={"step": step, "w": w})
            train_mod.report({"step": step, "w": w,
                              "world": ctx.get_world_size(),
                              "resumed": start > 0}, checkpoint=c)
    return loop


def _orchestrate(pkg, train_mod, tmp_path) -> dict:
    """The three runs of the comparison under one package's trainer."""
    def fit(name, config, **run_kw):
        return train_mod.DataParallelTrainer(
            _plain_loop(train_mod), train_loop_config=config,
            scaling_config=train_mod.ScalingConfig(num_workers=2,
                                                   cpus_per_worker=1),
            run_config=train_mod.RunConfig(
                name=name, storage_path=str(tmp_path / pkg),
                **run_kw)).fit()

    out = {}
    r = fit("reports", {"steps": 3})
    out["reports"] = (r.error, r.metrics, r.metrics_history,
                      r.checkpoint.metadata(), r.checkpoint.load_state(),
                      os.path.basename(r.checkpoint.path),
                      os.path.basename(r.best_checkpoint.path))
    r = fit("restart", {"steps": 4, "crash_at": 2,
                        "marker": str(tmp_path / f"{pkg}-crashed")},
            failure_config=train_mod.FailureConfig(max_failures=2))
    out["restart"] = (r.error, r.metrics, r.metrics_history,
                      r.checkpoint.load_state(),
                      sorted(os.listdir(tmp_path / pkg / "restart" /
                                        "checkpoints")))
    with pytest.raises(train_mod.TrainingFailedError) as e:
        fit("broken", {"steps": 2, "broken": True})
    out["failed"] = (str(e.value), "always broken" in str(e.value.__cause__))
    return out


def test_orchestration_matches_the_reference_trainer(tmp_path):
    import ray_tpu
    from ray_tpu import train as ref_train
    got = {}
    for pkg, runtime, train_mod in (("ref", ray_tpu, ref_train),
                                    ("port", rt, train)):
        if runtime.is_initialized():
            runtime.shutdown()
        runtime.init(num_cpus=2, object_store_memory=128 * 1024 * 1024)
        try:
            got[pkg] = _orchestrate(pkg, train_mod, tmp_path)
        finally:
            runtime.shutdown()
    assert got["port"] == got["ref"]
    assert got["port"]["reports"][1] == {"step": 2, "w": 4.5, "world": 2,
                                         "resumed": False}
    assert got["port"]["restart"][2][-1]["resumed"] is True
    assert got["port"]["failed"] == (
        "training failed after exhausting 0 retries", True)


# -- copies of the reference's gang cases (slow there, slow here) ----------

@pytest.mark.slow
def test_elastic_gang_downsizes(ray_start_regular):
    """ScalingConfig(min_workers=) sizes the gang to what the cluster can
    actually reserve (reference: v2 elastic scaling policy)."""
    def loop(config=None):
        ctx = train.get_context()
        train.report({"world": ctx.world_size, "rank": ctx.rank})

    avail = int(ray_start_regular.cluster_resources().get("CPU", 1))
    want = avail + 4  # infeasible at full size
    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=want, min_workers=1,
                                     cpus_per_worker=1.0,
                                     elastic_timeout_s=2.0),
        run_config=RunConfig(name="elastic-test"))
    result = trainer.fit()
    world = result.metrics["world"]
    assert 1 <= world <= avail, (world, avail)
    assert world < want


@pytest.mark.slow
def test_torch_trainer_gloo_gang(ray_start_regular):
    """TorchTrainer forms a gloo process group across the gang
    (reference: train/torch/config.py dist.init_process_group)."""
    def loop(config=None):
        import torch
        import torch.distributed as dist
        ctx = train.get_context()
        t = torch.tensor([float(ctx.rank + 1)])
        dist.all_reduce(t)             # 1 + 2 = 3 across the gang
        # a real DDP step proves gradient sync works end to end
        model = torch.nn.Linear(4, 1)
        ddp = torch.nn.parallel.DistributedDataParallel(model)
        x = torch.ones(2, 4) * (ctx.rank + 1)
        loss = ddp(x).sum()
        loss.backward()
        g = model.weight.grad.clone()
        train.report({"allreduce": float(t.item()),
                      "grad0": float(g[0, 0].item()),
                      "world": ctx.world_size,
                      "backend": dist.get_backend()})

    result = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2, cpus_per_worker=1.0),
        run_config=RunConfig(name="torch-gang")).fit()
    assert result.metrics["allreduce"] == 3.0
    assert result.metrics["world"] == 2
    assert result.metrics["backend"] == "gloo"
    # DDP averages grads: rank0 sees (2*1 + 2*2)/2 = 3
    assert abs(result.metrics["grad0"] - 3.0) < 1e-5


@pytest.mark.slow
def test_joining_node_grows_gang_without_failure(tmp_path):
    """A 2-worker-max gang starts at width 1 (a one-CPU head); when a
    node agent joins mid-run the controller checkpoints and restarts at
    width 2 — no worker failure involved (reference:
    tests/test_train_elastic.py)."""
    from ray_tpu_torch.cluster_utils import node_agent
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=1)   # holds exactly ONE 1-CPU train worker

    def _loop(config=None):
        import time as _t
        ctx = train.get_context()
        ckpt = train.get_checkpoint()
        start = ckpt.load_state()["step"] + 1 if ckpt else 0
        for step in range(start, 24):
            c = train.Checkpoint.from_state({"step": step})
            train.report({"step": step, "world": ctx.world_size},
                         checkpoint=c)
            _t.sleep(0.25)

    stop = threading.Event()

    def join_later():
        time.sleep(4.0)
        with node_agent("grow-node", num_cpus=1):
            stop.wait()

    joiner = threading.Thread(target=join_later, daemon=True)
    joiner.start()
    try:
        result = TorchTrainer(
            _loop,
            scaling_config=ScalingConfig(
                num_workers=2, min_workers=1, cpus_per_worker=1.0,
                elastic_timeout_s=2.0, elastic_poll_s=0.5),
            run_config=RunConfig(name="elastic-grow",
                                 storage_path=str(tmp_path))).fit()
        # the run finished at the FULL width and completed every step
        assert result.metrics["world"] == 2, result.metrics
        assert result.metrics["step"] == 23
        worlds = [m["world"] for m in result.metrics_history]
        assert worlds[0] == 1, "should have started shrunken"
        assert worlds[-1] == 2, "should have grown mid-run"
    finally:
        stop.set()
        joiner.join(timeout=60)
        rt.shutdown()


# -- the choices that differ from the reference ------------------------------

@pytest.mark.parametrize("n,ok", [(0, True), (1, True), (2.0, True),
                                  (0.5, False), (-1, False), (True, False)])
def test_gpus_per_worker_is_whole_devices(n, ok):
    if not ok:
        with pytest.raises(ValueError, match="whole number of devices"):
            ScalingConfig(gpus_per_worker=n)
        return
    sc = ScalingConfig(gpus_per_worker=n)
    assert sc.gpus_per_worker == int(n) and type(sc.gpus_per_worker) is int
    assert sc.bundle() == ({"CPU": 1.0, "GPU": int(n)} if n else
                           {"CPU": 1.0})


@pytest.mark.parametrize("name,value", [("jax_distributed", True),
                                        ("jax_distributed", False),
                                        ("local_device_count", 4),
                                        ("tpus_per_worker", 1.0)])
def test_scaling_config_refuses_the_reference_jax_fields(name, value):
    with pytest.raises(ValueError, match=name):
        ScalingConfig(num_workers=2, **{name: value})


@pytest.mark.parametrize("gpus,world,backend", [(1, 2, "nccl"),
                                                (2, 4, "nccl"),
                                                (0, 2, "gloo"),
                                                (1, 1, None), (0, 1, None)])
def test_torch_trainer_backend(gpus, world, backend):
    """nccl for a gang of GPU leases, gloo without; a gang of one forms
    no group (checked without forming an nccl group)."""
    t = TorchTrainer(lambda: None, scaling_config=ScalingConfig(
        num_workers=world, gpus_per_worker=gpus))
    env = t._worker_env(0, world)
    assert env.get("RTPU_TORCH_BACKEND") == backend
    assert env.get("RTPU_TORCH_DIST") == ("1" if backend else None)
    assert "RTPU_TORCH_BACKEND" not in DataParallelTrainer(
        lambda: None)._worker_env(0, world)


def test_datasets_and_dataset_shards_wait_for_data():
    """``datasets=`` is kept and split per attempt (a plain iterable
    round-robin), and ``get_dataset_shard`` reads the session's shards:
    outside a worker it raises as ``get_context`` does, and a name the
    trainer was not given raises KeyError."""
    t = TorchTrainer(lambda: None, datasets={"train": [1, 2, 3]})
    assert t._split_datasets(2) == [{"train": [1, 3]}, {"train": [2]}]
    assert TorchTrainer(lambda: None)._split_datasets(2) == [None, None]
    with pytest.raises(RuntimeError, match="not inside a train worker"):
        train.get_dataset_shard("train")
    from ray_tpu_torch.train import session
    session._set_context(session.TrainContext(
        run_name="r", rank=0, world_size=1,
        dataset_shards={"train": [1, 3]}))
    try:
        assert train.get_dataset_shard("train") == [1, 3]
        with pytest.raises(KeyError, match="eval"):
            train.get_dataset_shard("eval")
    finally:
        session._set_context(None)


def test_trainer_dataset_shards(ray_start_regular, tmp_path):
    def train_fn(config=None):
        shard = train.get_dataset_shard("train")
        train.report({"n": len(list(shard))})

    trainer = TorchTrainer(
        train_fn,
        scaling_config=ScalingConfig(num_workers=2, cpus_per_worker=1),
        run_config=RunConfig(name="t4", storage_path=str(tmp_path)),
        datasets={"train": list(range(10))},
    )
    result = trainer.fit()
    assert result.metrics["n"] == 5


def test_trainer_streams_real_dataset_shards(ray_start_regular, tmp_path):
    """datasets={'train': Dataset} flows through streaming_split: each
    worker consumes a disjoint shard; together they cover the data."""
    from ray_tpu_torch import data

    def loop(config=None):
        ctx = train.get_context()
        shard = train.get_dataset_shard("train")
        ids = []
        for batch in shard.iter_batches(batch_size=8,
                                        batch_format="numpy"):
            ids.extend(int(x) for x in batch["id"])
        train.report({"n": len(ids), "sum": sum(ids),
                      "rank": ctx.rank})

    ds = data.range(64, override_num_blocks=8)
    # leave CPU headroom for the data tasks: placement groups RESERVE
    # their resources (reference semantics), so a gang taking every CPU
    # would starve the streaming execution
    result = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2, cpus_per_worker=0.5),
        run_config=RunConfig(name="ds-shards", storage_path=str(tmp_path)),
        datasets={"train": ds}).fit()
    # rank 0's metrics: partial coverage; totals verified via history of
    # both ranks is not exposed — assert rank 0 got a non-empty strict
    # subset and per-worker disjointness via counts summing to 64 when
    # the shard split is balanced
    assert 0 < result.metrics["n"] < 64


def test_gpu_gang_leases_its_device_and_never_falls_back_to_gloo(tmp_path):
    """On fake GPUs (indices only): a one-worker gang leases GPU 0 (the
    runtime shows none free while it runs); a two-worker GPU gang tries
    nccl, which this machine cannot form, and fails — no gloo group."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the nccl gang would form")
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=2, num_gpus=2, object_store_memory=128 * 1024 * 1024)
    try:
        def loop(config=None):
            import os as _os
            import ray_tpu_torch as _rt
            train.report({"visible": _os.environ["CUDA_VISIBLE_DEVICES"],
                          "free": _rt.available_resources().get("GPU")})

        r = TorchTrainer(loop, scaling_config=ScalingConfig(
            num_workers=1, gpus_per_worker=1),
            run_config=RunConfig(name="lease",
                                 storage_path=str(tmp_path))).fit()
        assert r.metrics == {"visible": "0", "free": 1.0}
        with pytest.raises(train.TrainingFailedError) as e:
            TorchTrainer(loop, scaling_config=ScalingConfig(
                num_workers=2, gpus_per_worker=1),
                run_config=RunConfig(name="nccl",
                                     storage_path=str(tmp_path))).fit()
        assert "CUDA" in str(e.value.__cause__) or "cuda" in str(
            e.value.__cause__)
    finally:
        rt.shutdown()
