"""DataParallelTrainer / TorchTrainer: controller + worker-group state machine.

The port's copy of ``ray_tpu/train/trainer.py`` over the port's runtime
(reference parity: train/v2/_internal/execution/controller/controller.py:93
— schedule workers → run → monitor → restart-on-failure —,
worker_group/worker_group.py:105 — a placement-group gang, one actor per
bundle :242,:364 —, failure_handling/failure_policy.py).

* Failure granularity is the whole gang: any worker failure tears down
  and restarts the full group from the latest checkpoint, per
  FailureConfig.
* ``TorchTrainer`` takes the place of the reference's ``JaxTrainer`` (a
  JAX global mesh per gang): its gang forms one ``torch.distributed``
  process group before the train fn runs — ``nccl`` when each worker
  leases GPUs (``ScalingConfig(gpus_per_worker >= 1)``), ``gloo``
  otherwise, and none for a gang of one. An nccl group that fails to
  form fails the worker; nothing falls back to gloo. The reference's
  ``JaxTrainer`` and its ``jax.distributed`` bootstrap are not ported.
* A worker that leases GPUs sees their indices in
  ``CUDA_VISIBLE_DEVICES`` (the runtime's lease, held by its bundle of
  the gang's placement group).
* ``datasets=`` takes ``ray_tpu_torch.data`` Datasets (split across the
  gang by ``streaming_split``, again for each attempt) or plain iterables
  (dealt round-robin); a worker reads its piece with
  ``get_dataset_shard``.
"""
from __future__ import annotations

import os
import time
import uuid
from typing import Any, Callable, Optional

from .checkpoint import Checkpoint, CheckpointManager
from .config import RunConfig, ScalingConfig
from . import session as session_mod


class TrainingFailedError(RuntimeError):
    """Raised by fit() when training fails beyond FailureConfig limits
    (reference: train/base_trainer.py TrainingFailedError)."""


class Result:
    """(reference: air/result.py) Final metrics + checkpoint handles."""

    def __init__(self, metrics: dict, checkpoint: Optional[Checkpoint],
                 best_checkpoint: Optional[Checkpoint], path: str,
                 error: Optional[BaseException], metrics_history: list[dict]):
        self.metrics = metrics
        self.checkpoint = checkpoint
        self.best_checkpoint = best_checkpoint
        self.path = path
        self.error = error
        self.metrics_history = metrics_history

    def __repr__(self):
        return (f"Result(metrics={self.metrics}, "
                f"checkpoint={self.checkpoint}, error={self.error!r})")


class _ResultBus:
    """Async rendezvous actor carrying report() traffic worker→controller
    (reference analog: the report queue + sync actor of
    train/v2/_internal/execution/checkpoint/sync_actor.py).

    Two report modes: fire-and-forget `push` (Train workers) and
    decision-synchronous `push_wait` (Tune trials — the reporter parks until
    the controller answers CONTINUE/STOP, making scheduler decisions
    deterministic regardless of trial speed)."""

    def __init__(self):
        import asyncio
        self._asyncio = asyncio
        self._events: list[tuple] = []
        self._decisions: dict[tuple, str] = {}
        self._waiters: dict[tuple, object] = {}
        self._kv: dict[str, object] = {}

    # tiny KV rendezvous (GCS-KV analog, reference gcs_kv_manager.h): rank 0
    # publishes the torch.distributed coordinator address under the group's
    # generation key; peers poll until it lands
    async def set_kv(self, key: str, value):
        self._kv[key] = value

    async def get_kv(self, key: str):
        return self._kv.get(key)

    async def push(self, rank: int, seq: int, metrics: dict,
                   ckpt_path: Optional[str]):
        self._events.append((rank, seq, metrics, ckpt_path))

    async def push_wait(self, rank: int, seq: int, metrics: dict,
                        ckpt_path: Optional[str]) -> str:
        key = (rank, seq)
        ev = self._asyncio.Event()
        self._waiters[key] = ev
        self._events.append((rank, seq, metrics, ckpt_path))
        await ev.wait()
        return self._decisions.pop(key, "CONTINUE")

    async def decide(self, rank: int, seq: int, decision: str):
        key = (rank, seq)
        self._decisions[key] = decision
        ev = self._waiters.pop(key, None)
        if ev is not None:
            ev.set()

    async def drain(self) -> list[tuple]:
        out, self._events = self._events, []
        return out


class _TrainWorker:
    """One gang member; hosts the user's train_fn (reference:
    worker_group/worker.py RayTrainWorker)."""

    def __init__(self, run_name: str, rank: int, world_size: int,
                 bus, env: dict):
        self._ctx_args = (run_name, rank, world_size)
        self._bus = bus
        for k, v in env.items():
            os.environ[k] = v

    def run(self, fn_and_cfg: bytes, restore_path: Optional[str],
            shards: Optional[dict]) -> str:
        import cloudpickle
        train_fn, train_cfg = cloudpickle.loads(fn_and_cfg)
        run_name, rank, world = self._ctx_args
        tdist = self._init_torch_distributed(rank, world)
        ctx = session_mod.TrainContext(
            run_name=run_name, rank=rank, world_size=world,
            restored_checkpoint=(Checkpoint(restore_path)
                                 if restore_path else None),
            dataset_shards=shards, _bus=self._bus)
        session_mod._set_context(ctx)
        try:
            if isinstance(train_cfg, str) and train_cfg == _NO_CONFIG:
                train_fn()
            else:
                train_fn(train_cfg)
        finally:
            session_mod._set_context(None)
            if tdist:
                try:
                    import torch.distributed as td
                    td.destroy_process_group()
                except Exception:
                    pass  # backend may never have initialized
        return "done"

    def _rendezvous_coord(self, rank: int) -> str:
        """Gen-keyed coordinator rendezvous over the result bus: rank 0
        binds a port on ITS host and publishes; peers poll. The
        generation key isolates a restarted gang from a dead
        predecessor's address."""
        from ..core import api as ray

        key = f"tcoord:{os.environ.get('RTPU_TRAIN_GEN', '0')}"
        if rank == 0:
            from ..core.runtime import host_ip
            coord = f"{host_ip()}:{_free_port()}"
            ray.get(self._bus.set_kv.remote(key, coord))
            return coord
        deadline = time.monotonic() + 60
        while True:
            coord = ray.get(self._bus.get_kv.remote(key))
            if coord:
                return coord
            if time.monotonic() > deadline:
                raise TrainingFailedError(
                    "rank 0 never published the torch.distributed "
                    "coordinator address")
            time.sleep(0.05)

    def _init_torch_distributed(self, rank: int, world: int) -> bool:
        """The gang's torch.distributed process group (the reference
        TorchTrainer's backend setup, train/torch/config.py:115 —
        dist.init_process_group over a rendezvous rank 0 publishes):
        ``RTPU_TORCH_BACKEND`` names it, nccl on each worker's first
        leased GPU or gloo."""
        if os.environ.get("RTPU_TORCH_DIST") != "1" or world <= 1:
            return False
        backend = os.environ["RTPU_TORCH_BACKEND"]
        coord = self._rendezvous_coord(rank)
        import torch
        import torch.distributed as td
        if backend == "nccl":
            torch.cuda.set_device(0)
        td.init_process_group(backend, init_method=f"tcp://{coord}",
                              rank=rank, world_size=world)
        return True


# String sentinel: must survive a cloudpickle round-trip to the worker
# (an `object()` sentinel would lose identity and break the `is` check).
_NO_CONFIG = "__rtpu_no_config__"


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _fits(demand: dict, capacity: dict) -> bool:
    """A bundle fits a node's free resources (the port's copy of the
    reference's ``autoscaler._fits``; the autoscaler is not ported)."""
    return all(capacity.get(k, 0.0) >= v - 1e-9 for k, v in demand.items())


class DataParallelTrainer:
    """Gang-schedules `train_loop_per_worker` over a placement group and
    supervises it (reference: v2/api/data_parallel_trainer.py:55, fit
    :103).

    With `datasets=`, leave CPU headroom outside the gang: placement
    groups RESERVE their resources, and the streaming data tasks run
    outside the PG (reference guidance is identical — data-loading CPUs
    are provisioned beside the training gang).
    """

    def __init__(self,
                 train_loop_per_worker: Callable,
                 *,
                 train_loop_config: Any = _NO_CONFIG,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[dict] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        self.train_fn = train_loop_per_worker
        self.train_cfg = train_loop_config
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.resume_from = resume_from_checkpoint
        self._start_count = 0

    # -- worker-group lifecycle -------------------------------------------

    def _reserve_gang(self, n_max: int):
        """Reserve the largest gang the cluster can hold right now
        (elastic path; fixed configs insist on num_workers)."""
        from ..util.placement_group import (placement_group,
                                            remove_placement_group)
        sc = self.scaling
        n_min = sc.min_workers if sc.min_workers is not None else n_max
        timeout = 120.0 if n_min == n_max else sc.elastic_timeout_s
        for n in range(n_max, n_min - 1, -1):
            pg = placement_group([sc.bundle() for _ in range(n)],
                                 strategy=sc.placement_strategy)
            if pg.wait(timeout):
                return n, pg
            try:
                remove_placement_group(pg)
            except Exception:
                pass  # PG already gone with the failed attempt
        raise TrainingFailedError(
            f"no gang of {n_min}..{n_max} × {sc.bundle()} workers became "
            f"ready (cluster too small?)")

    def _gang_can_grow(self, ray, current_n: int) -> bool:
        """True when the cluster's FREE resources could host at least one
        more worker bundle (reference: Train v2 consults ScalingPolicy
        every control-loop tick, controller.py:446). The actual larger
        reservation is re-validated by _reserve_gang on restart."""
        if current_n >= self.scaling.num_workers:
            return False
        bundle = self.scaling.bundle()
        return any(_fits(bundle, dict(row["Available"]))
                   for row in ray.nodes() if row["Alive"])

    def _start_group(self, ray, run_name, bus, restore: Optional[Checkpoint]):
        import cloudpickle
        n, pg = self._reserve_gang(self.scaling.num_workers)
        WorkerCls = ray.remote(_TrainWorker)
        shards = self._split_datasets(n)
        workers, run_refs = [], []
        blob = cloudpickle.dumps((self.train_fn, self.train_cfg))
        self._start_count += 1
        for rank in range(n):
            env = self._worker_env(rank, n)
            w = WorkerCls.options(
                num_cpus=self.scaling.cpus_per_worker,
                num_gpus=self.scaling.gpus_per_worker,
                resources=self.scaling.resources_per_worker,
                placement_group=pg,
                placement_group_bundle_index=rank,
            ).remote(run_name, rank, n, bus, env)
            workers.append(w)
        for rank, w in enumerate(workers):
            run_refs.append(w.run.remote(
                blob, restore.path if restore else None, shards[rank]))
        return pg, workers, run_refs

    def _worker_env(self, rank: int, world: int) -> dict:
        """The gang's env (reference: train/torch/config.py:153)."""
        return {
            "RTPU_TRAIN_RANK": str(rank),
            "RTPU_TRAIN_WORLD": str(world),
        }

    def _split_datasets(self, n: int) -> list[Optional[dict]]:
        """Round-robin shard plain iterables; Dataset objects use
        streaming_split (reference: dataset.py:1731)."""
        shards: list[Optional[dict]] = [None] * n
        if not self.datasets:
            return shards
        per_worker: list[dict] = [{} for _ in range(n)]
        for name, ds in self.datasets.items():
            if hasattr(ds, "streaming_split"):
                for rank, piece in enumerate(ds.streaming_split(n)):
                    per_worker[rank][name] = piece
            else:
                items = list(ds)
                for rank in range(n):
                    per_worker[rank][name] = items[rank::n]
        return per_worker

    # -- fit ---------------------------------------------------------------

    def fit(self) -> Result:
        from ..core import api as ray
        from ..core.usage import record_library_usage
        record_library_usage("train")
        run_name = self.run_config.name or f"train_{uuid.uuid4().hex[:8]}"
        storage = os.path.join(self.run_config.resolved_storage_path(),
                               run_name)
        ckpt_cfg = self.run_config.checkpoint_config
        manager = CheckpointManager(
            os.path.join(storage, "checkpoints"),
            num_to_keep=ckpt_cfg.num_to_keep,
            score_attribute=ckpt_cfg.checkpoint_score_attribute,
            score_order=ckpt_cfg.checkpoint_score_order)

        BusCls = ray.remote(_ResultBus)
        bus = BusCls.options(max_concurrency=64).remote()

        failures_left = self.run_config.failure_config.max_failures
        restore = self.resume_from
        metrics_history: list[dict] = []
        last_metrics: dict = {}
        # dedup multi-rank checkpoints per report step; generation
        # disambiguates restarts (worker seq counters reset)
        seen_ckpt_seqs: set[tuple] = set()
        generation = 0
        error: Optional[BaseException] = None

        pg, workers, run_refs = self._start_group(ray, run_name, bus, restore)
        elastic = self.scaling.min_workers is not None
        next_grow_check = time.monotonic() + self.scaling.elastic_poll_s

        def drain_reports():
            nonlocal last_metrics
            for rank, seq, metrics, ckpt_path in ray.get(
                    bus.drain.remote()):
                key = (generation, seq)
                if ckpt_path and key not in seen_ckpt_seqs:
                    seen_ckpt_seqs.add(key)
                    manager.register(Checkpoint(ckpt_path), metrics)
                if rank == 0:
                    metrics_history.append(metrics)
                    last_metrics = metrics

        try:
            while True:
                done, pending = ray.wait(run_refs, num_returns=len(run_refs),
                                         timeout=0.25)
                drain_reports()
                # mid-run elastic GROWTH: a shrunken gang widens as soon as
                # capacity appears (node joined) — checkpoint, restart at
                # the larger world size (reference Train v2: ScalingPolicy
                # per control-loop iteration, controller.py:446). Only
                # while workers are still running: a finished run's results
                # must never be discarded for a restart.
                if elastic and pending \
                        and len(workers) < self.scaling.num_workers \
                        and time.monotonic() >= next_grow_check:
                    next_grow_check = (time.monotonic()
                                       + self.scaling.elastic_poll_s)
                    if self._gang_can_grow(ray, len(workers)):
                        prev_n = len(workers)
                        # teardown FIRST, then drain: reports posted after
                        # the loop-top drain still belong to the OLD
                        # generation's key space
                        self._teardown(ray, workers, pg)
                        drain_reports()
                        generation += 1
                        restore = manager.latest or restore
                        try:
                            pg, workers, run_refs = self._start_group(
                                ray, run_name, bus, restore)
                        except TrainingFailedError as e:
                            # the freed resources were snatched between
                            # teardown and re-reservation: growing must
                            # not kill a healthy run outright — spend the
                            # failure budget like any other restart
                            if failures_left == 0:
                                error = e
                                workers, pg, run_refs = [], None, []
                                break
                            failures_left -= 1
                            pg, workers, run_refs = self._start_group(
                                ray, run_name, bus, restore)
                        if len(workers) <= prev_n:
                            # capacity was transient or constraint-bound:
                            # damp the next attempt so we don't thrash
                            next_grow_check = (
                                time.monotonic()
                                + 10 * self.scaling.elastic_poll_s)
                        continue
                try:
                    ray.get(done)  # surfaces any worker failure immediately
                except BaseException as e:  # noqa: BLE001
                    if failures_left == 0:
                        error = e
                        break
                    failures_left -= 1
                    self._teardown(ray, workers, pg)
                    drain_reports()   # residual old-generation reports
                    generation += 1
                    restore = manager.latest or restore
                    pg, workers, run_refs = self._start_group(
                        ray, run_name, bus, restore)
                    continue
                if not pending:
                    break  # all workers finished cleanly
        finally:
            self._teardown(ray, workers, pg)
            try:
                ray.kill(bus)
            except Exception:
                pass  # already dead

        if error is not None:
            raise TrainingFailedError(
                f"training failed after exhausting "
                f"{self.run_config.failure_config.max_failures} retries"
            ) from error
        return Result(last_metrics, manager.latest, manager.best, storage,
                      None, metrics_history)

    def _teardown(self, ray, workers, pg):
        from ..util.placement_group import remove_placement_group
        for w in workers:
            try:
                ray.kill(w)
            except Exception:
                pass  # already dead
        try:
            remove_placement_group(pg)
        except Exception:
            pass  # already removed


class TorchTrainer(DataParallelTrainer):
    """Torch data-parallel trainer (reference: TorchTrainer,
    train/torch/torch_trainer.py), in the place of the reference's
    JaxTrainer: a gang of more than one worker forms one
    torch.distributed process group before the train fn runs (nccl with
    GPU leases, gloo without) — use DDP / all_reduce inside as usual."""

    def _worker_env(self, rank: int, world: int) -> dict:
        env = super()._worker_env(rank, world)
        if world > 1:
            env["RTPU_TORCH_DIST"] = "1"
            env["RTPU_TORCH_BACKEND"] = (
                "nccl" if self.scaling.gpus_per_worker >= 1 else "gloo")
            env["RTPU_TRAIN_GEN"] = str(self._start_count)
        return env
