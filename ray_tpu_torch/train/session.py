"""Per-worker training session: report/get_checkpoint/get_context.

The port's copy of ``ray_tpu/train/session.py`` (reference parity:
python/ray/train/v2/api/train_fn_utils.py — report :13, get_checkpoint
:105, get_dataset_shard :150 — and the session protocol of
train/_internal/session.py:405). The session is thread-local state
installed by the TrainWorker actor before invoking the user's train
function; report() ships metrics (and optionally a checkpoint directory)
to the controller through the run's result-bus actor.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional

from .checkpoint import Checkpoint


@dataclasses.dataclass
class TrainContext:
    run_name: str
    rank: int
    world_size: int
    node_rank: int = 0
    local_rank: int = 0
    restored_checkpoint: Optional[Checkpoint] = None
    dataset_shards: Optional[dict] = None
    _bus: Any = None
    _seq: int = 0
    # Tune trials report decision-synchronously: report() parks until the
    # controller answers, and a STOP answer raises StopTrial
    sync_decisions: bool = False

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_experiment_name(self) -> str:
        return self.run_name


_local = threading.local()


def _set_context(ctx: Optional[TrainContext]):
    _local.ctx = ctx


def get_context() -> TrainContext:
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        raise RuntimeError(
            "not inside a train worker: train.get_context()/report() are "
            "only valid inside the train_fn launched by a Trainer")
    return ctx


class StopTrial(BaseException):
    """Scheduler-initiated graceful trial stop (reference analog: the
    StopIteration path of tune function trainables). BaseException so user
    `except Exception` blocks don't swallow it."""


def report(metrics: dict, checkpoint: Optional[Checkpoint] = None) -> None:
    """Stream metrics (and optionally a checkpoint) to the controller
    (reference: train_fn_utils.py:13). Every rank should call report with
    the same cadence; checkpoints are persisted from rank 0 (others' are
    accepted but deduplicated by sequence number)."""
    from ..core import api
    ctx = get_context()
    ctx._seq += 1
    ckpt_path = checkpoint.path if checkpoint is not None else None
    if ctx.sync_decisions:
        decision = api.get(ctx._bus.push_wait.remote(
            ctx.rank, ctx._seq, dict(metrics), ckpt_path))
        if decision == "STOP":
            raise StopTrial()
    else:
        api.get(ctx._bus.push.remote(
            ctx.rank, ctx._seq, dict(metrics), ckpt_path))


def get_checkpoint() -> Optional[Checkpoint]:
    """The checkpoint to resume from, set on restart after failure
    (reference: train_fn_utils.py:105)."""
    return get_context().restored_checkpoint


def get_dataset_shard(name: str = "train"):
    """This worker's shard of the dataset passed to the Trainer
    (reference: train_fn_utils.py:150, sharded by Data's
    streaming_split)."""
    shards = get_context().dataset_shards or {}
    if name not in shards:
        raise KeyError(f"no dataset {name!r} was passed to the trainer")
    return shards[name]
