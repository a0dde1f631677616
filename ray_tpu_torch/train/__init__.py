"""ray_tpu_torch.train — distributed training orchestration (Train v2 shape).

The port's copy of ``ray_tpu.train`` over the port's runtime (reference
parity: python/ray/train/v2 — controller state machine controller.py:93,
worker group worker_group.py:105, session/report train_fn_utils.py:13,
checkpoints _checkpoint.py:56). ``TorchTrainer`` takes the place of the
reference's ``JaxTrainer``: its gang forms one torch.distributed process
group (nccl across GPU leases, gloo on CPUs) instead of a JAX global
mesh, and ``ScalingConfig(gpus_per_worker=n)`` leases whole GPUs.

User surface:
    trainer = TorchTrainer(train_fn,
                           scaling_config=ScalingConfig(num_workers=1,
                                                        gpus_per_worker=1),
                           run_config=RunConfig(name="run1"))
    result = trainer.fit()

Inside train_fn:
    from ray_tpu_torch import train
    ctx = train.get_context()          # rank / world size
    train.report({"loss": ...}, checkpoint=train.Checkpoint.from_state(
        {"params": params, "opt": opt.state_dict(), "step": step}))
    ckpt = train.get_checkpoint()      # restored checkpoint on restart
"""
from .config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from .checkpoint import Checkpoint, CheckpointManager
from .session import (
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
    TrainContext,
)
from .trainer import (DataParallelTrainer, Result, TorchTrainer,
                      TrainingFailedError)

__all__ = [
    "Checkpoint", "CheckpointManager", "CheckpointConfig", "FailureConfig", "RunConfig",
    "ScalingConfig", "get_checkpoint", "get_context", "get_dataset_shard",
    "report", "TrainContext", "DataParallelTrainer",
    "TorchTrainer", "Result",
    "TrainingFailedError",
]
