"""Training run configuration.

The port's copy of ``ray_tpu/train/config.py`` (reference parity:
python/ray/air/config.py RunConfig/ScalingConfig/CheckpointConfig/
FailureConfig). ``ScalingConfig`` leases whole GPUs
(``gpus_per_worker``) where the reference asks for TPU chips; the
reference's ``jax_distributed`` and ``local_device_count`` (JAX's global
mesh, XLA's virtual devices) have no counterpart and are refused.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

# reference ScalingConfig fields with no counterpart here, and why
_NOT_PORTED = {
    "tpus_per_worker": "the port leases GPUs: use gpus_per_worker=n",
    "jax_distributed": "TorchTrainer forms a torch.distributed process "
                       "group across the gang instead of a JAX mesh",
    "local_device_count": "XLA's virtual CPU devices have no "
                          "counterpart in the port",
}


@dataclasses.dataclass
class ScalingConfig:
    """Gang size and per-worker resources.

    ``num_workers`` is the number of worker processes in the gang and
    ``gpus_per_worker`` the whole GPUs each one leases (its process sees
    their indices in ``CUDA_VISIBLE_DEVICES``; 0 for a CPU worker).
    Reference analog: ScalingConfig(num_workers, use_gpu,
    resources_per_worker), air/config.py. A fractional or negative
    ``gpus_per_worker`` raises ValueError, and so does naming the
    reference's ``tpus_per_worker``, ``jax_distributed`` or
    ``local_device_count``.
    """
    num_workers: int = 1
    cpus_per_worker: float = 1.0
    gpus_per_worker: int = 0
    resources_per_worker: Optional[dict] = None
    placement_strategy: str = "PACK"
    # Elastic gangs (reference: v2 scaling_policy/elastic — min/max worker
    # range): None = fixed size. With min_workers set, the trainer sizes
    # each (re)start to the LARGEST reservable gang in
    # [min_workers, num_workers] — training resumes from the latest
    # checkpoint at reduced width instead of stalling when the cluster
    # shrinks. Per-size reservation wait: elastic_timeout_s.
    min_workers: Optional[int] = None
    elastic_timeout_s: float = 30.0
    # How often the fit loop checks whether a shrunken gang can GROW back
    # toward num_workers (reference: Train v2 consults ScalingPolicy every
    # control-loop iteration, controller.py:446). Growth checkpoints the
    # run and restarts at the larger world size.
    elastic_poll_s: float = 5.0

    def __new__(cls, *args, **kwargs):
        named = sorted(set(kwargs) & set(_NOT_PORTED))
        if named:
            raise ValueError(
                "ScalingConfig does not take "
                + "; ".join(f"{n} ({_NOT_PORTED[n]})" for n in named))
        return super().__new__(cls)

    def __post_init__(self):
        n = self.gpus_per_worker
        if isinstance(n, bool) or not float(n).is_integer() or n < 0:
            raise ValueError(
                f"gpus_per_worker must be a whole number of devices >= 0, "
                f"got {n!r}")
        self.gpus_per_worker = int(n)

    def bundle(self) -> dict:
        res = {"CPU": self.cpus_per_worker}
        if self.gpus_per_worker:
            res["GPU"] = self.gpus_per_worker
        if self.resources_per_worker:
            res.update(self.resources_per_worker)
        return res


@dataclasses.dataclass
class FailureConfig:
    """(reference: air/config.py FailureConfig) max_failures < 0 = retry
    forever; 0 = fail fast."""
    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    """(reference: air/config.py CheckpointConfig)"""
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)
    # an object with the reference's progress-reporter hook surface
    # (tune.reporter.CLIReporter there); kept for the Tuner's result loop
    progress_reporter: Optional[Any] = None

    def resolved_storage_path(self) -> str:
        return self.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_results")
