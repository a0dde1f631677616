"""ray_tpu_torch.tune — hyperparameter search (the port's copy of
``ray_tpu.tune``).

Reference parity: python/ray/tune (Tuner tuner.py:43, TuneController
execution/tune_controller.py:68, schedulers/ — ASHA async_hyperband.py, PBT
pbt.py, median stopping; search spaces tune/search/sample.py, grid/random
search via BasicVariantGenerator). Trials are actors of the port's
runtime; results stream over the same report bus the port's Train
library uses (`tune.report` is `train.report`, matching the unified v2
API). A trial leases whole GPUs (``resources_per_trial={"GPU": n}``:
its process sees them in ``CUDA_VISIBLE_DEVICES``) where the
reference's asks for TPU chips.
"""
from .search import (
    BOHBSearch,
    TPESearch,
    choice,
    grid_search,
    loguniform,
    qrandint,
    quniform,
    randint,
    sample_from,
    uniform,
)
from .schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    HyperBandForBOHB,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
)
from .optuna_search import OptunaSearch
from .reporter import CLIReporter
from .tuner import ResultGrid, TuneConfig, Tuner
from ..train.session import get_context
from ..train import Checkpoint

# unified report API (reference: ray.tune.report == ray.train.report in v2)
from ..train.session import report, get_checkpoint  # noqa: F401

__all__ = [
    "CLIReporter",
    "Tuner", "TuneConfig", "ResultGrid", "grid_search", "choice", "uniform",
    "loguniform", "randint", "qrandint", "quniform", "sample_from",
    "FIFOScheduler", "ASHAScheduler", "MedianStoppingRule",
    "PopulationBasedTraining", "HyperBandForBOHB", "PB2",
    "TPESearch", "BOHBSearch", "OptunaSearch",
    "report", "get_checkpoint", "get_context",
    "Checkpoint",
]
