"""Optuna searcher adapter (reference:
tune/search/optuna/optuna_search.py). Skipped when optuna is absent —
the adapter is a soft dependency, like the reference's.

The port's copy of ``tests/test_tune_optuna.py``, with its imports
pointed at ``ray_tpu_torch``.
"""
import pytest

import ray_tpu_torch
from ray_tpu_torch import tune

optuna = pytest.importorskip("optuna")


@pytest.fixture
def ray2():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    yield
    ray_tpu_torch.shutdown()


def test_domain_mapping():
    from ray_tpu_torch.tune.optuna_search import _to_distribution
    import optuna.distributions as od
    d = _to_distribution(tune.choice(["a", "b"]))
    assert isinstance(d, od.CategoricalDistribution)
    d = _to_distribution(tune.loguniform(1e-4, 1e-1))
    assert isinstance(d, od.FloatDistribution) and d.log
    d = _to_distribution(tune.randint(0, 10))
    assert isinstance(d, od.IntDistribution) and d.high == 9
    d = _to_distribution(tune.uniform(0.0, 1.0))
    assert isinstance(d, od.FloatDistribution) and not d.log


def test_optuna_search_converges(ray2):
    def trainable(config):
        # quadratic bowl: optimum at x=0.3, y=-0.1
        loss = (config["x"] - 0.3) ** 2 + (config["y"] + 0.1) ** 2
        tune.report({"loss": loss})

    tuner = tune.Tuner(
        trainable,
        param_space={"x": tune.uniform(-1.0, 1.0),
                     "y": tune.uniform(-1.0, 1.0)},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", num_samples=24,
            search_alg=tune.OptunaSearch(seed=0)),
    )
    results = tuner.fit()
    best = results.get_best_result()
    assert best.metrics["loss"] < 0.05


def test_grid_axes_rejected():
    s = tune.OptunaSearch()
    with pytest.raises(ValueError, match="grid_search"):
        s.setup({"x": tune.grid_search([1, 2])}, "loss", "min")
