"""Tune experiment restore + TPE searcher tests (reference: Tuner.restore,
tune/search integrations).

The port's copy of ``tests/test_tune_restore_tpe.py``, with its imports
pointed at ``ray_tpu_torch`` and its own ``ray_start_regular`` fixture
(conftest's starts the reference's runtime).
"""
import os

import pytest

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.tune.search import TPESearch, loguniform, uniform


@pytest.fixture
def ray_start_regular():
    """The port's runtime under conftest's name (conftest's starts the
    reference's)."""
    import ray_tpu_torch
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray(ray_start_regular):
    return ray_start_regular


def test_tpe_concentrates_on_optimum():
    """Pure searcher test: TPE's late suggestions cluster near the max of
    a quadratic better than its early random phase."""
    tpe = TPESearch(n_initial=8, seed=0)
    tpe.setup({"x": uniform(0.0, 1.0)}, metric="score", mode="max")
    xs = []
    for _ in range(40):
        cfg = tpe.suggest()
        xs.append(cfg["x"])
        tpe.on_trial_complete(cfg, {"score": -(cfg["x"] - 0.3) ** 2})
    early = sum(abs(x - 0.3) for x in xs[:8]) / 8
    late = sum(abs(x - 0.3) for x in xs[-10:]) / 10
    assert late < early, (early, late)
    assert late < 0.15, late


def test_tpe_minimize_and_loguniform():
    tpe = TPESearch(n_initial=6, seed=1)
    tpe.setup({"lr": loguniform(1e-5, 1e-1)}, metric="loss", mode="min")
    best = None
    for _ in range(30):
        cfg = tpe.suggest()
        import math
        loss = (math.log10(cfg["lr"]) + 3) ** 2   # optimum at 1e-3
        tpe.on_trial_complete(cfg, {"loss": loss})
        if best is None or loss < best[1]:
            best = (cfg["lr"], loss)
    assert 1e-4 < best[0] < 1e-2, best


def test_tpe_rejects_grid():
    tpe = TPESearch()
    with pytest.raises(ValueError, match="grid"):
        tpe.setup({"a": tune.grid_search([1, 2])}, "m", "max")


@pytest.mark.slow
def test_tuner_with_tpe_search(ray, tmp_path):
    def objective(config):
        tune.report({"score": -(config["x"] - 0.5) ** 2})

    tuner = tune.Tuner(
        objective,
        param_space={"x": uniform(0.0, 1.0)},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=8,
            search_alg=TPESearch(n_initial=4, seed=0),
            max_concurrent_trials=2),
        run_config=tune.Tuner.__init__.__defaults__ and None or None,
    )
    # run_config default; storage under default dir is fine
    grid = tuner.fit()
    assert len(grid) == 8
    best = grid.get_best_result()
    assert abs(best.config["x"] - 0.5) < 0.45  # found something reasonable


@pytest.mark.slow
def test_tuner_restore_resumes_unfinished(ray, tmp_path):
    """Errored trials re-run on restore; finished ones keep results."""
    marker = tmp_path / "attempt2"

    def flaky(config):
        import os as _os
        for i in range(3):
            if config["idx"] == 1 and not _os.path.exists(str(marker)) \
                    and i == 1:
                raise RuntimeError("boom on first attempt")
            tune.report({"val": config["idx"] * 10 + i})

    from ray_tpu_torch.train.config import RunConfig
    run_config = RunConfig(name="restore-exp", storage_path=str(tmp_path))
    tuner = tune.Tuner(
        flaky,
        param_space={"idx": tune.grid_search([0, 1])},
        tune_config=tune.TuneConfig(metric="val", mode="max",
                                    num_samples=1),
        run_config=run_config)
    grid = tuner.fit()
    statuses = sorted(r.status for r in grid)
    assert statuses == ["ERROR", "TERMINATED"], statuses

    exp_dir = os.path.join(str(tmp_path), "restore-exp")
    assert os.path.exists(os.path.join(exp_dir, "tuner_state.pkl"))

    marker.write_text("go")  # second attempt succeeds
    tuner2 = tune.Tuner.restore(exp_dir, trainable=flaky,
                                restore_errored=True)
    grid2 = tuner2.fit()
    assert sorted(r.status for r in grid2) == ["TERMINATED", "TERMINATED"]
    vals = sorted(r.metrics["val"] for r in grid2)
    assert vals == [2, 12], vals
