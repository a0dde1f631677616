"""Tune tests (reference parity: tune/tests — variant generation, Tuner.fit
end-to-end, ASHA early stopping, PBT exploit/explore, stop criteria).

The port's copy of ``tests/test_tune.py``, with its imports pointed at
``ray_tpu_torch`` and its own ``ray_start_regular`` fixture (conftest's
starts the reference's runtime).
"""
import pytest


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


def test_generate_variants_grid_and_random():
    from ray_tpu_torch.tune.search import generate_variants
    from ray_tpu_torch import tune
    space = {"a": tune.grid_search([1, 2, 3]), "b": tune.uniform(0, 1),
             "c": "fixed"}
    variants = generate_variants(space, num_samples=2, seed=0)
    assert len(variants) == 6
    assert sorted({v["a"] for v in variants}) == [1, 2, 3]
    assert all(0 <= v["b"] <= 1 and v["c"] == "fixed" for v in variants)


@pytest.mark.slow  # 4.4s; Tuner driving stays via test_stop_criteria_iterations, variant expansion via test_generate_variants_grid_and_random
def test_tuner_grid_best_result(ray, tmp_path):
    from ray_tpu_torch import tune
    from ray_tpu_torch.train.config import RunConfig

    def objective(config):
        score = -(config["x"] - 3) ** 2
        tune.report({"score": score})

    tuner = tune.Tuner(
        objective,
        param_space={"x": tune.grid_search([0, 1, 2, 3, 4])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    max_concurrent_trials=2),
        run_config=RunConfig(name="grid", storage_path=str(tmp_path)))
    grid = tuner.fit()
    assert len(grid) == 5
    best = grid.get_best_result()
    assert best.config["x"] == 3
    assert best.metrics["score"] == 0
    df = grid.get_dataframe()
    assert "config/x" in df.columns and len(df) == 5


@pytest.mark.slow
def test_asha_stops_bad_trials(ray, tmp_path):
    from ray_tpu_torch import tune
    from ray_tpu_torch.train.config import RunConfig

    def objective(config):
        for step in range(8):
            tune.report({"score": config["x"] * (step + 1)})

    tuner = tune.Tuner(
        objective,
        param_space={"x": tune.grid_search([1, 2, 3, 4])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", max_concurrent_trials=4,
            scheduler=tune.ASHAScheduler(max_t=8, grace_period=2,
                                         reduction_factor=2)),
        run_config=RunConfig(name="asha", storage_path=str(tmp_path)))
    grid = tuner.fit()
    assert grid.get_best_result().config["x"] == 4
    stopped = [r for r in grid if r.status == "STOPPED"]
    assert stopped, "ASHA should early-stop at least one trial"


def test_stop_criteria_iterations(ray, tmp_path):
    from ray_tpu_torch import tune
    from ray_tpu_torch.train.config import RunConfig

    def objective(config):
        for _ in range(100):
            tune.report({"loss": 1.0})

    tuner = tune.Tuner(
        objective, param_space={"x": tune.grid_search([1])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    stop={"training_iteration": 3}),
        run_config=RunConfig(name="stop", storage_path=str(tmp_path)))
    grid = tuner.fit()
    assert grid[0].metrics["training_iteration"] == 3


@pytest.mark.slow
def test_pbt_perturbs_and_restores(ray, tmp_path):
    from ray_tpu_torch import tune
    from ray_tpu_torch.train.config import RunConfig

    def objective(config):
        ckpt = tune.get_checkpoint()
        step = ckpt.load_state()["step"] + 1 if ckpt else 0
        lr = config["lr"]
        for s in range(step, 12):
            c = tune.Checkpoint.from_state({"step": s})
            tune.report({"score": lr * (s + 1), "lr": lr}, checkpoint=c)

    tuner = tune.Tuner(
        objective,
        param_space={"lr": tune.grid_search([0.1, 1.0])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", max_concurrent_trials=2,
            scheduler=tune.PopulationBasedTraining(
                perturbation_interval=3,
                hyperparam_mutations={"lr": [0.5, 2.0]})),
        run_config=RunConfig(name="pbt", storage_path=str(tmp_path)))
    grid = tuner.fit()
    assert len(grid) == 2
    # the weak trial should have been exploited: its final lr is a mutation,
    # not its original 0.1
    lrs = sorted(r.metrics.get("lr", 0) for r in grid)
    assert lrs[0] != 0.1 or lrs[1] != 1.0
