"""BOHB (HyperBandForBOHB + BOHBSearch) and PB2 (reference:
tune/schedulers/hb_bohb.py, tune/search/bohb/, tune/schedulers/pb2.py).

The port's copy of ``tests/test_tune_bohb_pb2.py``, with its imports
pointed at ``ray_tpu_torch`` and its own ``ray_start_regular`` fixture
(conftest's starts the reference's runtime).
"""
import pytest

from ray_tpu_torch import tune


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


class TestHyperBandForBOHB:
    def test_brackets_ladder(self):
        sched = tune.HyperBandForBOHB(max_t=27, reduction_factor=3)
        sched.setup("score", "max")
        # one bracket per starting rung: [27], [9,27], [3,9,27], [1,3,9,27]
        assert [b[-1] for b in sched.brackets] == [27] * len(sched.brackets)
        assert sched.brackets[-1][0] == 1
        assert len(sched.brackets) == 4

    def test_stops_bottom_of_rung(self):
        """Rung semantics, driven directly: once reduction_factor results
        land on a rung, the bottom 1/rf stop; survivors continue to
        max_t."""
        from ray_tpu_torch.tune.schedulers import CONTINUE, STOP

        class T:
            def __init__(self, tid):
                self.trial_id = tid

        sched = tune.HyperBandForBOHB(max_t=9, reduction_factor=3)
        sched.setup("score", "max")
        trials = [T(f"t{i}") for i in range(3)]
        for t in trials:   # pin all three to the full ladder [1, 3, 9]
            sched._trial_bracket[t.trial_id] = len(sched.brackets) - 1

        r1 = {"training_iteration": 1}
        assert sched.on_result(trials[0], {**r1, "score": 3}) == CONTINUE
        assert sched.on_result(trials[1], {**r1, "score": 2}) == CONTINUE
        # third arrival completes the rung; it is the bottom third -> STOP
        assert sched.on_result(trials[2], {**r1, "score": 1}) == STOP
        # survivors continue between rungs
        assert sched.on_result(
            trials[0], {"training_iteration": 2, "score": 6}) == CONTINUE
        # max_t is terminal for everyone
        assert sched.on_result(
            trials[0], {"training_iteration": 9, "score": 60}) == STOP

    @pytest.mark.slow
    def test_bohb_search_convergence(self, ray, tmp_path):
        from ray_tpu_torch.train.config import RunConfig

        def objective(config):
            for step in range(4):
                tune.report(
                    {"score": -(config["x"] - 0.7) ** 2 * (step + 1)})

        tuner = tune.Tuner(
            objective,
            param_space={"x": tune.uniform(0.0, 1.0)},
            tune_config=tune.TuneConfig(
                metric="score", mode="max", num_samples=16,
                max_concurrent_trials=2,
                search_alg=tune.BOHBSearch(n_initial=6, seed=0),
                scheduler=tune.HyperBandForBOHB(max_t=4,
                                                reduction_factor=2)),
            run_config=RunConfig(name="bohbs", storage_path=str(tmp_path)))
        grid = tuner.fit()
        best = grid.get_best_result()
        # the model should concentrate near the optimum
        assert abs(best.config["x"] - 0.7) < 0.25, best.config


class TestPB2:
    def test_requires_bounds(self):
        with pytest.raises(ValueError, match="bounds"):
            tune.PB2(hyperparam_bounds={})

    @pytest.mark.slow
    def test_pb2_exploits_with_gp_suggestions(self, ray, tmp_path):
        from ray_tpu_torch.train.config import RunConfig

        def objective(config):
            ckpt = tune.get_checkpoint()
            step = ckpt.load_state()["step"] + 1 if ckpt else 0
            for s in range(step, 12):
                c = tune.Checkpoint.from_state({"step": s})
                tune.report({"score": config["lr"] * (s + 1),
                             "lr": config["lr"]}, checkpoint=c)

        tuner = tune.Tuner(
            objective,
            param_space={"lr": tune.grid_search([0.05, 1.0])},
            tune_config=tune.TuneConfig(
                metric="score", mode="max", max_concurrent_trials=2,
                scheduler=tune.PB2(
                    perturbation_interval=3,
                    hyperparam_bounds={"lr": (0.01, 2.0)})),
            run_config=RunConfig(name="pb2", storage_path=str(tmp_path)))
        grid = tuner.fit()
        assert len(grid) == 2
        # the weak trial's lr was replaced by a GP suggestion inside bounds
        lrs = sorted(r.metrics.get("lr", 0) for r in grid)
        assert lrs[0] != 0.05 or lrs[1] != 1.0
        assert all(0.01 <= v <= 2.0 for v in lrs)
