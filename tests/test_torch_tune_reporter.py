"""Tune progress reporters (reference: tune/progress_reporter.py
CLIReporter).

The port's copy of ``tests/test_tune_reporter.py``, with its imports
pointed at ``ray_tpu_torch`` and its own ``ray_start_regular`` fixture
(conftest's starts the reference's runtime).
"""
import io

import pytest

from ray_tpu_torch.tune.reporter import CLIReporter


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


def test_cli_reporter_table_and_rate_cap():
    buf = io.StringIO()
    r = CLIReporter(metric_columns=["loss"], max_report_frequency=0.0,
                    max_progress_rows=2, out=buf)
    r.setup("loss")
    for i in range(3):
        r.on_result(i, {"lr": 0.1}, {"loss": 1.0 / (i + 1)}, "RUNNING")
    r.on_trial_complete(0, "TERMINATED")
    r.final()
    out = buf.getvalue()
    assert "trial_0" in out and "loss" in out
    assert "and 1 more trials" in out          # max_progress_rows cap
    assert "TERMINATED" in out                  # final table has status

def test_cli_reporter_respects_frequency():
    buf = io.StringIO()
    r = CLIReporter(metric_columns=["m"], max_report_frequency=3600.0,
                    out=buf)
    for i in range(5):
        r.on_result(0, {}, {"m": i}, "RUNNING")
    # one initial print at most (first call prints; the rest are capped)
    assert buf.getvalue().count("== trial progress ==") <= 1
    r.final()
    assert "== trial results ==" in buf.getvalue()


def test_reporter_wired_through_tuner(ray_start_regular):
    """End-to-end: RunConfig(progress_reporter=...) receives every trial
    result and the final table (reference: tune's CLIReporter flow)."""
    import io

    from ray_tpu_torch import tune
    from ray_tpu_torch.train.config import RunConfig
    from ray_tpu_torch.tune.reporter import CLIReporter

    buf = io.StringIO()
    rep = CLIReporter(max_report_frequency=0.0, out=buf)

    def trainable(config):
        for i in range(3):
            tune.report({"score": config["x"] * (i + 1)})

    tuner = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1, 2])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    num_samples=1),
        run_config=RunConfig(progress_reporter=rep),
        resources_per_trial={"CPU": 0.5})
    res = tuner.fit()
    assert res.get_best_result().metrics["score"] == 6
    out = buf.getvalue()
    assert "trial_0" in out and "trial_1" in out and "score" in out
    assert "== trial results ==" in out
