"""The port's Tune classes against ray_tpu's, on the same seeded inputs.

Search spaces, searchers, schedulers and the CLI reporter are pure
Python in both packages: each case builds the same objects in each
package, feeds them the same results and compares every output
exactly (variants, suggestion sequences, decisions, exploit targets,
perturbed configs, the reporter's text). Last, the port's Tuner on fake
GPUs (``init(num_cpus=2, num_gpus=1)``): ``{"GPU": 1}`` trials run one
at a time, each in a process that sees ``CUDA_VISIBLE_DEVICES`` "0",
the GPU is back after ``fit``, and ``"TPU"`` or a fractional GPU
raises."""
import io
import math
import os
import time

import numpy as np
import pytest

import ray_tpu.tune as jtune
import ray_tpu_torch.tune as ttune
from ray_tpu.tune import schedulers as jsched
from ray_tpu.tune import search as jsearch
from ray_tpu_torch.tune import schedulers as tsched
from ray_tpu_torch.tune import search as tsearch

PKGS = ((jtune, jsearch, jsched), (ttune, tsearch, tsched))


def _both(fn):
    """fn(tune, search, schedulers) in each package; the outputs."""
    ref, port = (fn(*p) for p in PKGS)
    return ref, port


def _space(tune):
    return {"a": tune.grid_search([1, 2, 3]), "b": tune.uniform(0, 1),
            "c": tune.loguniform(1e-4, 1e-1), "d": tune.randint(0, 10),
            "e": tune.qrandint(0, 100, 5), "f": tune.quniform(0, 1, 0.1),
            "g": tune.choice(["x", "y", "z"]),
            "h": tune.sample_from(lambda _spec: 42), "i": "fixed"}


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_generate_variants_agree(seed):
    ref, port = _both(lambda tune, search, _s: search.generate_variants(
        _space(tune), num_samples=3, seed=seed))
    assert len(port) == 9
    assert port == ref


def _searcher_trace(tune, search, name, mode):
    cls = {"tpe": search.TPESearch, "bohb": search.BOHBSearch}[name]
    s = cls(n_initial=6, n_candidates=16, seed=3)
    s.setup({"x": tune.uniform(-2, 2), "lr": tune.loguniform(1e-4, 1e-1),
             "k": tune.choice([1, 2, 3]), "n": tune.randint(0, 8)},
            "score", mode)
    out = []
    for i in range(30):
        cfg = s.suggest()
        score = -(cfg["x"] - 0.5) ** 2 + 0.1 * math.log10(cfg["lr"]) \
            - 0.05 * abs(cfg["k"] - 2) - 0.01 * cfg["n"]
        s.on_trial_complete(cfg, {"score": score if mode == "max" else
                                  -score, "training_iteration": 1 + i % 4})
        out.append(cfg)
    return out


@pytest.mark.parametrize("name", ["tpe", "bohb"])
@pytest.mark.parametrize("mode", ["max", "min"])
def test_searchers_agree(name, mode):
    ref, port = _both(lambda tune, search, _s: _searcher_trace(
        tune, search, name, mode))
    assert port == ref


class _Trial:
    def __init__(self, i, config):
        self.trial_id = f"trial_{i:05d}"
        self.config = dict(config)


def _results(n_trials, n_iters, seed):
    """A stream of (trial index, iteration, score): interleaved trials,
    each climbing at its own rate with noise."""
    rng = np.random.RandomState(seed)
    rates = rng.uniform(0.1, 1.0, n_trials)
    for it in range(1, n_iters + 1):
        for i in range(n_trials):
            yield i, it, float(rates[i] * math.log1p(it)
                               + rng.normal(0, 0.05))


def _scheduler_trace(sched, n_trials=9, n_iters=12, seed=0):
    sched.setup("score", "max")
    trials = [_Trial(i, {"lr": 0.01 * (i + 1)}) for i in range(n_trials)]
    stopped, out = set(), []
    for i, it, score in _results(n_trials, n_iters, seed):
        if i in stopped:
            continue
        d = sched.on_result(trials[i], {"score": score,
                                        "training_iteration": it})
        out.append((i, it, d))
        if d == "STOP":
            stopped.add(i)
    return out


SCHEDULERS = {
    "asha": lambda s: s.ASHAScheduler(max_t=12, grace_period=2,
                                      reduction_factor=2),
    "median": lambda s: s.MedianStoppingRule(grace_period=3,
                                             min_samples_required=3),
    "hyperband_bohb": lambda s: s.HyperBandForBOHB(max_t=9,
                                                   reduction_factor=3),
    "fifo": lambda s: s.FIFOScheduler(),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_decisions_agree(name):
    ref, port = _both(lambda _t, _s, sched: _scheduler_trace(
        SCHEDULERS[name](sched)))
    assert port == ref
    if name != "fifo":
        assert any(d == "STOP" for _i, _it, d in port), port


def _pbt_trace(sched, n_trials=6, n_iters=16, seed=1):
    """What the Tuner does with a PBT scheduler: on_result, then, when
    due, exploit_target and perturb_config (the trial restarts with the
    target's perturbed config)."""
    sched.setup("score", "max")
    trials = [_Trial(i, {"lr": 0.01 * (i + 1), "mom": 0.5 + 0.05 * i})
              for i in range(n_trials)]
    out = []
    for i, it, score in _results(n_trials, n_iters, seed):
        t = trials[i]
        score *= t.config["lr"] * 50
        res = {"score": score, "training_iteration": it}
        d = sched.on_result(t, res)
        target = None
        if sched.should_perturb(t, res):
            target = sched.exploit_target(t, trials)
            if target is not None:
                t.config = sched.perturb_config(target.config)
        out.append((i, it, d, target and target.trial_id, dict(t.config)))
    return out


PBTS = {
    "pbt": lambda s: s.PopulationBasedTraining(
        perturbation_interval=3, seed=5,
        hyperparam_mutations={"lr": [0.005, 0.02, 0.05],
                              "mom": (0.1, 0.9)}),
    "pbt_factor": lambda s: s.PopulationBasedTraining(
        perturbation_interval=2, seed=2, quantile_fraction=0.5,
        hyperparam_mutations={"lr": "factor"}),
    "pb2": lambda s: s.PB2(perturbation_interval=3, seed=5,
                           hyperparam_bounds={"lr": (0.001, 0.1),
                                              "mom": (0.1, 0.9)}),
}


@pytest.mark.parametrize("name", sorted(PBTS))
def test_pbt_decisions_and_perturbations_agree(name):
    ref, port = _both(lambda _t, _s, sched: _pbt_trace(PBTS[name](sched)))
    assert port == ref
    assert any(target for _i, _it, _d, target, _c in port)  # exploited


@pytest.mark.parametrize("rows", [2, 20])
def test_cli_reporter_text_agrees(rows):
    def text(tune, _search, _sched):
        buf = io.StringIO()
        r = tune.CLIReporter(metric_columns=["loss", "acc"],
                             max_report_frequency=0.0,
                             max_progress_rows=rows, out=buf)
        r.setup("score")
        for i in range(4):
            r.on_result(i, {"lr": 0.1 * i},
                        {"loss": 1.0 / (i + 1), "acc": i * 0.25,
                         "score": ["n/a", 3, 2.5, None][i]}, "RUNNING")
        r.on_trial_complete(0, "TERMINATED")
        r.on_trial_complete(2, "STOPPED")
        r.final()
        return buf.getvalue()
    ref, port = _both(text)
    assert port == ref and "== trial results ==" in port


# ------------------------------------------------------------------ #
# the Tuner on fake GPUs
# ------------------------------------------------------------------ #

@pytest.fixture
def gpu1():
    import ray_tpu_torch
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, num_gpus=1,
                       object_store_memory=64 * 1024 * 1024)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_gpu_trials_run_one_at_a_time(gpu1, tmp_path):
    rt = gpu1
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig

    def trainable(config):
        t0 = time.time()
        for i in range(3):
            time.sleep(0.2)
            tune.report({"score": config["x"] * (i + 1),
                         "visible": os.environ["CUDA_VISIBLE_DEVICES"],
                         "pid": os.getpid(), "t0": t0, "t": time.time()})

    grid = tune.Tuner(
        trainable, param_space={"x": tune.grid_search([1, 2, 3])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    max_concurrent_trials=3),
        run_config=RunConfig(name="gpu", storage_path=str(tmp_path)),
        resources_per_trial={"CPU": 1, "GPU": 1}).fit()
    assert len(grid) == 3 and not grid.errors
    assert grid.get_best_result().config["x"] == 3
    spans = []
    for r in grid:
        hist = r.metrics_history
        assert [m["visible"] for m in hist] == ["0"] * 3
        spans.append((hist[0]["t0"], hist[-1]["t"]))
    assert len({r.metrics["pid"] for r in grid}) == 3
    spans.sort()
    for (_a0, a1), (b0, _b1) in zip(spans, spans[1:]):
        assert b0 >= a1, spans             # never two trials at once
    deadline = time.monotonic() + 30
    while rt.available_resources().get("GPU", 0.0) != 1.0:
        assert time.monotonic() < deadline
        time.sleep(0.05)


@pytest.mark.parametrize("resources", [{"CPU": 1, "TPU": 1},
                                       {"GPU": 0.5}, {"GPU": -1},
                                       {"GPU": True}])
def test_tpu_and_fractional_gpus_raise(resources):
    with pytest.raises(ValueError):
        ttune.Tuner(lambda c: None, param_space={},
                    resources_per_trial=resources)
    # the reference takes what the port refuses only for "TPU"
    if "TPU" in resources:
        jtune.Tuner(lambda c: None, param_space={},
                    resources_per_trial=resources)
