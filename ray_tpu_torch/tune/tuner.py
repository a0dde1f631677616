"""Tuner + trial controller.

The port's copy of ``ray_tpu/tune/tuner.py`` over the port's runtime and
Train library. Reference parity: python/ray/tune/tuner.py:43 (Tuner.fit
-> ResultGrid) and tune/execution/tune_controller.py:68 (the actor-based
trial event loop: launch up to max_concurrent trials, stream results,
apply scheduler decisions, early-stop/perturb, collect terminal states).

A trial's actor leases ``resources_per_trial["GPU"]`` whole GPUs (the
reference's ``"TPU"`` chips): ``{"GPU": 1}`` trials run one at a time on
a one-GPU node, each in a process that sees ``CUDA_VISIBLE_DEVICES``
"0", and a stopped trial's GPU goes back when its process is gone and
its card has freed its memory (``core/runtime.py``). A ``"TPU"`` key, or
a fractional or negative ``"GPU"``, raises ValueError, as
``ScalingConfig`` does.
"""
from __future__ import annotations

import os
import time
import uuid
from typing import Any, Callable, Optional

from ..train.checkpoint import Checkpoint
from ..train.config import RunConfig
from ..train.trainer import _ResultBus
from ..train import session as session_mod
from .schedulers import (
    CONTINUE, STOP, FIFOScheduler, PopulationBasedTraining,
)
from .search import generate_variants


def _check_resources(resources: dict) -> dict:
    """``resources_per_trial`` with a whole GPU count (the port's
    ``ScalingConfig`` rules): ValueError for ``"TPU"`` and for a
    fractional or negative ``"GPU"``."""
    if "TPU" in resources:
        raise ValueError("resources_per_trial does not take 'TPU' (the "
                         "port leases GPUs: use {'GPU': n})")
    n = resources.get("GPU", 0)
    if isinstance(n, bool) or not float(n).is_integer() or n < 0:
        raise ValueError(f"resources_per_trial['GPU'] must be a whole "
                         f"number of devices >= 0, got {n!r}")
    return dict(resources)


class TuneConfig:
    """(reference: tune/tune_config.py) metric/mode drive scheduler and
    best-result selection; `stop` is an early-stop dict such as
    {"training_iteration": 20} or {"loss": 0.1} (threshold reached =>
    trial stops), matching RunConfig(stop=...) in the reference."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 num_samples: int = 1, scheduler=None,
                 max_concurrent_trials: int = 2,
                 stop: Optional[dict] = None, seed: int = 0,
                 search_alg=None):
        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        self.metric = metric
        self.mode = mode
        self.num_samples = num_samples
        self.scheduler = scheduler or FIFOScheduler()
        self.max_concurrent_trials = max_concurrent_trials
        self.stop = stop or {}
        self.seed = seed
        # sequential suggester (TPESearch) — None = upfront variant
        # generation (BasicVariantGenerator semantics)
        self.search_alg = search_alg


class Trial:
    PENDING, RUNNING, TERMINATED, STOPPED, ERROR = (
        "PENDING", "RUNNING", "TERMINATED", "STOPPED", "ERROR")

    def __init__(self, index: int, config: dict):
        self.index = index
        self.gen = 0  # bumped on every (re)launch; stale reports are dropped
        self.trial_id = f"trial_{index:05d}_{uuid.uuid4().hex[:6]}"
        self.config = dict(config)
        self.status = Trial.PENDING
        self.results: list[dict] = []
        self.iteration = 0
        self.last_checkpoint: Optional[Checkpoint] = None
        self.error: Optional[BaseException] = None
        self.restore_from: Optional[Checkpoint] = None
        self.actor = None
        self.run_ref = None

    @property
    def last_result(self) -> dict:
        return self.results[-1] if self.results else {}


class TrialResult:
    """One row of the ResultGrid (reference: air/result.py Result)."""

    def __init__(self, trial: Trial):
        self.config = trial.config
        self.metrics = trial.last_result
        self.metrics_history = trial.results
        self.checkpoint = trial.last_checkpoint
        self.error = trial.error
        self.trial_id = trial.trial_id
        self.status = trial.status


class ResultGrid:
    def __init__(self, results: list[TrialResult], metric, mode):
        self._results = results
        self._metric, self._mode = metric, mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> TrialResult:
        return self._results[i]

    @property
    def errors(self) -> list[BaseException]:
        return [r.error for r in self._results if r.error is not None]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        scored = [r for r in self._results if metric in r.metrics]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        key = lambda r: r.metrics[metric]  # noqa: E731
        return max(scored, key=key) if mode == "max" else min(scored, key=key)

    def get_dataframe(self):
        import pandas as pd
        rows = []
        for r in self._results:
            row = dict(r.metrics)
            row.update({f"config/{k}": v for k, v in r.config.items()})
            row["trial_id"] = r.trial_id
            row["status"] = r.status
            rows.append(row)
        return pd.DataFrame(rows)


class _TrialActor:
    """Hosts one trial's function trainable (reference: the trainable actor
    of tune_controller; session wiring mirrors the Train worker)."""

    def __init__(self, trial_index: int, run_name: str, bus):
        self._index = trial_index
        self._run_name = run_name
        self._bus = bus

    def run(self, fn_blob: bytes, config: dict,
            restore_path: Optional[str]) -> str:
        import cloudpickle
        fn = cloudpickle.loads(fn_blob)
        ctx = session_mod.TrainContext(
            run_name=self._run_name, rank=self._index, world_size=1,
            restored_checkpoint=(Checkpoint(restore_path)
                                 if restore_path else None),
            _bus=self._bus, sync_decisions=True)
        session_mod._set_context(ctx)
        try:
            fn(config)
        except session_mod.StopTrial:
            return "stopped"
        finally:
            session_mod._set_context(None)
        return "done"


class Tuner:
    def __init__(self, trainable: Callable, *, param_space: dict,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resources_per_trial: Optional[dict] = None):
        self.trainable = trainable
        self.param_space = param_space
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self.resources = _check_resources(resources_per_trial or {"CPU": 1})
        self._restored_trials: Optional[list[Trial]] = None

    # -- experiment persistence (reference: Tuner.restore + the
    # experiment-state file tune writes under the run dir) --------------- #

    _STATE_FILE = "tuner_state.pkl"

    def _save_experiment(self, storage: str, trials: list[Trial],
                         fn_blob: bytes) -> None:
        import cloudpickle
        state = {
            "param_space": self.param_space,
            "tune_config": self.tune_config,
            "resources": self.resources,
            "run_name": os.path.basename(storage),
            "fn_blob": fn_blob,
            "trials": [{
                "index": t.index, "config": t.config, "status": t.status,
                "results": t.results, "iteration": t.iteration,
                "checkpoint": (t.last_checkpoint.path
                               if t.last_checkpoint else None),
                "error": repr(t.error) if t.error else None,
            } for t in trials],
        }
        tmp = os.path.join(storage, self._STATE_FILE + ".tmp")
        with open(tmp, "wb") as f:
            cloudpickle.dump(state, f)
        os.replace(tmp, os.path.join(storage, self._STATE_FILE))

    @classmethod
    def restore(cls, path: str, trainable: Optional[Callable] = None,
                restore_errored: bool = False,
                resume_unfinished: bool = True) -> "Tuner":
        """Resume an experiment from its run dir (reference: Tuner.restore,
        tune/tuner.py). Finished trials keep their results; unfinished
        ones resume from their last checkpoint; errored ones re-run only
        with ``restore_errored=True``."""
        import cloudpickle
        with open(os.path.join(path, cls._STATE_FILE), "rb") as f:
            state = cloudpickle.load(f)
        fn = trainable if trainable is not None else cloudpickle.loads(
            state["fn_blob"])
        tuner = cls(fn, param_space=state["param_space"],
                    tune_config=state["tune_config"],
                    run_config=RunConfig(
                        name=state["run_name"],
                        storage_path=os.path.dirname(path)),
                    resources_per_trial=state["resources"])
        trials = []
        for row in state["trials"]:
            t = Trial(row["index"], row["config"])
            t.results = row["results"]
            t.iteration = row["iteration"]
            t.status = row["status"]
            if row["checkpoint"]:
                t.last_checkpoint = Checkpoint(row["checkpoint"])
            # STOPPED is terminal: it's the scheduler's early-stop verdict
            # (ASHA/median), not an interruption — never re-run those
            if t.status in (Trial.RUNNING, Trial.PENDING) and \
                    resume_unfinished:
                t.status = Trial.PENDING
                t.restore_from = t.last_checkpoint
            elif t.status == Trial.ERROR and restore_errored:
                t.status = Trial.PENDING
                t.restore_from = t.last_checkpoint
            trials.append(t)
        tuner._restored_trials = trials
        return tuner

    # -- controller -------------------------------------------------------

    def fit(self) -> ResultGrid:
        import cloudpickle

        from ..core import api as ray
        from ..core.usage import record_library_usage
        record_library_usage("tune")

        tc = self.tune_config
        sched = tc.scheduler
        sched.setup(tc.metric, tc.mode)
        reporter = getattr(self.run_config, "progress_reporter", None)
        if reporter is not None:
            reporter.setup(tc.metric)
        run_name = self.run_config.name or f"tune_{uuid.uuid4().hex[:8]}"
        storage = os.path.join(self.run_config.resolved_storage_path(),
                               run_name)
        os.makedirs(storage, exist_ok=True)

        searcher = tc.search_alg
        if self._restored_trials is not None:
            trials = self._restored_trials
        elif searcher is not None:
            searcher.setup(self.param_space, tc.metric, tc.mode)
            trials = []  # suggested lazily as capacity frees up
        else:
            variants = generate_variants(self.param_space, tc.num_samples,
                                         tc.seed)
            trials = [Trial(i, cfg) for i, cfg in enumerate(variants)]
        by_index = {t.index: t for t in trials}
        fn_blob = cloudpickle.dumps(self.trainable)

        BusCls = ray.remote(_ResultBus)
        bus = BusCls.options(max_concurrency=256).remote()
        ActorCls = ray.remote(_TrialActor)

        # reports are keyed rank = gen * _GEN + index so a restarted trial
        # (PBT exploit) can't be corrupted by a killed actor's stale reports
        _GEN = 1_000_000

        def launch(trial: Trial):
            trial.gen += 1
            trial.actor = ActorCls.options(
                num_cpus=self.resources.get("CPU", 1),
                num_gpus=int(self.resources.get("GPU", 0)),
            ).remote(trial.gen * _GEN + trial.index, run_name, bus)
            trial.run_ref = trial.actor.run.remote(
                fn_blob, trial.config,
                trial.restore_from.path if trial.restore_from else None)
            trial.status = Trial.RUNNING

        def stop_trial(trial: Trial, status: str,
                       err: Optional[BaseException] = None):
            trial.status = status
            trial.error = err
            if trial.actor is not None:
                try:
                    ray.kill(trial.actor)
                except Exception:
                    pass  # already dead
                trial.actor = None
            if searcher is not None and status in (
                    Trial.TERMINATED, Trial.STOPPED, Trial.ERROR) and \
                    not getattr(trial, "_searcher_told", False):
                trial._searcher_told = True
                searcher.on_trial_complete(trial.config, trial.last_result)

        def active():
            return [t for t in trials if t.status == Trial.RUNNING]

        def pending():
            return [t for t in trials if t.status == Trial.PENDING]

        last_save = 0.0
        try:
            while pending() or active() or (
                    searcher is not None and len(trials) < tc.num_samples):
                while pending() and len(active()) < tc.max_concurrent_trials:
                    launch(pending()[0])
                if searcher is not None:
                    while len(trials) < tc.num_samples and \
                            len(active()) < tc.max_concurrent_trials:
                        t = Trial(len(trials), searcher.suggest())
                        trials.append(t)
                        by_index[t.index] = t
                        launch(t)

                # reap finished/stopped/crashed trial actors
                live = [t for t in trials if t.actor is not None
                        and t.run_ref is not None]
                refs = [t.run_ref for t in live]
                done, _ = ray.wait(refs, num_returns=len(refs), timeout=0.2)
                done_set = set(done)
                for t in live:
                    if t.run_ref not in done_set:
                        continue
                    err = None
                    try:
                        ray.get(t.run_ref)
                    except BaseException as e:  # noqa: BLE001
                        err = e
                    if t.status == Trial.RUNNING:
                        stop_trial(t, Trial.ERROR if err else
                                   Trial.TERMINATED, err)
                    else:  # scheduler already decided; just clear the actor
                        stop_trial(t, t.status)

                # stream reported results; every report is answered
                # (reporters park in push_wait until the decision lands)
                for rank, seq, metrics, ckpt_path in ray.get(
                        bus.drain.remote()):
                    t = by_index.get(rank % _GEN)
                    if t is None or rank // _GEN != t.gen:
                        # stale report from a killed generation: answer STOP
                        # so a still-alive old actor exits, and drop it
                        bus.decide.remote(rank, seq, STOP)
                        continue
                    t.iteration += 1
                    metrics = dict(metrics)
                    metrics.setdefault("training_iteration", t.iteration)
                    t.results.append(metrics)
                    if reporter is not None:
                        try:
                            reporter.on_result(t.index, t.config, metrics,
                                               t.status)
                        except Exception:
                            pass  # a broken reporter must not kill trials
                    if ckpt_path:
                        t.last_checkpoint = Checkpoint(ckpt_path)
                    decision = CONTINUE
                    if self._should_stop(metrics):
                        decision = STOP
                        t.status = Trial.TERMINATED
                    elif t.status == Trial.RUNNING:
                        decision = sched.on_result(t, metrics)
                        if decision == STOP:
                            t.status = Trial.STOPPED
                    bus.decide.remote(rank, seq, decision)
                    if t.status == Trial.RUNNING and \
                            isinstance(sched, PopulationBasedTraining) and \
                            sched.should_perturb(t, metrics):
                        self._pbt_step(sched, t, trials, stop_trial, launch)

                now = time.monotonic()
                if now - last_save > 1.0:  # experiment-state checkpoint
                    last_save = now
                    self._save_experiment(storage, trials, fn_blob)
        finally:
            for t in trials:
                if t.actor is not None:
                    stop_trial(t, t.status if t.status != Trial.RUNNING
                               else Trial.STOPPED)
            try:
                ray.kill(bus)
            except Exception:
                pass  # already dead
            try:
                self._save_experiment(storage, trials, fn_blob)
            except Exception:
                pass  # best-effort final save
            if reporter is not None:
                try:
                    # a misbehaving user reporter must never mask the
                    # real in-flight exception or eat the ResultGrid
                    for t in trials:
                        reporter.on_trial_complete(t.index, t.status)
                    reporter.final()
                except Exception:
                    pass  # reporter is cosmetic; results collected

        return ResultGrid([TrialResult(t) for t in trials],
                          tc.metric, tc.mode)

    def _should_stop(self, metrics: dict) -> bool:
        for k, v in self.tune_config.stop.items():
            if k not in metrics:
                continue
            if k == "training_iteration":
                if metrics[k] >= v:
                    return True
            elif self.tune_config.mode == "max" and metrics[k] >= v:
                return True
            elif self.tune_config.mode == "min" and metrics[k] <= v:
                return True
        return False

    def _pbt_step(self, sched, trial, trials, stop_trial, launch):
        """Exploit+explore: clone a top trial's checkpoint with perturbed
        hyperparams, restart this trial from it (reference: pbt.py
        _exploit)."""
        target = sched.exploit_target(trial, trials)
        if target is None or target.last_checkpoint is None:
            return
        stop_trial(trial, Trial.PENDING)
        trial.config = sched.perturb_config(target.config)
        trial.restore_from = target.last_checkpoint
        trial.error = None
        launch(trial)
