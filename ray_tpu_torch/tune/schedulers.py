"""Trial schedulers: early stopping and population-based training.

The port's copy of ``ray_tpu/tune/schedulers.py`` (pure Python; PB2's
surrogate stays numpy).
Reference parity: python/ray/tune/schedulers/ — FIFO (fifo.py), ASHA
(async_hyperband.py AsyncHyperBandScheduler), median stopping
(median_stopping_rule.py), PBT (pbt.py). The controller feeds every
reported result to `on_result(trial, result)`; the scheduler answers
CONTINUE / STOP, and PBT additionally mutates trial configs via
`exploit_target(trial)`.
"""
from __future__ import annotations

import random
from collections import defaultdict
from typing import Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class FIFOScheduler:
    """Run every trial to completion (reference: fifo.py)."""

    def setup(self, metric: str, mode: str):
        self.metric, self.mode = metric, mode

    def on_result(self, trial, result: dict) -> str:
        return CONTINUE


class ASHAScheduler(FIFOScheduler):
    """Asynchronous successive halving (reference: async_hyperband.py).

    Rungs at grace_period * reduction_factor^k; at each rung a trial stops
    unless its metric is in the top 1/reduction_factor of results recorded
    at that rung so far.
    """

    def __init__(self, time_attr: str = "training_iteration",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4):
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace = grace_period
        self.rf = reduction_factor
        self.rungs: list[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        self.rung_results: dict[int, list[float]] = defaultdict(list)
        self._passed: dict[tuple, set] = defaultdict(set)

    def on_result(self, trial, result: dict) -> str:
        t = result.get(self.time_attr, 0)
        val = result.get(self.metric)
        if val is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        for rung in self.rungs:
            if t >= rung and rung not in self._passed[(trial.trial_id,)]:
                self._passed[(trial.trial_id,)].add(rung)
                recorded = self.rung_results[rung]
                recorded.append(val if self.mode == "max" else -val)
                v = val if self.mode == "max" else -val
                if len(recorded) >= self.rf:
                    cutoff = sorted(recorded, reverse=True)[
                        max(0, len(recorded) // self.rf - 1)]
                    if v < cutoff:
                        return STOP
        return CONTINUE


class MedianStoppingRule(FIFOScheduler):
    """Stop a trial whose running-average metric falls below the median of
    other trials' averages at the same step (reference:
    median_stopping_rule.py)."""

    def __init__(self, time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.time_attr = time_attr
        self.grace = grace_period
        self.min_samples = min_samples_required
        self._sums: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)

    def on_result(self, trial, result: dict) -> str:
        t = result.get(self.time_attr, 0)
        val = result.get(self.metric)
        if val is None:
            return CONTINUE
        tid = trial.trial_id
        self._sums[tid] += val if self.mode == "max" else -val
        self._counts[tid] += 1
        if t < self.grace or len(self._counts) < self.min_samples:
            return CONTINUE
        means = [self._sums[k] / self._counts[k]
                 for k in self._counts if k != tid]
        if not means:
            return CONTINUE
        my_mean = self._sums[tid] / self._counts[tid]
        med = sorted(means)[len(means) // 2]
        return STOP if my_mean < med else CONTINUE


class PopulationBasedTraining(FIFOScheduler):
    """PBT (reference: pbt.py): every perturbation_interval, bottom-quantile
    trials clone a top-quantile trial's checkpoint + config, with
    hyperparameters perturbed (×0.8 / ×1.2 or resampled)."""

    def __init__(self, time_attr: str = "training_iteration",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[dict] = None,
                 quantile_fraction: float = 0.25, seed: int = 0):
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.rng = random.Random(seed)
        self._last: dict[str, dict] = {}       # trial_id -> last result
        self._last_perturb: dict[str, int] = defaultdict(int)

    def on_result(self, trial, result: dict) -> str:
        self._last[trial.trial_id] = result
        return CONTINUE

    def should_perturb(self, trial, result: dict) -> bool:
        t = result.get(self.time_attr, 0)
        return t - self._last_perturb[trial.trial_id] >= self.interval

    def exploit_target(self, trial, all_trials) -> Optional[object]:
        """The trial to clone from, or None if `trial` is healthy."""
        scored = []
        for tr in all_trials:
            res = self._last.get(tr.trial_id)
            if res is None or self.metric not in res:
                continue
            v = res[self.metric]
            scored.append((v if self.mode == "max" else -v, tr))
        if len(scored) < 2:
            return None
        scored.sort(key=lambda x: x[0])
        n_q = max(1, int(len(scored) * self.quantile))
        bottom = [tr for _, tr in scored[:n_q]]
        top = [tr for _, tr in scored[-n_q:]]
        if any(tr.trial_id == trial.trial_id for tr in bottom):
            self._last_perturb[trial.trial_id] = self._last.get(
                trial.trial_id, {}).get(self.time_attr, 0)
            return self.rng.choice(top)
        self._last_perturb[trial.trial_id] = self._last.get(
            trial.trial_id, {}).get(self.time_attr, 0)
        return None

    def perturb_config(self, config: dict) -> dict:
        out = dict(config)
        for key, spec in self.mutations.items():
            if callable(spec):
                out[key] = spec()
            elif isinstance(spec, list):
                out[key] = self.rng.choice(spec)
            elif isinstance(spec, tuple) and len(spec) == 2:
                lo, hi = spec
                out[key] = self.rng.uniform(lo, hi)
            else:
                factor = self.rng.choice([0.8, 1.2])
                out[key] = config[key] * factor
        return out


class HyperBandForBOHB(FIFOScheduler):
    """BOHB's scheduler half (reference: tune/schedulers/hb_bohb.py):
    hyperband brackets of successive-halving rungs. New trials join the
    bracket with the fewest members; within a bracket, a trial reaching a
    rung survives only in the top 1/reduction_factor of results recorded
    at that rung. Pair with search.BOHBSearch, which feeds the model from
    the same budget-tagged observations."""

    def __init__(self, time_attr: str = "training_iteration",
                 max_t: int = 81, reduction_factor: int = 3):
        self.time_attr = time_attr
        self.max_t = max_t
        self.rf = reduction_factor
        # bracket b has rungs at max_t / rf^k for k = b..0 (hyperband's
        # budget ladder: one bracket per possible starting rung). Integer
        # loop: int(log(243, 3)) == 4 by float rounding, dropping a rung.
        s_max = 0
        while reduction_factor ** (s_max + 1) <= max_t:
            s_max += 1
        self.brackets: list[list[int]] = []
        for b in range(s_max + 1):
            rungs = sorted(max_t // (reduction_factor ** k)
                           for k in range(b + 1))
            self.brackets.append([r for r in rungs if r >= 1])
        self._trial_bracket: dict[str, int] = {}
        self._members: list[int] = [0] * len(self.brackets)
        self.rung_results: dict[tuple[int, int], list[float]] = \
            defaultdict(list)
        self._passed: dict[str, set] = defaultdict(set)

    def _bracket_of(self, trial) -> int:
        b = self._trial_bracket.get(trial.trial_id)
        if b is None:
            b = min(range(len(self.brackets)), key=lambda i: self._members[i])
            self._trial_bracket[trial.trial_id] = b
            self._members[b] += 1
        return b

    def on_result(self, trial, result: dict) -> str:
        t = result.get(self.time_attr, 0)
        val = result.get(self.metric)
        if val is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        v = val if self.mode == "max" else -val
        b = self._bracket_of(trial)
        for rung in self.brackets[b]:
            if rung >= self.max_t:
                continue
            if t >= rung and rung not in self._passed[trial.trial_id]:
                self._passed[trial.trial_id].add(rung)
                recorded = self.rung_results[(b, rung)]
                recorded.append(v)
                if len(recorded) >= self.rf:
                    cutoff = sorted(recorded, reverse=True)[
                        max(0, len(recorded) // self.rf - 1)]
                    if v < cutoff:
                        return STOP
        return CONTINUE


class PB2(PopulationBasedTraining):
    """PB2 (reference: tune/schedulers/pb2.py): PBT where perturbations
    come from a Gaussian-process bandit over (hyperparams -> recent metric
    improvement) instead of random x0.8/x1.2 nudges — far more
    sample-efficient for small populations (Parker-Holder et al. 2020).

    `hyperparam_bounds` maps keys to (low, high); suggestions maximize
    GP-UCB fitted (numpy-only) on observed (config, delta-metric) pairs.
    """

    def __init__(self, time_attr: str = "training_iteration",
                 perturbation_interval: int = 4,
                 hyperparam_bounds: Optional[dict] = None,
                 quantile_fraction: float = 0.25, seed: int = 0,
                 ucb_kappa: float = 1.5):
        super().__init__(time_attr=time_attr,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations=None,
                         quantile_fraction=quantile_fraction, seed=seed)
        self.bounds = dict(hyperparam_bounds or {})
        if not self.bounds:
            raise ValueError("PB2 requires hyperparam_bounds")
        self.kappa = ucb_kappa
        # observations: (normalized config vector, improvement)
        self._gp_x: list[list[float]] = []
        self._gp_y: list[float] = []
        self._prev_metric: dict[str, float] = {}

    def _norm(self, config: dict) -> list[float]:
        out = []
        for k, (lo, hi) in self.bounds.items():
            v = float(config.get(k, lo))
            out.append((v - lo) / max(hi - lo, 1e-12))
        return out

    def on_result(self, trial, result: dict) -> str:
        val = result.get(self.metric)
        if val is not None:
            v = val if self.mode == "max" else -val
            prev = self._prev_metric.get(trial.trial_id)
            if prev is not None:
                self._gp_x.append(self._norm(trial.config))
                self._gp_y.append(v - prev)
                # bound the GP fit cost
                self._gp_x = self._gp_x[-256:]
                self._gp_y = self._gp_y[-256:]
            self._prev_metric[trial.trial_id] = v
        return super().on_result(trial, result)

    # -- tiny numpy GP (RBF kernel, fixed scales) ------------------------ #

    def _gp_ucb(self, cand) -> float:
        import numpy as np
        if not self._gp_x:
            return 0.0
        X = np.asarray(self._gp_x)
        y = np.asarray(self._gp_y)
        y_std = y.std() or 1.0
        yn = (y - y.mean()) / y_std
        ls, noise = 0.2, 1e-2
        def k(a, b):
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / ls ** 2)
        K = k(X, X) + noise * np.eye(len(X))
        c = np.asarray(cand)[None, :]
        kx = k(X, c)[:, 0]
        try:
            Ki = np.linalg.inv(K)
        except np.linalg.LinAlgError:
            return 0.0
        mu = kx @ Ki @ yn
        var = max(1e-9, 1.0 - kx @ Ki @ kx)
        return float(mu + self.kappa * var ** 0.5)

    def perturb_config(self, config: dict) -> dict:
        """GP-UCB-maximizing config over the bounds (candidate sampling)."""
        import numpy as np
        best, best_score = None, None
        for _ in range(32):
            cand = {}
            vec = []
            for k, (lo, hi) in self.bounds.items():
                u = self.rng.random()
                cand[k] = lo + u * (hi - lo)
                vec.append(u)
            score = self._gp_ucb(vec)
            if best_score is None or score > best_score:
                best, best_score = cand, score
        out = dict(config)
        out.update(best or {})
        return out
