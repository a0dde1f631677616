"""Search spaces + variant generation.

The port's copy of ``ray_tpu/tune/search.py`` (pure Python: the same
seeded draws give the same variants and suggestions in both packages).
Reference parity: python/ray/tune/search/sample.py (Categorical/Float/
Integer domains, grid_search) and search/basic_variant.py
(BasicVariantGenerator — grid cross-product × num_samples random draws).
"""
from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Uniform(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low, high):
        import math
        self.lo, self.hi = math.log(low), math.log(high)

    def sample(self, rng):
        import math
        return math.exp(rng.uniform(self.lo, self.hi))


class QUniform(Domain):
    def __init__(self, low, high, q):
        self.low, self.high, self.q = low, high, q

    def sample(self, rng):
        v = rng.uniform(self.low, self.high)
        return round(v / self.q) * self.q


class RandInt(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class QRandInt(Domain):
    def __init__(self, low, high, q):
        self.low, self.high, self.q = low, high, q

    def sample(self, rng):
        return (rng.randrange(self.low, self.high) // self.q) * self.q


class Function(Domain):
    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng):
        return self.fn(None)


class GridSearch:
    def __init__(self, values):
        self.values = list(values)


def grid_search(values) -> GridSearch:
    return GridSearch(values)


def choice(categories) -> Categorical:
    return Categorical(categories)


def uniform(low, high) -> Uniform:
    return Uniform(low, high)


def loguniform(low, high) -> LogUniform:
    return LogUniform(low, high)


def quniform(low, high, q) -> QUniform:
    return QUniform(low, high, q)


def randint(low, high) -> RandInt:
    return RandInt(low, high)


def qrandint(low, high, q) -> QRandInt:
    return QRandInt(low, high, q)


def sample_from(fn: Callable) -> Function:
    return Function(fn)


def generate_variants(param_space: dict, num_samples: int,
                      seed: int = 0) -> list[dict]:
    """Grid axes cross-product × num_samples draws of stochastic domains
    (reference: BasicVariantGenerator semantics)."""
    rng = random.Random(seed)
    grid_keys = [k for k, v in param_space.items()
                 if isinstance(v, GridSearch)]
    grid_values = [param_space[k].values for k in grid_keys]
    variants = []
    for _ in range(num_samples):
        for combo in itertools.product(*grid_values) if grid_keys else [()]:
            cfg = {}
            for k, v in param_space.items():
                if isinstance(v, GridSearch):
                    cfg[k] = combo[grid_keys.index(k)]
                elif isinstance(v, Domain):
                    cfg[k] = v.sample(rng)
                elif isinstance(v, dict):
                    cfg[k] = generate_variants(v, 1, rng.randrange(1 << 30))[0]
                else:
                    cfg[k] = v
            variants.append(cfg)
    return variants


# ---------------------------------------------------------------------------
# TPE searcher (native BayesOpt-lite; reference role: tune/search/hyperopt &
# bayesopt integrations — external libs aren't available in this image, so
# the searcher itself is implemented here, numpy-only)
# ---------------------------------------------------------------------------

class TPESearch:
    """Tree-structured Parzen Estimator over flat Domain param spaces.

    After ``n_initial`` random draws, observations split into good (top
    ``gamma`` fraction by the objective) and bad; numeric dims model both
    sets with Gaussian KDEs, categorical dims with smoothed counts;
    ``n_candidates`` samples from the good model are ranked by the
    acquisition l(x)/g(x) (Bergstra et al. 2011) and the best becomes the
    next suggestion. Grid axes are unsupported (use the default
    generator for grids).
    """

    def __init__(self, n_initial: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: int = 0):
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self.param_space: dict = {}
        self.metric: Optional[str] = None
        self.mode = "max"
        self._obs: list[tuple[dict, float]] = []

    def setup(self, param_space: dict, metric: Optional[str], mode: str):
        for k, v in param_space.items():
            if isinstance(v, GridSearch):
                raise ValueError(
                    "TPESearch does not combine with grid_search axes")
        self.param_space = param_space
        self.metric = metric
        self.mode = mode

    # -- observation -----------------------------------------------------

    def on_trial_complete(self, config: dict, metrics: dict) -> None:
        if not self.metric or self.metric not in metrics:
            return
        score = float(metrics[self.metric])
        if self.mode == "min":
            score = -score
        self._obs.append((config, score))

    # -- suggestion ------------------------------------------------------

    def suggest(self) -> dict:
        if len(self._obs) < self.n_initial:
            return self._random_config()
        ranked = sorted(self._obs, key=lambda o: -o[1])
        n_good = max(1, int(len(ranked) * self.gamma))
        good = [c for c, _ in ranked[:n_good]]
        bad = [c for c, _ in ranked[n_good:]] or good
        best, best_score = None, None
        for _ in range(self.n_candidates):
            cand = {}
            score = 0.0
            for k, dom in self.param_space.items():
                if not isinstance(dom, Domain):
                    cand[k] = dom
                    continue
                v, s = self._sample_dim(k, dom, good, bad)
                cand[k] = v
                score += s
            if best_score is None or score > best_score:
                best, best_score = cand, score
        return best if best is not None else self._random_config()

    def _random_config(self) -> dict:
        return {k: (v.sample(self.rng) if isinstance(v, Domain) else v)
                for k, v in self.param_space.items()}

    def _sample_dim(self, key, dom, good, bad):
        """Sample one dimension from the good model; returns
        (value, log l(x) - log g(x))."""
        import math as m
        gvals = [c[key] for c in good if key in c]
        bvals = [c[key] for c in bad if key in c]
        if isinstance(dom, Categorical):
            cats = dom.categories
            gw = [1.0 + sum(1 for v in gvals if v == c) for c in cats]
            bw = [1.0 + sum(1 for v in bvals if v == c) for c in cats]
            tot = sum(gw)
            r = self.rng.random() * tot
            acc = 0.0
            idx = 0
            for i, w in enumerate(gw):
                acc += w
                if r <= acc:
                    idx = i
                    break
            v = cats[idx]
            return v, m.log(gw[idx] / sum(gw)) - m.log(bw[idx] / sum(bw))
        # numeric: KDE in (possibly log-) space
        logspace = isinstance(dom, LogUniform)

        def xform(x):
            return m.log(x) if logspace else float(x)

        gx = [xform(v) for v in gvals] or [xform(dom.sample(self.rng))]
        bx = [xform(v) for v in bvals] or gx
        lo, hi = (xform(dom.low), xform(dom.high)) if hasattr(dom, "low") \
            else (min(gx + bx), max(gx + bx))
        span = max(hi - lo, 1e-12)

        def scott_bw(pts):
            # Scott's rule with a floor so degenerate clusters still
            # explore a little
            n = len(pts)
            mean = sum(pts) / n
            std = (sum((p - mean) ** 2 for p in pts) / n) ** 0.5
            return max(std * n ** -0.2, span * 0.02)

        bw_g = scott_bw(gx)
        bw_b = scott_bw(bx)
        center = self.rng.choice(gx)
        x = self.rng.gauss(center, bw_g)
        x = min(max(x, lo), hi)

        def kde(pts, bw, x):
            return sum(m.exp(-0.5 * ((x - p) / bw) ** 2) / bw
                       for p in pts) / len(pts) + 1e-12

        score = m.log(kde(gx, bw_g, x)) - m.log(kde(bx, bw_b, x))
        v = m.exp(x) if logspace else x
        if isinstance(dom, QRandInt):
            # quantize, then respect the domain's inclusive-low/exclusive-
            # high contract (RandInt.sample uses randrange semantics)
            v = int(round(round(v / dom.q) * dom.q))
            v = min(max(v, dom.low), dom.high - 1)
        elif isinstance(dom, RandInt):
            v = min(max(int(round(v)), dom.low), dom.high - 1)
        elif isinstance(dom, QUniform):
            v = min(max(round(v / dom.q) * dom.q, dom.low), dom.high)
        return v, score


class BOHBSearch(TPESearch):
    """BOHB's model half (reference: tune/search/bohb/ — TPE conditioned
    on budget, Falkner et al. 2018): observations are tagged with the
    budget (training_iteration) they were measured at, and suggestions
    come from the model built at the LARGEST budget that has enough
    observations — low-budget rung results guide early sampling, full-
    budget results dominate once available. Pair with
    schedulers.HyperBandForBOHB."""

    def __init__(self, n_initial: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: int = 0,
                 budget_attr: str = "training_iteration"):
        super().__init__(n_initial=n_initial, gamma=gamma,
                         n_candidates=n_candidates, seed=seed)
        self.budget_attr = budget_attr
        self._budget_obs: dict[int, list[tuple[dict, float]]] = {}

    def on_trial_complete(self, config: dict, metrics: dict) -> None:
        if not self.metric or self.metric not in metrics:
            return
        score = float(metrics[self.metric])
        if self.mode == "min":
            score = -score
        budget = int(metrics.get(self.budget_attr, 0))
        self._budget_obs.setdefault(budget, []).append((config, score))
        # total count drives the random-vs-model switch in suggest()
        self._obs.append((config, score))

    def suggest(self) -> dict:
        if len(self._obs) < self.n_initial:
            return self._random_config()
        # model the largest budget with enough points (>= 4); pool
        # smaller budgets in if the largest alone is too thin
        budgets = sorted(self._budget_obs, reverse=True)
        pool: list[tuple[dict, float]] = []
        for b in budgets:
            pool = self._budget_obs[b] + pool
            if len(self._budget_obs[b]) >= 4:
                pool = self._budget_obs[b]
                break
        saved = self._obs
        try:
            self._obs = pool if len(pool) >= 2 else saved
            return super().suggest()
        finally:
            self._obs = saved
