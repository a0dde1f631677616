"""Optuna searcher adapter for Tune.

The port's copy of ``ray_tpu/tune/optuna_search.py``.
Reference parity: python/ray/tune/search/optuna/optuna_search.py
(OptunaSearch — maps the Tune param_space onto optuna distributions and
drives a Study through its ask/tell interface). Soft dependency: optuna
imports lazily at setup(); constructing the class without optuna
installed raises ImportError with an actionable message, mirroring the
reference's missing-dependency behavior.
"""
from __future__ import annotations

from typing import Optional

from .search import (Categorical, Domain, GridSearch, LogUniform, QRandInt,
                     QUniform, RandInt, Uniform)


def _to_distribution(dom: Domain):
    """One Tune domain -> optuna distribution (reference:
    optuna_search.py convert_search_space)."""
    import optuna.distributions as od
    if isinstance(dom, Categorical):
        return od.CategoricalDistribution(dom.categories)
    if isinstance(dom, LogUniform):
        import math
        return od.FloatDistribution(math.exp(dom.lo), math.exp(dom.hi),
                                    log=True)
    if isinstance(dom, QUniform):
        return od.FloatDistribution(dom.low, dom.high, step=dom.q)
    if isinstance(dom, QRandInt):
        return od.IntDistribution(dom.low, dom.high - 1, step=dom.q)
    if isinstance(dom, RandInt):
        return od.IntDistribution(dom.low, dom.high - 1)
    if isinstance(dom, Uniform):
        return od.FloatDistribution(dom.low, dom.high)
    raise ValueError(f"cannot express {type(dom).__name__} as an optuna "
                     f"distribution")


class OptunaSearch:
    """Tune Searcher over an optuna Study (ask/tell).

    Usage matches the native searchers::

        tuner = Tuner(trainable, param_space={...},
                      tune_config=TuneConfig(metric="loss", mode="min",
                                             search_alg=OptunaSearch()))
    """

    def __init__(self, sampler=None, seed: Optional[int] = None,
                 study_name: str = "rtpu"):
        try:
            import optuna  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "OptunaSearch requires the 'optuna' package "
                "(pip install optuna)") from e
        self._sampler = sampler
        self._seed = seed
        self._study_name = study_name
        self._study = None
        self._dists: dict = {}
        self._fixed: dict = {}
        self._live: dict = {}   # frozen config tuple -> optuna trial
        self.metric: Optional[str] = None
        self.mode = "max"

    def setup(self, param_space: dict, metric: Optional[str], mode: str):
        import optuna
        for k, v in param_space.items():
            if isinstance(v, GridSearch):
                raise ValueError(
                    "OptunaSearch does not combine with grid_search axes")
        self.metric = metric
        self.mode = mode
        self._dists = {k: _to_distribution(v)
                       for k, v in param_space.items()
                       if isinstance(v, Domain)}
        self._fixed = {k: v for k, v in param_space.items()
                       if not isinstance(v, Domain)}
        sampler = self._sampler or optuna.samplers.TPESampler(
            seed=self._seed)
        optuna.logging.set_verbosity(optuna.logging.WARNING)
        self._study = optuna.create_study(
            study_name=self._study_name, sampler=sampler,
            direction="minimize" if mode == "min" else "maximize")

    @staticmethod
    def _key(config: dict) -> tuple:
        return tuple(sorted((k, repr(v)) for k, v in config.items()))

    def suggest(self) -> dict:
        trial = self._study.ask(self._dists)
        config = {**self._fixed, **trial.params}
        self._live[self._key(config)] = trial
        return config

    def on_trial_complete(self, config: dict, metrics: dict) -> None:
        if not self.metric or self.metric not in metrics:
            return
        trial = self._live.pop(self._key(config), None)
        if trial is None:
            return  # a config optuna didn't propose (e.g. initial grid)
        import optuna
        self._study.tell(trial, float(metrics[self.metric]),
                         state=optuna.trial.TrialState.COMPLETE)
