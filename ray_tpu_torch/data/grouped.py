"""GroupedData aggregations (reference parity: python/ray/data/grouped_data.py
— count/sum/min/max/mean/std plus map_groups), executed as a hash-partition
exchange + per-partition pandas aggregation."""
from __future__ import annotations

from typing import Callable

from .dataset import Dataset
from .executor import Exchange


def _agg_named(ops: list[tuple[str, str]]):
    """ops: [(column, op_name)] -> fn(groupby) -> DataFrame."""
    def fn(gb):
        spec = {}
        for col, op in ops:
            spec[f"{op}({col})"] = (col, op)
        return gb.agg(**spec).reset_index()
    return fn


def _count_fn(gb):
    return gb.size().to_frame("count()").reset_index()


class GroupedData:
    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _exchange(self, agg_fn) -> Dataset:
        return Dataset(Exchange([self._ds._plan], "groupby", key=self._key,
                                agg_fn=agg_fn), self._ds._ctx)

    def count(self) -> Dataset:
        return self._exchange(_count_fn)

    def sum(self, col: str) -> Dataset:
        return self._exchange(_agg_named([(col, "sum")]))

    def min(self, col: str) -> Dataset:
        return self._exchange(_agg_named([(col, "min")]))

    def max(self, col: str) -> Dataset:
        return self._exchange(_agg_named([(col, "max")]))

    def mean(self, col: str) -> Dataset:
        return self._exchange(_agg_named([(col, "mean")]))

    def std(self, col: str) -> Dataset:
        return self._exchange(_agg_named([(col, "std")]))

    def aggregate(self, **named_ops: tuple[str, str]) -> Dataset:
        """aggregate(total=("value", "sum"), lo=("value", "min"))"""
        def fn(gb):
            return gb.agg(**named_ops).reset_index()
        return self._exchange(fn)

    def map_groups(self, fn: Callable) -> Dataset:
        """fn(pandas.DataFrame) -> DataFrame, applied per group."""
        def agg(gb):
            import pandas as pd
            frames = [fn(g) for _, g in gb]
            out = pd.concat(frames) if frames else pd.DataFrame()
            # match the exchange contract: reset_index is applied by caller,
            # so hand back something with a trivial index
            return out.reset_index(drop=True)
        return self._exchange(agg)
