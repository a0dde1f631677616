"""``ray_tpu_torch.data`` against the JAX package's ``ray_tpu.data``.

The same plans, on the same inputs made from a seed with numpy, run under
each package's runtime (``init(num_cpus=2)``), one after the other in
this process: the reference first, then the port. Each case compares
one plan's result.

- Rows are compared exactly (values and dtypes, as Python or numpy
  scalars), in order wherever the plan orders them: reads, fused map
  chains, ``flat_map``, ``filter``, ``repartition``,
  ``random_shuffle(seed)`` (a seeded exchange is deterministic),
  ``sort``, ``zip``, ``union``, ``train_test_split``, ``iter_batches``
  with and without ``local_shuffle_seed``. Where the reference's own
  tests sort (``groupby``, ``join``, the shards of ``streaming_split``,
  whose cut between shards is work-stealing, and files read back), the
  rows are compared as sorted multisets.
- Float aggregates (``sum``, ``mean``, ``std`` per group) run the same
  pandas code on the same partitions in both packages, so they are
  compared bit for bit too; no tolerance is needed.
- ``iter_device_batches(device="cpu")`` is held to the reference's
  ``iter_jax_batches`` (values as numpy, ``drop_last=True`` in both).

The plans' functions are made inside ``_plans``, so they pickle by value
and a worker of either runtime never imports this module.
"""
import os

import numpy as np
import pytest

SEED = 20261018


def _norm(v):
    if isinstance(v, np.ndarray):
        return (str(v.dtype), v.shape, v.tobytes())
    if isinstance(v, np.generic):
        return (str(v.dtype), v.item())
    return (type(v).__name__, v)


def _rows(rows) -> list:
    return [tuple(sorted((k, _norm(v)) for k, v in r.items()))
            for r in rows]


def _batches(batches) -> list:
    return [tuple(sorted((k, _norm(np.asarray(v))) for k, v in b.items()))
            for b in batches]


def _plans(pkg: str, tmp: str) -> dict:
    """name -> thunk giving the plan's result under package ``pkg``."""
    import importlib
    data = importlib.import_module(pkg + ".data")
    DataContext = importlib.import_module(pkg + ".data.context").DataContext
    rng = np.random.RandomState(SEED)
    arr = rng.standard_normal((48, 6)).astype(np.float32)
    items = [{"a": int(rng.randint(0, 1000)), "b": f"s{i % 7}",
              "c": float(rng.standard_normal())} for i in range(60)]
    perm = [int(x) for x in rng.permutation(80)]
    groups = [{"g": f"k{int(rng.randint(0, 5))}",
               "v": float(rng.standard_normal()),
               "n": int(rng.randint(0, 100))} for _ in range(120)]
    left = [{"id": int(i), "x": int(rng.randint(0, 50))}
            for i in rng.permutation(40)]
    right = [{"id": int(i), "y": float(rng.standard_normal())}
             for i in rng.permutation(np.arange(20, 60))]

    def split(transport):
        def run():
            ctx = DataContext.get_current()
            saved = (ctx.split_transport, ctx.streaming_executor)
            ctx.split_transport = transport
            ctx.streaming_executor = "force" if transport == "chan" \
                else saved[1]
            try:
                shards = data.range(90, override_num_blocks=9) \
                    .map_batches(lambda b: {"id": b["id"],
                                            "sq": b["id"] * b["id"]}) \
                    .streaming_split(2)
                got = [list(s.iter_rows()) for s in shards]
            finally:
                ctx.split_transport, ctx.streaming_executor = saved
            return sorted(_rows(got[0] + got[1]))
        return run

    def written(fmt):
        def run():
            out = os.path.join(tmp, pkg, fmt)
            ds = data.from_items(items, override_num_blocks=3)
            paths = getattr(ds, f"write_{fmt}")(out)
            back = getattr(data, f"read_{fmt}")(out)
            return ([os.path.relpath(p, out) for p in paths],
                    sorted(_rows(back.take_all())))
        return run

    def tts():
        ds = data.range(100, override_num_blocks=3)
        a, b = ds.train_test_split(0.2)
        c, d = ds.train_test_split(0.5, shuffle=True, seed=7)
        return [_rows(x.take_all()) for x in (a, b, c, d)]

    def device_batches():
        ds = data.from_numpy(arr, override_num_blocks=4)
        if pkg == "ray_tpu":
            it = ds.iter_jax_batches(batch_size=10)
        else:
            it = ds.iter_device_batches(batch_size=10, device="cpu")
        return _batches(it)

    return {
        "range": lambda: _rows(
            data.range(100, override_num_blocks=7).take_all()),
        "from_numpy": lambda: _batches(
            data.from_numpy(arr, override_num_blocks=4)
            .iter_batches(batch_size=None)),
        "from_items": lambda: _rows(
            data.from_items(items, override_num_blocks=5).take_all()),
        "fused_map_chain": lambda: _rows(
            data.range(200, override_num_blocks=8)
            .map_batches(lambda b: {"id": b["id"] * 3,
                                    "sq": b["id"] * b["id"]})
            .map(lambda r: {"id": r["id"] + 1, "sq": r["sq"]})
            .filter(lambda r: r["sq"] % 3 != 0).take_all()),
        "flat_map": lambda: _rows(
            data.from_items(items, override_num_blocks=4)
            .flat_map(lambda r: [{"a": r["a"]}, {"a": -r["a"]}])
            .take_all()),
        "filter": lambda: _rows(
            data.from_items(items, override_num_blocks=4)
            .filter(lambda r: r["c"] > 0).take_all()),
        "repartition": lambda: [
            _batches(data.range(100, override_num_blocks=6).repartition(4)
                     .iter_batches(batch_size=None))],
        "random_shuffle": lambda: _rows(
            data.range(200, override_num_blocks=5).random_shuffle(seed=7)
            .take_all()),
        "sort": lambda: [
            _rows(data.from_items([{"k": k} for k in perm],
                                  override_num_blocks=4)
                  .sort("k", descending=desc).take_all())
            for desc in (False, True)],
        "groupby_aggregate": lambda: sorted(_rows(
            data.from_items(groups, override_num_blocks=4).groupby("g")
            .aggregate(total=("v", "sum"), lo=("v", "min"),
                       hi=("n", "max"), mean=("v", "mean"),
                       std=("v", "std")).take_all())),
        "groupby_count": lambda: sorted(_rows(
            data.from_items(groups, override_num_blocks=4).groupby("g")
            .count().take_all())),
        "join": lambda: sorted(_rows(
            data.from_items(left, override_num_blocks=3)
            .join(data.from_items(right, override_num_blocks=2), on="id",
                  num_partitions=3).take_all())),
        "zip": lambda: _rows(
            data.range(50, override_num_blocks=5)
            .zip(data.range(50, override_num_blocks=4)
                 .map(lambda r: {"y": r["id"] * 3})).take_all()),
        "union": lambda: _rows(
            data.range(20, override_num_blocks=2)
            .union(data.from_items(
                [{"id": np.int64(-i)} for i in range(10)])).take_all()),
        "train_test_split": tts,
        "iter_batches": lambda: _batches(
            data.range(100, override_num_blocks=6)
            .iter_batches(batch_size=32)),
        "iter_batches_local_shuffle": lambda: _batches(
            data.range(300, override_num_blocks=6)
            .iter_batches(batch_size=32, local_shuffle_buffer_size=50,
                          local_shuffle_seed=3)),
        "streaming_split_actor": split("actor"),
        "streaming_split_chan": split("chan"),
        "parquet": written("parquet"),
        "csv": written("csv"),
        "json": written("json"),
        "iter_device_batches": device_batches,
    }


PLANS = [
    "range", "from_numpy", "from_items", "fused_map_chain", "flat_map",
    "filter", "repartition", "random_shuffle", "sort",
    "groupby_aggregate", "groupby_count", "join", "zip", "union",
    "train_test_split", "iter_batches", "iter_batches_local_shuffle",
    "streaming_split_actor", "streaming_split_chan", "parquet", "csv",
    "json", "iter_device_batches"]


def _run_all(pkg: str, tmp: str) -> dict:
    import importlib
    rt = importlib.import_module(pkg)
    for other in ("ray_tpu", "ray_tpu_torch"):
        p = importlib.import_module(other)
        if p.is_initialized():
            p.shutdown()
    rt.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    out = {}
    try:
        plans = _plans(pkg, tmp)
        assert sorted(plans) == sorted(PLANS)
        for name in PLANS:
            try:
                out[name] = ("ok", plans[name]())
            except Exception as e:  # noqa: BLE001 — reported per case
                out[name] = ("error", f"{type(e).__name__}: {e}")
    finally:
        rt.shutdown()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax  # noqa: F401 — the reference's iter_jax_batches needs it
    tmp = str(tmp_path_factory.mktemp("data_agreement"))
    return _run_all("ray_tpu", tmp), _run_all("ray_tpu_torch", tmp)


@pytest.mark.parametrize("plan", PLANS)
def test_plan_rows_equal_the_reference(runs, plan):
    ref, port = runs
    assert ref[plan][0] == "ok", ref[plan]
    assert port[plan] == ref[plan]
