"""Data-plane telemetry: rtpu_data_* metrics + metrics_summary().

The dispatch-economy proof for the streaming executor, shaped exactly
like rtpu_rl_* (bench_rl) and the serve stream counters (bench_serve
--decode-plan): both executors count the control dispatches they issue
and the blocks they deliver, so ``dispatches_per_block`` is
counter-verified per path instead of inferred.

Metric names and label sets:
  rtpu_data_blocks_total{path}         counter — blocks delivered to the
      consumer (path=chan: streaming pipeline sink; path=task: the
      task-per-block executor's per-block yield)
  rtpu_data_dispatches_total{path}     counter — control-plane calls
      issued to move blocks: ONE run_loop call per stage worker for the
      streaming path (steady state adds none), one task submission per
      block for the task path. The headline ratio
      dispatches/block -> ~0 streaming, >= 1 task.
  rtpu_data_backpressure_waits_total   counter — times a stage sender
      found every consumer ring at its credit limit and parked (the
      bounded-memory proof under skew: blocks park in rings, not in the
      store)
  rtpu_data_queue_depth                gauge — sealed-but-unread blocks
      at the sink's rings (sampled while the consumer iterates)

``metrics_summary()`` condenses the merged store into the numbers a run
report cites; ``state.summary()["data"]`` exposes the same rollup.
"""
from __future__ import annotations

from ...util.metrics import (Counter, Gauge, cached_metric as _metric,
                             collect_store as _collect_store)


def blocks() -> Counter:
    return _metric(Counter, "rtpu_data_blocks_total",
                   "dataset blocks delivered to the consumer",
                   tag_keys=("path",))


def dispatches() -> Counter:
    return _metric(Counter, "rtpu_data_dispatches_total",
                   "control-plane calls issued to move dataset blocks",
                   tag_keys=("path",))


def backpressure_waits() -> Counter:
    return _metric(Counter, "rtpu_data_backpressure_waits_total",
                   "stage senders parked at the ring credit limit")


def queue_depth() -> Gauge:
    return _metric(Gauge, "rtpu_data_queue_depth",
                   "sealed-but-unread blocks at the pipeline sink")


def note_backpressure() -> None:
    try:
        backpressure_waits().inc(1.0)
    except Exception:
        pass  # telemetry must never fail the data plane


def note_blocks(n: float, path: str) -> None:
    try:
        blocks().inc(n, tags={"path": path})
    except Exception:
        pass  # telemetry must never fail the data plane


def note_dispatches(n: float, path: str) -> None:
    try:
        dispatches().inc(n, tags={"path": path})
    except Exception:
        pass  # telemetry must never fail the data plane


def note_depth(d: float) -> None:
    try:
        queue_depth().set(d)
    except Exception:
        pass  # telemetry must never fail the data plane


def _by_tag(rec, tag: str) -> dict:
    out: dict = {}
    for key, val in (rec or {}).get("series", {}).items():
        label = next((v for k, v in key if k == tag), "")
        out[label] = out.get(label, 0.0) + val
    return out


def metrics_summary() -> dict:
    """Per-path block/dispatch totals with the dispatches_per_block
    headline, plus backpressure-wait totals and the last sampled sink
    depth. Store merge is the util/metrics helper every other summary
    uses."""
    store = _collect_store()
    out: dict = {}
    blks = _by_tag(store.get("rtpu_data_blocks_total"), "path")
    disp = _by_tag(store.get("rtpu_data_dispatches_total"), "path")
    if blks or disp:
        paths: dict = {}
        for p in set(blks) | set(disp):
            rec = {"blocks": blks.get(p, 0.0),
                   "dispatches": disp.get(p, 0.0)}
            if rec["blocks"]:
                rec["dispatches_per_block"] = (
                    rec["dispatches"] / rec["blocks"])
            paths[p] = rec
        out["path"] = paths
    bp = _by_tag(store.get("rtpu_data_backpressure_waits_total"), "")
    if bp:
        out["backpressure_waits"] = sum(bp.values())
    rec = store.get("rtpu_data_queue_depth")
    if rec and rec["series"]:
        out["queue_depth"] = max(rec["series"].values())
    return out
