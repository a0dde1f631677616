"""Stage actors: the long-lived workers of a streaming pipeline.

Each stage worker executes ONE ``run_loop`` actor call for the whole
pipeline run (the Sebulba shape — rl/podracer/sebulba.py): blocks flow
in over sealed-ring edges, through the stage's operator plus any fused
block fns, and out over the next edge, shm-to-shm, with **zero control
dispatches per block** in steady state. The only actor calls a pipeline
ever issues are the one loop start per worker and (on abort) nothing —
teardown rides the shared stop flag.

Stage kinds:

* ``source`` — no input edge; executes its share of read tasks (or
  fetches its share of pre-materialized block refs) in plan order and
  emits ``(idx, block)``. Worker ``w`` of ``W`` owns idxs ``w (mod W)``
  — the stripe-sender contract downstream ordered receivers rely on.
* ``pool`` — the streaming ActorPoolMapOperator: constructs the user's
  callable class ONCE (model load / warm-up paid once), then maps
  its stripe of blocks through it in order. Pool feeds are
  deterministic (worker ``w`` owns idxs ``w (mod W)``) rather than
  work-stealing: that is what keeps the credit graph deadlock-free and
  the output bit-identical — a slow block head-of-lines its own worker
  only, the same profile as the task executor's plan-order delivery.
* ``repartition`` — the one materializing stage: an all-to-all by
  definition, it must see every input block before emitting output
  block 0. Splits each arriving block contiguously as it arrives
  (arrow slices are cheap views) and concatenates at end-of-stream —
  the exact math of the task executor's repartition(shuffle=False), so
  results stay bit-identical.
* ``zip`` — two ordered input edges; aligns row ranges and emits
  column-concatenated chunks as soon as BOTH sides have rows, holding
  only the rate-mismatch carry (bounded by the edges' credit windows).
  Error-path divergence from the task executor, on purpose: mismatched
  row counts raise at END of stream (after the aligned prefix already
  flowed downstream), because a streaming zip cannot know totals up
  front without materializing both sides — the task executor counts
  both materialized sides first and raises before yielding anything.
  Success-path results are bit-identical.

A worker that hits an error lets the exception fly: the run_loop ref
fails, the driver's idle probe surfaces it within a wait slice and
seals the stop flag, and every other parked worker unwinds through
ChannelClosed. On abort each worker sweeps its own channel windows, so
the store returns to its pre-pipeline object count.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

from ...core import flight
from ...dag.channel import ChannelClosed
from .channels import BlockReceiver, BlockSender, EdgeSpec


@dataclasses.dataclass
class StageSpec:
    """Everything one stage worker needs, pickled into its single
    run_loop call (fns ride the blob, edges are plain id bases)."""

    kind: str                 # "source" | "pool" | "repartition" | "zip"
    idx: int                  # stage position in the pipeline (flight)
    width: int                # workers in this stage
    fused: list               # block fns applied to every emitted block
    in_edges: list            # [] | [EdgeSpec] | [left, right] for zip
    in_modes: list            # receiver mode per in edge
    out_edge: EdgeSpec
    out_mode: str             # "stripe" | "steal"
    payload: Any              # per kind, see _run_* below


def _apply_fused(fused, block):
    for fn in fused:
        block = fn(block)
    return block


def run_stage_loop(spec: StageSpec, worker_idx: int) -> dict:
    """The one long-lived task per (stage, worker) slot. A task — not an
    actor — on purpose: it runs on the shared worker pool, so a finished
    pipeline returns its workers to the pool intact (no per-run process
    churn, and the workers' flight-recorder rings survive for `cli
    timeline`), while a wedged stage is still force-reapable via
    ``ray.cancel(ref, force=True)``. Spawned with max_retries=0: a
    retried loop would replay rings whose cursors moved."""
    return PipelineStageWorker().run_loop(spec, worker_idx)


class PipelineStageWorker:
    """Stage worker body; its whole life is one ``run_loop`` call."""

    def run_loop(self, spec: StageSpec, worker_idx: int) -> dict:
        from ...core import runtime as rt_mod
        if os.environ.get("RTPU_OWN_STORE") == "1":
            # this worker's store is NOT the head's shm segment: slots
            # sealed here would be invisible to the pipeline's consumers
            # (the queue.py RolloutProducer contract). Raise — the
            # driver's idle probe surfaces this within a wait slice —
            # rather than wedge every consumer on never-sealed slots.
            raise RuntimeError(
                "streaming stage landed on an own-store node; sealed "
                "channels need the cluster's shared shm store — pin "
                "the pipeline to the head node or set "
                "DataContext.streaming_executor='off'")
        rt = rt_mod.get_runtime_if_exists()
        store = getattr(rt, "store", None)
        if store is None:
            raise RuntimeError(
                "streaming stage needs a shared shm object store "
                "(own-store nodes can't join a pipeline)")
        sender = BlockSender(store, spec.out_edge, worker_idx,
                             spec.out_mode)
        # consumer slot = worker index: stage worker w owns idxs
        # w (mod width) on its input edge (width-1 stages are slot 0)
        receivers = [BlockReceiver(store, e, worker_idx, mode=m)
                     for e, m in zip(spec.in_edges, spec.in_modes)]
        flight.evt(flight.DATA_STAGE_BEGIN, spec.idx, worker_idx)
        blocks = 0
        aborted = False
        try:
            runner = getattr(self, f"_run_{spec.kind}")
            blocks = runner(spec, worker_idx, receivers, sender)
            sender.finish()
        except ChannelClosed:
            aborted = True   # teardown: stop flag sealed mid-wait
        except BaseException:
            aborted = True
            # a failed stage dooms the WHOLE pipeline: seal the stop
            # flag so every parked consumer (including split shards in
            # other processes, which have no driver probe) wakes within
            # one wait slice instead of waiting out its timeout; the
            # driver still surfaces THIS error through the failed ref
            try:
                from ...dag.channel import signal_stop
                signal_stop(store, spec.out_edge.stop_oid())
            except Exception:
                pass  # store closing; consumers die with it
            raise            # driver's probe surfaces this ref's error
        finally:
            if aborted or sender.closed():
                sender.sweep()
                for r in receivers:
                    r.sweep()
            flight.evt(flight.DATA_STAGE_END, spec.idx, blocks)
        return {"blocks": blocks, "worker": worker_idx}

    # -- stage kinds ---------------------------------------------------- #

    def _run_source(self, spec, worker_idx, receivers, sender) -> int:
        kind, items = spec.payload
        n = 0
        for k in range(worker_idx, len(items), spec.width):
            if kind == "tasks":
                block = items[k]()
            else:                      # "refs": pre-materialized blocks
                import ray_tpu_torch
                block = ray_tpu_torch.get(items[k])
            block = _apply_fused(spec.fused, block)
            flight.evt(flight.DATA_BLOCK, spec.idx, k)
            sender.send(k, block)
            n += 1
        return n

    def _run_pool(self, spec, worker_idx, receivers, sender) -> int:
        import cloudpickle
        cls, args, kwargs, wrap = cloudpickle.loads(spec.payload)
        fn = cls(*args, **kwargs) if isinstance(cls, type) else cls
        recv = receivers[0]
        n = 0
        while True:
            got = recv.next_block()
            if got is None:
                return n
            idx, block = got
            out = _apply_fused(spec.fused, wrap(fn, block))
            flight.evt(flight.DATA_BLOCK, spec.idx, idx)
            sender.send(idx, out)
            n += 1

    def _run_repartition(self, spec, worker_idx, receivers, sender) -> int:
        from .. import block as B
        from ..executor import _split_for_exchange
        n_out = int(spec.payload)
        recv = receivers[0]
        parts: list = []          # per input block: tuple of n_out slices
        while True:
            got = recv.next_block()
            if got is None:
                break
            parts.append(_split_for_exchange(got[1], n_out, False, 0))
        for j in range(n_out):
            out = B.concat([p[j] for p in parts]) if parts \
                else B.concat([])
            out = _apply_fused(spec.fused, out)
            flight.evt(flight.DATA_BLOCK, spec.idx, j)
            sender.send(j, out)
        return n_out

    def _run_zip(self, spec, worker_idx, receivers, sender) -> int:
        from .. import block as B
        left, right = receivers
        lbuf = rbuf = None            # rate-mismatch carry per side
        ldone = rdone = False
        ltotal = rtotal = 0           # rows seen per side (error report)
        out_idx = 0

        def rows(b) -> int:
            return b.num_rows if b is not None else 0

        while not (ldone and rdone):
            if rows(lbuf) == 0 and not ldone:
                got = left.next_block()
                if got is None:
                    ldone = True
                else:
                    ltotal += got[1].num_rows
                    lbuf = got[1]
                continue
            if rows(rbuf) == 0 and not rdone:
                got = right.next_block()
                if got is None:
                    rdone = True
                else:
                    rtotal += got[1].num_rows
                    rbuf = got[1]
                continue
            take = min(rows(lbuf), rows(rbuf))
            if take == 0:
                break   # one side ended while the other still has rows
            from ..executor import zip_blocks
            lchunk = B.slice_block(lbuf, 0, take)
            rchunk = B.slice_block(rbuf, 0, take)
            lbuf = B.slice_block(lbuf, take, rows(lbuf))
            rbuf = B.slice_block(rbuf, take, rows(rbuf))
            out = _apply_fused(spec.fused, zip_blocks(lchunk, rchunk))
            flight.evt(flight.DATA_BLOCK, spec.idx, out_idx)
            sender.send(out_idx, out)
            out_idx += 1
        # drain whatever is left (counts only) so a length mismatch
        # reports the true totals, like the task executor's up-front check
        while not ldone:
            got = left.next_block()
            if got is None:
                ldone = True
            else:
                ltotal += got[1].num_rows
        while not rdone:
            got = right.next_block()
            if got is None:
                rdone = True
            else:
                rtotal += got[1].num_rows
        if ltotal != rtotal:
            raise ValueError(f"zip requires equal row counts ({ltotal} "
                             f"vs {rtotal})")
        return out_idx


