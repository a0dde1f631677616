"""Streaming physical executor: compile a logical plan into stage
actors wired by sealed-ring edges, drive it from the consumer side.

The Ray Data streaming_executor.py analog, rebuilt on the substrate PRs
5/6 proved out (sealed channels, credit backpressure, one long-lived
actor call per worker) instead of per-block tasks:

* ``compile_plan`` walks the same logical plan the task executor runs
  and splits it into stages: fused block-op chains ride whichever stage
  produces their input (a map/filter/flat_map pipeline still costs ZERO
  extra stages), ``ActorPoolOp`` becomes a fixed-width pool stage,
  ``repartition``/``zip`` become width-1 stages, and any other exchange
  (shuffle/sort/groupby/limit/union/join) is a **plan split**: the
  subtree below it runs on the task executor (all-to-all barriers want
  task semantics) and its materialized blocks feed the pipeline as a
  source.
* ``StreamingPipeline`` owns a run: it resolves plan-split sources,
  mints the edge id bases and the pipeline-wide stop flag, spawns the
  stage actors (ONE ``run_loop`` call each — the only control
  dispatches of the run, counter-verified via rtpu_data_*), and
  iterates the sink edge. Block payloads never touch the control plane:
  producer seals shm slot, consumer futex-wakes, zero-copy read.
* Teardown: the driver seals the stop flag; every parked worker wakes
  with ChannelClosed, sweeps its channel windows and exits, and the
  store returns to its pre-pipeline object count (the channels' contract).
  A stage worker that dies mid-run fails its run_loop ref; the driver's
  idle probe (every wait slice) surfaces the original error promptly
  and tears the rest down.

Delivery order matches the task executor's plan-order contract, so
results are bit-identical across the supported op matrix — the
``streaming_executor="auto"`` default can sit behind the existing
Dataset API without consumers noticing anything but the dispatch bill.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Optional

from ...core import flight
from ...core.ids import ObjectID
from ...dag.channel import ChannelClosed, signal_stop
from . import telemetry as tm
from .channels import BlockReceiver, EdgeSpec
from .stage import StageSpec, run_stage_loop


class _StageDraft:
    """Driver-side stage record before edges/widths are final."""

    __slots__ = ("kind", "width", "fused", "payload", "ins")

    def __init__(self, kind: str, width: Optional[int], fused: list,
                 payload: Any, ins: list):
        self.kind = kind
        self.width = width
        self.fused = fused
        self.payload = payload
        self.ins = ins


def compile_plan(plan, ctx) -> Optional[list]:
    """Logical plan -> ordered stage drafts (last = sink producer), or
    None when streaming buys nothing (a bare materialized block list)."""
    from ..executor import (ActorPoolOp, BlockOp, Exchange, InputData,
                            Read)

    stages: list[_StageDraft] = []

    def peel(op):
        chain = []
        node = op
        while isinstance(node, BlockOp):
            chain.append(node)
            node = node.inputs[0]
        return [c.fn for c in reversed(chain)], node

    def build(node) -> int:
        fused, src = peel(node)
        if isinstance(src, Read):
            stages.append(_StageDraft("source", None, fused,
                                      ("tasks", src.read_tasks), []))
        elif isinstance(src, InputData):
            stages.append(_StageDraft("source", None, fused,
                                      ("pairs", src.refs_and_meta), []))
        elif isinstance(src, ActorPoolOp):
            up = build(src.inputs[0])
            # fixed-width pool at the pool's MAX size (the worker-budget
            # clamp in start() shrinks it on small clusters): streaming
            # has no queue-depth autoscaler, and an idle stage worker
            # costs a parked futex wait, not a core — starting at min
            # would silently forfeit the (min,max) pool's throughput
            width = max(1, getattr(src, "max_size", None) or src.size)
            stages.append(_StageDraft("pool", width, fused,
                                      src.fn_blob, [up]))
        elif isinstance(src, Exchange) and src.kind == "repartition" \
                and src.kwargs.get("n"):
            up = build(src.inputs[0])
            stages.append(_StageDraft("repartition", 1, fused,
                                      int(src.kwargs["n"]), [up]))
        elif isinstance(src, Exchange) and src.kind == "zip":
            left = build(src.inputs[0])
            right = build(src.inputs[1])
            stages.append(_StageDraft("zip", 1, fused, None,
                                      [left, right]))
        else:
            # plan split: run the subtree on the task executor, feed its
            # materialized blocks in as a source
            stages.append(_StageDraft("source", None, fused,
                                      ("plan", src), []))
        return len(stages) - 1

    build(plan)
    if len(stages) == 1 and not stages[0].fused:
        kind = stages[0].payload[0]
        if kind in ("pairs", "plan"):
            # no streaming op anywhere: the task executor (or a plain
            # ref iteration) already does this with nothing to amortize
            return None
    return stages


def _local_store():
    from ...core import runtime as rt_mod
    rt = rt_mod.get_runtime_if_exists()
    return getattr(rt, "store", None)


_active_lock = threading.Lock()
_active_workers = 0    # stage workers held by LIVE pipelines in this
#                        driver. guarded by: _active_lock


def _pool_slots() -> int:
    """Total worker processes the pool can run: CPU + 4 per node, minus
    one kept spare for foreign tasks."""
    try:
        import ray_tpu_torch as ray
        return int(ray.cluster_resources().get("CPU", 2)) + 3
    except Exception:
        return 5


def _try_acquire_workers(n: int) -> bool:
    """Atomically claim n worker slots against the live-pipeline total
    (check-then-acquire in ONE lock hold: two pipelines starting
    concurrently must never both see the full budget)."""
    global _active_workers
    total = _pool_slots()
    with _active_lock:
        if _active_workers + n > total:
            return False
        _active_workers += n
        return True


def _release_workers(n: int) -> None:
    global _active_workers
    with _active_lock:
        _active_workers = max(0, _active_workers - n)


def worker_budget() -> int:
    """How many MORE stage workers can run concurrently right now: each
    node's pool spawns at most CPU + 4 worker processes, every stage
    worker occupies one for the whole run, and workers held by other
    live pipelines started from this driver (concurrent or NESTED
    Dataset iteration) are already spoken for."""
    with _active_lock:
        return _pool_slots() - _active_workers


def _detach(err: BaseException) -> BaseException:
    """``err`` without the frames that raised it, nor its causes': the
    frames of a failed ``get`` hold the refs it was given and sit in a
    cycle with the error, so those refs' objects would stay in the store
    until a gc pass, or for as long as a caller keeps the error (a
    REPL's last exception, a test's ``excinfo``). The remote traceback
    rides in the error's message."""
    e = err
    while e is not None:
        e.__traceback__ = None
        e = e.__cause__ or e.__context__
    return err


def _raise_detached(ray, refs: list) -> None:
    """Pop a stage loop's ref off the end of ``refs`` and raise its
    error, if it holds one, detached (``_detach``); no frame of this
    module keeps the ref."""
    ref = refs.pop()
    try:
        ray.get(ref)
        return
    except Exception as e:  # noqa: BLE001 — re-raised below, detached
        err = e
    del ref
    raise _detach(err)


class StreamingPipeline:
    """One streaming run: stage actors + edges + the sink. Create per
    consumption (pipelines are single-shot; a second epoch is a second
    pipeline)."""

    def __init__(self, drafts: list, ctx, consumers: int = 1,
                 split: bool = False):
        self._drafts = drafts
        self._ctx = ctx
        self._consumers = max(1, consumers)
        self._split = split
        self._started = False
        self._shut = False
        self._held_workers = 0
        self._sinks_done = 0   # guarded by: self._probe_lock
        self._probe_lock = threading.Lock()
        self._loop_refs: list = []
        self._hold: list = []    # materialized plan-split pairs (lifetime)
        self._recv: Optional[BlockReceiver] = None
        self._store = None
        self._ray = None
        self._stop: Optional[bytes] = None
        self.sink_edge: Optional[EdgeSpec] = None
        self.sink_mode = "stripe"

    # -- build ----------------------------------------------------------- #

    def start(self) -> "StreamingPipeline":
        if self._started:
            return self
        import ray_tpu_torch as ray
        self._ray = ray
        store = _local_store()
        if store is None:
            raise RuntimeError(
                "streaming executor needs an initialized cluster with a "
                "shared shm object store (local_mode has none)")
        self._store = store
        self._stop = os.urandom(16)
        ctx = self._ctx
        drafts = self._drafts

        # resolve sources: plan splits materialize HERE (the all-to-all
        # barrier), widths become concrete
        resolved: list[tuple] = []   # (kind, payload) per stage
        for d in drafts:
            if d.kind != "source":
                resolved.append((d.kind, d.payload))
                continue
            kind, items = d.payload
            if kind == "plan":
                from ..executor import Executor
                pairs = Executor(ctx).execute(items)
                self._hold.append(pairs)
                kind, items = "refs", [ref for ref, _ in pairs]
            elif kind == "pairs":
                self._hold.append(items)
                kind, items = "refs", [ref for ref, _ in items]
            resolved.append((kind, items))
        widths = []
        for d, (kind, items) in zip(drafts, resolved):
            if d.kind == "source":
                widths.append(max(1, min(ctx.streaming_source_workers,
                                         len(items) or 1)))
            else:
                widths.append(d.width)
        # worker-pool budget: each node spawns at most CPU + 4 worker
        # processes, and every stage worker occupies one for the whole
        # run — a pipeline wider than the pool would park forever on
        # loops the scheduler can never start. Clamp the widest stages
        # down (width is a throughput knob, never a correctness one),
        # keeping one slot spare for foreign tasks.
        # clamp-and-claim loop: the budget snapshot and the claim must
        # agree, and another pipeline may grab slots between them —
        # retry the clamp against the fresh budget until the atomic
        # claim lands (or nothing is claimable even at width 1)
        base_widths = list(widths)
        while True:
            budget = worker_budget()
            widths = list(base_widths)
            while sum(widths) > budget:
                i = max(range(len(widths)), key=widths.__getitem__)
                if widths[i] <= 1:
                    break
                widths[i] -= 1
            if sum(widths) > budget:
                # even width-1 stages outnumber the FREE worker slots:
                # some run_loop could never be scheduled and its
                # consumers would park forever. Fail loudly — "auto"
                # plans this wide never reach here (the factory falls
                # back to the task executor)
                raise RuntimeError(
                    f"streaming pipeline needs {sum(widths)} concurrent "
                    f"stage workers but only {budget} worker slots are "
                    f"free (other live pipelines hold the rest); raise "
                    f"num_cpus or set "
                    f"DataContext.streaming_executor='off'")
            if _try_acquire_workers(sum(widths)):
                self._held_workers = sum(widths)
                break

        try:
            self._wire_and_spawn(ray, drafts, resolved, widths, ctx)
        except BaseException:
            # a failure past the slot claim (an unpicklable user fn,
            # spawn error) must not strand what already exists: release
            # the budget, wake any already-spawned loop via the stop
            # flag, and reap it — shutdown() does all three
            self._started = True
            try:
                self.shutdown(timeout_s=5.0)
            except Exception:
                pass  # best-effort unwind; the original error wins
            raise
        self._started = True
        return self

    def _wire_and_spawn(self, ray, drafts, resolved, widths, ctx) -> None:
        # edges: every stage feeds exactly one consumer (zip consumes
        # two producers); the last stage feeds the sink
        consumer_of = {}
        for i, d in enumerate(drafts):
            for u in d.ins:
                consumer_of[u] = i
        edges: dict[int, EdgeSpec] = {}
        for u, i in consumer_of.items():
            c = widths[i] if drafts[i].kind == "pool" else 1
            edges[u] = EdgeSpec.create(widths[u], c, ctx.streaming_ring,
                                       self._stop)
        last = len(drafts) - 1
        self.sink_edge = EdgeSpec.create(widths[last], self._consumers,
                                         ctx.streaming_ring, self._stop)
        edges[last] = self.sink_edge
        # every stage edge is deterministic stripe — each worker owns
        # idxs worker (mod width) and processes them in order, which is
        # both what keeps results bit-identical to the task executor's
        # plan-order delivery AND what makes the credit graph
        # deadlock-free (see channels.py). Work-stealing fan-out exists
        # only at a split sink, where shards hold no downstream credit.
        self.sink_mode = "any" if self._split else "stripe"

        # stage workers are long-lived TASKS on the shared worker pool
        # (see run_stage_loop): one dispatch per worker for the whole
        # run, workers return to the pool when the pipeline ends.
        # max_retries=0 — a retried loop would replay moved ring cursors.
        # num_cpus=0 (the actor default): a stage worker spends its life
        # parked in channel waits; billing each one a core would
        # deadlock any pipeline wider than the CPU count
        remote_loop = ray.remote(run_stage_loop).options(max_retries=0,
                                                         num_cpus=0)
        dispatches = 0
        for i, (d, (pkind, pitems)) in enumerate(zip(drafts, resolved)):
            out_mode = "steal" if (i == last and self._split) \
                else "stripe"
            payload = (pkind, pitems) if d.kind == "source" else d.payload
            spec = StageSpec(
                kind=d.kind, idx=i, width=widths[i], fused=d.fused,
                in_edges=[edges[u] for u in d.ins],
                in_modes=["stripe" for _ in d.ins],
                out_edge=edges[i], out_mode=out_mode, payload=payload)
            # the spec rides inline in each task (pickled with it), not
            # as a bytes blob: the runtime moves a bytes argument over
            # INLINE_ARG_LIMIT into the store, where it would stay for
            # the whole run outside the ring credit (a source stage's
            # read tasks carry their data)
            for w in range(widths[i]):
                self._loop_refs.append(remote_loop.remote(spec, w))
                dispatches += 1
        tm.note_dispatches(float(dispatches), "chan")

    # -- consumption ------------------------------------------------------ #

    def _probe(self) -> None:
        """Sink idle hook: surface a failed stage worker promptly (the
        <45s death contract — every wait slice re-checks) and sample the
        sink depth gauge. A run_loop that RETURNED is normal: a worker
        exits once its messages are all acked, which can precede the
        sink draining its peers. Locked: concurrently-consumed split
        shards install this hook from multiple driver threads."""
        if self._recv is not None:
            tm.note_depth(float(self._recv.depth()))
        with self._probe_lock:
            refs = list(self._loop_refs)
        if not refs:
            return
        ready, _ = self._ray.wait(refs, num_returns=1, timeout=0)
        del refs, _
        if not ready:
            return
        with self._probe_lock:
            if ready[0] not in self._loop_refs:
                return   # another shard's probe already claimed it
            self._loop_refs.remove(ready[0])
        _raise_detached(self._ray, ready)   # the stage's original error

    def _raise_stage_failure(self) -> None:
        """After a ChannelClosed wake (a failing stage seals the stop
        flag), surface the ORIGINAL stage error rather than a generic
        teardown message."""
        with self._probe_lock:
            refs = list(self._loop_refs)
        if not refs:
            return
        done, _ = self._ray.wait(refs, num_returns=len(refs),
                                 timeout=2.0)
        del refs, _
        done.reverse()
        while done:
            _raise_detached(self._ray, done)   # first failure raises

    def iter_blocks(self, timeout_s: Optional[float] = None):
        """Drive the pipeline and yield blocks in plan order. Starting,
        consuming and teardown all live inside this generator: closing
        it early (``take(n)``) tears the pipeline down and the store
        still returns to baseline."""
        self.start()
        self._recv = BlockReceiver(self._store, self.sink_edge, 0,
                                   mode=self.sink_mode)
        n_stages = len(self._drafts)
        try:
            while True:
                got = self._recv.next_block(timeout_s=timeout_s,
                                            on_idle=self._probe)
                if got is None:
                    break
                idx, block = got
                tm.note_blocks(1.0, "chan")
                flight.evt(flight.DATA_BLOCK, n_stages, idx)
                yield block
        except ChannelClosed:
            self._raise_stage_failure()   # original error, if a stage died
            raise RuntimeError(
                "streaming pipeline was torn down mid-iteration "
                "(stop flag sealed)") from None
        finally:
            self.shutdown()

    def note_sink_done(self) -> None:
        """Split pipelines have no driver receiver to notice the end of
        the stream: each driver-side shard reports its completion, and
        the LAST one joins the producers (they finish within
        milliseconds of the final EOS ack) and releases the worker
        budget — instead of holding it until the shard feeds are
        garbage-collected. Remotely-consumed shards can't report;
        those pipelines release at feed GC (__del__ -> shutdown)."""
        if not self._started or self._shut:
            return
        with self._probe_lock:
            self._sinks_done += 1
            last = self._sinks_done >= self._consumers
            refs = list(self._loop_refs)
        if not last:
            return
        if refs:
            try:
                self._ray.get(refs, timeout=10.0)
            except Exception as e:  # noqa: BLE001 — shutdown reaps it
                _detach(e)  # a failed/straggling loop
            del refs
        self.shutdown()

    # -- teardown --------------------------------------------------------- #

    def shutdown(self, timeout_s: float = 20.0) -> None:
        """Idempotent. Clean completions just join the loop refs; aborts
        seal the stop flag first so every parked worker unwinds, then
        re-sweep the sink windows after stragglers are force-killed."""
        if not self._started or self._shut:
            return
        self._shut = True
        ray = self._ray
        clean = self._recv is not None and self._recv.done()
        stop_oid = ObjectID(self._stop[:ObjectID.SIZE])
        if not clean:
            signal_stop(self._store, stop_oid)
        joined = True
        if self._loop_refs:
            try:
                ray.get(self._loop_refs, timeout=timeout_s)
            except Exception as e:  # noqa: BLE001 — reaped below
                joined = False   # failed stage / wedged user fn
                _detach(e)
        if not joined:
            # force-reap only what did not unwind: cancel(force) kills
            # the worker process a wedged loop occupies (clean exits
            # already returned their worker to the pool)
            for ref in self._loop_refs:
                try:
                    done, _ = ray.wait([ref], num_returns=1, timeout=0)
                    if not done:
                        ray.cancel(ref, force=True)
                except Exception:
                    pass  # worker already dead
        if not clean:
            if not joined:
                # let the force-kills land, then catch anything a
                # straggler sealed after the first sweep
                time.sleep(0.5)
            if self._recv is not None:
                self._recv.sweep()
        try:
            self._store.delete(stop_oid)
        except Exception:
            pass  # store closing: the flag dies with it
        # joined or reaped: drop the loop results now, not when a
        # traceback or a reference cycle lets the pipeline go
        self._loop_refs = []
        _release_workers(self._held_workers)
        self._held_workers = 0

    def __del__(self):
        try:
            self.shutdown(timeout_s=2.0)
        except Exception:
            pass  # interpreter teardown: the store reaps everything


class PipelineFeed:
    """Re-iterable block feed over a compiled plan: each ``iter_blocks``
    call is a fresh pipeline run (one epoch = one run). Quacks for
    DataIterator."""

    def __init__(self, make: Callable[[], StreamingPipeline]):
        self._make = make

    def iter_blocks(self):
        return self._make().iter_blocks()

    def __iter__(self):
        return self.iter_blocks()


class ChannelShardFeed:
    """One ``streaming_split`` shard on the channel transport: a
    picklable consumer slot of the sink edge. First iteration pulls
    blocks from the rings (work-stealing: whichever shard consumes gets
    fed) and CACHES them so epochs replay, like the actor-feed split.
    The driver-side original holds the pipeline alive; pickled copies
    ship only the edge spec.

    One live copy per consumer slot: pickling ships the slot, not the
    cache or the ring cursors, so a SECOND copy of a partially-consumed
    shard (e.g. a retried consumer task reusing the same pickled
    argument) would wait on slots the first copy already consumed and
    time out after ``timeout_s`` — blocks a dead consumer had read are
    not replayed. Retry-sensitive consumers should use
    ``split_transport="actor"`` (the coordinator hands out only
    unclaimed blocks)."""

    def __init__(self, edge: EdgeSpec, consumer_idx: int,
                 pipeline: Optional[StreamingPipeline] = None,
                 timeout_s: float = 600.0):
        self._edge = edge
        self._idx = consumer_idx
        self._pipeline = pipeline   # driver-side lifetime anchor
        self._timeout_s = timeout_s
        self._cache: list = []
        self._complete = False
        # ONE receiver for the feed's lifetime: ring cursors must
        # survive a partially-consumed iteration (a fresh receiver at
        # seq 0 would re-wait on slots the first pass already deleted)
        self._recv: Optional[BlockReceiver] = None

    def __reduce__(self):
        return (ChannelShardFeed, (self._edge, self._idx, None,
                                   self._timeout_s))

    def count_rows(self) -> int:
        if not self._complete:
            raise TypeError(
                "count() on an unconsumed streaming_split shard would "
                "steal the other shards' blocks; iterate it (or "
                "materialize() the dataset) first")
        return sum(b.num_rows for b in self._cache)

    def iter_blocks(self):
        yield from self._cache
        if self._complete:
            return
        if self._pipeline is not None:
            self._pipeline.start()
        if self._recv is None:
            store = _local_store()
            if store is None or os.environ.get("RTPU_OWN_STORE") == "1":
                raise RuntimeError(
                    "streaming_split(chan) shard needs a process "
                    "attached to the cluster's shared shm store "
                    "(own-store nodes see none of the sealed slots); "
                    "use split_transport='actor' there")
            self._recv = BlockReceiver(store, self._edge, self._idx,
                                       mode="any")
        recv = self._recv
        # the driver-side shard can probe stage liveness; pickled copies
        # in remote consumers rely on the stop flag + read timeout
        on_idle = self._pipeline._probe if self._pipeline is not None \
            else None
        try:
            while True:
                got = recv.next_block(timeout_s=self._timeout_s,
                                      on_idle=on_idle)
                if got is None:
                    break
                tm.note_blocks(1.0, "chan")
                self._cache.append(got[1])
                yield got[1]
        except ChannelClosed:
            if self._pipeline is not None:
                self._pipeline._raise_stage_failure()  # original error
            raise RuntimeError(
                "streaming_split pipeline was torn down mid-iteration "
                "(stop flag sealed)") from None
        self._complete = True
        if self._pipeline is not None:
            # the last driver-side shard to finish frees the worker
            # budget now, not at feed garbage-collection
            self._pipeline.note_sink_done()

    def __iter__(self):
        return self.iter_blocks()
