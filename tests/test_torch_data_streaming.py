"""Streaming data plane (data/streaming): stage actors on sealed
channels behind the Dataset API.

Covers the PR contract: streaming-vs-task bit-identical results across
the op matrix, credit backpressure bounding in-flight blocks, prompt
stage-death surfacing, teardown draining the store to exact baseline,
dispatch-economy counters, the replay-buffer ingestion adapter, and the
offline-inference driver.

The port's copy of ``tests/test_data_streaming.py``, with its imports
pointed at ``ray_tpu_torch``; ``Plus`` is made by a function, so it
pickles by value and a stage worker never imports this module.
``test_a_kept_stage_error_pins_nothing_in_the_store`` and
``test_a_stage_error_surfaces_when_its_swept_slot_is_read_late`` are
the port's own. ``test_offline_inference_token_parity`` runs the port's
``LLMPredictor`` and ``InferenceEngine`` with ``device="cpu"`` (their
default is the card) on a vocabulary of 258: the byte tokenizer emits
ids up to 257, which the reference's 256-row embedding gather clamps
and the port's indexing refuses. Left out: ``test_replay_ingestion_feeds_dqn``
(it needs the port's RL library, not ported yet) and
``test_bench_data_quick_smoke`` (it runs the JAX package's
``bench_data.py``)."""
import time

import numpy as np
import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch import data as rdata
from ray_tpu_torch.data.context import DataContext


@pytest.fixture(scope="module")
def cluster():
    if ray_tpu.is_initialized():
        ray_tpu.shutdown()
    ray_tpu.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    yield ray_tpu
    ray_tpu.shutdown()


@pytest.fixture
def ctx():
    """Fresh context fields per test (DataContext is a singleton)."""
    c = DataContext.get_current()
    saved = (c.streaming_executor, c.split_transport,
             c.streaming_ring, c.streaming_source_workers)
    yield c
    (c.streaming_executor, c.split_transport,
     c.streaming_ring, c.streaming_source_workers) = saved


def _store():
    from ray_tpu_torch.core.api import _runtime
    return _runtime().store


def _settle(store, base, budget=10.0):
    """Wait for async ref-drop frees; -> leaked object count."""
    import gc
    deadline = time.time() + budget
    while time.time() < deadline:
        gc.collect()
        if store.num_objects() == base:
            return 0
        time.sleep(0.2)
    return store.num_objects() - base


def _quiesce(store, budget=10.0) -> int:
    """Drain a previous test's in-flight async frees, then return a
    STABLE baseline count (a snapshot taken mid-drain would read 'leaked
    negative objects' after they land)."""
    import gc
    deadline = time.time() + budget
    last, stable_since = store.num_objects(), time.time()
    while time.time() < deadline:
        gc.collect()
        n = store.num_objects()
        if n != last:
            last, stable_since = n, time.time()
        elif time.time() - stable_since > 1.0:
            break
        time.sleep(0.1)
    return last


def _plus():
    class Plus:
        """Stateful pool callable for map_batches actor pools."""

        def __init__(self, k):
            self.k = k

        def __call__(self, batch):
            return {"id": batch["id"] + self.k}
    return Plus


Plus = _plus()


class TestBitIdentical:
    """The acceptance matrix: every supported op produces EXACTLY the
    task executor's rows, in the same order."""

    def _both(self, ctx, make):
        ctx.streaming_executor = "force"
        streamed = [tuple(sorted(r.items())) for r in make().iter_rows()]
        ctx.streaming_executor = "off"
        tasked = [tuple(sorted(r.items())) for r in make().iter_rows()]
        assert streamed == tasked
        return streamed

    def test_fused_block_chain(self, cluster, ctx):
        def make():
            return (rdata.range(60, override_num_blocks=6)
                    .map_batches(lambda b: {"id": b["id"] * 2})
                    .map(lambda r: {"id": r["id"] + 1})
                    .filter(lambda r: r["id"] % 3 != 0)
                    .flat_map(lambda r: [r, {"id": -r["id"]}]))
        rows = self._both(ctx, make)
        assert len(rows) > 0

    def test_actor_pool(self, cluster, ctx):
        def make():
            return rdata.range(40, override_num_blocks=8).map_batches(
                Plus, concurrency=2, fn_constructor_args=(100,))
        rows = self._both(ctx, make)
        assert [dict(r)["id"] for r in rows] == [i + 100 for i in range(40)]

    def test_repartition(self, cluster, ctx):
        def make():
            return rdata.range(30, override_num_blocks=6).repartition(4)
        self._both(ctx, make)
        ctx.streaming_executor = "force"
        ds = rdata.range(30, override_num_blocks=6).repartition(4)
        assert sum(1 for _ in ds.iter_batches(batch_size=None)) == 4

    def test_zip_mismatched_block_boundaries(self, cluster, ctx):
        def make():
            left = rdata.range(25, override_num_blocks=5)
            right = rdata.range(25, override_num_blocks=4).map(
                lambda r: {"y": r["id"] * 3})
            return left.zip(right)
        self._both(ctx, make)

    def test_plan_split_fallback_exchange(self, cluster, ctx):
        """sort streams through the task executor at a clean plan-split
        boundary; the map above it still rides the pipeline."""
        def make():
            return (rdata.range(20, override_num_blocks=4)
                    .map(lambda r: {"id": -r["id"]})
                    .sort("id")
                    .map(lambda r: {"id": r["id"] * 10}))
        rows = self._both(ctx, make)
        assert [dict(r)["id"] for r in rows] == sorted(
            -i * 10 for i in range(20))


def test_dispatch_economy_counters(cluster, ctx):
    """Streaming issues one run_loop dispatch per stage worker for the
    WHOLE run (dispatches/block << 1); the task path pays one per
    block — both counter-verified via rtpu_data_*."""
    from ray_tpu_torch.data.streaming import metrics_summary

    def counters():
        out = {}
        for p, rec in metrics_summary().get("path", {}).items():
            out[p] = (rec.get("blocks", 0.0), rec.get("dispatches", 0.0))
        return out

    n_blocks = 16
    before = counters()
    ds = rdata.range(320, override_num_blocks=n_blocks).map_batches(
        lambda b: {"id": b["id"]})
    ctx.streaming_executor = "force"
    assert sum(1 for _ in ds.iter_batches(batch_size=None)) == n_blocks
    ctx.streaming_executor = "off"
    ds2 = rdata.range(320, override_num_blocks=n_blocks).map_batches(
        lambda b: {"id": b["id"]})
    assert sum(1 for _ in ds2.iter_batches(batch_size=None)) == n_blocks
    after = counters()

    def delta(path):
        b0, d0 = before.get(path, (0.0, 0.0))
        b1, d1 = after.get(path, (0.0, 0.0))
        return b1 - b0, d1 - d0

    chan_blocks, chan_disp = delta("chan")
    task_blocks, task_disp = delta("task")
    assert chan_blocks >= n_blocks
    # one dispatch per stage worker (2 source), not per block
    assert chan_disp <= 4, (chan_blocks, chan_disp)
    assert chan_disp / chan_blocks < 0.5
    assert task_blocks >= n_blocks
    assert task_disp >= task_blocks


def test_backpressure_bounds_inflight_blocks(cluster, ctx):
    """A consumer 10x slower than the producers parks the pipeline at
    the ring credit limit: sealed-but-unread blocks never exceed the
    edge credit total, store occupancy stays bounded, and the stall is
    counted."""
    from ray_tpu_torch.data.streaming import metrics_summary

    store = _store()
    ctx.streaming_executor = "force"
    ctx.streaming_ring = 2
    ctx.streaming_source_workers = 2
    bp_before = metrics_summary().get("backpressure_waits", 0.0)
    # ~800KB per block so occupancy is measurable
    ds = rdata.from_numpy(np.zeros((24 * 100_000,), np.float64),
                          override_num_blocks=24).map_batches(
        lambda b: b)
    base = store.bytes_in_use()
    peak = 0
    n = 0
    for _ in ds.iter_batches(batch_size=None):
        peak = max(peak, store.bytes_in_use() - base)
        time.sleep(0.05)   # slow consumer
        n += 1
    assert n == 24
    # edge credit total: 2 producers x ring 2 = 4 blocks in flight (plus
    # the one being consumed and serialization slack)
    block_bytes = 100_000 * 8
    assert peak <= 8 * block_bytes, (peak, block_bytes)
    # stage workers ship metric deltas on the 2s background flusher:
    # poll the merged store rather than racing it
    deadline = time.time() + 10.0
    while time.time() < deadline:
        if metrics_summary().get("backpressure_waits", 0.0) > bp_before:
            break
        time.sleep(0.25)
    assert metrics_summary().get("backpressure_waits", 0.0) > bp_before


def test_stage_death_surfaces_promptly(cluster, ctx):
    """A stage worker failing mid-run fails its run_loop ref; the
    driver's idle probe surfaces the ORIGINAL error well inside 45s and
    tears the pipeline down."""
    def boom(batch):
        if int(batch["id"][0]) >= 30:
            raise RuntimeError("stage exploded on purpose")
        return batch

    ctx.streaming_executor = "force"
    ds = rdata.range(60, override_num_blocks=6).map_batches(
        Plus, concurrency=2, fn_constructor_args=(0,)).map_batches(boom)
    store = _store()
    base = _quiesce(store)
    t0 = time.time()
    with pytest.raises(Exception, match="stage exploded"):
        for _ in ds.iter_batches(batch_size=None):
            pass
    assert time.time() - t0 < 45.0
    assert _settle(store, base) == 0


def test_stage_worker_process_death_surfaces(cluster, ctx):
    """The harder death: the stage worker PROCESS dies (SIGKILL-style
    os._exit). run_loop rides max_retries=0, so the task fails through
    the worker-death machinery instead of silently retrying with moved
    ring cursors; the driver surfaces it promptly."""
    def die(batch):
        if int(batch["id"][0]) >= 20:
            import os
            os._exit(1)
        return batch

    ctx.streaming_executor = "force"
    ds = rdata.range(40, override_num_blocks=4).map_batches(
        Plus, concurrency=1, fn_constructor_args=(0,)).map_batches(die)
    t0 = time.time()
    with pytest.raises(Exception):
        for _ in ds.iter_batches(batch_size=None):
            pass
    assert time.time() - t0 < 45.0


def test_teardown_drains_store_to_baseline(cluster, ctx):
    """Full consumption AND an early-abandoned take() both return the
    store to its exact pre-pipeline object count (the sealed channel
    contract)."""
    store = _store()
    ctx.streaming_executor = "force"

    base = _quiesce(store)
    ds = rdata.range(120, override_num_blocks=12).map_batches(
        Plus, concurrency=2, fn_constructor_args=(7,))
    assert [r["id"] for r in ds.iter_rows()] == [i + 7 for i in range(120)]
    assert _settle(store, base) == 0

    base = _quiesce(store)
    ds2 = rdata.range(200, override_num_blocks=20).map_batches(
        lambda b: {"id": b["id"]})
    assert len(ds2.take(5)) == 5     # abandons the stream mid-flight
    assert _settle(store, base) == 0


def test_streaming_split_chan_transport(cluster, ctx):
    """streaming_split over sealed-channel shards: zero dispatches per
    block, exact totals under concurrent AND sequential consumption,
    count guard, epoch replay from the shard cache."""
    ctx.split_transport = "chan"
    ctx.streaming_executor = "force"

    shards = rdata.range(60, override_num_blocks=6).streaming_split(2)

    @ray_tpu.remote
    class Consumer:
        def consume(self, it):
            return sorted(r["id"] for r in it.iter_rows())

    consumers = [Consumer.remote() for _ in range(2)]
    got = ray_tpu.get([c.consume.remote(s)
                       for c, s in zip(consumers, shards)], timeout=120)
    assert sorted(got[0] + got[1]) == list(range(60))

    # sequential consumption stays exact IN ANY ORDER (work-stealing:
    # the first consumer claims most blocks, parked rings drain to the
    # other). Reverse order is the regression case: the producer's
    # finish must seal EVERY shard's EOS before parking on any shard's
    # trailing acks, or consuming shard 1 first deadlocks.
    shards2 = rdata.range(40, override_num_blocks=4).streaming_split(2)
    with pytest.raises(TypeError):
        shards2[0].count()
    b = [r["id"] for r in shards2[1].iter_rows()]   # reverse order first
    a = [r["id"] for r in shards2[0].iter_rows()]
    assert sorted(a + b) == list(range(40))
    # epochs replay the SAME blocks per shard from the cache
    assert [r["id"] for r in shards2[0].iter_rows()] == a
    assert shards2[0].count() == len(a)


def test_a_kept_stage_error_pins_nothing_in_the_store(cluster, ctx):
    """The port's own case: a stage's error raised out of a streaming
    run and kept alive by the caller (as a REPL keeps its last
    exception) pins none of the run's loop results in the store: with
    the garbage collector off, the count is back at its baseline."""
    import gc

    def boom(batch):
        if int(batch["id"][0]) >= 30:
            raise RuntimeError("stage exploded on purpose")
        return batch

    ctx.streaming_executor = "force"
    store = _store()
    base = _quiesce(store)
    gc.disable()
    try:
        with pytest.raises(Exception, match="stage exploded") as kept:
            for _ in rdata.range(60, override_num_blocks=6).map_batches(
                    boom).iter_batches(batch_size=None):
                pass
        deadline = time.time() + 10.0
        while store.num_objects() != base and time.time() < deadline:
            time.sleep(0.1)
        assert store.num_objects() == base, (store.num_objects(), base)
        assert kept.value is not None
    finally:
        gc.enable()


def test_a_stage_error_surfaces_when_its_swept_slot_is_read_late(
        cluster, ctx, monkeypatch, tmp_path):
    """The port's own case: a failing stage seals the stop flag and then
    sweeps the slots it wrote. A driver that saw a slot sealed but reads
    it only after the sweep (a loaded host) still surfaces the stage's
    own error, not a timeout on the swept slot."""
    import os

    from ray_tpu_torch.data.streaming.channels import (BlockReceiver,
                                                       slot_oid)
    seen = str(tmp_path / "slot_seen")

    def boom(batch):
        if int(batch["id"][0]) >= 30:
            # fail only once the driver has seen a slot of this run sealed
            deadline = time.time() + 20.0
            while not os.path.exists(seen) and time.time() < deadline:
                time.sleep(0.05)
            raise RuntimeError("stage exploded on purpose")
        return batch

    read = BlockReceiver._read

    def late_read(self, rc, ack):
        # read the sealed slot only once the failed stage has swept it
        open(seen, "w").close()
        deadline = time.time() + 20.0
        while self.store.contains(slot_oid(rc.base, rc.seq)) and \
                time.time() < deadline:
            time.sleep(0.05)
        return read(self, rc, ack)

    monkeypatch.setattr(BlockReceiver, "_read", late_read)
    ctx.streaming_executor = "force"
    store = _store()
    base = _quiesce(store)
    with pytest.raises(Exception, match="stage exploded"):
        for _ in rdata.range(60, override_num_blocks=6).map_batches(
                boom).iter_batches(batch_size=None):
            pass
    assert _settle(store, base) == 0


def test_put_parallel_copy_bit_equality(cluster):
    """The put-bandwidth fix: large pieces copy across the thread pool;
    bytes must be identical to the single-threaded path."""
    from ray_tpu_torch.core.config import cfg

    arr = np.random.default_rng(1).integers(
        0, 256, 48 * 1024 * 1024, dtype=np.uint8)   # > _PARALLEL_MIN
    try:
        cfg.override(put_copy_threads=4)
        back_par = np.asarray(ray_tpu.get(ray_tpu.put(arr)))
        cfg.override(put_copy_threads=1)
        back_one = np.asarray(ray_tpu.get(ray_tpu.put(arr)))
    finally:
        cfg.reset("put_copy_threads")
    assert np.array_equal(back_par, arr)
    assert np.array_equal(back_one, arr)


@pytest.mark.slow
def test_offline_inference_token_parity(cluster, ctx):
    """The flagship driver: Dataset.map_batches(LLMPredictor, pool)
    through the streaming executor produces the EXACT tokens of direct
    engine calls (slow: builds a llama_tiny engine twice)."""
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine, SamplingParams
    from ray_tpu_torch.llm.batch import LLMPredictor
    from ray_tpu_torch.models import llama

    def ecfg():
        return EngineConfig(model=llama.llama_tiny(vocab_size=258,
                                                   max_seq_len=64),
                            max_batch_size=2, max_seq_len=64,
                            prefill_buckets=(16, 32))

    prompts = [f"hello world {i}" for i in range(6)]
    sampling = SamplingParams(max_tokens=4)

    ctx.streaming_executor = "force"
    ds = rdata.from_items([{"prompt": p} for p in prompts]).map_batches(
        LLMPredictor, concurrency=1,
        fn_constructor_args=(ecfg(), sampling),
        fn_constructor_kwargs={"device": "cpu"})
    rows = sorted(ds.take_all(), key=lambda r: r["prompt"])

    engine = InferenceEngine(ecfg(), device="cpu")
    direct = engine.generate(prompts, sampling)
    expect = {p: list(o["token_ids"]) for p, o in zip(prompts, direct)}
    for r in rows:
        assert list(r["generated_ids"]) == expect[r["prompt"]], r["prompt"]
