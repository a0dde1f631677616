"""Execution-context knobs (reference parity: python/ray/data/context.py
DataContext — a process-wide singleton of tunables)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class DataContext:
    target_max_block_size: int = 128 * 1024 * 1024
    target_min_block_size: int = 1 * 1024 * 1024
    default_batch_size: int = 256
    # max concurrently in-flight block tasks per executing dataset
    max_tasks_in_flight: int = 16
    read_default_num_blocks: int = 8
    # actor-pool autoscaling (reference: _internal/execution/autoscaler/
    # default_autoscaler.py): scale UP when every active actor has at
    # least this many calls queued; scale DOWN when more than half the
    # pool sits idle
    actor_pool_scale_up_queued: int = 2
    # streaming physical executor (data/streaming): "auto" streams any
    # streamable plan through stage actors on sealed channels when a
    # cluster with a shared shm store is up (falling back to the task
    # executor otherwise), "off" always uses the task executor, "force"
    # raises instead of falling back (tests/benches pin the path)
    streaming_executor: str = "auto"
    # per-edge credit window, in blocks, per (producer, consumer) ring:
    # bounds in-flight memory under skew (a stage 10x slower parks its
    # senders at this limit instead of flooding the store)
    streaming_ring: int = 4
    # source-stage workers (read tasks / block fetches run this wide)
    streaming_source_workers: int = 2
    # streaming_split transport: "actor" = the work-stealing coordinator
    # actor (one dispatch per block, any consumption pattern), "chan" =
    # push-mode sealed-channel shards (zero dispatches per block; shards
    # should be consumed concurrently for balanced splits, though any
    # order stays correct)
    split_transport: str = "actor"

    _instance = None

    @classmethod
    def get_current(cls) -> "DataContext":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance
