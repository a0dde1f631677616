"""ActorPool: load-balance work over a fixed set of actors.

Reference parity: python/ray/util/actor_pool.py (ActorPool — map/
map_unordered/submit/get_next over a set of actor handles).
The port's copy of ``ray_tpu/util/actor_pool.py``: it reaches the port's
runtime through ``import ray_tpu_torch`` inside its methods, so importing
it loads only ``collections``.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable


class ActorPool:
    def __init__(self, actors: Iterable):
        self._idle = list(actors)
        if not self._idle:
            raise ValueError("ActorPool needs at least one actor")
        self._future_to_actor: dict = {}
        self._pending: deque = deque()     # completion-order buffer
        self._index_to_future: dict = {}
        self._next_task_index = 0
        self._next_return_index = 0

    # -- submission ------------------------------------------------------- #

    def submit(self, fn: Callable, value: Any) -> None:
        """fn(actor, value) -> ObjectRef; queues when all actors busy."""
        if self._idle:
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._future_to_actor[ref] = (self._next_task_index, actor)
            self._index_to_future[self._next_task_index] = ref
            self._next_task_index += 1
        else:
            self._pending.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._future_to_actor or self._pending)

    def has_free(self) -> bool:
        return bool(self._idle) and not self._pending

    def _return_actor(self, actor) -> None:
        self._idle.append(actor)
        if self._pending:
            fn, value = self._pending.popleft()
            self.submit(fn, value)

    # -- retrieval -------------------------------------------------------- #

    def get_next(self, timeout: float | None = None) -> Any:
        """Next result in SUBMISSION order."""
        import ray_tpu_torch
        if not self.has_next():
            raise StopIteration("no pending results")
        idx = self._next_return_index
        ref = self._index_to_future.pop(idx)
        self._next_return_index += 1
        _, actor = self._future_to_actor.pop(ref)
        self._return_actor(actor)
        return ray_tpu_torch.get(ref, timeout=timeout)

    def get_next_unordered(self, timeout: float | None = None) -> Any:
        """Next result in COMPLETION order."""
        import ray_tpu_torch
        if not self.has_next():
            raise StopIteration("no pending results")
        ready, _ = ray_tpu_torch.wait(list(self._future_to_actor),
                                      num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        ref = ready[0]
        idx, actor = self._future_to_actor.pop(ref)
        self._index_to_future.pop(idx, None)
        self._return_actor(actor)
        return ray_tpu_torch.get(ref, timeout=timeout)

    # -- bulk helpers ----------------------------------------------------- #

    def map(self, fn: Callable, values: Iterable) -> Iterable:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable) -> Iterable:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()
