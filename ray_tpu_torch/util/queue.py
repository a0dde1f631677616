"""Distributed FIFO queue backed by an actor.

Reference parity: python/ray/util/queue.py (Queue — an asyncio.Queue
wrapped in an actor; put/get/qsize with optional blocking + timeouts,
usable from any worker/actor/driver).
The port's copy of ``ray_tpu/util/queue.py``: the backing actor is a
``ray_tpu_torch`` actor, and importing the module loads only ``asyncio``.
"""
from __future__ import annotations

import asyncio
from typing import Any, Optional


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self._q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)

    async def put(self, item: Any, timeout: Optional[float] = None) -> bool:
        if timeout is None:
            await self._q.put(item)
            return True
        try:
            await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def put_nowait(self, item: Any) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def get(self, timeout: Optional[float] = None):
        if timeout is None:
            return True, await self._q.get()
        try:
            return True, await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    async def get_nowait(self):
        try:
            return True, self._q.get_nowait()
        except asyncio.QueueEmpty:
            return False, None

    async def qsize(self) -> int:
        return self._q.qsize()

    async def empty(self) -> bool:
        return self._q.empty()

    async def full(self) -> bool:
        return self._q.full()


class Queue:
    """Client handle; picklable (pass it into tasks/actors freely)."""

    def __init__(self, maxsize: int = 0, *, actor_options: Optional[dict] =
                 None, _actor=None):
        import ray_tpu_torch
        if _actor is not None:
            self._actor = _actor
            return
        cls = ray_tpu_torch.remote(_QueueActor)
        self._actor = cls.options(
            max_concurrency=64, **(actor_options or {})).remote(maxsize)

    @classmethod
    def _from_actor(cls, actor) -> "Queue":
        self = cls.__new__(cls)
        self._actor = actor
        return self

    def __reduce__(self):
        # no __init__ on unpickle: it would mint a fresh backing actor
        return (Queue._from_actor, (self._actor,))

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        import ray_tpu_torch
        if not block:
            ok = ray_tpu_torch.get(self._actor.put_nowait.remote(item))
            if not ok:
                raise Full("queue is full")
            return
        ok = ray_tpu_torch.get(self._actor.put.remote(item, timeout))
        if not ok:
            raise Full(f"queue stayed full for {timeout}s")

    def get(self, block: bool = True,
            timeout: Optional[float] = None) -> Any:
        import ray_tpu_torch
        if not block:
            ok, item = ray_tpu_torch.get(self._actor.get_nowait.remote())
            if not ok:
                raise Empty("queue is empty")
            return item
        ok, item = ray_tpu_torch.get(self._actor.get.remote(timeout))
        if not ok:
            raise Empty(f"queue stayed empty for {timeout}s")
        return item

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def qsize(self) -> int:
        import ray_tpu_torch
        return ray_tpu_torch.get(self._actor.qsize.remote())

    def empty(self) -> bool:
        import ray_tpu_torch
        return ray_tpu_torch.get(self._actor.empty.remote())

    def full(self) -> bool:
        import ray_tpu_torch
        return ray_tpu_torch.get(self._actor.full.remote())

    def shutdown(self) -> None:
        import ray_tpu_torch
        try:
            ray_tpu_torch.kill(self._actor)
        except Exception:
            pass  # already dead
