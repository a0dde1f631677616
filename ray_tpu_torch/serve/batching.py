"""@serve.batch — transparent request batching.

Counterpart of ``ray_tpu/serve/batching.py`` (reference parity:
serve/batching.py — @serve.batch, _BatchQueue): single calls enqueue; a
background coroutine drains up to ``max_batch_size`` items (waiting at
most ``batch_wait_timeout_s`` after the first), invokes the wrapped
function ONCE with the list, and fans results back out to the callers'
futures. The wrapped function must take a list and return a list of
equal length (or raise — the exception fans out to every caller in the
batch). Each drained batch records its size and its oldest item's wait
in the ``rtpu_serve_batch_size`` and ``rtpu_serve_batch_wait_seconds``
histograms (``metrics.py``).
"""
from __future__ import annotations

import asyncio
import functools
from typing import Any, Callable, Optional


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float, fn_name: str = ""):
        self.fn = fn
        self.fn_name = fn_name
        self.max_batch_size = max_batch_size
        self.timeout_s = batch_wait_timeout_s
        self.queue: asyncio.Queue = asyncio.Queue()
        self._worker: Optional[asyncio.Task] = None

    def ensure_worker(self):
        if self._worker is None or self._worker.done():
            self._worker = asyncio.get_event_loop().create_task(
                self._loop())

    async def _loop(self):
        while True:
            item = await self.queue.get()
            batch = [item]
            if self.timeout_s > 0:
                deadline = asyncio.get_event_loop().time() + self.timeout_s
                while len(batch) < self.max_batch_size:
                    remain = deadline - asyncio.get_event_loop().time()
                    if remain <= 0:
                        break
                    try:
                        batch.append(await asyncio.wait_for(
                            self.queue.get(), remain))
                    except asyncio.TimeoutError:
                        break
            else:
                while len(batch) < self.max_batch_size:
                    try:
                        batch.append(self.queue.get_nowait())
                    except asyncio.QueueEmpty:
                        break
            try:
                from . import metrics as sm
                sm.batch_size().observe(len(batch),
                                        tags={"fn": self.fn_name})
                # FIFO queue: batch[0] is the oldest item
                sm.batch_wait().observe(
                    max(asyncio.get_event_loop().time() - batch[0][2], 0.0),
                    tags={"fn": self.fn_name})
            except Exception:
                pass  # telemetry must never fail the batch
            args = [a for a, _, _ in batch]
            futs = [f for _, f, _ in batch]
            try:
                results = await self.fn(args)
                if results is None or len(results) != len(args):
                    raise TypeError(
                        f"@serve.batch function must return a list of "
                        f"len {len(args)}, got "
                        f"{type(results).__name__}")
                for f, r in zip(futs, results):
                    if not f.done():
                        f.set_result(r)
            except BaseException as e:  # noqa: BLE001 — fan the error out
                for f in futs:
                    if not f.done():
                        f.set_exception(e)


def batch(_fn=None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01):
    """Decorate an async function/method taking a LIST of requests.

        @serve.batch(max_batch_size=32, batch_wait_timeout_s=0.005)
        async def forward(self, inputs: list) -> list: ...

    Callers invoke it with a SINGLE request and await a single result.
    """
    def wrap(fn):
        if not asyncio.iscoroutinefunction(fn):
            raise TypeError("@serve.batch requires an async def function")
        queues: dict[int, _BatchQueue] = {}  # per bound instance

        @functools.wraps(fn)
        async def wrapper(*args) -> Any:
            if len(args) == 2:        # bound method: (self, request)
                owner, request = args
                key = id(owner)
                call = functools.partial(fn, owner)
            elif len(args) == 1:      # free function: (request,)
                owner, request = None, args[0]
                key = 0
                call = fn
            else:
                raise TypeError(
                    "@serve.batch functions take exactly one request arg")
            q = queues.get(key)
            if q is None:
                q = queues[key] = _BatchQueue(
                    call, max_batch_size, batch_wait_timeout_s,
                    fn_name=getattr(fn, "__qualname__", fn.__name__))
            q.ensure_worker()
            loop = asyncio.get_event_loop()
            fut: asyncio.Future = loop.create_future()
            q.queue.put_nowait((request, fut, loop.time()))
            return await fut

        wrapper._rtpu_batch_queues = queues  # introspection/tests
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
