"""Model multiplexing: many models per deployment, LRU-cached per replica.

Counterpart of ``ray_tpu/serve/multiplex.py`` (reference parity:
serve/multiplex.py — _ModelMultiplexWrapper, used via @serve.multiplexed
+ handle.options(multiplexed_model_id=...)) and the router's model-aware
replica ranking.

Routing under cluster Serve is RENDEZVOUS HASHING in the handle (see
``serve/handle.py`` DeploymentHandle._pick): requests for the same model
id deterministically prefer the same replica of the current replica
set, so each model's weights load once and stay cache-hot. In local
testing mode the id reaches the loader explicitly or through the
request context.
"""
from __future__ import annotations

import asyncio
import collections
import functools
from typing import Any, Callable

from .context import get_multiplexed_model_id


class _ModelCache:
    """Per-instance async LRU of loaded models with eviction callbacks."""

    def __init__(self, loader: Callable, max_models: int):
        self.loader = loader
        self.max_models = max_models
        self.models: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self.locks: dict[str, asyncio.Lock] = {}

    async def get(self, model_id: str) -> Any:
        if model_id in self.models:
            self.models.move_to_end(model_id)
            return self.models[model_id]
        lock = self.locks.setdefault(model_id, asyncio.Lock())
        async with lock:
            if model_id in self.models:   # raced another loader
                self.models.move_to_end(model_id)
                return self.models[model_id]
            model = await self.loader(model_id)
            self.models[model_id] = model
            while len(self.models) > self.max_models:
                old_id, old = self.models.popitem(last=False)
                self.locks.pop(old_id, None)
                # best-effort destructor (reference calls __del__/release)
                release = getattr(old, "release", None)
                if callable(release):
                    try:
                        res = release()
                        if asyncio.iscoroutine(res):
                            await res
                    except Exception:
                        pass  # user hook failed; eviction proceeds
            return model


def multiplexed(_fn=None, *, max_num_models_per_replica: int = 3):
    """Decorate an async model loader ``async def get_model(self, model_id)``.
    Calling it with NO arguments inside a request loads/returns the model
    for the request's multiplexed_model_id (set via
    ``handle.options(multiplexed_model_id=...)``)."""
    def wrap(fn):
        if not asyncio.iscoroutinefunction(fn):
            raise TypeError("@serve.multiplexed requires an async def loader")
        caches: dict[int, _ModelCache] = {}

        @functools.wraps(fn)
        async def wrapper(*args) -> Any:
            # (self,) or (self, model_id) or () or (model_id,)
            if args and not isinstance(args[0], str):
                owner, rest = args[0], args[1:]
                key = id(owner)
                loader = functools.partial(fn, owner)
            else:
                owner, rest = None, args
                key = 0
                loader = fn
            model_id = rest[0] if rest else get_multiplexed_model_id()
            if not model_id:
                raise ValueError(
                    "no multiplexed model id: pass one explicitly or set "
                    "handle.options(multiplexed_model_id=...)")
            cache = caches.get(key)
            if cache is None:
                cache = caches[key] = _ModelCache(
                    loader, max_num_models_per_replica)
            return await cache.get(model_id)

        wrapper._rtpu_multiplex_caches = caches
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
