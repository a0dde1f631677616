"""Serve local testing mode: run an application fully in-process.

Counterpart of ``ray_tpu/serve/local_mode.py`` (reference parity:
serve/_private/local_testing_mode.py, the ``serve.run(app,
_local_testing_mode=True)`` path) — deployments are instantiated as
plain objects in the calling process, handles dispatch to them over a
thread pool, and no cluster, controller, proxy, or replica actors exist.
It is the only way the port runs an application until the runtime is
ported: composition, async methods, streaming and reconfigure work;
autoscaling, routing across replicas and restarts are exactly what it
does NOT do.

Handles mirror the cluster ``DeploymentHandle`` surface: ``.remote()``
returns a response with ``.result(timeout_s)`` / ``await``; attribute
access selects a method; ``.options(stream=True)`` yields a generator
response; composition works because bound children are injected as local
handles at build time, same as the controller does with real handles.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import threading
from typing import Any, Optional

_REGISTRY: dict[str, "LocalDeploymentHandle"] = {}
_POOL: Optional[concurrent.futures.ThreadPoolExecutor] = None
_LOOP: Optional[asyncio.AbstractEventLoop] = None
_LOOP_THREAD: Optional[threading.Thread] = None
_LOCK = threading.Lock()


def _pool() -> concurrent.futures.ThreadPoolExecutor:
    global _POOL
    with _LOCK:
        if _POOL is None:
            _POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=32, thread_name_prefix="serve-local")
        return _POOL


def _loop() -> asyncio.AbstractEventLoop:
    """One shared background event loop runs every async deployment
    method (the local-mode analog of the replica's asyncio loop)."""
    global _LOOP, _LOOP_THREAD
    with _LOCK:
        if _LOOP is None:
            loop = asyncio.new_event_loop()
            t = threading.Thread(target=loop.run_forever, daemon=True,
                                 name="serve-local-loop")
            t.start()
            _LOOP, _LOOP_THREAD = loop, t
        return _LOOP


def _guard_loop_thread(what: str) -> None:
    """Blocking on a response from the shared loop thread would deadlock
    every async deployment — refuse loudly instead."""
    if _LOOP_THREAD is not None and \
            threading.current_thread() is _LOOP_THREAD:
        raise RuntimeError(
            f"{what} would block the serve-local event loop from inside "
            f"an async deployment method; await the response instead")


class LocalDeploymentResponse:
    """result()/await surface of DeploymentResponse over a plain
    concurrent future."""

    def __init__(self, fut: concurrent.futures.Future):
        self._fut = fut

    def result(self, timeout_s: Optional[float] = None) -> Any:
        if not self._fut.done():
            _guard_loop_thread("result()")
        return self._fut.result(timeout=timeout_s)

    def _to_object_ref(self):  # composition: nested handle args resolve
        return self.result()

    def __await__(self):
        return asyncio.wrap_future(self._fut).__await__()


def _drive_async_gen(agen):
    """Sync iterator over an async-generator method, items pulled through
    the shared loop (the local analog of the replica's streaming
    responses over async generators)."""
    while True:
        _guard_loop_thread("iterating a streaming response")
        try:
            yield asyncio.run_coroutine_threadsafe(
                agen.__anext__(), _loop()).result()
        except StopAsyncIteration:
            return


class LocalResponseGenerator:
    """Streaming response: iterates the method's generator directly."""

    def __init__(self, gen):
        self._gen = gen

    def __iter__(self):
        return self._gen

    def __next__(self):
        return next(self._gen)

    def cancel(self):
        self._gen.close()


class LocalDeploymentHandle:
    """In-process stand-in for DeploymentHandle (same call surface)."""

    def __init__(self, instance: Any, name: str, method: str = "__call__",
                 stream: bool = False):
        self._instance = instance
        self.deployment_name = name
        self._method = method
        self._stream = stream

    def options(self, method_name: Optional[str] = None,
                stream: Optional[bool] = None,
                **_ignored) -> "LocalDeploymentHandle":
        return LocalDeploymentHandle(
            self._instance, self.deployment_name,
            method_name or self._method,
            self._stream if stream is None else stream)

    def __getattr__(self, name: str) -> "LocalDeploymentHandle":
        if name.startswith("_"):
            raise AttributeError(name)
        return LocalDeploymentHandle(self._instance, self.deployment_name,
                                     name, self._stream)

    def _target(self):
        import inspect
        # function deployments: the function IS the replica — return it
        # directly so iscoroutinefunction still sees an async def (its
        # bound __call__ wrapper would hide that)
        if self._method == "__call__" and (
                inspect.isfunction(self._instance)
                or inspect.iscoroutinefunction(self._instance)):
            return self._instance
        fn = getattr(self._instance, self._method, None)
        if fn is None:
            raise AttributeError(
                f"{self.deployment_name!r} has no method {self._method!r}")
        return fn

    def remote(self, *args, **kwargs):
        import inspect
        fn = self._target()

        def resolve():
            # nested responses resolve to their values before dispatch,
            # the local analog of passing the underlying ObjectRef
            a = tuple(x.result() if isinstance(x, LocalDeploymentResponse)
                      else x for x in args)
            kw = {k: (v.result()
                      if isinstance(v, LocalDeploymentResponse) else v)
                  for k, v in kwargs.items()}
            return a, kw

        if self._stream:
            a, kw = resolve()  # result() guards the loop thread itself
            out = fn(*a, **kw)
            if inspect.isasyncgen(out):
                return LocalResponseGenerator(_drive_async_gen(out))
            return LocalResponseGenerator(iter(out))

        # resolve + invoke entirely on the pool: calling .remote() from
        # inside an async deployment (on the loop thread) must never
        # block the loop waiting on another deployment's coroutine
        def invoke():
            a, kw = resolve()
            if inspect.isasyncgenfunction(fn):
                raise TypeError(
                    "async-generator methods require "
                    ".options(stream=True)")
            if asyncio.iscoroutinefunction(fn):
                return asyncio.run_coroutine_threadsafe(
                    fn(*a, **kw), _loop()).result()
            return fn(*a, **kw)

        return LocalDeploymentResponse(_pool().submit(invoke))


def build_local_app(app, name: str = "default") -> LocalDeploymentHandle:
    """Instantiate every deployment of a bound application in-process and
    return the ingress handle (reference: local_testing_mode's
    make_local_deployment_handle over the built app graph)."""
    from .api import BoundDeployment

    instances: dict[str, Any] = {}

    def build(node: BoundDeployment):
        spec = node.spec
        if spec.name in instances:
            return instances[spec.name]
        args = tuple(LocalDeploymentHandle(build(a), a.spec.name)
                     if isinstance(a, BoundDeployment) else a
                     for a in spec.init_args)
        kwargs = {k: (LocalDeploymentHandle(build(v), v.spec.name)
                      if isinstance(v, BoundDeployment) else v)
                  for k, v in spec.init_kwargs.items()}
        fc = spec.func_or_class
        if isinstance(fc, type):
            inst = fc(*args, **kwargs)
            if spec.user_config is not None and hasattr(inst,
                                                        "reconfigure"):
                inst.reconfigure(spec.user_config)
        else:
            inst = fc  # function deployment: the function is the replica
        instances[spec.name] = inst
        return inst

    ingress = build(app.ingress)
    handle = LocalDeploymentHandle(ingress, app.ingress.spec.name)
    _REGISTRY[name] = handle
    return handle


def get_local_app(name: str = "default") -> Optional[LocalDeploymentHandle]:
    return _REGISTRY.get(name)


def delete_local_app(name: str = "default") -> None:
    _REGISTRY.pop(name, None)
