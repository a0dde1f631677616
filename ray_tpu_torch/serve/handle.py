"""DeploymentHandle: the client-side router.

Counterpart of ``ray_tpu/serve/handle.py``, on the port's runtime.

Reference parity: serve/handle.py:639 (DeploymentHandle.remote :715 ->
DeploymentResponse), _private/router.py:365 (AsyncioRouter.assign_request
:676) and request_router/pow_2_router.py:27 (power-of-two-choices).

Routing here tracks in-flight counts per handle (each handle routes its own
traffic) and picks the lighter of two random replicas; the replica set is
cached and refreshed from the controller when its version changes or a
replica dies mid-call (retried once on a fresh set).

Prefix affinity: LLM-style requests (a dict carrying ``prompt``, or an
explicit ``session_id``) rendezvous-hash onto a stable replica so repeated
prefixes — system prompts, multi-turn sessions — land where the paged
engine's prefix cache already holds their KV pages (paged_engine.py
enable_prefix_caching). The affinity choice yields to least-loaded when
the preferred replica is clearly busier than the lightest one, so a hot
prefix cannot hotspot a replica into queueing.
"""
from __future__ import annotations

import random
import time
from collections import deque
from typing import Any, Optional

from ..core.config import cfg as _cfg
from ..core import flight as _fl

# affinity yields to load: the preferred replica is skipped when it has
# this many more in-flight requests (on this handle) than the lightest
# replica — a cache hit saves prefill, not a queueing delay
_AFFINITY_SLACK = 4


class DeploymentResponse:
    """Future for one request (reference: handle.py DeploymentResponse).
    `.result()` blocks; `await` works inside async actors; passing a
    response to another .remote() passes the underlying ObjectRef so the
    payload never bounces through the caller.

    `.result()` retries once on a fresh replica set when the chosen replica
    died (scale-down or crash race against the handle's cached set)."""

    def __init__(self, ref, on_done, retry=None):
        self._ref = ref
        self._done = False
        self._on_done = on_done
        self._retry = retry

    def result(self, timeout_s: Optional[float] = None) -> Any:
        import ray_tpu_torch
        from ..exceptions import ActorDiedError, WorkerCrashedError
        try:
            try:
                return ray_tpu_torch.get(self._ref, timeout=timeout_s)
            except (ActorDiedError, WorkerCrashedError) as e:
                if self._retry is None:
                    raise
                # break the exception->traceback->frame cycle NOW: the
                # traceback's get() frames pin the dead replica's error
                # ref until a gc pass happens to run, which would hold
                # the store above baseline long after a chaos kill is
                # retried successfully
                e.__traceback__ = None
                self._ref = self._retry()
                return ray_tpu_torch.get(self._ref, timeout=timeout_s)
        finally:
            self._settle()

    def _settle(self):
        if not self._done:
            self._done = True
            self._on_done()

    def _to_object_ref(self):
        return self._ref

    def __await__(self):
        def gen():
            try:
                out = yield from self._ref.__await__()
                return out
            finally:
                self._settle()
        return gen()


class ChannelResponseGenerator:
    """Iterator over a streaming response served by the STATIC DECODE
    PLAN: the replica drains its generator into a sealed ring channel
    (dag/channel.py) and this end reads items straight out of shm —
    zero control-plane dispatches per item in steady state (the only
    actor calls are the setup and, when the stream goes quiet for a long
    time, a liveness probe so a dead replica raises instead of hanging).
    Falls out of DeploymentHandle.remote() when the replica shares the
    caller's object store and cfg.serve_static_decode_plan is on."""

    # probe the replica after this many idle 0.5s wait-slices in a row
    # (a healthy but slow decode costs at most one probe dispatch per
    # ~30s of silence — still amortized-zero)
    _PROBE_IDLE_SLICES = 60

    def __init__(self, replica, chan: dict, on_done, tags: dict):
        from ..core import runtime as rt_mod
        from ..core.ids import ObjectID
        from ..dag.channel import RingReader
        rt = rt_mod.get_runtime_if_exists()
        self._replica = replica
        self._reader = RingReader(rt.store, chan["base"],
                                  ObjectID(chan["stop"]),
                                  int(chan["ring"]))
        self._on_done = on_done
        self._tags = {**tags, "transport": "chan"}
        self._done = False
        self._idle = 0

    def __iter__(self):
        return self

    def _probe(self):
        self._idle += 1
        if self._idle % self._PROBE_IDLE_SLICES:
            return
        import ray_tpu_torch
        try:
            from . import metrics as sm
            sm.stream_dispatches().inc(1.0, tags=self._tags)
        except Exception:
            pass  # telemetry must never fail a stream
        ray_tpu_torch.get(self._replica.stats.remote(), timeout=30)  # liveness

    def __next__(self):
        from ..dag.channel import ChannelClosed
        if self._done:
            raise StopIteration
        try:
            kind, payload = self._reader.read(on_idle=self._probe)
        except ChannelClosed:
            self._reader.retire()
            self._settle()
            raise StopIteration from None
        self._idle = 0
        if kind == "i":
            try:
                from . import metrics as sm
                sm.stream_items().inc(1.0, tags=self._tags)
            except Exception:
                pass  # telemetry must never fail a stream
            return payload
        self._reader.retire()  # sweep the trailing ack ring (leak-free)
        self._settle()
        if kind == "x":
            raise payload
        raise StopIteration

    def _settle(self):
        if not self._done:
            self._done = True
            if self._on_done:
                self._on_done()
                self._on_done = None

    def cancel(self):
        if self._done:
            return
        # sealing the stop flag is the whole cancellation: the replica's
        # drain thread observes it (its next write/closed() check) and
        # sweeps the channel — no actor call, zero dispatches
        self._reader.close()
        self._settle()


class DeploymentResponseGenerator:
    """Iterator over a streaming deployment response (reference:
    handle.py DeploymentResponseGenerator). Pulls batched chunks from the
    replica-retained generator via stream_next — the fallback transport
    when the static decode plan can't engage (no shared store, or
    cfg.serve_static_decode_plan off)."""

    def __init__(self, replica, sid: int, on_done, tags=None):
        self._replica = replica
        self._sid = sid
        self._on_done = on_done
        self._tags = {**(tags or {}), "transport": "poll"}
        self._buf: deque = deque()
        self._done = False

    def __iter__(self):
        return self

    def __next__(self):
        import ray_tpu_torch
        while not self._buf:
            if self._done:
                raise StopIteration
            items, done = ray_tpu_torch.get(
                self._replica.stream_next.remote(self._sid))
            try:
                from . import metrics as sm
                sm.stream_dispatches().inc(1.0, tags=self._tags)
                if items:
                    sm.stream_items().inc(float(len(items)),
                                          tags=self._tags)
            except Exception:
                pass  # telemetry must never fail a stream
            self._buf.extend(items)
            if done:
                self._done = True
                if self._on_done:
                    self._on_done()
                    self._on_done = None
        return self._buf.popleft()

    def cancel(self):
        import ray_tpu_torch
        if not self._done:
            self._done = True
            try:
                ray_tpu_torch.get(self._replica.stream_cancel.remote(self._sid))
            except Exception:
                pass  # replica died; stream is gone either way
            if self._on_done:
                self._on_done()
                self._on_done = None


def _listen_loop_weak(handle_ref):
    """Body of a handle's long-poll listener thread. Takes a weakref so an
    abandoned handle (and this thread) can die; between polls only ids are
    kept live."""
    import ray_tpu_torch
    failures = 0
    while True:
        h = handle_ref()
        if h is None:
            return
        ctrl, app, dep, known = (h._ctrl, h.app_name, h.deployment_name,
                                 h._version)
        del h  # don't pin the handle across the (long) poll
        try:
            version, replicas = ray_tpu_torch.get(
                ctrl.listen_for_change.remote(app, dep, known),
                timeout=45.0)
            failures = 0
        except Exception:
            # controller busy/restarting or deployment deleted; back off
            # and give up after repeated failures (the TTL path in
            # _refresh still keeps the handle usable)
            failures += 1
            h = handle_ref()
            if failures >= 5 or h is None:
                if h is not None:
                    h._listener_started = False
                return
            del h
            time.sleep(min(2.0 ** failures, 10.0))
            continue
        h = handle_ref()
        if h is None:
            return
        if version != h._version:
            # atomic installs: readers snapshot these attributes
            h._inflight = {i: 0 for i in range(len(replicas))}
            h._replicas = replicas
            h._version = version
        h._last_refresh = time.monotonic()
        del h


class DeploymentHandle:
    def __init__(self, deployment: str, app: str, controller,
                 method: str = "__call__", stream: bool = False,
                 multiplexed_model_id: str = "",
                 replica_index: Optional[int] = None):
        self.deployment_name = deployment
        self.app_name = app
        self._ctrl = controller
        self._method = method
        self._stream = stream
        self._model_id = multiplexed_model_id
        self._replica_index = replica_index
        self._replicas: list = []
        self._version = -1
        self._inflight: dict[int, int] = {}
        self._last_refresh = 0.0
        self._listener_started = False

    # handles pickle into replicas/tasks; router state is rebuilt lazily
    def __reduce__(self):
        return (DeploymentHandle,
                (self.deployment_name, self.app_name, self._ctrl,
                 self._method, self._stream, self._model_id,
                 self._replica_index))

    def options(self, method_name: Optional[str] = None,
                stream: Optional[bool] = None,
                multiplexed_model_id: Optional[str] = None,
                replica_index: Optional[int] = None,
                **_ignored) -> "DeploymentHandle":
        return DeploymentHandle(
            self.deployment_name, self.app_name, self._ctrl,
            method_name or self._method,
            self._stream if stream is None else stream,
            self._model_id if multiplexed_model_id is None
            else multiplexed_model_id,
            self._replica_index if replica_index is None
            else replica_index)

    def __getattr__(self, name: str) -> "DeploymentHandle":
        if name.startswith("_"):
            raise AttributeError(name)
        return DeploymentHandle(self.deployment_name, self.app_name,
                                self._ctrl, name, self._stream,
                                self._model_id, self._replica_index)

    # -- routing ----------------------------------------------------------

    def num_replicas(self) -> int:
        """Live replica count (fresh poll) — lets index-pinned callers
        (see ``options(replica_index=...)``) size their routing modulus
        to the deployment's actual width."""
        self._refresh(force=True)
        return len(self._replicas)

    def _ensure_listener(self):
        """Long-poll push of replica-set changes (reference:
        _private/long_poll.py LongPollClient): one daemon thread parks in
        the controller's listen_for_change, so scale-ups/downs reach this
        handle promptly instead of on the next TTL poll, and steady-state
        traffic costs the controller one parked waiter, not one
        get_replicas per poll interval. The thread holds only a WEAKREF to
        this handle and exits when the handle is collected — short-lived
        handles (e.g. per-request ones) must not each pin a thread."""
        if self._listener_started:
            return
        self._listener_started = True
        import threading
        import weakref
        threading.Thread(target=_listen_loop_weak,
                         args=(weakref.ref(self),), daemon=True,
                         name=f"serve-lp-{self.deployment_name}").start()

    def _refresh(self, force: bool = False):
        import ray_tpu_torch
        now = time.monotonic()
        if not force and self._replicas and (
                now - self._last_refresh < _cfg.serve_replica_poll_s):
            return
        version, replicas = ray_tpu_torch.get(self._ctrl.get_replicas.remote(
            self.app_name, self.deployment_name))
        if version != self._version:
            self._version = version
            self._replicas = replicas
            self._inflight = {i: 0 for i in range(len(replicas))}
        self._last_refresh = now

    @staticmethod
    def _affinity_key(args: tuple, kwargs: dict) -> Optional[str]:
        """Prefix-affinity routing key for LLM-style calls: an explicit
        ``session_id`` (kwarg or request field) wins; otherwise the head
        of the request dict's prompt — the first N tokens/chars, which is
        exactly the region the paged engine's prefix cache can reuse.
        Non-LLM calls (no dict request, no session) return None and keep
        pure least-loaded routing."""
        req = args[0] if args and isinstance(args[0], dict) else None
        sid = kwargs.get("session_id") or (
            req.get("session_id") if req else None)
        if sid:
            return f"sid:{sid}"
        if req is None:
            return None
        prompt = req.get("prompt")
        if isinstance(prompt, str) and prompt:
            return "tok:" + prompt[:256]
        if isinstance(prompt, (list, tuple)) and prompt:
            return "tok:" + ",".join(map(str, prompt[:64]))
        return None

    def _pick(self, replicas: list, affinity: Optional[str] = None) -> int:
        """Power-of-two-choices over local in-flight counts
        (reference: pow_2_router.py:27). With a multiplexed model id,
        rendezvous hashing over stable replica (actor) ids instead: same
        model → same replica while it lives, so its weights stay
        cache-hot (multiplex.py routing note). An affinity key (shared
        prompt prefix / session) rendezvous-hashes the same way — same
        prefix → same replica → warm prefix cache — but yields to the
        least-loaded replica when the preferred one is clearly busier.
        Operates on the caller's SNAPSHOT of the replica list — the
        listener thread may swap self._replicas concurrently."""
        n = len(replicas)
        if n == 1:
            return 0
        import hashlib

        def rendezvous(key):
            def score(i):
                rid = replicas[i]._actor_id.hex()
                return hashlib.md5(f"{key}:{rid}".encode()).digest()
            return max(range(n), key=score)

        if self._model_id:
            return rendezvous(self._model_id)
        if affinity is not None:
            pref = rendezvous(affinity)
            loads = [self._inflight.get(i, 0) for i in range(n)]
            if loads[pref] <= min(loads) + _AFFINITY_SLACK:
                return pref
            return loads.index(min(loads))
        i, j = random.sample(range(n), 2)
        return i if self._inflight.get(i, 0) <= self._inflight.get(j, 0) \
            else j

    @staticmethod
    def _make_chan_spec():
        """Channel spec for the static decode plan, or None when it
        can't engage from this process (flag off, no shm store — local
        mode — or this caller sits on an own-store node and can't share
        a store with a head-store replica)."""
        if not _cfg.serve_static_decode_plan:
            return None
        from ..core import runtime as rt_mod
        rt = rt_mod.get_runtime_if_exists()
        if getattr(rt, "store", None) is None or \
                getattr(rt, "own_store", False):
            return None
        import os
        return {"base": os.urandom(16), "stop": os.urandom(16),
                "ring": max(2, _cfg.serve_stream_ring)}

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        import ray_tpu_torch
        t0 = time.perf_counter()
        self._refresh()
        self._ensure_listener()
        deadline = time.monotonic() + 30.0
        while not self._replicas:
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"no replicas for {self.deployment_name!r}")
            time.sleep(0.05)
            self._refresh(force=True)
        args = tuple(a._to_object_ref() if isinstance(a, DeploymentResponse)
                     else a for a in args)
        kwargs = {k: (v._to_object_ref()
                      if isinstance(v, DeploymentResponse) else v)
                  for k, v in kwargs.items()}
        replicas = self._replicas  # snapshot: listener may swap the list
        if self._replica_index is not None:
            # pinned routing (PD channel pairing): the caller addresses a
            # specific replica by stable index, modulo the live count so a
            # scale-down degrades to wraparound instead of erroring
            idx = self._replica_index % len(replicas)
        else:
            idx = self._pick(replicas, self._affinity_key(args, kwargs))
        replica = replicas[idx]
        self._inflight[idx] = self._inflight.get(idx, 0) + 1
        _fl.evt(_fl.SRV_DISPATCH, idx, int(self._stream))

        def done(i=idx):
            self._inflight[i] = max(0, self._inflight.get(i, 1) - 1)

        request_id = ""
        try:
            from . import metrics as sm
            from .context import get_request_context
            request_id = get_request_context().request_id
            tags = {"app": self.app_name,
                    "deployment": self.deployment_name}
            sm.handle_requests().inc(1.0, tags=tags)
            sm.router_wait().observe(time.perf_counter() - t0, tags=tags)
        except Exception:
            pass  # telemetry must never fail a request

        context = {"app_name": self.app_name,
                   "deployment": self.deployment_name,
                   "multiplexed_model_id": self._model_id,
                   "request_id": request_id}

        if self._stream:
            import ray_tpu_torch
            tags = {"app": self.app_name, "deployment": self.deployment_name}
            chan = self._make_chan_spec()
            resp = ray_tpu_torch.get(replica.handle_request_streaming.remote(
                self._method, args, kwargs, context, chan))
            try:
                from . import metrics as sm
                sm.stream_dispatches().inc(1.0, tags={
                    **tags, "transport": "chan" if isinstance(resp, dict)
                    else "poll"})
            except Exception:
                pass  # telemetry must never fail a request
            if isinstance(resp, dict) and resp.get("chan") is not None:
                # static decode plan engaged: items arrive over the ring
                # channel, no per-chunk actor calls
                _fl.evt(_fl.SRV_STREAM_START, int(resp["chan"]), 1)
                return ChannelResponseGenerator(replica, chan, done, tags)
            _fl.evt(_fl.SRV_STREAM_START, int(resp), 0)
            return DeploymentResponseGenerator(replica, resp, done, tags)

        def retry():
            self._refresh(force=True)
            rs = self._replicas
            if not rs:
                raise RuntimeError(
                    f"no replicas for {self.deployment_name!r}")
            r = rs[self._pick(rs)]
            return r.handle_request.remote(self._method, args, kwargs,
                                           context)

        ref = replica.handle_request.remote(self._method, args, kwargs,
                                            context)
        return DeploymentResponse(ref, done, retry)
