"""ServeController + ReplicaActor: the reconciling control loop.

Counterpart of ``ray_tpu/serve/controller.py``, on the port's runtime: a
replica asks for ``num_gpus`` (whole devices of its node) where the
reference asks for ``num_tpus``.

Reference parity: serve/_private/controller.py:88 (singleton controller,
deploy_application :783), deployment_state.py (replica state machine),
replica.py:945 (ReplicaActor), autoscaling_state.py + autoscaling_policy.py
:12 (_calculate_desired_num_replicas over queue metrics).

The controller is an async actor: `deploy_application` materializes replica
actors for every deployment spec; a reconcile task keeps replica counts at
target, replaces dead replicas, and autoscales queue-length-based between
min/max replicas.
"""
from __future__ import annotations

import asyncio
import math
import time
from typing import Any, Optional

from ..core import flight as _fl
from .api import AutoscalingConfig, DeploymentSpec

#: update_user_config waits this long at a time for a routed replica's
#: reconfigure(), at most ten times, before it fails the update
RECONFIGURE_WAIT_S = 30.0


class ReplicaActor:
    """Hosts one replica of a deployment's callable (reference:
    replica.py:945 — async execution with max_ongoing_requests enforced by
    actor max_concurrency; here requests are counted for autoscaling
    stats)."""

    def __init__(self, spec_blob: bytes):
        import cloudpickle
        spec, handle_args, handle_kwargs = cloudpickle.loads(spec_blob)
        fc = spec.func_or_class
        self._ongoing = 0
        self._total = 0
        self._streams: dict[int, Any] = {}
        self._pending: dict[int, Any] = {}  # parked __anext__ futures
        self._stream_seq = 0
        if isinstance(fc, type):
            self._callable = fc(*handle_args, **handle_kwargs)
        else:
            if handle_args or handle_kwargs:
                raise TypeError("function deployments take no init args")
            self._callable = fc
        # user_config is applied by the controller through the async
        # reconfigure() path right after creation (supports async def
        # reconfigure too; a sync __init__ could not await it)

    async def _invoke(self, method: str, args: tuple, kwargs: dict,
                      context: Optional[dict]):
        from .context import reset_request_context, set_request_context
        token = set_request_context(**(context or {}))
        try:
            # "__call__" covers both function deployments and class __call__
            target = (self._callable if method == "__call__"
                      else getattr(self._callable, method))
            if asyncio.iscoroutinefunction(getattr(target, "__call__",
                                                   target)) or \
                    asyncio.iscoroutinefunction(target):
                out = target(*args, **kwargs)
            else:
                # sync callables must not block the replica's event loop
                # (reference: replica.py runs sync user code in a thread);
                # the contextvar copies into the executor thread via
                # a captured Context
                import contextvars
                ctx = contextvars.copy_context()
                loop = asyncio.get_event_loop()
                out = await loop.run_in_executor(
                    None, lambda: ctx.run(target, *args, **kwargs))
            # inspect.iscoroutine, NOT asyncio.iscoroutine: on py<3.12 the
            # asyncio one also accepts PLAIN GENERATORS (legacy @coroutine
            # support), and awaiting a sync-generator deployment's return
            # value raises TypeError instead of streaming it
            import inspect
            if inspect.iscoroutine(out):
                out = await out
            return out
        finally:
            reset_request_context(token)

    @staticmethod
    def _observe(context: Optional[dict], t0: float, outcome: str):
        """Replica-side telemetry (reference: serve/_private replica
        processing-latency + request counters). Never raises."""
        import time
        try:
            from . import metrics as sm
            tags = {"app": (context or {}).get("app_name", ""),
                    "deployment": (context or {}).get("deployment", "")}
            sm.replica_latency().observe(time.perf_counter() - t0,
                                         tags=tags)
            sm.replica_requests().inc(
                1.0, tags={**tags, "outcome": outcome})
        except Exception:
            pass  # telemetry must never fail a request

    async def handle_request(self, method: str, args: tuple, kwargs: dict,
                             context: Optional[dict] = None):
        import time
        self._ongoing += 1
        self._total += 1
        req = self._total
        t0 = time.perf_counter()
        outcome = "ok"
        _fl.evt(_fl.SRV_REQ_BEGIN, req)
        try:
            return await self._invoke(method, args, kwargs, context)
        except BaseException:
            outcome = "error"
            raise
        finally:
            self._ongoing -= 1
            _fl.evt(_fl.SRV_REQ_END, req, int(outcome == "ok"))
            self._observe(context, t0, outcome)

    # -- streaming responses (reference: replica.py handles generator
    # results via ray streaming generators; here the replica retains the
    # generator and the caller drains it in batched stream_next calls) ----

    async def handle_request_streaming(self, method: str, args: tuple,
                                       kwargs: dict,
                                       context: Optional[dict] = None,
                                       chan: Optional[dict] = None):
        import time
        self._ongoing += 1
        self._total += 1
        req = self._total
        t0 = time.perf_counter()
        _fl.evt(_fl.SRV_REQ_BEGIN, req)
        try:
            out = await self._invoke(method, args, kwargs, context)
            if not hasattr(out, "__anext__") and \
                    not hasattr(out, "__next__"):
                raise TypeError(
                    f"streaming call to {method!r} returned "
                    f"{type(out).__name__}, not a generator")
        except BaseException:
            self._ongoing -= 1
            _fl.evt(_fl.SRV_REQ_END, req, 0)
            self._observe(context, t0, "error")
            raise
        # latency here covers the call that produced the generator; the
        # drain is accounted at the proxy's e2e histogram
        _fl.evt(_fl.SRV_REQ_END, req, 1)
        self._observe(context, t0, "ok")
        self._stream_seq += 1
        sid = self._stream_seq
        self._streams[sid] = out
        if chan is not None and self._start_stream_channel(sid, out, chan,
                                                           context):
            # static decode plan accepted: the caller reads items from
            # the ring channel; no stream_next dispatches will follow
            return {"chan": sid}
        return sid

    def _start_stream_channel(self, sid: int, gen, chan: dict,
                              context: Optional[dict]) -> bool:
        """Serve this stream over a sealed ring channel: a drain thread
        pulls the generator and seals each item into shm; the handle
        reads them directly — zero control-plane dispatches per item
        (reference analog: compiling the decode step into a static plan
        instead of one stream_next RPC per chunk). Returns False when
        this replica can't share a store with the caller (own-store
        node) so the handle falls back to the poll transport."""
        import os
        if os.environ.get("RTPU_OWN_STORE") == "1":
            return False
        from ..core import runtime as rt_mod
        from ..core.ids import ObjectID
        from ..dag.channel import (ChannelClosed, RingWriter,
                                   drain_stale_slots)
        rt = rt_mod.get_runtime_if_exists()
        store = getattr(rt, "store", None)
        if store is None:
            return False
        import asyncio as _aio
        import threading
        loop = _aio.get_running_loop()
        stop_oid = ObjectID(chan["stop"])
        writer = RingWriter(store, chan["base"], stop_oid,
                            int(chan["ring"]))
        is_async = hasattr(gen, "__anext__")

        def drain():
            # items are counted by the CONSUMING handle (symmetric with
            # the poll transport) — no replica-side inc, or the series
            # would double
            _fl.evt(_fl.SRV_DRAIN_BEGIN, sid)
            try:
                while True:
                    if writer.closed():
                        break  # consumer cancelled: stop pulling
                    try:
                        if is_async:
                            item = _aio.run_coroutine_threadsafe(
                                gen.__anext__(), loop).result()
                        else:
                            item = next(gen)
                    except (StopIteration, StopAsyncIteration):
                        writer.write(("e", None))
                        break
                    except BaseException as e:  # noqa: BLE001 — shipped
                        writer.write(("x", e))
                        break
                    writer.write(("i", item))
            except ChannelClosed:
                pass  # consumer cancelled mid-write
            except Exception:
                import traceback
                traceback.print_exc()
            finally:
                _fl.evt(_fl.SRV_DRAIN_END, sid, writer.seq)
                try:
                    # cancelled streams leave the stop flag and a ring
                    # window of unread slots behind: sweep them
                    if store.contains(stop_oid):
                        drain_stale_slots(
                            store,
                            [chan["base"], writer.ack_base],
                            writer.seq - int(chan["ring"]), writer.seq)
                        store.delete(stop_oid)
                except Exception:
                    pass  # store closing: slots die with it
                loop.call_soon_threadsafe(self._drop_stream, sid)

        threading.Thread(target=drain, daemon=True,
                         name=f"serve-stream-chan-{sid}").start()
        return True

    async def stream_next(self, sid: int, max_items: int = 8):
        """(items, done): blocks for the FIRST item only, then takes up to
        max_items - 1 more that are already available — a slow generator
        streams item-by-item (low latency), a fast one ships batches (the
        round-trip amortization). The possibly-unfinished __anext__ is
        parked in _pending for the next call, never cancelled (cancelling
        mid-__anext__ would corrupt the generator)."""
        gen = self._streams.get(sid)
        if gen is None:
            return [], True
        items: list = []
        done = False
        try:
            if hasattr(gen, "__anext__"):
                pending = self._pending.pop(sid, None)
                while len(items) < max_items:
                    if pending is None:
                        pending = asyncio.ensure_future(gen.__anext__())
                    try:
                        if items:
                            # past the 1st item take only near-ready ones:
                            # a tiny positive timeout lets a ready
                            # __anext__ actually run (timeout=0 would just
                            # check done() on the never-scheduled task and
                            # defeat the batching)
                            item = await asyncio.wait_for(
                                asyncio.shield(pending), 0.002)
                        else:
                            item = await pending
                    except asyncio.TimeoutError:
                        self._pending[sid] = pending
                        return items, False
                    except StopAsyncIteration:
                        done = True
                        break
                    pending = None
                    items.append(item)
                if pending is not None:
                    self._pending[sid] = pending
            else:
                # sync generator: one item per call — next() can block
                # arbitrarily in a pinned executor thread, so favor
                # latency; sync deployments wanting throughput should
                # yield pre-batched chunks
                loop = asyncio.get_event_loop()
                def pull():
                    try:
                        return [next(gen)], False
                    except StopIteration:
                        return [], True
                items, done = await loop.run_in_executor(None, pull)
        except BaseException:
            self._drop_stream(sid)
            raise
        if done:
            self._drop_stream(sid)
        return items, done

    def _drop_stream(self, sid: int):
        if self._streams.pop(sid, None) is not None:
            self._ongoing -= 1
        pending = self._pending.pop(sid, None)
        if pending is not None:
            pending.cancel()

    async def stream_cancel(self, sid: int):
        self._drop_stream(sid)

    async def stats(self) -> dict:
        return {"ongoing": self._ongoing, "total": self._total}

    async def reconfigure(self, user_config: Any):
        if hasattr(self._callable, "reconfigure"):
            res = self._callable.reconfigure(user_config)
            if asyncio.iscoroutine(res):
                await res

    async def set_self(self, handle):
        """Inject this replica's OWN actor handle (the controller calls
        this right after creation, passing the handle back in). The
        prefix-directory client publishes it as the owner of every page
        hash this replica registers (llm/serving.py
        set_replica_handle)."""
        if hasattr(self._callable, "set_replica_handle"):
            self._callable.set_replica_handle(handle)

    async def health_check(self) -> bool:
        if hasattr(self._callable, "check_health"):
            self._callable.check_health()
        return True


class _DeploymentState:
    def __init__(self, spec: DeploymentSpec, app: str, version_counter):
        self.spec = spec
        self.app = app
        self.replicas: list = []          # actor handles
        self.target = spec.num_replicas
        if spec.autoscaling_config:
            self.target = spec.autoscaling_config.min_replicas
        # versions are controller-global monotonic so a redeploy can never
        # collide with a cached handle's last-seen version
        self._vc = version_counter
        self.version = next(version_counter)
        self._last_scale_up = 0.0
        self._last_scale_down = 0.0
        # cached TSDB autoscale signals (obs/scraper.py), refreshed at
        # most once per scrape period per deployment; the remote fetch
        # runs OFF the controller's event loop (_sig_fetching guards
        # one in-flight refresh)
        self._sig = None
        self._sig_ts = 0.0
        self._sig_fetching = False
        # long-poll wakeup (reference: _private/long_poll.py:222 — waiters
        # park on the event; bump() swaps in a fresh one)
        self.changed = asyncio.Event()

    def bump(self):
        self.version = next(self._vc)
        old, self.changed = self.changed, asyncio.Event()
        old.set()


class ServeController:
    """Singleton control plane (reference: controller.py:88)."""

    def __init__(self):
        import itertools
        self._apps: dict[str, dict[str, _DeploymentState]] = {}
        self._ingress: dict[str, str] = {}
        # app -> URL route prefix (reference: route_prefix in serve.run)
        self._routes: dict[str, str] = {}
        # proxy fleet (serve/frontdoor): [{"actor", "port", "index"}],
        # controller-managed like replicas — dead proxies are replaced
        # on their port by the proxy loop (_proxy_loop)
        self._proxies: list[dict] = []
        self._http_port = None
        self._reconcile_task = None
        self._proxy_task = None
        self._shutdown = False
        self._version_counter = itertools.count(1)
        self._ticks = 0
        # app -> prefill-replica keys already wired to a decode KV ring
        # (MPMD PD pairing over DeploymentSpec.role)
        self._pd_paired: dict[str, set] = {}
        # last published route-table snapshot (minus the version field):
        # republished through frontdoor/routetable.py whenever topology
        # drifts from it
        self._pub_state = None

    # -- deploy ------------------------------------------------------------

    async def deploy_application(self, app_name: str, specs_blob: bytes,
                                 http_port: Optional[int] = None,
                                 num_proxies: Optional[int] = None) -> None:
        import cloudpickle
        specs, ingress, route_prefix = cloudpickle.loads(specs_blob)
        if app_name in self._apps:  # redeploy: tear down the old replicas
            await self.delete_application(app_name)
        states: dict[str, _DeploymentState] = {}
        for spec in specs:
            states[spec.name] = _DeploymentState(spec, app_name,
                                                 self._version_counter)
        self._apps[app_name] = states
        self._ingress[app_name] = ingress
        # "/" (the default) means app-name addressing (/<app>/...); only
        # EXPLICIT prefixes join the longest-match route table
        if route_prefix and route_prefix != "/":
            if not route_prefix.startswith("/"):
                raise ValueError(
                    f"route_prefix must start with '/', got "
                    f"{route_prefix!r}")
            owner = next((a for a, p in self._routes.items()
                          if p == route_prefix and a != app_name), None)
            if owner is not None:
                raise ValueError(
                    f"route_prefix {route_prefix!r} is already used by "
                    f"app {owner!r}")
            self._routes[app_name] = route_prefix
        else:
            self._routes.pop(app_name, None)
        for st in states.values():
            await self._scale_to_target(st)
        await self._pair_pd_roles(app_name)
        if http_port is not None:
            await self._ensure_proxies(http_port, num_proxies)
        self._publish_routes()
        if self._reconcile_task is None:
            loop = asyncio.get_event_loop()
            self._reconcile_task = loop.create_task(self._reconcile_loop())
            self._proxy_task = loop.create_task(self._proxy_loop())

    def _replica_blob(self, spec: DeploymentSpec) -> bytes:
        import cloudpickle
        from .api import BoundDeployment
        from .handle import DeploymentHandle
        # bound children become live handles (model composition)
        def conv(a):
            if isinstance(a, BoundDeployment):
                import ray_tpu_torch
                ctrl = ray_tpu_torch.get_actor("rtpu:serve:controller")
                return DeploymentHandle(a.spec.name, spec_app(a), ctrl)
            return a

        def spec_app(bound):  # child deployments live in the same app
            for app, states in self._apps.items():
                if bound.spec.name in states:
                    return app
            return "default"

        args = tuple(conv(a) for a in spec.init_args)
        kwargs = {k: conv(v) for k, v in spec.init_kwargs.items()}
        return cloudpickle.dumps((spec, args, kwargs))

    async def _start_replica(self, st: _DeploymentState):
        import ray_tpu_torch
        cls = ray_tpu_torch.remote(ReplicaActor)
        opts = dict(st.spec.ray_actor_options)
        actor = cls.options(
            num_cpus=opts.get("num_cpus", 0.1),
            num_gpus=opts.get("num_gpus", 0),
            resources=opts.get("resources"),
            max_concurrency=max(st.spec.max_ongoing_requests, 1),
        ).remote(self._replica_blob(st.spec))
        # configured BEFORE the replica enters routing (async-aware), and
        # again while an update_user_config persisted a newer config
        # during the await: that update's replica snapshot missed this
        # replica, which would otherwise route with the old config
        sent = None
        while st.spec.user_config is not sent:
            sent = st.spec.user_config
            await actor.reconfigure.remote(sent)
        # hand the replica its own handle (prefix-directory ownership);
        # fire-and-forget: replicas without the hook ignore it
        try:
            actor.set_self.remote(actor)
        except Exception:
            pass  # replica already dying; reconcile replaces it
        st.replicas.append(actor)
        st.bump()

    async def _pair_pd_roles(self, app: str) -> None:
        """MPMD prefill/decode pairing: for an app carrying
        role="prefill" and role="decode" deployment groups, give every
        prefill replica a sealed KV ring into a decode peer (round-robin
        i mod n_decode — llm/pd_disagg.py open_kv_channel /
        connect_kv_channel). Steady-state KV handoff between the pair
        then costs zero control dispatches. Idempotent per prefill
        replica; a replacement replica gets wired on the next reconcile
        tick. Decode replicas may consume several rings (one per paired
        prefill producer)."""
        states = self._apps.get(app, {})
        pre = [r for st in states.values()
               if getattr(st.spec, "role", None) == "prefill"
               for r in st.replicas]
        dec = [r for st in states.values()
               if getattr(st.spec, "role", None) == "decode"
               for r in st.replicas]
        if not pre or not dec:
            return
        paired = self._pd_paired.setdefault(app, set())
        for i, p in enumerate(pre):
            key = getattr(p, "_actor_id", None) or id(p)
            if key in paired:
                continue
            d = dec[i % len(dec)]
            try:
                spec = await d.handle_request.remote(
                    "open_kv_channel", (4, None), {}, None)
                if not spec:
                    continue  # no shared store: actor-call handoff stays
                if await p.handle_request.remote(
                        "connect_kv_channel", (spec,), {}, None):
                    paired.add(key)
            except Exception:
                pass  # replica dying; reconcile replaces then re-pairs

    async def _close_pd_rings(self, app: str, states: dict) -> None:
        """Close the KV ring of every prefill replica _pair_pd_roles
        paired, before the application's replicas are killed: the
        sentinel retires the decode replica's drain thread, which sweeps
        the ring, and close_kv_channel returns once it has. Killed with
        their rings open, the pair would leave the ring's trailing acks
        in the store."""
        paired = self._pd_paired.pop(app, set())
        closes = [r.handle_request.remote("close_kv_channel", (), {}, None)
                  for st in states.values()
                  if getattr(st.spec, "role", None) == "prefill"
                  for r in st.replicas
                  if (getattr(r, "_actor_id", None) or id(r)) in paired]
        for ref in closes:
            try:
                await asyncio.wait_for(ref, timeout=60)
            except Exception:
                pass  # replica dying: nothing left to close

    async def _scale_to_target(self, st: _DeploymentState):
        while len(st.replicas) < st.target:
            await self._start_replica(st)
        while len(st.replicas) > st.target:
            import ray_tpu_torch
            victim = st.replicas.pop()
            st.bump()
            try:
                ray_tpu_torch.kill(victim)
            except Exception:
                pass  # already dead

    # -- routing state -----------------------------------------------------

    async def get_replicas(self, app: str, deployment: str):
        st = self._apps.get(app, {}).get(deployment)
        if st is None:
            raise ValueError(f"no deployment {deployment!r} in app {app!r}")
        return st.version, list(st.replicas)

    async def listen_for_change(self, app: str, deployment: str,
                                known_version: int,
                                timeout_s: float = 30.0):
        """Long-poll: return (version, replicas) as soon as the replica set
        differs from the caller's known_version, else after timeout_s with
        the unchanged state (reference: LongPollHost.listen_for_change,
        _private/long_poll.py:222). Many handles parking here cost only an
        asyncio waiter each — no controller work per poll tick."""
        st = self._apps.get(app, {}).get(deployment)
        if st is None:
            raise ValueError(f"no deployment {deployment!r} in app {app!r}")
        if st.version == known_version:
            try:
                await asyncio.wait_for(st.changed.wait(), timeout_s)
            except asyncio.TimeoutError:
                pass
            # re-resolve: a redeploy may have replaced the state object
            st = self._apps.get(app, {}).get(deployment)
            if st is None:
                raise ValueError(
                    f"deployment {deployment!r} was deleted from {app!r}")
        return st.version, list(st.replicas)

    async def update_user_config(self, app: str, deployment: str,
                                 user_config) -> None:
        """Lightweight update: push reconfigure() to every live replica
        concurrently, then persist for future replicas. Application
        errors SURFACE (and the old config stays for future replicas);
        only dying-replica errors are ignored — the reconcile loop
        replaces those. It returns once every replica in routing holds
        the new config: a replica whose reconfigure() outlasts
        ``RECONFIGURE_WAIT_S`` is waited for again while the
        reconcile loop keeps it in routing (ten waits at most, then the
        update fails naming it), and a replica that entered routing
        while the update ran, configured with the old config, is sent
        the new one."""
        import dataclasses

        from ..exceptions import ActorDiedError, WorkerCrashedError
        st = self._apps.get(app, {}).get(deployment)
        if st is None:
            raise ValueError(f"no deployment {deployment!r} in app {app!r}")
        done: list = []
        app_error = None
        pending = list(st.replicas)
        while pending and app_error is None:
            refs = [(r, r.reconfigure.remote(user_config)) for r in pending]
            done += pending
            for r, ref in refs:
                for _ in range(10):
                    try:
                        await asyncio.wait_for(ref,
                                               timeout=RECONFIGURE_WAIT_S)
                    except asyncio.TimeoutError:
                        if any(r is x for x in st.replicas):
                            continue  # slow but routed: wait again
                    except (ActorDiedError, WorkerCrashedError):
                        pass  # dying replica: reconcile will replace it
                    except Exception as e:  # noqa: BLE001 — user bug
                        app_error = e
                    break
                else:
                    raise RuntimeError(
                        f"reconfigure({user_config!r}) did not return on "
                        f"replica {r!r} in routing; config NOT persisted")
            pending = [r for r in st.replicas
                       if not any(r is d for d in done)]
        if app_error is not None:
            raise RuntimeError(
                f"reconfigure({user_config!r}) raised on a replica; "
                f"config NOT persisted") from app_error
        st.spec = dataclasses.replace(st.spec, user_config=user_config)

    async def set_target(self, app: str, deployment: str, n: int) -> None:
        """Manually retarget a deployment's replica count (ops escape
        hatch; autoscaling keeps adjusting around it when configured)."""
        st = self._apps.get(app, {}).get(deployment)
        if st is None:
            raise ValueError(f"no deployment {deployment!r} in app {app!r}")
        st.target = max(0, int(n))
        await self._scale_to_target(st)

    async def get_routes(self) -> dict:
        """{route_prefix: app} for the proxy's longest-prefix matching."""
        return {v: k for k, v in self._routes.items()}

    async def get_proxies(self) -> list:
        """The live proxy fleet with actor handles (ops/chaos tooling)."""
        return [{"actor": p["actor"], "port": p["port"],
                 "index": p["index"]} for p in self._proxies]

    async def get_ingress(self, app: str) -> str:
        if app not in self._ingress:
            raise ValueError(f"no application {app!r}")
        return self._ingress[app]

    async def status(self) -> dict:
        out: dict = {"applications": {},
                     "proxies": [{"index": p["index"], "port": p["port"]}
                                 for p in self._proxies],
                     "http_port": self._http_port}
        for app, states in self._apps.items():
            out["applications"][app] = {
                "ingress": self._ingress.get(app),
                "deployments": {
                    name: {"target_replicas": st.target,
                           "running_replicas": len(st.replicas),
                           "autoscaling": st.spec.autoscaling_config
                           is not None}
                    for name, st in states.items()},
            }
        return out

    async def delete_application(self, app: str) -> None:
        self._routes.pop(app, None)
        import ray_tpu_torch
        states = self._apps.pop(app, None)
        self._ingress.pop(app, None)
        self._publish_routes()
        if not states:
            return
        await self._close_pd_rings(app, states)
        for st in states.values():
            for r in st.replicas:
                try:
                    ray_tpu_torch.kill(r)
                except Exception:
                    pass  # already dead
            # gauges are last-write-wins: without an explicit zero the
            # deleted deployment's queue_depth/replicas series hold their
            # final value on /metrics forever
            try:
                from . import metrics as sm
                tags = {"app": st.app, "deployment": st.spec.name}
                sm.queue_depth().set(0.0, tags=tags)
                sm.replica_count().set(0.0, tags=tags)
            except Exception:
                pass  # metrics store gone mid-shutdown

    async def shutdown(self) -> None:
        self._shutdown = True
        for app in list(self._apps):
            await self.delete_application(app)
        import ray_tpu_torch
        for rec in self._proxies:
            try:
                ray_tpu_torch.kill(rec["actor"])
            except Exception:
                pass  # already dead
        self._proxies.clear()

    # -- reconcile + autoscaling ------------------------------------------

    async def _reconcile_loop(self):
        import ray_tpu_torch
        while not self._shutdown:
            await asyncio.sleep(0.25)
            self._ticks += 1
            deep = self._ticks % 4 == 0  # user health_check every ~1s
            for states in list(self._apps.values()):
                for st in list(states.values()):
                    alive = []
                    ongoing = 0
                    for r in st.replicas:
                        try:
                            s = await r.stats.remote()
                            if deep:
                                await r.health_check.remote()
                            ongoing += s["ongoing"]
                            alive.append(r)
                        except Exception:
                            # dead or failing health: drop from routing and
                            # kill so _scale_to_target replaces it
                            st.bump()
                            try:
                                ray_tpu_torch.kill(r)
                            except Exception:
                                pass  # already dead
                    st.replicas = alive
                    # membership check right before the write (no await in
                    # between, and the controller is single-event-loop):
                    # delete_application may have zeroed these gauges while
                    # this tick awaited replica stats, and a write from the
                    # pre-delete snapshot would resurrect the series at a
                    # stale value forever
                    if self._apps.get(st.app, {}).get(st.spec.name) is st:
                        try:
                            from . import metrics as sm
                            tags = {"app": st.app,
                                    "deployment": st.spec.name}
                            sm.queue_depth().set(ongoing, tags=tags)
                            sm.replica_count().set(len(st.replicas),
                                                   tags=tags)
                        except Exception:
                            pass  # telemetry is best-effort here
                    cfg = st.spec.autoscaling_config
                    if cfg is not None:
                        self._autoscale(st, cfg, ongoing)
                    await self._scale_to_target(st)
            if deep:
                # replacement replicas of role="prefill" groups need a
                # fresh KV ring to a decode peer; no-op once paired
                for app in list(self._apps):
                    await self._pair_pd_roles(app)
            # topology drift (replica counts, proxy replacements) reaches
            # the shared route table here; no-op when nothing changed
            self._publish_routes()

    async def _proxy_loop(self):
        """Replace dead proxies every ~1 s, apart from the replica loop:
        that loop awaits every replica's stats(), and a replacement
        replica answers only once its constructor has returned, which
        must not keep a dead proxy's port closed (a divergence from the
        reference, whose one loop checks both)."""
        while not self._shutdown:
            await asyncio.sleep(1.0)
            if self._proxies and not self._shutdown:
                await self._check_proxies()
                self._publish_routes()

    def _autoscale(self, st: _DeploymentState, cfg: AutoscalingConfig,
                   total_ongoing: int):
        """(reference: autoscaling_policy.py:12
        _calculate_desired_num_replicas) — the ongoing-requests rule,
        composed with the TSDB signals (shed rate, TTFT/e2e burn rate,
        TTFT slope, per-tenant admission backlog) so a deployment scales
        OUT before the first 429 fires. cfg.serve_autoscale_signals=off
        reproduces the legacy queue-depth-only decisions exactly: the
        signal path then contributes nothing to ``desired``."""
        now = time.monotonic()
        desired = math.ceil(total_ongoing / max(cfg.target_ongoing_requests,
                                                1e-9))
        desired = max(cfg.min_replicas, min(cfg.max_replicas, desired))
        sig_reason = None
        sig = self._signals_for(st)
        if sig is not None and sig.get("scale_out"):
            # step out by one replica per decision: the signals say
            # "capacity is short", not by how much — the burn windows
            # re-fire next period if one replica wasn't enough. A
            # firing signal also vetoes any concurrent scale-DOWN
            # (including at max_replicas, where stepped == target and
            # the down branch's desired < target can no longer hold —
            # an overloaded deployment at max must not oscillate)
            legacy = desired
            stepped = min(cfg.max_replicas, st.target + 1)
            desired = max(desired, stepped)
            if desired > st.target and stepped > legacy:
                sig_reason = (sig.get("reasons") or ["signal"])[0]
        direction = None
        if desired > st.target and \
                now - self._last(st, "up") >= cfg.upscale_delay_s:
            st.target = desired
            st._last_scale_up = now
            direction = "up"
        elif desired < st.target and \
                now - self._last(st, "down") >= cfg.downscale_delay_s:
            st.target = desired
            st._last_scale_down = now
            direction = "down"
        if direction is not None:
            try:
                from . import metrics as sm
                sm.autoscale_decisions().inc(1.0, tags={
                    "app": st.app, "deployment": st.spec.name,
                    "direction": direction})
                if direction == "up" and sig_reason is not None:
                    sm.autoscale_signal().inc(1.0, tags={
                        "app": st.app, "deployment": st.spec.name,
                        "reason": sig_reason})
            except Exception:
                pass  # telemetry is best-effort here

    def _signals_for(self, st: _DeploymentState) -> Optional[dict]:
        """The deployment's cached TSDB scale-out signals; None when
        signals are off, the TSDB is disabled, or the head is
        unreachable — every failure mode falls back to the legacy
        ongoing-requests rule. The remote fetch blocks up to the rpc
        timeout when the head is wedged, so it runs in an executor
        thread and THIS call returns the previous cache immediately —
        the reconcile loop (replica/proxy respawn) must never stall
        behind a slow head."""
        from ..core.config import cfg
        if str(cfg.serve_autoscale_signals).lower() in ("off", "0",
                                                        "false"):
            return None
        now = time.monotonic()
        refresh = max(0.25, min(float(cfg.tsdb_scrape_s), 15.0))
        if (not st._sig_fetching
                and (not st._sig_ts or now - st._sig_ts >= refresh)):
            st._sig_fetching = True
            st._sig_ts = now

            def fetch():
                sig = None
                try:
                    from ..core import runtime as rt_mod
                    rt = rt_mod.get_runtime_if_exists()
                    if isinstance(rt, rt_mod.Runtime):
                        sig = rt.obs_signals(st.app, st.spec.name)
                    elif rt is not None:
                        sig = rt._rpc("obs_signals", st.app,
                                      st.spec.name)
                except Exception:
                    sig = None  # TSDB off / head mid-restart: legacy
                st._sig = sig
                st._sig_fetching = False

            try:
                asyncio.get_running_loop().run_in_executor(None, fetch)
            except RuntimeError:
                # no running loop (unit tests drive _autoscale
                # directly): the head-local path is lock-light and
                # sub-ms, safe to run inline
                fetch()
        return st._sig

    @staticmethod
    def _last(st: _DeploymentState, which: str) -> float:
        return st._last_scale_up if which == "up" else st._last_scale_down

    # -- HTTP proxy fleet (serve/frontdoor) -------------------------------

    async def _spawn_proxy(self, port: int, index: int) -> dict:
        import ray_tpu_torch
        from .proxy import ProxyActor
        cls = ray_tpu_torch.remote(ProxyActor)
        actor = cls.options(max_concurrency=512).remote(port, index)
        await actor.start.remote()
        return {"actor": actor, "port": port, "index": index}

    async def _ensure_proxies(self, port: int,
                              num_proxies: Optional[int] = None):
        """Scale the proxy fleet to N actors on ports port..port+N-1
        (cfg.serve_num_proxies when unspecified). Idempotent; a second
        app deploy reuses the running fleet. Excess proxies (a deploy
        shrinking the fleet) drain: killed after the route table stops
        listing them."""
        from ..core.config import cfg
        if num_proxies is None:
            num_proxies = cfg.serve_num_proxies
        n = max(1, int(num_proxies))
        self._http_port = port
        import ray_tpu_torch
        while len(self._proxies) > n:
            victim = self._proxies.pop()
            self._publish_routes()
            try:
                await victim["actor"].stop.remote()
                ray_tpu_torch.kill(victim["actor"])
            except Exception:
                pass  # already dead
        for i in range(len(self._proxies), n):
            self._proxies.append(await self._spawn_proxy(port + i, i))
        self._publish_routes()

    async def _check_proxies(self):
        """Reconcile tick: replace dead proxies on their port (same
        controller-managed contract as replicas)."""
        import ray_tpu_torch
        for rec in list(self._proxies):
            try:
                await rec["actor"].ping.remote()
            except Exception:
                try:
                    ray_tpu_torch.kill(rec["actor"])
                except Exception:
                    pass  # already dead
                try:
                    fresh = await self._spawn_proxy(rec["port"],
                                                    rec["index"])
                except Exception:
                    # port still lingering in TIME_WAIT or node down:
                    # retry next tick rather than losing the slot
                    continue
                if rec not in self._proxies:
                    # the fleet shrank while the new proxy started
                    try:
                        ray_tpu_torch.kill(fresh["actor"])
                    except Exception:
                        pass  # already dead
                    continue
                self._proxies[self._proxies.index(rec)] = fresh
                self._publish_routes()
        try:
            from . import metrics as sm
            sm.proxy_count().set(float(len(self._proxies)))
        except Exception:
            pass  # telemetry is best-effort here

    # -- shared route table (frontdoor/routetable.py) ---------------------

    def _publish_routes(self):
        """Publish the route-table snapshot to the head's shared
        directory when anything drifted: routes, ingress, per-deployment
        capacity (replicas x max_ongoing — the admission budgets), or
        the proxy fleet. One async frame; proxies TTL-refresh from it
        instead of calling this controller per request."""
        state = {
            "routes": {v: k for k, v in self._routes.items()},
            "ingress": dict(self._ingress),
            "capacity": {
                f"{app}/{name}": [len(st.replicas) or st.target,
                                  st.spec.max_ongoing_requests]
                for app, states in self._apps.items()
                for name, st in states.items()},
            "n_proxies": max(1, len(self._proxies)),
            "proxies": [{"index": p["index"], "port": p["port"]}
                        for p in self._proxies],
        }
        if state == self._pub_state:
            return
        self._pub_state = state
        try:
            from .frontdoor import routetable
            routetable.publish_snapshot(
                {**state, "v": next(self._version_counter)})
        except Exception:
            pass  # no cluster directory (local test): proxies fall back
