"""HTTP proxy actor (aiohttp) — one member of the front-door fleet.

Counterpart of ``ray_tpu/serve/proxy.py``, on the port's runtime.

Reference parity: serve/_private/proxy.py:709 HTTPProxy / :1059 ProxyActor —
uvicorn/Starlette there, aiohttp here (what the image ships). Routes
`/<app_name>` (and `/` for the default app) to the app's ingress handle:
JSON bodies become the callable's argument, JSON-able returns become the
response body.

Front door (serve/frontdoor/): the controller runs N of these behind
one shared route table (frontdoor/routetable.py — refreshed from the
head's directory service on a short TTL, controller RPC only as
fallback), and every request passes the SLO-aware admission gate
(frontdoor/admission.py) before it touches a handle. Past-budget
traffic queues bounded-and-deadlined, then sheds as ``429`` +
``Retry-After``; replica death surfaces as a typed ``503``, a replica
timeout as ``504`` — a healthy front door returns NO bare 500s under
overload or chaos. Session/prefix affinity is consistent across the
fleet for free: handles rendezvous-hash on stable replica actor ids,
so every proxy maps the same session/prefix to the same replica.
"""
from __future__ import annotations

import asyncio
import json
from typing import Optional


_STREAM_END = object()

# the proxy route registers METH_ANY; metric labels must come from this
# fixed set, never the raw (client-controlled) method token
_KNOWN_VERBS = frozenset(
    {"GET", "POST", "PUT", "DELETE", "PATCH", "HEAD", "OPTIONS"})


class ProxyActor:
    def __init__(self, port: int, index: int = 0):
        from .frontdoor.admission import AdmissionController
        self._port = port
        self._index = index
        self._runner = None
        # handle cache: a DeploymentHandle per routing variant, NOT per
        # request — each handle runs one long-poll listener thread, so
        # per-request construction would leak threads/waiters. Bounded
        # LRU; evicted handles are GC'd and their listener threads exit
        # (weakref-based, see handle._ensure_listener)
        from collections import OrderedDict
        self._handles: "OrderedDict" = OrderedDict()
        self._handles_max = 256
        # shared route table snapshot (frontdoor/routetable.py),
        # refreshed off-loop on a short TTL; None until the first fetch
        # (or forever in fallback mode — then per-request controller
        # calls resolve routing and admission stays unconfigured)
        self._snap: Optional[dict] = None
        self._routes: dict = {}
        self._routes_ts = 0.0
        self._admission = AdmissionController(f"proxy-{index}")

    def _handle_for(self, ingress, app_name, stream, model_id,
                    method="__call__"):
        from .handle import DeploymentHandle
        import ray_tpu_torch
        from .api import CONTROLLER_NAME
        key = (app_name, ingress, stream, model_id, method)
        h = self._handles.get(key)
        if h is None:
            ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
            h = DeploymentHandle(ingress, app_name, ctrl, method,
                                 stream=stream,
                                 multiplexed_model_id=model_id)
            self._handles[key] = h
            while len(self._handles) > self._handles_max:
                self._handles.popitem(last=False)
        else:
            self._handles.move_to_end(key)
        return h

    async def start(self) -> int:
        from aiohttp import web

        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", self._dispatch)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, "127.0.0.1", self._port)
        await site.start()
        return self._port

    async def ping(self) -> dict:
        """Controller liveness probe (frontdoor fleet management); the
        pid lets chaos tooling SIGKILL a specific proxy."""
        import os
        return {"port": self._port, "pid": os.getpid(),
                "index": self._index}

    # -- shared route table ------------------------------------------------

    async def _refresh_table(self):
        """TTL-refresh the routing/admission state: ONE dir_query frame
        for the controller-published snapshot; falls back to controller
        RPCs (routing only — admission stays open) when the directory
        is unreachable. Runs off-loop: both paths block."""
        import time as _time
        if _time.monotonic() - self._routes_ts <= 1.0:
            return
        loop = asyncio.get_event_loop()

        def _fetch():
            from .frontdoor import routetable
            snap = routetable.fetch_snapshot()
            if snap is not None:
                return snap, snap.get("routes", {})
            # fallback: a cluster without the directory (local clusters
            # torn mid-test, head restarting) still routes
            try:
                import ray_tpu_torch
                from .api import CONTROLLER_NAME
                ctrl0 = ray_tpu_torch.get_actor(CONTROLLER_NAME)
                return None, ray_tpu_torch.get(ctrl0.get_routes.remote())
            except Exception:
                return None, {}
        snap, routes = await loop.run_in_executor(None, _fetch)
        self._routes = routes
        self._routes_ts = _time.monotonic()
        if snap is not None:
            self._snap = snap
            live = set()
            n = max(1, int(snap.get("n_proxies", 1)))
            for key, cap in snap.get("capacity", {}).items():
                app, _, dep = key.partition("/")
                live.add((app, dep))
                self._admission.configure(
                    app, dep, max(int(cap[0]), 1) * max(int(cap[1]), 1),
                    n_proxies=n)
            self._admission.prune(live)

    def _resolve_ingress(self, app_name: str) -> Optional[str]:
        """Ingress deployment for an app: snapshot first, controller
        RPC fallback. None = unknown app."""
        if self._snap is not None:
            ing = self._snap.get("ingress", {}).get(app_name)
            if ing is not None:
                return ing
        import ray_tpu_torch
        from .api import CONTROLLER_NAME
        try:
            ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
            return ray_tpu_torch.get(ctrl.get_ingress.remote(app_name))
        except ValueError:
            return None

    # -- request path ------------------------------------------------------

    async def _dispatch(self, request):
        """Telemetry shell around _dispatch_inner: mints the request id,
        opens the request's root trace span, and lands the per-route
        counters + e2e latency histogram whatever the outcome."""
        import secrets
        import time as _time

        from aiohttp import web

        from . import metrics as sm
        from ..util import tracing

        rid = secrets.token_hex(8)
        meta = {"app": "", "route": ""}
        t0 = _time.perf_counter()
        status = 500
        try:
            with tracing.span("serve.proxy", root=True) as span_rec:
                if span_rec is not None:
                    span_rec["request_id"] = rid
                resp = await self._dispatch_inner(request, rid, meta)
            status = resp.status
            return resp
        except web.HTTPException as e:
            status = e.status
            raise
        except (ConnectionResetError, asyncio.CancelledError):
            # the client dropped mid-stream: not a server error (499,
            # nginx's client-closed-request), and kept out of the error
            # counter an operator alerts on
            status = 499
            raise
        finally:
            try:
                route = meta["route"] or "/"
                # the route registers METH_ANY, so request.method is an
                # arbitrary client token: allowlist it (same unbounded-
                # cardinality guard as the app label below)
                method = request.method if request.method in _KNOWN_VERBS \
                    else "OTHER"
                sm.proxy_requests().inc(1.0, tags={
                    "route": route, "method": method,
                    # status is a server-chosen HTTP code — a bounded
                    # vocabulary, not client-controlled
                    "status": str(status)})  # graftlint: disable=GL011
                sm.request_latency().observe(
                    _time.perf_counter() - t0,
                    tags={"app": meta["app"], "route": route})
                # 499 (client hung up) and 429 (deliberate shed, its own
                # rtpu_serve_admission_shed_total series) stay out of the
                # error counter operators alert on
                if status >= 400 and status not in (429, 499):
                    sm.request_errors().inc(1.0, tags={
                        "app": meta["app"], "route": route,
                        # bounded server-chosen HTTP code (as above)
                        "code": str(status)})  # graftlint: disable=GL011
                if status >= 500:
                    # the replica-death/timeout paths raise and catch
                    # through executor threads; the exception->traceback
                    # ->frame cycles pin the failed call's ObjectRefs
                    # (and their store error objects) until a gc pass
                    # happens to run. Errors are rare: collect shortly
                    # after, so a chaos kill can't hold the store above
                    # baseline until allocation pressure triggers gc.
                    import gc
                    asyncio.get_event_loop().call_later(0.5, gc.collect)
            except Exception:
                pass  # telemetry must never turn a response into a 500

    async def _dispatch_inner(self, request, rid: str, meta: dict):
        from aiohttp import web

        path = request.match_info["tail"].strip("/")
        # route_prefix longest-match first (reference: the proxy's route
        # table); falls back to /<app_name> addressing
        app_name, subpath = None, ""
        await self._refresh_table()
        routes = self._routes
        full = "/" + path
        for prefix, app in sorted(routes.items(), key=lambda kv:
                                  -len(kv[0])):
            p = prefix.rstrip("/")
            if not p:
                continue  # "/" prefixes never reach the route table
            if full == p or full.startswith(p + "/"):
                app_name = app
                subpath = full[len(p):].strip("/")
                meta["route"] = p
                break
        if app_name is None:
            app_name = path.split("/", 1)[0] if path else "default"
            subpath = path.split("/", 1)[1] if "/" in path else ""
        method = subpath.strip("/").replace("/", "_").replace(
            ".", "_").replace("-", "_") if subpath else "__call__"
        if method != "__call__" and (
                method.startswith("_") or not method.isidentifier()):
            # never expose private/dunder attributes over HTTP
            return web.json_response(
                {"error": f"no route {subpath!r}"}, status=404)
        loop = asyncio.get_event_loop()
        ingress = await loop.run_in_executor(
            None, self._resolve_ingress, app_name)
        if ingress is None:
            if app_name != "default":
                ingress = await loop.run_in_executor(
                    None, self._resolve_ingress, "default")
                if ingress is None:
                    return web.json_response(
                        {"error": f"no app {app_name!r}"}, status=404)
                app_name = "default"
            else:
                return web.json_response(
                    {"error": "no default app"}, status=404)
        # label AFTER ingress resolution: app_name is client-controlled
        # until it resolves against deployed apps, and unresolved names
        # must not mint metric series (unbounded label cardinality —
        # every scanner probe would become a permanent head-store series)
        meta["app"] = app_name
        if not meta["route"]:
            meta["route"] = "/" + app_name

        # body parse BEFORE the gate: tenant resolution (adapter id /
        # body fields) needs it, and a shed should not have done any
        # replica work anyway
        payload: Optional[dict] = None
        if request.can_read_body:
            try:
                payload = await request.json()
            except Exception:
                payload = {"body": (await request.read()).decode(
                    errors="replace")}

        # -- admission gate (frontdoor/admission.py): budget-admit,
        # bounded-queue (weighted-fair per tenant), or shed BEFORE any
        # replica work happens ------------------------------------------
        from ..core.config import cfg as _cfg
        release = None
        if _cfg.serve_admission_control:
            from .frontdoor.admission import ShedError, resolve_tenant
            tenant = resolve_tenant(request.headers, payload)
            try:
                release = await self._admission.acquire(
                    app_name, ingress, tenant)
            except ShedError as shed:
                return web.json_response(
                    {"error": "overloaded", "reason": shed.reason,
                     "retry_after_s": shed.retry_after_s},
                    status=429,
                    headers={"Retry-After": str(shed.retry_after_s)})
        import time as _time
        t_adm = _time.perf_counter()
        try:
            return await self._dispatch_admitted(
                request, rid, meta, app_name, ingress, method, payload)
        finally:
            if release is not None:
                release(_time.perf_counter() - t_adm)

    async def _dispatch_admitted(self, request, rid: str, meta: dict,
                                 app_name: str, ingress: str,
                                 method: str, payload: Optional[dict]):
        from aiohttp import web

        from ..exceptions import (ActorDiedError, GetTimeoutError,
                                  WorkerCrashedError)

        # session affinity across the fleet: an explicit session header
        # becomes the request's affinity key (handle._affinity_key), so
        # every proxy rendezvous-routes the session to the same replica
        sid = request.headers.get("serve_session_id", "")
        if sid and isinstance(payload, dict) and \
                "session_id" not in payload:
            payload["session_id"] = sid

        # streaming ingress: ?stream=1, Accept: text/event-stream, or an
        # OpenAI-style {"stream": true} body field
        # (reference: proxy.py streams ASGI responses chunk by chunk)
        want_stream = (request.query.get("stream") in ("1", "true")
                       or "text/event-stream" in
                       request.headers.get("Accept", "")
                       or (isinstance(payload, dict)
                           and payload.get("stream") is True))
        model_id = request.headers.get("serve_multiplexed_model_id", "")

        handle = self._handle_for(ingress, app_name, want_stream, model_id,
                                  method)

        def call():
            # handle.remote() itself may block (replica-set refresh, cold
            # start wait) — keep ALL of it off the proxy's event loop
            resp = (handle.remote(payload) if payload is not None
                    else handle.remote())
            if want_stream:
                return resp  # a DeploymentResponseGenerator
            return resp.result(30.0)

        # run_in_executor does NOT carry contextvars: capture the handler
        # context (active proxy span + request context) explicitly so the
        # replica call parents to the proxy span and rides the request id
        import contextvars

        from .context import reset_request_context, set_request_context
        token = set_request_context(request_id=rid, app_name=app_name)
        try:
            call_ctx = contextvars.copy_context()
        finally:
            reset_request_context(token)

        loop = asyncio.get_event_loop()
        try:
            out = await loop.run_in_executor(None,
                                             lambda: call_ctx.run(call))
        except (ActorDiedError, WorkerCrashedError) as e:
            # replica died mid-call and the handle's one retry found no
            # healthy replacement yet: a TYPED, retryable 503 — the
            # controller is already replacing the replica
            return web.json_response(
                {"error": "replica_unavailable",
                 "detail": type(e).__name__},
                status=503, headers={"Retry-After": "1"})
        except GetTimeoutError:
            return web.json_response(
                {"error": "upstream_timeout"}, status=504,
                headers={"Retry-After": "1"})
        except ValueError as e:
            # the request named something the app does not serve (an
            # unknown model or LoRA adapter): the caller's fault, a typed
            # 400 and not a bare 500. The failed call's refs sit in
            # exception cycles: collect shortly after, as for a 5xx
            import gc
            loop.call_later(0.5, gc.collect)
            return web.json_response(
                {"error": "invalid_request", "detail": str(e)[:200]},
                status=400)
        except RuntimeError as e:
            if "no replicas" in str(e):
                return web.json_response(
                    {"error": "replica_unavailable",
                     "detail": "no replicas"},
                    status=503, headers={"Retry-After": "1"})
            if str(e).startswith("overloaded") or "overloaded:" in str(e):
                # replica-side overload raised as a typed marker (e.g.
                # multi-LoRA: every adapter slot live) — retryable, not
                # a bare 500
                return web.json_response(
                    {"error": "overloaded", "detail": str(e)[:200]},
                    status=503, headers={"Retry-After": "1"})
            raise
        if want_stream:
            stream = web.StreamResponse()
            stream.headers["Content-Type"] = "text/event-stream"
            await stream.prepare(request)
            it = iter(out)
            try:
                while True:
                    try:
                        chunk = await loop.run_in_executor(
                            None, lambda: next(it, _STREAM_END))
                    except (ActorDiedError, WorkerCrashedError,
                            GetTimeoutError) as e:
                        # mid-stream replica loss: the status line is
                        # gone (200 already sent); surface a typed error
                        # chunk, then end the stream cleanly
                        await stream.write(json.dumps(
                            {"error": "replica_unavailable",
                             "detail": type(e).__name__}).encode())
                        break
                    if chunk is _STREAM_END:
                        break
                    if not isinstance(chunk, (bytes, str)):
                        chunk = json.dumps(chunk)
                    if isinstance(chunk, str):
                        chunk = chunk.encode()
                    await stream.write(chunk)
                await stream.write_eof()
            finally:
                # client disconnect / write error: release the
                # replica-retained generator and its ongoing slot
                await loop.run_in_executor(None, out.cancel)
            return stream
        try:
            return web.json_response(out)
        except TypeError:
            return web.Response(text=json.dumps(str(out)),
                                content_type="application/json")

    async def stop(self):
        if self._runner is not None:
            await self._runner.cleanup()
