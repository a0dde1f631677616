"""gRPC ingress for Serve.

Counterpart of ``ray_tpu/serve/grpc_proxy.py``, on the port's runtime.

Reference parity: the Serve gRPC proxy (serve/_private/proxy.py gRPCProxy +
user-supplied proto servicers). This image ships the grpc RUNTIME but not
protoc codegen, so the ingress is a *generic* service registered with
``GenericRpcHandler`` — no generated stubs on either side:

  method  /raytpu.Serve/Call         unary-unary
  method  /raytpu.Serve/CallStream   unary-stream
  request/response payloads: JSON bytes
  request envelope: {"app": str, "method": str, "payload": any,
                     "multiplexed_model_id": str}

Client (pure grpc, no stubs):

    ch = grpc.insecure_channel(f"127.0.0.1:{port}")
    call = ch.unary_unary("/raytpu.Serve/Call")
    out = json.loads(call(json.dumps({"app": "llm",
                                      "method": "v1_models"}).encode()))
"""
from __future__ import annotations

import json
import threading
from collections import OrderedDict
from concurrent import futures
from typing import Optional


class GrpcProxyActor:
    """Serve deployment-routing gRPC server (one per cluster, started by
    serve.start_grpc_proxy)."""

    def __init__(self, port: int = 0):
        self._requested_port = port
        self._server = None
        self.port: Optional[int] = None
        self._handles: "OrderedDict" = OrderedDict()
        self._handles_max = 256
        # the 16-thread gRPC executor mutates the cache concurrently
        # (unlike the HTTP proxy, which lives on one event-loop thread)
        self._handles_lock = threading.Lock()
        # synchronous admission gate (the HTTP fleet's asyncio
        # controller doesn't fit a thread-pool server): per-app
        # in-flight counts against the route-table capacity; past
        # budget + queue depth the request sheds RESOURCE_EXHAUSTED —
        # the gRPC spelling of the HTTP 429 contract
        self._inflight: dict[str, int] = {}  # guarded by: self._adm_lock
        self._adm_lock = threading.Lock()
        self._snap: Optional[dict] = None
        self._snap_ts = 0.0

    # -- admission (frontdoor, sync flavor) --------------------------------

    def _budget_for(self, app: str) -> Optional[int]:
        """App's admission bound from the shared route-table snapshot:
        the fleet capacity itself (replicas x max_ongoing_requests —
        replica-side queueing is already inside max_ongoing, and gRPC
        clients carry deadlines/retries, so unlike the HTTP proxies
        there is no extra proxy-side queue allowance). None =
        unconfigured (admit untracked)."""
        from ..core.config import cfg
        if not cfg.serve_admission_control:
            return None
        import time as _time

        from .frontdoor import routetable
        if _time.monotonic() - self._snap_ts > 1.0:
            try:
                self._snap = routetable.fetch_snapshot()
            except Exception:
                self._snap = None  # directory unreachable: admit open
            self._snap_ts = _time.monotonic()
        snap = self._snap
        if not snap:
            return None
        ing = snap.get("ingress", {}).get(app)
        if ing is None:
            return None
        cap = routetable.capacity_of(snap, app, ing)
        if cap <= 0:
            return None
        return cap

    def _admit(self, app: str, context, tenant: str = "") -> bool:
        """True = admitted (caller must _release); aborts the rpc with
        RESOURCE_EXHAUSTED when the app — or the request's TENANT share
        of it (cfg.serve_tenant_max_share, same quota rule as the HTTP
        gate) — is past budget."""
        import grpc

        from ..core.config import cfg
        bound = self._budget_for(app)
        if not cfg.serve_tenant_fair:
            tenant = ""
        reason = "queue_full"
        with self._adm_lock:
            cur = self._inflight.get(app, 0)
            t_bound = None
            if bound is not None and tenant and \
                    cfg.serve_tenant_max_share < 1.0:
                t_bound = max(1, int(bound * cfg.serve_tenant_max_share))
            t_cur = self._inflight.get((app, tenant), 0) if tenant else 0
            if bound is not None and cur >= bound:
                shed = True
            elif t_bound is not None and t_cur >= t_bound:
                shed, reason = True, "tenant_quota"
            else:
                self._inflight[app] = cur + 1
                if tenant:
                    self._inflight[(app, tenant)] = t_cur + 1
                shed = False
        if shed:
            try:
                from . import metrics as sm
                sm.admission_shed().inc(1.0, tags={
                    "app": app, "deployment": "", "reason": reason})
                if tenant:
                    sm.tenant_requests().inc(1.0, tags={
                        "app": app, "deployment": "", "tenant": tenant,
                        "outcome": "shed"})
            except Exception:
                pass  # telemetry must never fail a request
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                          "overloaded; retry_after_s=1")
        return True

    def _release(self, app: str, tenant: str = ""):
        with self._adm_lock:
            self._inflight[app] = max(0, self._inflight.get(app, 1) - 1)
            if tenant and (app, tenant) in self._inflight:
                self._inflight[(app, tenant)] = max(
                    0, self._inflight[(app, tenant)] - 1)

    def start(self) -> int:
        import grpc

        if self._server is not None:   # idempotent: start-or-return
            return self.port

        outer = self

        class Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                method = handler_call_details.method
                if method == "/raytpu.Serve/Call":
                    return grpc.unary_unary_rpc_method_handler(
                        outer._call)
                if method == "/raytpu.Serve/CallStream":
                    return grpc.unary_stream_rpc_method_handler(
                        outer._call_stream)
                return None

        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=16))
        self._server.add_generic_rpc_handlers((Handler(),))
        self.port = self._server.add_insecure_port(
            f"127.0.0.1:{self._requested_port}")
        self._server.start()
        return self.port

    # -- routing (mirrors the HTTP proxy's handle cache) ----------------- #

    def _handle_for(self, app: str, method: str, stream: bool,
                    model_id: str):
        import ray_tpu_torch

        from .api import CONTROLLER_NAME
        from .handle import DeploymentHandle
        # re-resolve the ingress EVERY request and key on it: a redeployed
        # app must not route to the old ingress (matches the HTTP proxy)
        ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        ingress = ray_tpu_torch.get(ctrl.get_ingress.remote(app))
        key = (app, ingress, method, stream, model_id)
        with self._handles_lock:
            h = self._handles.get(key)
            if h is None:
                h = DeploymentHandle(ingress, app, ctrl, method,
                                     stream=stream,
                                     multiplexed_model_id=model_id)
                self._handles[key] = h
                while len(self._handles) > self._handles_max:
                    self._handles.popitem(last=False)
            else:
                self._handles.move_to_end(key)
        return h

    @staticmethod
    def _parse(request_bytes: bytes):
        req = json.loads(request_bytes or b"{}")
        app = req.get("app", "default")
        method = req.get("method", "__call__")
        if method != "__call__" and (
                method.startswith("_") or not method.isidentifier()):
            raise ValueError(f"no route {method!r}")
        return (app, method, req.get("payload"),
                req.get("multiplexed_model_id", ""))

    @staticmethod
    def _typed_abort(context, e) -> None:
        """Typed statuses for the failure modes a healthy front door
        still sees (same contract as the HTTP proxy's 503/504): replica
        death -> UNAVAILABLE (retryable), upstream timeout ->
        DEADLINE_EXCEEDED; anything else is a real INTERNAL."""
        import grpc

        from ..exceptions import (ActorDiedError, GetTimeoutError,
                                  WorkerCrashedError)
        if isinstance(e, (ActorDiedError, WorkerCrashedError)) or (
                isinstance(e, RuntimeError) and "no replicas" in str(e)):
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          f"replica_unavailable: {type(e).__name__}")
        if isinstance(e, GetTimeoutError):
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                          "upstream_timeout")
        context.abort(grpc.StatusCode.INTERNAL, repr(e))

    def _call(self, request_bytes: bytes, context) -> bytes:
        try:
            app, method, payload, model_id = self._parse(request_bytes)
        except Exception as e:  # noqa: BLE001 — bad envelope
            import grpc
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, repr(e))
        from .frontdoor.admission import resolve_tenant
        tenant = resolve_tenant(None, payload)
        self._admit(app, context, tenant)
        try:
            h = self._handle_for(app, method, False, model_id)
            resp = (h.remote(payload) if payload is not None
                    else h.remote())
            out = resp.result(timeout_s=300)
            return json.dumps(out, default=str).encode()
        except Exception as e:  # noqa: BLE001 — map to grpc status
            self._typed_abort(context, e)
        finally:
            self._release(app, tenant)

    def _call_stream(self, request_bytes: bytes, context):
        try:
            app, method, payload, model_id = self._parse(request_bytes)
        except Exception as e:  # noqa: BLE001 — bad envelope
            import grpc
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, repr(e))
        from .frontdoor.admission import resolve_tenant
        tenant = resolve_tenant(None, payload)
        self._admit(app, context, tenant)
        try:
            h = self._handle_for(app, method, True, model_id)
            gen = (h.remote(payload) if payload is not None
                   else h.remote())
            try:
                for chunk in gen:
                    yield json.dumps(chunk, default=str).encode()
            finally:
                gen.cancel()
        except Exception as e:  # noqa: BLE001
            self._typed_abort(context, e)
        finally:
            self._release(app, tenant)

    def stop(self):
        if self._server is not None:
            self._server.stop(grace=1.0)


def start_grpc_proxy(port: int = 0):
    """Start (or return) the cluster's gRPC proxy actor; returns
    (handle, bound_port)."""
    import ray_tpu_torch
    name = "rtpu:serve:grpc-proxy"
    try:
        actor = ray_tpu_torch.get_actor(name)
        return actor, ray_tpu_torch.get(actor.start.remote())
    except ValueError:
        pass
    cls = ray_tpu_torch.remote(GrpcProxyActor)
    actor = cls.options(name=name, max_concurrency=32).remote(port)
    bound = ray_tpu_torch.get(actor.start.remote())
    return actor, bound
