"""SLO-aware admission control + per-tenant fairness for the proxies.

Counterpart of ``ray_tpu/serve/frontdoor/admission.py``.

Each proxy runs one :class:`AdmissionController` on its event loop. Per
deployment it holds a budget (its share of the fleet's live capacity:
``replicas x max_ongoing_requests / n_proxies``), bounded FIFO queues
for arrivals past the budget, and an EWMA of per-request service time.

Decision tree for an arriving request (``acquire``):

1. a slot is free (globally AND within the request's tenant quota)
   -> admit immediately;
2. the tenant is past its quota and its queue share is full -> shed
   (``tenant_quota``);
3. the global queue is full -> shed (``queue_full``);
4. the *predicted* queue wait — requests ahead divided by the drain
   rate the EWMA implies — already exceeds the deadline
   (cfg.serve_admission_timeout_s) -> shed (``slo``);
5. otherwise park in the tenant's queue; releases hand slots to parked
   waiters. A request still parked at the deadline sheds
   (``deadline``).

Sheds raise :class:`ShedError` carrying a Retry-After estimate (the
predicted time for the backlog to drain, clamped to [1, 60] seconds) —
the proxy turns it into ``429`` + ``Retry-After``, the gRPC proxy into
``RESOURCE_EXHAUSTED``.

**Multi-tenant isolation** (cfg.serve_tenant_*): requests that resolve
a tenant id (``x_tenant_id`` header, ``tenant`` body field, or the
request's LoRA adapter id — :func:`resolve_tenant`) get

- *weighted-fair queueing*: one FIFO per tenant, drained
  deficit-round-robin (per-tenant weights, default 1), so a heavy
  tenant's thousand parked requests cannot starve a light tenant's
  one — the light tenant's p99 stays bounded by its own load;
- *quota*: at most ``serve_tenant_max_share`` of the deployment budget
  in flight (and of the queue depth parked) per tenant; past it the
  HEAVY tenant sheds 429 (reason ``tenant_quota``) while other
  tenants keep admitting.

Untenanted traffic rides the ``""`` bucket: one plain FIFO, no quota —
bit-compatible with the single-tenant front door. Tenant ids are
client-controlled, so per-gate tracking is bounded
(cfg.serve_tenant_max_tracked; overflow shares one ``__other__``
bucket) — gate state and metric cardinality cannot be grown by a
scanner.

Everything here is asyncio single-loop state — no locks; the proxy
calls it only from its event loop.
"""
from __future__ import annotations

import asyncio
import math
import time
from collections import deque
from typing import Optional

# EWMA smoothing for per-request service seconds; ~20-request memory
_EWMA_ALPHA = 0.1
# before any completion is observed, assume requests are this slow —
# optimistic enough not to shed a cold deployment on its first burst
_EWMA_SEED_S = 0.05

# overflow bucket once a gate tracks cfg.serve_tenant_max_tracked ids
_OTHER = "__other__"


def resolve_tenant(headers, payload) -> str:
    """The request's tenant id, resolved at admission: explicit header
    first, then body fields, then the LoRA adapter id (multi-tenant
    serving's natural tenant key — ``lora`` field or the ``:<adapter>``
    suffix of ``model``). "" = untenanted."""
    t = ""
    try:
        if headers is not None:
            t = headers.get("x_tenant_id", "") or ""
        if not t and isinstance(payload, dict):
            t = payload.get("tenant") or payload.get("user") or ""
            if not t:
                t = payload.get("lora") or ""
            if not t:
                model = payload.get("model", "")
                if isinstance(model, str) and ":" in model:
                    t = model.split(":", 1)[1]
        return str(t)[:128]
    except Exception:
        return ""  # tenant resolution must never fail a request


class ShedError(Exception):
    """Request refused by admission control; carries the retry hint."""

    def __init__(self, reason: str, retry_after_s: int, detail: str = ""):
        super().__init__(detail or f"admission shed ({reason})")
        self.reason = reason
        self.retry_after_s = retry_after_s


class _DeploymentGate:
    def __init__(self, budget: int, queue_depth: int, timeout_s: float):
        self.budget = max(1, int(budget))
        self.queue_depth = max(0, int(queue_depth))
        self.timeout_s = float(timeout_s)
        self.inflight = 0
        self.ewma_s = _EWMA_SEED_S
        # per-tenant state; "" is the untenanted bucket (no quota).
        # _queues doubles as the DRR rotation order.
        self._queues: dict[str, deque] = {}   # tenant -> (fut, t0) FIFO
        self._inflight_t: dict[str, int] = {}
        self._credits: dict[str, float] = {}
        self.weights: dict[str, float] = {}
        self._share = 1.0
        self._max_tracked = 64

    # -- tenant bookkeeping ----------------------------------------------

    def bucket(self, tenant: str) -> str:
        """Clamp a client-controlled tenant id to the tracked set."""
        if not tenant:
            return ""
        known = set(self._queues) | set(self._inflight_t)
        if tenant in known or len(known) < self._max_tracked:
            return tenant
        return _OTHER

    def _quota(self, tenant: str) -> Optional[int]:
        """Inflight cap for a tenant (None = unquota'd: untenanted
        traffic, or share >= 1)."""
        if not tenant or self._share >= 1.0:
            return None
        return max(1, int(self.budget * self._share))

    def _queue_quota(self, tenant: str) -> int:
        if not tenant or self._share >= 1.0:
            return self.queue_depth
        return max(1, int(self.queue_depth * self._share))

    def _under_quota(self, tenant: str) -> bool:
        q = self._quota(tenant)
        return q is None or self._inflight_t.get(tenant, 0) < q

    def parked_total(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def parked_of(self, tenant: str) -> int:
        q = self._queues.get(tenant)
        return len(q) if q else 0

    def park(self, tenant: str, fut, t0: float) -> None:
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = deque()
            self._credits.setdefault(tenant, self.weights.get(tenant, 1.0))
        q.append((fut, t0))

    def unpark(self, tenant: str, fut, t0: float) -> None:
        q = self._queues.get(tenant)
        if q is not None:
            try:
                q.remove((fut, t0))
            except ValueError:
                pass  # a release popped us concurrently
        self.prune_idle(tenant)

    def prune_idle(self, tenant: str) -> None:
        """Drop a tenant's gate state once it is fully idle (no slots,
        nothing parked). Without this, the bounded tracked set would
        fill PERMANENTLY — one scan burst of unique ids and every
        later real tenant would share the __other__ bucket forever.
        Configured weights survive (they are operator state, not
        traffic state)."""
        if not tenant or tenant not in (
                set(self._queues) | set(self._inflight_t)):
            return
        if self._inflight_t.get(tenant, 0) == 0 and \
                not self._queues.get(tenant):
            self._inflight_t.pop(tenant, None)
            self._queues.pop(tenant, None)
            self._credits.pop(tenant, None)

    def pop_waiter(self) -> Optional[tuple]:
        """Next waiter to hand a freed slot to: deficit-round-robin over
        tenant queues, skipping tenants at quota (their own releases
        re-arm them). -> (tenant, fut, t0) or None."""
        for _replenish in (False, True):
            if _replenish:
                live = [t for t, q in self._queues.items()
                        if q and self._under_quota(t)]
                if not live:
                    return None
                for t in live:
                    self._credits[t] = max(self.weights.get(t, 1.0), 1e-9)
            for t in list(self._queues):
                q = self._queues[t]
                if not q or not self._under_quota(t):
                    continue
                if self._credits.get(t, 0.0) <= 0:
                    continue
                while q:
                    fut, t0 = q.popleft()
                    if not fut.done():
                        self._credits[t] -= 1.0
                        # rotate: this tenant goes to the back of the
                        # round-robin order
                        self._queues[t] = self._queues.pop(t)
                        return t, fut, t0
        return None

    # -- prediction -------------------------------------------------------

    def predicted_wait_s(self, ahead: int) -> float:
        """Seconds until `ahead` queued requests drain: the budget
        retires ~budget/ewma requests per second."""
        return ahead * self.ewma_s / self.budget

    def retry_after_s(self) -> int:
        est = self.predicted_wait_s(self.parked_total() + 1)
        return max(1, min(60, int(math.ceil(est))))


class AdmissionController:
    """Per-proxy gatekeeper. ``configure`` is idempotent and cheap — the
    proxy calls it on every route-table refresh so budgets track live
    replica capacity; gates for deployments that disappear are
    dropped."""

    def __init__(self, proxy_label: str = "proxy-0"):
        self._gates: dict[tuple, _DeploymentGate] = {}
        self._proxy = proxy_label

    # -- configuration ---------------------------------------------------

    def configure(self, app: str, deployment: str, capacity: int,
                  n_proxies: int = 1,
                  queue_depth: Optional[int] = None,
                  timeout_s: Optional[float] = None,
                  tenant_max_share: Optional[float] = None,
                  tenant_weights: Optional[dict] = None) -> None:
        from ...core.config import cfg
        budget = max(1, int(capacity) // max(1, int(n_proxies)))
        qd = cfg.serve_admission_queue_depth if queue_depth is None \
            else queue_depth
        to = cfg.serve_admission_timeout_s if timeout_s is None \
            else timeout_s
        share = cfg.serve_tenant_max_share if tenant_max_share is None \
            else tenant_max_share
        g = self._gates.get((app, deployment))
        if g is None:
            g = self._gates[(app, deployment)] = _DeploymentGate(
                budget, qd, to)
        else:
            g.budget = max(1, int(budget))
            g.queue_depth = max(0, int(qd))
            g.timeout_s = float(to)
        g._share = float(share)
        g._max_tracked = max(1, int(cfg.serve_tenant_max_tracked))
        if tenant_weights:
            g.weights.update({str(k): float(v)
                              for k, v in tenant_weights.items()})

    def prune(self, live: set) -> None:
        """Drop gates for (app, deployment) pairs no longer deployed.
        Parked waiters of a pruned gate shed with a small retry hint —
        their app was deleted mid-wait."""
        for key in [k for k in self._gates if k not in live]:
            g = self._gates.pop(key)
            for tenant, q in g._queues.items():
                for fut, _t in q:
                    if not fut.done():
                        fut.set_exception(ShedError("deadline", 1,
                                                    "deployment removed"))
                q.clear()
                # last-write-wins gauge: a removed deployment must not
                # pin a stale queue depth on the TSDB forever
                self._set_queued(key[0], key[1], g, tenant)

    def gate_for(self, app: str, deployment: str) -> \
            Optional[_DeploymentGate]:
        return self._gates.get((app, deployment))

    # -- the gate --------------------------------------------------------

    async def acquire(self, app: str, deployment: str, tenant: str = ""):
        """Admit or shed. Returns a zero-arg release callable the caller
        MUST invoke exactly once when the request finishes (any
        outcome); raises ShedError to refuse."""
        g = self._gates.get((app, deployment))
        if g is None:
            # unknown deployment (admission unconfigured — e.g. route
            # snapshot unavailable, or a proxy started standalone in a
            # test): admit untracked. Must accept the release duration
            # argument like a real releaser.
            return lambda *_a: None
        from ...core.config import cfg
        if not cfg.serve_tenant_fair:
            tenant = ""   # one FIFO, no quota: the single-tenant gate
        t = g.bucket(tenant)
        if g.inflight < g.budget and g._under_quota(t):
            g.inflight += 1
            g._inflight_t[t] = g._inflight_t.get(t, 0) + 1
            self._count_admit(app, deployment, g, t, 0.0)
            return self._releaser(app, deployment, g, t)
        if t and g._share < 1.0 and \
                g.parked_of(t) >= g._queue_quota(t):
            # the HEAVY tenant sheds once its queue share fills —
            # regardless of its inflight count, so a tenant holding
            # zero slots still cannot fill the global queue and starve
            # everyone else into queue_full sheds
            self._count_shed(app, deployment, "tenant_quota", g, t)
            raise ShedError("tenant_quota", g.retry_after_s())
        if g.parked_total() >= g.queue_depth:
            self._count_shed(app, deployment, "queue_full", g, t)
            raise ShedError("queue_full", g.retry_after_s())
        if g.predicted_wait_s(g.parked_total() + 1) > g.timeout_s:
            # SLO-aware refusal: the queue would outlive the deadline
            self._count_shed(app, deployment, "slo", g, t)
            raise ShedError("slo", g.retry_after_s())
        fut = asyncio.get_event_loop().create_future()
        t0 = time.perf_counter()
        g.park(t, fut, t0)
        self._set_queued(app, deployment, g, t)
        try:
            await asyncio.wait_for(fut, g.timeout_s)
        except asyncio.TimeoutError:
            if fut.done() and not fut.cancelled():
                # same-tick race (Python >= 3.12 wait_for discards a
                # completed result when the timer fires first): a
                # releaser already transferred its slot to us — pass it
                # onward or g.inflight leaks one budget slot forever
                self._releaser(app, deployment, g, t)(None)
            else:
                g.unpark(t, fut, t0)
            self._set_queued(app, deployment, g, t)
            self._count_shed(app, deployment, "deadline", g, t)
            raise ShedError("deadline", g.retry_after_s()) from None
        except asyncio.CancelledError:
            # client disconnected while parked: withdraw from the queue
            # and re-record the gauge — rtpu_serve_tenant_queued feeds
            # the tenant_queue autoscale signal, so a waiter that left
            # without unparking would pin a stale backlog that scales
            # the deployment out forever. If a releaser handed us its
            # slot in the same tick (fut completed before the cancel
            # landed), the pop-time bookkeeping already transferred the
            # inflight count to us: release it onward.
            if fut.done() and not fut.cancelled():
                self._releaser(app, deployment, g, t)(None)
            else:
                g.unpark(t, fut, t0)
            self._set_queued(app, deployment, g, t)
            raise
        # a releaser handed us its slot (inflight + our tenant count
        # are already transferred/incremented by pop-time bookkeeping)
        self._count_admit(app, deployment, g, t,
                          time.perf_counter() - t0)
        return self._releaser(app, deployment, g, t)

    def _releaser(self, app: str, deployment: str, g: _DeploymentGate,
                  tenant: str):
        released = False

        def release(duration_s: Optional[float] = None):
            nonlocal released
            if released:
                return
            released = True
            if duration_s is not None:
                g.ewma_s += _EWMA_ALPHA * (duration_s - g.ewma_s)
            # free OUR tenant's slot first, then hand the global slot to
            # the fairest eligible waiter; the waiter keeps the inflight
            # count we hold, so the budget can never leak
            g._inflight_t[tenant] = max(
                g._inflight_t.get(tenant, 1) - 1, 0)
            got = g.pop_waiter()
            if got is not None:
                w_t, fut, _t0 = got
                g._inflight_t[w_t] = g._inflight_t.get(w_t, 0) + 1
                fut.set_result(None)
                self._set_inflight(app, deployment, g, w_t)
                self._set_queued(app, deployment, g, w_t)
            else:
                g.inflight -= 1
            self._set_inflight(app, deployment, g, tenant)
            g.prune_idle(tenant)
        return release

    # -- telemetry (never raises) ----------------------------------------

    def _count_admit(self, app, deployment, g, tenant, waited_s: float):
        try:
            from .. import metrics as sm
            tags = {"app": app, "deployment": deployment}
            sm.admission_admitted().inc(1.0, tags=tags)
            sm.admission_queue_wait().observe(waited_s, tags=tags)
            if tenant:
                sm.tenant_requests().inc(1.0, tags={
                    **tags, "tenant": tenant, "outcome": "admitted"})
            self._set_inflight(app, deployment, g, tenant)
        except Exception:
            pass  # telemetry must never fail a request

    def _count_shed(self, app, deployment, reason, g, tenant=""):
        try:
            from .. import metrics as sm
            sm.admission_shed().inc(1.0, tags={
                "app": app, "deployment": deployment, "reason": reason})
            if tenant:
                sm.tenant_requests().inc(1.0, tags={
                    "app": app, "deployment": deployment,
                    "tenant": tenant, "outcome": "shed"})
        except Exception:
            pass  # telemetry must never fail a request

    def _set_queued(self, app, deployment, g, tenant=""):
        """Per-tenant queue-depth gauge (the "" bucket doubles as the
        deployment's plain admission backlog). The TSDB turns these
        last-write samples into the per-tenant queue-depth SERIES the
        adapter-aware autoscaling signal reads; the proc label keys the
        head's death sweep (a killed proxy's backlog zeroes instead of
        pinning the scale-out signal on forever)."""
        try:
            from ...llm.telemetry import _proc
            from .. import metrics as sm
            sm.tenant_queued().set(float(g.parked_of(tenant)), tags={
                "app": app, "deployment": deployment,
                "tenant": tenant, "proxy": self._proxy,
                "proc": _proc()})
        except Exception:
            pass  # telemetry must never fail a request

    def _set_inflight(self, app, deployment, g, tenant=""):
        try:
            from .. import metrics as sm
            sm.admission_inflight().set(float(g.inflight), tags={
                "app": app, "deployment": deployment,
                "proxy": self._proxy})
            if tenant:
                sm.tenant_inflight().set(
                    float(g._inflight_t.get(tenant, 0)), tags={
                        "app": app, "deployment": deployment,
                        "tenant": tenant, "proxy": self._proxy})
        except Exception:
            pass  # telemetry must never fail a request

    def stats(self) -> dict:
        out = {}
        for (a, d), g in self._gates.items():
            out[f"{a}/{d}"] = {
                "inflight": g.inflight,
                "queued": g.parked_total(),
                "budget": g.budget,
                "ewma_service_s": round(g.ewma_s, 4),
                "tenants": {t: {"inflight": g._inflight_t.get(t, 0),
                                "queued": g.parked_of(t)}
                            for t in (set(g._inflight_t)
                                      | set(g._queues)) if t},
            }
        return out
