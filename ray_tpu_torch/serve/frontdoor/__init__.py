"""Serve front door: the scale-out data plane in front of the replicas.

Counterpart of ``ray_tpu/serve/frontdoor/``, on the port's runtime.

Three pieces (reference analog: Ray Serve's proxy tier):

- :mod:`admission` — SLO-aware admission control at every proxy.
  Per-deployment budgets derive from live replica capacity (replicas x
  max_ongoing_requests, split across proxies); past the budget requests
  queue with bounded depth and deadline, then shed as HTTP 429 +
  Retry-After — backpressure to the socket, never a timeout-as-500.
- :mod:`routetable` — the shared route table. The controller publishes
  one snapshot (routes, ingress map, capacity, proxy fleet) into the
  head's shared directory service (core/directory.py); every proxy
  refreshes from it on a short TTL, so ingress scales horizontally
  without per-request controller round-trips.
- :mod:`prefix` — the cluster-wide prefix-cache directory. Paged-engine
  replicas publish their chained page hashes; at admission a replica
  that lacks a prefix locally imports the KV pages from whichever
  replica warmed them, over the object store (extending the PD-disagg
  import_prefill contract). Directory entries are hints: on any failure
  the request prefills cold and the hint is dropped.
"""
from .admission import AdmissionController, ShedError           # noqa: F401
from .prefix import PrefixDirectoryClient                       # noqa: F401
from .routetable import (ROUTES_DIR, fetch_snapshot,            # noqa: F401
                         publish_snapshot)
