"""The proxies' shared route table, published through the head's shared
directory service (core/directory.py, protocol v7).

Counterpart of ``ray_tpu/serve/frontdoor/routetable.py``.

The controller is the single writer: on every topology change (deploy,
delete, replica scale, proxy death/replacement) it publishes ONE
snapshot entry into the ``serve:routes`` directory::

    {"v": int,                      # controller-side version counter
     "routes": {route_prefix: app},      # longest-match table
     "ingress": {app: ingress_deployment},
     "capacity": {"app/deployment": [replicas, max_ongoing_requests]},
     "n_proxies": int,
     "proxies": [{"index": i, "port": p}]}

Every proxy refreshes its copy on a short TTL with one ``dir_query``
frame — no per-request controller round-trips, and N proxies cost the
controller nothing in steady state. When the directory is unreachable
(local clusters torn mid-test, head restarting) proxies fall back to
direct controller calls, so the snapshot is an optimization AND the
scale-out mechanism, never a single point of failure.

Like every shared-directory payload, the snapshot is a hint: a proxy
may briefly route on a stale table after a scale event. That window is
bounded by the TTL and is benign — handles re-resolve replicas
themselves, and admission budgets only lag capacity by one refresh.
"""
from __future__ import annotations

from typing import Optional

ROUTES_DIR = "serve:routes"
_SNAP_KEY = "snapshot"


def publish_snapshot(snap: dict) -> bool:
    """Controller-side: merge the current snapshot into the directory.
    Fire-and-forget (one async frame); False when no cluster runtime."""
    from ...core import directory as cdir
    return cdir.update(ROUTES_DIR, put={_SNAP_KEY: snap})


def fetch_snapshot(timeout: float = 2.0) -> Optional[dict]:
    """Proxy-side: the latest published snapshot, or None when the
    directory is unreachable/empty (callers fall back to controller
    RPCs)."""
    from ...core import directory as cdir
    got = cdir.query(ROUTES_DIR, keys=[_SNAP_KEY], timeout=timeout)
    if not got:
        return None
    return got["entries"].get(_SNAP_KEY)


def capacity_of(snap: dict, app: str, deployment: str) -> int:
    cap = snap.get("capacity", {}).get(f"{app}/{deployment}")
    if not cap:
        return 0
    replicas, max_ongoing = cap
    return max(int(replicas), 1) * max(int(max_ongoing), 1)
