"""Placement groups: gang resource reservation.

Reference parity: python/ray/util/placement_group.py:42 (PlacementGroup),
:146 (placement_group factory); server side gcs_placement_group_mgr.h:232.
The port's copy of ``ray_tpu/util/placement_group.py``: bundles reserve
gangs of workers — a bundle of {"GPU": n} holds n of a host's GPUs for the
tasks and actors placed in it (each worker process still leases its own
device indices, core/runtime.py), and STRICT_SPREAD lays a multi-host gang
across hosts.

Handles are id-based and picklable (reference: PlacementGroup carries only
its id, util/placement_group.py:55), so they can be created from the driver
*or* from inside an actor (e.g. a Train controller) and passed around.
"""
from __future__ import annotations

import threading
from typing import Optional

from ..core.ids import ObjectID, PlacementGroupID
from ..core.ref import ObjectRef


def _runtime():
    from ..core import runtime as rt
    r = rt.get_runtime_if_exists()
    if r is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return r


VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundle_specs: list[dict]):
        self._pg_id = pg_id
        self._bundle_specs = [dict(b) for b in bundle_specs]
        self._ready_ref: Optional[ObjectRef] = None

    @property
    def id(self) -> PlacementGroupID:
        return self._pg_id

    @property
    def bundle_specs(self) -> list[dict]:
        return [dict(b) for b in self._bundle_specs]

    @property
    def bundle_count(self) -> int:
        return len(self._bundle_specs)

    def ready(self) -> ObjectRef:
        """ObjectRef that resolves (to the pg id hex) once all bundles are
        reserved (reference: PlacementGroup.ready, util/placement_group.py:70).
        """
        if self._ready_ref is not None:  # one waiter thread per handle
            return self._ready_ref
        rt = _runtime()
        oid = ObjectID.from_random()
        pg_id, pg_hex = self._pg_id, self._pg_id.hex()
        rt.expect(oid)  # local mode pre-registers deferred oids; others no-op

        def _waiter():
            try:
                ok = rt.pg_wait(pg_id, timeout=24 * 3600.0)
                if ok:
                    rt.put_at(oid, pg_hex)
                else:
                    rt.put_at(oid, TimeoutError(
                        f"placement group {pg_hex} never ready"),
                        is_exception=True)
            except BaseException as e:  # noqa: BLE001 — resolve, never hang
                try:
                    rt.put_at(oid, e, is_exception=True)
                except BaseException:
                    pass  # store closing; waiter times out
        threading.Thread(target=_waiter, daemon=True).start()
        self._ready_ref = ObjectRef(oid)
        return self._ready_ref

    def wait(self, timeout_seconds: float = 30) -> bool:
        return _runtime().pg_wait(self._pg_id, timeout=timeout_seconds)

    def __reduce__(self):
        return (PlacementGroup, (self._pg_id, self._bundle_specs))

    def __repr__(self):
        return f"PlacementGroup({self._pg_id.hex()[:12]}, {self._bundle_specs})"


def placement_group(bundles: list[dict[str, float]],
                    strategy: str = "PACK",
                    name: str = "",
                    lifetime: Optional[str] = None,
                    same_label: Optional[str] = None,
                    bundle_label_selectors:
                        Optional[list[Optional[dict]]] = None,
                    ) -> PlacementGroup:
    """Gang-reserve `bundles` of resources.

    `same_label`: a node-label key — all bundles must land on nodes that
    share ONE value of it (e.g. ``util.tpu.SLICE_LABEL`` to keep a gang
    inside one TPU slice / ICI domain). `bundle_label_selectors[i]` further
    restricts bundle i to nodes whose labels contain every given key=value.
    Reference analog: the TPU-{pod}-head resource encoding
    (_private/accelerators/tpu.py:110) and bundle label selectors.
    """
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("at least one bundle is required")
    for b in bundles:
        if not b or any(v < 0 for v in b.values()):
            raise ValueError(f"invalid bundle {b}")
    if bundle_label_selectors is not None \
            and len(bundle_label_selectors) != len(bundles):
        raise ValueError("bundle_label_selectors must have one entry "
                         "(dict or None) per bundle")
    rt = _runtime()
    result = rt.create_placement_group(
        [dict(b) for b in bundles], strategy, name,
        same_label=same_label, bundle_selectors=bundle_label_selectors)
    if isinstance(result, PlacementGroup):  # worker: head rpc wraps already
        return result
    # driver / local mode: direct call returns the internal state
    return PlacementGroup(result.pg_id,
                          [dict(b.resources) for b in result.bundles])


def remove_placement_group(pg: PlacementGroup) -> None:
    _runtime().remove_placement_group(pg.id)


def placement_group_table() -> dict:
    rt = _runtime()
    out = {}
    for pg_id, st in getattr(rt, "pgs", {}).items():
        out[pg_id.hex()] = {
            "name": st.name, "strategy": st.strategy, "state": st.state,
            "bundles": {i: dict(b.resources)
                        for i, b in enumerate(st.bundles)},
            "bundle_nodes": {i: (b.node_id.hex() if b.node_id else None)
                             for i, b in enumerate(st.bundles)},
        }
    return out
