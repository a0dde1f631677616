"""Compiled DAG execution (reference: dag/compiled_dag_node.py:808).

See package docstring for the channel protocol. Compilation:

1. topo-sort the graph; group ClassMethodNodes by owning actor;
2. allocate sealed ring channels per cross-process edge (deterministic id
   bases: sha1(dag_id, producer, consumer); message ``seq`` maps to
   ``base[:12] + uint32(seq)`` — see dag/channel.py for the seal/ack
   protocol that retires ring positions without delete-and-recreate);
3. install one ``_dag_actor_loop_sealed`` per actor via ``handle._exec``
   — a long-running actor task stepping that actor's nodes in topo order
   (same-actor edges pass values in-process, no shm hop);
4. ``execute()`` writes the input channels and returns a CompiledDAGRef
   over the output channel; the ring bounds in-flight executions
   (auto-draining the oldest when full).

``cfg.dag_sealed_channels = False`` restores the legacy polling transport
(consume-once slots, delete-and-recreate, 100ms poll slices, copies
forced on every read) — results must be bit-identical either way.

The port's copy of ``ray_tpu/dag/compiled.py``. A loop reaches its
worker by reference (``ray_tpu_torch.dag.compiled.
_dag_actor_loop_sealed``), so the worker imports this module and nothing
of the reference.
"""
from __future__ import annotations

import hashlib
import os
import time
from collections import deque
from typing import Any, Optional

from ..core.ids import ObjectID
from ..core import flight
from . import channel as ch
from .nodes import ClassMethodNode, DAGNode, InputNode

_STOP = "__rtpu_dag_stop__"


def _slot_oid(base: bytes, slot: int) -> ObjectID:
    return ObjectID(base[:-1] + bytes([slot]))


def _read_channel(store, oid: ObjectID, stop_oid: ObjectID,
                  timeout_s: Optional[float] = None):
    """LEGACY transport: blocking consume-once read — wait for the
    object, read, DELETE. Returns _STOP if the stop flag appears while
    waiting. Kept behind cfg.dag_sealed_channels=False as the
    bit-identical fallback; the sealed-channel path replaces the poll
    slices below with one futex wait over {data, stop}."""
    from ..core.object_store import GetTimeoutError
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while True:
        try:
            # zero_copy=False: a channel slot is deleted and RECREATED
            # under the same id each ring pass; a zero-copy pin would make
            # the delete lazy and the recreate collide or read stale data
            val = store.get(oid, timeout_ms=100,  # graftlint: disable=GL009
                            zero_copy=False)
            store.delete(oid)
            return val
        except GetTimeoutError:
            if store.contains(stop_oid):
                return _STOP
            if deadline is not None and time.monotonic() > deadline:
                raise


def _dag_actor_loop(instance, plan: list, stop_hex: str, max_inflight: int):
    """LEGACY transport loop (cfg.dag_sealed_channels=False): steps this
    actor's nodes forever until the stop flag object appears."""
    from ..core import runtime as rt_mod
    rt = rt_mod.get_runtime_if_exists()
    store = rt.store
    stop_oid = ObjectID(bytes.fromhex(stop_hex))
    seq = 0
    while True:
        slot = seq % max_inflight
        local: dict[int, Any] = {}
        for step in plan:
            if store.contains(stop_oid):
                return seq
            args = []
            for kind, val in step["args"]:
                if kind == "const":
                    args.append(val)
                elif kind == "local":
                    args.append(local[val])
                else:  # chan: the edge's data base
                    v = _read_channel(store, _slot_oid(val, slot),
                                      stop_oid)
                    if v is _STOP:
                        return seq
                    args.append(v)
            out = getattr(instance, step["method"])(*args)
            local[step["idx"]] = out
            frame = None   # serialize once per value, reuse across targets
            for base, addr in step["out_chans"]:
                if addr is None:
                    store.put(_slot_oid(base, slot), out)
                else:
                    # cross-store edge: push into the consumer's store
                    from ..core.object_store import _FramedValue
                    from ..core.object_transfer import push_object
                    if frame is None:
                        frame = _FramedValue(out, False)
                    if not push_object(addr, _slot_oid(base, slot),
                                       frame=frame):
                        raise RuntimeError(
                            f"DAG channel push to {addr} rejected "
                            "(consumer store full?)")
        seq += 1


def _dag_actor_loop_sealed(instance, plan: list, stop_hex: str, ring: int):
    """Sealed-channel transport loop: an in-edge read is one native get
    when the slot is already sealed (the pipelined steady state), else
    one futex wait over {data, stop} (dag/channel.py read_slot). No ack
    traffic: the driver paces the whole pipeline (execute() drains output
    seq-ring before feeding seq), which bounds every edge to the ring.
    Values cross the DAG zero-copy when cfg.zero_copy_get allows."""
    from . import channel as _ch
    from ..core import runtime as rt_mod
    rt = rt_mod.get_runtime_if_exists()
    store = rt.store
    stop_oid = ObjectID(bytes.fromhex(stop_hex))
    seq = 0
    from ..core import flight as _fl
    try:
        while True:
            local: dict[int, Any] = {}
            for step in plan:
                args = []
                for kind, val in step["args"]:
                    if kind == "const":
                        args.append(val)
                    elif kind == "local":
                        args.append(local[val])
                    else:  # chan: the edge's data base
                        args.append(_ch.read_slot(store, val, seq,
                                                  stop_oid))
                _fl.evt(_fl.DAG_STEP_BEGIN, step["idx"], seq)
                out = getattr(instance, step["method"])(*args)
                _fl.evt(_fl.DAG_STEP_END, step["idx"], seq)
                local[step["idx"]] = out
                outs = step["out_chans"]
                if not outs:
                    continue
                frame = None   # serialize once, fan out to every target
                if len(outs) > 1 or any(a is not None for _, a in outs):
                    from ..core.object_store import _FramedValue
                    frame = _FramedValue(out, False)
                for base, addr in outs:
                    _ch.write_slot(store, base, seq, out, frame=frame,
                                   push_addr=addr)
            seq += 1
    except _ch.ChannelClosed:
        return seq  # teardown: stop flag sealed while waiting


class CompiledDAGRef:
    """Result handle for one execute() (reference: CompiledDAGRef).
    get() consumes the output channel; repeated get() returns the cache.
    If a participating actor dies mid-loop, get() raises instead of
    hanging (the liveness probe runs between wait slices)."""

    def __init__(self, store, oid: ObjectID, stop_oid: ObjectID,
                 dag: Optional["CompiledDAG"] = None,
                 seq: Optional[int] = None):
        self._store = store
        self._oid = oid          # legacy transport slot (None when sealed)
        self._stop = stop_oid
        self._dag = dag
        self._seq = seq          # sealed transport message seq
        self._value: Any = None
        self._consumed = False

    def get(self, timeout_s: Optional[float] = 60.0):
        if self._consumed:
            return self._value
        if self._seq is None:
            v = _read_channel(self._store, self._oid, self._stop, timeout_s)
            if v is _STOP:
                raise RuntimeError("compiled DAG was torn down")
        else:
            dag = self._dag
            try:
                v = ch.read_slot(self._store, dag.output_chan, self._seq,
                                 self._stop, timeout_s,
                                 on_idle=dag._probe_loops)
            except ch.ChannelClosed:
                raise RuntimeError("compiled DAG was torn down") from None
        self._value = v
        self._consumed = True
        return self._value


class CompiledDAG:
    def __init__(self, output_node: DAGNode, max_inflight: int = 2):
        import ray_tpu_torch
        from ..core import runtime as rt_mod
        from ..core.config import cfg
        self._rt = rt_mod.get_runtime_if_exists()
        if self._rt is None:
            raise RuntimeError("ray_tpu_torch.init() first")
        self.store = self._rt.store
        self.max_inflight = max_inflight
        self.sealed = bool(cfg.dag_sealed_channels)
        self.dag_id = os.urandom(8)
        self._seq = 0
        self._outstanding: deque[CompiledDAGRef] = deque()
        stop_digest = hashlib.sha1(self.dag_id + b"stop").digest()
        self.stop_oid = ObjectID(stop_digest[:ObjectID.SIZE])
        self._torn_down = False

        # ---- topo order (args before node) --------------------------- #
        order: list[ClassMethodNode] = []
        seen: dict[int, int] = {}

        def visit(n):
            if isinstance(n, InputNode):
                return
            if not isinstance(n, ClassMethodNode):
                return
            if id(n) in seen:
                return
            for a in n.args:
                visit(a)
            seen[id(n)] = len(order)
            order.append(n)

        visit(output_node)
        if not order:
            raise ValueError("DAG has no actor-method nodes")
        self.output_node = order[-1]
        if output_node is not self.output_node:
            raise ValueError("compile from the DAG's final node")

        # ---- channels -------------------------------------------------- #
        def chan_base(tag: str) -> bytes:
            return hashlib.sha1(self.dag_id + tag.encode()).digest()[
                :ObjectID.SIZE]

        self.input_chans: list = []
        self.output_chan = chan_base("out")
        # per-actor plans
        plans: dict[bytes, list] = {}
        actors: dict[bytes, Any] = {}
        node_actor = {}
        for idx, n in enumerate(order):
            aid = n.actor._actor_id.binary()
            actors[aid] = n.actor
            node_actor[id(n)] = aid
            step = {"idx": idx, "method": n.method_name, "args": [],
                    "out_chans": []}
            for a in n.args:
                if isinstance(a, InputNode):
                    base = chan_base(f"in->{idx}")
                    # (channel, consuming actor) — resolved to a push
                    # target after placement is known
                    self.input_chans.append((base, aid))
                    step["args"].append(("chan", base))
                elif isinstance(a, ClassMethodNode):
                    src_idx = seen[id(a)]
                    if node_actor[id(a)] == aid:
                        step["args"].append(("local", src_idx))
                    else:
                        base = chan_base(f"{src_idx}->{idx}")
                        # producer writes this channel toward consumer aid
                        for s in plans[node_actor[id(a)]]:
                            if s["idx"] == src_idx:
                                s["out_chans"].append((base, aid))
                        step["args"].append(("chan", base))
                else:
                    step["args"].append(("const", a))
            plans.setdefault(aid, []).append(step)
        # final node also writes the driver-facing output channel
        # (consumer None = the driver/head store)
        out_aid = node_actor[id(self.output_node)]
        for s in plans[out_aid]:
            if s["idx"] == seen[id(self.output_node)]:
                s["out_chans"].append((self.output_chan, None))

        # ---- cross-store channel routing ------------------------------ #
        # A consumer waits on its node-LOCAL store, so the producer of
        # every cross-store edge PUSHES the value into the consumer's
        # store via the transfer service (reference: aDAG remote channels
        # over RPC, local ones over shm — compiled_dag_node.py:808).
        # Same-store edges stay plain store seals. Resolve placement by
        # pinging each actor (forces scheduling), then mapping it to its
        # node's data address (None = shares the driver's store).
        from ..core.ids import ActorID
        actor_addr: dict[bytes, Optional[str]] = {a: None for a in plans}
        head_addr: Optional[str] = None
        if isinstance(self._rt, rt_mod.Runtime):
            ray_tpu_torch.get([actors[aid]._exec(lambda inst: None)
                         for aid in plans], timeout=120)
            with self._rt.lock:
                head_addr = self._rt.head_node.data_addr
                for aid in plans:
                    a = self._rt.actors.get(ActorID(aid))
                    w = (self._rt.workers.get(a.wid)
                         if a is not None and a.wid else None)
                    n = (self._rt.nodes.get(w.node_id)
                         if w is not None else None)
                    if n is not None and n.own_store:
                        actor_addr[aid] = n.data_addr

        def route(src_addr: Optional[str],
                  dst_addr: Optional[str]) -> Optional[str]:
            """Where a value produced on `src` must be placed to be
            visible to `dst`; None = the producer's own local store."""
            target = dst_addr if dst_addr is not None else head_addr
            own = src_addr if src_addr is not None else head_addr
            return None if target == own else target

        def addr_of(c) -> Optional[str]:
            return actor_addr[c] if c is not None else None

        for aid, plan in plans.items():
            for step in plan:
                # data flows producer -> consumer store
                step["out_chans"] = [
                    (base, route(actor_addr[aid], addr_of(c)))
                    for base, c in step["out_chans"]]
        # driver-side channels (driver writes inputs / reads the output
        # against the head store)
        self.input_chans = [
            (base, route(None, addr_of(c)))
            for base, c in self.input_chans]
        self._push_addrs = sorted({addr for addr in actor_addr.values()
                                   if addr is not None})
        # where each channel's slots land (None = the driver's store; an
        # address = that own-store node's), for teardown's sweep, and one
        # actor per own store to run that store's part of it: the
        # reference sweeps only the driver's store and leaves the stop
        # flag it pushed in every other store behind
        def store_of(addr: Optional[str]) -> Optional[str]:
            return None if addr == head_addr else addr

        self._lands: dict[Optional[str], list[bytes]] = {
            None: [self.output_chan]}
        for base, addr in self.input_chans:
            self._lands.setdefault(store_of(addr), []).append(base)
        for aid, plan in plans.items():
            for step in plan:
                for base, addr in step["out_chans"]:
                    if base != self.output_chan:
                        self._lands.setdefault(store_of(
                            addr if addr is not None else actor_addr[aid]),
                            []).append(base)
        self._sweepers = {addr: actors[next(
            aid for aid in plans if actor_addr[aid] == addr)]
            for addr in self._push_addrs}
        # channel-endpoint accounting for state.summary(): every edge
        # (inputs + cross-actor + the driver-facing output) is one live
        # channel until teardown
        self._n_chans = len(self.input_chans) + sum(
            len(step["out_chans"]) for plan in plans.values()
            for step in plan)
        flight.chan_opened(self._n_chans)

        # ---- install loops -------------------------------------------- #
        self._loop_refs = []
        for aid, plan in plans.items():
            if self.sealed:
                self._loop_refs.append(actors[aid]._exec(
                    _dag_actor_loop_sealed, plan, self.stop_oid.hex(),
                    max_inflight))
            else:
                self._loop_refs.append(actors[aid]._exec(
                    _dag_actor_loop, plan, self.stop_oid.hex(),
                    max_inflight))

    # ------------------------------------------------------------------- #

    def _probe_loops(self):
        """Between wait slices: raise if any actor loop exited while the
        DAG is live (actor death / a step raising) — a CompiledDAGRef
        must never hang on a pipeline that can no longer produce."""
        if self._torn_down:
            return
        import ray_tpu_torch
        ready, _ = ray_tpu_torch.wait(self._loop_refs,
                                num_returns=1, timeout=0)
        if ready:
            val = ray_tpu_torch.get(ready[0])   # raises ActorDiedError & co.
            raise RuntimeError(
                f"compiled DAG actor loop exited mid-pipeline "
                f"(returned {val!r}); tear the DAG down")

    def execute(self, value: Any) -> CompiledDAGRef:
        if self._torn_down:
            raise RuntimeError("DAG is torn down")
        if len(self._outstanding) >= self.max_inflight:
            # ring full: auto-drain the oldest so slots recycle
            self._outstanding.popleft().get()
        seq = self._seq
        self._seq += 1
        flight.evt(flight.DAG_EXEC, seq)
        if self.sealed:
            ref = self._execute_sealed(seq, value)
        else:
            ref = self._execute_poll(seq, value)
        self._outstanding.append(ref)
        return ref

    def _execute_sealed(self, seq: int, value: Any) -> CompiledDAGRef:
        frame = None   # serialize once per execute, reuse across targets
        if len(self.input_chans) > 1 or any(
                a is not None for _, a in self.input_chans):
            from ..core.object_store import _FramedValue
            frame = _FramedValue(value, False)
        # no ack wait: the auto-drain in execute() already proved every
        # stage consumed seq - max_inflight (all nodes are ancestors of
        # the drained output node), so this ring position is retired
        for base, addr in self.input_chans:
            ch.write_slot(self.store, base, seq, value, frame=frame,
                          push_addr=addr)
        return CompiledDAGRef(self.store, None, self.stop_oid,
                              dag=self, seq=seq)

    def _execute_poll(self, seq: int, value: Any) -> CompiledDAGRef:
        slot = seq % self.max_inflight
        from ..core.object_store import _FramedValue
        from ..core.object_transfer import push_object
        frame = None
        for base, addr in self.input_chans:
            if addr is None:
                self.store.put(_slot_oid(base, slot), value)
            else:
                if frame is None:
                    frame = _FramedValue(value, False)
                if not push_object(addr, _slot_oid(base, slot),
                                   frame=frame):
                    raise RuntimeError(
                        f"DAG input push to {addr} rejected "
                        "(consumer store full?)")
        return CompiledDAGRef(self.store, _slot_oid(self.output_chan, slot),
                              self.stop_oid)

    def teardown(self, timeout_s: float = 30.0):
        if self._torn_down:
            return
        self._torn_down = True
        flight.chan_closed(self._n_chans)
        ch.signal_stop(self.store, self.stop_oid)
        # own-store actors wait on their LOCAL stores for the flag
        from ..core.object_transfer import push_object
        for addr in self._push_addrs:
            try:
                push_object(addr, self.stop_oid, True)
            except OSError:
                pass  # node gone: its loop died with it
        import ray_tpu_torch
        try:
            ray_tpu_torch.get(self._loop_refs, timeout=timeout_s)
        except Exception:
            pass  # loops may have errored; teardown continues
        # sweep unconsumed slots (inputs never read, outputs never got,
        # middle edges a stopped loop never read) so a torn-down DAG
        # leaves no channel objects behind in any store; the driver
        # pacing bounds live slots to the trailing ring window
        lo, hi = self._seq - 2 * self.max_inflight, self._seq
        if self.sealed:
            ch.drain_stale_slots(self.store, self._lands.get(None, []),
                                 lo, hi)
        # every own store: its slots and the stop flag pushed there, swept
        # by an actor living on it (its loop has returned by now)
        sweeps = []
        for addr, actor in self._sweepers.items():
            bases = self._lands.get(addr, []) if self.sealed else []
            try:
                sweeps.append(actor._exec(_sweep_local_store, bases, lo, hi,
                                          self.stop_oid.hex()))
            except Exception:
                pass  # actor gone: its node's store went with it
        try:
            ray_tpu_torch.get(sweeps, timeout=timeout_s)
        except Exception:
            pass  # a node died mid-sweep; its store died with it
        try:
            self.store.delete(self.stop_oid)
        except Exception:
            pass  # store closing; the oid dies with it


def _sweep_local_store(instance, bases: list, lo: int, hi: int,
                       stop_hex: str) -> None:
    """Teardown's sweep of an own-store node, run by one of its actors:
    the unconsumed slots of the channels landing there and the stop flag
    pushed there."""
    from ..core import runtime as rt_mod
    store = rt_mod.get_runtime_if_exists().store
    ch.drain_stale_slots(store, bases, lo, hi)
    try:
        store.delete(ObjectID(bytes.fromhex(stop_hex)))
    except Exception:
        pass  # store closing; the oid dies with it
