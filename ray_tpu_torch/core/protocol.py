"""Wire-protocol versioning for the control plane.

The reference versions every cross-process message through generated
protobuf schemas (reference: src/ray/protobuf/*.proto, 36 files) so peers
from different releases fail loudly instead of mis-parsing each other. This
runtime deliberately keeps pickled dataclasses on an authkeyed channel
(single-language cluster, no cross-language marshalling) — but the
cross-VERSION guarantee still matters: a worker, node agent, or driver
built from a different checkout must be rejected at the handshake, not
crash mid-job on a missing dataclass field.

Every register message carries ``pv`` (the port's head takes a worker's
`register`; a node agent's `register_node` and a driver client's
`register_driver` wait for ``core/node_agent.py`` and ``core/client.py``); the head compares it against its own PROTOCOL_VERSION and
refuses mismatches with a structured error the peer surfaces to the user.
Bump PROTOCOL_VERSION whenever a control-message shape, TaskSpec/ActorSpec
field, or the object-store wire framing changes incompatibly.

GCS snapshots embed SNAPSHOT_SCHEMA_VERSION the same way so
``init(resume_from=...)`` across an incompatible upgrade fails with a
clear message instead of restoring garbage state (reference analog: the
GCS table schema version in gcs_storage).

The batch frame (v3)
--------------------
Every peer may coalesce consecutive control messages into one frame::

    {"t": "batch", "msgs": [msg, msg, ...]}

with the contained messages processed strictly in list order — a batch is
a transport optimization, never a reordering point, so per-connection
FIFO invariants (func_def before the submits that reference it, ref_add
before a later ref_drop) survive batching unchanged. Senders fill batches
through an adaptive flush buffer (core/worker.py WorkerRuntime.send_async)
drained combining-lock style — no flusher thread: an async sender appends
and try-acquires the connection, shipping its own message immediately
when uncontended, while under a burst the first sender becomes the
shipper and everything appended during its pipe write coalesces into
large frames (one pickle + one syscall amortized over N; every holder
re-checks the buffer after releasing, so nothing strands). Synchronous
messages (ensure/blocked/rpc/...) drain the buffer in-order and ship
immediately with it. Receivers handle a batch with one scheduler lock
acquisition and one deferred scheduling pass (head: Runtime._handle_batch;
workers splice batches into their ordered backlog). v2 peers know none of
this, so v3 is a handshake-incompatible bump.
"""
from __future__ import annotations

# Bump on any incompatible control-plane or store-framing change.
# v2: submit/actor_call imply the submitter's interest in return_ids
#     (no per-task ref_add), batched ref_drops, positional-tuple
#     TaskSpec/ActorSpec pickling (+ max_calls field).
# v3: client->head "batch" frames (adaptive flush buffer, see module
#     docstring); multi-oid "ensure" remains but is now sent once up
#     front for every missing ref of a bulk get/wait.
# v4: sealed ring channels (dag/channel.py). No NEW control frames, but
#     two cross-build store contracts changed: the native store gained
#     os_chan_get (stop-aware blocking get — an old-build worker's
#     libobjstore lacks the symbol, and channel consumers rely on its
#     stop-wake semantics), and serve's handle_request_streaming grew a
#     `chan` argument whose dict reply an old-build handle would treat
#     as a stream id. Same-build clusters only, as ever.
# v5: flight-recorder collection frames (core/flight.py): the head may
#     send "flight_pull" {nonce, stats_only} to any worker, which
#     answers "flight_ring" {nonce, snap} carrying its event-ring
#     snapshot + (mono_ns, wall_ns) clock pair for offset estimation.
#     An old-build worker would drop flight_pull on the floor and the
#     head would wait out its collection timeout per pull — reject at
#     the handshake instead.
# v6: stall-doctor live-stack collection frames (core/stacks.py): the
#     head may send "stack_dump" {nonce, no_stacks} to any worker OR
#     driver, answered with "stack_reply" {nonce, snap} carrying every
#     thread's frames plus wait-beacon/task annotations. Like
#     flight_pull, the reply is built on the per-connection recv
#     threads, so a dump succeeds while the target's executor threads
#     are wedged; an old-build peer would drop the frame and stall
#     every stack/hang report for its full collection timeout — reject
#     at the handshake instead.
# v7: shared-directory frames (core/directory.py): any peer may send
#     "dir_update" {d, put, drop} (async merge into a head-side named
#     hint map, owner-stamped and swept on disconnect) and "dir_query"
#     {d, keys, reply_oid} (answered inline on the head recv thread via
#     the rpc_reply plumbing). The serve front door rides these for its
#     shared proxy route table and the cluster-wide prefix-cache
#     directory; an old-build head would drop both frames and every
#     proxy route refresh / prefix lookup would wait out its timeout —
#     reject at the handshake instead.
PROTOCOL_VERSION = 7

# Bump on any incompatible change to the sqlite snapshot contents.
# v2: named-actor keys are namespace-qualified ("ns/name"); v1 snapshots
#     are migrated on restore (unqualified names -> "default/name").
SNAPSHOT_SCHEMA_VERSION = 2


class ProtocolMismatchError(ConnectionError):
    """Peer speaks a different wire-protocol version than this process."""


def check_peer_version(peer_pv, who: str) -> None:
    """Raise ProtocolMismatchError unless `peer_pv` matches ours.

    `who` names the peer for the error message ("worker", "node agent",
    "driver client"). Peers that predate versioning send no ``pv`` at
    all (None) — rejected with the same message, since they are by
    definition an older build.
    """
    if peer_pv != PROTOCOL_VERSION:
        raise ProtocolMismatchError(
            f"{who} speaks wire-protocol version {peer_pv!r}, this process "
            f"speaks {PROTOCOL_VERSION}; mixing builds in one cluster is "
            f"not supported — restart the cluster from one checkout")
