"""Wire-protocol version handshake (reference analog: protobuf-versioned
control messages, src/ray/protobuf/*.proto — here a pv field checked at
every register; see core/protocol.py).

The port's copy of ``tests/test_protocol_version.py``, with its imports
pointed at ``ray_tpu_torch``.
"""
import pickle

import pytest

import ray_tpu_torch
from ray_tpu_torch.core import protocol


def test_mismatched_driver_rejected(tmp_path):
    ray_tpu_torch.init(num_cpus=1)
    try:
        import json
        import os
        from multiprocessing.connection import Client

        from ray_tpu_torch.core.api import _runtime

        with open(_runtime().cluster_file) as f:
            cf = json.load(f)
        # a peer from a different build (other pv) must be refused with a
        # structured error, not a crash or a silent mis-parse
        conn = Client(cf["unix_addr"], "AF_UNIX",
                      authkey=bytes.fromhex(cf["authkey"]))
        conn.send({"t": "register_driver", "pid": os.getpid(),
                   "pv": protocol.PROTOCOL_VERSION + 1})
        reply = conn.recv()
        assert reply["t"] == "rejected"
        assert "wire-protocol" in reply["error"]
        conn.close()
    finally:
        ray_tpu_torch.shutdown()


def test_matching_driver_accepted(tmp_path):
    ray_tpu_torch.init(num_cpus=1)
    try:
        from ray_tpu_torch.core import client
        from ray_tpu_torch.core.api import _runtime

        conn, reply = client._dial(_runtime().cluster_file)
        assert reply["t"] == "registered_driver"
        conn.close()
    finally:
        ray_tpu_torch.shutdown()


def test_newer_snapshot_rejected(tmp_path):
    from ray_tpu_torch.core.gcs_store import GcsStore, restore

    d = tmp_path / "old_session"
    d.mkdir()
    store = GcsStore(str(d / "gcs.sqlite"))
    store.put("snapshot", "meta", pickle.dumps(
        {"schema_version": protocol.SNAPSHOT_SCHEMA_VERSION + 1}))
    store.close()
    with pytest.raises(RuntimeError, match="schema version"):
        restore(object(), str(d))


def test_unversioned_snapshot_still_restores(tmp_path):
    """Snapshots written before versioning (no schema_version) load."""
    from ray_tpu_torch.core.gcs_store import GcsStore

    d = tmp_path / "old_session"
    d.mkdir()
    store = GcsStore(str(d / "gcs.sqlite"))
    store.close()
    ray_tpu_torch.init(num_cpus=1, resume_from=str(d))
    ray_tpu_torch.shutdown()
