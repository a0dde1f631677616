"""Head restart survivability (reference: GCS fault tolerance —
gcs/store_client/redis_store_client.h:111 restore-from-Redis + retryable
client RPC wrappers under src/ray/rpc/): a driver client rides out a head
kill+restart — it reconnects with backoff, resubmits unresolved tasks, and
its in-flight gets complete against the new session.

The port's copy of ``tests/test_head_restart.py``, with its imports
pointed at ``ray_tpu_torch``.

The head runs as a subprocess of the port (``init(...)`` of
``ray_tpu_torch``), and the driver attaches through its
``cluster.json``, which names the port's package. Its heads listen on
two consecutive free ports (``PORT``, ``PORT + 1``) in the place of the
reference's fixed 18431 and 18432, which the reference's file holds when
both run at once.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest

AUTHKEY = "ab" * 16


def _free_pair() -> int:
    """The first of two consecutive ports free right now: a head restarts
    on the same port, and the unrelated cluster takes the next."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + 1 > 65535:
            continue
        socks = []
        try:
            for p in (base, base + 1):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no two consecutive free ports")


PORT = _free_pair()

HEAD_SCRIPT = """
import json, os, sys, time
import ray_tpu_torch
from ray_tpu_torch.core.config import cfg
cfg.override(head_tcp_port={port}, gcs_snapshot_period_s=0.5,
             worker_prestart=2)
info = ray_tpu_torch.init(num_cpus=2{resume})
print(json.dumps(info), flush=True)
while True:
    time.sleep(0.5)
"""


def _start_head(tmp_path, resume_from=None):
    env = dict(os.environ)
    env["RTPU_CLUSTER_AUTHKEY"] = AUTHKEY
    env.setdefault("JAX_PLATFORMS", "cpu")
    resume = f", resume_from={resume_from!r}" if resume_from else ""
    proc = subprocess.Popen(
        [sys.executable, "-c",
         HEAD_SCRIPT.format(port=PORT, resume=resume)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    line = proc.stdout.readline()
    try:
        info = json.loads(line)
    except json.JSONDecodeError:
        rest = proc.stdout.read()
        raise RuntimeError(f"head failed to start: {line}{rest}")
    return proc, info


@pytest.fixture
def fresh_driver_state():
    import ray_tpu_torch
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


def test_driver_survives_head_restart(tmp_path, fresh_driver_state):
    import ray_tpu_torch
    head1, info1 = _start_head(tmp_path)
    head2 = None
    try:
        cf = os.path.join(info1["session_dir"], "cluster.json")
        ray_tpu_torch.init(address=cf)

        @ray_tpu_torch.remote
        def add(a, b):
            return a + b

        @ray_tpu_torch.remote
        def slow(x):
            import time as _t
            _t.sleep(6.0)
            return x * 10

        # a completed round-trip before the kill
        assert ray_tpu_torch.get(add.remote(2, 3), timeout=60) == 5

        # mid-workload: this task is IN FLIGHT when the head dies
        ref = slow.remote(7)
        time.sleep(1.0)
        head1.send_signal(signal.SIGKILL)
        head1.wait(timeout=10)

        # restart the head from the old session's snapshot, same address
        head2, info2 = _start_head(
            tmp_path, resume_from=info1["session_dir"])
        assert "restored" in info2

        # the driver's pending get resumes: the unresolved task was
        # resubmitted to the new head and re-executed there
        assert ray_tpu_torch.get(ref, timeout=120) == 70
        # and the SAME driver keeps submitting new work
        assert ray_tpu_torch.get(add.remote(10, 20), timeout=120) == 30
    finally:
        for p in (head1, head2):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=10)


@pytest.mark.slow
def test_named_actor_restored_after_restart(tmp_path, fresh_driver_state):
    import ray_tpu_torch
    head1, info1 = _start_head(tmp_path)
    head2 = None
    try:
        cf = os.path.join(info1["session_dir"], "cluster.json")
        ray_tpu_torch.init(address=cf)

        @ray_tpu_torch.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def bump(self):
                self.n += 1
                return self.n

        c = Counter.options(name="survivor", lifetime="detached").remote()
        assert ray_tpu_torch.get(c.bump.remote(), timeout=60) == 1
        time.sleep(3.0)  # let a snapshot cycle capture the named actor

        head1.send_signal(signal.SIGKILL)
        head1.wait(timeout=10)
        head2, info2 = _start_head(
            tmp_path, resume_from=info1["session_dir"])
        assert info2["restored"]["actors"] >= 1

        # reconnect happens lazily on the next call; the restored actor is
        # a FRESH instance re-created from its spec (state restarts at 0)
        deadline = time.monotonic() + 120
        c2 = None
        while time.monotonic() < deadline:
            try:
                c2 = ray_tpu_torch.get_actor("survivor")
                break
            except Exception:
                time.sleep(0.5)
        assert c2 is not None, "named actor never restored"
        assert ray_tpu_torch.get(c2.bump.remote(), timeout=120) == 1
    finally:
        for p in (head1, head2):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=10)


@pytest.mark.slow
def test_reconnect_refuses_unrelated_cluster(tmp_path, fresh_driver_state):
    """A driver whose head died must NOT silently attach to some other
    local cluster that auto-resolve happens to find (cross-cluster
    hijack): its session lineage check rejects the foreign head, and
    sends fail with ConnectionError instead of landing on the wrong
    cluster (reference analog: GCS FT clients reconnect to a fixed
    address, never to 'any GCS')."""
    import ray_tpu_torch
    from ray_tpu_torch.core.config import cfg
    head1, info1 = _start_head(tmp_path)
    foreign = None
    try:
        cf = os.path.join(info1["session_dir"], "cluster.json")
        ray_tpu_torch.init(address=cf)

        @ray_tpu_torch.remote
        def nop():
            return 1

        assert ray_tpu_torch.get(nop.remote(), timeout=60) == 1

        head1.send_signal(signal.SIGKILL)
        head1.wait(timeout=10)
        # an unrelated cluster appears (different port, NEWEST session):
        # auto-resolve would pick it — the identity check must refuse
        env = dict(os.environ)
        env["RTPU_CLUSTER_AUTHKEY"] = AUTHKEY
        env.setdefault("JAX_PLATFORMS", "cpu")
        foreign = subprocess.Popen(
            [sys.executable, "-c",
             HEAD_SCRIPT.format(port=PORT + 1, resume="")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        json.loads(foreign.stdout.readline())

        cfg.override(driver_reconnect_timeout_s=6.0)
        try:
            # the first send may still land in the dead socket's buffer;
            # keep submitting until the refused-reconnect surfaces
            got = None
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and got is None:
                try:
                    ray_tpu_torch.get(nop.remote(), timeout=5)
                except ConnectionError as e:
                    got = e
                except Exception:
                    time.sleep(0.2)
            assert isinstance(got, ConnectionError), \
                "driver attached to an unrelated cluster"
        finally:
            cfg.override(driver_reconnect_timeout_s=60.0)
    finally:
        for p in (head1, foreign):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=10)
