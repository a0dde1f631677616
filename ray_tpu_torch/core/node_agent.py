"""Node agent: joins a host to a running cluster over TCP.

Reference parity: the per-node raylet daemon (reference:
src/ray/raylet/main.cc:139 + node_manager.h:124) reduced to its worker-pool
role — it registers the host's resources with the head, forks/kills worker
processes on request, and reports their exits. Scheduling stays centralized
in the head (unlike the reference's per-node scheduler).

The port's copy of ``ray_tpu/core/node_agent.py``, with GPUs in the place
of its TPUs. The head leases this node's GPU indices (``--num-gpus N``
makes indices 0..N-1 of this host schedulable) and sends the leased ones
with each ``spawn_worker``; the agent puts them into the worker's
``CUDA_VISIBLE_DEVICES`` before the process starts (CUDA reads it once),
and a worker without a lease gets "". The agent itself never touches
CUDA: its node labels come from ``nvidia-smi`` (util/gpu.py).

By default the agent's workers attach the head's shared-memory object
store, so the agent must run on a host that can see it. With
``--own-store`` the node keeps its own store, spill directory and data
server, and objects cross between the stores through object_transfer.py
(the reference's object_manager.h:119 push/pull).

Usage:
    RTPU_AUTHKEY=HEX python -m ray_tpu_torch.core.node_agent \
        --head HOST:PORT --num-cpus N --num-gpus N \
        [--own-store --store-capacity BYTES] [--labels JSON] [--name NAME]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
import traceback
from multiprocessing.connection import Client

from .protocol import PROTOCOL_VERSION, ProtocolMismatchError


class NodeAgent:
    def __init__(self, head: str, authkey: bytes, resources: dict,
                 name: str = "", own_store: bool = False,
                 store_capacity: int = 1 << 30,
                 labels: dict | None = None,
                 reconnect_timeout_s: float = 30.0):
        host, port = head.rsplit(":", 1)
        name = name or f"agent-{os.uname().nodename}"
        self.head_addr = (host, int(port))
        self._authkey_bytes = authkey
        self._resources = dict(resources)
        self._name = name
        self.reconnect_timeout_s = reconnect_timeout_s
        self.conn = Client(self.head_addr, authkey=authkey)
        self.head_host = host
        self.send_lock = threading.Lock()

        # own-store mode: this node has its own shm store + spill dir +
        # data server — the true multi-host shape (objects cross nodes via
        # object_transfer pulls). Shared-store mode (default) requires the
        # head's /dev/shm to be visible (same machine).
        self.own_store = own_store
        self.local_store = None
        self.data_server = None
        data_addr = None
        if own_store:
            import atexit

            from .object_store import SharedObjectStore, SpillStore
            from .object_transfer import ObjectDataServer
            from .runtime import host_ip
            from .runtime import session_base
            safe = "".join(c if c.isalnum() else "_" for c in name)
            # this package's names: neither package's tests find or count
            # the other's stores and spill directories
            self._own_store_path = \
                f"/dev/shm/ray_tpu_torch_node_{safe}_{os.getpid()}"
            self._own_spill_dir = os.path.join(
                session_base(), f"node_{safe}_{os.getpid()}", "spill")
            self.local_store = SharedObjectStore(
                self._own_store_path, capacity=store_capacity, create=True)
            # registered the instant the shm file exists: a SIGTERM that
            # lands anywhere after this point (even mid-__init__, before
            # run()'s finally is armed) still unlinks the store
            atexit.register(self.teardown)
            self.local_spill = SpillStore(self._own_spill_dir)
            self.data_server = ObjectDataServer(
                self.local_store, self.local_spill, host="0.0.0.0")
            port_part = self.data_server.address.rsplit(":", 1)[1]
            data_addr = f"{host_ip()}:{port_part}"

        # card identity labels come from nvidia-smi — never from
        # torch.cuda, which would open a CUDA context in the agent
        from ..util.gpu import discover_gpu_labels
        self._data_addr = data_addr
        self._labels = {**discover_gpu_labels(), **(labels or {})}
        self.procs: dict[str, subprocess.Popen] = {}
        self._register()

    def _register(self):
        """Register (or re-register after a head restart) over the current
        connection (reference: raylet re-announcing itself to a failed-over
        GCS)."""
        self.conn.send({"t": "register_node", "resources": self._resources,
                        "name": self._name, "own_store": self.own_store,
                        "data_addr": self._data_addr,
                        "labels": self._labels, "pv": PROTOCOL_VERSION})
        # registration handshake: runs from the run loop only while the
        # control link is down/new, so there are no frames to stall
        reply = self.conn.recv()  # graftlint: disable=GL013
        if reply.get("t") == "rejected":
            raise ProtocolMismatchError(reply.get("error", "rejected"))
        if reply.get("pv") != PROTOCOL_VERSION:
            # symmetric check: a pre-versioning head never sends pv
            raise ProtocolMismatchError(
                f"head speaks wire-protocol version {reply.get('pv')!r}, "
                f"this node agent speaks {PROTOCOL_VERSION}")
        if reply.get("t") != "registered":
            raise RuntimeError(f"head rejected registration: {reply}")
        self.node_id = reply["node_id"]
        if self.own_store:
            self.store_path = self._own_store_path
            self.spill_dir = self._own_spill_dir
        else:
            self.store_path = reply["store_path"]
            self.spill_dir = reply.get("spill_dir", "")
            if not os.path.exists(self.store_path):
                raise RuntimeError(
                    f"object store {self.store_path} is not visible from "
                    f"this host; run with --own-store so objects move via "
                    f"the transfer service")
        # the head never echoes the authkey; we authenticated with our copy
        self.authkey = self._authkey_bytes.hex()
        self.tcp_port = reply["tcp_port"]

    def _reconnect(self) -> bool:
        """The head went away: kill orphaned workers (their control conns
        died with it) and re-dial the SAME address with backoff — a head
        restarted with cfg.head_tcp_port + RTPU_CLUSTER_AUTHKEY comes back
        dialable (the Redis-fixed-address role in reference GCS FT)."""
        if self.reconnect_timeout_s <= 0:
            return False
        for p in list(self.procs.values()):
            try:
                p.kill()
            except Exception:
                pass  # already exited
        self.procs.clear()
        deadline = time.monotonic() + self.reconnect_timeout_s
        delay = 0.25
        while time.monotonic() < deadline:
            try:
                conn = Client(self.head_addr, authkey=self._authkey_bytes)
                # swap + register atomically vs the heartbeat thread: its
                # send() takes send_lock, so no heartbeat can interleave
                # into the new conn before register_node goes out
                with self.send_lock:
                    self.conn = conn
                    self._register()
                print(f"node_agent: re-joined as node {self.node_id}",
                      flush=True)
                return True
            except ProtocolMismatchError as e:
                # deterministic refusal — retrying cannot succeed
                print(f"node_agent: rejoin refused: {e}", flush=True)
                return False
            except Exception:
                # backoff while the head is unreachable: link down, no
                # inbound frames to stall
                time.sleep(delay)  # graftlint: disable=GL013
                delay = min(delay * 2, 2.0)
        return False

    def send(self, msg):
        with self.send_lock:
            self.conn.send(msg)

    def _spawn(self, wid: str, node_id: str, gpus: tuple):
        """Fork one worker; `gpus` are the indices the head leased to it,
        its CUDA_VISIBLE_DEVICES (set before Popen)."""
        from .runtime import build_worker_env, session_base

        env = build_worker_env(
            store_path=self.store_path,
            head_addr=f"{self.head_host}:{self.tcp_port}",
            head_family="AF_INET", authkey_hex=self.authkey,
            wid=wid, node_id_hex=node_id, gpus=gpus,
            spill_dir=self.spill_dir, own_store=self.own_store)
        log_dir = os.environ.get("RTPU_AGENT_LOG_DIR") or os.path.join(
            session_base(), "agent")
        os.makedirs(log_dir, exist_ok=True)
        log = open(os.path.join(log_dir, f"worker-{wid}.log"), "wb")
        # fork+exec on the control loop is this frame's entire job;
        # heartbeats ride a separate timer thread, and spawning async
        # would reorder spawn_worker against a racing kill_worker
        proc = subprocess.Popen(  # graftlint: disable=GL013
            [sys.executable, "-m", "ray_tpu_torch.core.worker"],
            env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True)
        self.procs[wid] = proc
        self.send({"t": "worker_spawned", "wid": wid, "pid": proc.pid})
        threading.Thread(target=self._watch, args=(wid, proc),
                         daemon=True).start()

    def _watch(self, wid: str, proc: subprocess.Popen):
        rc = proc.wait()
        self.procs.pop(wid, None)
        try:
            self.send({"t": "worker_exit", "wid": wid, "rc": rc})
        except Exception:
            pass  # head gone; its EOF cleanup covers this

    def _heartbeat_loop(self):
        from .config import cfg
        period = cfg.health_check_period_ms / 1000.0
        if period <= 0:
            return
        while True:
            time.sleep(period)
            try:
                self.send({"t": "heartbeat"})
            except Exception:
                # conn gone: run() may be mid-reconnect (it swaps self.conn
                # in) — keep looping; the daemon thread dies with teardown
                continue

    def run(self):
        threading.Thread(target=self._heartbeat_loop, daemon=True,
                         name="agent-heartbeat").start()
        try:
            while True:
                try:
                    msg = self.conn.recv()
                except (EOFError, OSError):
                    if self._reconnect():
                        continue
                    break
                t = msg.get("t")
                if t == "spawn_worker":
                    try:
                        self._spawn(msg["wid"], msg["node_id"],
                                    tuple(msg.get("gpus", ())))
                    except Exception:
                        traceback.print_exc()
                        self.send({"t": "worker_exit", "wid": msg["wid"],
                                   "rc": -1})
                elif t == "free_objects":
                    if self.local_store is not None:
                        from .ids import ObjectID
                        for ob in msg["oids"]:
                            try:
                                self.local_store.delete(ObjectID(ob))
                            except Exception:
                                pass  # already evicted/deleted
                            self.local_spill.delete(ObjectID(ob))
                elif t == "kill_worker":
                    p = self.procs.get(msg["wid"])
                    if p is not None:
                        try:
                            p.kill()
                        except Exception:
                            pass  # already exited
                elif t == "shutdown":
                    break
        except (EOFError, OSError):
            pass  # head went away
        finally:
            self.teardown()

    _torn_down = False

    def teardown(self):
        """Idempotent full cleanup (kill workers, unlink the own-store shm
        file). Runs from run()'s finally, atexit, and the SIGTERM path; a
        second SIGTERM mid-teardown is ignored so the unlink completes."""
        if self._torn_down:
            return
        import signal
        try:
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
        except (ValueError, OSError):
            pass  # not the main thread / already exiting
        # flag AFTER masking SIGTERM: a signal landing between the two
        # would abort this run while the atexit retry no-ops on the flag
        self._torn_down = True
        try:
            # announce the exit so the head removes this node NOW instead
            # of on conn EOF / heartbeat timeout (runtime._agent_loop's
            # "deregister" branch); moot when the head initiated it
            self.send({"t": "deregister"})
        except Exception:
            pass  # head already gone; EOF-side cleanup covers it
        for p in list(self.procs.values()):
            try:
                p.kill()
            except Exception:
                pass  # already exited
        deadline = time.monotonic() + 2.0
        for p in list(self.procs.values()):
            try:
                p.wait(timeout=max(0.01, deadline - time.monotonic()))
            except Exception:
                pass  # unkillable child; we exit anyway
        if self.data_server is not None:
            try:
                self.data_server.stop()
            except Exception:
                pass  # server thread died with its socket
        if self.local_store is not None:
            try:
                self.local_store.close(unlink=True)
            except Exception:
                pass  # shm file may already be unlinked


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--head", required=True, help="head TCP address host:port")
    ap.add_argument("--authkey", default=None,
                    help="cluster authkey hex (or env RTPU_AUTHKEY)")
    ap.add_argument("--num-cpus", type=float, default=1.0)
    ap.add_argument("--num-gpus", type=int, default=0,
                    help="GPUs of this host the head may lease "
                         "(indices 0..N-1)")
    ap.add_argument("--resources", default="{}",
                    help='extra resources JSON, e.g. \'{"ssd": 1}\'')
    ap.add_argument("--name", default="")
    ap.add_argument("--labels", default="{}",
                    help='node labels JSON, e.g. \'{"zone": "edge"}\'')
    ap.add_argument("--own-store", action="store_true",
                    help="node-local object store + transfer service "
                         "(required off the head host)")
    ap.add_argument("--store-capacity", type=int, default=1 << 30)
    ap.add_argument("--reconnect-timeout", type=float, default=30.0,
                    help="seconds to retry re-dialing a restarted head "
                         "(0 disables)")
    args = ap.parse_args(argv)
    # terminate() must run the teardown path (kill workers, unlink the
    # own-store shm file) — without this, every terminated agent leaks
    # its /dev/shm store for the host's lifetime
    import signal
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    authkey = bytes.fromhex(args.authkey or os.environ["RTPU_AUTHKEY"])
    resources = {"CPU": args.num_cpus, **json.loads(args.resources)}
    if args.num_gpus:
        resources["GPU"] = float(args.num_gpus)
    agent = NodeAgent(args.head, authkey, resources, args.name,
                      own_store=args.own_store,
                      store_capacity=args.store_capacity,
                      labels=json.loads(args.labels),
                      reconnect_timeout_s=args.reconnect_timeout)
    print(f"node_agent: joined as node {agent.node_id}", flush=True)
    agent.run()


if __name__ == "__main__":
    main()
