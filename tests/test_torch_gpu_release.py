"""A dead GPU worker's lease goes back only when its card lets go.

On fake GPUs (``init(num_cpus=2, num_gpus=1)``; nothing here touches
CUDA) with an injected compute-process reader in the place of
``util/gpu.py``'s ``compute_apps``: the head holds a SIGKILLed worker's
index, and the "GPU" count of ``available_resources()``, while the card
lists its pid; gives them back once the pid is gone; gives them back at
``GPU_RELEASE_BOUND_S`` when it never goes; and, where the card lists
pids of another PID namespace (a container's), while the card lists
more processes than before the worker opened it. Without a reader (no
``nvidia-smi``) the release is immediate. A replacement that asks for
the GPU waits for the lease."""
import os
import signal
import subprocess
import threading
import time

import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.core import runtime
from ray_tpu_torch.util import gpu


class _Card:
    """What the fake card lists: {index: [(pid, MiB), ...]}."""

    def __init__(self):
        self.rows = []
        self.lock = threading.Lock()

    def set(self, rows):
        with self.lock:
            self.rows = list(rows)

    def __call__(self):
        with self.lock:
            return {0: list(self.rows)}


@pytest.fixture(scope="module")
def head():
    if ray.is_initialized():
        ray.shutdown()
    ray.init(num_cpus=2, num_gpus=1, object_store_memory=64 * 1024 * 1024)
    yield runtime.get_runtime_if_exists()
    ray.shutdown()


@pytest.fixture
def card(head):
    c = _Card()
    head._gpu_apps = c
    yield c
    head._gpu_apps = None


@ray.remote(num_gpus=1)
class Dev:
    def pid(self):
        return os.getpid()

    def visible(self):
        return os.environ["CUDA_VISIBLE_DEVICES"]


def _worker(head, pid):
    with head.lock:
        (w,) = [w for w in head.workers.values()
                if getattr(w.proc, "pid", None) == pid]
    return w


def _kill_and_reap(head, pid):
    w = _worker(head, pid)
    os.kill(pid, signal.SIGKILL)
    deadline = time.monotonic() + 30
    while w.proc.poll() is None or w.state != "dead":
        assert time.monotonic() < deadline, "worker not reaped"
        time.sleep(0.01)
    return w, time.monotonic()


def _gpu_avail():
    return ray.available_resources().get("GPU", 0.0)


def _wait_back(w, timeout=30.0):
    deadline = time.monotonic() + timeout
    while w.gpus:
        assert time.monotonic() < deadline, "lease never came back"
        time.sleep(0.01)
    return time.monotonic()


def test_lease_held_while_pid_listed_then_back(head, card):
    a = Dev.remote()
    pid = ray.get(a.pid.remote(), timeout=60)
    card.set([(pid, 6662)])
    w, _ = _kill_and_reap(head, pid)
    # a replacement asks for the GPU while the card still lists the pid
    b = Dev.remote()
    ready = b.visible.remote()
    time.sleep(1.0)
    assert w.gpus == (0,) and w.gpu_held == "all"
    assert _gpu_avail() == 0.0
    assert ray.wait([ready], timeout=0)[0] == []
    with head.lock:
        assert head.nodes[w.node_id].gpu_free == []
    card.set([])
    _wait_back(w)
    assert w.card_wait[0] == "freed"
    assert ray.get(ready, timeout=60) == "0"
    ray.kill(b)
    deadline = time.monotonic() + 30
    while _gpu_avail() != 1.0:
        assert time.monotonic() < deadline
        time.sleep(0.05)


def test_lease_back_at_the_bound(head, card, monkeypatch):
    monkeypatch.setattr(runtime, "GPU_RELEASE_BOUND_S", 1.5)
    a = Dev.remote()
    pid = ray.get(a.pid.remote(), timeout=60)
    card.set([(pid, 6662)])          # the pid never leaves
    w, t_reaped = _kill_and_reap(head, pid)
    time.sleep(0.5)
    assert w.gpus == (0,) and _gpu_avail() == 0.0
    t_back = _wait_back(w)
    assert t_back - t_reaped >= 1.5
    assert w.card_wait[0] == "bound (pid)"
    deadline = time.monotonic() + 30
    while _gpu_avail() != 1.0:
        assert time.monotonic() < deadline
        time.sleep(0.05)


def test_foreign_pids_hold_by_the_cards_entry_count(head, card):
    """A container's card lists host pids: the worker's own pid never
    shows, and the lease waits while the card lists more processes than
    it did before the worker opened it."""
    card.set([(1, 500)])             # a process outside the runtime
    a = Dev.remote()
    pid = ray.get(a.pid.remote(), timeout=60)
    w = _worker(head, pid)
    assert w.card_base == {0: [(1, 500)]}
    card.set([(1, 500), (1, 6662)])  # the worker's entry, by a host pid
    w, _ = _kill_and_reap(head, pid)
    time.sleep(0.5)
    assert w.gpus == (0,)
    card.set([(1, 500)])
    _wait_back(w)
    assert w.card_wait[0] == "freed"


def test_without_nvidia_smi_the_release_is_immediate(head):
    assert head._gpu_apps is None
    a = Dev.remote()
    pid = ray.get(a.pid.remote(), timeout=60)
    w, t_reaped = _kill_and_reap(head, pid)
    _wait_back(w, timeout=2.0)
    assert w.card_wait is None and w.gpu_held is None
    deadline = time.monotonic() + 30
    while _gpu_avail() != 1.0:
        assert time.monotonic() < deadline
        time.sleep(0.05)


def test_compute_apps_maps_processes_to_indices(monkeypatch):
    outs = {
        "--query-gpu=index,uuid,pci.bus_id":
            "0, GPU-a, 00000000:18:00.0\n1, GPU-b, 00000000:2A:00.0\n",
        "--query-compute-apps=pid,gpu_uuid,gpu_bus_id,used_memory":
            "131, GPU-b, 00000000:2A:00.0, 6662\n"
            "7, GPU-a, 00000000:18:00.0, [N/A]\n",
    }

    def run(cmd, **_kw):
        return subprocess.CompletedProcess(cmd, 0, outs[cmd[1]], "")

    monkeypatch.setattr(gpu.shutil, "which", lambda _n: "/bin/nvidia-smi")
    monkeypatch.setattr(gpu.subprocess, "run", run)
    assert gpu.compute_apps() == {0: [(7, 0)], 1: [(131, 6662)]}
    # cards that cannot be told apart: a process is on every index
    outs["--query-gpu=index,uuid,pci.bus_id"] = (
        "0, GPU-REDACTED, x\n1, GPU-REDACTED, x\n")
    outs["--query-compute-apps=pid,gpu_uuid,gpu_bus_id,used_memory"] = (
        "1, GPU-REDACTED, x, 6662\n")
    assert gpu.compute_apps() == {0: [(1, 6662)], 1: [(1, 6662)]}
    monkeypatch.setattr(gpu.shutil, "which", lambda _n: None)
    assert gpu.compute_apps() is None
