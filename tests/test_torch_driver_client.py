"""The port's driver client (``ray_tpu_torch/core/client.py``):
``init(address=...)`` and the ``RTPU_ADDRESS`` auto-connect.

A second process attaches to a running head as a driver, runs tasks,
calls a named actor and gets an object the head's driver put. A job
submitted through the port's job manager calls a plain ``init()``, which
attaches through ``RTPU_ADDRESS``, and finishes. The case of
``tests/test_head_restart.py``: a driver rides out a head killed and
restarted from its snapshot at the same address, its in-flight get
resuming. Last, the two packages share ``RTPU_ADDRESS`` and the cluster
file's name: ``"auto"`` never resolves to a session of the reference
package, and the port's client refuses a cluster file that a reference
head wrote.

The scripts of the second processes are files written by the tests, and
the remote functions are defined inside them or inside the tests, so no
worker imports this module.
"""
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import textwrap
import time

import pytest

import ray_tpu_torch as ray

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.pop("RTPU_ADDRESS", None)
    env.update(extra)
    return env


def _script(tmp_path, name, body):
    path = tmp_path / name
    path.write_text(textwrap.dedent(body))
    return str(path)


@pytest.fixture
def head():
    if ray.is_initialized():
        ray.shutdown()
    ray.init(num_cpus=2, object_store_memory=256 << 20)
    yield ray
    ray.shutdown()


def _cluster_file():
    from ray_tpu_torch.core import runtime
    return runtime.get_runtime_if_exists().cluster_file


def test_second_driver_attaches_runs_tasks_and_calls_an_actor(head,
                                                              tmp_path):
    import cloudpickle

    @ray.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def bump(self, k):
            self.n += k
            return self.n

    c = Counter.options(name="shared-counter").remote()
    assert ray.get(c.bump.remote(1), timeout=60) == 1
    ref = ray.put({"answer": 41, "blob": b"x" * (2 << 20)})
    script = _script(tmp_path, "driver.py", """
        import json, sys
        import cloudpickle
        import ray_tpu_torch as rt
        info = rt.init(address=sys.argv[1])

        @rt.remote
        def square(x):
            return x * x

        out = {"info": sorted(info),
               "squares": rt.get([square.remote(i) for i in range(5)],
                                 timeout=60)}
        actor = rt.get_actor("shared-counter")
        out["bump"] = rt.get(actor.bump.remote(5), timeout=60)
        got = rt.get(cloudpickle.loads(bytes.fromhex(sys.argv[2])),
                     timeout=60)
        out["put"] = [got["answer"], len(got["blob"])]
        out["banned"] = sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "ray_tpu"))
        rt.shutdown()
        print(json.dumps(out))
    """)
    run = subprocess.run(
        [sys.executable, script, _cluster_file(),
         cloudpickle.dumps(ref).hex()],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out == {"info": ["address", "job_id", "session_dir", "wid"],
                   "squares": [0, 1, 4, 9, 16], "bump": 6,
                   "put": [41, 2 << 20], "banned": []}
    # the head's driver sees the second driver's call
    assert ray.get(c.bump.remote(0), timeout=60) == 6


def test_job_driver_attaches_through_rtpu_address(head, tmp_path):
    from ray_tpu_torch.core import runtime
    rt = runtime.get_runtime_if_exists()
    script = _script(tmp_path, "job.py", """
        import os
        import ray_tpu_torch as rt
        rt.init()                     # RTPU_ADDRESS, set by the job manager

        @rt.remote
        def add(a, b):
            return a + b

        print("job sum", rt.get(add.remote(2, 3), timeout=60),
              os.environ["RTPU_ADDRESS"] == os.environ["WANT_ADDRESS"])
        rt.shutdown()
    """)
    job = rt.job_submit(f"{sys.executable} {script}",
                        env={"WANT_ADDRESS": rt.cluster_file})
    deadline = time.monotonic() + 120
    while rt.job_status(job)["status"] not in ("SUCCEEDED", "FAILED",
                                                "STOPPED"):
        assert time.monotonic() < deadline, rt.job_logs(job)
        time.sleep(0.2)
    assert rt.job_status(job)["status"] == "SUCCEEDED", rt.job_logs(job)
    assert "job sum 5 True" in rt.job_logs(job)


# -- a head restart (tests/test_head_restart.py) --------------------------

AUTHKEY = "cd" * 16

HEAD_SCRIPT = """
import json, sys, time
import ray_tpu_torch as rt
from ray_tpu_torch.core.config import cfg
cfg.override(head_tcp_port=int(sys.argv[1]), gcs_snapshot_period_s=0.5,
             worker_prestart=2)
resume = sys.argv[2] if len(sys.argv) > 2 else None
info = rt.init(num_cpus=2, resume_from=resume)
print(json.dumps(info), flush=True)
while True:
    time.sleep(0.5)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def short_tmp():
    """A temp dir with a short path (a session's AF_UNIX socket path must
    stay under 108 bytes, which pytest's tmp_path can exceed)."""
    d = tempfile.mkdtemp(prefix="rtt")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _start_head(tmp, port, resume_from=None):
    script = os.path.join(tmp, "head.py")
    with open(script, "w") as f:
        f.write(HEAD_SCRIPT)
    args = [sys.executable, script, str(port)] + \
        ([resume_from] if resume_from else [])
    proc = subprocess.Popen(
        args, env=_env(RTPU_CLUSTER_AUTHKEY=AUTHKEY, TMPDIR=tmp),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    line = proc.stdout.readline()
    try:
        return proc, json.loads(line)
    except json.JSONDecodeError:
        proc.kill()
        raise RuntimeError(f"head failed to start: {line}"
                           f"{proc.stdout.read()}")


def test_driver_survives_head_restart(short_tmp, monkeypatch):
    if ray.is_initialized():
        ray.shutdown()
    # this test's heads keep their sessions under short_tmp, and so does
    # the driver's "auto" fallback: no other cluster can be picked
    monkeypatch.setattr(tempfile, "tempdir", short_tmp)
    port = _free_port()
    head1, info1 = _start_head(short_tmp, port)
    head2 = info2 = None
    try:
        cf = os.path.join(info1["session_dir"], "cluster.json")
        ray.init(address=cf)

        @ray.remote
        def add(a, b):
            return a + b

        @ray.remote
        def slow(x):
            import time as _t
            _t.sleep(6.0)
            return x * 10

        assert ray.get(add.remote(2, 3), timeout=60) == 5
        ref = slow.remote(7)          # in flight when the head dies
        time.sleep(1.0)
        head1.send_signal(signal.SIGKILL)
        head1.wait(timeout=10)
        head2, info2 = _start_head(short_tmp, port,
                                   resume_from=info1["session_dir"])
        assert "restored" in info2
        # the unresolved task was resubmitted to the new head
        assert ray.get(ref, timeout=120) == 70
        assert ray.get(add.remote(10, 20), timeout=120) == 30
    finally:
        if ray.is_initialized():
            ray.shutdown()
        for p, info in ((head1, info1), (head2, info2)):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=10)
            if info is not None:
                # a killed head cannot remove its store
                with open(os.path.join(info["session_dir"],
                                       "cluster.json")) as f:
                    store = json.load(f)["store_path"]
                if os.path.exists(store):
                    os.unlink(store)


# -- the two packages side by side -----------------------------------------

def test_port_client_never_attaches_to_a_reference_cluster(short_tmp,
                                                           monkeypatch):
    import ray_tpu
    from ray_tpu_torch.core.client import resolve_cluster_file
    if ray.is_initialized():
        ray.shutdown()
    monkeypatch.setattr(tempfile, "tempdir", short_tmp)
    monkeypatch.delenv("RTPU_ADDRESS", raising=False)
    ray_tpu.init(num_cpus=1, object_store_memory=64 << 20)
    try:
        from ray_tpu.core import runtime as ref_runtime
        ref_cf = ref_runtime.get_runtime_if_exists().cluster_file
        # a live reference session exists, but "auto" scans only the
        # port's own session base
        with pytest.raises(ConnectionError, match="no running cluster"):
            resolve_cluster_file("auto")
        with pytest.raises(ConnectionError, match="not written by a "
                                                  "ray_tpu_torch head"):
            ray.init(address=ref_cf)
        monkeypatch.setenv("RTPU_ADDRESS", ref_cf)
        with pytest.raises(ConnectionError, match="not written by a "
                                                  "ray_tpu_torch head"):
            ray.init(num_cpus=1)       # the env auto-connect
        assert not ray.is_initialized()
        monkeypatch.delenv("RTPU_ADDRESS")
        # and a port head is found by "auto" beside the reference's
        ray.init(num_cpus=1, object_store_memory=64 << 20)
        try:
            port_cf = _cluster_file()
            assert resolve_cluster_file("auto") == port_cf
            assert json.load(open(port_cf))["package"] == "ray_tpu_torch"
        finally:
            ray.shutdown()
    finally:
        ray_tpu.shutdown()
