"""Config/flag system tests (ray_config_def.h analog).

The port's copy of ``tests/test_config.py``, with its imports pointed at
``ray_tpu_torch``.

The scripts of the two ``slow`` cases run on the port in a subprocess;
``test_idle_workers_reaped_beyond_prestart`` asks for 4 CPUs, as the
reference's does, and stays ``slow``.
"""
import pytest  # noqa: E402
import os
import subprocess
import sys

from ray_tpu_torch.core.config import Config, Flag, cfg


def test_defaults_and_types():
    assert isinstance(cfg.object_store_memory, int)
    assert cfg.object_store_memory == 2 << 30
    assert isinstance(cfg.serve_replica_poll_s, float)
    assert isinstance(cfg.event_export_enabled, bool)


def test_env_override_parsing():
    c = Config([Flag("x_int", 7), Flag("x_float", 1.5),
                Flag("x_bool", False), Flag("x_str", "a")])
    os.environ["RTPU_X_INT"] = "42"
    os.environ["RTPU_X_FLOAT"] = "2.5"
    os.environ["RTPU_X_BOOL"] = "true"
    os.environ["RTPU_X_STR"] = "hello"
    try:
        assert c.x_int == 42
        assert c.x_float == 2.5
        assert c.x_bool is True
        assert c.x_str == "hello"
    finally:
        for k in ("RTPU_X_INT", "RTPU_X_FLOAT", "RTPU_X_BOOL", "RTPU_X_STR"):
            del os.environ[k]


def test_programmatic_override_and_reset():
    c = Config([Flag("y", 1)])
    assert c.y == 1
    c.override(y=9)
    assert c.y == 9
    c.reset("y")
    assert c.y == 1
    try:
        c.override(y="nope")
        raise AssertionError("type check should have fired")
    except TypeError:
        pass
    try:
        c.override(nonexistent=1)
        raise AssertionError("unknown flag should have fired")
    except AttributeError:
        pass


def test_dump_and_describe():
    d = cfg.dump()
    assert "worker_prestart" in d and "rpc_pool_workers" in d
    rows = cfg.describe()
    row = next(r for r in rows if r["name"] == "worker_prestart")
    assert row["env"] == "RTPU_WORKER_PRESTART"
    assert row["doc"]


@pytest.mark.slow
def test_flag_reaches_runtime():
    """RTPU_ env flag changes real runtime behavior in a fresh process."""
    code = (
        "import ray_tpu_torch\n"
        "ray_tpu_torch.init(num_cpus=2)\n"
        "from ray_tpu_torch.core import runtime as rt_mod\n"
        "rt = rt_mod.get_runtime_if_exists()\n"
        "assert rt.store.capacity() >= 48 * 1024 * 1024, rt.store.capacity()\n"
        "assert rt.store.capacity() < 128 * 1024 * 1024\n"
        "assert len(rt.workers) == 0, rt.workers\n"
        "ray_tpu_torch.shutdown()\n"
        "print('OK')\n")
    env = dict(os.environ)
    env["RTPU_OBJECT_STORE_MEMORY"] = str(64 * 1024 * 1024)
    env["RTPU_WORKER_PRESTART"] = "0"
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout


@pytest.mark.slow
def test_idle_workers_reaped_beyond_prestart():
    """Idle workers above the prestart floor exit after
    worker_idle_timeout_s (worker_pool idle eviction)."""
    import subprocess
    import sys
    import textwrap
    script = textwrap.dedent("""
        import time
        import ray_tpu_torch
        from ray_tpu_torch.core import runtime as rt_mod
        ray_tpu_torch.init(num_cpus=4)
        rt = rt_mod.get_runtime_if_exists()

        @ray_tpu_torch.remote
        def work(i):
            time.sleep(0.3)
            return i

        # force 4 concurrent workers
        assert ray_tpu_torch.get([work.remote(i) for i in range(4)],
                                 timeout=120) == [0, 1, 2, 3]
        time.sleep(1.0)
        live0 = sum(1 for w in rt.workers.values() if w.state == "idle")
        assert live0 >= 3, live0
        deadline = time.time() + 30
        while time.time() < deadline:
            live = sum(1 for w in rt.workers.values()
                       if w.state == "idle")
            if live <= 2:
                break
            time.sleep(0.5)
        assert live <= 2, live
        ray_tpu_torch.shutdown()
        print("REAP_OK")
    """)
    env = dict(os.environ)
    env["RTPU_WORKER_IDLE_TIMEOUT_S"] = "2.0"
    env["RTPU_WORKER_PRESTART"] = "2"
    env["RTPU_HEALTH_CHECK_PERIOD_MS"] = "500"
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr
    assert "REAP_OK" in r.stdout
