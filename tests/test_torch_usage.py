"""Usage-stats tests (reference: _private/usage/usage_lib.py).

The port's copy of ``tests/test_usage.py``, with its imports pointed at
``ray_tpu_torch``.
"""
import json
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_usage_snapshot_and_optout():
    from ray_tpu_torch.core import usage
    usage.record_library_usage("data")
    usage.record_extra_usage_tag("test_tag", "42")
    snap = usage.usage_snapshot()
    assert "data" in snap["libraries"]
    assert snap["tags"]["test_tag"] == "42"
    os.environ["RTPU_USAGE_STATS_ENABLED"] = "0"
    try:
        assert not usage.enabled()
        usage.record_library_usage("should-not-appear")
        assert "should-not-appear" not in usage.usage_snapshot()["libraries"]
    finally:
        del os.environ["RTPU_USAGE_STATS_ENABLED"]


def test_usage_file_written_on_shutdown():
    script = textwrap.dedent("""
        import ray_tpu_torch
        info = ray_tpu_torch.init(num_cpus=1)
        print("SESSION", info["session_dir"])
        from ray_tpu_torch import data
        data.from_items([{"x": 1}]).take_all()
        ray_tpu_torch.shutdown()
    """)
    env = dict(os.environ)
    env["RTPU_WORKER_PRESTART"] = "0"
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr
    session = [ln.split()[1] for ln in r.stdout.splitlines()
               if ln.startswith("SESSION")][0]
    with open(os.path.join(session, "usage_stats.json")) as f:
        snap = json.load(f)
    assert "data" in snap["libraries"]
    assert snap["version"]
