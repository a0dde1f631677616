"""Usage-stats tests (reference: _private/usage/usage_lib.py).

The port's copy of ``tests/test_usage.py``, with its imports pointed at
``ray_tpu_torch``.

Left out: ``test_usage_file_written_on_shutdown`` (queue A19): it needs
``ray_tpu_torch.data`` (not ported yet).
"""
import os


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
