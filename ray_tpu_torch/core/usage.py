"""Usage stats: opt-out feature-usage recording.

Counterpart of ``ray_tpu/core/usage.py`` (reference parity:
_private/usage/usage_lib.py, architecture comment :20-28): libraries
record feature tags at first use, and the report is a json snapshot
(``write_usage_file``) written into a directory the caller names,
never sent anywhere. ``RTPU_USAGE_STATS_ENABLED=0`` disables recording
entirely, matching the reference's env opt-out.
"""
from __future__ import annotations

import json
import os
import threading
import time

_lock = threading.Lock()
_tags: dict[str, str] = {}
_libraries: set[str] = set()


def enabled() -> bool:
    return os.environ.get("RTPU_USAGE_STATS_ENABLED", "1") not in (
        "0", "false", "no")


def record_library_usage(name: str) -> None:
    """Called at first use of a library (data/train/tune/serve/rl/llm)."""
    if not enabled():
        return
    with _lock:
        _libraries.add(name)


def record_extra_usage_tag(key: str, value: str) -> None:
    if not enabled():
        return
    with _lock:
        _tags[key] = str(value)


def usage_snapshot() -> dict:
    from .. import __version__
    with _lock:
        return {
            "version": __version__,
            "libraries": sorted(_libraries),
            "tags": dict(_tags),
            "ts": time.time(),
        }


def write_usage_file(session_dir: str) -> str | None:
    """Persist the snapshot (the head calls this at shutdown)."""
    if not enabled():
        return None
    path = os.path.join(session_dir, "usage_stats.json")
    try:
        with open(path, "w") as f:
            json.dump(usage_snapshot(), f, indent=2)
        return path
    except OSError:
        return None
