"""Typed runtime config flags, overridable via ``RTPU_*`` env vars.

Counterpart of ``ray_tpu/core/config.py`` (the ``RAY_CONFIG`` flag
system): a flag is a typed descriptor on a singleton, read once at first
access and cacheable, with ``RTPU_<NAME>`` (upper-cased) as the override
channel. The port keeps only the flags its modules read — tracing
(``util/tracing.py``), the flight recorder (``core/flight.py``) and the
multi-LoRA manager's version cache (``llm/multilora/manager.py``) — with
the reference's defaults.

Usage::

    from ray_tpu_torch.core.config import cfg
    on = cfg.flight_recorder
    cfg.override(tracing_enabled=True)   # tests / programmatic override
"""
from __future__ import annotations

import os
import threading
from typing import Any


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


class Flag:
    """One typed config entry (a ``RAY_CONFIG(type, name, default)`` row)."""

    __slots__ = ("name", "default", "type", "doc", "env")

    def __init__(self, name: str, default: Any, doc: str = ""):
        self.name = name
        self.default = default
        self.type = type(default)
        self.doc = doc
        self.env = f"RTPU_{name.upper()}"

    def parse(self, raw: str) -> Any:
        if self.type is bool:
            return _parse_bool(raw)
        if self.type is int:
            return int(raw, 0)  # accepts 0x..., underscores not needed
        return self.type(raw)


class Config:
    """Singleton flag table. Attribute access returns the effective value:
    programmatic override > ``RTPU_*`` env var > default."""

    def __init__(self, flags: list[Flag]):
        self._flags = {f.name: f for f in flags}
        self._overrides: dict[str, Any] = {}
        self._cache: dict[str, Any] = {}
        self._lock = threading.Lock()

    def __getattr__(self, name: str) -> Any:
        # __getattr__ only fires for names not found normally, so _flags
        # etc. resolve through __init__'s instance dict without recursion.
        flags = object.__getattribute__(self, "_flags")
        if name not in flags:
            raise AttributeError(f"unknown config flag {name!r}")
        with self._lock:
            if name in self._overrides:
                return self._overrides[name]
            if name in self._cache:
                return self._cache[name]
            f = flags[name]
            raw = os.environ.get(f.env)
            val = f.default if raw is None else f.parse(raw)
            self._cache[name] = val
            return val

    def override(self, **kv: Any) -> None:
        """Programmatically pin flags (tests, embedders). Type-checked."""
        with self._lock:
            for name, val in kv.items():
                f = self._flags.get(name)
                if f is None:
                    raise AttributeError(f"unknown config flag {name!r}")
                if not isinstance(val, f.type) and not (
                        f.type is float and isinstance(val, int)):
                    raise TypeError(
                        f"{name} expects {f.type.__name__}, got "
                        f"{type(val).__name__}")
                self._overrides[name] = f.type(val)

    def reset(self, *names: str) -> None:
        """Drop overrides/cache (all flags when called with no names)."""
        with self._lock:
            if not names:
                self._overrides.clear()
                self._cache.clear()
            for n in names:
                self._overrides.pop(n, None)
                self._cache.pop(n, None)


_FLAGS = [
    Flag("tracing_enabled", False,
         "stamp (trace_id, span_id) context on submitted requests "
         "(util/tracing.py)"),
    Flag("flight_recorder", True,
         "always-on per-process flight recorder (core/flight.py): "
         "sub-microsecond struct-packed event ring; off = evt() is a "
         "no-op"),
    Flag("flight_ring_slots", 16384,
         "flight-recorder ring capacity in events (rounded up to a "
         "power of two; 44 bytes/event — the default is ~720 KiB per "
         "process, overwritten oldest-first)"),
    Flag("llm_lora_refresh_s", 0.25,
         "TTL on a serving replica's cached latest-version lookups in "
         "the adapter registry: the upper bound on how long a freshly "
         "published adapter version takes to start serving (the "
         "hot-swap observation window)"),
]

cfg = Config(_FLAGS)
