"""Flight recorder — always-on, sub-microsecond event tracing.

Counterpart of ``ray_tpu/core/flight.py``, with the same record layout
and the same integer event codes, so a ring captured from the port
decodes as the reference's does. In the port the serving engine emits
into it (``STEP_BEGIN``/``STEP_END`` from ``util/profiling.py``'s step
profiler, ``PREFIX_EVICT`` from the paged engine): a per-process,
preallocated, struct-packed ring buffer whose ``evt()`` costs well under
a microsecond — cheap enough to leave on in production.

Design constraints, in order:

- **No locks, no allocation on the hot path.** ``evt(code, a0..a3)``
  packs one fixed 44-byte record (monotonic ns, code, thread id low
  bits, four int64 args) into a preallocated ``bytearray`` ring. The
  slot index comes from ``itertools.count`` (its ``__next__`` is a
  single C call, atomic under the GIL), so concurrent emitters never
  contend. Argument errors (non-int, overflow) drop the record and bump
  a counter — the recorder can never raise into instrumented code.
- **Bounded memory.** The ring holds ``cfg.flight_ring_slots`` records
  (rounded to a power of two); older events are overwritten. The
  recorder never blocks and never grows.
- **Strings never enter the ring.** Event codes and args are integers.

:func:`decode` reads a ring back. The reference's snapshot, cross-process
Chrome-trace export and bench report need its cluster runtime and wait
for the runtime's port, as do the runtime's own event codes.

On by default (``cfg.flight_recorder``; ``RTPU_FLIGHT_RECORDER=0``
binds ``evt`` to a no-op).
"""
from __future__ import annotations

import itertools
import struct
import threading
import time
from typing import Optional

# --------------------------------------------------------------------- #
# record layout
# --------------------------------------------------------------------- #

RECORD = struct.Struct("<QHHqqqq")   # ts_ns, code, tid16, a0..a3
RECSZ = RECORD.size                  # 44 bytes
_ZERO8 = bytes(8)                    # ts wipe for torn/dropped records

# --------------------------------------------------------------------- #
# event codes — wire-stable integers, the reference's values; the port
# emits only these
# --------------------------------------------------------------------- #

# llm prefix-cache heat plane (llm/paged_engine.py) — cache churn
PREFIX_EVICT = 91     # i  (pid, chain_slot)

# step profiling (util/profiling.py)
STEP_BEGIN = 70       # B  (kind,)
STEP_END = 71         # E  (kind,)


# --------------------------------------------------------------------- #
# the recorder
# --------------------------------------------------------------------- #

class FlightRecorder:
    """Preallocated struct-packed ring. One per process; create via the
    module functions, not directly (tests may instantiate with a small
    slot count through install_for_test)."""

    __slots__ = ("buf", "cap", "mask", "ctr", "bad")

    def __init__(self, slots: int):
        cap = 1 << max(6, (max(2, slots) - 1).bit_length())
        self.buf = bytearray(cap * RECSZ)
        self.cap = cap
        self.mask = cap - 1
        self.ctr = itertools.count()
        self.bad = 0


def decode(buf: bytes) -> list[tuple]:
    """Ring bytes -> [(ts_ns, code, tid, a0, a1, a2, a3)] sorted by ts.
    Empty slots (ts == 0) are skipped; a record mid-overwrite at capture
    time can tear (diagnostic tool, not a transactional log)."""
    out = []
    for off in range(0, len(buf) - RECSZ + 1, RECSZ):
        rec = RECORD.unpack_from(buf, off)
        if rec[0]:
            out.append(rec)
    out.sort(key=lambda r: r[0])
    return out


# --------------------------------------------------------------------- #
# module singleton + hot-path emit
# --------------------------------------------------------------------- #

_rec: Optional[FlightRecorder] = None
_resolved = False


def _noop(code, a0=0, a1=0, a2=0, a3=0):
    return None


def _make_evt(rec: FlightRecorder):
    # everything the hot path touches lives in closure cells: no
    # attribute lookups, no globals beyond the two clock/tid callables
    pack = RECORD.pack_into
    buf = rec.buf
    mask = rec.mask
    nxt = rec.ctr.__next__
    mono = time.monotonic_ns
    tid = threading.get_ident

    def evt(code, a0=0, a1=0, a2=0, a3=0):
        off = (nxt() & mask) * RECSZ
        try:
            pack(buf, off, mono(), code, tid() & 0xFFFF, a0, a1, a2, a3)
        except (struct.error, OverflowError, TypeError):
            # bad args drop the record, never raise; pack_into may have
            # torn a partial record into the slot — zero its timestamp
            # so decode() reads the slot as empty
            buf[off:off + 8] = _ZERO8
            rec.bad += 1

    return evt


def _ensure() -> Optional[FlightRecorder]:
    global _rec, _resolved, evt
    if _resolved:
        return _rec
    _resolved = True
    from .config import cfg
    if cfg.flight_recorder:
        _rec = FlightRecorder(cfg.flight_ring_slots)
        evt = _make_evt(_rec)
    else:
        evt = _noop
    return _rec


def _evt_unresolved(code, a0=0, a1=0, a2=0, a3=0):
    if _ensure() is not None:
        evt(code, a0, a1, a2, a3)


#: THE emit function. Call as ``flight.evt(CODE, a0, a1)`` — module
#: attribute lookup keeps the binding current across a recorder swap.
evt = _evt_unresolved


def install_for_test(slots: int) -> FlightRecorder:
    """Swap in a fresh recorder with a custom ring size (tests)."""
    global _rec, _resolved, evt
    _resolved = True
    _rec = FlightRecorder(slots)
    evt = _make_evt(_rec)
    return _rec
