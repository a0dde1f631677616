"""Channel slot ids (counterpart of ``ray_tpu/dag/channel.py``).

A channel is a pair of 12-byte id bases; message ``seq`` lives at
``ObjectID(base[:12] + uint32le(seq))``, so an id is never reused for
the channel's lifetime. The port has ``slot_oid`` only: the adapter
registry (``llm/multilora/registry.py``) seals adapter version ``v`` at
``slot_oid(base, v)``. The ring transport, its readers and writers need
the runtime's object store and are ported with it.
"""
from __future__ import annotations

import struct

from ..core.ids import ObjectID


def slot_oid(base: bytes, seq: int) -> ObjectID:
    return ObjectID(base[:12] + struct.pack("<I", seq & 0xFFFFFFFF))
