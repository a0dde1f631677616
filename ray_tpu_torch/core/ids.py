"""Binary IDs for objects, tasks, actors, nodes and jobs.

A copy of ``ray_tpu/core/ids.py`` (no JAX in it): the port keeps its own
instead of importing the reference package. Reference parity:
src/ray/common/id.h defines Job/Task/Object/Actor/NodeID as fixed-width
binary ids. We use 16 random bytes for everything (no embedded
task-index structure — in the reference, ownership metadata lives in the
owning process's object directory, ``ray_tpu/core/runtime.py``).
"""
from __future__ import annotations

import os
import random
import threading

# id generation: a urandom-seeded PRNG per (process, thread). Minting an
# id costs one getrandbits (C-level, no syscall) — ids are minted twice
# per task submit, which is hot in burst submission. The earlier
# prefix+counter scheme was cheaper still but made every id on a thread
# share its leading bytes, colliding everything derived from an id
# PREFIX (session dirs, /dev/shm store names, truncated display ids);
# ids must look random end to end.
_LOCAL = threading.local()

# Fork detection WITHOUT a per-mint getpid(): glibc >= 2.25 makes every
# getpid() a real syscall (~10-20us on virtualized hosts — it dominated
# burst submission). The child-side at-fork hook bumps the epoch instead;
# a mint compares two Python ints. Threads other than the forking one
# don't survive a fork, so their stale thread-locals can never be read.
# Accepted blind spot: a native library calling fork(2) directly bypasses
# Python's at-fork hooks — but a child like that re-entering the
# interpreter is unsupported by CPython generally (thread/lock state),
# and every Python-level fork (os.fork, multiprocessing, pty) runs hooks.
_FORK_EPOCH = [0]
if hasattr(os, "register_at_fork"):
    os.register_at_fork(
        after_in_child=lambda: _FORK_EPOCH.__setitem__(0, _FORK_EPOCH[0] + 1))


def _mint(size: int) -> bytes:
    gen = getattr(_LOCAL, "gen", None)
    if gen is None or gen[1] != _FORK_EPOCH[0]:
        # (re)seed on first use and after fork — a forked worker must
        # not continue its parent's stream
        gen = (random.Random(os.urandom(24)), _FORK_EPOCH[0])
        _LOCAL.gen = gen
    return gen[0].getrandbits(size * 8).to_bytes(size, "little")


class BaseID:
    __slots__ = ("_bytes",)
    SIZE = 16

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(f"{type(self).__name__} must be {self.SIZE} bytes")
        self._bytes = binary

    @classmethod
    def from_random(cls):
        return cls(_mint(cls.SIZE))

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __hash__(self):
        return hash((type(self).__name__, self._bytes))

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()[:12]})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class ObjectID(BaseID):
    pass


class TaskID(BaseID):
    pass


class ActorID(BaseID):
    pass


class NodeID(BaseID):
    pass


class JobID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass
