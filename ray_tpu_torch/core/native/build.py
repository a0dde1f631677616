"""Lazy build of the native object store shared library.

The port's copy of ``ray_tpu/core/native/build.py``. The reference ships
prebuilt bazel binaries (src/ray/object_manager/plasma); here the library
is compiled with g++ from this directory's ``objstore.cc`` at first use,
into ``_build/`` beside it (listed in ``.gitignore``: no binary is
committed). The build takes ~2s. A content hash of the source, written
beside the library, decides when it is stale. There is no shipped binary
to fall back to, so a host without g++ raises.

Sanitizer mode (the reference runs its C++ store tests under ASan/TSan in
CI): set ``RTPU_OBJSTORE_SANITIZE=address,undefined`` (any comma-joined
``-fsanitize=`` list) and every process that builds/loads the store in that
environment gets a ``libobjstore.<mode>.so`` debug build (-O1 -g, frame
pointers) instead of the production one. The sanitized variant caches
under its own name + source-hash file, so flipping the env never clobbers
the production binary. Loading an ASan build into a non-instrumented
python requires LD_PRELOADing libasan/libubsan.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "objstore.cc")
BUILD_DIR = os.path.join(_DIR, "_build")
_lock = threading.Lock()


def _san_mode() -> str:
    """Normalized sanitizer list from the env ('' = production build)."""
    mode = os.environ.get("RTPU_OBJSTORE_SANITIZE", "").strip()
    return ",".join(s.strip() for s in mode.split(",") if s.strip())


def _lib_path(mode: str) -> str:
    if not mode:
        return os.path.join(BUILD_DIR, "libobjstore.so")
    tag = mode.replace(",", "-")
    return os.path.join(BUILD_DIR, f"libobjstore.{tag}.so")


def _src_hash() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _compile_and_swap(mode: str) -> None:
    """Compile to a per-process tmp path and atomically replace the .so
    + hash (processes that race a first build each rename a whole file).
    Caller holds _lock. Raises RuntimeError on compile errors and when
    the compiler is missing."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = _lib_path(mode)
    tmp = f"{lib}.{os.getpid()}.tmp"
    if mode:
        # debug-grade opt level + frame pointers: sanitizer reports with
        # usable stacks beat a fast binary nobody profiles
        flags = [f"-fsanitize={mode}", "-O1", "-g",
                 "-fno-omit-frame-pointer"]
    else:
        flags = ["-O2", "-g"]
    try:
        subprocess.run(
            ["g++", *flags, "-shared", "-fPIC", "-std=c++17",
             "-o", tmp, _SRC, "-lpthread"],
            check=True,
            capture_output=True,
        )
    except subprocess.CalledProcessError as e:
        # a real compile error must surface (silently loading a stale
        # .so is the failure mode the hash scheme prevents)
        raise RuntimeError(
            "objstore.cc failed to compile:\n"
            + e.stderr.decode(errors="replace")) from e
    except OSError as e:
        raise RuntimeError(
            f"cannot build the object store from {_SRC}: g++ is needed "
            f"(the port ships no prebuilt library): {e}") from e
    os.replace(tmp, lib)
    htmp = f"{lib}.srchash.{os.getpid()}.tmp"
    with open(htmp, "w") as f:
        f.write(_src_hash())
    os.replace(htmp, lib + ".srchash")


def ensure_built() -> str:
    """Compile objstore.cc -> _build/libobjstore[.<san>].so if missing or
    stale, and return its path.

    Staleness is a CONTENT hash of the source, not mtimes: a fresh git
    checkout gives every file the same mtime.
    """
    mode = _san_mode()
    lib = _lib_path(mode)
    with _lock:
        want = _src_hash()
        have = None
        if os.path.exists(lib) and os.path.exists(lib + ".srchash"):
            try:
                with open(lib + ".srchash") as f:
                    have = f.read().strip()
            except OSError:
                pass
        if have != want:
            _compile_and_swap(mode)
    return lib


def rebuild() -> str:
    """Recompile for THIS host and swap in the result. Used when a
    cached library fails to LOAD (e.g. a build directory carried over
    from a host with a newer glibc) — the content hash can't catch that,
    only dlopen can."""
    mode = _san_mode()
    with _lock:
        _compile_and_swap(mode)
    return _lib_path(mode)
