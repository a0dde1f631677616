"""Build the port's CUDA kernels from the sources in ``csrc/`` at first use.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``: no
PyTorch headers, so a build takes seconds. Libraries land in
``_build/<hash of the flags, the source and the csrc/ headers it
includes>/`` beside this file (listed in ``.gitignore``), so an edited
source or header rebuilds and an unchanged one is loaded as built. ``build_all()`` starts one ``nvcc`` per source at once
and waits for all of them.

Nothing here runs at import time: this module is imported on machines
that have no ``nvcc``, and only a call that needs a kernel builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from collections import deque

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

#: library name -> its source under csrc/
SOURCES = {
    "ragged_paged_attention": "ragged_paged_attention.cu",
    "flash_attention": "flash_attention.cu",
    "paged_attention": "paged_attention.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    or nvcc on PATH. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def _sources_of(name: str) -> list:
    """The source of library ``name`` and every file under csrc/ that it
    includes with ``#include "..."``, transitively, in first-seen order
    (system headers, in angle brackets, are not followed)."""
    todo, seen = deque([SOURCES[name]]), []
    while todo:
        rel = todo.popleft()
        if rel in seen:
            continue
        seen.append(rel)
        with open(os.path.join(CSRC, rel)) as f:
            text = f.read()
        todo += [inc for inc in _INCLUDE.findall(text)
                 if os.path.isfile(os.path.join(CSRC, inc))]
    return seen


def _lib_path(name: str) -> str:
    """Where library ``name`` is built: keyed by the nvcc flags and the
    bytes of its source and of every csrc/ header it includes, so an
    edited header rebuilds each library that includes it."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for rel in _sources_of(name):
        with open(os.path.join(CSRC, rel), "rb") as f:
            digest.update(rel.encode() + b"\0" + f.read() + b"\0")
    return os.path.join(BUILD_DIR, digest.hexdigest()[:16], f"lib{name}.so")


def _start(name: str):
    """Start nvcc for one library; None when it is already built."""
    out = _lib_path(name)
    if os.path.isfile(out):
        return None
    os.makedirs(os.path.dirname(out), exist_ok=True)
    # build under a private name, then rename: a process that loads the
    # library never sees a half-written file
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started, t0: float) -> dict:
    """Wait for a build _start began; returns {"seconds": wall time since
    t0 (0.0 when it was already built), "log": nvcc's output, with
    ptxas's register/shared-memory report (kept beside the library, so
    an earlier build's log is returned too)}."""
    if started is None:
        log_path = _lib_path(name) + ".log"
        log = ""
        if os.path.isfile(log_path):
            with open(log_path) as f:
                log = f.read()
        return {"seconds": 0.0, "log": log}
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{log}")
    with open(f"{tmp}.log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.log", out + ".log")
    os.replace(tmp, out)
    return {"seconds": time.perf_counter() - t0, "log": log}


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def ptxas_kernels(log: str) -> dict:
    """ptxas's -v report per kernel: {mangled name: {"registers",
    "spill_stores", "spill_loads", "stack", "static_smem"}} (bytes; the
    kernels' dynamic shared memory is not in the report)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            cur["static_smem"] = int(s.group(1)) if s else 0
    return out


def build_all() -> dict:
    """Compile every kernel library that is not built yet, one nvcc per
    source, all started together. Returns {name: _finish's record}."""
    with _lock:
        t0 = time.perf_counter()
        started = {n: _start(n) for n in SOURCES}
        return {n: _finish(n, s, t0) for n, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            t0 = time.perf_counter()
            _finish(name, _start(name), t0)
            lib = ctypes.CDLL(_lib_path(name))
            _bind(name, lib)
            _loaded[name] = lib
    return lib


def _bind(name: str, lib: ctypes.CDLL):
    """Declare argtypes/restype: pointers and the stream as c_void_p (a
    bare Python int would be passed as a 32-bit int and cut)."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "ragged_paged_attention":
        # dtype, q, k_pages, v_pages, block_tables, starts, q_lens, part_o,
        # part_ml, out, R, Q, H, KVH, D, page, max_pages, n_splits,
        # split_pages, warps, scale, stream
        lib.rpa_forward.argtypes = [I, P, P, P, P, P, P, P, P, P,
                                    I, I, I, I, I, I, I, I, I, I, F, P]
        lib.rpa_forward.restype = I
        # dtype, warps per bf16 pass-1 block, D -> dynamic smem bytes
        lib.rpa_smem_bytes.argtypes = [I, I, I]
        lib.rpa_smem_bytes.restype = I
    elif name == "flash_attention":
        # dtype, q, k, v, then the outputs / backward operands, then
        # B, Sq, Sk, H, KVH, D, causal, scale, stream
        sizes = [I, I, I, I, I, I, I, F, P]
        lib.flash_fwd.argtypes = [I, P, P, P, P, P] + sizes
        lib.flash_dq.argtypes = [I, P, P, P, P, P, P, P] + sizes
        lib.flash_dkv.argtypes = [I, P, P, P, P, P, P, P, P] + sizes
        for fn in (lib.flash_fwd, lib.flash_dq, lib.flash_dkv):
            fn.restype = I
        # kernel (0 forward, 1 dq, 2 dkv), dtype, D -> dynamic smem bytes
        lib.flash_smem_bytes.argtypes = [I, I, I]
        lib.flash_smem_bytes.restype = I
    elif name == "paged_attention":
        # dtype, q, k_pages, v_pages, block_table, lengths, part_o,
        # part_ml, counters, out, B, H, KVH, D, page, max_pages, n_splits,
        # split_pages, scale, stream
        lib.pda_forward.argtypes = [I, P, P, P, P, P, P, P, P, P,
                                    I, I, I, I, I, I, I, I, F, P]
        lib.pda_forward.restype = I
        # dtype, D -> dynamic smem bytes
        lib.pda_smem_bytes.argtypes = [I, I]
        lib.pda_smem_bytes.restype = I
