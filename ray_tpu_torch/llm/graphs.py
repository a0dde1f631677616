"""Captured programs: the paged engine's dispatch, one CUDA graph per
static key (counterpart of ``_family_jit`` and the ``_decode_win_fns`` /
``_prefill_rows_fns`` / ``_verify_fns`` program caches of
``ray_tpu/llm/paged_engine.py``).

The reference compiles one XLA program per (family, static key) and a
dispatch is one launch of it. On the card the port's program is a
``torch.cuda.CUDAGraph``: ``GraphCache.run(tag, body, arrays)`` looks up
the graph captured for ``tag`` (the family and its static key), copies
the dispatch's host arrays into that graph's static input buffer,
replays it, and reads its outputs back in one transfer.

- The first dispatch at a tag runs ``body`` once eagerly on a side
  stream (the warm run: its outputs are that dispatch's result), then
  captures ``body`` on the same side stream with
  ``capture_error_mode="thread_local"``, so threads that only queue
  requests (``LLMServer``'s callers) are never held to the capture's
  rules. Later dispatches replay.
- Inputs: every host array (int32 or float32) is a view of one int32
  device buffer per graph, filled from a pinned twin by one
  asynchronous copy. Outputs: the captured body ends by packing its
  outputs into one int32 tensor, read back by one copy that also waits
  for the replay.
- Every graph draws from one memory pool (``graph_pool_handle``):
  dispatches run one at a time, and each reads its outputs before the
  next replays, so a graph may reuse another's intermediates.
- B1 launches: a capture launches nothing, so the launches the wrapper
  counted while capturing are taken back and recorded, and every replay
  adds them to ``ragged_paged_attention.launches``.

There is no fallback: an error while capturing or replaying raises. On
the CPU nothing is captured: the engine runs ``body`` eagerly, as the
reference's jit runs on the CPU.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.ragged_paged_attention import ragged_paged_attention as _rpa

_ALIGN = 4          # int32 words per 16 bytes: each input starts aligned


def _pack(outs) -> torch.Tensor:
    """The int32 words of every output, concatenated (inside capture)."""
    return torch.cat([t.reshape(-1).view(torch.int32) for t in outs
                      if t is not None])


class _Program:
    """One captured dispatch: the static input buffer with its pinned
    host twin and per-input views, the graph, its packed output with the
    layout to unpack it, and the B1 launches one replay makes."""

    def __init__(self, arrays, device):
        self.offsets, n = [], 0
        for a in arrays:
            if a.dtype.itemsize != 4 or a.dtype.kind not in "if":
                raise TypeError(f"graph inputs are int32 or float32, got "
                                f"{a.dtype}")
            self.offsets.append(n)
            n += -(-a.size // _ALIGN) * _ALIGN
        self.host = torch.empty(n, dtype=torch.int32, pin_memory=True)
        self.host_np = self.host.numpy()
        self.flat = torch.zeros(n, dtype=torch.int32, device=device)
        self.args = []
        for a, o in zip(arrays, self.offsets):
            v = self.flat[o:o + a.size].view(a.shape)
            self.args.append(v.view(torch.float32)
                             if a.dtype == np.float32 else v)
        self.graph = torch.cuda.CUDAGraph()
        self.out = None
        self.layout = []            # (offset, shape, numpy dtype) or None
        self.launches = 0

    def load(self, arrays):
        for a, o in zip(arrays, self.offsets):
            self.host_np[o:o + a.size] = a.reshape(-1).view(np.int32)
        self.flat.copy_(self.host, non_blocking=True)

    def set_outputs(self, outs):
        self.out = _pack(outs)
        o = 0
        for t in outs:
            if t is None:
                self.layout.append(None)
                continue
            self.layout.append((o, tuple(t.shape),
                                np.float32 if t.dtype == torch.float32
                                else np.int32))
            o += t.numel()

    def read(self) -> list:
        words = self.out.cpu().numpy()
        res = []
        for spec in self.layout:
            if spec is None:
                res.append(None)
                continue
            o, shape, dt = spec
            n = int(np.prod(shape))
            res.append(words[o:o + n].view(dt).reshape(shape))
        return res


class GraphCache:
    """One captured program per (family, static key) on one card."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._programs: dict = {}
        self._side = torch.cuda.Stream(device=self.device)
        self._pool = None
        #: seconds each capture took, warm run included
        self.capture_s: list[float] = []

    def __len__(self) -> int:
        return len(self._programs)

    def __contains__(self, tag) -> bool:
        return tag in self._programs

    def run(self, tag, body, arrays) -> list:
        """Dispatch ``body(*device views of arrays)`` under ``tag``;
        returns its outputs as host arrays (None where body returned
        None). ``body`` must depend on nothing but its inputs, the
        tensors it closes over (weights, caches: never reallocated) and
        what ``tag`` fixes."""
        prog = self._programs.get(tag)
        if prog is None:
            return self._capture(tag, body, arrays)
        prog.load(arrays)
        prog.graph.replay()
        _rpa.launches += prog.launches
        return prog.read()

    def _capture(self, tag, body, arrays) -> list:
        t0 = time.perf_counter()
        prog = _Program(arrays, self.device)
        prog.load(arrays)
        cur = torch.cuda.current_stream(self.device)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            warm = body(*prog.args)
        cur.wait_stream(self._side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = _rpa.launches
        try:
            with torch.cuda.graph(prog.graph, pool=self._pool,
                                  stream=self._side,
                                  capture_error_mode="thread_local"):
                prog.set_outputs(body(*prog.args))
            prog.launches = _rpa.launches - before
        finally:
            _rpa.launches = before          # a capture launches nothing
        self._programs[tag] = prog
        result = [None if t is None else t.cpu().numpy() for t in warm]
        self.capture_s.append(time.perf_counter() - t0)
        return result
