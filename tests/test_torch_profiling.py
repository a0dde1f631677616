"""The port's step profiler against ray_tpu's, and the paged engine's
FLOPs estimate.

- One scripted sequence of steps, explicit compiles and FLOPs
  attachments on each package's StepProfiler, under one deterministic
  clock, books the same compile/execute counts and walls, executed
  tags and MFU (both given the same peak).
- On the CPU the peak is unknown, so MFU is None.
- With warmup off, every dispatch is one profiled step: per family,
  first dispatches at a key plus later ones equal the dispatch count,
  on both packages (each keys prefill by its own row count: the port
  dispatches the real rows, the reference pads to a power of two).
- estimate_flops runs dummy dispatches that write only sink page 0: the
  engine's counters, RNG position, profiler counts and every page from
  1 up are unchanged, and the counted FLOPs match the analytic count,
  2 x (matmul weights) x tokens plus the plain attention's two products
  over the bucket's keys, within 1%."""
import itertools
import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm import PagedEngineConfig as JaxConfig
from ray_tpu.llm import PagedInferenceEngine as JaxEngine
from ray_tpu.llm import SamplingParams as JaxSP
from ray_tpu.models import llama as jllama
from ray_tpu.util.profiling import StepProfiler as JaxStepProfiler
from ray_tpu_torch.llm import (PagedEngineConfig, PagedInferenceEngine,
                               SamplingParams)
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.util.profiling import (StepProfiler, compiled_flops,
                                          device_peak_flops, mfu, trace)

SHAPE = dict(vocab_size=258, max_seq_len=512)
ENGINE = dict(max_batch_size=3, page_size=8, num_pages=64,
              max_pages_per_seq=16, chunk_size=16, prefill_rows=2,
              decode_window=4, spec_tokens=4, page_buckets="on")


def _script(prof):
    m = (False, False, False)
    prof.record_compile(0.5, "prefill", (1, m, 4))
    for kind, key in [("prefill", (1, m, 4)), ("prefill", (2, m, 8)),
                      ("prefill", (2, m, 8)), ("decode", (4, m, 8)),
                      ("decode", (4, m, 8)), ("decode", (4, m, 8)),
                      ("decode", (1, m, 4)), ("verify", (3, 5, 8, False)),
                      ("verify", (3, 5, 8, False)), ("other", None)]:
        with prof.step(kind, key):
            pass
    prof.attach_flops("decode", 2.0e9, key=(4, m, 8))
    prof.attach_flops("prefill", 3.0e9, key=(2, m, 8))
    prof.attach_flops("verify", 1.0e9, key=(3, 5, 8, False))
    prof.attach_flops("decode", 0.5e9, key=(1, m, 4))    # never executed


def test_step_profiler_books_like_the_reference(monkeypatch):
    out = []
    for cls in (JaxStepProfiler, StepProfiler):
        ticks = itertools.count()
        # one clock for both: each perf_counter call advances 0.25 s
        monkeypatch.setattr(time, "perf_counter",
                            lambda: next(ticks) * 0.25)
        prof = cls("paged_engine")
        prof._peak = 1e12
        _script(prof)
        monkeypatch.undo()
        out.append((prof.summary(), prof.executed_tags()))
    (ref, ref_tags), (got, got_tags) = out
    assert got == ref
    assert got_tags == ref_tags
    assert got["compiles"] == 6 and got["steps"] == 5
    assert got["steps_by_kind"] == {"prefill": 2, "decode": 2,
                                    "verify": 1}
    # (2 decode x 2e9 + 1 prefill x 3e9 + 1 verify x 1e9) / (5 x 0.25 s)
    assert got["mfu"] == pytest.approx(8e9 / 1.25 / 1e12)


def test_cpu_has_no_peak_so_no_mfu():
    assert device_peak_flops("cpu") is None
    if not torch.cuda.is_available():
        assert device_peak_flops() is None
        assert mfu(1e9, 0.5) is None
    prof = StepProfiler("cpu", device="cpu")
    with prof.step("decode", 1):
        pass
    with prof.step("decode", 1):
        pass
    prof.attach_flops("decode", 1e9, key=1)
    s = prof.summary()
    assert s["peak_flops"] is None and s["mfu"] is None and s["steps"] == 1


def _pair():
    jax_eng = JaxEngine(JaxConfig(model=jllama.llama_tiny(**SHAPE), **ENGINE),
                        rng_seed=0)
    mc = tllama.llama_tiny(**SHAPE)
    params = params_from_numpy(jax.tree.map(np.asarray, jax_eng.params), mc,
                               device="cpu")
    port = PagedInferenceEngine(PagedEngineConfig(model=mc, **ENGINE),
                                params=params, device="cpu")
    return jax_eng, port


def _run(eng, sp_cls) -> list:
    """A mixed batch (prefill and decode), then one self-similar greedy
    prompt alone, which drives the speculative verify family."""
    rng = np.random.RandomState(5)
    mixed = [[int(t) for t in rng.randint(1, 250, n)] for n in (40, 9, 23)]
    out = eng.generate(mixed, sp_cls(max_tokens=12))
    out += eng.generate([[7, 8, 9] * 5], sp_cls(max_tokens=48))
    return [x["token_ids"] for x in out]


def _per_kind(prof) -> dict:
    """{kind: first dispatches at a key + later dispatches}."""
    out = {}
    for kind, _ in prof._seen:
        out[kind] = out.get(kind, 0) + 1
    for kind, n in prof.steps_by_kind.items():
        out[kind] = out.get(kind, 0) + n
    return out


def test_profiled_steps_equal_dispatches_on_both_packages():
    jax_eng, port = _pair()
    assert _run(port, SamplingParams) == _run(jax_eng, JaxSP)
    for eng in (jax_eng, port):
        st = eng.stats
        want = {"prefill": st["prefill_dispatches"],
                "decode": st["decode_dispatches"],
                "verify": st["spec_dispatches"]}
        assert _per_kind(eng.profiler) == {k: v for k, v in want.items()
                                           if v}
        s = eng.profile_summary()
        assert s["compiles"] + s["steps"] == sum(want.values())
        assert s["dispatches"] == {"prefill": want["prefill"],
                                   "decode": want["decode"],
                                   "spec": want["verify"]}
    assert port.stats["spec_dispatches"] > 0
    assert sum(_per_kind(port.profiler).values()) == \
        sum(_per_kind(jax_eng.profiler).values())


def _analytic_flops(mc, cfg, kind, key) -> int:
    """2 x matmul weights x tokens (+ the lm_head rows), plus the plain
    attention's two products over the key's whole table width."""
    dim, h, kvh, d = mc.dim, mc.n_heads, mc.n_kv_heads, mc.head_dim
    per_tok = 2 * (dim * h * d + 2 * dim * kvh * d + h * d * dim
                   + 3 * dim * mc.mlp_dim)
    head = 2 * dim * mc.vocab_size
    if kind == "decode":
        w, _, pages = key
        rows, q, steps, head_rows = cfg.max_batch_size, 1, w, \
            cfg.max_batch_size
    elif kind == "prefill":
        rows, _, pages = key
        q, steps, head_rows = cfg.chunk_size, 1, rows
    else:
        rows, q, pages, _ = key
        steps, head_rows = 1, rows * q
    keys = pages * cfg.page_size
    return steps * (mc.n_layers * (rows * q * per_tok
                                   + 4 * rows * h * q * keys * d)
                    + head * head_rows)


def test_estimate_flops_leaves_state_and_counts_the_model():
    _, port = _pair()
    _run(port, SamplingParams)
    before = {
        "stats": dict(port.stats), "rng": port._rng_ctr,
        "prof": {k: v for k, v in port.profile_summary().items()
                 if k in ("compiles", "steps", "steps_by_kind",
                          "compile_s", "execute_s")},
        "pages": [(layer["k"][1:].clone(), layer["v"][1:].clone())
                  for layer in port.caches],
        "pool": port.pool_stats()}
    est = port.estimate_flops()
    after_prof = {k: v for k, v in port.profile_summary().items()
                  if k in before["prof"]}
    assert port.stats == before["stats"]
    assert port._rng_ctr == before["rng"]
    assert after_prof == before["prof"]
    assert port.pool_stats() == before["pool"]
    for (k0, v0), layer in zip(before["pages"], port.caches):
        assert torch.equal(layer["k"][1:], k0)
        assert torch.equal(layer["v"][1:], v0)
    tags = port.profiler.executed_tags()
    assert {kind for kind, _ in tags} >= {"prefill", "decode"}
    assert {(kind, key) for kind, keys in est.items() for key in keys} == \
        set(tags)
    mc, cfg = port.cfg.model, port.cfg
    for kind, keys in est.items():
        for key, fl in keys.items():
            want = _analytic_flops(mc, cfg, kind, key)
            assert fl == pytest.approx(want, rel=0.01), (kind, key)
    # each verify key ran once here (its first dispatch), so none was
    # estimated above: count one directly
    key = (2, 5, 8, True)
    assert compiled_flops(*port._dispatch_for_key("verify", key)) == \
        pytest.approx(_analytic_flops(mc, cfg, "verify", key), rel=0.01)
    s = port.profile_summary()
    assert s["flops_per_step"] == {k: max(v.values())
                                   for k, v in est.items()}
    assert s["mfu"] is None          # the CPU has no peak


def test_trace_writes_a_profile_only_when_given_a_directory(tmp_path):
    with trace(None):
        torch.ones(4).sum()
    with trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    written = list(tmp_path.iterdir())
    assert len(written) == 1 and written[0].name.endswith(".json")
    assert "aten::mm" in written[0].read_text()
