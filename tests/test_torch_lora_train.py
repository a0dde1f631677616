"""The port's LoRA trainer against ray_tpu's, on the same weights.

The reference's tiny config and seeded init (converted with
``models/convert.params_from_numpy``), f32 on the CPU, the reference's
``_teach`` objective (4 x 16 random inputs, every target one token),
lr 0.1, rank 4, alpha 8, targets ``("wq", "wv", "lm_head")``.

One step from a shared state (the reference's state after 0 and after 3
steps, given to the port's ``_run_loop``) matches the reference's next
state: loss within 1e-5, factors and both Adam moments within 1e-5 abs
+ 1e-4 rel, ``count`` exact (measured: 1e-6 on the factors, 3e-7 on the
moments). Whole 25-step runs from the same initial factors do not stay
that close: measured, the losses agree within 5e-5 over the first 10
steps, then the gap grows about 2x per step (1e-2 by step 20, 0.3-2.2
at step 25; factors 0.27 apart). Nothing but f32 summation order
separates the two (XLA's and PyTorch's sums of the same products);
Adam's update m̂/√v̂ is lr-sized whatever the gradient's size, and at
lr 0.1 the training is chaotic (the loss swings between 0.01 and 13
step to step in both packages), so the rounding gap grows
exponentially. ``test_whole_runs_agree_until_the_drift`` holds the
first 10 steps at 1e-4 and reports the rest.

So the port's counterpart of ``test_e2e_train_publish_serve_hot_swap``
trains in lockstep with the reference: each of the 25 steps of each
adapter runs on the port from the reference's state before it and is
held to the one-step tolerance; the last goes through
``LoRATrainer.fit()``'s resume path from a checkpoint, and the adapter
it returns is published and served. The mixed batch then gives the
reference's own run's tokens for the base and both tenants, and the
hot swap the reference's in-flight and new tokens. The port's own free
run (its own init, no reference) is held to its merged engine's tokens
and to falling losses. The reference's ``count(7) >= 6`` is not held:
the reference's own run gives tenant-a 2 sevens.

Runtimes (substrate mode, Serve) use ``init(num_cpus=2)``; remote code
is defined inside test bodies (pickled by value)."""
import os
import socket

import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm import SamplingParams as JaxSamplingParams
from ray_tpu.llm.multilora import AdapterRegistry as JaxRegistry
from ray_tpu.llm.multilora import LoRATrainConfig as JaxTrainConfig
from ray_tpu.llm.multilora import LoRATrainer as JaxTrainer
from ray_tpu.llm.multilora import MultiLoraManager as JaxManager
from ray_tpu.llm.multilora import train as jtrain
from ray_tpu.llm.paged_engine import PagedEngineConfig as JaxEngineConfig
from ray_tpu.llm.paged_engine import PagedInferenceEngine as JaxEngine
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import (PagedEngineConfig, PagedInferenceEngine,
                               SamplingParams, lora)
from ray_tpu_torch.llm.multilora import (AdapterRegistry, LoRATrainConfig,
                                         LoRATrainer, MultiLoraManager)
from ray_tpu_torch.llm.multilora import train as ttrain
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager

SHAPE = dict(n_layers=2, dim=64, mlp_dim=128, n_heads=4, n_kv_heads=2,
             max_seq_len=256)
ECFG = dict(max_batch_size=4, page_size=8, num_pages=128,
            max_pages_per_seq=16, chunk_size=16)
TCFG = dict(rank=4, alpha=8.0, targets=("wq", "wv", "lm_head"), steps=25,
            learning_rate=0.1, checkpoint_every=25)
STEP_TOL = dict(atol=1e-5, rtol=1e-4)
# (seed, taught token) of tenant-a, tenant-b and tenant-a's v2
TENANTS = ((1, 7), (2, 13), (3, 21))


def _teach(cfg, tok):
    """The reference's fine-tune objective: always emit ``tok``."""
    def data_fn(step):
        rng = np.random.RandomState(1000 + step)
        toks = rng.randint(1, cfg.vocab_size, (4, 17)).astype(np.int32)
        return toks[:, :16], np.full((4, 16), tok, np.int32)
    return data_fn


@pytest.fixture(scope="module")
def base():
    """(reference cfg, reference params, port cfg, port params)."""
    jcfg = jllama.llama_tiny(**SHAPE)
    jp = jllama.init(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.llama_tiny(**SHAPE)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _ref_states(jcfg, jp, seed, tok, steps, **kw):
    """The reference's states after 0..steps steps (state 0: its init)."""
    cfg = JaxTrainConfig(model=jcfg, **dict(TCFG, seed=seed, steps=steps,
                                            checkpoint_every=1, **kw))
    states, losses = [], []
    jtrain._run_loop(JaxTrainConfig(**dict(vars(cfg), steps=0)), jp, None,
                     None, lambda s, loss, st: states.append(st))
    jtrain._run_loop(cfg, jp, _teach(jcfg, tok), None,
                     lambda s, loss, st: (states.append(st),
                                          losses.append(loss)))
    return states, losses


def _port_step(tcfg, tp, seed, tok, state, **kw):
    """One port step from ``state``: (next state, loss)."""
    n = int(state["step"])
    out = []
    st = ttrain._run_loop(
        LoRATrainConfig(model=tcfg, **dict(TCFG, seed=seed, steps=n + 1,
                                           checkpoint_every=1, **kw)),
        tp, _teach(tcfg, tok), state, lambda s, loss, x: out.append(loss))
    return st, out[-1]


def _assert_factors_close(got, want, label):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   err_msg=f"{label} {k}", **STEP_TOL)


def _assert_state_close(got, want, label):
    assert int(got["step"]) == int(want["step"]), label
    _assert_factors_close(got["adapter"], want["adapter"], label)
    g, w = got["opt_leaves"], want["opt_leaves"]
    assert len(g) == len(w)
    assert np.asarray(g[0]).dtype == np.int32
    assert int(np.asarray(g[0])) == int(np.asarray(w[0])), label
    for i, (a, b) in enumerate(zip(g[1:], w[1:]), start=1):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   err_msg=f"{label} opt leaf {i}",
                                   **STEP_TOL)


def _write_state(storage, adapter_id, state):
    """``state`` as the latest checkpoint of the port's local mode under
    ``storage`` (what a crashed earlier run would have left)."""
    mgr = CheckpointManager(os.path.join(storage, adapter_id,
                                         "checkpoints"), num_to_keep=2)
    mgr.scan_existing()
    step = int(state["step"])
    mgr.register(Checkpoint.from_state(state, metadata={"step": step}),
                 {"step": step})


# ------------------------------------------------------------------ #
# merge, init, one step
# ------------------------------------------------------------------ #

def test_merge_takes_factors_as_tensors_with_grad(base):
    _jcfg, _jp, tcfg, tp = base
    ad = lora.random_adapter(3, tcfg, rank=4, alpha=8.0,
                             targets=("wq", "wv", "lm_head"))
    as_np = lora.merge(tp, ad)
    facs = {k: torch.tensor(v, requires_grad=True)
            for k, v in ad.items() if k.endswith((".A", ".B"))}
    as_t = lora.merge(tp, {**ad, **facs})
    for name in ("wq", "wv"):
        assert torch.equal(as_t["layers"][name], as_np["layers"][name])
    assert torch.equal(as_t["lm_head"], as_np["lm_head"])
    assert as_t["layers"]["wq"].device == tp["layers"]["wq"].device
    # d sum(W') / dB = s * A^T 1
    as_t["lm_head"].sum().backward()
    want = 2.0 * facs["lm_head.A"].detach().sum(0)[:, None].expand(
        -1, tcfg.vocab_size)
    torch.testing.assert_close(facs["lm_head.B"].grad, want)
    assert facs["wq.A"].grad is None       # wq' took no part in the sum


def test_init_adapter_is_seeded_with_b_zero(base):
    _jcfg, _jp, tcfg, _tp = base
    mk = lambda seed: ttrain._init_adapter(LoRATrainConfig(  # noqa: E731
        model=tcfg, **dict(TCFG, seed=seed)))
    a, again, b = mk(1), mk(1), mk(2)
    assert sorted(a) == ["lm_head.A", "lm_head.B", "wq.A", "wq.B", "wv.A",
                         "wv.B"]
    for k in a:
        assert a[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], again[k])
        if k.endswith(".B"):
            assert not a[k].any()
        else:
            assert not np.array_equal(a[k], b[k])
    assert a["wq.A"].shape == (2, 64, 4) and a["wq.B"].shape == (2, 4, 64)
    assert a["lm_head.A"].shape == (64, 4) and a["lm_head.B"].shape == (4, 256)
    draws = np.concatenate([a[k].ravel() for k in a if k.endswith(".A")])
    # std 0.02 within sampling error (n = 1280: a relative 2% of sd)
    assert abs(draws.std() - 0.02) < 0.02 * 0.08
    assert abs(draws.mean()) < 4 * 0.02 / np.sqrt(draws.size)


@pytest.mark.parametrize("start", [0, 3])
def test_one_step_from_a_shared_state(base, start):
    jcfg, jp, tcfg, tp = base
    states, losses = _ref_states(jcfg, jp, 1, 7, start + 1)
    got, loss = _port_step(tcfg, tp, 1, 7, states[start])
    assert abs(loss - losses[start]) <= 1e-5
    _assert_state_close(got, states[start + 1], f"step {start + 1}")


def test_states_resume_across_packages(base):
    """The port's state after 3 steps (numpy, and as the CPU tensors its
    checkpoint loads) resumes in the reference, and the reference's in
    the port, to the same next state within the one-step tolerance."""
    jcfg, jp, tcfg, tp = base
    st3 = None
    for _ in range(3):
        st3, _ = _port_step(tcfg, tp, 2, 13, st3 if st3 is not None else
                            ttrain._run_loop(
                                LoRATrainConfig(model=tcfg, **dict(
                                    TCFG, seed=2, steps=0)),
                                tp, None, None, lambda *a: None))
    port4, _ = _port_step(tcfg, tp, 2, 13, st3)
    loaded = Checkpoint.from_state(st3).load_state()
    for state in (st3, loaded):
        ref4 = jtrain._run_loop(
            JaxTrainConfig(model=jcfg, **dict(TCFG, seed=2, steps=4)), jp,
            _teach(jcfg, 13), state, lambda *a: None)
        _assert_state_close(port4, ref4, "reference from the port's")


# ------------------------------------------------------------------ #
# whole runs
# ------------------------------------------------------------------ #

def test_whole_runs_agree_until_the_drift(base, tmp_path):
    """25 steps of the reference's loop (what its ``fit()`` runs) and of
    the port's ``fit()``, resumed from a step-0 checkpoint holding the
    reference's init, for each tenant: the losses of the first 10 steps
    agree within 1e-4 (measured <= 5e-5); later steps drift apart as the
    module docstring sets out (measured 0.07-2.2 at step 25)."""
    jcfg, jp, tcfg, tp = base
    for seed, tok in TENANTS:
        states, ref_losses = _ref_states(jcfg, jp, seed, tok, 25)
        storage = str(tmp_path / f"run{seed}")
        _write_state(storage, "w", states[0])
        port = LoRATrainer(
            LoRATrainConfig(model=tcfg, **dict(TCFG, seed=seed,
                                               checkpoint_every=1)),
            "w", base_params=tp, data_fn=_teach(tcfg, tok),
            storage_path=storage)
        port.fit()
        assert len(port.losses) == 25 and all(np.isfinite(port.losses))
        np.testing.assert_allclose(port.losses[:10], ref_losses[:10],
                                   atol=1e-4, rtol=0)


# ------------------------------------------------------------------ #
# train -> publish -> serve -> hot swap, in process
# ------------------------------------------------------------------ #

def _engine(Engine, Config, cfg, params, **kw):
    extra = {"device": "cpu"} if Engine is PagedInferenceEngine else {}
    return Engine(Config(model=cfg, **ECFG, **kw), params=params, **extra)


def _run(eng, reqs):
    while not all(r.done for r in reqs):
        eng.step()


def _solo(params, cfg, prompt, sp):
    eng = _engine(PagedInferenceEngine, PagedEngineConfig, cfg, params)
    req = eng.submit(prompt, sp)
    _run(eng, [req])
    return list(req.out_ids)


def _loop(pkg, trained, cfg, params):
    """The reference test's serving sequence in ``pkg`` ("jax" or
    "torch"): tenant-a and tenant-b published, a mixed batch of base and
    both tenants, then tenant-a's v2 published mid-stream. ``trained(i)``
    trains the i-th of TENANTS and returns its trainer (not yet
    published). Returns every request's tokens, the versions, the
    adapters and the manager's slots."""
    if pkg == "jax":
        Reg, Mgr, Eng, Cfg, SP = (JaxRegistry, JaxManager, JaxEngine,
                                  JaxEngineConfig, JaxSamplingParams)
    else:
        Reg, Mgr, Eng, Cfg, SP = (AdapterRegistry, MultiLoraManager,
                                  PagedInferenceEngine, PagedEngineConfig,
                                  SamplingParams)
    reg = Reg(f"t-e2e-{pkg}")
    tr_a, tr_b = trained(0, reg), trained(1, reg)
    out = {"adapters": [tr_a.adapter, tr_b.adapter],
           "versions": [tr_a.publish(), tr_b.publish()]}
    eng = _engine(Eng, Cfg, cfg, params, max_adapters=4, lora_rank=8)
    mgr = Mgr(eng, reg, refresh_s=0.0)
    sa, va, salt_a = mgr.resolve("tenant-a")
    sb, _vb, salt_b = mgr.resolve("tenant-b")
    prompt = list(np.random.RandomState(0).randint(1, 250, (12,)))
    sp = SP(max_tokens=8)
    r0 = eng.submit(prompt, sp)
    ra = eng.submit(prompt, sp, adapter_slot=sa, prefix_salt=salt_a)
    rb = eng.submit(prompt, sp, adapter_slot=sb, prefix_salt=salt_b)
    _run(eng, [r0, ra, rb])
    inflight = eng.submit(prompt, SP(max_tokens=24), adapter_slot=sa,
                          prefix_salt=salt_a)
    for _ in range(2):
        eng.step()
    tr_a2 = trained(2, reg)
    out["adapters"].append(tr_a2.adapter)
    out["versions"].append(tr_a2.publish())
    sa2, va2, salt_a2 = mgr.resolve("tenant-a")
    r_new = eng.submit(prompt, sp, adapter_slot=sa2, prefix_salt=salt_a2)
    _run(eng, [inflight, r_new])
    out.update({
        "prompt": prompt, "swap": (va2 - va, sa2 != sa),
        "done": inflight.done and r_new.done,
        **{k: list(r.out_ids) for k, r in (
            ("base", r0), ("a", ra), ("b", rb), ("inflight", inflight),
            ("new", r_new))}})
    return out


def test_e2e_train_publish_serve_hot_swap(base, tmp_path):
    """The reference's acceptance loop on both packages: the port's
    adapters are trained in lockstep with the reference's (module
    docstring): 24 steps of each from the reference's states, and the
    25th through ``LoRATrainer.fit()`` resuming a checkpoint of the
    reference's state 24. Each step's loss is held within 1e-5 and its
    factors within the one-step tolerance (measured: 4e-6 and 9e-6 at
    worst over the 75 steps). The moments are held to that tolerance in
    the one-step tests; here they are not: measured, 74 of the 75 steps
    meet it, and at tenant-a's step 21 (loss 5.56 after 1.42) 6 of the
    512 entries of wq.A's first moment are 2.7e-5 apart (rel 5e-3), a
    gradient that large steps make ~3e-4 apart in f32."""
    jcfg, jp, tcfg, tp = base

    def ref_trained(i, reg):
        seed, tok = TENANTS[i]
        tr = JaxTrainer(JaxTrainConfig(model=jcfg, **dict(TCFG, seed=seed)),
                        "tenant-a" if i != 1 else "tenant-b",
                        base_params=jp, data_fn=_teach(jcfg, tok),
                        registry=reg)
        tr.fit()
        return tr

    def port_trained(i, reg):
        seed, tok = TENANTS[i]
        states, losses = _ref_states(jcfg, jp, seed, tok, 25)
        for n in range(24):
            got, loss = _port_step(tcfg, tp, seed, tok, states[n])
            assert abs(loss - losses[n]) <= 1e-5, (i, n)
            _assert_factors_close(got["adapter"], states[n + 1]["adapter"],
                                  f"{i}: step {n + 1}")
        storage = str(tmp_path / f"lockstep{i}")
        name = "tenant-a" if i != 1 else "tenant-b"
        _write_state(storage, name, states[24])
        tr = LoRATrainer(LoRATrainConfig(model=tcfg, **dict(TCFG,
                                                            seed=seed)),
                         name, base_params=tp, data_fn=_teach(tcfg, tok),
                         storage_path=storage, registry=reg)
        tr.fit()
        assert len(tr.losses) == 1     # resumed at step 24: one step
        assert abs(tr.losses[0] - losses[24]) <= 1e-5
        _assert_factors_close(tr.adapter, states[25]["adapter"], f"{i}: fit")
        return tr

    ref = _loop("jax", ref_trained, jcfg, jp)
    port = _loop("torch", port_trained, tcfg, tp)
    assert port["versions"] == ref["versions"] == [0, 0, 1]
    assert port["swap"] == ref["swap"] == (1, True)
    assert port["done"] and ref["done"]               # zero drops
    for k in ("base", "a", "b", "inflight", "new"):
        assert port[k] == ref[k], (k, port[k], ref[k])
    assert port["a"] != port["base"] and port["b"] != port["a"]
    # bit-level loop closure: the served tokens ARE the merged model's
    sp = SamplingParams(max_tokens=8)
    for ad, key in zip(port["adapters"], ("a", "b", "new")):
        assert port[key] == _solo(lora.merge(tp, ad), tcfg, port["prompt"],
                                  sp), key
    # in flight across the swap: tenant-a's v1 throughout
    assert port["inflight"] == _solo(lora.merge(tp, port["adapters"][0]),
                                     tcfg, port["prompt"],
                                     SamplingParams(max_tokens=24))


def test_free_run_serves_its_merged_model(base):
    """The port's own run (its own init, no reference): every loss
    finite, the last ten below the first on average (the taught token
    took, under lr 0.1's swings), and a mixed batch's tenant row equal
    to its merged engine's tokens and apart from the base row."""
    _jcfg, _jp, tcfg, tp = base
    reg = AdapterRegistry("t-free")
    tr = LoRATrainer(LoRATrainConfig(model=tcfg, **dict(
        TCFG, seed=1, checkpoint_every=1)), "tenant-a", base_params=tp,
        data_fn=_teach(tcfg, 7), registry=reg)
    ad = tr.fit()
    assert len(tr.losses) == 25 and all(np.isfinite(tr.losses))
    assert np.mean(tr.losses[-10:]) < tr.losses[0], tr.losses
    assert tr.publish() == 0
    eng = _engine(PagedInferenceEngine, PagedEngineConfig, tcfg, tp,
                  max_adapters=4, lora_rank=8)
    slot, _v, salt = MultiLoraManager(eng, reg,
                                      refresh_s=0.0).resolve("tenant-a")
    prompt = list(np.random.RandomState(0).randint(1, 250, (12,)))
    sp = SamplingParams(max_tokens=8)
    r0 = eng.submit(prompt, sp)
    ra = eng.submit(prompt, sp, adapter_slot=slot, prefix_salt=salt)
    _run(eng, [r0, ra])
    assert list(ra.out_ids) == _solo(lora.merge(tp, ad), tcfg, prompt, sp)
    assert list(r0.out_ids) == _solo(tp, tcfg, prompt, sp)
    assert ra.out_ids != r0.out_ids


def test_lora_trainer_checkpoint_resume(base, tmp_path):
    """A second trainer pointed at the same storage resumes from the
    latest checkpoint, and a fresh run of as many steps gives the same
    adapter bit for bit (the reference's test on the port)."""
    _jcfg, _jp, tcfg, tp = base
    mk = lambda steps: LoRATrainConfig(   # noqa: E731
        model=tcfg, rank=2, alpha=8.0, targets=("wq",), steps=steps,
        learning_rate=0.05, checkpoint_every=5, seed=4)
    a5 = LoRATrainer(mk(5), "r", base_params=tp,
                     storage_path=str(tmp_path)).fit()
    t2 = LoRATrainer(mk(10), "r", base_params=tp, storage_path=str(tmp_path))
    a10 = t2.fit()
    assert len(t2.losses) == 1           # one report: step 10
    assert not np.allclose(a5["wq.B"], a10["wq.B"])   # kept training
    a10_fresh = LoRATrainer(mk(10), "r2", base_params=tp).fit()
    for k in ("wq.A", "wq.B"):
        np.testing.assert_array_equal(a10[k], a10_fresh[k])
    assert a10["rank"] == 2 and a10["alpha"] == np.float32(8.0)


# ------------------------------------------------------------------ #
# substrate mode on the port's runtime
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module")
def rt():
    import ray_tpu_torch
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _cfg20(tcfg, seed=1):
    return LoRATrainConfig(model=tcfg, **dict(TCFG, steps=20,
                                              checkpoint_every=10, seed=seed))


def test_substrate_mode_equals_local_mode(rt, base, tmp_path):
    from ray_tpu_torch import train
    _jcfg, _jp, tcfg, tp = base
    local = LoRATrainer(_cfg20(tcfg), "a", base_params=tp,
                        data_fn=_teach(tcfg, 7))
    want = local.fit()
    marker = str(tmp_path / "crashed_once")
    teach = _teach(tcfg, 7)

    def crash_once(step):
        # after the step-10 checkpoint, once: the gang restarts from it
        if step == 10 and not os.path.exists(marker):
            open(marker, "w").close()
            raise RuntimeError("planned crash after step 10's checkpoint")
        return teach(step)

    for name, fn, failures in (("plain", teach, 0),
                               ("crash", crash_once, 1)):
        sub = LoRATrainer(
            _cfg20(tcfg), "a", base_params=tp, data_fn=fn,
            scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(
                name=name, storage_path=str(tmp_path),
                failure_config=train.FailureConfig(max_failures=failures)))
        got = sub.fit()
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=name)
        assert sub.last_loss == local.last_loss
        assert sub.base_blob_bytes > 0 and sub.base_pickle_s >= 0
    assert os.path.exists(marker)
    assert sub.losses[-1] == local.losses[-1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_substrate_train_publish_serve_hot_swap(rt, tmp_path):
    """The reference's production-shaped loop on the port's runtime:
    LoRATrainer on the Train gang, publish into the runtime's registry,
    a Serve replica resolves the adapter live, a v1 publish hot-swaps it
    without redeploy. Each served text equals the text of the port's
    in-process server over that version's merged weights. The model is
    the tiny config with a 258-token vocabulary and the port's own seeded
    weights: the byte tokenizer's BOS is id 256 (the reference's gather
    clamps it into a 256-row table; the port's indexing raises)."""
    import time

    from ray_tpu_torch import serve, train
    from ray_tpu_torch.llm.serving import (LLMConfig, LLMServer,
                                           build_llm_deployment)
    tcfg = tllama.llama_tiny(**SHAPE, vocab_size=258)
    tp = tllama.init(tcfg, seed=0, device="cpu")
    body = {"prompt": "hello world", "max_tokens": 8}

    def merged_text(adapter):
        srv = LLMServer(LLMConfig(model_id="tiny", warmup=False,
                                  engine=PagedEngineConfig(model=tcfg,
                                                           **ECFG)),
                        params_ref=lora.merge(tp, adapter), device="cpu")
        try:
            return srv.completions(dict(body))["choices"][0]["text"]
        finally:
            srv._stop = True
            srv._wake.set()

    try:
        reg = AdapterRegistry("tiny")
        econf = PagedEngineConfig(model=tcfg, max_adapters=4, lora_rank=8,
                                  **ECFG)
        h = serve.run(build_llm_deployment(
            LLMConfig(model_id="tiny", engine=econf, warmup=False,
                      lora_namespace="tiny"), params_ref=tp, device="cpu"),
            name="mlora", http_port=_free_port())
        trainer = LoRATrainer(
            _cfg20(tcfg), "tenant-a", base_params=tp,
            data_fn=_teach(tcfg, 7), registry=reg,
            scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(storage_path=str(tmp_path)))
        ad0 = trainer.fit()
        assert trainer.publish() == 0

        def served(model):
            return h.options(method_name="completions").remote(
                dict(body, model=model)).result(timeout_s=300)

        text_v0 = served("tiny:tenant-a")["choices"][0]["text"]
        assert text_v0 == merged_text(ad0)
        tr2 = LoRATrainer(_cfg20(tcfg, seed=2), "tenant-a", base_params=tp,
                          data_fn=_teach(tcfg, 13), registry=reg)
        ad1 = tr2.fit()
        assert tr2.publish() == 1
        time.sleep(0.6)                  # > cfg.llm_lora_refresh_s
        text_v1 = served("tiny:tenant-a")["choices"][0]["text"]
        assert text_v1 == merged_text(ad1)
        assert text_v1 != text_v0
        outb = h.options(method_name="completions").remote(
            dict(body, model="tiny", max_tokens=4)).result(timeout_s=300)
        assert outb["object"] == "text_completion"
    finally:
        serve.shutdown()
