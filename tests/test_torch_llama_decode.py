"""The port's dense-cache Llama forms against ray_tpu.models.llama.

Same weights (the reference's init, converted by params_from_numpy), same
numpy inputs; both run their plain paths on the CPU (the port's prefill
attention is the plain version of the flash op on CPU tensors).
Compared: apply_with_kv's logits and per-layer K/V, decode_batched's
logits, cache and lengths, and apply_decode's logits step by step.
Tolerance: float32, atol 2e-5 (rtol 1e-5) — XLA and PyTorch sum the same
f32 products in different orders; through two layers and the lm_head
that moves logits of magnitude ~3 by a few 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy

TOL = dict(rtol=1e-5, atol=2e-5)
SHAPE = dict(vocab_size=64, n_heads=4, n_kv_heads=2, dim=32, n_layers=2,
             mlp_dim=64, max_seq_len=128)


@pytest.fixture(scope="module")
def models():
    cfg_j = jllama.llama_tiny(**SHAPE)
    cfg_t = tllama.llama_tiny(**SHAPE)
    params_j = jllama.init(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), cfg_t,
                                 device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_with_kv_matches_reference(models):
    cfg_j, cfg_t, params_j, params_t = models
    tokens = np.random.RandomState(0).randint(0, 64, (2, 11)).astype(np.int32)
    lg_j, ks_j, vs_j = jllama.apply_with_kv(params_j, jnp.asarray(tokens),
                                            cfg_j)
    lg_t, ks_t, vs_t = tllama.apply_with_kv(params_t,
                                            torch.from_numpy(tokens), cfg_t)
    assert ks_t.shape == (2, 2, 11, 2, 8)
    _close(lg_t, lg_j)
    _close(ks_t, ks_j)
    _close(vs_t, vs_j)
    # the engine's one-position form: the same logits at `last`
    last, ks2, _ = tllama.prefill_with_kv(params_t, torch.from_numpy(tokens),
                                          6, cfg_t)
    _close(last, np.asarray(lg_j)[:, 6])
    assert torch.equal(ks2, ks_t)


def test_decode_batched_matches_reference(models):
    """Three slots at lengths 0, 5 and 9 over a cache seeded by a prefill
    (pad positions beyond each slot's length hold real K/V, as the
    engine's bucketed prefill leaves them); three steps, checking
    logits, the whole cache and the lengths after each."""
    cfg_j, cfg_t, params_j, params_t = models
    rng = np.random.RandomState(1)
    max_len = 16
    c_j = jllama.init_slot_cache(cfg_j, 3, max_len)
    c_t = tllama.init_slot_cache(cfg_t, 3, max_len, device="cpu")
    prompt = rng.randint(0, 64, (1, 12)).astype(np.int32)
    _, ks, vs = jllama.apply_with_kv(params_j, jnp.asarray(prompt), cfg_j)
    lengths = np.asarray([0, 5, 9], np.int32)
    for slot in (1, 2):
        c_j["k"] = c_j["k"].at[:, slot, :12].set(ks[:, 0])
        c_j["v"] = c_j["v"].at[:, slot, :12].set(vs[:, 0])
        c_t["k"][:, slot, :12] = torch.from_numpy(np.array(ks[:, 0]))
        c_t["v"][:, slot, :12] = torch.from_numpy(np.array(vs[:, 0]))
    c_j["lengths"] = jnp.asarray(lengths)
    c_t["lengths"] = torch.from_numpy(lengths.copy())
    for _ in range(3):
        tok = rng.randint(0, 64, (3, 1)).astype(np.int32)
        lg_j, c_j = jllama.decode_batched(params_j, jnp.asarray(tok), c_j,
                                          cfg_j)
        lg_t, c_t = tllama.decode_batched(params_t, torch.from_numpy(tok),
                                          c_t, cfg_t)
        _close(lg_t, lg_j)
        _close(c_t["k"], c_j["k"])
        _close(c_t["v"], c_j["v"])
        np.testing.assert_array_equal(c_t["lengths"].numpy(),
                                      np.asarray(c_j["lengths"]))
        assert c_t["lengths"].dtype == torch.int32


def test_apply_decode_matches_reference_and_full_forward(models):
    """Prefill 8 tokens through the cache, then decode one at a time
    (tests/test_models.py's pattern): each step's logits match the
    reference's, and the stitched logits match the full forward."""
    cfg_j, cfg_t, params_j, params_t = models
    b, s = 2, 12
    tokens = np.random.RandomState(2).randint(0, 64, (b, s)).astype(np.int32)
    c_j = jllama.init_kv_cache(cfg_j, b, max_len=32)
    c_t = tllama.init_kv_cache(cfg_t, b, max_len=32, device="cpu")
    steps = [(0, 8)] + [(i, i + 1) for i in range(8, s)]
    stitched = []
    for lo, hi in steps:
        lg_j, c_j = jllama.apply_decode(
            params_j, jnp.asarray(tokens[:, lo:hi]), c_j, cfg_j)
        lg_t, c_t = tllama.apply_decode(
            params_t, torch.from_numpy(tokens[:, lo:hi]), c_t, cfg_t)
        _close(lg_t, lg_j)
        assert c_t["idx"] == int(c_j["idx"]) == hi
        stitched.append(lg_t)
    _close(c_t["k"], c_j["k"])
    full = tllama.apply(params_t, torch.from_numpy(tokens), cfg_t)
    torch.testing.assert_close(torch.cat(stitched, dim=1), full, rtol=1e-5,
                               atol=2e-5)


def test_dense_cache_forms_raise_past_the_cache_end(models):
    """The reference clamps an out-of-range cache write; the port raises
    instead of writing somewhere else."""
    _, cfg_t, _, params_t = models
    cache = tllama.init_kv_cache(cfg_t, 1, max_len=4, device="cpu")
    with pytest.raises(IndexError):
        tllama.apply_decode(params_t, torch.zeros((1, 5), dtype=torch.int32),
                            cache, cfg_t)
