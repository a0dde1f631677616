"""The port's counter-based sampling draw (``ray_tpu_torch/llm/engine.py``:
``root_key``, ``fold_in``, ``uniform``), the counterpart of
``jax.random.fold_in(fold_in(key, ctr), step)``.

The reference's threefry stream is not reproduced, so the draw is held
to its own contract: a pure function of (seed, counter, step, row,
vocab index); two engines with one seed draw the same tokens at one
counter; every (counter, step) draws anew; sampled frequencies follow
the softmax (chi-square, 15 degrees of freedom, at the 1e-6 tail: the
draws are seeded, so the statistic is one fixed number, and a bias of a
few percent in any bucket would exceed the bound); top-k never leaves
the k."""
import numpy as np
import pytest
import torch
from scipy import stats

from ray_tpu_torch.llm import PagedEngineConfig, PagedInferenceEngine
from ray_tpu_torch.llm.engine import (fold_in, root_key, sample_logits,
                                      sample_logits_batch, uniform)
from ray_tpu_torch.models import llama as tllama

SHAPE = dict(vocab_size=258, max_seq_len=256)


def _engine(seed):
    mc = tllama.llama_tiny(**SHAPE)
    cfg = PagedEngineConfig(model=mc, max_batch_size=3, page_size=8,
                            num_pages=32, max_pages_per_seq=8,
                            chunk_size=16, decode_window=4)
    return PagedInferenceEngine(cfg, tllama.init(mc, 0, device="cpu"),
                                rng_seed=seed, device="cpu")


def _window(eng, ctr):
    """One sampled decode window of 3 steps at counter ctr: zero tables,
    so every write lands on sink page 0."""
    eng._rng_ctr = ctr
    out, lps = eng._decode_window(
        3, (True, True, True), np.asarray([5, 9, 200], np.int32),
        np.zeros((3, 4), np.int32), np.asarray([2, 7, 0], np.int32),
        np.asarray([1.0, 0.8, 1.3], np.float32),
        np.asarray([0, 20, 0], np.int32))
    return out, lps


def test_same_seed_and_counter_give_the_same_tokens_on_two_engines():
    a, b, other = _engine(7), _engine(7), _engine(8)
    for ctr in (0, 3, 11):
        ta, la = _window(a, ctr)
        tb, lb = _window(b, ctr)
        assert np.array_equal(ta, tb) and np.array_equal(la, lb)
    # another seed draws other tokens at the same counters
    assert any(not np.array_equal(_window(a, c)[0], _window(other, c)[0])
               for c in range(4))
    # and the draw is a pure function: no state moved between the calls
    key = fold_in(fold_in(root_key(7, "cpu"), 3), 1)
    assert torch.equal(uniform(key, (3, 258)), uniform(key, (3, 258)))


def test_each_counter_and_step_draws_anew():
    base = root_key(0x5EED, "cpu")
    keys, draws = set(), set()
    for ctr in range(32):
        for step in range(8):
            key = fold_in(fold_in(base, ctr), step)
            keys.add(int(key))
            u = uniform(key, (4, 64))
            assert ((u > 0) & (u < 1)).all()
            draws.add(u.numpy().tobytes())
    assert len(keys) == len(draws) == 32 * 8
    # rows and vocab entries of one draw differ too
    u = uniform(fold_in(base, 1), (4, 64))
    assert len(set(u.reshape(-1).tolist())) > 250


@pytest.mark.parametrize("temp", [1.0, 0.7])
def test_sampled_frequencies_follow_the_softmax(temp):
    v, rows, ctrs = 16, 16, 500
    logits = torch.randn(1, v, generator=torch.Generator().manual_seed(3))
    batch = logits.expand(rows, v).contiguous()
    temps = torch.full((rows,), temp)
    top_ks = torch.zeros(rows, dtype=torch.int32)
    base = root_key(11, "cpu")
    counts = np.zeros(v)
    for ctr in range(ctrs):
        tok, _ = sample_logits_batch(batch, fold_in(fold_in(base, ctr), 0),
                                     temps, top_ks, want_logp=False)
        counts += np.bincount(tok.numpy(), minlength=v)
    p = torch.softmax(logits[0] / temp, -1).double().numpy()
    n = rows * ctrs
    chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
    assert chi2 < stats.chi2.ppf(1 - 1e-6, v - 1), (chi2, counts)


def test_top_k_never_leaves_the_k():
    v = 40
    logits = torch.randn(6, v, generator=torch.Generator().manual_seed(9))
    ks = [1, 2, 3, 5, 8, 0]
    temps = torch.tensor([1.5, 1.0, 2.0, 0.7, 1.2, 0.0])
    top_ks = torch.tensor(ks, dtype=torch.int32)
    allowed = [set(torch.topk(logits[r] / max(float(temps[r]), 1e-6),
                              k).indices.tolist()) if k else None
               for r, k in enumerate(ks)]
    base = root_key(2, "cpu")
    seen = [set() for _ in ks]
    for ctr in range(300):
        key = fold_in(fold_in(base, ctr), 0)
        tok, _ = sample_logits_batch(logits, key, temps, top_ks)
        for r, t in enumerate(tok.tolist()):
            if allowed[r] is not None:
                assert t in allowed[r]
            seen[r].add(t)
        one = sample_logits(logits[:1], key, 1.0, 3)
        assert int(one[0]) in set(torch.topk(logits[0], 3).indices.tolist())
    # the draws spread over each k (row 5 is greedy: one token)
    assert [len(s) for s in seen] == [1, 2, 3, 5, 8, 1]
