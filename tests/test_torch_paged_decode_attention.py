"""The port's decode-only paged attention against the reference package.

ray_tpu_torch.ops.paged_attention.paged_decode_attention on CPU tensors
(its plain version) is held against ray_tpu's Pallas
``paged_decode_attention`` run in interpret mode and against the
reference's plain decode version, on the same numpy inputs.

Tolerances:
- float32: atol 2e-5. Both sides compute the same softmax in f32 with
  sums in different orders (the Pallas kernel streams page by page),
  which moves results by a few ulps of values of order 1.
- bfloat16: |port - reference| <= 1e-2 + 2^-7 |reference|. Both compute
  in f32 from the same bf16 inputs and round the output to bf16 (one
  bf16 ulp is at most 2^-7 of the value), and the Pallas kernel also
  rounds the unnormalised p to bf16 before p.V, which the plain version
  does not: a relative error of at most 2^-8 per weight, averaged over
  the row, that stays well inside the 1e-2 floor for outputs near 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.paged_attention import \
    paged_decode_attention as jax_paged_decode_attention
from ray_tpu.ops.paged_attention import \
    paged_decode_reference as jax_paged_decode_reference
from ray_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_reference,
)
from ray_tpu_torch.ops.ragged_paged_attention import ragged_decode_attention

F32_ATOL = 2e-5
BF16_TOL = (1e-2, 2 ** -7)


def _case(groups, page, seed=0, poison=False):
    """Rows of length 0, 1, a page boundary, a mid-page tail, and the full
    table; disjoint live pages per row, and (with ``poison``) every table
    entry past a row's live page count naming an all-NaN page."""
    rng = np.random.RandomState(seed)
    kvh, d, maxp = 2, 64, 5
    h = kvh * groups
    lengths = np.asarray([0, 1, page, 2 * page + 3, maxp * page], np.int32)
    n_live = -(-lengths // page)
    P = int(n_live.sum()) + 2
    dead = P - 1
    ids = iter(rng.permutation(np.arange(1, P - 1)))
    bt = np.full((len(lengths), maxp), dead if poison else 0, np.int32)
    for r, n in enumerate(n_live):
        bt[r, :n] = [next(ids) for _ in range(n)]
    q = rng.randn(len(lengths), h, d).astype(np.float32)
    kp = rng.randn(P, page, kvh, d).astype(np.float32)
    vp = rng.randn(P, page, kvh, d).astype(np.float32)
    if poison:
        kp[dead] = np.nan
        vp[dead] = np.nan
    return q, kp, vp, bt, lengths


def _t(*arrays, dtype=torch.float32):
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        out.append(t.to(dtype) if t.is_floating_point() else t)
    return out


def _jax_kernel(q, kp, vp, bt, lengths, dtype=jnp.float32):
    return np.asarray(jax_paged_decode_attention(
        jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
        jnp.asarray(vp, dtype), jnp.asarray(bt), jnp.asarray(lengths),
        interpret=True).astype(jnp.float32))


@pytest.mark.parametrize("groups,page", [(1, 8), (2, 8), (4, 8), (1, 16),
                                         (2, 16), (4, 16)])
def test_matches_reference_kernel_and_plain_version_f32(groups, page):
    q, kp, vp, bt, lengths = _case(groups, page)
    want = _jax_kernel(q, kp, vp, bt, lengths)
    want_plain = np.asarray(jax_paged_decode_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lengths)))
    args = _t(q, kp, vp, bt, lengths)
    got = paged_decode_attention(*args).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL)
    # the reference's plain version gives a length-0 row the mean of the
    # whole table's V (its softmax over all-masked keys is uniform); both
    # kernels give 0 there, so the plain versions agree on live rows
    np.testing.assert_allclose(got[1:], want_plain[1:], atol=F32_ATOL)
    assert not got[0].any() and not want[0].any()
    # the dispatching wrapper on CPU is exactly the plain version
    np.testing.assert_array_equal(got, paged_decode_reference(*args).numpy())


@pytest.mark.parametrize("groups,page", [(2, 8), (4, 16)])
def test_nan_pages_past_live_count_never_reach_the_output(groups, page):
    """Every table tail names an all-NaN page. The Pallas kernel's grid
    names those pages but skips their compute; the port's plain version
    gathers them and zeroes them before the weighted sum."""
    q, kp, vp, bt, lengths = _case(groups, page, seed=1, poison=True)
    want = _jax_kernel(q, kp, vp, bt, lengths)
    got = paged_decode_attention(*_t(q, kp, vp, bt, lengths)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=F32_ATOL)
    assert not got[0].any()


@pytest.mark.parametrize("groups,page", [(1, 16), (4, 8)])
def test_bfloat16_within_one_output_ulp_of_reference_kernel(groups, page):
    q, kp, vp, bt, lengths = _case(groups, page, seed=2, poison=True)
    want = _jax_kernel(q, kp, vp, bt, lengths, dtype=jnp.bfloat16)
    got = paged_decode_attention(*_t(q, kp, vp, bt, lengths,
                                     dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    atol, rtol = BF16_TOL
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    assert not got[0].any()


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_equals_ragged_decode_on_live_rows(groups):
    """B2 and B1 at q_len 1 take the same lengths (INCLUDING the current
    token). On rows of length >= 1 they agree; on a length-0 row B2
    writes exact zeros, while B1 treats the row as padding."""
    q, kp, vp, bt, lengths = _case(groups, 8, seed=3, poison=True)
    args = _t(q, kp, vp, bt, lengths)
    got = paged_decode_attention(*args)
    ragged = ragged_decode_attention(*args)
    live = lengths >= 1
    np.testing.assert_allclose(got.numpy()[live], ragged.numpy()[live],
                               atol=F32_ATOL)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


def test_wrapper_rejects_unknown_devices():
    q, kp, vp, bt, lengths = _t(*_case(2, 8))
    before = paged_decode_attention.launches
    paged_decode_attention(q, kp, vp, bt, lengths)
    with pytest.raises(ValueError, match="no kernel"):
        paged_decode_attention(*(t.to("meta") for t in (q, kp, vp, bt,
                                                        lengths)))
    assert paged_decode_attention.launches == before   # CPU calls: none
