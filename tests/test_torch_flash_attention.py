"""The port's flash attention against ray_tpu.ops.flash_attention.

The same numpy inputs (from a seed) go through the JAX package's Pallas
kernels in interpret mode (``interpret=True``, as
tests/test_flash_attention.py runs them on the CPU) and through the
port's op on CPU tensors (its plain versions). Compared: the forward's
out and lse, and the gradients of q, k and v (``jax.grad`` against
``torch.autograd``) for a random output cotangent.

Tolerances (float32): forward atol 1e-5, gradients atol 2e-5 + rtol
1e-5. Both sides sum the same f32 products in different orders (the
Pallas kernel block by block with a streaming softmax, the port in one
einsum); measured differences are below 3e-6 on values up to ~7. The
JAX package's own tests allow 2e-4 / 2e-3. The bf16 forward's and
backward's tolerances are stated at their tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.flash_attention import _flash_fwd
from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu.ops.flash_attention import mha_reference as jax_mha
from ray_tpu_torch.ops.flash_attention import (
    FLASH_FWD_OP, flash_attention, flash_backward_reference,
    flash_dkv_kernel, flash_dq_kernel, flash_fwd_kernel,
    flash_forward_reference, mha_reference,
)

FWD_TOL = dict(atol=1e-5, rtol=0)
GRAD_TOL = dict(atol=2e-5, rtol=1e-5)

# (b, sq, sk, h, kvh, d, block_q, block_k): aligned, GQA, the padded
# shapes of tests/test_flash_attention.py (30, 100, 77x140), and the
# card's bf16 dq/dkv kernels' head dim with GQA 4 on a ragged 80
SHAPES = {
    "aligned": (2, 64, 64, 2, 2, 16, 32, 32),
    "gqa2": (1, 64, 64, 4, 2, 16, 32, 32),
    "pad30": (1, 30, 30, 4, 2, 32, 16, 128),
    "pad100": (2, 100, 100, 4, 2, 32, 64, 128),
    "ragged77x140": (2, 77, 140, 4, 2, 32, 64, 128),
    "d128gqa4": (1, 80, 80, 8, 2, 128, 64, 64),
}


def _inputs(shape, seed):
    b, sq, sk, h, kvh, d, _, _ = shape
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in
            ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d), (b, sq, h, d))]


def _cases():
    for name, shape in SHAPES.items():
        for causal in (False, True):
            yield pytest.param(shape, causal, id=f"{name}-"
                               f"{'causal' if causal else 'full'}")


@pytest.mark.parametrize("shape,causal", list(_cases()))
def test_forward_out_and_lse_match_pallas_interpret(shape, causal):
    q, k, v, _ = _inputs(shape, 0)
    d, bq, bk = shape[5], shape[6], shape[7]
    want_out, want_lse = _flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal, d ** -0.5, bq,
                                    bk, True)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash_forward_reference(tq, tk, tv, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **FWD_TOL)
    # the public op returns the same out
    got = flash_attention(tq, tk, tv, causal, None, bq, bk)
    np.testing.assert_allclose(got.numpy(), out.numpy(), atol=0, rtol=0)
    np.testing.assert_allclose(
        mha_reference(tq, tk, tv, causal).numpy(),
        np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal)), **FWD_TOL)


@pytest.mark.parametrize("shape,causal", list(_cases()))
def test_grads_match_jax_grad_of_pallas_interpret(shape, causal):
    q, k, v, go = _inputs(shape, 1)
    bq, bk = shape[6], shape[7]

    def loss(q, k, v):
        return (jax_flash(q, k, v, causal, None, bq, bk, True)
                * jnp.asarray(go)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal, None, bq, bk)
    (out * torch.from_numpy(go)).sum().backward()
    for name, w, t in zip("qkv", want, (tq, tk, tv)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=f"d{name}", **GRAD_TOL)


def test_bf16_forward_within_one_ulp_of_reference():
    """bf16: the JAX package's flash_attention off the TPU (its
    mha_reference path) rounds the normalised p to bf16, as the port's
    plain version does: held to one bf16 ulp of its output. The Pallas
    kernel in interpret mode rounds the unnormalised per-block p instead,
    which moves outputs near 0 by many of their own ulps: held to atol
    1e-2 (measured 7.8e-3 here)."""
    q, k, v, _ = _inputs(SHAPES["gqa2"], 2)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    got = flash_attention(*(torch.from_numpy(x).to(torch.bfloat16)
                            for x in (q, k, v)), True).float().numpy()
    want = np.asarray(jax_flash(*jb, True).astype(jnp.float32))
    # one bf16 ulp of the reference value: 2^(exponent - 7)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()
    pallas = np.asarray(jax_flash(*jb, True, None, 32, 32, True)
                        .astype(jnp.float32))
    np.testing.assert_allclose(got, pallas, atol=1e-2, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_backward_matches_pallas_interpret(causal):
    """bf16 at G 1: the plain backward (the card kernels' oracle) against
    jax.grad of the Pallas kernels in interpret mode, on the same numpy
    inputs rounded to bf16, both given the Pallas forward's out and lse.
    Both round ds and p to bf16 at the same points and sum exact f32
    products in f32 in other orders, so an output lands at most about one
    bf16 ulp away: within 2^-7 of the tensor's largest |value| (measured:
    at most 1.1e-3 of it, and fewer than 0.1% of the entries differ)."""
    shape = (1, 96, 96, 2, 2, 64, 32, 32)
    q, k, v, go = _inputs(shape, 6)
    d, bq, bk = shape[5], shape[6], shape[7]
    jq, jk, jv, jg = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, go))

    def loss(q, k, v):
        out = jax_flash(q, k, v, causal, None, bq, bk, True)
        return (out.astype(jnp.float32) * jg.astype(jnp.float32)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    out, lse = _flash_fwd(jq, jk, jv, causal, d ** -0.5, bq, bk, True)
    as_t = lambda x: torch.from_numpy(                       # noqa: E731
        np.array(jnp.asarray(x, jnp.float32)))
    got = flash_backward_reference(
        *(as_t(x).to(torch.bfloat16) for x in (jq, jk, jv, out)),
        as_t(lse), as_t(jg).to(torch.bfloat16), causal)
    for name, w, g in zip("qkv", want, got):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(g.float().numpy() - w)
        assert err.max() <= 2 ** -7 * np.abs(w).max(), (name, err.max())


def test_block_k_only_chunks_the_plain_backward():
    """block_k changes the plain backward's key blocks (a ragged last
    block included), not its result; block_q changes nothing."""
    q, k, v, go = _inputs(SHAPES["ragged77x140"], 3)
    grads = []
    for bq, bk in ((512, 512), (16, 33), (64, 1)):
        ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = flash_attention(*ts, True, None, bq, bk)
        (out * torch.from_numpy(go)).sum().backward()
        grads.append([t.grad for t in ts])
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            torch.testing.assert_close(a, b, atol=2e-6, rtol=1e-6)


def test_op_is_dispatcher_visible_and_cpu_calls_launch_nothing():
    assert FLASH_FWD_OP is torch.ops.ray_tpu_torch.flash_fwd.default
    before = (flash_fwd_kernel.launches, flash_dq_kernel.launches,
              flash_dkv_kernel.launches)
    q, k, v, go = _inputs(SHAPES["gqa2"], 4)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, lse = FLASH_FWD_OP(*ts, True, 0.25, 512)
    assert out.shape == ts[0].shape and lse.shape == (1, 4, 64)
    assert lse.dtype == torch.float32
    (out * torch.from_numpy(go)).sum().backward()
    assert all(t.grad is not None for t in ts)
    assert (flash_fwd_kernel.launches, flash_dq_kernel.launches,
            flash_dkv_kernel.launches) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(SHAPES["gqa2"], 5))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_fwd_kernel(q, k, v, True, 0.25)
