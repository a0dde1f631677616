"""The port's Llama training path against ray_tpu.models.llama.

Same weights (the reference's init, converted by params_from_numpy and
made leaf parameters), same numpy tokens. The reference runs on the CPU
(flash_attention's mha_reference forward and blockwise backward); the
port runs its plain versions on CPU tensors. Compared: logits, the
cross-entropy loss and every parameter's gradient, then three AdamW
steps against optax.adamw.

Tolerances (float32): logits and loss atol 2e-5 + rtol 1e-5, gradients
atol 2e-6 + rtol 1e-4 — XLA and PyTorch sum the same f32 products in
different orders; through two layers, the lm_head and the backward that
moves values of ~1e-2 by a few 1e-7. AdamW: losses atol 1e-5 (the
updates are lr-sized, 3e-4, and the loss changes by ~1e-3 per step);
parameters atol 1e-4, a third of lr: Adam's step m / sqrt(v) is about
+-lr whatever the gradient's size, so where a gradient is near 0 the
summation-order noise moves the step by a visible part of lr (measured
1.9e-5 on one of 2048 entries)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy

SHAPE = dict(vocab_size=64, n_heads=4, n_kv_heads=2, dim=32, n_layers=2,
             mlp_dim=64, max_seq_len=128)
TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-6, rtol=1e-4)
# the module (ray_tpu_torch.ops exports the function under the same name)
tflash = importlib.import_module("ray_tpu_torch.ops.flash_attention")


@pytest.fixture(scope="module")
def ref():
    cfg = jllama.llama_tiny(**SHAPE)
    params = jllama.init(jax.random.PRNGKey(0), cfg)
    tokens = np.random.RandomState(1).randint(0, 64, (2, 17)).astype(
        np.int32)
    return cfg, params, tokens


def _port_params(params_j, cfg_t):
    tree = jax.tree.map(np.asarray, params_j)
    params = params_from_numpy(tree, cfg_t, device="cpu")
    for t in _leaves(params):
        t.requires_grad_()
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _port_loss(params, tokens, cfg):
    tok = torch.from_numpy(tokens)
    logits = tllama.apply(params, tok[:, :-1], cfg)
    return logits, tllama.cross_entropy_loss(logits, tok[:, 1:])


def _port_grads(params_j, tokens, cfg_t):
    params = _port_params(params_j, cfg_t)
    _, loss = _port_loss(params, tokens, cfg_t)
    loss.backward()
    return {n: t.grad for n, t in _named(params).items()}


def test_logits_loss_and_every_gradient_match_reference(ref):
    cfg_j, params_j, tokens = ref
    cfg_t = tllama.llama_tiny(**SHAPE)

    def loss_fn(p):
        logits = jllama.apply(p, jnp.asarray(tokens[:, :-1]), cfg_j)
        return jllama.cross_entropy_loss(logits, jnp.asarray(tokens[:, 1:]))

    want_logits = jllama.apply(params_j, jnp.asarray(tokens[:, :-1]), cfg_j)
    want_loss, want_grads = jax.value_and_grad(loss_fn)(params_j)

    params = _port_params(params_j, cfg_t)
    logits, loss = _port_loss(params, tokens, cfg_t)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    loss.backward()
    want = _named(jax.tree.map(np.asarray, want_grads))
    got = _named(params)
    assert set(got) == set(want)
    for name, t in got.items():
        np.testing.assert_allclose(t.grad.numpy(), want[name],
                                   err_msg=name, **GRAD_TOL)


def test_remat_off_full_and_save_attn_give_equal_grads(ref):
    _, params_j, tokens = ref
    grads = {}
    for mode, kw in (("off", dict(remat=False)),
                     ("full", dict(remat=True, remat_policy="full")),
                     ("save_attn", dict(remat=True,
                                        remat_policy="save_attn"))):
        grads[mode] = _port_grads(params_j, tokens,
                                  tllama.llama_tiny(**SHAPE, **kw))
    for mode in ("full", "save_attn"):
        for name, g in grads[mode].items():
            torch.testing.assert_close(g, grads["off"][name], atol=1e-7,
                                       rtol=1e-6, msg=f"{mode} {name}")


@pytest.mark.parametrize("policy,per_layer", [("save_attn", 1), ("full", 2)])
def test_save_attn_never_replays_the_flash_forward(ref, monkeypatch, policy,
                                                   per_layer):
    """Calls of the flash op's forward in one training step: once per
    layer under save_attn (the backward reads its saved out and lse),
    twice under full remat (the backward replays it)."""
    _, params_j, tokens = ref
    calls = []
    plain = tflash.flash_forward_reference

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(tflash, "flash_forward_reference", counted)
    cfg = tllama.llama_tiny(**SHAPE, remat=True, remat_policy=policy)
    _port_grads(params_j, tokens, cfg)
    assert len(calls) == per_layer * cfg.n_layers


def test_adamw_steps_match_optax(ref):
    cfg_j, params_j, tokens = ref
    cfg_t = tllama.llama_tiny(**SHAPE)
    opt = optax.adamw(3e-4, weight_decay=0.0)

    def loss_fn(p):
        logits = jllama.apply(p, jnp.asarray(tokens[:, :-1]), cfg_j)
        return jllama.cross_entropy_loss(logits, jnp.asarray(tokens[:, 1:]))

    p_j, state = params_j, opt.init(params_j)
    want = []
    for _ in range(3):
        loss, g = jax.value_and_grad(loss_fn)(p_j)
        updates, state = opt.update(g, state, p_j)
        p_j = optax.apply_updates(p_j, updates)
        want.append(float(loss))

    params = _port_params(params_j, cfg_t)
    torch_opt = torch.optim.AdamW(_leaves(params), lr=3e-4,
                                  weight_decay=0.0)
    got = []
    for _ in range(3):
        torch_opt.zero_grad()
        _, loss = _port_loss(params, tokens, cfg_t)
        loss.backward()
        torch_opt.step()
        got.append(float(loss))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got[-1] < got[0]
    final = _named(jax.tree.map(np.asarray, p_j))
    for name, t in _named(params).items():
        np.testing.assert_allclose(t.detach().numpy(), final[name],
                                   atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("preset", ["tiny", "8b"])
def test_flops_per_token_and_num_params_match_reference(preset):
    if preset == "tiny":
        cj, ct = jllama.llama_tiny(**SHAPE), tllama.llama_tiny(**SHAPE)
    else:
        cj, ct = jllama.llama3_8b(), tllama.llama3_8b()
        assert abs(ct.num_params() - 8.03e9) < 0.01e9
    assert ct.num_params() == cj.num_params()
    for seq in (None, 4096):
        assert ct.flops_per_token(seq) == cj.flops_per_token(seq)


def test_use_flash_false_runs_mha_reference(ref, monkeypatch):
    _, params_j, tokens = ref
    flash_cfg = tllama.llama_tiny(**SHAPE)
    want, _ = _port_loss(_port_params(params_j, flash_cfg), tokens,
                         flash_cfg)
    monkeypatch.setattr(tflash, "flash_forward_reference",
                        lambda *a, **k: pytest.fail("flash op called"))
    cfg = tllama.llama_tiny(**SHAPE, use_flash=False)
    params = _port_params(params_j, cfg)
    logits, loss = _port_loss(params, tokens, cfg)
    loss.backward()
    torch.testing.assert_close(logits, want, **TOL)
