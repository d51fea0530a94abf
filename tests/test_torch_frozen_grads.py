"""A frozen leaf costs no gradient work: the autograd Functions of the port
(linear, layer_norm, the fused lm_head + CE) skip what a parameter without
requires_grad would get, and the fine-tune path relies on it (124M frozen
weights below a trainable bridge). Also the routing constant the fine-tune
shape falls under."""

import inspect

import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.ops import attention as jattention
from gpt2_vision_language_tpu_torch.core.precision import FP32_POLICY
from gpt2_vision_language_tpu_torch.ops import attention, fused_ce, layers


def _count_matmuls(monkeypatch, module):
    calls = []
    real = module.matmul_f32

    def counting(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b)

    monkeypatch.setattr(module, "matmul_f32", counting)
    return calls


@pytest.mark.parametrize("frozen", [False, True])
def test_fused_ce_backward_skips_dw_of_a_frozen_head(monkeypatch, frozen):
    """3 products a chunk (logits, dx, dW) with a trainable head, 2 with a
    frozen one; dx is the same either way."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(64, 16).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.randn(40, 16).astype(np.float32)).requires_grad_(not frozen)
    t = torch.from_numpy(rng.randint(0, 40, 64))
    nll = fused_ce.fused_linear_ce(x, w, t, n_chunks=4, policy=FP32_POLICY)
    calls = _count_matmuls(monkeypatch, fused_ce)
    nll.sum().backward()
    assert len(calls) == (2 if frozen else 3) * 4
    assert (w.grad is None) == frozen
    ref = torch.autograd.grad(
        torch.nn.functional.cross_entropy(x @ w.detach().t(), t, reduction="sum"), x)[0]
    np.testing.assert_allclose(x.grad.numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("frozen", [False, True])
def test_linear_backward_skips_dw_of_a_frozen_weight(monkeypatch, frozen):
    x = torch.randn(6, 8, generator=torch.Generator().manual_seed(0)).requires_grad_()
    w = torch.randn(5, 8, generator=torch.Generator().manual_seed(1)).requires_grad_(not frozen)
    b = torch.zeros(5).requires_grad_(not frozen)
    y = layers.linear(x, w, b, policy=FP32_POLICY)
    calls = _count_matmuls(monkeypatch, layers)
    y.sum().backward()
    assert len(calls) == (1 if frozen else 2)
    assert (w.grad is None) == frozen and (b.grad is None) == frozen and x.grad is not None


@pytest.mark.parametrize("frozen", [False, True])
def test_layer_norm_backward_skips_frozen_parameters(frozen):
    x = torch.randn(4, 3, 8, generator=torch.Generator().manual_seed(0)).requires_grad_()
    scale = torch.ones(8).requires_grad_(not frozen)
    bias = torch.zeros(8).requires_grad_(not frozen)
    y = layers.layer_norm(x, scale, bias)
    y.square().sum().backward()
    assert (scale.grad is None) == frozen and (bias.grad is None) == frozen
    ref_x = x.detach().clone().requires_grad_()
    torch.nn.functional.layer_norm(ref_x, (8,)).square().sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), ref_x.grad.numpy(), atol=1e-5)
    # the Function itself returns None for them, not a computed tensor
    ctx = type("Ctx", (), {"needs_input_grad": (True, not frozen, not frozen, False)})()
    mean, rstd = layers._ln_stats(x.detach(), 1e-5)
    ctx.saved_tensors = (x.detach(), scale.detach(), mean, rstd)
    _, ds, db, _ = layers._LayerNorm.backward(ctx, torch.ones_like(y))
    assert (ds is None) == frozen and (db is None) == frozen


def test_flash_threshold_is_the_jax_packages():
    """The fine-tune's T=65 self-attention takes the plain path in both
    packages: the port keeps the JAX threshold (the H100 reading that the
    kernels win below it too is recorded beside the constant, not acted on)."""
    assert f">= {attention.AUTO_FLASH_MIN_T}" in inspect.getsource(jattention.sdpa)
    assert attention.AUTO_FLASH_MIN_T == 512
    q = torch.randn(2, 65, 2, 64, generator=torch.Generator().manual_seed(0))
    before = attention.flash_attention.launches
    out = attention.sdpa(q, q, q, causal=True, impl="auto", layout="bthd")
    assert out.shape == q.shape and attention.flash_attention.launches == before
    src = inspect.getsource(attention)
    assert "another chip" not in src and "H100" in src
