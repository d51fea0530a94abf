"""ops/layers of the PyTorch port against the JAX package, fp32 (<= 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.core.precision import FP32_POLICY as JAX_FP32
from gpt2_vision_language_tpu.ops import layers as J
from gpt2_vision_language_tpu_torch.core.precision import FP32_POLICY
from gpt2_vision_language_tpu_torch.ops import layers as P

TOL = dict(rtol=1e-6, atol=1e-6)


def _x(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    x, w, b = _x(2, 5, 16), _x(16, 24, seed=1, scale=0.1), _x(24, seed=2)
    want = J.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b) if bias else None,
                    policy=JAX_FP32)
    # the port stores weights as torch nn.Linear does: (out, in)
    got = P.linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                   torch.from_numpy(b) if bias else None, policy=FP32_POLICY)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_linear_bf16_operands_accumulate_in_fp32():
    """bf16 policy on CPU: operands round to bf16, the product and the bias add
    stay fp32 until the final cast (jnp.dot preferred_element_type=f32)."""
    x, w, b = _x(3, 64), _x(64, 32, seed=1, scale=0.1), _x(32, seed=2)
    xt = torch.from_numpy(x)
    got = P.linear(xt, torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    xb = xt.bfloat16().float()
    wb = torch.from_numpy(w).bfloat16().float()
    np.testing.assert_allclose(got.numpy(), (xb @ wb + torch.from_numpy(b)).numpy(), **TOL)


def test_layer_norm():
    x = _x(2, 7, 32, scale=3.0) + 1.5
    s, b = _x(32, seed=1), _x(32, seed=2)
    want = J.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    got = P.layer_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=2e-6)


@pytest.mark.parametrize("name", ["gelu_tanh", "gelu_exact"])
def test_gelu(name):
    x = _x(4, 33, scale=3.0)
    want = getattr(J, name)(jnp.asarray(x))
    got = getattr(P, name)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embed():
    table = _x(50, 8)
    ids = np.random.RandomState(3).randint(0, 50, (3, 11))
    want = J.embed(jnp.asarray(table), jnp.asarray(ids))
    got = P.embed(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_layer_norm_backward_matches_jax_custom_vjp():
    """fp32: dx, dscale, dbias of the recompute backward within 1e-6 of the
    JAX custom VJP (ops/layers.py _ln_bwd)."""
    import jax

    x = _x(2, 7, 32, scale=3.0) + 1.5
    s, b, g = _x(32, seed=1), _x(32, seed=2), _x(2, 7, 32, seed=3)
    want = jax.grad(lambda *a: jnp.sum(J.layer_norm(*a) * g), argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, s, b)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, s, b)]
    (P.layer_norm(*leaves) * torch.from_numpy(g)).sum().backward()
    for name, a, w in zip(("dx", "dscale", "dbias"), leaves, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=1e-6, atol=2e-6,
                                   err_msg=name)


@pytest.mark.parametrize("bias", [True, False])
def test_linear_backward_matches_jax(bias):
    """fp32: dx, dw, db of the linear Function within 1e-6 of jax.grad
    (dw compared in torch's (out, in) layout)."""
    import jax

    x, w, b = _x(2, 5, 16), _x(16, 24, seed=1, scale=0.1), _x(24, seed=2)
    g = _x(2, 5, 24, seed=3)

    def loss(x, w, b):
        return jnp.sum(J.linear(x, w, b if bias else None, policy=JAX_FP32) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w.T.copy(), b))
    (P.linear(xt, wt, bt if bias else None, policy=FP32_POLICY)
     * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want[1]).T, **TOL)
    if bias:
        np.testing.assert_allclose(bt.grad.numpy(), np.asarray(want[2]), rtol=1e-6, atol=2e-6)
    else:
        assert bt.grad is None


def test_linear_bf16_backward_dtypes():
    """bf16 policy on CPU: dx in x's dtype, dw and db in the fp32 params'
    dtype, the products of bf16 operands accumulated in fp32."""
    x = torch.from_numpy(_x(3, 64)).bfloat16().requires_grad_(True)
    w = torch.from_numpy(_x(32, 64, seed=1, scale=0.1)).requires_grad_(True)
    b = torch.zeros(32, requires_grad=True)
    P.linear(x, w, b).float().sum().backward()
    assert (x.grad.dtype, w.grad.dtype, b.grad.dtype) == (
        torch.bfloat16, torch.float32, torch.float32)
    want = torch.ones(3, 32).t() @ x.detach().float()
    torch.testing.assert_close(w.grad, want, rtol=1e-6, atol=1e-6)


def test_matmul_f32_batched_low_precision():
    """Batched bf16 operands with broadcast batch dims: the fp32 product of
    the (exactly upcast) operands, returned in fp32."""
    a = torch.from_numpy(_x(5, 3, 1, 16)).bfloat16()
    b = torch.from_numpy(_x(3, 16, 7, seed=1)).bfloat16()
    got = P.matmul_f32(a, b)
    assert got.dtype == torch.float32 and got.shape == (5, 3, 1, 7)
    torch.testing.assert_close(got, torch.matmul(a.float(), b.float()), rtol=0, atol=0)
