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
