"""The port's CLIP token pooling against the JAX one on the same inputs
(made from a seed with numpy), at the ViT-B/16 (14 x 14) and a 16 x 16 grid."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gpt2_vision_language_tpu.ops import pooling as jpool
from gpt2_vision_language_tpu_torch.ops import pooling

# fp32 both ways; the two einsums sum in another order
TOL = 1e-6


@pytest.mark.parametrize("side", [14, 16])
def test_pool_clip_tokens_to_33_matches_jax(side):
    x = np.random.RandomState(side).randn(3, 1 + side * side, 24).astype(np.float32)
    got = pooling.pool_clip_tokens_to_33(torch.from_numpy(x))
    want = np.asarray(jpool.pool_clip_tokens_to_33(jnp.asarray(x)))
    assert tuple(got.shape) == (3, 33, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # unit L2 norm per token
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("hw, out", [((14, 14), (4, 8)), ((16, 16), (4, 8)), ((7, 9), (3, 2))])
def test_adaptive_avg_pool2d_matches_jax_and_torch(hw, out):
    """The two-matrix contraction against the JAX one and, as a second check,
    against torch's own adaptive pooling (uneven, overlapping bins)."""
    x = np.random.RandomState(0).randn(2, 5, *hw).astype(np.float32)
    got = pooling.adaptive_avg_pool2d(torch.from_numpy(x), out)
    want = np.asarray(jpool.adaptive_avg_pool2d(jnp.asarray(x), out))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    lib = F.adaptive_avg_pool2d(torch.from_numpy(x), out)
    np.testing.assert_allclose(got.numpy(), lib.numpy(), atol=1e-6, rtol=0)
    assert np.array_equal(pooling._adaptive_matrix(hw[0], out[0]),
                          jpool._adaptive_matrix(hw[0], out[0]))


def test_pooling_keeps_dtype_and_refuses_a_ragged_grid():
    x = torch.randn(2, 197, 8, generator=torch.Generator().manual_seed(0))
    assert pooling.pool_clip_tokens_to_33(x.to(torch.bfloat16)).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="square"):
        pooling.pool_clip_tokens_to_33(torch.zeros(1, 1 + 12, 8))
