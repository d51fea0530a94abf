"""Fused LM-head + CE of the PyTorch port: the kernel's plain version against
the JAX Pallas forward (interpret mode), the chunked plain route against the
JAX XLA route, and the routing and its refusals. The CUDA kernel itself is
checked against the plain version on the card by chip_smoke.py."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.core import precision as jax_precision
from gpt2_vision_language_tpu.ops import fused_ce as jce
from gpt2_vision_language_tpu_torch.core.precision import DEFAULT_POLICY, FP32_POLICY
from gpt2_vision_language_tpu_torch.ops import fused_ce as fc


def _inputs(n, d, v, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, d) * 0.5).astype(np.float32)
    w = (rng.randn(v, d) * 0.1).astype(np.float32)
    t = rng.randint(0, v, n).astype(np.int32)
    t[:8] = np.arange(8)  # first vocab tile
    t[8:16] = np.arange(v - 8, v)  # last vocab tile
    return x, w, t


def test_plain_matches_jax_pallas_kernel():
    """N=512, D=64, V=1024, fp32: nll and lse within 1e-4 of _ce_fwd_kernel."""
    x, w, t = _inputs(512, 64, 1024)
    bn, bv = jce._ce_block_sizes(512, 64, 1024, 4)
    with mock.patch.object(jce, "FORCE_INTERPRET", True):
        nll_j, lse_j = jce._ce_fwd_pallas(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(t),
            jax_precision.FP32_POLICY, bn, bv, interpret=True,
        )
    nll, lse = fc.ce_forward(*map(torch.from_numpy, (x, w, t)))
    assert fc.ce_forward.launches == 0  # CPU tensors: the plain version
    np.testing.assert_allclose(nll.numpy(), np.asarray(nll_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_chunks", [1, 3, 8])
def test_reference_chunking_is_exact(n_chunks):
    x, w, t = map(torch.from_numpy, _inputs(100, 32, 300, seed=1))
    nll, lse = fc.ce_forward_reference(x, w, t, n_chunks=n_chunks)
    logits = x @ w.t()
    lz = torch.logsumexp(logits, dim=-1)
    torch.testing.assert_close(lse, lz, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(nll, lz - logits[torch.arange(100), t.long()],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "policy, jpolicy, tol",
    [(FP32_POLICY, jax_precision.FP32_POLICY, 1e-5),
     (DEFAULT_POLICY, jax_precision.DEFAULT_POLICY, 2e-2)],
    ids=["fp32", "bf16"],
)
def test_plain_route_matches_jax_xla_route(policy, jpolicy, tol):
    """impl="xla": the chunked forward of ops/fused_ce.py:291-329 (logits
    rounded to the compute dtype); bf16 within loss ulps of the JAX route."""
    x, w, t = _inputs(256, 64, 512, seed=2)
    want = jce.fused_linear_ce(jnp.asarray(x), jnp.asarray(w), jnp.asarray(t),
                               n_chunks=4, policy=jpolicy, impl="xla")
    got = fc.fused_linear_ce(*map(torch.from_numpy, (x, w, t)), n_chunks=4,
                             policy=policy, impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_routing_on_cpu():
    x, w, t = map(torch.from_numpy, _inputs(64, 32, 256, seed=3))
    # "auto" takes the kernel only on CUDA tensors
    auto = fc.fused_linear_ce(x, w, t, n_chunks=2, policy=DEFAULT_POLICY)
    xla = fc.fused_linear_ce(x, w, t, n_chunks=2, policy=DEFAULT_POLICY, impl="xla")
    assert torch.equal(auto, xla)
    kernel = fc.fused_linear_ce(x, w, t, policy=DEFAULT_POLICY, impl="kernel")
    want, _ = fc.ce_forward_reference(x.bfloat16(), w.bfloat16(), t)
    assert torch.equal(kernel, want)
    assert fc.ce_forward.launches == 0


def test_plain_route_is_differentiable():
    x, w, t = map(torch.from_numpy, _inputs(32, 16, 128, seed=4))
    x.requires_grad_(True)
    fc.fused_linear_ce(x, w, t, policy=FP32_POLICY).mean().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_unknown_impl_raises():
    x, w, t = map(torch.from_numpy, _inputs(16, 8, 32))
    with pytest.raises(ValueError, match="bogus"):
        fc.fused_linear_ce(x, w, t, impl="bogus")


@pytest.mark.parametrize(
    "shapes",
    [((4, 8), (16, 4), (4,)), ((4, 8), (16, 8), (5,)), ((2, 4, 8), (16, 8), (4,))],
    ids=["depth_mismatch", "targets_len", "x_rank"],
)
def test_ce_forward_refuses(shapes):
    x, w = torch.zeros(shapes[0]), torch.zeros(shapes[1])
    t = torch.zeros(shapes[2], dtype=torch.int32)
    with pytest.raises(ValueError):
        fc.ce_forward(x, w, t)


def _ce_loss_jax(x, w, t, g, n_chunks, jpolicy):
    return jnp.sum(jce.fused_linear_ce(x, w, t, n_chunks=n_chunks, policy=jpolicy,
                                       impl="xla") * g)


def _grads(x, w, t, g, n_chunks, policy, impl="xla"):
    """dx, dw of sum(nll * g) through the port."""
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    nll = fc.fused_linear_ce(xt, wt, torch.from_numpy(t), n_chunks=n_chunks,
                             policy=policy, impl=impl)
    (nll * torch.from_numpy(g)).sum().backward()
    return xt.grad, wt.grad


@pytest.mark.parametrize("n_chunks", [1, 4])
def test_backward_matches_jax_fp32(n_chunks):
    """N=512, D=64, V=1024, fp32, rows with a zero cotangent (the masked
    -100 rows of fused_ce_loss): dx and dw within 1e-5 of jax.grad of the
    JAX fused_linear_ce (the chunked recompute backward of _make._bwd)."""
    import jax

    x, w, t = _inputs(512, 64, 1024, seed=5)
    g = np.random.RandomState(6).rand(512).astype(np.float32)
    g[::7] = 0.0  # masked rows
    want = jax.grad(_ce_loss_jax, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(t), jnp.asarray(g), n_chunks,
        jax_precision.FP32_POLICY)
    dx, dw = _grads(x, w, t, g, n_chunks, FP32_POLICY)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
    assert not dx[::7].any()


def test_backward_matches_jax_bf16():
    """bf16 policy: dx and dw within 2e-2 of max |grad| of the JAX grads;
    dw comes back fp32 for fp32 w (accumulated in fp32 across chunks)."""
    import jax

    x, w, t = _inputs(256, 64, 512, seed=7)
    g = np.full(256, 1.0 / 256, np.float32)
    want = jax.grad(_ce_loss_jax, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(t), jnp.asarray(g), 4,
        jax_precision.DEFAULT_POLICY)
    dx, dw = _grads(x, w, t, g, 4, DEFAULT_POLICY)
    assert dw.dtype == torch.float32 and dx.dtype == torch.float32
    for got, ref in ((dx, want[0]), (dw, want[1])):
        ref = np.asarray(ref, np.float32)
        err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
        assert err <= 2e-2, err


def test_kernel_route_has_the_same_backward():
    """impl="kernel" (K4's plain version on CPU tensors) gives the chunked
    backward too: at fp32 its grads equal the plain route's."""
    x, w, t = _inputs(64, 32, 256, seed=8)
    g = np.ones(64, np.float32)
    for a, b in zip(_grads(x, w, t, g, 2, FP32_POLICY, impl="kernel"),
                    _grads(x, w, t, g, 2, FP32_POLICY)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert fc.ce_forward.launches == 0
