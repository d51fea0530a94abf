"""Fused LM-head + CE of the PyTorch port: the forward kernel's plain version
against the JAX Pallas forward (interpret mode), the chunked plain route and
the kernel route (the plain versions of K4 and K4b on CPU tensors) against
the JAX XLA route and its jax.grad, and the routing and its refusals. The
CUDA kernels themselves are checked against their plain versions on the card
by chip_smoke.py."""

from types import SimpleNamespace
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.core import precision as jax_precision
from gpt2_vision_language_tpu.ops import fused_ce as jce
from gpt2_vision_language_tpu_torch.core.precision import DEFAULT_POLICY, FP32_POLICY
from gpt2_vision_language_tpu_torch.obs import spans
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


@pytest.mark.parametrize("v", [1152, 1408])
def test_plain_matches_jax_pallas_kernel_at_a_ragged_tile(v):
    """N=256, D=64, V a multiple of 128 but not of 256 (9 and 11 lane tiles:
    the CUDA kernel's 256-wide vocab tiles end half full), fp32, targets in
    the last 128 columns: nll and lse within 1e-4 of _ce_fwd_kernel in
    interpret mode (its vocab blocks are 384 and 128 wide)."""
    x, w, t = _inputs(256, 64, v, seed=9)
    t[16:32] = np.arange(v - 16, v)
    bn, bv = jce._ce_block_sizes(256, 64, v, 4)
    with mock.patch.object(jce, "FORCE_INTERPRET", True):
        nll_j, lse_j = jce._ce_fwd_pallas(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(t),
            jax_precision.FP32_POLICY, bn, bv, interpret=True,
        )
    nll, lse = fc.ce_forward(*map(torch.from_numpy, (x, w, t)))
    np.testing.assert_allclose(nll.numpy(), np.asarray(nll_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("v", [50257, 1000])
def test_plain_matches_jax_at_a_ragged_vocab(v):
    """N=256, D=64, V that no lane tile divides (GPT-2's own 50257, and 1000),
    targets in the last columns: the Pallas block sizes refuse the shape
    (ops/fused_ce.py:146 of the JAX package), so the plain version's nll is
    held within 1e-5 to the JAX XLA route under the fp32 policy."""
    x, w, t = _inputs(256, 64, v, seed=10)
    t[16:32] = np.arange(v - 16, v)
    assert jce._ce_block_sizes(256, 64, v, 4) is None
    want = jce.fused_linear_ce(jnp.asarray(x), jnp.asarray(w), jnp.asarray(t),
                               n_chunks=2, policy=jax_precision.FP32_POLICY, impl="xla")
    nll, _ = fc.ce_forward(*map(torch.from_numpy, (x, w, t)))
    np.testing.assert_allclose(nll.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,splits", [(8192, 2), (4096, 4), (1000, 16), (65536, 1)])
def test_split_count_fills_a_wave(n, splits):
    """The kernel's vocab split for 124M's vocab (197 tiles of 256 columns) on
    an H100's 132 SMs, one block of 128 rows an SM: one wave of 128 blocks at
    N=8192, 4096 and 1000, and one split where the row tiles alone fill
    several waves; every split holds a tile."""
    vocab_tiles = -(-50304 // 256)
    got = fc.split_count(-(-n // 128), vocab_tiles, 132)
    assert got == splits
    per = -(-vocab_tiles // got)
    assert (got - 1) * per < vocab_tiles


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


@pytest.mark.parametrize("n_chunks", [1, 4])
def test_kernel_route_backward_matches_jax_fp32(n_chunks):
    """impl="kernel" under FP32_POLICY (``ce_forward_reference`` and
    ``ce_backward_reference`` on CPU tensors): dx and dw within 1e-5 of
    jax.grad of the JAX fused_linear_ce, rows with a zero cotangent giving
    zero dx rows; no kernel launched."""
    import jax

    x, w, t = _inputs(512, 64, 1024, seed=11)
    g = np.random.RandomState(12).rand(512).astype(np.float32)
    g[::5] = 0.0
    want = jax.grad(_ce_loss_jax, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(t), jnp.asarray(g), n_chunks,
        jax_precision.FP32_POLICY)
    dx, dw = _grads(x, w, t, g, n_chunks, FP32_POLICY, impl="kernel")
    np.testing.assert_allclose(dx.numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
    assert not dx[::5].any()
    assert fc.ce_forward.launches == 0 and fc.ce_backward.launches == 0


def test_kernel_route_backward_matches_jax_bf16():
    """impl="kernel" under the bf16 policy: the logits stay fp32 (K4b's
    arithmetic), p is cast once to bf16; dx and dw within 2e-2 of max |grad|
    of the JAX grads, dw fp32 for fp32 w."""
    import jax

    x, w, t = _inputs(256, 64, 512, seed=13)
    g = np.full(256, 1.0 / 256, np.float32)
    want = jax.grad(_ce_loss_jax, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(t), jnp.asarray(g), 4,
        jax_precision.DEFAULT_POLICY)
    dx, dw = _grads(x, w, t, g, 4, DEFAULT_POLICY, impl="kernel")
    assert dw.dtype == torch.float32 and dx.dtype == torch.float32
    for got, ref in ((dx, want[0]), (dw, want[1])):
        ref = np.asarray(ref, np.float32)
        err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
        assert err <= 2e-2, err


@pytest.mark.parametrize("n,v,n_chunks", [(200, 1096, 3), (1000, 264, 1), (130, 2056, 2)])
def test_backward_reference_at_ragged_shapes(n, v, n_chunks):
    """N not a multiple of K4b's 128 rows, V a multiple of 8 whose last
    256-wide tile is part full, targets in that tile, a zero cotangent on
    some rows: ``ce_backward_reference`` equals the fp64 gradient of
    sum(nll * g) with respect to the logits within 1e-5, zero rows where g
    is; the kernel route's dx and dw (fp32) equal jax.grad within 1e-5."""
    import jax

    x, w, t = _inputs(n, 64, v, seed=14)
    t[16:40] = np.arange(v - 24, v)
    g = np.random.RandomState(15).rand(n).astype(np.float32)
    g[3::11] = 0.0
    logits = torch.from_numpy(x).double() @ torch.from_numpy(w).double().t()
    logits.requires_grad_(True)
    nll = torch.logsumexp(logits, -1) - logits[torch.arange(n), torch.from_numpy(t).long()]
    (nll * torch.from_numpy(g).double()).sum().backward()
    xt, wt, tt, gt = map(torch.from_numpy, (x, w, t, g))
    _, lse = fc.ce_forward_reference(xt, wt, tt)
    p = fc.ce_backward(xt, wt, tt, lse, gt)
    assert p.dtype == torch.float32 and p.shape == (n, v)
    np.testing.assert_allclose(p.numpy(), logits.grad.numpy(), rtol=1e-5, atol=1e-5)
    assert not p[3::11].any()
    want = jax.grad(_ce_loss_jax, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(t), jnp.asarray(g), n_chunks,
        jax_precision.FP32_POLICY)
    dx, dw = _grads(x, w, t, g, n_chunks, FP32_POLICY, impl="kernel")
    np.testing.assert_allclose(dx.numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)


def test_backward_reference_rounds_logits_as_asked():
    """``logits_dtype`` bf16 rounds the logits before the exp (the plain
    route's p); the default keeps them fp32 (K4b's). p is cast to x's dtype
    once, so both are bf16 for bf16 operands and differ only by the
    logits' rounding."""
    x, w, t = (torch.from_numpy(a) for a in _inputs(64, 32, 256, seed=16))
    xb, wb = x.bfloat16(), w.bfloat16()
    g = torch.full((64,), 1.0 / 64)
    _, lse = fc.ce_forward_reference(xb, wb, t)
    exact = fc.ce_backward_reference(xb, wb, t, lse, g)
    rounded = fc.ce_backward_reference(xb, wb, t, lse, g, logits_dtype=torch.bfloat16)
    logits = xb.float() @ wb.float().t()
    want = (torch.exp(logits - lse[:, None]) * g[:, None])
    want[torch.arange(64), t.long()] -= g
    assert exact.dtype == rounded.dtype == torch.bfloat16
    assert torch.equal(exact, want.bfloat16())
    assert not torch.equal(exact, rounded)


def _bwd_args(n=256, d=64, v=512, dtype=torch.bfloat16, tdtype=torch.int32,
              sdtype=torch.float32):
    return (torch.zeros(n, d, dtype=dtype), torch.zeros(v, d, dtype=dtype),
            torch.zeros(n, dtype=tdtype), torch.zeros(n, dtype=sdtype),
            torch.zeros(n, dtype=sdtype))


@pytest.mark.parametrize(
    "args",
    [_bwd_args(dtype=torch.float32), _bwd_args(dtype=torch.float16),
     _bwd_args(tdtype=torch.int64), _bwd_args(sdtype=torch.bfloat16),
     (torch.zeros(64, 256, dtype=torch.bfloat16).t(),) + _bwd_args()[1:],
     _bwd_args(d=68), _bwd_args(v=500)],
    ids=["fp32", "fp16", "int64_targets", "bf16_lse", "non_contiguous", "d_not_8", "v_not_8"],
)
def test_ce_backward_kernel_refuses(args):
    """K4b's wrapper refuses, before it builds or launches anything, what the
    kernel does not take: non-bf16 x and w, targets other than int32, lse
    and g other than fp32, a non-contiguous operand, D or V not a multiple
    of 8."""
    with mock.patch.object(fc._build, "load", side_effect=AssertionError("reached the build")):
        with pytest.raises(ValueError):
            fc.ce_backward_cuda(*args)
    assert fc.ce_backward.launches == 0


@pytest.mark.parametrize(
    "shapes",
    [((4, 8), (16, 4), (4,), (4,)), ((4, 8), (16, 8), (5,), (4,)),
     ((4, 8), (16, 8), (4,), (3,)), ((2, 4, 8), (16, 8), (4,), (4,))],
    ids=["depth_mismatch", "targets_len", "lse_len", "x_rank"],
)
def test_ce_backward_refuses(shapes):
    x, w = torch.zeros(shapes[0]), torch.zeros(shapes[1])
    t = torch.zeros(shapes[2], dtype=torch.int32)
    lse = g = torch.zeros(shapes[3])
    with pytest.raises(ValueError):
        fc.ce_backward(x, w, t, lse, g)


def _stand_in(is_cuda, n, d, v, requires_grad):
    """What ``kernel_route`` reads of x and w, for a card this host lacks."""
    return (SimpleNamespace(is_cuda=is_cuda, shape=(n, d), requires_grad=requires_grad),
            SimpleNamespace(is_cuda=is_cuda, shape=(v, d), requires_grad=requires_grad))


@pytest.mark.parametrize("requires_grad", [False, True], ids=["no_grad", "autograd"])
@pytest.mark.parametrize(
    "is_cuda,policy,d,v,want",
    [(True, DEFAULT_POLICY, 768, 50304, True), (True, DEFAULT_POLICY, 1600, 50304, True),
     (True, FP32_POLICY, 768, 50304, False), (False, DEFAULT_POLICY, 768, 50304, False),
     (True, DEFAULT_POLICY, 764, 50304, False), (True, DEFAULT_POLICY, 768, 50257, False)],
    ids=["cuda_bf16", "cuda_bf16_1558m", "cuda_fp32", "cpu_bf16", "d_not_8", "v_not_8"],
)
def test_kernel_route_picks(is_cuda, policy, d, v, want, requires_grad):
    """"auto" takes the kernels on CUDA under the bf16 policy at shapes they
    take, with or without autograd; the plain path under FP32_POLICY, on the
    CPU and at shapes they refuse. "kernel" and "xla" force their route."""
    x, w = _stand_in(is_cuda, 2048, d, v, requires_grad)
    assert fc.kernel_route("auto", x, w, policy) is want
    assert fc.kernel_route("kernel", x, w, policy) is True
    assert fc.kernel_route("xla", x, w, policy) is False


@pytest.mark.parametrize("impl,want", [("kernel", "kernel"), ("xla", "plain"), ("auto", "plain")])
def test_spans_carry_the_route(impl, want):
    """``ce.fwd`` and ``ce.bwd`` carry the route a call took as ``impl``;
    "auto" on CPU tensors is the plain path."""
    x, w, t = map(torch.from_numpy, _inputs(32, 16, 128, seed=17))
    x.requires_grad_(True)
    spans.drain()
    spans.enable()
    try:
        fc.fused_linear_ce(x, w, t, n_chunks=2, policy=DEFAULT_POLICY, impl=impl).sum().backward()
    finally:
        spans.disable()
    recs = {r.name: r.attrs for r in spans.drain()}
    assert recs == {"ce.fwd": {"impl": want}, "ce.bwd": {"impl": want}}
