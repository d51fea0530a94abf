"""The general flash-attention family of the PyTorch port (Tq != Tk, ragged
lengths, right-aligned causal or not) against the JAX package's streamed-K/V
Pallas kernels in interpret mode: forward (o and lse), backward through
jax.grad, the plain backward with D passed in, and the routing between the
two kernel families. On CPU tensors the port runs the kernels' plain
versions; the CUDA kernels themselves are held against those on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.ops import flash_attention as jfa
from gpt2_vision_language_tpu_torch.ops import attention
from gpt2_vision_language_tpu_torch.ops import flash_attention as fa

B, H, HS = 2, 2, 64
BLOCK = 128  # JAX tile size: several key tiles per sweep at these lengths


def _qkv(tq, tk, seed=0):
    """q (B, Tq, H, hs), k and v (B, Tk, H, hs), fp32, from a numpy seed."""
    rng = np.random.RandomState(seed)
    return [rng.randn(B, t, H, HS).astype(np.float32) for t in (tq, tk, tk)]


def _bhtd(a):
    return jnp.asarray(a.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq, tk", [(256, 256), (64, 256), (1, 193), (130, 385),
                                    (1000, 1000)])
def test_general_forward_matches_jax_streamed_kernel(tq, tk, causal):
    """fp32: o and lse of flash_attention(stream_kv=True) within 2e-5 of
    _fwd_kernel_grid (sum order only differs)."""
    q, k, v = _qkv(tq, tk)
    want_o, want_lse = jfa._fwd(_bhtd(q), _bhtd(k), _bhtd(v), causal=causal, bq=BLOCK,
                                bk=BLOCK, stream_kv=True, interpret=True)
    o, lse = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                return_lse=True, stream_kv=True)
    assert fa.flash_general_forward.launches == 0  # CPU tensors: the plain version
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o).transpose(0, 2, 1, 3),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse).reshape(B, H, tq),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("tq, tk, causal", [(130, 385, True), (256, 256, False)])
def test_general_backward_matches_jax_streamed_kernels(tq, tk, causal):
    """fp32: dq, dk, dv of sum(o * g) through the port's general family (D
    from rowdot, then the plain backward with D passed in) within 2e-5 of
    jax.grad through flash_attention(stream_kv=True), whose VJP runs
    _dq_kernel_grid and _dkv_kernel_grid. The port scales dq and dk inside
    its backward; JAX folds the scale into q outside its VJP: the gradients
    with respect to the unscaled q must agree."""
    q, k, v = _qkv(tq, tk, seed=1)
    g = np.random.RandomState(2).randn(B, tq, H, HS).astype(np.float32)

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK,
                                block_q_bwd=BLOCK, block_k_bwd=BLOCK, stream_kv=True,
                                interpret=True, layout="bthd")
        return jnp.sum(o * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = fa.flash_attention(*leaves, causal=causal, stream_kv=True)
    (o * torch.from_numpy(g)).sum().backward()
    assert fa.flash_general_dq.launches == fa.flash_general_dkv.launches == 0
    for name, a, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_with_d_passed_in(causal):
    """The plain backward given D = rowsum(do * o) equals the one that forms
    D itself, bit for bit; a different D changes dq and dk but not dv; and
    the per-kernel wrappers return their parts of it."""
    q, k, v = map(torch.from_numpy, _qkv(70, 200, seed=3))
    do = torch.from_numpy(np.random.RandomState(4).randn(B, 70, H, HS).astype(np.float32))
    o, lse = fa.flash_attention_reference(q, k, v, causal=causal)
    dd = fa.flash_rowdot(do, o)
    assert dd.shape == (B, H, 70) and fa.flash_rowdot.launches == 0
    own = fa.flash_attention_backward_reference(q, k, v, o, lse, do, causal=causal)
    given = fa.flash_attention_backward_reference(q, k, v, None, lse, do, causal=causal,
                                                  dd=dd)
    for a, b in zip(own, given):
        assert torch.equal(a, b)
    shifted = fa.flash_attention_backward_reference(q, k, v, o, lse, do, causal=causal,
                                                    dd=dd + 1.0)
    assert not torch.allclose(shifted[0], own[0]) and not torch.allclose(shifted[1], own[1])
    assert torch.equal(shifted[2], own[2])
    assert torch.equal(fa.flash_general_dq(q, k, v, do, lse, dd, causal=causal), own[0])
    dk, dv = fa.flash_general_dkv(q, k, v, do, lse, dd, causal=causal)
    assert torch.equal(dk, own[1]) and torch.equal(dv, own[2])
    both = fa.flash_general_backward(q, k, v, o, lse, do, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(both, own))


@pytest.mark.parametrize(
    "tq, tk, stream_kv, want",
    [
        (1024, 1024, None, "self"),
        (8192, 8192, None, "self"),
        (1000, 1000, None, "self"),  # a ragged T stays with the kernels that mask it
        (8320, 8320, None, "general"),
        (16384, 16384, None, "general"),
        (64, 2048, None, "general"),
        (1, 1500, None, "general"),
        (1024, 1024, True, "general"),
        (64, 2048, True, "general"),
        (1024, 1024, False, "self"),
        (16384, 16384, False, "lse"),  # the lse forward and the one-pass backward
        (64, 2048, False, "lse"),
    ],
)
def test_select_family(tq, tk, stream_kv, want):
    assert fa.select_family(tq, tk, stream_kv) == want
    assert fa.K1_MAX_T == jfa.DT_MAX_T


@pytest.mark.parametrize(
    "tq, tk, stream_kv, bound, want",
    [(128, 128, None, None, "self"), (128, 128, True, None, "general"),
     (64, 128, None, None, "general"), (128, 128, None, 64, "general"),
     (128, 128, False, None, "self")],
)
def test_flash_attention_routes_to_family(monkeypatch, tq, tk, stream_kv, bound, want):
    """flash_attention and sdpa(impl='flash') hand a shape to the family
    select_family names: both families' autograd Functions are replaced by
    recording stubs, so no CUDA device is needed."""
    calls = []

    def stub(name):
        def apply(q, k, v, causal):
            calls.append(name)
            return fa.flash_attention_reference(q, k, v, causal=causal)
        return apply

    monkeypatch.setattr(fa._FlashAttn, "apply", stub("self"))
    monkeypatch.setattr(fa._FlashAttnGeneral, "apply", stub("general"))
    if bound is not None:
        monkeypatch.setattr(fa, "K1_MAX_T", bound)
    q, k, v = map(torch.from_numpy, _qkv(tq, tk, seed=5))
    fa.flash_attention(q, k, v, causal=True, stream_kv=stream_kv)
    assert calls == [want]
    if stream_kv is None:
        got = attention.sdpa(q, k, v, causal=True, impl="flash", layout="bthd")
        assert calls == [want, want]
        torch.testing.assert_close(got, attention.xla_sdpa(q, k, v, causal=True,
                                                           layout="bthd"))


def test_causal_tq_gt_tk_rejected():
    q, k, v = map(torch.from_numpy, _qkv(256, 128, seed=6))
    with pytest.raises(ValueError, match="Tq <= Tk"):
        fa.flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="Tq <= Tk"):
        attention.sdpa(q, k, v, causal=True, impl="flash", layout="bthd")
    # non-causal takes it
    o = fa.flash_attention(q, k, v, causal=False)
    want = attention.xla_sdpa(q, k, v, causal=False, layout="bthd")
    torch.testing.assert_close(o, want)


def test_sdpa_flash_takes_tq_ne_tk_in_both_layouts():
    """sdpa(impl='flash') passes Tq != Tk through, in bthd and bhtd, and
    agrees with the JAX xla_sdpa within 2e-5 (fp32)."""
    from gpt2_vision_language_tpu.ops import attention as jax_attention

    q, k, v = _qkv(33, 97, seed=7)
    for layout in ("bthd", "bhtd"):
        arrs = [a if layout == "bthd" else a.transpose(0, 2, 1, 3).copy() for a in (q, k, v)]
        want = jax_attention.xla_sdpa(*map(jnp.asarray, arrs), causal=True, layout=layout)
        got = attention.sdpa(*map(torch.from_numpy, arrs), causal=True, impl="flash",
                             layout=layout)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
