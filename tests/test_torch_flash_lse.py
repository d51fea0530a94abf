"""The port's flash_attention_with_lse (differentiable in the output and in the
logsumexp) against the JAX package's, whose Pallas kernels run in interpret
mode on the CPU: the same numpy inputs through both, fp32, head size 64. On
CPU tensors the port runs the plain versions of its lse-forward and one-pass
backward kernels, through the same autograd Function that launches the
kernels on a CUDA device, so the D - dlse row term is exercised here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.ops import flash_attention as jfa
from gpt2_vision_language_tpu_torch.ops import attention
from gpt2_vision_language_tpu_torch.ops import flash_attention as fa

B, H, HS = 1, 2, 64
SHAPES = [(256, 256, True), (256, 256, False), (100, 100, True), (64, 300, True),
          (64, 300, False)]


def _inputs(tq, tk, seed):
    """q (B, Tq, H, hs), k, v (B, Tk, H, hs), w like the output, u (B, H, Tq)."""
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (mk(B, tq, H, HS), mk(B, tk, H, HS), mk(B, tk, H, HS), mk(B, tq, H, HS),
            mk(B, H, tq))


def _bhtd(a):
    return jnp.asarray(a.transpose(0, 2, 1, 3))


def _jax_loss(q, k, v, w, u, causal):
    out, lse = jfa.flash_attention_with_lse(q, k, v, causal=causal, interpret=True)
    return jnp.sum(out * w) + jnp.sum(lse[..., 0] * u)


def _port_grads(q, k, v, w, u, causal, fn=fa.flash_attention_with_lse):
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out, lse = fn(q, k, v, causal=causal)
    loss = (out * torch.from_numpy(w)).sum()
    if u is not None:
        loss = loss + (lse * torch.from_numpy(u)).sum()
    loss.backward()
    return out.detach(), lse.detach(), (q.grad, k.grad, v.grad)


@pytest.mark.parametrize("tq, tk, causal", SHAPES)
def test_forward_matches_jax(tq, tk, causal):
    q, k, v, _, _ = _inputs(tq, tk, seed=tq + tk)
    want_o, want_lse = jfa.flash_attention_with_lse(_bhtd(q), _bhtd(k), _bhtd(v),
                                                    causal=causal, interpret=True)
    out, lse = fa.flash_attention_with_lse(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert out.shape == (B, tq, H, HS) and lse.shape == (B, H, tq)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 1, 3), np.asarray(want_o),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], rtol=2e-5, atol=2e-5)
    assert fa.flash_lse_forward.launches == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("tq, tk, causal", SHAPES)
def test_grads_with_lse_cotangent_match_jax(tq, tk, causal):
    """Gradients of sum(out * w) + sum(lse * u) with random w and u, so the
    cotangent of lse is not zero; tolerances of tests/test_ring_attention.py."""
    q, k, v, w, u = _inputs(tq, tk, seed=7 + tq + tk)
    want = jax.grad(_jax_loss, argnums=(0, 1, 2))(_bhtd(q), _bhtd(k), _bhtd(v), _bhtd(w),
                                                  jnp.asarray(u), causal)
    _, _, got = _port_grads(q, k, v, w, u, causal)
    for g, r, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 1, 3), np.asarray(r),
                                   rtol=5e-4, atol=5e-5, err_msg=f"d{name}")
    # the lse cotangent matters: without it the gradients are others
    _, _, without = _port_grads(q, k, v, w, None, causal)
    assert not torch.allclose(got[0], without[0], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("tq, tk, causal", [(256, 256, True), (64, 300, False)])
def test_zero_lse_cotangent_gives_flash_attention_grads(tq, tk, causal):
    q, k, v, w, _ = _inputs(tq, tk, seed=3)
    _, _, got = _port_grads(q, k, v, w, np.zeros((B, H, tq), np.float32), causal)
    unused_o, unused_lse, unused = _port_grads(q, k, v, w, None, causal)
    plain = lambda q, k, v, causal: fa.flash_attention(  # noqa: E731
        q, k, v, causal=causal, return_lse=True, stream_kv=True)
    want_o, want_lse, want = _port_grads(q, k, v, w, None, causal, fn=plain)
    for g, n, r in zip(got, unused, want):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(n, r, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(unused_o, want_o)
    torch.testing.assert_close(unused_lse, want_lse)


def test_backward_reference_takes_dcap():
    """flash_fused_backward_reference with dcap = D - dlse is autograd's
    gradient of the plain forward under (do, dlse)."""
    tq, tk = 48, 80
    q, k, v, w, u = _inputs(tq, tk, seed=5)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out, lse = fa.flash_attention_with_lse_reference(qt, kt, vt, causal=True)
    do, dlse = torch.from_numpy(w), torch.from_numpy(u)
    want = torch.autograd.grad((out, lse), (qt, kt, vt), (do, dlse))
    dcap = fa.rowdot_reference(do, out.detach()) - dlse
    got = fa.flash_fused_backward_reference(qt.detach(), kt.detach(), vt.detach(), do,
                                            lse.detach(), dcap, causal=True)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5)
    assert fa.flash_fused_backward.launches == 0


def test_causal_tq_gt_tk_raises():
    q, k, v, _, _ = _inputs(128, 64, seed=1)
    with pytest.raises(ValueError, match="Tq <= Tk"):
        fa.flash_attention_with_lse(*map(torch.from_numpy, (q, k, v)), causal=True)
    out, lse = fa.flash_attention_with_lse(*map(torch.from_numpy, (q, k, v)), causal=False)
    assert out.shape == (B, 128, H, HS) and lse.shape == (B, H, 128)


@pytest.mark.parametrize("tq, tk", [(64, 300), (128, 128)])
def test_flash_attention_stream_kv_false_no_longer_raises(monkeypatch, tq, tk):
    """flash_attention(stream_kv=False) takes every shape: off the
    self-attention family's shapes it goes to the lse family with a zero lse
    cotangent, and equals stream_kv=True in value and gradient."""
    monkeypatch.setattr(fa, "K1_MAX_T", 64)  # so that (128, 128) is off K1's shapes too
    assert fa.select_family(tq, tk, False) == "lse"
    q, k, v, w, _ = _inputs(tq, tk, seed=9)
    run = lambda stream: _port_grads(  # noqa: E731
        q, k, v, w, None, True,
        fn=lambda q, k, v, causal: fa.flash_attention(q, k, v, causal=causal, return_lse=True,
                                                      stream_kv=stream))
    o0, lse0, g0 = run(False)
    o1, lse1, g1 = run(True)
    torch.testing.assert_close(o0, o1)
    torch.testing.assert_close(lse0, lse1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    want = attention.xla_sdpa(*map(torch.from_numpy, (q, k, v)), causal=True, layout="bthd")
    torch.testing.assert_close(o0, want)
