"""Flash-attention forward of the PyTorch port: its plain version against the
JAX dt Pallas kernel (interpret mode) and against xla_sdpa, and the
wrapper's and sdpa's refusals. The CUDA kernel itself is checked against
the plain version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.ops import attention as jax_attention
from gpt2_vision_language_tpu.ops import flash_attention as jfa
from gpt2_vision_language_tpu_torch.ops import attention
from gpt2_vision_language_tpu_torch.ops import flash_attention as fa


def _qkv(b, t, h, hs, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, hs).astype(np.float32) for _ in range(3)]


def _to_dt(a):
    """(B, T, H, hs) -> the JAX kernel's (H, hs, B*T)."""
    b, t, h, hs = a.shape
    return jnp.asarray(a.transpose(2, 3, 0, 1).reshape(h, hs, b * t))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [128, 256])
def test_plain_matches_jax_dt_kernel(t, causal):
    """fp32, B=2 H=2 hs=64: out and lse within 1e-5 of _fwd_dt_kernel."""
    b, h, hs = 2, 2, 64
    q, k, v = _qkv(b, t, h, hs)
    bq = jfa._dt_block(t, jfa.DEFAULT_BLOCK_Q)
    # flash_attention_dt folds the (power-of-two, lossless) scale into q
    o_dt, lse_dt = jfa._fwd_dt(
        _to_dt(q) * (1.0 / hs**0.5), _to_dt(k), _to_dt(v), b=b, t=t,
        causal=causal, bq=bq, bk=bq, interpret=True,
    )
    want_o = np.asarray(o_dt).reshape(h, hs, b, t).transpose(2, 3, 0, 1)
    want_lse = np.asarray(lse_dt)[:, 0, :].reshape(h, b, t).transpose(1, 0, 2)

    o, lse = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                return_lse=True)
    assert fa.flash_attention.launches == 0  # CPU tensors: the plain version
    np.testing.assert_allclose(o.numpy(), want_o, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["bthd", "bhtd"])
def test_ragged_t_matches_xla_sdpa(layout):
    """T=200 (no tile multiple), causal, fp32, within 1e-5."""
    q, k, v = _qkv(2, 200, 3, 64, seed=1)
    if layout == "bhtd":
        q, k, v = (a.transpose(0, 2, 1, 3).copy() for a in (q, k, v))
    want = jax_attention.xla_sdpa(*map(jnp.asarray, (q, k, v)), causal=True,
                                  layout=layout)
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                             layout=layout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the port's own einsum path agrees too
    ref = attention.xla_sdpa(*map(torch.from_numpy, (q, k, v)), causal=True,
                             layout=layout)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "shapes, kw",
    [
        # Tq != Tk is taken (the general kernels), except causal with Tq > Tk
        (((1, 32, 2, 64), (1, 16, 2, 64), (1, 16, 2, 64)), {}),
        (((1, 16, 2, 32),) * 3, {}),  # a head size the kernel is not built for
        (((16, 2, 64),) * 3, {}),  # not 4-D
        (((1, 16, 2, 64),) * 3, {"layout": "bht"}),
    ],
    ids=["tq_ne_tk", "head_size", "rank", "layout"],
)
def test_wrapper_refuses(shapes, kw):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, **kw)


def test_sdpa_routing_on_cpu():
    q, k, v = map(torch.from_numpy, _qkv(1, 600, 2, 64, seed=2))
    # "auto" takes the kernel only on CUDA tensors; here the einsum path runs
    got = attention.sdpa(q, k, v, causal=True, impl="auto", layout="bthd")
    want = attention.xla_sdpa(q, k, v, causal=True, layout="bthd")
    assert torch.equal(got, want)
    flash = attention.sdpa(q, k, v, causal=True, impl="flash", layout="bthd")
    torch.testing.assert_close(flash, want, rtol=1e-5, atol=1e-5)
    assert fa.flash_attention.launches == 0
    with pytest.raises(RuntimeError, match="set_ring"):  # no ring installed
        attention.sdpa(q, k, v, causal=True, impl="ring")
    with pytest.raises(ValueError):
        attention.sdpa(q, k, v, causal=True, impl="bogus")


def _from_dt(a, b):
    """The JAX kernel's (H, hs, B*T) -> (B, T, H, hs)."""
    h, hs, bt = a.shape
    return np.asarray(a).reshape(h, hs, b, bt // b).transpose(2, 3, 0, 1)


def _port_grads(q, k, v, g, causal, fn=None):
    """dq, dk, dv of sum(attention(q, k, v) * g) through the port."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = (fn or fa.flash_attention)(*leaves, causal=causal)
    (o * torch.from_numpy(g)).sum().backward()
    return [a.grad.numpy() for a in leaves]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [128, 256])
def test_backward_matches_jax_dt_kernel(t, causal):
    """fp32, B=2 H=2 hs=64: the port's _FlashAttn backward (its plain version
    on CPU) against jax.grad of flash_attention_dt in interpret mode, whose
    VJP is _bwd_dt_kernel; dq, dk, dv within 1e-5."""
    import jax

    b, h, hs = 2, 2, 64
    q, k, v = _qkv(b, t, h, hs, seed=3)
    g = np.random.RandomState(4).randn(b, t, h, hs).astype(np.float32)

    def loss(q, k, v):
        o = jfa.flash_attention_dt(_to_dt(q), _to_dt(k), _to_dt(v), b=b, causal=causal,
                                   interpret=True)
        return jnp.sum(jnp.asarray(o) * _to_dt(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _port_grads(q, k, v, g, causal)
    assert fa.flash_attention_backward.launches == 0  # CPU tensors: the plain version
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a, np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=f"d{name}")


def test_backward_ragged_t_matches_autograd_of_reference():
    """T=200 (no tile multiple), causal, fp32: the plain backward against
    autograd through flash_attention_reference, within 1e-5."""
    q, k, v = _qkv(2, 200, 3, 64, seed=5)
    g = np.random.RandomState(6).randn(*q.shape).astype(np.float32)
    got = _port_grads(q, k, v, g, True)
    want = _port_grads(q, k, v, g, True,
                       fn=lambda *a, causal: fa.flash_attention_reference(*a, causal=causal)[0])
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-5, err_msg=f"d{name}")


def test_lse_is_not_differentiable():
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(1, 64, 1, 64, seed=7))
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    assert o.requires_grad and not lse.requires_grad


@pytest.mark.parametrize("causal", [True, False])
def test_f32_forward_matches_jax_dt_kernel(causal):
    """flash_forward_f32, the fp32 kernel's wrapper, on CPU tensors (its plain
    version) against _fwd_dt_kernel on fp32 operands: out and lse within
    1e-5, o in fp32."""
    b, t, h, hs = 2, 256, 2, 64
    q, k, v = _qkv(b, t, h, hs, seed=4)
    bq = jfa._dt_block(t, jfa.DEFAULT_BLOCK_Q)
    o_dt, lse_dt = jfa._fwd_dt(
        _to_dt(q) * (1.0 / hs**0.5), _to_dt(k), _to_dt(v), b=b, t=t,
        causal=causal, bq=bq, bk=bq, interpret=True,
    )
    assert o_dt.dtype == jnp.float32
    want_o = np.asarray(o_dt).reshape(h, hs, b, t).transpose(2, 3, 0, 1)
    want_lse = np.asarray(lse_dt)[:, 0, :].reshape(h, b, t).transpose(1, 0, 2)
    o, lse = fa.flash_forward_f32(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert fa.flash_forward_f32.launches == 0 and o.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), want_o, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-5)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports is_cuda, so that the routers take the card's
    routes; the launchers are replaced by recording stubs."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize(
    "dtype, tq, tk, grad, want",
    [(torch.float32, 1024, 1024, False, "f32"),     # eval_quality's HellaSwag at fp32
     (torch.float32, 1000, 1000, False, "f32"),     # ragged T
     (torch.bfloat16, 1024, 1024, False, "bf16"),
     (torch.bfloat16, 1024, 1024, True, "bf16"),
     (torch.float32, 1024, 1024, True, NotImplementedError),  # no fp32 backward
     (torch.float32, 64, 1024, False, ValueError)],  # the general family takes bf16
)
def test_fp32_routing_with_stubs(monkeypatch, dtype, tq, tk, grad, want):
    """sdpa(impl='auto') and flash_attention on operands that report the card:
    fp32 q of the self-attention family goes to the fp32 forward kernel, bf16
    to the bf16 one; fp32 that needs a gradient raises before any launch, and
    so does fp32 q of the general family."""
    calls = []

    def stub(name):
        def launch(q, k, v, *, causal=True):
            calls.append(name)
            plain = [a.as_subclass(torch.Tensor) for a in (q, k, v)]
            return fa.flash_attention_reference(*plain, causal=causal)
        return launch

    monkeypatch.setattr(fa, "flash_forward_f32", stub("f32"))
    monkeypatch.setattr(fa, "flash_fwd_cuda", stub("bf16"))
    rng = np.random.RandomState(9)
    q = torch.from_numpy(rng.randn(1, tq, 2, 64).astype(np.float32)).to(dtype)
    kv = torch.from_numpy(rng.randn(1, tk, 4, 64).astype(np.float32)).to(dtype)
    q, k, v = (a.as_subclass(_OnCard) for a in (q, kv[:, :, :2], kv[:, :, 2:]))
    if grad:
        q.requires_grad_(True)
    if isinstance(want, type):
        with pytest.raises(want):
            attention.sdpa(q, k, v, causal=True, impl="flash", layout="bthd")
        assert calls == []
        return
    got = attention.sdpa(q, k, v, causal=True, layout="bthd")  # auto: T >= 512
    assert calls == [want]
    ref = fa.flash_attention_reference(*[a.as_subclass(torch.Tensor).detach() for a in (q, k, v)],
                                       causal=True)[0]
    torch.testing.assert_close(got.as_subclass(torch.Tensor).detach(), ref)
