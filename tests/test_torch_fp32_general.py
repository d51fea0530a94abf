"""The fp32 cases of the general and lse flash families of the PyTorch port
(csrc/flash_general_fwd_f32.cu, flash_general_bwd_f32.cu and the fp32 D of
flash_bwd_f32.cu): their wrappers on CPU tensors (the plain versions)
against the JAX package's streamed and resident-K/V Pallas kernels in
interpret mode on fp32 operands; the routing by dtype inside each family,
with recording stubs for the launchers on tensors that report the card; the
operand check that the ring's chunk views and the fused QKV view pass; and
chip_smoke.py's phase 10b / 15b check helpers with their three controls (a
left-aligned causal mask, the last key tile dropped at a ragged Tk, the lse
cotangent dropped), each of which must fail the check that the right plain
output passes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gpt2_vision_language_tpu.ops import flash_attention as jfa
from gpt2_vision_language_tpu_torch.ops import attention
from gpt2_vision_language_tpu_torch.ops import flash_attention as fa

B, H, HS = 2, 2, 64
BLOCK = 128  # JAX tile size: several key tiles per sweep at these lengths


def _qkv(tq, tk, seed=0, h=H):
    """q, dO (B, Tq, H, hs), k and v (B, Tk, H, hs), fp32, from a numpy seed."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, t, h, HS).astype(np.float32) for t in (tq, tk, tk, tq))
    return q, k, v, do


def _bhtd(a):
    return jnp.asarray(a.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("stream_kv, fwd", [(True, "flash_general_forward_f32"),
                                            (False, "flash_lse_forward_f32")])
@pytest.mark.parametrize("tq, tk, causal", [(130, 385, True), (130, 385, False), (1, 193, True)])
def test_f32_forward_wrappers_match_jax(tq, tk, causal, stream_kv, fwd):
    """K2b's (stream_kv=True, _fwd_kernel_grid) and K2a's (stream_kv=False,
    _fwd_kernel) fp32 wrappers on CPU tensors: o and lse within 2e-5 of the
    JAX kernels on fp32 operands, o fp32, no launch counted."""
    q, k, v, _ = _qkv(tq, tk, seed=tq + tk)
    want_o, want_lse = jfa._fwd(_bhtd(q), _bhtd(k), _bhtd(v), causal=causal, bq=BLOCK,
                                bk=BLOCK, stream_kv=stream_kv, interpret=True)
    assert want_o.dtype == jnp.float32
    launcher = getattr(fa, fwd)
    o, lse = launcher(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert launcher.launches == 0 and o.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o).transpose(0, 2, 1, 3),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse).reshape(B, H, tq),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("stream_kv", [True, False])
def test_f32_general_backward_wrapper_matches_jax(stream_kv, causal):
    """The fp32 general backward's wrapper (K3a's and K3b's functions) with D
    from the fp32 D wrapper, on CPU tensors (the plain version of the
    one-pass kernel that csrc/flash_general_bwd_f32.cu runs), against
    jax.grad through JAX's streamed kernels (stream_kv=True: _dq_kernel_grid,
    _dkv_kernel_grid) and through its one-pass backward with no lse
    cotangent (stream_kv=False: _bwd_kernel_fused), interpret mode, at
    Tq != Tk, causal and unmasked: dq, dk, dv within 2e-5."""
    tq, tk = 130, 385
    q, k, v, g = _qkv(tq, tk, seed=11)

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK,
                                block_q_bwd=BLOCK, block_k_bwd=BLOCK, stream_kv=stream_kv,
                                interpret=True, layout="bthd")
        return jnp.sum(o * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq_, tk_, tv_, tg = map(torch.from_numpy, (q, k, v, g))
    o, lse = fa.flash_general_forward_f32(tq_, tk_, tv_, causal=causal)
    dd = fa.flash_rowdot_f32(tg, o)
    got = fa.flash_general_backward_f32(tq_, tk_, tv_, tg, lse, dd, causal=causal)
    assert fa.flash_rowdot_f32.launches == fa.flash_general_backward_f32.launches == 0
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5,
                                   err_msg=f"d{name}")


def test_f32_one_pass_backward_with_lse_cotangent_matches_jax():
    """The fp32 one-pass backward's wrapper (K3c's function) on CPU tensors,
    given dcap = D - dlse with a random lse cotangent, against jax.grad of
    sum(out * w) + sum(lse * u) through JAX flash_attention_with_lse in
    interpret mode at Tq != Tk (130, 385), causal: the tolerances of
    tests/test_torch_flash_lse.py. Without the cotangent the gradients are
    others."""
    tq, tk = 130, 385
    q, k, v, w = _qkv(tq, tk, seed=13)
    u = np.random.RandomState(14).randn(B, H, tq).astype(np.float32)

    def loss(q, k, v):
        out, lse = jfa.flash_attention_with_lse(q, k, v, causal=True, interpret=True)
        return jnp.sum(out * _bhtd(w)) + jnp.sum(lse[..., 0] * jnp.asarray(u))

    want = jax.grad(loss, argnums=(0, 1, 2))(_bhtd(q), _bhtd(k), _bhtd(v))
    tq_, tk_, tv_, tw = map(torch.from_numpy, (q, k, v, w))
    o, lse = fa.flash_lse_forward_f32(tq_, tk_, tv_, causal=True)
    dd = fa.flash_rowdot(tw, o)
    got = fa.flash_fused_backward_f32(tq_, tk_, tv_, tw, lse, dd - torch.from_numpy(u),
                                      causal=True)
    for name, a, r in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(r).transpose(0, 2, 1, 3),
                                   rtol=5e-4, atol=5e-5, err_msg=f"d{name}")
    without = fa.flash_fused_backward_f32(tq_, tk_, tv_, tw, lse, dd, causal=True)
    assert not torch.allclose(got[0], without[0], rtol=1e-3, atol=1e-3)
    assert fa.flash_fused_backward_f32.launches == fa.flash_lse_forward_f32.launches == 0


class _OnCard(torch.Tensor):
    """A CPU tensor that reports is_cuda, so that the routers take the card's
    routes; the launchers are replaced by recording stubs."""

    @property
    def is_cuda(self):
        return True


def _plain(*xs):
    return [x.as_subclass(torch.Tensor) if x is not None else None for x in xs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family, tq, tk, stream_kv", [("general", 64, 256, None),
                                                       ("general", 256, 256, True),
                                                       ("lse", 64, 256, False)])
def test_routing_by_dtype_with_stubs(monkeypatch, dtype, family, tq, tk, stream_kv):
    """flash_attention on operands that report the card, forward and
    backward: inside the general and the lse family fp32 q reaches the fp32
    launchers (the forward, the fp32 D, the fp32 backward on D or on D -
    dlse) and bf16 q the bf16 ones; nothing else is called."""
    calls = []

    def fwd(name):
        def launch(q, k, v, *, causal=True):
            calls.append(name)
            o, lse = fa.flash_attention_reference(*_plain(q, k, v), causal=causal)
            return o.as_subclass(_OnCard), lse.as_subclass(_OnCard)
        return launch

    def bwd(name, part=slice(None)):
        def launch(q, k, v, do, lse, dd, *, causal=True):
            calls.append(name)
            out = fa.flash_attention_backward_reference(*_plain(q, k, v), None,
                                                        *_plain(lse, do), causal=causal,
                                                        dd=_plain(dd)[0])[part]
            return out if isinstance(part, int) else tuple(out)
        return launch

    def rowdot(name):
        def launch(do, o):
            calls.append(name)
            return fa.rowdot_reference(*_plain(do, o)).as_subclass(_OnCard)
        return launch

    for name in ("flash_general_forward_f32", "flash_general_forward",
                 "flash_lse_forward_f32", "flash_lse_forward"):
        monkeypatch.setattr(fa, name, fwd(name))
    for name in ("flash_general_backward_f32", "flash_fused_backward_f32",
                 "flash_fused_backward"):
        monkeypatch.setattr(fa, name, bwd(name))
    monkeypatch.setattr(fa, "flash_general_dq", bwd("flash_general_dq", 0))
    monkeypatch.setattr(fa, "flash_general_dkv", bwd("flash_general_dkv", slice(1, 3)))
    monkeypatch.setattr(fa, "flash_rowdot_f32", rowdot("flash_rowdot_f32"))
    if dtype == torch.bfloat16:  # the bf16 D launches inline: its wrapper is the stub
        monkeypatch.setattr(fa, "flash_rowdot", rowdot("flash_rowdot"))
    q, k, v, g = (torch.from_numpy(a).to(dtype).as_subclass(_OnCard)
                  for a in _qkv(tq, tk, seed=21))
    q.requires_grad_(True)
    o = fa.flash_attention(q, k, v, causal=True, stream_kv=stream_kv)
    o.backward(g)
    f32 = dtype == torch.float32
    want = {
        ("general", True): ["flash_general_forward_f32", "flash_rowdot_f32",
                            "flash_general_backward_f32"],
        ("general", False): ["flash_general_forward", "flash_rowdot", "flash_general_dq",
                             "flash_general_dkv"],
        ("lse", True): ["flash_lse_forward_f32", "flash_rowdot_f32", "flash_fused_backward_f32"],
        ("lse", False): ["flash_lse_forward", "flash_rowdot", "flash_fused_backward"],
    }[family, f32]
    assert calls == want
    plain = [a.as_subclass(torch.Tensor).detach().float() for a in (q, k, v, g)]
    ref_o, ref_lse = fa.flash_attention_reference(*plain[:3], causal=True)
    dq = fa.flash_attention_backward_reference(*plain[:3], ref_o, ref_lse, plain[3],
                                               causal=True)[0]
    tol = {} if f32 else {"rtol": 2e-2, "atol": 2e-2}
    torch.testing.assert_close(q.grad.as_subclass(torch.Tensor).float(), dq, **tol)


def test_sdpa_routes_fp32_long_context_to_the_fp32_general_kernels(monkeypatch):
    """sdpa(impl='auto') on fp32 operands past K1_MAX_T (lowered here) sends
    the model's long-context attention to the fp32 general forward, not the
    bf16 one and not the plain version."""
    calls = []

    def launch(q, k, v, *, causal=True):
        calls.append("flash_general_forward_f32")
        return fa.flash_attention_reference(*_plain(q, k, v), causal=causal)

    monkeypatch.setattr(fa, "flash_general_forward_f32", launch)
    monkeypatch.setattr(fa, "K1_MAX_T", 512)
    q, k, v, _ = (torch.from_numpy(a).as_subclass(_OnCard) for a in _qkv(576, 576, seed=23))
    attention.sdpa(q, k, v, causal=True, layout="bthd")
    assert calls == ["flash_general_forward_f32"]


def test_f32_operand_check_takes_the_ring_and_fused_qkv_views():
    """_check_f32_operand, the check every fp32 kernel's wrapper makes: the
    strided views of a fused fp32 QKV projection and the ring's chunk views
    of it pass without a copy; bf16, a hs stride of 2 and a base pointer off
    16 bytes do not."""
    b, t, h, n = 1, 256, 12, 4
    qkv = torch.randn(b, t, 3 * h * HS)
    q, k, v = (a.view(b, t, h, HS) for a in qkv.split(h * HS, dim=-1))
    c = t // n
    for a in (q, k, v, q[:, 3 * c:], k[:, c:2 * c], v[:, :c]):
        fa._check_f32_operand("x", a)
    cq, ck, cv, _, _ = chip_smoke.chunk_views(torch, 1, 64, 128, h, torch.device("cpu"),
                                              torch.Generator().manual_seed(0),
                                              dtype=torch.float32)
    for a in (cq, ck, cv):
        fa._check_f32_operand("x", a)
    wide = torch.randn(b, t, h, 2 * HS)
    for bad in (q.to(torch.bfloat16), wide[..., ::2], qkv[..., 1:].unfold(-1, HS, HS)[..., :h, :]):
        with pytest.raises(ValueError):
            fa._check_f32_operand("x", bad)


# ---- chip_smoke.py's phase 10b / 15b helpers and their controls -----------------


def _case(tq, tk, causal, seed, h=4):
    q, k, v, do = map(torch.from_numpy, _qkv(tq, tk, seed=seed, h=h))
    o, lse = fa.flash_attention_reference(q, k, v, causal=causal)
    dd = fa.rowdot_reference(do, o)
    got = chip_smoke.bwd_by_heads(torch, fa, q, k, v, None, lse, do, causal, dd=dd)
    return q, k, v, do, o, lse, dd, got


def test_general_hide_is_the_right_aligned_mask():
    """general_hide without a fault is _causal_mask (right-aligned); the
    left-aligned one agrees with it only where Tq == Tk; dropping the last
    key tile hides keys from (Tk - 1) // 64 * 64 on."""
    dev = torch.device("cpu")
    for tq, tk in ((130, 385), (64, 64), (1, 193)):
        assert torch.equal(chip_smoke.general_hide(torch, tq, tk, True, dev),
                           fa._causal_mask(tq, tk, dev))
        left = chip_smoke.general_hide(torch, tq, tk, True, dev, left=True)
        assert torch.equal(left, fa._causal_mask(tq, tk, dev)) == (tq == tk)
    drop = chip_smoke.general_hide(torch, 10, 4133, False, dev, drop_last_tile=True)
    assert drop[:, 4096:].all() and not drop[:, :4096].any()


@pytest.mark.parametrize("tq, tk, causal, fault", [(130, 385, True, "left"),
                                                    (100, 300, True, "drop_last_tile"),
                                                    (100, 300, False, "drop_last_tile")])
def test_general_controls_fail_the_row_rules(tq, tk, causal, fault):
    """The plain output passes phase 10b's row rules against the plain
    version with the right mask; the left-aligned mask at Tq != Tk and the
    last key tile dropped at a ragged Tk fail both the forward's and the
    backward's."""
    q, k, v, do, o, lse, dd, got = _case(tq, tk, causal, seed=31)
    dev = torch.device("cpu")
    right = chip_smoke.general_hide(torch, tq, tk, causal, dev)
    fwd_ok, bwd_ok = chip_smoke.f32_control_errs(torch, q, k, v, do, lse, dd, o, got, right)
    assert fwd_ok <= chip_smoke.F32_ROW_TOL and bwd_ok <= chip_smoke.F32_ROW_TOL
    rels, rows = chip_smoke.f32_bwd_errs(got, got, False)
    assert max(rels) == max(rows) == 0.0
    hide = chip_smoke.general_hide(torch, tq, tk, causal, dev, **{fault: True})
    fwd_c, bwd_c = chip_smoke.f32_control_errs(torch, q, k, v, do, lse, dd, o, got, hide)
    assert fwd_c > chip_smoke.F32_ROW_TOL and bwd_c > chip_smoke.F32_ROW_TOL


@pytest.mark.parametrize("causal", [False, True])
def test_dropped_lse_cotangent_fails_the_row_rule(causal):
    """Phase 15b's control: the one-pass backward on dcap = D - dlse against
    the plain backward on D alone fails the row rule that the plain backward
    on dcap passes."""
    q, k, v, do, o, lse, dd, _ = _case(128, 128, causal, seed=37)
    dlse = torch.from_numpy(np.random.RandomState(38).randn(B, 4, 128).astype(np.float32))
    dcap = dd - dlse
    got = fa.flash_fused_backward_f32(q, k, v, do, lse, dcap, causal=causal)
    want = chip_smoke.bwd_by_heads(torch, fa, q, k, v, None, lse, do, causal, dd=dcap)
    _, rows = chip_smoke.f32_bwd_errs(got, want, causal)
    assert max(rows) <= chip_smoke.F32_ROW_TOL
    ctrl = chip_smoke.bwd_by_heads(torch, fa, q, k, v, None, lse, do, causal, dd=dd)
    assert max(chip_smoke.f32_row_err(x, r) for x, r in zip(got, ctrl)) > chip_smoke.F32_ROW_TOL
