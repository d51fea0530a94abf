"""The port's dt-layout A/B tool: its plain forward and backward against the
TPU tool's Pallas kernels in interpret mode on the same inputs (made from a
seed with numpy), the layout helpers, the checks on the CPU, and the wrappers'
refusals."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu_torch.ops.flash_attention import flash_attention_reference
from gpt2_vision_language_tpu_torch.tools import ab_dt_flash as ab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, T, HS = 2, 2, 256, 64


@pytest.fixture(scope="module")
def jax_tool():
    """tools/ab_dt_flash.py of the repository, imported by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_ab_dt_flash", os.path.join(ROOT, "tools", "ab_dt_flash.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, T, H, HS).astype(np.float32) for _ in range(4))
    to_dt = lambda x: np.ascontiguousarray(x.transpose(2, 3, 0, 1).reshape(H, HS, B * T))  # noqa: E731
    return (q, k, v, do), tuple(to_dt(a) for a in (q * HS ** -0.5, k, v, do))


@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_matches_the_tpu_kernel(jax_tool, causal):
    """o within 2e-5 (the TPU tool's own limit), lse within 2e-5 and equal to
    row 0 of the TPU kernel's eight replicated rows."""
    _, (qd, kd, vd, _) = _inputs(0)
    jo, jlse = jax_tool.flash_fwd_dt_b(jnp.asarray(qd), jnp.asarray(kd), jnp.asarray(vd), B, T, T,
                                       causal=causal, bq=128, bk=128, interpret=True)
    o, lse = ab.flash_fwd_dt_b(*(torch.from_numpy(a) for a in (qd, kd, vd)), B, T, T,
                               causal=causal)
    assert tuple(o.shape) == (H, HS, B * T) and tuple(lse.shape) == (H, B * T)
    assert jlse.shape == (H, 8, B * T)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, 0, :], atol=2e-5, rtol=0)
    assert np.array_equal(np.asarray(jlse)[:, 0, :], np.asarray(jlse)[:, 7, :])


@pytest.mark.parametrize("b,tq,tk", [(2, 128, 256), (2, 192, 192)])
def test_plain_forward_matches_the_tpu_kernel_at_checked_shapes(jax_tool, b, tq, tk):
    """The yardstick of chip_smoke's P1 shapes, in 64-position blocks (the
    CUDA kernel's box): Tq != Tk under the causal mask, which has no offset
    (query i sees keys <= i), and a T that is an odd multiple of 64 (a
    sequence ends in half a 128-row tile, and the next one starts where
    zeros belong). o and lse within 2e-5 of the TPU kernel in interpret
    mode."""
    rng = np.random.RandomState(9)
    to_dt = lambda x: np.ascontiguousarray(x.transpose(2, 3, 0, 1).reshape(H, HS, -1))  # noqa: E731
    qd = to_dt(rng.randn(b, tq, H, HS).astype(np.float32) * HS ** -0.5)
    kd, vd = (to_dt(rng.randn(b, tk, H, HS).astype(np.float32)) for _ in range(2))
    jo, jlse = jax_tool.flash_fwd_dt_b(jnp.asarray(qd), jnp.asarray(kd), jnp.asarray(vd), b, tq,
                                       tk, causal=True, bq=64, bk=64, interpret=True)
    o, lse = ab.flash_fwd_dt_b(*(torch.from_numpy(a) for a in (qd, kd, vd)), b, tq, tk,
                               causal=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, 0, :], atol=2e-5, rtol=0)
    if tq != tk:
        # the no-offset mask: the last query sees the first tq keys only
        q_last = torch.from_numpy(qd).reshape(H, HS, b, tq)[..., -1].float()
        k_first = torch.from_numpy(kd).reshape(H, HS, b, tk)[..., :tq].float()
        want = torch.logsumexp(torch.einsum("hdb,hdbk->hbk", q_last, k_first), dim=-1)
        np.testing.assert_allclose(lse.reshape(H, b, tq)[..., -1].numpy(), want.numpy(),
                                   atol=2e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_the_tpu_kernel(jax_tool, causal):
    """dq, dk, dv within 1e-5 of max|ref| (the TPU tool's own limit), from the
    same lse and dcap."""
    _, (qd, kd, vd, dod) = _inputs(1)
    scale = HS ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (qd, kd, vd, dod))
    jo, jlse = jax_tool.flash_fwd_dt_b(jq, jk, jv, B, T, T, causal=causal, bq=128, bk=128,
                                       interpret=True)
    jdcap = jnp.sum(jo * jdo, axis=1, keepdims=True)
    want = jax_tool.flash_bwd_dt_b(jq, jk, jv, jdo, jlse, jdcap, B, T, T, causal=causal, bq=128,
                                   bk=128, dq_scale=scale, interpret=True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (qd, kd, vd, dod))
    o, lse = ab.flash_fwd_dt_b(tq, tk, tv, B, T, T, causal=causal)
    dcap = ab.dcap_dt(o, tdo)
    np.testing.assert_allclose(dcap.numpy(), np.asarray(jdcap)[:, 0, :], atol=2e-5, rtol=0)
    got = ab.flash_bwd_dt_b(tq, tk, tv, tdo, lse, dcap, B, T, T, causal=causal, dq_scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * float(np.abs(w).max()), name
    # dq_scale multiplies dq and nothing else
    unscaled = ab.flash_bwd_dt_b(tq, tk, tv, tdo, lse, dcap, B, T, T, causal=causal)
    assert torch.allclose(unscaled[0] * scale, got[0], atol=1e-6)
    assert torch.equal(unscaled[1], got[1]) and torch.equal(unscaled[2], got[2])


@pytest.mark.parametrize("b,tq,tk", [(2, 128, 256), (1, 192, 128)])
def test_plain_backward_matches_the_tpu_kernel_at_tq_ne_tk(jax_tool, b, tq, tk):
    """The backward at Tq != Tk under the mask without offset (query i sees
    keys <= i: with Tq < Tk the last keys see no query and get zero dk, dv;
    with Tq > Tk the last queries see every key), in 64-position blocks:
    dq, dk, dv within 1e-5 of max|ref| of the TPU kernel in interpret mode,
    from the same lse and dcap."""
    rng = np.random.RandomState(12)
    to_dt = lambda x: np.ascontiguousarray(x.transpose(2, 3, 0, 1).reshape(H, HS, -1))  # noqa: E731
    qd, dod = (to_dt(rng.randn(b, tq, H, HS).astype(np.float32)) for _ in range(2))
    qd = qd * HS ** -0.5
    kd, vd = (to_dt(rng.randn(b, tk, H, HS).astype(np.float32)) for _ in range(2))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (qd, kd, vd, dod))
    jo, jlse = jax_tool.flash_fwd_dt_b(jq, jk, jv, b, tq, tk, causal=True, bq=64, bk=64,
                                       interpret=True)
    jdcap = jnp.sum(jo * jdo, axis=1, keepdims=True)
    want = jax_tool.flash_bwd_dt_b(jq, jk, jv, jdo, jlse, jdcap, b, tq, tk, causal=True, bq=64,
                                   bk=64, dq_scale=HS ** -0.5, interpret=True)
    tq_, tk_, tv_, tdo = (torch.from_numpy(a) for a in (qd, kd, vd, dod))
    lse = torch.from_numpy(np.array(jlse)[:, 0, :])
    dcap = torch.from_numpy(np.array(jdcap)[:, 0, :])
    got = ab.flash_bwd_dt_b(tq_, tk_, tv_, tdo, lse, dcap, b, tq, tk, causal=True,
                            dq_scale=HS ** -0.5)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * float(np.abs(w).max()), name
    if tq < tk:
        assert not got[1].reshape(H, HS, b, tk)[..., tq:].any()


def test_dt_side_equals_the_shipping_paths_plain_version():
    """Side B's plain versions against side A's (flash_attention_reference and
    its autograd gradients) on the same values, through the layout helpers."""
    (q, k, v, do), (qd, kd, vd, dod) = _inputs(2)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o_ref, lse_ref = flash_attention_reference(tq, tk, tv, causal=True)
    refs = torch.autograd.grad((o_ref * torch.from_numpy(do)).sum(), (tq, tk, tv))
    dts = [torch.from_numpy(a) for a in (qd, kd, vd, dod)]
    o, lse = ab.flash_fwd_dt_b(*dts[:3], B, T, T)
    np.testing.assert_allclose(ab.from_dt(o, B, T).numpy(), o_ref.detach().numpy(), atol=2e-5)
    # lse: (H, B*T) against (B, H, T)
    np.testing.assert_allclose(lse.reshape(H, B, T).permute(1, 0, 2).numpy(),
                               lse_ref.detach().numpy(), atol=2e-5)
    got = ab.flash_bwd_dt_b(*dts, lse, ab.dcap_dt(o, dts[3]), B, T, T, dq_scale=HS ** -0.5)
    for g, r in zip(got, refs):
        assert float((ab.from_dt(g, B, T) - r).abs().max()) <= 1e-5 * float(r.abs().max())


def test_layout_helpers_round_trip():
    x = torch.arange(B * T * H * HS, dtype=torch.float32).reshape(B, T, H, HS)
    d = ab.to_dt(x)
    assert tuple(d.shape) == (H, HS, B * T) and d.is_contiguous()
    assert float(d[1, 3, 1 * T + 5]) == float(x[1, 5, 1, 3])  # b-major slabs of T positions
    assert torch.equal(ab.from_dt(d, B, T), x)
    # a strided view of a fused QKV output goes in without trouble
    qkv = torch.randn(B, T, 3 * H * HS, generator=torch.Generator().manual_seed(0))
    k = qkv.split(H * HS, dim=-1)[1].view(B, T, H, HS)
    assert torch.equal(ab.from_dt(ab.to_dt(k), B, T), k)


def test_checks_run_the_plain_versions_on_the_cpu(capsys):
    """--check and --check-bwd at the TPU tool's (2, 3, 1024, 64) fp32 shape
    and limits; the launch counts stay 0 on CPU tensors."""
    err = ab.main(["--check", "--device", "cpu"])
    rels = ab.main(["--check-bwd", "--device", "cpu"])
    out = capsys.readouterr().out
    assert err < 2e-5 and max(rels.values()) < 1e-5 and out.count("OK") == 2
    assert ab.flash_fwd_dt_b.launches == ab.flash_bwd_dt_b.launches == 0


def test_refusals():
    """No silent CPU for the device modes, no misaligned or mis-shaped input."""
    if not torch.cuda.is_available():
        for argv in ([], ["--bwd"], ["--check"], ["--check-bwd"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                ab.main(argv)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        ab.main(["--device", "cpu"])
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        ab.bench_bwd("cpu")
    q = torch.zeros(H, HS, B * T)
    with pytest.raises(ValueError, match="dt layout"):
        ab.flash_fwd_dt_b(q, q[:, :, :-1], q, B, T, T)
    with pytest.raises(ValueError, match="lse and dcap"):
        ab.flash_bwd_dt_b(q, q, q, q, torch.zeros(H, 8, B * T), torch.zeros(H, B * T), B, T, T)
    bf = q.to(torch.bfloat16)
    ok_stats = torch.zeros(H, B * T)
    with pytest.raises(ValueError, match="multiples of 64"):
        ab._check_kernel((("q", bf),), (), 100, 128)
    with pytest.raises(ValueError, match="bf16"):
        ab._check_kernel((("q", q),), (), 128, 128)
    with pytest.raises(ValueError, match="fp32"):
        ab._check_kernel((("q", bf),), (("lse", ok_stats.double()),), 128, 128)
    with pytest.raises(ValueError, match="head size"):
        ab._check_kernel((("q", torch.zeros(H, 32, 128, dtype=torch.bfloat16)),), (), 128, 128)


def test_kernel_sources_and_signatures_are_registered():
    from gpt2_vision_language_tpu_torch import _build

    names = {p.name for p in _build.sources()}
    # thirteen sources since the fp32 self-attention forward (flash_fwd_f32.cu)
    assert {"flash_dt_fwd.cu", "flash_dt_bwd.cu"} <= names and len(names) == 13
    assert len(_build.SIGNATURES["gpt2vl_flash_dt_fwd"]) == 12
    assert len(_build.SIGNATURES["gpt2vl_flash_dt_bwd"]) == 17
    for name in ("flash_dt_fwd", "flash_dt_bwd"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int gpt2vl_{name}(' in src and "tools/ab_dt_flash.py" in src
