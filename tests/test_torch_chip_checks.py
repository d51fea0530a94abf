"""The row checks of chip_smoke.py on plain CPU tensors.

chip_smoke.py holds the attention kernels' o row by row (``row_excess``)
and their dq, dk and dv row by row (``grad_row_excess``), beside the
elementwise checks, because a kernel that stops a sweep early, or starts it
late, moves a small row by much of its norm and stays under an absolute or
max-relative tolerance. These tests hold the two checks and the control
helpers (``dkv_reference``, ``dq_reference``) to that at a small size, one
head, with the port's plain versions: the faults they must see fail them,
and the plain bf16 result passes them against its own fp32 evaluation."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from gpt2_vision_language_tpu_torch.ops import flash_attention as fa
from gpt2_vision_language_tpu_torch.ops import fused_ce as fc
from gpt2_vision_language_tpu_torch.tools import ab_dt_flash as ab

T, H, HS = 1024, 1, 64


def _inputs(seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(1, T, H, HS).astype(np.float32)).to(torch.bfloat16)
                   for _ in range(4))
    return q, k, v, do


def _backward(q, k, v, do, causal):
    """(dk, dv) of the plain backward on the operands' dtype, lse and D from
    the fp32 forward of the same bf16 values."""
    o32, lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), causal=causal)
    dd = fa.rowdot_reference(do.float(), o32)
    return fa.flash_attention_backward_reference(q, k, v, None, lse, do, causal=causal,
                                                 dd=dd)[1:], (lse, dd)


@pytest.mark.parametrize("causal", [True, False])
def test_o_without_last_key_tile_fails_row_check(causal):
    q, k, v, _ = _inputs(0)
    o = fa.flash_attention_reference(q, k, v, causal=causal)[0]
    r = slice(T - 128, T)
    dropped = fa.flash_attention_reference(q[:, r], k[:, :T - 128], v[:, :T - 128],
                                           causal=False)[0]
    _, over = cs.row_excess(dropped, o[:, r])
    assert over > 0


@pytest.mark.parametrize("causal", [True, False])
def test_dkv_reference_matches_plain_backward(causal):
    q, k, v, do = _inputs(1)
    (dk, dv), (lse, dd) = _backward(q, k, v, do, causal)
    rk, rv = cs.dkv_reference(torch, q, k, v, do, lse, dd, causal)
    assert torch.equal(rk, dk) and torch.equal(rv, dv)


def test_dkv_short_sweep_fails_row_check():
    """The fault the row check is for: dk/dv whose key tiles stop their query
    sweep 512 rows on."""
    q, k, v, do = _inputs(2)
    (dk, dv), (lse, dd) = _backward(q, k, v, do, True)
    sk, sv = cs.dkv_reference(torch, q, k, v, do, lse, dd, True, drop_after=512)
    assert cs.grad_row_excess(sk, dk)[1] > 0 and cs.grad_row_excess(sv, dv)[1] > 0


@pytest.mark.parametrize("causal", [True, False])
def test_plain_bf16_passes_row_checks(causal):
    """The plain version on bf16 operands against the same values in fp32:
    o, dk and dv pass the row checks and the elementwise ones."""
    q, k, v, do = _inputs(3)
    o = fa.flash_attention_reference(q, k, v, causal=causal)[0]
    o32 = fa.flash_attention_reference(q.float(), k.float(), v.float(), causal=causal)[0]
    assert cs.row_excess(o, o32)[1] <= 0 and cs.out_excess(o, o32)[1] <= 0
    (dk, dv), (lse, dd) = _backward(q, k, v, do, causal)
    dk32, dv32 = fa.flash_attention_backward_reference(
        q.float(), k.float(), v.float(), None, lse, do.float(), causal=causal, dd=dd)[1:]
    for x, ref in ((dk, dk32), (dv, dv32)):
        assert cs.grad_row_excess(x, ref)[1] <= 0 and cs.rel_err(x, ref) <= 3e-2


def test_o_late_start_fails_row_check_not_elementwise():
    """The fault of phase 2's control: the last 128 rows at T=8192 (the
    longest self-attention the first family takes) without their first key
    tile. The row check fails it; the elementwise check, whose 2e-2 floor is
    above a typical late |o| (about 0.012), passes it. Only the 128 rows are
    formed, against all 8192 keys."""
    t = 8192
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, t, H, HS).astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    r = slice(t - 128, t)
    o = fa.flash_attention_reference(q[:, r], k, v, causal=True)[0]
    late = fa.flash_attention_reference(q[:, r], k[:, 128:], v[:, 128:], causal=True)[0]
    assert cs.row_excess(late, o)[1] > 0
    assert cs.out_excess(late, o)[1] <= 0


def _dq(q, k, v, do, causal):
    """dq of the plain backward on the operands' dtype, and (lse, D) from the
    fp32 forward of the same bf16 values."""
    o32, lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), causal=causal)
    dd = fa.rowdot_reference(do.float(), o32)
    return fa.flash_attention_backward_reference(q, k, v, None, lse, do, causal=causal,
                                                 dd=dd)[0], (lse, dd)


@pytest.mark.parametrize("causal", [True, False])
def test_dq_reference_matches_plain_backward(causal):
    q, k, v, do = _inputs(5)
    dq, (lse, dd) = _dq(q, k, v, do, causal)
    assert torch.equal(cs.dq_reference(torch, q, k, v, do, lse, dd, causal), dq)


def test_dq_late_start_fails_row_check_not_max_relative():
    """The fault the dq row check is for: query tiles that start their key
    sweep late. At T=2048, dropping the 8 keys more than 1912 before the last
    query tile already moves some of its rows by a quarter of their norm,
    and stays inside 3e-2 of max|ref|, the check that held dq before."""
    t = 2048
    rng = np.random.RandomState(4)
    q, k, v, do = (torch.from_numpy(rng.randn(1, t, H, HS).astype(np.float32)).to(torch.bfloat16)
                   for _ in range(4))
    dq, (lse, dd) = _dq(q, k, v, do, True)
    late = cs.dq_reference(torch, q, k, v, do, lse, dd, True, drop_before=1912)
    assert cs.grad_row_excess(late, dq)[1] > 0
    assert cs.rel_err(late, dq) <= 3e-2


@pytest.mark.parametrize("causal", [True, False])
def test_plain_bf16_dq_passes_row_check(causal):
    """The plain dq on bf16 operands against the same values in fp32 passes
    the row check and the check against max|ref|."""
    q, k, v, do = _inputs(6)
    dq, (lse, dd) = _dq(q, k, v, do, causal)
    dq32 = fa.flash_attention_backward_reference(
        q.float(), k.float(), v.float(), None, lse, do.float(), causal=causal, dd=dd)[0]
    assert cs.grad_row_excess(dq, dq32)[1] <= 0 and cs.rel_err(dq, dq32) <= 3e-2


@pytest.fixture(scope="module")
def k1_max_t():
    """Phase 6's longest shape, one head: B=1, T=8192 (K1_MAX_T) bf16 inputs
    drawn as the phase draws them (normal values), lse and D from the fp32
    forward, and the plain backward on the operands' dtype and in fp32."""
    t = fa.K1_MAX_T
    g = torch.Generator().manual_seed(6)
    qkv = torch.randn(1, t, 3 * HS, generator=g).to(torch.bfloat16)
    q, k, v = (a.view(1, t, 1, HS) for a in qkv.split(HS, dim=-1))
    do = torch.randn(1, t, 1, HS, generator=g).to(torch.bfloat16)
    o32, lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), causal=True)
    dd = fa.rowdot_reference(do.float(), o32)
    grads = fa.flash_attention_backward_reference(q, k, v, None, lse, do, causal=True, dd=dd)
    grads32 = fa.flash_attention_backward_reference(q.float(), k.float(), v.float(), None, lse,
                                                    do.float(), causal=True, dd=dd)
    return (q, k, v, do, lse, dd), grads, grads32


def test_k1_dkv_control_fails_row_check(k1_max_t):
    """Phase 6's dk/dv control at T=8192: the queries from K1_DKV_DROP_AFTER
    after each key tile dropped. The row check fails it on dk and on dv."""
    (q, k, v, do, lse, dd), (_, dk, dv), _ = k1_max_t
    sk, sv = cs.dkv_reference(torch, q, k, v, do, lse, dd, True,
                              drop_after=cs.K1_DKV_DROP_AFTER, heads=1)
    assert cs.grad_row_excess(sk, dk)[1] > 0 and cs.grad_row_excess(sv, dv)[1] > 0


def test_k1_dq_control_fails_row_check_not_max_relative(k1_max_t):
    """Phase 6's dq control at T=8192: the keys more than K1_DQ_DROP_BEFORE
    before each query tile dropped (the last 128 rows lose their first 128
    keys). The row check fails it; the check against 3e-2 of max|ref|, which
    held dq before, passes it."""
    (q, k, v, do, lse, dd), (dq, _, _), _ = k1_max_t
    late = cs.dq_reference(torch, q, k, v, do, lse, dd, True,
                           drop_before=cs.K1_DQ_DROP_BEFORE, heads=1)
    assert cs.grad_row_excess(late, dq)[1] > 0
    assert cs.rel_err(late, dq) <= 3e-2


@pytest.mark.parametrize("which", [0, 1, 2])
def test_plain_bf16_passes_row_checks_at_k1_max_t(k1_max_t, which):
    """The plain dq, dk and dv on bf16 operands at T=8192 against the same
    values in fp32 pass the row check and the check against max|ref|."""
    _, grads, grads32 = k1_max_t
    x, ref = grads[which], grads32[which]
    assert cs.grad_row_excess(x, ref)[1] <= 0 and cs.rel_err(x, ref) <= 3e-2


def _dt(seed, t):
    """One sequence of one head in the dt layout (1, 64, T) bf16, q pre-scaled."""
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(1, HS, t).astype(np.float32)) for _ in range(3))
    return (q * HS ** -0.5).to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)


def test_dt_rows_without_first_keys_is_the_plain_forward_when_none_dropped():
    """Phase 19's control helper with no key dropped gives the plain dt
    forward's last rows, within one bf16 rounding (its sums run over the
    visible keys of 128 rows, the plain version's over all of them)."""
    t = 1024
    qd, kd, vd = _dt(7, t)
    o = ab.flash_fwd_dt_b_reference(qd, kd, vd, 1, t, t, causal=True)[0]
    rows = cs.dt_rows_without_first_keys(torch, qd, kd, vd, t, skip=0)
    assert torch.allclose(rows.float(), o[:, :, t - 128:].float(), rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("t", [2048, 8192])
def test_dt_late_start_fails_row_check(t):
    """Phase 19's P1 control: the last 128 rows without their first key tile.
    The row check (over each position's 64 channels) fails it, and the plain
    dt forward on bf16 operands passes it against the same values in fp32."""
    qd, kd, vd = _dt(8, t)
    o = cs.dt_rows_without_first_keys(torch, qd, kd, vd, t, skip=0)
    late = cs.dt_rows_without_first_keys(torch, qd, kd, vd, t)
    assert cs.dt_row_excess(late, o)[1] > 0
    o32 = cs.dt_rows_without_first_keys(torch, qd.float(), kd.float(), vd.float(), t, skip=0)
    assert cs.dt_row_excess(o, o32)[1] <= 0


# phase 3's CE check (1e-4 in nll and lse) and its two controls. The
# controls' size scales as the columns they touch over V, so they are made
# at the real V (50304 and 50257) with a narrow D and logits of phase 3's
# spread (std 0.554): a 64-column drop and 47 counted padding columns move
# lse by about 1e-3, inside the old 2e-3 check.
CE_N, CE_D = 256, 64


@pytest.fixture(scope="module")
def ce_inputs():
    rng = np.random.RandomState(1)
    w = torch.from_numpy((rng.randn(50304, CE_D) * 0.554 / CE_D ** 0.5).astype(np.float32))
    x = torch.from_numpy(rng.randn(CE_N, CE_D).astype(np.float32))
    t = torch.from_numpy(rng.randint(0, 50257, CE_N).astype(np.int32))
    t[:47] = torch.arange(50257 - 47, 50257, dtype=torch.int32)  # the last, ragged tile
    return x.to(torch.bfloat16), w.to(torch.bfloat16), t


@pytest.mark.parametrize("v", [50304, 50257])
def test_ce_reference_drop_with_nothing_dropped_is_the_plain_version(ce_inputs, v):
    x, w, t = ce_inputs
    want = fc.ce_forward_reference(x, w[:v], t, n_chunks=8)
    got = cs.ce_reference_drop(torch, x, w[:v], t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("fault", ["drop64", "pad"])
def test_ce_controls_fail_the_check_and_pass_the_old_one(ce_inputs, fault):
    """Control (i), 64 columns of one 128-column tile left out at V=50304, and
    control (ii), the 47 padding columns of V=50257's ragged last tile counted
    as logits 0: every row is off by more than 1e-4, and the largest error is
    under the old 2e-3, which passed both."""
    x, w, t = ce_inputs
    if fault == "drop64":
        v, kw = 50304, {"drop_cols": slice(100 * 128, 100 * 128 + 64)}
    else:
        v, kw = 50257, {"pad_zeros": -50257 % 128}
    ref = fc.ce_forward_reference(x, w[:v], t, n_chunks=8)
    got = cs.ce_reference_drop(torch, x, w[:v], t, **kw)
    err = torch.maximum((got[0] - ref[0]).abs(), (got[1] - ref[1]).abs())
    assert err.min().item() > cs.CE_TOL
    assert err.max().item() < cs.CE_OLD_TOL


def test_plain_bf16_operands_pass_the_ce_check(ce_inputs):
    """The fp32 plain version over the bf16 operands against the same sums in
    fp64: far inside 1e-4."""
    x, w, t = ce_inputs
    nll, lse = fc.ce_forward_reference(x, w, t, n_chunks=8)
    logits = x.double() @ w.double().t()
    lz = torch.logsumexp(logits, dim=-1)
    assert (lse.double() - lz).abs().max().item() < cs.CE_TOL / 10
    gold = logits.gather(1, t.long()[:, None])[:, 0]
    assert (nll.double() - (lz - gold)).abs().max().item() < cs.CE_TOL / 10


def _ce_bwd_case(ce_inputs):
    """Phase 3b's inputs at a small size: the bf16 operands, their fp32 lse,
    a cotangent with zero rows, and the plain version's fp32 P."""
    x, w, t = ce_inputs
    g = torch.from_numpy(np.random.RandomState(2).rand(CE_N).astype(np.float32)) / CE_N
    g[::7] = 0.0
    _, lse = fc.ce_forward_reference(x, w, t)
    ref = fc.ce_backward_reference(x.float(), w.float(), t, lse, g)
    return x, w, t, lse, g, ref


def test_plain_bf16_p_passes_the_ce_bwd_check(ce_inputs):
    """The plain version's P on the bf16 operands, cast once to bf16 as K4b
    casts it, against its own fp32 P: inside bf16's unit roundoff, 2^-8, the
    part of phase 3b's elementwise limit that the cast takes; zero rows where
    g is 0."""
    x, w, t, lse, g, ref = _ce_bwd_case(ce_inputs)
    p = fc.ce_backward_reference(x, w, t, lse, g)
    assert p.dtype == torch.bfloat16
    assert cs.ce_bwd_rel_err(torch, p, ref) <= 2.0 ** -8 < cs.CE_BWD_TOL
    assert not p[::7].any()


@pytest.mark.parametrize("fault", ["no_onehot", "drop64", "zero_row_nonzero"])
def test_ce_bwd_faults_fail_the_check(ce_inputs, fault):
    """Phase 3b's control, P without the one-hot subtraction, fails the
    elementwise check, as do 64 vocab columns of one tile left at 0 and a
    row of g = 0 given another row's P; a max-relative check at the same
    tolerance passes the dropped columns (their entries are about g / V)."""
    x, w, t, lse, g, ref = _ce_bwd_case(ce_inputs)
    if fault == "no_onehot":
        p = cs.ce_bwd_reference_no_onehot(torch, x.float(), w.float(), lse, g).to(torch.bfloat16)
    else:
        p = fc.ce_backward_reference(x, w, t, lse, g)
        if fault == "drop64":
            p[:, 100 * 256:100 * 256 + 64] = 0
        else:
            p[7] = p[8]
    assert cs.ce_bwd_rel_err(torch, p, ref) > cs.CE_BWD_TOL
    if fault == "drop64":
        assert (p.float() - ref).abs().max() / ref.abs().max() < cs.CE_BWD_TOL


# phase 19's P2 checks at a small size: one sequence of T=2048, one head, in
# the dt layout; its controls drop fewer positions than phase 19's (the
# effect on max|ref| grows with the share of a row that is lost)
DT_T = 2048


@pytest.fixture(scope="module")
def dt_backward():
    """q (pre-scaled), k, v, dO in the dt layout (1, 64, T) bf16, lse and dcap
    from the fp32 forward, and the plain dt backward on the operands' dtype
    and in fp32."""
    rng = np.random.RandomState(11)
    q, k, v, do = (torch.from_numpy(rng.randn(1, HS, DT_T).astype(np.float32)) for _ in range(4))
    qd, kd, vd, dod = ((q * HS ** -0.5).to(torch.bfloat16), k.to(torch.bfloat16),
                       v.to(torch.bfloat16), do.to(torch.bfloat16))
    o, lse = ab.flash_fwd_dt_b_reference(qd.float(), kd.float(), vd.float(), 1, DT_T, DT_T)
    dcap = ab.dcap_dt(o, dod)
    args = (qd, kd, vd, dod, lse, dcap, 1, DT_T, DT_T)
    grads = ab.flash_bwd_dt_b_reference(*args, dq_scale=HS ** -0.5)
    grads32 = ab.flash_bwd_dt_b_reference(qd.float(), kd.float(), vd.float(), dod.float(), lse,
                                          dcap, 1, DT_T, DT_T, dq_scale=HS ** -0.5)
    return args, grads, grads32


def test_dt_references_with_nothing_dropped_are_the_plain_backward(dt_backward):
    args, (dq, dk, dv), _ = dt_backward
    rk, rv = cs.dt_dkv_reference(torch, *args, heads=1)
    rq = cs.dt_dq_reference(torch, *args, dq_scale=HS ** -0.5, heads=1)
    assert torch.equal(rq, dq) and torch.equal(rk, dk) and torch.equal(rv, dv)


def test_dt_dkv_control_fails_row_check_not_max_relative(dt_backward):
    """dk/dv whose key tiles stop their query sweep 1984 positions on (the
    keys of the first tile lose up to 64 queries): the row check fails dk and
    dv, the check against 3e-2 of max|ref| passes both."""
    args, (_, dk, dv), _ = dt_backward
    sk, sv = cs.dt_dkv_reference(torch, *args, drop_after=1984, heads=1)
    assert cs.dt_grad_row_excess(sk, dk)[1] > 0 and cs.dt_grad_row_excess(sv, dv)[1] > 0
    assert cs.rel_err(sk, dk) <= 3e-2 and cs.rel_err(sv, dv) <= 3e-2


def test_dt_dq_control_fails_row_check_not_max_relative(dt_backward):
    """dq whose query tiles start their key sweep late (the keys more than
    1912 before each query tile dropped): the row check fails it, the check
    against 3e-2 of max|ref| passes it."""
    args, (dq, _, _), _ = dt_backward
    late = cs.dt_dq_reference(torch, *args, dq_scale=HS ** -0.5, drop_before=1912, heads=1)
    assert cs.dt_grad_row_excess(late, dq)[1] > 0
    assert cs.rel_err(late, dq) <= 3e-2


@pytest.mark.parametrize("which", [0, 1, 2])
def test_plain_bf16_dt_backward_passes_row_check(dt_backward, which):
    """The plain dt dq, dk and dv on bf16 operands against the same values in
    fp32 pass the row check and the check against max|ref|."""
    _, grads, grads32 = dt_backward
    x, ref = grads[which], grads32[which]
    assert cs.dt_grad_row_excess(x, ref)[1] <= 0 and cs.rel_err(x, ref) <= 3e-2


# phase 19b: the fp32 dt kernels under the fp32 rules of phases 2b and 2c
# (``f32_fwd_row_err``, ``f32_row_err`` on (B, T, H, hs) views), with the
# controls of phase 19 and the right-aligned mask


def _dt_f32(seed, b, tq, tk, h=2):
    """q (pre-scaled), k, v, dO in the dt layout (H, 64, B*T), fp32."""
    rng = np.random.RandomState(seed)
    to_dt = lambda x: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x.transpose(2, 3, 0, 1).reshape(h, HS, -1)))
    q, do = (rng.randn(b, tq, h, HS).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, tk, h, HS).astype(np.float32) for _ in range(2))
    return to_dt(q * HS ** -0.5), to_dt(k), to_dt(v), to_dt(do)


@pytest.mark.parametrize("b,tq,tk", [(2, 128, 256), (2, 256, 128), (3, 192, 192)])
def test_dt_f32_masked_with_the_dt_mask_is_the_plain_dt_pair(b, tq, tk):
    """``dt_f32_masked`` with the dt kernels' own mask (query i sees keys <=
    i) gives the plain dt forward's o and the plain dt backward's dq, dk, dv
    on that forward's lse and dcap, within the fp32 rules: the control's
    arithmetic is the plain version's, only its mask differs."""
    qd, kd, vd, dod = _dt_f32(21, b, tq, tk)
    hide = torch.arange(tk)[None, :] > torch.arange(tq)[:, None]
    o_c, *grads_c = cs.dt_f32_masked(torch, qd, kd, vd, dod, b, tq, tk, hide, HS ** -0.5)
    o, lse = ab.flash_fwd_dt_b_reference(qd, kd, vd, b, tq, tk, causal=True)
    grads = ab.flash_bwd_dt_b_reference(qd, kd, vd, dod, lse, ab.dcap_dt(o, dod), b, tq, tk,
                                        causal=True, dq_scale=HS ** -0.5)
    assert cs.f32_fwd_row_err(ab.from_dt(o_c, b, tq), ab.from_dt(o, b, tq)) <= cs.F32_ROW_TOL
    for x, r, n in zip(grads_c, grads, (tq, tk, tk)):
        assert cs.rel_err(x, r) <= cs.F32_TOL
        assert cs.f32_row_err(ab.from_dt(x, b, n), ab.from_dt(r, b, n)) <= cs.F32_ROW_TOL


def test_dt_right_aligned_mask_fails_the_f32_row_rules():
    """Phase 19b's control at Tq < Tk: the causal mask right-aligned (the
    general kernels' rule) fails the fp32 row rules of o and of the
    gradients against the dt pair's plain versions."""
    b, tq, tk = 2, 128, 256
    qd, kd, vd, dod = _dt_f32(22, b, tq, tk)
    o, lse = ab.flash_fwd_dt_b_reference(qd, kd, vd, b, tq, tk, causal=True)
    grads = ab.flash_bwd_dt_b_reference(qd, kd, vd, dod, lse, ab.dcap_dt(o, dod), b, tq, tk,
                                        causal=True, dq_scale=HS ** -0.5)
    hide = cs.general_hide(torch, tq, tk, True, "cpu")
    o_c, *grads_c = cs.dt_f32_masked(torch, qd, kd, vd, dod, b, tq, tk, hide, HS ** -0.5)
    assert cs.f32_fwd_row_err(ab.from_dt(o, b, tq), ab.from_dt(o_c, b, tq)) > cs.F32_ROW_TOL
    assert max(cs.f32_row_err(ab.from_dt(x, b, n), ab.from_dt(w, b, n))
               for x, w, n in zip(grads, grads_c, (tq, tk, tk))) > cs.F32_ROW_TOL


def test_dt_controls_fail_the_f32_row_rules():
    """Phase 19's three controls, held by phase 19b to the fp32 row rules at
    T=8192, fail them here at T=1024 with drop points scaled to it; the
    plain dt pair passes them against itself run on fp64 operands."""
    t = 1024
    qd, kd, vd, dod = _dt_f32(23, 1, t, t, h=1)
    o, lse = ab.flash_fwd_dt_b_reference(qd, kd, vd, 1, t, t, causal=True)
    dcap = ab.dcap_dt(o, dod)
    args = (qd, kd, vd, dod, lse, dcap, 1, t, t)
    dq, dk, dv = ab.flash_bwd_dt_b_reference(*args, causal=True, dq_scale=HS ** -0.5)
    late = cs.dt_rows_without_first_keys(torch, qd, kd, vd, t)
    assert cs.f32_fwd_row_err(ab.from_dt(o[:, :, t - 128:], 1, 128),
                              ab.from_dt(late, 1, 128)) > cs.F32_ROW_TOL
    sk, sv = cs.dt_dkv_reference(torch, *args, drop_after=960, heads=1)
    assert max(cs.f32_row_err(ab.from_dt(x, 1, t), ab.from_dt(r, 1, t))
               for x, r in ((sk, dk), (sv, dv))) > cs.F32_ROW_TOL
    sq = cs.dt_dq_reference(torch, *args, dq_scale=HS ** -0.5, drop_before=768, heads=1)
    assert cs.f32_row_err(ab.from_dt(sq, 1, t), ab.from_dt(dq, 1, t),
                          causal_dq=True) > cs.F32_ROW_TOL
    o64, _ = ab.flash_fwd_dt_b_reference(qd.double(), kd.double(), vd.double(), 1, t, t)
    assert cs.f32_fwd_row_err(ab.from_dt(o, 1, t), ab.from_dt(o64, 1, t)) <= cs.F32_ROW_TOL


@pytest.mark.parametrize("tq,tk,causal,parts", [(256, 256, False, 2), (256, 256, True, 4),
                                                (200, 453, True, 3)])
def test_lse_dropped_part_fails_the_f32_row_rule(tq, tk, causal, parts):
    """Phase 15b's merge control: K2a's fp32 split-and-merge without each
    split query tile's last part fails the fp32 row rule against the plain
    forward, which the whole split-and-merge passes."""
    rng = np.random.RandomState(24)
    q, k, v = (torch.from_numpy(rng.randn(1, n, 2, HS).astype(np.float32))
               for n in (tq, tk, tk))
    ro, _ = fa.flash_attention_reference(q, k, v, causal=causal)
    whole, _ = fa.flash_lse_split_reference(q, k, v, causal=causal, parts=parts)
    assert cs.f32_fwd_row_err(whole, ro) <= cs.F32_ROW_TOL
    assert cs.f32_fwd_row_err(cs.lse_dropped_part(torch, fa, q, k, v, causal, parts),
                              ro) > cs.F32_ROW_TOL


@pytest.mark.parametrize("b,tq,tk,causal,parts", [(2, 512, 1024, True, 4),
                                                  (1, 1088, 1088, True, 6),
                                                  (2, 256, 256, False, 2)])
def test_dt_dropped_part_fails_the_f32_row_rule(b, tq, tk, causal, parts):
    """Phase 19b's merge control: P1 fp32's split-and-merge without each
    split query tile's last part fails the fp32 row rule against the plain
    dt forward, which the whole split-and-merge passes (Tq < Tk, the ragged
    Tq = 1088, unmasked)."""
    rng = np.random.RandomState(25)
    qd, kd, vd = (ab.to_dt(torch.from_numpy(rng.randn(b, n, 2, HS).astype(np.float32)))
                  for n in (tq, tk, tk))
    qd = qd * HS ** -0.5
    ro, _ = ab.flash_fwd_dt_b_reference(qd, kd, vd, b, tq, tk, causal=causal)
    whole, _ = ab.flash_fwd_dt_split_reference(qd, kd, vd, b, tq, tk, causal=causal,
                                               parts=parts)
    assert cs.f32_fwd_row_err(ab.from_dt(whole, b, tq), ab.from_dt(ro, b, tq)) <= cs.F32_ROW_TOL
    short = cs.dt_dropped_part(torch, ab, qd, kd, vd, b, tq, tk, causal, parts)
    assert cs.f32_fwd_row_err(ab.from_dt(short, b, tq), ab.from_dt(ro, b, tq)) > cs.F32_ROW_TOL


@pytest.mark.parametrize("n_head, n_embd, ways", [(4, 64, 4), (25, 200, 4), (6, 48, 2)])
def test_placement_bytes_check_holds_the_shards_and_fails_whole_leaves(n_head, n_embd, ways):
    """Phase 35's bytes check: each rank's fp32 params and two fp32 moments,
    as ``shard_model`` cuts a whole model for that rank, equal
    ``megatron_bytes``' count; the whole model on every rank (the one-process
    placement, the control) is outside it on every rank."""
    from gpt2_vision_language_tpu_torch.core.config import GPTConfig
    from gpt2_vision_language_tpu_torch.models import gpt2
    from gpt2_vision_language_tpu_torch.parallel import sharding
    from gpt2_vision_language_tpu_torch.utils.trees import tree_bytes

    cfg = GPTConfig(block_size=64, vocab_size=300, n_layer=2, n_head=n_head, n_embd=n_embd)
    want = cs.megatron_bytes(torch, cfg, ways)
    held = []
    for r in range(ways):
        model = gpt2.GPT2(cfg)
        sharding.shard_model(model, sharding.TensorParallel(None, r, ways, cfg))
        p = tree_bytes(gpt2.named_params(model))
        held.append((p, 2 * p))
    assert cs.placement_bytes_excess(held, want) == [0] * ways
    whole = tree_bytes(gpt2.named_params(gpt2.GPT2(cfg)))
    assert sum(want) > whole > max(want)
    assert all(cs.placement_bytes_excess([(whole, 2 * whole)] * ways, want))
