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
