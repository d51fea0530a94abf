"""chip_smoke.py's checks of the fp32 self-attention backward (phase 2c)
and of the memory recipes (phase 31) on plain CPU tensors: the plain fp32
backward passes the row rule against its fp64 evaluation, the two controls
fail it, the fp64 evaluation is the plain backward's function, and the
helpers that read the recipes' results say what they should."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from gpt2_vision_language_tpu_torch.ops import flash_attention as fa

T, H, HS = 512, 2, 64


@pytest.fixture(scope="module")
def fp32_case():
    rng = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(rng.randn(2, T, H, HS).astype(np.float32)) for _ in range(4))
    o, lse = fa.flash_attention_reference(q, k, v, causal=True)
    want = fa.flash_attention_backward_reference(q, k, v, o, lse, do, causal=True)
    return q, k, v, do, o, lse, want


def test_masked_reference_with_the_causal_mask_is_the_plain_backward(fp32_case):
    q, k, v, do, o, lse, want = fp32_case
    hide = torch.ones(T, T, dtype=torch.bool).triu(1)
    got = cs.masked_bwd_reference(torch, q, k, v, do, lse, fa.rowdot_reference(do, o), hide)
    for x, r in zip(got, want):
        torch.testing.assert_close(x, r, rtol=1e-6, atol=1e-6)


def test_f64_backward_is_the_plain_backward(fp32_case):
    q, k, v, do, o, lse, want = fp32_case
    truth = cs.f64_bwd(torch, q, k, v, o, lse, do)
    for x, r in zip(want, truth):
        assert x.dtype == torch.float32 and r.dtype == torch.float64
        assert cs.rel_err(x, r) < 1e-5


def test_plain_fp32_passes_the_row_rule_against_fp64(fp32_case):
    """The row rule holds a correct fp32 backward (here the plain one) to
    its fp64 evaluation within 2e-5."""
    q, k, v, do, o, lse, want = fp32_case
    truth = cs.f64_bwd(torch, q, k, v, o, lse, do)
    for i, (x, r) in enumerate(zip(want, truth)):
        assert cs.f32_row_err(x.double(), r, causal_dq=i == 0) <= cs.F32_ROW_TOL


@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_controls_fail_the_row_rule(fp32_case, which):
    """dq without the last key tile each query sees, and dk/dv without the
    last 64 query rows, fail the row rule by most of a row."""
    q, k, v, do, o, lse, want = fp32_case
    qpos, kpos = torch.arange(T)[:, None], torch.arange(T)[None, :]
    extra = kpos >= qpos // 64 * 64 if which == "dq" else qpos >= T - 64
    got = cs.masked_bwd_reference(torch, q, k, v, do, lse, fa.rowdot_reference(do, o),
                                  (kpos > qpos) | extra)
    if which == "dq":
        err = cs.f32_row_err(got[0], want[0], causal_dq=True)
    else:
        err = max(cs.f32_row_err(x, r) for x, r in zip(got[1:], want[1:]))
    assert err > 0.1


def test_moment_gap():
    a = {"m": {"w": {"q": torch.tensor([1, -3, 5], dtype=torch.int8),
                     "s": torch.tensor([0.5])},
               "b": torch.tensor([1.0, 2.0])},
         "v": {}}
    assert cs.moment_gap(torch, a, a) == {"codes_max_gap": 0, "scales_max_rel": 0.0,
                                          "tensor_max_rel": 0.0}
    b = {"m": {"w": {"q": torch.tensor([1, -2, 5], dtype=torch.int8),
                     "s": torch.tensor([0.5])},
               "b": torch.tensor([1.0, 2.0 * (1 + 2.0 ** -8)])},
         "v": {}}
    gap = cs.moment_gap(torch, b, a)
    assert gap["codes_max_gap"] == 1 and gap["tensor_max_rel"] == pytest.approx(2.0 ** -8)


def test_fit_rows_of_the_stacks():
    labels = [s[0] for s in cs.BIG_STACKS]
    assert len(set(labels)) == len(labels)
    assert cs._fit_row("none", cs.BIG_STACKS) == {}
    assert cs._fit_row("none B=16", cs.BIG_STACKS) == {"micro_batch": 16}
    assert cs._fit_row("remat recompute_gelu", cs.BIG_STACKS) == {"remat": "recompute_gelu"}
    assert cs._fit_row("+ layerwise", cs.BIG_STACKS) == {
        "param_dtype": "bfloat16", "opt_state_dtype": "int8", "grad_accum_dtype": "bfloat16",
        "remat": "full", "layerwise_grad": True}
