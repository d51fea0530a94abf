"""chip_smoke.py's checks of the fp32 self-attention forward (phase 2b) on
plain CPU tensors: the plain fp32 forward passes the row rule against its
fp64 evaluation, and the two controls, a key sweep that starts one tile late
and one that stops a tile short at the diagonal, fail it."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from gpt2_vision_language_tpu_torch.ops import flash_attention as fa

T, H, HS = 512, 2, 64


@pytest.fixture(scope="module")
def fp32_case():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, T, H, HS).astype(np.float32)) for _ in range(3))
    o, lse = fa.flash_forward_f32(q, k, v, causal=True)
    return q, k, v, o, lse


def _causal_hide(t):
    pos = torch.arange(t)
    return pos[None, :] > pos[:, None]


def test_masked_reference_with_the_causal_mask_is_the_plain_forward(fp32_case):
    q, k, v, o, _ = fp32_case
    got = cs.masked_fwd_reference(torch, q, k, v, slice(None), _causal_hide(T))
    torch.testing.assert_close(got, o, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_fp32_passes_the_row_rule_against_fp64(causal):
    """The row rule holds a correct fp32 forward (here the plain one) to its
    fp64 evaluation within 2e-5, with the mask and without."""
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(2, T, H, HS).astype(np.float32)) for _ in range(3))
    o, _ = fa.flash_forward_f32(q, k, v, causal=causal)
    hide = _causal_hide(T) if causal else torch.zeros(T, T, dtype=torch.bool)
    truth = cs.masked_fwd_reference(torch, q.double(), k.double(), v.double(), slice(None), hide)
    assert truth.dtype == torch.float64
    assert cs.f32_fwd_row_err(o.double(), truth) <= cs.F32_ROW_TOL


@pytest.mark.parametrize("which", ["late", "diagonal"])
def test_controls_fail_the_row_rule(fp32_case, which):
    """The last 128 rows without their first key tile, and the last query
    tile of the kernel's F32_FWD_BQ rows without the diagonal's last key tile
    of F32_FWD_BK keys, fail the row rule by most of a row."""
    q, k, v, o, _ = fp32_case
    rows, ref = cs.fwd_controls(torch, q, k, v)[which]
    assert o[:, rows].shape == ref.shape
    assert cs.f32_fwd_row_err(o[:, rows], ref) > 0.1


def test_diagonal_control_spans_the_kernels_tiles(fp32_case):
    """The diagonal control covers the kernel's whole last query tile (its
    first rows see nothing of the dropped key tile and keep their o), and
    only the rows from the dropped key tile on move."""
    q, k, v, o, _ = fp32_case
    rows, ref = cs.fwd_controls(torch, q, k, v)["diagonal"]
    assert (rows.start, rows.stop) == (T - cs.F32_FWD_BQ, T)
    kd0 = (T - 1) // cs.F32_FWD_BK * cs.F32_FWD_BK
    moved = (o[:, rows] - ref).norm(dim=-1) / ref.norm(dim=-1)
    split = kd0 - rows.start
    assert moved[:, :split].max() < cs.F32_ROW_TOL < moved[:, split:].min()


def test_ffma_probe_needs_the_card(monkeypatch):
    """tools/ffma_probe.py reads the card only: without a CUDA device it
    exits before it builds or times anything, and its CUDA source times
    each access pattern it names."""
    from gpt2_vision_language_tpu_torch.tools import ffma_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        ffma_probe.main([])
    assert ffma_probe.LDS_SRC.count("if (pattern ==") == 5
    assert '"2_a_quarter", "4_a_quarter"' in ffma_probe.LDS_SRC
