"""K2a's fp32 kernel (csrc/flash_lse_fwd_f32.cu) as it computes, in plain
PyTorch: each 128-row query tile's visible key tiles cut into parts, each
part's unnormalised o, running max and row sum, merged in part order
(``fa.flash_lse_split_reference``). Held against the JAX package's
flash_attention_with_lse, whose Pallas kernel runs in interpret mode on the
CPU, and against the unsplit plain version, the same numpy inputs through
all three, fp32, head size 64; and the wrapper's rule for how many parts
(``fa.lse_f32_parts``) as a pure function of the grid and the card's slots."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.ops import flash_attention as jfa
from gpt2_vision_language_tpu_torch.ops import flash_attention as fa

B, H, HS = 1, 2, 64
TOL = 1e-5
# (Tq, Tk, causal, parts): a query tile that sees fewer key tiles than parts
# (256 causal: the first tile sees 2 of 4), Tq != Tk with a ragged Tk whose
# parts are uneven (5 key tiles in parts of 3 and 2; 8 in parts of 3, 3, 2),
# both lengths ragged without the mask, and more parts than any tile needs
SHAPES = [(256, 256, True, 4), (256, 256, False, 3), (100, 300, True, 2), (200, 453, True, 3),
          (300, 453, False, 4), (64, 300, False, 8), (256, 256, True, 1)]


def _inputs(tq, tk, seed):
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return mk(B, tq, H, HS), mk(B, tk, H, HS), mk(B, tk, H, HS)


@pytest.mark.parametrize("tq, tk, causal, parts", SHAPES)
def test_split_forward_matches_jax_and_the_unsplit_plain_version(tq, tk, causal, parts):
    q, k, v = _inputs(tq, tk, seed=3 * tq + tk + parts)
    o, lse = fa.flash_lse_split_reference(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                          parts=parts)
    assert o.shape == (B, tq, H, HS) and lse.shape == (B, H, tq)
    want_o, want_lse = jfa.flash_attention_with_lse(
        *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)), causal=causal,
        interpret=True)
    np.testing.assert_allclose(o.numpy().transpose(0, 2, 1, 3), np.asarray(want_o),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], rtol=TOL, atol=TOL)
    ro, rlse = fa.flash_attention_reference(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(o.numpy(), ro.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), rlse.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tq, tk, causal, parts, want", [
    (256, 256, True, 4, [[1, 1], [1, 1, 1, 1]]),   # chunk 1: the first tile's last 2 parts empty
    (100, 300, True, 2, [[3, 2]]),                   # 5 visible tiles, chunk 3
    (200, 453, True, 3, [[3, 3], [3, 3, 2]]),        # 6 and 8 visible tiles, chunk 3
    (300, 453, False, 4, [[2, 2, 2, 2]] * 3),        # 8 key tiles, chunk 2
])
def test_parts_cover_each_visible_range_in_order(tq, tk, causal, parts, want):
    """The parts of each query tile: consecutive runs of at most chunk key
    tiles from key 0 to the tile's last visible key, empty ones dropped."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(tq, tk, seed=1))
    chunk = fa.lse_f32_chunk(tk, parts)
    vis = fa.lse_f32_visible_tiles(tq, tk, causal)
    lengths = [[min(chunk, n - p * chunk) for p in range(parts) if p * chunk < n] for n in vis]
    assert lengths == want and [sum(w) for w in want] == vis
    split = fa.lse_f32_parts_reference(q, k, v, causal=causal, parts=parts)
    assert [len(pts) for _, pts in split] == [len(w) for w in want]


def test_a_dropped_part_changes_the_merge():
    """The merge weighs every part: without the last part of a query tile of
    several, its rows lose that part's keys."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(256, 256, seed=5))
    for rows, pts in fa.lse_f32_parts_reference(q, k, v, causal=False, parts=2):
        whole, _ = fa.merge_lse_parts(pts)
        short, _ = fa.merge_lse_parts(pts[:-1])
        assert (whole - short).abs().max() > 1e-2


@pytest.mark.parametrize("bh, t, causal", [(12, 16384, True), (12, 16384, False)])
def test_parts_rule_leaves_a_full_grid_whole(bh, t, causal):
    """K2b's T=16384 grid (1536 query tiles of 128 rows) already fills the
    card's 2 x 132 resident slots: one part."""
    assert fa.lse_f32_parts(bh, t, t, causal, 2 * 132) == 1
    assert fa.lse_f32_balance(bh, t, t, causal, 2 * 132, 1) >= fa.LSE_F32_BALANCE


@pytest.mark.parametrize("causal", [False, True])
def test_parts_rule_splits_the_ring_pair(causal):
    """The ring's chunk pair (B=1, Tq=Tk=4096, H=12) is 384 query tiles for
    264 slots, 73-75% busy as one part a tile; the rule picks the fewest parts
    that reach 90%."""
    bh, t, slots = 12, 4096, 2 * 132
    parts = fa.lse_f32_parts(bh, t, t, causal, slots)
    assert parts >= 2
    assert fa.lse_f32_balance(bh, t, t, causal, slots, 1) < 0.8
    assert fa.lse_f32_balance(bh, t, t, causal, slots, parts) >= fa.LSE_F32_BALANCE
    assert all(fa.lse_f32_balance(bh, t, t, causal, slots, p) < fa.LSE_F32_BALANCE
               for p in range(1, parts))


def test_cpu_wrapper_is_the_plain_version():
    """On CPU tensors flash_lse_forward_f32 runs the plain version and counts
    no launch."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(100, 300, seed=2))
    before = fa.flash_lse_forward_f32.launches
    o, lse = fa.flash_lse_forward_f32(q, k, v, causal=True)
    ro, rlse = fa.flash_attention_reference(q, k, v, causal=True)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert fa.flash_lse_forward_f32.launches == before
