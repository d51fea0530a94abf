"""P1 fp32 (csrc/flash_dt_fwd_f32.cu) as it computes, in plain PyTorch: a
one-dimensional grid of 128-row query tiles, each one's visible key tiles
under the dt layout's mask without offset cut into parts, each part's
unnormalised o, running max and row sum, merged in part order
(``ab.flash_fwd_dt_split_reference``). Held against the TPU tool's P1
(tools/ab_dt_flash.py flash_fwd_dt_b) in interpret mode with 64-position
blocks, the same numpy inputs through both, fp32, head size 64; the parts
rule (``ab.dt_f32_parts``) as a pure function of the grid and the card's
slots; and the wrapper's launch on operands that report the card."""

import contextlib
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu_torch.ops import flash_attention as fa
from gpt2_vision_language_tpu_torch.tools import ab_dt_flash as ab
from torch_threads import share_cores  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, HS = 2, 64
TOL = 2e-5  # the TPU tool's own limit
SLOTS = 2 * 132  # the H100's resident blocks of the fp32 forward


@pytest.fixture(scope="module")
def jax_tool():
    """tools/ab_dt_flash.py of the repository, imported by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_ab_dt_flash", os.path.join(ROOT, "tools", "ab_dt_flash.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(b, tq, tk, seed):
    """q (pre-scaled), k, v in the dt layout (H, hs, B*T), fp32 numpy."""
    rng = np.random.RandomState(seed)
    to_dt = lambda x: np.ascontiguousarray(x.transpose(2, 3, 0, 1).reshape(H, HS, -1))  # noqa: E731
    q = to_dt(rng.randn(b, tq, H, HS).astype(np.float32) * HS ** -0.5)
    k, v = (to_dt(rng.randn(b, tk, H, HS).astype(np.float32)) for _ in range(2))
    return q, k, v


# (B, Tq, Tk, causal, parts): phase 19b's kinds of shape (causal, the ragged
# Tq = 1088, Tq < Tk, unmasked), Tq > Tk (queries past Tk see every key),
# unmasked Tq != Tk, and more parts than a short tile has key tiles
SHAPES = [(2, 1024, 1024, True, 2), (1, 1088, 1088, True, 6), (2, 512, 1024, True, 4),
          (2, 1024, 1024, False, 4), (2, 640, 384, True, 3), (1, 384, 640, False, 3),
          (2, 256, 256, True, 8)]


@pytest.mark.parametrize("b, tq, tk, causal, parts", SHAPES)
def test_split_forward_matches_the_tpu_kernel(jax_tool, b, tq, tk, causal, parts):
    """o and lse within 2e-5 of the TPU kernel in interpret mode, and of the
    unsplit plain version."""
    q, k, v = _inputs(b, tq, tk, seed=tq + 3 * tk + parts)
    o, lse = ab.flash_fwd_dt_split_reference(*map(torch.from_numpy, (q, k, v)), b, tq, tk,
                                             causal=causal, parts=parts)
    assert tuple(o.shape) == (H, HS, b * tq) and tuple(lse.shape) == (H, b * tq)
    jo, jlse = jax_tool.flash_fwd_dt_b(*map(jnp.asarray, (q, k, v)), b, tq, tk, causal=causal,
                                       bq=64, bk=64, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, 0, :], atol=TOL, rtol=0)
    ro, rlse = ab.flash_fwd_dt_b_reference(*map(torch.from_numpy, (q, k, v)), b, tq, tk,
                                           causal=causal)
    np.testing.assert_allclose(o.numpy(), ro.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), rlse.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("tq, tk, causal, parts, want", [
    # Tq > Tk: tiles past Tk see all 8 key tiles; chunk 3
    (1024, 512, True, 3, [[2], [3, 1], [3, 3], [3, 3, 2]] + [[3, 3, 2]] * 4),
    # Tq < Tk: the last tile sees min(Tq, Tk) / 64 = 8 key tiles, not 16
    (512, 1024, True, 4, [[2], [2, 2], [2, 2, 2], [2, 2, 2, 2]]),
    # Tq = 1088: 9 tiles, the last of 64 rows sees 17 key tiles; chunk 3
    (1088, 1088, True, 6, [[2], [3, 1], [3, 3], [3, 3, 2], [3, 3, 3, 1], [3, 3, 3, 3],
                           [3, 3, 3, 3, 2], [3, 3, 3, 3, 3, 1], [3, 3, 3, 3, 3, 2]]),
    (256, 640, False, 4, [[3, 3, 3, 1]] * 2),  # 10 key tiles, chunk 3
])
def test_parts_cover_each_visible_range_in_order(tq, tk, causal, parts, want):
    """The parts of each query tile: consecutive runs of at most chunk key
    tiles from key 0 to the tile's last visible key, empty ones dropped; the
    items, run after run, hold every visible score once."""
    vis = ab.dt_f32_visible_tiles(tq, tk, causal)
    assert [sum(w) for w in want] == vis
    q, k, v = map(torch.from_numpy, _inputs(1, tq, tk, seed=1))
    split = list(ab.dt_f32_parts_reference(q, k, v, 1, tq, tk, causal=causal, parts=parts))
    assert [len(pts) for _, pts in split] == [len(w) for w in want]
    assert [(r.start, r.stop) for r, _ in split] == [
        (i * 128, min(i * 128 + 128, tq)) for i in range(len(want))]
    # each part's row sum adds up to the whole row's over its visible keys
    s = torch.exp(ab._scores(q, k, 1, tq, tk, causal))  # (H, 1, Tq, Tk), |s| small
    for rows, pts in split:
        total = sum(lp * torch.exp(m) for _, m, lp in pts)
        torch.testing.assert_close(total, s[:, :, rows].sum(-1), rtol=1e-5, atol=0)


@pytest.mark.parametrize("b, tq, tk, causal, want", [
    (8, 1024, 1024, True, 1),    # the A/B tool's shape: the 1-D order alone
    (1, 8192, 8192, True, 3),
    (2, 1024, 1024, True, 2),    # phase 19b's shapes
    (3, 1088, 1088, True, 3),
    (2, 512, 1024, True, 4),
    (2, 1024, 1024, False, 4),
    (2, 1024, 512, True, 3),     # Tq > Tk
    (2, 2048, 1024, True, 1),
])
def test_parts_rule_at_the_cards_slots(b, tq, tk, causal, want):
    """The part count of least cost (the list schedule's makespan, and the
    merge's share where a tile is cut) over the 264 slots, at H=12."""
    assert ab.dt_f32_parts(12 * b, tq, tk, causal, SLOTS) == want


@pytest.mark.parametrize("b, tq, tk, causal", [(8, 1024, 1024, True), (2, 1024, 512, True),
                                               (2, 1024, 1024, False)])
def test_parts_cost_is_the_makespan_and_the_merge(b, tq, tk, causal):
    """At one part the cost is the list schedule's makespan; at more, the
    makespan, a share of each split item spread over the slots and the
    merge's launch."""
    vis = ab.dt_f32_visible_tiles(tq, tk, causal)
    work, span, split = fa.split_makespan(12 * b, vis, SLOTS, 1)
    assert split == 0 and work == 12 * b * sum(vis)
    assert ab.dt_f32_cost(12 * b, tq, tk, causal, SLOTS, 1) == span
    for parts in (2, 3, 8):
        work_p, span_p, split_p = fa.split_makespan(12 * b, vis, SLOTS, parts)
        assert work_p == work and split_p > 0
        assert ab.dt_f32_cost(12 * b, tq, tk, causal, SLOTS, parts) == pytest.approx(
            span_p + split_p * ab.DT_F32_MERGE_ITEM / SLOTS + ab.DT_F32_MERGE_LAUNCH)


@pytest.mark.parametrize("b, t, old, new", [(8, 1024, 0.727, 0.935), (1, 8192, 0.733, 0.900)])
def test_longest_first_over_the_whole_grid(b, t, old, new):
    """At one part the 1-D grid's order (the longest query tiles of every
    (b, h) first) keeps the slots busier than the parent's (tile, h, b) grid,
    longest first only inside each (b, h)."""
    vis = ab.dt_f32_visible_tiles(t, t, True)
    parent = fa.split_balance(1, vis * 12 * b, SLOTS, 1)  # one (b, h) after another
    assert parent == pytest.approx(old, abs=1e-3)
    assert fa.split_balance(12 * b, vis, SLOTS, 1) == pytest.approx(new, abs=1e-3)


def test_a_dropped_part_changes_the_merge():
    """The control: each split query tile merged without its last part loses
    that part's keys, far outside the 2e-5 the kernel is held to; a tile of
    one part has nothing to drop."""
    b, tq, tk = 2, 512, 1024
    q, k, v = map(torch.from_numpy, _inputs(b, tq, tk, seed=5))
    for rows, pts in ab.dt_f32_parts_reference(q, k, v, b, tq, tk, causal=True, parts=4):
        whole, _ = ab.merge_dt_parts(pts)
        if len(pts) == 1:
            assert rows.start == 0
            continue
        short, _ = ab.merge_dt_parts(pts[:-1])
        assert (whole - short).abs().max() > 1e-2


class _Lib:
    """A stand-in for the library: records the fp32 forward's arguments."""

    def __init__(self):
        self.args = []
        self.gpt2vl_flash_dt_fwd_f32 = lambda *a: self.args.append(a) or 0
        self.gpt2vl_flash_dt_fwd_f32_slots = lambda: SLOTS


class _OnCard(torch.Tensor):
    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("b, t, parts", [(8, 1024, 1), (2, 1024, 2)])
def test_wrapper_passes_parts_and_workspace(monkeypatch, b, t, parts):
    """On fp32 operands that report the card, the wrapper launches once with
    the rule's parts, a workspace of items x 128 x (64 + 2) floats where
    there are several and none where there is one, and counts one launch,
    and one of the merge where there are several parts."""
    lib = _Lib()
    monkeypatch.setattr(ab._build, "load", lambda: lib)
    monkeypatch.setattr(ab, "_stream", lambda t_: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(ab.flash_fwd_dt_b, "launches_f32", 0)
    monkeypatch.setattr(ab.flash_fwd_dt_b, "launches_f32_merge", 0)
    sizes = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *s, **kw: sizes.append(s) or empty(*s, **kw))
    x = torch.zeros(12, HS, b * t).as_subclass(_OnCard)
    ab.flash_fwd_dt_b(x, x, x, b, t, t, causal=True)
    (args,) = lib.args
    items = (t // 128) * parts * b * 12
    assert args[6:13] == (b, t, t, 12, HS, 1, parts)
    assert (args[5] is None) == (parts == 1)
    assert ((items * 128 * (HS + 2),) in sizes) == (parts > 1)
    assert ab.flash_fwd_dt_b.launches_f32 == 1
    assert ab.flash_fwd_dt_b.launches_f32_merge == int(parts > 1)


def test_cpu_wrapper_is_the_plain_version():
    """On CPU tensors flash_fwd_dt_b runs the plain version and counts no
    launch."""
    q, k, v = map(torch.from_numpy, _inputs(2, 256, 256, seed=2))
    before, merges = ab.flash_fwd_dt_b.launches_f32, ab.flash_fwd_dt_b.launches_f32_merge
    o, lse = ab.flash_fwd_dt_b(q, k, v, 2, 256, 256, causal=True)
    ro, rlse = ab.flash_fwd_dt_b_reference(q, k, v, 2, 256, 256, causal=True)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert ab.flash_fwd_dt_b.launches_f32 == before
    assert ab.flash_fwd_dt_b.launches_f32_merge == merges
