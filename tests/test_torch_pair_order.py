"""The work order of the fp32 one-pass backward block (csrc/flash_f32.cuh
pair_grid, pair_block) in plain Python, for its two cases: GENERAL (the
right-aligned causal mask, any Tq <= Tk) and DT (the A/B tool's layout, no
offset, Tq and Tk multiples of 64 either way round). Each block walks its
work items (b, h, key tile) in the order pair_grid deals them; an item sweeps
its query tiles, and its part of a query tile's dq waits until the tile's
flag counts the parts ranked before it. The model checks what the kernel's
header comment argues: every visible (query tile, key tile) pair is swept
once, the parts of a query tile take the ranks 0, 1, ... once each, and the
blocks, all resident at once, never wait on one another for ever."""

import itertools

import pytest

TILE = 64


def plan(ntq, ntk, bh, causal, slots):
    """(rounds, grid) as flash_f32.cuh launch_pair_grid picks them."""
    rounds = min(slots // ntk, bh) if not causal and ntq == ntk and ntk <= slots else 0
    items = ntk * bh
    list_rounds = -(-items // slots)
    return rounds, (rounds * ntk if rounds else -(-items // list_rounds))


def block_items(x, grid, ntk, bh, rounds):
    """The (bh, key tile) items of block x, in its order (pair_grid)."""
    out = []
    for r in itertools.count():
        if rounds:
            b, kt = x // ntk + r * rounds, x % ntk
        else:
            base = r * grid
            if base >= ntk * bh:
                return out
            w = base + (grid - 1 - x if r & 1 else x)
            if w >= ntk * bh:
                continue
            b, kt = w % bh, ntk - 1 - w // bh
        if b >= bh:
            return out
        out.append((b, kt))


def item_steps(case, kt, tq, tk, causal, rounds):
    """[(query tile, rank)] of the item of key tile kt (pair_block)."""
    ntq, ntk = -(-tq // TILE), -(-tk // TILE)
    off = tk - tq if case == "general" else 0
    k0 = kt * TILE
    it0 = kt if rounds else (kt if case == "dt" else max(k0 - off, 0) // TILE) if causal else 0
    n = ntq if rounds else ntq - it0
    steps = []
    for st in range(n):
        it = (it0 + st) % ntq if rounds else it0 + st
        if rounds:
            rank = st
        elif not causal:
            rank = ntk - 1 - kt
        elif case == "dt":
            rank = min(it, ntk - 1) - kt
        else:
            rank = (min(it * TILE + TILE, tq) - 1 + off) // TILE - kt
        steps.append((it, rank))
    return steps


def visible(case, it, kt, tq, tk, causal):
    """Whether a row of query tile it sees a key of key tile kt."""
    if not causal:
        return True
    off = tk - tq if case == "general" else 0
    return kt * TILE <= min(it * TILE + TILE, tq) - 1 + off


def simulate(case, tq, tk, bh, causal, slots):
    ntq, ntk = -(-tq // TILE), -(-tk // TILE)
    rounds, grid = plan(ntq, ntk, bh, causal, slots)
    assert grid <= slots
    queues = [[(b, kt, item_steps(case, kt, tq, tk, causal, rounds))
               for b, kt in block_items(x, grid, ntk, bh, rounds)] for x in range(grid)]
    swept = [(b, kt, it) for q_ in queues for b, kt, steps in q_ for it, _ in steps]
    assert sorted(swept) == sorted((b, kt, it) for b in range(bh) for kt in range(ntk)
                                   for it in range(ntq) if visible(case, it, kt, tq, tk, causal))
    ranks = {}
    for q_ in queues:
        for b, _, steps in q_:
            for it, rank in steps:
                ranks.setdefault((b, it), []).append(rank)
    assert all(sorted(r) == list(range(len(r))) for r in ranks.values())
    # all blocks resident at once: each advances when its step's flag counts
    # its rank, then adds one to it
    flags, pos = {}, [(0, 0)] * grid
    while True:
        moved, done = False, True
        for x in range(grid):
            i, st = pos[x]
            while i < len(queues[x]):
                b, _, steps = queues[x][i]
                if st == len(steps):
                    i, st = i + 1, 0
                    continue
                it, rank = steps[st]
                if flags.get((b, it), 0) != rank:
                    break
                flags[(b, it)] = rank + 1
                st, moved = st + 1, True
            pos[x] = (i, st)
            done = done and i == len(queues[x])
        if done:
            return rounds
        assert moved, f"deadlock at {pos}"


@pytest.mark.parametrize("tq, tk, causal", [
    (1024, 1024, True), (512, 1024, True), (1024, 512, True), (1088, 1088, True),
    (512, 1024, False), (1024, 512, False)])
@pytest.mark.parametrize("slots", [5, 264])
def test_dt_order_sweeps_each_pair_once_and_never_deadlocks(tq, tk, causal, slots):
    assert simulate("dt", tq, tk, 2 * 3, causal, slots) == 0


def test_dt_unmasked_square_takes_the_rounds():
    """Unmasked at Tq == Tk the dt case runs whole (b, h) in rounds, as the
    general case does: 24 (b, h) of 16 key tiles on 264 slots, rounds of 16."""
    assert simulate("dt", 1024, 1024, 24, False, 264) == 16


@pytest.mark.parametrize("tq, tk, causal", [
    (130, 385, True), (130, 385, False), (1, 193, True), (3000, 4133, True),
    (1024, 1024, True)])
def test_general_order_sweeps_each_pair_once_and_never_deadlocks(tq, tk, causal):
    assert simulate("general", tq, tk, 2, causal, 7) == 0
