"""The port's sort-free nucleus sampler against the JAX package's: the pass
count, the kept set bit for bit on dyadic rows (every probability a multiple
of 2^-20, so every partial sum is exact in any order), the sorted path's kept
set, softmax rows away from the boundary, ways=2 against ways=8, and the
draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.infer import sampling as jsampling
from gpt2_vision_language_tpu_torch.infer import sampling
from torch_threads import share_cores  # noqa: F401  (autouse)

N = 1 << 20  # dyadic rows: counts of 2^-20 summing to 2^20


def dyadic_rows(seed, b, v, p, m=8, head=20):
    """(b, v) fp32 rows, each a multiple of 2^-20 summing to exactly 1: `head`
    large tokens, a tie group of `m` tokens at one value straddling p, and a
    tail of smaller tokens, in shuffled positions (the tie group's ids are
    scattered, so the ascending-id rule decides which members stay)."""
    rng = np.random.RandomState(seed)
    tie = 2000 if p < 0.99 else 100
    rows = []
    for _ in range(b):
        top = int(p * N) - (m // 2) * tie + int(rng.randint(tie))
        heads = np.full(head, top // head)
        heads[: top % head] += 1
        heads += rng.randint(-50, 50, head) * (np.arange(head) % 2 * 2 - 1)
        heads[-1] += top - heads.sum()
        rest = N - top - m * tie
        tail = rng.multinomial(rest, np.full(v - head - m, 1.0 / (v - head - m)))
        counts = np.concatenate([heads, np.full(m, tie), tail])
        assert counts.sum() == N and heads.min() > tie > tail.max()
        rows.append(counts[rng.permutation(v)])
    return (np.stack(rows) / N).astype(np.float32)


@pytest.mark.parametrize("ways", [2, 3, 8])
def test_bisect_passes_match_jax(ways):
    assert sampling._bisect_passes(0x3F800000, ways) == jsampling._bisect_passes(0x3F800000, ways)


@pytest.mark.parametrize("v", [1000, 50304])
@pytest.mark.parametrize("p", [0.5, 0.9, 0.999])
def test_keep_mask_on_dyadic_rows_equals_jax_and_the_sorted_set(v, p):
    probs = dyadic_rows(int(p * 1000) + v, 4, v, p)
    want = np.asarray(jsampling.top_p_keep_mask(jnp.asarray(probs), p))
    got = sampling.top_p_keep_mask(torch.from_numpy(probs), p)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(sampling.sorted_keep_mask(torch.from_numpy(probs), p), got)
    # the tie group straddles p in every row: some members kept, some not
    for row, keep in zip(probs, got.numpy()):
        vb = row[keep].min()
        tie = row == vb
        assert 0 < (keep & tie).sum() < tie.sum()
    assert torch.equal(sampling.top_p_keep_mask(torch.from_numpy(probs), p, ways=8), got)


@pytest.mark.parametrize("v, p", [(1000, 0.5), (1000, 0.9), (50304, 0.5)])
def test_keep_mask_on_softmax_rows_matches_jax_away_from_the_boundary(v, p):
    """Softmax rows of seeded N(0, 3) logits: port and JAX masks agree on every
    row where the exclusive mass (float64) of both the last kept and the first
    dropped token lies more than 1e-5 from p; fewer than 5% of the rows are
    left out. ways=2 and ways=8 are bit-equal on every row."""
    logits = np.random.RandomState(v + int(p * 10)).randn(64, v).astype(np.float32) * 3
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    want = np.asarray(jsampling.top_p_keep_mask(jnp.asarray(probs), p))
    t = torch.from_numpy(probs)
    got = sampling.top_p_keep_mask(t, p).numpy()
    assert np.array_equal(sampling.top_p_keep_mask(t, p, ways=8).numpy(), got)
    p64 = probs.astype(np.float64)
    s = -np.sort(-p64, axis=1)
    excl = np.cumsum(s, axis=1) - s
    kept = (excl <= p).sum(1)
    rows = np.arange(len(s))
    near = ((np.abs(excl[rows, kept - 1] - p) <= 1e-5)
            | (np.abs(excl[rows, np.minimum(kept, v - 1)] - p) <= 1e-5))
    print(f"V={v} p={p}: {near.sum()} of {len(s)} rows within 1e-5 of p left out")
    assert near.mean() < 0.05
    assert np.array_equal(got[~near], want[~near])
    assert np.array_equal(got.sum(1)[~near], kept[~near])


def test_draws_land_on_the_kept_set_with_its_frequencies():
    """20,000 draws from one dyadic row (as logits, temperature 1): only kept
    tokens, each within 5 standard errors of its renormalized probability."""
    p, n = 0.9, 20000
    row = dyadic_rows(7, 1, 256, p, m=6, head=4)
    logits = torch.from_numpy(np.log(row)).expand(n, -1)
    gen = torch.Generator().manual_seed(0)
    draws = sampling.sample_top_p_fast(gen, logits, p=p, temperature=1.0)
    probs = torch.softmax(logits[:1], dim=-1)
    keep = sampling.top_p_keep_mask(probs, p)[0].numpy()
    assert 4 < keep.sum() < 10
    counts = np.bincount(draws.numpy(), minlength=256)
    assert counts[~keep].sum() == 0
    q = np.where(keep, probs[0].numpy(), 0.0).astype(np.float64)
    q /= q.sum()
    se = np.sqrt(n * q * (1 - q))
    assert np.all(np.abs(counts - n * q)[keep] <= 5 * se[keep])
