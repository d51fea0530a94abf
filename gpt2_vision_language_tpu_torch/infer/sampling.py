"""Token samplers, (generator, logits (B, V)) -> (B,) int64 ids.

Counterpart of gpt2_vision_language_tpu/infer/sampling.py:

  * greedy argmax;
  * top-k=50 multinomial, the pretrain inline sampler (train_gpt2.py:444-448);
  * temperature + nucleus top-p, the caption sampler of evaluate_cider
    (gpt2_linear/data.py:114-125), two ways that keep the same set:
    ``sample_top_p`` by a stable descending sort, and the sort-free
    ``sample_top_p_fast`` (``top_p_keep_mask``: a bisection on the bit
    pattern of the probabilities for the boundary value, JAX :87-223).

The caption paths of the port (``eval/caption_eval.py``,
``models/caption.py``, ``train/finetune.py``) sample with ``sample_top_p``,
where the JAX package takes the sort-free sampler: on the TPU a (50, 50304)
sort was 44% of a decode step, while on the H100 one call of the sorted
sampler at that shape took 0.567-0.904 ms of wall time against 13.1-19.9 ms
for the sort-free one at ways=2 (9.9-14.5 at ways=8): its 31 passes are
some 400 small eager launches, paced by the host; its kernels alone took
1.744 ms against 0.416 (``chip_smoke.py`` phase 24, two runs, NVIDIA H100
80GB HBM3, 700.00 W; PERF.md). Both keep the same set.
``cli/bench_decode`` samples with the sort-free one, as the JAX tool does.
A ``torch.Generator`` does not give ``jax.random``'s numbers: compare kept
sets, not draws.
"""

from __future__ import annotations

import torch


def _bisect_passes(width: int, ways: int, _memo={}) -> int:
    """Exact worst-case pass count for `ways`-way bisection of an integer
    interval of `width`: each pass splits [lo, hi] at lo + step*j (step =
    max(width // ways, 1), j = 1..ways-1, clamped to hi), so the next width is
    step (interior segment) or step + width % ways (last segment); step == 0
    cases degenerate to step 1, which covers any width <= ways in one pass."""
    key = (width, ways)
    if width <= 1:
        return 0
    if key in _memo:
        return _memo[key]
    q, r = divmod(width, ways)
    n = 1 if q == 0 else 1 + max(_bisect_passes(q, ways), _bisect_passes(q + r, ways))
    _memo[key] = n
    return n


def greedy(generator, logits):
    del generator
    return torch.argmax(logits, dim=-1)


def sample_top_k(generator, logits, k: int = 50, temperature: float = 1.0):
    logits = logits.float() / temperature
    top_logits, top_idx = torch.topk(logits, k, dim=-1)
    probs = torch.softmax(top_logits, dim=-1)
    choice = torch.multinomial(probs, 1, generator=generator)
    return top_idx.gather(-1, choice)[:, 0]


def _sorted_cutoff(probs, p: float):
    """(descending probs, their ids, drop mask in that order): a token is
    dropped when the cumulative mass before it in descending-probability
    order (ties by ascending id) already exceeds p; rank 0 is always kept."""
    sorted_probs, sort_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    cum = torch.cumsum(sorted_probs, dim=-1)
    cutoff = torch.zeros_like(cum, dtype=torch.bool)
    cutoff[:, 1:] = cum[:, :-1] > p
    return sorted_probs, sort_idx, cutoff


def sorted_keep_mask(probs, p: float):
    """The kept set of ``sample_top_p`` as a (B, V) bool mask in id order."""
    _, sort_idx, cutoff = _sorted_cutoff(probs, p)
    return torch.zeros_like(cutoff).scatter_(-1, sort_idx, ~cutoff)


def sample_top_p(generator, logits, p: float = 0.9, temperature: float = 0.8):
    """Nucleus sampling by a stable descending sort: the renormalized
    multinomial over the kept set."""
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    sorted_probs, sort_idx, cutoff = _sorted_cutoff(probs, p)
    sorted_probs = sorted_probs.masked_fill(cutoff, 0.0)
    choice = torch.multinomial(sorted_probs, 1, generator=generator)
    return sort_idx.gather(-1, choice)[:, 0]


def sample_top_p_fast(generator, logits, p: float = 0.9, temperature: float = 0.8,
                      ways: int = 2):
    """Sort-free nucleus sampling: the kept set of ``sample_top_p`` without a
    full-vocab sort (``top_p_keep_mask``), then a draw from the masked
    log-probs: the multinomial over the kept probabilities, which is the
    renormalized distribution of the sorted path. ``ways`` is the bisection
    arity (2 in the JAX package; ``cli/bench_decode --topp-ways``)."""
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    keep = top_p_keep_mask(probs, p, ways=ways)
    choice = torch.multinomial(probs.masked_fill(~keep, 0.0), 1, generator=generator)
    return choice[:, 0]


def top_p_keep_mask(probs, p: float, ways: int = 2):
    """(B, V) fp32 probabilities -> (B, V) bool: token kept iff its exclusive
    prefix mass in descending-prob, ascending-id order is <= p (the sorted
    path's rule), found without a sort (JAX infer/sampling.py:143-223):

      1. bisect on the int32 bit pattern of the probabilities (nonnegative
         fp32 order is int32 order) for adjacent floats lo < hi with
         G(lo) > p >= G(hi), G(t) = sum(probs[probs > t]); hi is then the
         value vb of the boundary tie group, and G(hi) rides along through
         the loop, so no pass follows it;
      2. tokens with probs > vb are kept;
      3. within the tie group at vb, members are kept while
         G(vb) + k * vb <= p, k counting the group's members of lower id
         (an exclusive cumsum): the stable sort's order.

    Each threshold's mass is its own (B, V) reduction, stacked, not one
    (B, V, ways-1) reduction: every per-threshold sum then has the shape and
    order of a lone binary-bisection evaluation, the computed G is monotone
    in the threshold, and every arity lands on the same boundary, bit for
    bit (JAX :153-171)."""
    b = probs.shape[0]
    one = 0x3F800000  # bit pattern of fp32 1.0; G(1.0) = 0 <= p
    lo = torch.zeros(b, dtype=torch.int32, device=probs.device)
    hi = torch.full((b,), one, dtype=torch.int32, device=probs.device)
    g_hi = torch.zeros(b, dtype=torch.float32, device=probs.device)
    jj = torch.arange(1, ways, dtype=torch.int32, device=probs.device)
    int_max = torch.iinfo(torch.int32).max
    for _ in range(_bisect_passes(one, ways)):
        step = torch.clamp((hi - lo) // ways, min=1)
        # ways-1 interior thresholds, clamped to hi (a duplicate at hi keeps
        # the invariant: probs > hi_val is the same mask)
        mids = torch.minimum(lo[:, None] + step[:, None] * jj[None, :], hi[:, None])
        t = mids.view(torch.float32)
        g = torch.stack([torch.where(probs > t[:, k, None], probs, 0.0).sum(-1)
                         for k in range(ways - 1)], dim=1)
        above = g > p
        # lo' = the largest threshold still above p (mids ascend)
        lo = torch.where(above, mids, lo[:, None]).amax(dim=1)
        # hi' = the smallest threshold at or below p, its G picked by position
        jidx = torch.where(above, int_max, mids).argmin(dim=1, keepdim=True)
        found = ~above.all(dim=1)
        hi = torch.where(found, mids.gather(1, jidx)[:, 0], hi)
        g_hi = torch.where(found, g.gather(1, jidx)[:, 0], g_hi)
    vb = hi.view(torch.float32)[:, None]
    eq = probs == vb
    k_before = torch.cumsum(eq, dim=-1, dtype=torch.int32) - eq.to(torch.int32)
    # the first max-prob token has exclusive mass 0 <= p: rank 0 is kept
    return (probs > vb) | (eq & (g_hi[:, None] + k_before * vb <= p))
