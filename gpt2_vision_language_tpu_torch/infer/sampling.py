"""Token samplers, (generator, logits (B, V)) -> (B,) int64 ids.

Counterpart of gpt2_vision_language_tpu/infer/sampling.py:39-84:

  * greedy argmax;
  * top-k=50 multinomial, the pretrain inline sampler (train_gpt2.py:444-448);
  * temperature + nucleus top-p, the caption sampler of evaluate_cider
    (gpt2_linear/data.py:114-125), by a stable descending sort.

The sort-free nucleus sampler (``top_p_keep_mask``, ``sample_top_p_fast``)
is not ported yet; ``sample_top_p`` keeps the same set. A ``torch.Generator``
does not give ``jax.random``'s numbers: compare kept sets, not draws.
"""

from __future__ import annotations

import torch


def greedy(generator, logits):
    del generator
    return torch.argmax(logits, dim=-1)


def sample_top_k(generator, logits, k: int = 50, temperature: float = 1.0):
    logits = logits.float() / temperature
    top_logits, top_idx = torch.topk(logits, k, dim=-1)
    probs = torch.softmax(top_logits, dim=-1)
    choice = torch.multinomial(probs, 1, generator=generator)
    return top_idx.gather(-1, choice)[:, 0]


def sample_top_p(generator, logits, p: float = 0.9, temperature: float = 0.8):
    """Drop tokens whose preceding cumulative mass in descending-probability
    order (ties by ascending id) already exceeds p; rank 0 is always kept;
    draw from the renormalized rest."""
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    sorted_probs, sort_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    cum = torch.cumsum(sorted_probs, dim=-1)
    cutoff = torch.zeros_like(cum, dtype=torch.bool)
    cutoff[:, 1:] = cum[:, :-1] > p
    sorted_probs = sorted_probs.masked_fill(cutoff, 0.0)
    choice = torch.multinomial(sorted_probs, 1, generator=generator)
    return sort_idx.gather(-1, choice)[:, 0]
