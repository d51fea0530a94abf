"""KV-cached autoregressive generation.

Counterpart of gpt2_vision_language_tpu/infer/decode.py: one prefill over
the prompt, then single-token steps against the KV cache, O(T) decoder work
per token instead of the reference's full re-forward (train_gpt2.py:440-449).

The visual prefix (gpt2_linear/model.py:197-200): its M tokens occupy cache
slots [0, M) with NO positional embeddings; text token t gets wpe[t] while
living in cache slot M + t. The decoder keeps ``slot`` and ``pos`` apart to
reproduce this exactly.

PyTorch runs eagerly, so there is no jit here: the step loop is Python and
the cache is updated in place.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import torch

from ..core.config import GPTConfig
from ..core.precision import Policy, DEFAULT_POLICY
from ..models import gpt2
from .sampling import sample_top_k


def cast_decode_params(model: gpt2.GPT2, policy: Policy = DEFAULT_POLICY):
    """A copy of ``model`` with its weight matrices (wte/lm_head, wpe, every
    Linear weight) stored in the compute dtype, for serving; LayerNorm
    parameters and biases stay fp32 (infer/decode.py:29-61). Decoding
    reads every weight once per token, so this halves the bytes it moves;
    the matmuls cast to the compute dtype anyway."""
    out = copy.deepcopy(model)
    for p in out.parameters():
        if p.is_floating_point() and p.dim() >= 2:
            p.data = p.data.to(policy.compute_dtype)
    return out


class Decoder:
    """Prefill + decode loop for a fixed config and policy."""

    def __init__(self, cfg: GPTConfig, *, policy: Policy = DEFAULT_POLICY,
                 sample_fn: Callable = sample_top_k):
        self.cfg = cfg
        self.policy = policy
        self.sample_fn = sample_fn

    @torch.no_grad()
    def prefill_tokens(self, model, ids, cache, slot: int, pos_offset: int = 0, z=None):
        """Embed ids at positions pos_offset.. and prefill at ``slot``.
        Returns (last-position logits (B, V), cache)."""
        embeds = gpt2.embed_tokens(model, ids, self.cfg, pos_offset=pos_offset)
        return self.prefill_embeds(model, embeds, cache, slot, z=z)

    @torch.no_grad()
    def prefill_embeds(self, model, embeds, cache, slot: int, z=None):
        """Prefill raw embeddings (a visual prefix: no positional embeddings)."""
        embeds = embeds.to(self.policy.compute_dtype)
        logits, cache = gpt2.forward_cached(
            model, embeds, self.cfg, cache, slot, z=z, policy=self.policy,
            last_only=True,
        )
        return logits[:, -1, :], cache

    @torch.no_grad()
    def prefill_embeds_cache_only(self, model, embeds, cache, slot: int):
        """Like prefill_embeds, but only fills the cache (no lm_head)."""
        embeds = embeds.to(self.policy.compute_dtype)
        gpt2.run_blocks_cached(model, embeds, self.cfg, cache, slot, self.policy)
        return cache

    @torch.no_grad()
    def generate(self, model, prompt_ids, max_new_tokens: int,
                 generator: Optional[torch.Generator], *, prefix_embeds=None,
                 z=None, max_len: Optional[int] = None):
        """Sample continuations. Returns ((B, max_new_tokens) new ids, cache).

        prompt_ids: (B, Tp) int. prefix_embeds: optional (B, M, D) visual
        prefix placed before the prompt without positional embeddings. z:
        optional (B, N, C) projected visual memory of the cross-attention
        variant, attended to by every block at every step.
        """
        b, tp = prompt_ids.shape
        m = 0 if prefix_embeds is None else prefix_embeds.shape[1]
        total = m + tp + max_new_tokens
        max_len = max_len or total
        if max_len < total:
            raise ValueError(f"max_len {max_len} < prefix + prompt + new = {total}")
        if tp + max_new_tokens > self.cfg.block_size:
            raise ValueError(
                f"prompt + new tokens = {tp + max_new_tokens} exceeds "
                f"block_size {self.cfg.block_size}"
            )
        cache = gpt2.init_cache(self.cfg, b, max_len, self.policy.compute_dtype,
                                device=prompt_ids.device)
        slot = 0
        if prefix_embeds is not None:
            cache = self.prefill_embeds_cache_only(model, prefix_embeds, cache, slot)
            slot = m
        logits, cache = self.prefill_tokens(model, prompt_ids, cache, slot, z=z)
        slot, pos = m + tp, tp
        wte = model.transformer.wte.weight
        wpe = model.transformer.wpe.weight
        toks = [self.sample_fn(generator, logits)]
        for _ in range(max_new_tokens - 1):
            embeds = (wte[toks[-1]] + wpe[pos])[:, None, :]
            logits, cache = gpt2.forward_cached(
                model, embeds.to(self.policy.compute_dtype), self.cfg, cache,
                slot, z=z, policy=self.policy, last_only=True,
            )
            toks.append(self.sample_fn(generator, logits[:, -1, :]))
            slot, pos = slot + 1, pos + 1
        return torch.stack(toks, dim=1), cache


def generate(model, cfg: GPTConfig, prompt_ids, max_new_tokens: int, generator,
             *, sample_fn: Callable = sample_top_k,
             policy: Policy = DEFAULT_POLICY, **kw):
    """One-shot convenience wrapper around Decoder."""
    dec = Decoder(cfg, policy=policy, sample_fn=sample_fn)
    toks, _ = dec.generate(model, prompt_ids, max_new_tokens, generator, **kw)
    return toks
