"""HellaSwag multiple-choice evaluation.

Counterpart of gpt2_vision_language_tpu/eval/hellaswag.py (:37-212), reading
a local jsonl (``$HELLASWAG_DIR/hellaswag_{split}.jsonl``, no network):

  * rendering: context tokens + " " + ending tokens per candidate, bool mask
    over the ending region, 4 rows padded to a common length;
  * scoring: per-token CE on shifted logits, masked mean over the completion,
    argmin over the 4 candidates (reference get_most_likely_row,
    train_gpt2.py:190-202);
  * execution: examples are padded into fixed-size batches of bucketed width
    and scored by one forward per batch, under ``torch.no_grad()``, instead
    of a Python loop of one 4-row forward per example (train_gpt2.py:398-409);
  * sharding round-robin by rank with summed counts (train_gpt2.py:399,
    410-416): each rank scores its own stride of the examples and the caller
    sums (correct, total).
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional

import numpy as np
import torch

from ..core.config import GPTConfig
from ..core.precision import Policy, DEFAULT_POLICY
from ..models import gpt2


def iterate_examples(split: str, data_dir: Optional[str] = None) -> Iterator[dict]:
    data_dir = data_dir or os.environ.get("HELLASWAG_DIR", "hellaswag")
    path = os.path.join(data_dir, f"hellaswag_{split}.jsonl")
    with open(path) as f:
        for line in f:
            if line.strip():
                yield json.loads(line)


def render_example(example: dict, tokenizer):
    """-> (tokens (4, L) int32, mask (4, L) bool, label int), numpy. Rows
    padded to the longest candidate; pad tokens are masked out."""
    ctx = tokenizer.encode(example["ctx"])
    rows, masks = [], []
    for end in example["endings"]:
        end_tok = tokenizer.encode(" " + end)
        rows.append(ctx + end_tok)
        masks.append([0] * len(ctx) + [1] * len(end_tok))
    maxlen = max(len(r) for r in rows)
    tokens = np.zeros((4, maxlen), np.int32)
    mask = np.zeros((4, maxlen), bool)
    for i, (r, m) in enumerate(zip(rows, masks)):
        tokens[i, : len(r)] = r
        mask[i, : len(m)] = m
    return tokens, mask, int(example["label"])


def ending_losses(tokens, mask, logits):
    """Masked-mean shifted CE of each candidate (train_gpt2.py:190-202):
    tokens (..., N, L), mask (..., N, L) over completion tokens, logits
    (..., N, L, V) -> (..., N) fp32. The logsumexp and the gold logit are
    taken in fp32 (the upcast of bf16 logits is exact)."""
    shift_logits = logits[..., :-1, :]
    shift_tokens = tokens[..., 1:].long()
    logz = torch.logsumexp(shift_logits.float(), dim=-1)
    gold = shift_logits.gather(-1, shift_tokens[..., None])[..., 0].float()
    losses = logz - gold
    shift_mask = mask[..., 1:].to(losses.dtype)
    return (losses * shift_mask).sum(-1) / shift_mask.sum(-1).clamp(min=1)


def most_likely_row(tokens, mask, logits):
    """The candidate of least ``ending_losses``: the argmin over N."""
    return ending_losses(tokens, mask, logits).argmin(-1)


class HellaSwagEvaluator:
    """Batched evaluation over bucketed (batch, 4, L) shapes.

    Examples are scored at FULL length (the reference forwards each example
    unclipped, train_gpt2.py:398-409): each batch is padded to the smallest
    width bucket >= its longest row. Examples longer than max_len (default:
    the model's block_size, the hard ceiling) are SKIPPED and counted, never
    scored truncated, which could flip predictions."""

    def __init__(
        self,
        cfg: GPTConfig,
        *,
        policy: Policy = DEFAULT_POLICY,
        max_len: Optional[int] = None,
        batch_examples: int = 8,
    ):
        self.cfg = cfg
        self.policy = policy
        self.max_len = max_len or cfg.block_size
        self.batch = batch_examples
        self.skipped_too_long = 0  # examples whose tokens exceeded max_len
        self.buckets = sorted(
            {b for b in (64, 128, 256, 512) if b < self.max_len}
            | {self.max_len}
        )

    @torch.no_grad()
    def _predict(self, model, tokens, mask):
        """tokens (N, 4, L) numpy -> predicted candidate per example (N,)."""
        device = next(model.parameters()).device
        tokens = torch.from_numpy(tokens).to(device)
        mask = torch.from_numpy(mask).to(device)
        n = tokens.shape[0]
        flat = tokens.reshape(n * 4, -1).long()
        logits, _ = gpt2.apply(model, flat, self.cfg, policy=self.policy)
        logits = logits.reshape(n, 4, flat.shape[1], -1)
        return most_likely_row(tokens, mask, logits).cpu().numpy()

    def evaluate(
        self,
        model,
        tokenizer,
        *,
        split: str = "val",
        data_dir: Optional[str] = None,
        rank: int = 0,
        world_size: int = 1,
        limit: Optional[int] = None,
    ):
        """-> (num_correct, num_total) on this rank's shard of examples.

        With world_size > 1 every rank runs the same number of forwards at
        one fixed width: each rank's flush count is padded to a common upper
        bound with dummy batches (discarded), so ranks that hold shards of
        one model stay in lock step, as the JAX evaluator's do. The caller
        sums (correct, total) across ranks."""
        tok_buf, mask_buf, labels = [], [], []
        correct = total = 0
        # per-eval counter: the evaluator is reused across the training run
        self.skipped_too_long = 0
        lockstep = world_size > 1

        def flush():
            nonlocal correct, total
            n = len(tok_buf)
            if lockstep or n == 0:
                width = self.max_len
            else:
                lmax = max(t.shape[1] for t in tok_buf)
                width = next(b for b in self.buckets if b >= lmax)
            tokens = np.zeros((self.batch, 4, width), np.int32)
            mask = np.zeros((self.batch, 4, width), bool)
            for i, (t, m) in enumerate(zip(tok_buf, mask_buf)):
                L = t.shape[1]
                tokens[i, :, :L] = t
                mask[i, :, :L] = m
            preds = self._predict(model, tokens, mask)
            for i in range(n):
                total += 1
                correct += int(preds[i] == labels[i])
            tok_buf.clear()
            mask_buf.clear()
            labels.clear()

        n_examples = 0
        flushes = 0
        for i, ex in enumerate(iterate_examples(split, data_dir)):
            if limit is not None and i >= limit:
                break
            n_examples += 1
            if i % world_size != rank:
                continue
            t, m, label = render_example(ex, tokenizer)
            if t.shape[1] > self.max_len:
                self.skipped_too_long += 1
                continue
            tok_buf.append(t)
            mask_buf.append(m)
            labels.append(label)
            if len(tok_buf) == self.batch:
                flush()
                flushes += 1
        if tok_buf:
            flush()
            flushes += 1
        if lockstep:
            # upper bound on ANY rank's flush count (skips only reduce it)
            per_rank = -(-n_examples // world_size)
            need = -(-per_rank // self.batch)
            while flushes < need:
                flush()  # dummy: empty buffers, results discarded
                flushes += 1
        if self.skipped_too_long:
            print(
                f"[hellaswag] WARNING: {self.skipped_too_long} examples "
                f"exceeded max_len={self.max_len} and were skipped "
                "(not scored)"
            )
        return correct, total
