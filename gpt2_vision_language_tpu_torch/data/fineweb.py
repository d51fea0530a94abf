"""FineWeb-Edu token-shard pipeline.

The port's own copy of gpt2_vision_language_tpu/data/fineweb.py (numpy
only; same names, same batches from the same files), without the optional
C++ prefetching reader and the device-side row splitters.

Loader reproduces `DataLoaderLite` semantics exactly
(train_gpt2.py:149-187): uint16/int32 `.npy` shards in `$FW_OUT_DIR`
(default `edu_fineweb10B`), filename-filtered by split, sorted; per-rank
disjoint striding `pos0 = B*T*rank`, advance `B*T*world`, wrap to the next
shard when fewer than B*T*world+1 tokens remain; `next_batch()` returns
(x, y) = (buf[:-1], buf[1:]) reshaped (B, T).

Extras the reference lacks:
  * `next_accum_batch(k)` / `next_accum_rowbuf(k)` return the whole
    grad-accumulation window so it ships to the device in ONE transfer;
  * shards are memory-mapped (np.load mmap_mode) so shard switches don't
    re-read 100M tokens through the page cache eagerly;
  * a shard writer + synthetic-corpus generator (the reference's prep
    script is absent from its repo, SURVEY.md §6 defect c).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np


def list_shards(data_dir: str, split: str) -> List[str]:
    assert split in ("train", "val")
    names = sorted(s for s in os.listdir(data_dir) if split in s)
    assert names, f"no shards found for split {split} in {data_dir}"
    return [os.path.join(data_dir, s) for s in names]


def load_tokens(path: str) -> np.ndarray:
    arr = np.load(path, mmap_mode="r")
    return arr


class TokenShardLoader:
    """Per-rank strided reader over memory-mapped token shards
    (DataLoaderLite parity)."""

    def __init__(
        self,
        batch_size: int,
        seq_len: int,
        *,
        rank: int = 0,
        world_size: int = 1,
        split: str = "train",
        data_dir: Optional[str] = None,
    ):
        self.B = batch_size
        self.T = seq_len
        self.rank = rank
        self.world = world_size
        data_dir = data_dir or os.environ.get("FW_OUT_DIR", "edu_fineweb10B")
        self.shards = list_shards(data_dir, split)
        self.reset()

    def _open(self, path: str):
        return load_tokens(path)

    def reset(self) -> None:
        window = self.B * self.T * self.world + 1
        need = window + self.B * self.T * self.rank
        for i, path in enumerate(self.shards):
            tokens = self._open(path)
            if len(tokens) >= need:
                self.current_shard = i
                self.tokens = tokens
                break
        else:
            raise ValueError(f"no shard holds a full window of {window} tokens")
        self.pos = self.B * self.T * self.rank

    def _advance(self) -> None:
        self.pos += self.B * self.T * self.world
        if self.pos + (self.B * self.T * self.world + 1) > len(self.tokens):
            window = self.B * self.T * self.world + 1
            need = window + self.B * self.T * self.rank
            for _ in range(len(self.shards)):
                self.current_shard = (self.current_shard + 1) % len(self.shards)
                self.tokens = self._open(self.shards[self.current_shard])
                if len(self.tokens) >= need:
                    break  # skip shards too small for one read window
            else:
                raise ValueError(
                    f"no shard holds a full window of {window} tokens"
                )
            self.pos = self.B * self.T * self.rank

    def seek(self, n_batches: int) -> None:
        """Position the loader as if `n_batches` next_batch() calls had run
        since reset(), without reading any tokens — O(#shards), closed-form
        per shard visit.

        This is the resume half the reference never had: its auto-resume
        restores only step/optimizer (train_gpt2.py:319-325) and
        DataLoaderLite restarts at shard 0, silently re-training the early
        corpus after every crash. Here run_pretrain seeks the train loader
        to `start_step * accum` so a resumed trajectory consumes exactly
        the tokens the uninterrupted run would have."""
        stride = self.B * self.T * self.world
        window = stride + 1
        r0 = self.B * self.T * self.rank
        need = window + r0
        lens: list = [None] * len(self.shards)

        def length(i: int) -> int:
            if lens[i] is None:
                lens[i] = len(self._open(self.shards[i]))
            return lens[i]

        def cap(i: int) -> int:
            # batches consumable per visit: reads at r0 + j*stride while
            # the NEXT pos + window still fits (mirrors _advance's wrap)
            return (length(i) - r0 - window) // stride + 1

        # entry shard: reset() semantics (first shard holding a window)
        order = [i for i in range(len(self.shards)) if length(i) >= need]
        if not order:
            raise ValueError(f"no shard holds a full window of {window} tokens")
        n = int(n_batches)
        cur = order[0]
        if n >= cap(cur):
            # after the entry visit, visits cycle through qualifying shards
            # starting after the entry shard (wrap order of _advance)
            n -= cap(cur)
            k = order.index(cur)
            cycle = order[k + 1 :] + order[: k + 1]
            n %= sum(cap(i) for i in cycle)  # skip whole epochs
            for i in cycle:
                if n < cap(i):
                    cur = i
                    break
                n -= cap(i)
        self.current_shard = cur
        self.tokens = self._open(self.shards[cur])
        self.pos = r0 + n * stride

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        b, t = self.B, self.T
        buf = np.asarray(self.tokens[self.pos : self.pos + b * t + 1], np.int32)
        x = buf[:-1].reshape(b, t)
        y = buf[1:].reshape(b, t)
        self._advance()
        return x, y

    def next_accum_batch(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(k, B, T) x/y stack for one optimizer step's scan."""
        xs = np.empty((k, self.B, self.T), np.int32)
        ys = np.empty((k, self.B, self.T), np.int32)
        for i in range(k):
            xs[i], ys[i] = self.next_batch()
        return xs, ys

    def next_accum_rowbuf(self, k: int) -> np.ndarray:
        """(k, B, T+1) uint16 row buffers with 1-token overlap between
        consecutive rows: row b = window[b*T : (b+1)*T + 1], so on device
        x = rows[..., :-1] and y = rows[..., 1:] reproduce
        x=buf[:-1], y=buf[1:] (train_gpt2.py:179-181).

        Unlike the flat (B*T+1,) buffer this layout concatenates cleanly
        across processes on the batch axis (each rank's rows are disjoint
        (B,T) slices of the global batch plus their own shifted-target
        token), at the same ~2 bytes/token host->device cost."""
        out = np.empty((k, self.B, self.T + 1), np.uint16)
        n = self.B * self.T + 1
        for i in range(k):
            w = np.asarray(self.tokens[self.pos : self.pos + n])
            out[i] = np.lib.stride_tricks.sliding_window_view(
                w.astype(np.uint16), self.T + 1
            )[:: self.T]
            self._advance()
        return out

    def next_accum_buf(self, k: int) -> np.ndarray:
        """(k, B*T+1) uint16 raw buffers: x = buf[:-1], y = buf[1:] are
        derived on the device, quartering host->device bytes vs int32 x+y."""
        out = np.empty((k, self.B * self.T + 1), np.uint16)
        for i in range(k):
            buf = np.asarray(
                self.tokens[self.pos : self.pos + self.B * self.T + 1]
            )
            out[i] = buf.astype(np.uint16)
            self._advance()
        return out


def write_token_shard(path: str, tokens: np.ndarray) -> None:
    """Write a uint16 token shard (the format DataLoaderLite consumes)."""
    tokens = np.asarray(tokens)
    assert tokens.max() < 2**16
    np.save(path, tokens.astype(np.uint16))


def write_synthetic_corpus(
    data_dir: str,
    *,
    vocab_size: int = 50257,
    shard_tokens: int = 1 << 20,
    n_train: int = 2,
    n_val: int = 1,
    seed: int = 0,
    kind: str = "zipf",
) -> None:
    """Synthetic corpus for tests/benchmarks (the real FineWeb-Edu download
    needs network access).

    kind="zipf": i.i.d. Zipf tokens — a trained model can at best match the
    unigram entropy, so loss curves flatline early; fine for smoke tests.
    kind="markov": Zipf-drawn pairs ``(a, perm[a])`` for a fixed secret
    permutation — the optimal loss is ~half the unigram entropy, reached
    only by LEARNING the pairing, so sustained-training loss curves show
    genuine structure acquisition (odd positions approach CE 0 as the
    model memorizes perm; even positions stay at the Zipf prior)."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    perm = rng.permutation(vocab_size) if kind == "markov" else None
    for split, n in (("train", n_train), ("val", n_val)):
        for i in range(n):
            if kind == "markov":
                a = rng.choice(vocab_size, size=shard_tokens // 2, p=probs)
                toks = np.stack([a, perm[a]], axis=1).reshape(-1)
            else:
                toks = rng.choice(vocab_size, size=shard_tokens, p=probs)
            write_token_shard(
                os.path.join(data_dir, f"edufineweb_{split}_{i:06d}.npy"), toks
            )
