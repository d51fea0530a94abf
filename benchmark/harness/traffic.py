"""The one generator of training traffic: seeded token shards.

A copy of the port's ``data/fineweb.write_synthetic_corpus`` (kind "zipf"),
kept here so that later changes to the program cannot change the yardstick:
i.i.d. tokens with P(id) proportional to 1 / (id + 1) ** exponent over the
traffic file's vocabulary, written as uint16 ``.npy`` shards in the format the
trainer's ``TokenShardLoader`` reads (``edufineweb_train_<i>.npy``). Every seed
gets the same sizes; only the ids differ. Sampling is by the inverse CDF, from
``numpy.random.default_rng(seed)``, which takes any non-negative integer seed.
"""

from __future__ import annotations

import os

import numpy as np


def zipf_tokens(n: int, vocab: int, exponent: float, rng: np.random.Generator) -> np.ndarray:
    """``n`` i.i.d. ids in [0, vocab) with P(id) proportional to
    1 / (id + 1) ** exponent, as uint16."""
    if vocab > 1 << 16:
        raise ValueError(f"vocab {vocab} does not fit uint16 shards")
    cdf = np.cumsum(1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** exponent)
    cdf /= cdf[-1]
    ids = np.searchsorted(cdf, rng.random(n), side="right")
    return np.minimum(ids, vocab - 1).astype(np.uint16)


def write_shards(data_dir: str, tokens: dict, seed: int) -> list:
    """Write the train shards that the traffic file's ``tokens`` block asks
    for into ``data_dir``; returns their paths in the loader's order."""
    if tokens["distribution"] != "zipf":
        raise ValueError(f"unknown token distribution {tokens['distribution']!r}")
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(int(seed))
    paths = []
    for i in range(int(tokens.get("shards", 1))):
        toks = zipf_tokens(int(tokens["shard_tokens"]), int(tokens["vocab"]),
                           float(tokens.get("exponent", 1.0)), rng)
        path = os.path.join(data_dir, f"edufineweb_train_{i:06d}.npy")
        np.save(path, toks)
        paths.append(path)
    return paths


def step_rows(paths: list, micro_batch: int, seq_len: int, accum: int, steps: int) -> np.ndarray:
    """The (steps, accum, B, T + 1) int64 rows that the trainer's loader hands
    to its first ``steps`` steps, read from the shards as it reads them
    (DataLoaderLite on one process: row b of a micro-batch is
    tokens[pos + b*T : pos + (b+1)*T + 1], pos advancing by B*T). Read
    independently of the program, for the plain reference."""
    tokens = np.load(paths[0], mmap_mode="r")
    need = steps * accum * micro_batch * seq_len + 1
    if len(tokens) < need:
        raise ValueError(f"the first shard holds {len(tokens)} tokens; the checked steps "
                         f"read {need} (raise shard_tokens)")
    out = np.empty((steps, accum, micro_batch, seq_len + 1), np.int64)
    pos = 0
    for s in range(steps):
        for a in range(accum):
            for b in range(micro_batch):
                out[s, a, b] = tokens[pos + b * seq_len: pos + (b + 1) * seq_len + 1]
            pos += micro_batch * seq_len
    return out
