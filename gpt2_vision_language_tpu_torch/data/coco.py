"""COCO captions + precomputed CLIP-token dataset.

The port's own copy of gpt2_vision_language_tpu/data/coco.py: the host side
(index, caption encoding, dataset, batcher, synthetic writer) is the same code
and gives the same batches from the same files; ``build_pooled_feature_bank``
returns a torch tensor on the device it is given.

Replaces torchvision `CocoCaptions` + `CocoClipFullTokensDataset`
(gpt2_linear/data.py:16-63) with a dependency-free implementation:

  * `CocoCaptionsIndex` parses `captions_{split}2017.json` directly and
    reproduces torchvision's ordering: image ids sorted ascending, captions
    per image in annotation-file order.
  * `CocoClipTokensDataset` pairs captions with precomputed CLIP patch-token
    shards via `index.json` (list: idx -> {"shard", "row"}), keeping the
    reference's single-shard LRU cache (:58-61). Shards may be `.npy`
    (ours) or `.pt` (reference's torch.save format, loaded via torch if
    available).
  * `_encode_caption` parity (:35-49): truncate to max_len-1, append EOT,
    pad with EOT, shifted x/y, bool mask over the first max(L-1, 1) targets.
  * random caption choice per sample (:53) with an explicit seeded RNG.
  * `CocoBatcher`: shuffled, drop_last batching that stacks whole
    grad-accumulation windows for single-transfer device feeding; the
    33-token pooling happens on the device, once, when the bank is built.

A synthetic-dataset writer generates valid annotation + shard + index files
for tests and benchmarks (real COCO requires network access).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np


class CocoCaptionsIndex:
    """idx -> (image_id, [captions...]) with torchvision-compatible order."""

    def __init__(self, ann_path: str):
        with open(ann_path) as f:
            ann = json.load(f)
        caps: Dict[int, List[str]] = {}
        for a in ann["annotations"]:
            caps.setdefault(a["image_id"], []).append(a["caption"])
        self.ids = sorted(img["id"] for img in ann["images"])
        self.captions = [caps.get(i, [""]) for i in self.ids]

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx: int) -> List[str]:
        return self.captions[idx]


def _load_shard(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path, mmap_mode="r")
    # reference shards are torch.save'd tensors (gpt2_linear/data.py:60)
    import torch

    return torch.load(path, map_location="cpu").numpy()


def encode_caption(text: str, tokenizer, max_len: int):
    """Reference _encode_caption (gpt2_linear/data.py:35-49)."""
    ids = tokenizer.encode(text)
    if len(ids) == 0:
        ids = [tokenizer.eot_token]
    ids = ids[: max_len - 1] + [tokenizer.eot_token]
    L = len(ids)
    if L < max_len:
        ids = ids + [tokenizer.eot_token] * (max_len - L)
    ids = np.asarray(ids, np.int32)
    x = ids[:-1]
    y = ids[1:]
    valid = max(L - 1, 1)
    mask = np.zeros_like(y, bool)
    mask[:valid] = True
    return x, y, mask


class CocoClipTokensDataset:
    def __init__(
        self,
        tokens_dir: str,
        ann_path: str,
        tokenizer,
        max_len: int,
        *,
        seed: int = 0,
    ):
        self.tokens_dir = tokens_dir
        self.coco = CocoCaptionsIndex(ann_path)
        self.tokenizer = tokenizer
        self.max_len = max_len
        with open(os.path.join(tokens_dir, "index.json")) as f:
            self.index = json.load(f)
        assert len(self.index) == len(self.coco), "index.json length mismatch with COCO"
        self._shard_name: Optional[str] = None
        self._shard: Optional[np.ndarray] = None
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.coco)

    def features(self, idx: int) -> np.ndarray:
        entry = self.index[idx]
        name = entry["shard"]
        if name != self._shard_name:
            self._shard = _load_shard(os.path.join(self.tokens_dir, name))
            self._shard_name = name
        return np.asarray(self._shard[entry["row"]], np.float32)

    def __getitem__(self, idx: int):
        caps = self.coco[idx]
        text = self.rng.choice(caps)
        x, y, m = encode_caption(text, self.tokenizer, self.max_len)
        z = self.features(idx)
        return x, y, m, z


class CocoBatcher:
    """Shuffled epoch iterator over (B, ...) numpy batches, drop_last=True
    for train (gpt2_linear/train.py:90-93). Restarting iteration reshuffles,
    mirroring DataLoader(shuffle=True) epoch semantics.

    Batches are ALWAYS exactly B rows (as in the JAX package): with
    drop_last=False an epoch tail shorter than B wraps into the next epoch
    to fill the batch. `rank`/`world` stride the epoch order across
    processes for multi-host data parallelism.

    reset() rewinds to the epoch start without reshuffling — used by the
    validation loop so every eval scores the SAME leading window
    (reference re-iterates a fresh val_loader each validation,
    gpt2_linear/train.py:225)."""

    def __init__(self, dataset: CocoClipTokensDataset, batch_size: int,
                 *, shuffle: bool = True, drop_last: bool = True, seed: int = 0,
                 rank: int = 0, world: int = 1):
        self.ds = dataset
        self.B = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rank = rank
        self.world = world
        assert len(dataset) >= world, (
            f"dataset of {len(dataset)} rows cannot stride across "
            f"{world} processes (rank {rank} would spin forever on an "
            "empty epoch order)"
        )
        self.rng = np.random.RandomState(seed)
        # Caption draws are a PURE FUNCTION of (seed, epoch, dataset row)
        # (_draw_caption) — not a sequential stream. Two properties ride
        # on that: (1) reset() makes a validation batcher score the SAME
        # (image, caption) pairs every eval (val-loss deltas measure the
        # model, not draw noise); (2) the pairing is TOPOLOGY-INVARIANT —
        # N rank-strided batchers assemble bitwise the same global batch
        # as one batcher (a per-rank stream consumed draws only for its
        # own rows, so the pairing depended on the process count — caught
        # by test_two_process_finetune_matches_single_process, r5).
        self._cap_seed = seed ^ 0x5A5A
        self._base = np.arange(len(dataset))
        self._pos = 0
        self._epoch = -1
        self._new_epoch()

    def _new_epoch(self):
        if self.shuffle:
            self.rng.shuffle(self._base)
        self._order = self._base[self.rank :: self.world]
        self._pos = 0
        self._epoch += 1

    def reset(self):
        """Rewind to epoch 0's start (no reshuffle), so a validation pass
        scores identical (image, caption) pairs every time. Only
        meaningful for shuffle=False batchers (the val loop): a shuffled
        batcher's _order no longer matches epoch 0's. (The streaming
        next_batch path draws inside the dataset and is not made
        reproducible here — the finetune workload validates through
        next_index_batch.)"""
        self._pos = 0
        self._epoch = 0

    def _draw_caption(self, row: int, n: int, epoch: int) -> int:
        """Deterministic caption pick for `row` in `epoch`: splitmix64 of
        (cap_seed, epoch, row), reduced mod n."""
        h = (
            self._cap_seed * 0x9E3779B97F4A7C15
            + epoch * 0xBF58476D1CE4E5B9
            + int(row) * 0x94D049BB133111EB
        ) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 30
        h = (h * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 27
        h = (h * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
        return h % n

    def steps_per_epoch(self) -> int:
        n = len(self._order)
        return n // self.B if self.drop_last else -(-n // self.B)

    def _next_idxs(self):
        """Next B dataset rows plus the epoch each row was drawn in (a
        drop_last=False tail wraps into the next epoch mid-batch; caption
        draws must key on the ROW's epoch, not the batcher's final one,
        or wrap timing would differ across process topologies)."""
        if self._pos + self.B > len(self._order):
            if self.drop_last or self._pos >= len(self._order):
                self._new_epoch()
        idxs = self._order[self._pos : self._pos + self.B]
        epochs = np.full(len(idxs), self._epoch)
        self._pos += len(idxs)
        while len(idxs) < self.B:  # wrap tail into the next epoch
            self._new_epoch()
            take = self._order[: self.B - len(idxs)]
            self._pos = len(take)
            idxs = np.concatenate([idxs, take])
            epochs = np.concatenate([epochs, np.full(len(take), self._epoch)])
        return idxs, epochs

    def skip_batches(self, n: int) -> None:
        """Advance by n batches without encoding them: a resumed run's data
        stream goes on where the uninterrupted run would be (a port-only
        addition; the JAX trainer has no resume)."""
        for _ in range(n):
            self._next_idxs()

    def next_batch(self):
        idxs, _ = self._next_idxs()
        xs, ys, ms, zs = zip(*(self.ds[int(i)] for i in idxs))
        return (
            np.stack(xs),
            np.stack(ys),
            np.stack(ms),
            np.stack(zs),
        )

    def next_accum_batch(self, k: int):
        outs = [self.next_batch() for _ in range(k)]
        return tuple(np.stack([o[i] for o in outs]) for i in range(4))

    # -- index mode (device-resident feature bank) ------------------------

    def next_index_batch(self):
        """(x, y, mask, idx) — features are looked up ON DEVICE in a
        preloaded bank; only token ids cross the host->device boundary."""
        idxs, epochs = self._next_idxs()
        xs, ys, ms = [], [], []
        for i, ep in zip(idxs, epochs):
            caps = self.ds.coco[int(i)]
            text = caps[self._draw_caption(int(i), len(caps), int(ep))]
            x, y, m = encode_caption(text, self.ds.tokenizer, self.ds.max_len)
            xs.append(x)
            ys.append(y)
            ms.append(m)
        return (
            np.stack(xs),
            np.stack(ys),
            np.stack(ms),
            np.asarray(idxs, np.int32),
        )

    def next_accum_index_batch(self, k: int):
        outs = [self.next_index_batch() for _ in range(k)]
        return tuple(np.stack([o[i] for o in outs]) for i in range(4))


def build_pooled_feature_bank(
    dataset: CocoClipTokensDataset,
    pool_fn,
    *,
    chunk: int = 256,
    dtype=None,
    device=None,
):
    """Stream every shard through `pool_fn` ((n, L, D) -> (n, 33, D)) once
    and return the full pooled bank as one tensor on ``device``.

    The reference streams the FULL 197/257-token CLIP features per sample
    every step, ~300 KB a sample, gigabytes per optimizer step across the
    host->device link. Pooled 33-token features for all of COCO train fit in
    device memory (118k x 33 x 768 bf16 ~= 6 GB), so the transfer is paid once
    and rows are gathered on the device per micro-batch.
    """
    import torch

    # group indices by shard to read each shard exactly once, in order
    per_shard = {}
    for i, e in enumerate(dataset.index):
        per_shard.setdefault(e["shard"], []).append((i, e["row"]))
    chunks = []
    order = []
    for shard, entries in sorted(per_shard.items()):
        arr = _load_shard(os.path.join(dataset.tokens_dir, shard))
        rows = np.asarray([r for _, r in entries])
        data = np.asarray(arr, np.float32)[rows]
        for s in range(0, len(data), chunk):
            part = torch.from_numpy(np.ascontiguousarray(data[s : s + chunk])).to(device)
            pooled = pool_fn(part)
            chunks.append(pooled if dtype is None else pooled.to(dtype))
            order.extend(i for i, _ in entries[s : s + chunk])
    bank = torch.cat(chunks, dim=0)
    # free the per-chunk tensors BEFORE any reorder: peak device memory is
    # then ~2x the bank (concat inputs+output; gather in+out), never 3x
    chunks.clear()
    order = np.asarray(order)
    if np.array_equal(order, np.arange(len(order))):
        return bank  # index.json already in shard order: no gather needed
    inv = np.empty(len(order), np.int64)
    inv[order] = np.arange(len(order))
    return bank[torch.from_numpy(inv).to(bank.device)]


# ---------------------------------------------------------------------------
# Synthetic dataset + CLIP-feature shard writer
# ---------------------------------------------------------------------------

_WORDS = (
    "a the red blue small large cat dog person car tree kitchen beach plate "
    "table man woman riding holding standing sitting group young food water"
).split()


def write_clip_feature_shards(
    tokens_dir: str,
    features: np.ndarray,
    *,
    rows_per_shard: int = 512,
) -> None:
    """features (N, L, D) -> .npy shards + index.json (our shard format)."""
    os.makedirs(tokens_dir, exist_ok=True)
    index = []
    for s in range(0, len(features), rows_per_shard):
        chunk = features[s : s + rows_per_shard]
        name = f"clip_tokens_{s // rows_per_shard:05d}.npy"
        np.save(os.path.join(tokens_dir, name), chunk.astype(np.float16))
        index.extend(
            {"shard": name, "row": i} for i in range(len(chunk))
        )
    with open(os.path.join(tokens_dir, "index.json"), "w") as f:
        json.dump(index, f)


def write_synthetic_coco(
    root: str,
    *,
    split: str = "train",
    n_images: int = 64,
    n_tokens: int = 197,
    enc_dim: int = 32,
    seed: int = 0,
) -> Tuple[str, str]:
    """-> (tokens_dir, ann_path): fake COCO annotations + CLIP shards."""
    rng = np.random.RandomState(seed)
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    images = [{"id": 1000 + i} for i in range(n_images)]
    annotations = []
    for i in range(n_images):
        for c in range(5):
            words = rng.choice(_WORDS, size=rng.randint(4, 9))
            annotations.append(
                {
                    "image_id": 1000 + i,
                    "id": i * 5 + c,
                    "caption": " ".join(words),
                }
            )
    ann_path = os.path.join(ann_dir, f"captions_{split}2017.json")
    with open(ann_path, "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)

    feats = rng.randn(n_images, n_tokens, enc_dim).astype(np.float32)
    tokens_dir = os.path.join(root, "clip_feats", split)
    write_clip_feature_shards(tokens_dir, feats, rows_per_shard=32)
    return tokens_dir, ann_path
