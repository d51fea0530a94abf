"""CLI: tokenize a local text corpus into FineWeb-style uint16 token shards.

    python -m gpt2_vision_language_tpu_torch.cli.prepare_fineweb \
        --input docs.jsonl [--text-key text] --out edu_fineweb10B \
        [--shard-tokens 100000000] [--val-shards 1]

The port's own copy of gpt2_vision_language_tpu/cli/prepare_fineweb.py, on
the port's data.fineweb.write_token_shard and data.tokenizer.get_tokenizer:
the same flags and the same shard files, byte for byte. It works offline on
local files and touches no device.

The reference consumes `edu_fineweb10B/` shards whose preparation script
was never checked in (SURVEY.md §6 defect c; DataLoaderLite expects files
with "train"/"val" in the name, train_gpt2.py:161-165). This produces that
exact format from a local `.jsonl` (one document per line) or plain `.txt`
(one document per paragraph): each document is tokenized and terminated
with EOT, packed into fixed-size uint16 shards.
"""

from __future__ import annotations

import argparse
import json
import os


def _iter_documents(path: str, text_key: str):
    if path.endswith(".jsonl"):
        with open(path) as f:
            for line in f:
                if line.strip():
                    yield json.loads(line)[text_key]
    else:
        with open(path) as f:
            for para in f.read().split("\n\n"):
                if para.strip():
                    yield para


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True, help=".jsonl or .txt corpus")
    p.add_argument("--text-key", default="text")
    p.add_argument("--out", required=True)
    p.add_argument("--shard-tokens", type=int, default=100_000_000,
                   help="tokens per shard (reference uses ~100M)")
    p.add_argument("--val-shards", type=int, default=1,
                   help="number of leading shards assigned to the val split")
    args = p.parse_args(argv)

    import numpy as np

    from ..data.fineweb import write_token_shard
    from ..data.tokenizer import get_tokenizer

    tok = get_tokenizer()
    print(f"[prepare] tokenizer: {tok.name}")
    os.makedirs(args.out, exist_ok=True)

    buf = np.empty(args.shard_tokens, np.uint16)
    filled = 0
    shard_id = 0
    total = 0

    def flush():
        nonlocal filled, shard_id
        if filled == 0:
            return
        split = "val" if shard_id < args.val_shards else "train"
        name = f"edufineweb_{split}_{shard_id:06d}.npy"
        write_token_shard(os.path.join(args.out, name), buf[:filled])
        print(f"[prepare] wrote {name} ({filled:,} tokens)")
        shard_id += 1
        filled = 0

    for doc in _iter_documents(args.input, args.text_key):
        ids = tok.encode(doc) + [tok.eot_token]
        pos = 0
        while pos < len(ids):
            take = min(len(ids) - pos, args.shard_tokens - filled)
            buf[filled : filled + take] = ids[pos : pos + take]
            filled += take
            pos += take
            total += take
            if filled == args.shard_tokens:
                flush()
    flush()
    print(f"[prepare] total {total:,} tokens in {shard_id} shards -> {args.out}")
    if shard_id <= args.val_shards:
        p.error(
            f"corpus produced only {shard_id} shard(s), all assigned to the "
            f"val split — the train split would be EMPTY. Re-run with a "
            f"smaller --shard-tokens (e.g. {max(1024, total // 4)}) or "
            f"--val-shards 0."
        )


if __name__ == "__main__":
    main()
