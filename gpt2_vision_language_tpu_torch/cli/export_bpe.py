"""CLI: serialize tiktoken's GPT-2 BPE tables for offline use.

    python -m gpt2_vision_language_tpu_torch.cli.export_bpe --out gpt2_bpe
    python -m gpt2_vision_language_tpu_torch.cli.export_bpe --from-hf PATH --out gpt2_bpe
    python -m gpt2_vision_language_tpu_torch.cli.export_bpe --scan --out gpt2_bpe

The port's own copy of gpt2_vision_language_tpu/cli/export_bpe.py (same
flags, output and exit codes). Run the first form once on a machine with
network (or a warm tiktoken cache); copy the resulting directory to the
machine that trains and set GPT2_BPE_DIR to it. Air-gapped runs then use the
real GPT-2 vocabulary (reference: train_gpt2.py:241) through
data.tokenizer.LocalBpeTokenizer instead of the byte-fallback. --from-hf and
--scan work offline, on HuggingFace GPT-2 tokenizer files already on disk.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="gpt2_bpe", help="output directory")
    p.add_argument(
        "--from-hf", default=None, metavar="PATH",
        help="build from OFFLINE HuggingFace assets instead of tiktoken: a "
        "tokenizer.json, a vocab.json, or a directory holding "
        "vocab.json+merges.txt",
    )
    p.add_argument(
        "--scan", action="store_true",
        help="search common cache locations for HF GPT-2 tokenizer data "
        "and export from the first hit",
    )
    args = p.parse_args(argv)

    from ..data.bpe_export import (
        export_bpe,
        export_bpe_from_hf,
        iter_hf_gpt2_asset_candidates,
    )

    if args.scan:
        # try every candidate: the sniff also matches RoBERTa-family
        # caches (byte-level BPE, no <|endoftext|>) that export_bpe_from_hf
        # rightly rejects — skip those and keep scanning
        kind = src = None
        for cand in iter_hf_gpt2_asset_candidates():
            try:
                kind = export_bpe_from_hf(cand, args.out)
                src = cand
                break
            except ValueError as e:
                print(f"scan: skipping {cand}: {e}")
        if src is None:
            print(
                "scan: no offline GPT-2 tokenizer data found (no HF cache, "
                "no vocab.json/merges.txt, no tokenizer.json) — the "
                "real-vocab gap is environmental; run this on an online "
                "machine instead"
            )
            return 1
        print(f"scan hit: {src} ({kind})")
    elif args.from_hf:
        kind = export_bpe_from_hf(args.from_hf, args.out)
        print(f"converted {args.from_hf} ({kind})")
    else:
        export_bpe(args.out)
    print(f"wrote {args.out}/encoder.json and {args.out}/vocab.bpe")
    print(f"set GPT2_BPE_DIR={args.out} to use them")


if __name__ == "__main__":
    import sys

    sys.exit(main())
