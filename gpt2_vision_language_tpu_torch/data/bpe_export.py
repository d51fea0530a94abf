"""Serialize a tiktoken byte-level BPE into encoder.json + vocab.bpe.

The port's own copy of gpt2_vision_language_tpu/data/bpe_export.py (stdlib
only, tiktoken imported where it is asked for; same names and behaviour, the
same bytes written).

The reference tokenizes with tiktoken's GPT-2 BPE (train_gpt2.py:241),
whose data files live behind a network fetch. On an online machine,

    python -m gpt2_vision_language_tpu_torch.cli.export_bpe --out $GPT2_BPE_DIR

writes the classic `encoder.json` / `vocab.bpe` pair that
`data.tokenizer.LocalBpeTokenizer` consumes fully offline — after which
every air-gapped run tokenizes with the REAL GPT-2 vocabulary instead of
the byte-fallback.

tiktoken exposes only `mergeable_ranks` (token bytes -> rank), not the
merge list; the merges are recovered per token by running the BPE merge
loop restricted to strictly lower ranks — the final two parts of a rank-r
token are exactly the pair whose merge created it. (Standard recovery,
same as HF's tiktoken conversion.)
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's printable byte<->unicode table (same as
    tokenizer.LocalBpeTokenizer._bytes_to_unicode)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _bpe_parts(ranks: Dict[bytes, int], token: bytes, max_rank: int) -> List[bytes]:
    """Merge `token`'s bytes using only merges with rank < max_rank."""
    parts = [bytes([b]) for b in token]
    while len(parts) > 1:
        best_rank, best_i = None, None
        for i in range(len(parts) - 1):
            r = ranks.get(parts[i] + parts[i + 1])
            if r is not None and r < max_rank and (best_rank is None or r < best_rank):
                best_rank, best_i = r, i
        if best_rank is None:
            break
        parts = (
            parts[:best_i]
            + [parts[best_i] + parts[best_i + 1]]
            + parts[best_i + 2 :]
        )
    return parts


def merges_from_mergeable_ranks(
    ranks: Dict[bytes, int],
) -> List[Tuple[bytes, bytes]]:
    """Recover the ordered merge list from token->rank."""
    merges = []
    for token, rank in sorted(ranks.items(), key=lambda kv: kv[1]):
        if len(token) == 1:
            continue
        parts = _bpe_parts(ranks, token, rank)
        assert len(parts) == 2, (
            f"token {token!r} (rank {rank}) did not decompose into a merge "
            f"pair: {parts!r} — not a byte-level BPE?"
        )
        merges.append((parts[0], parts[1]))
    return merges


def export_bpe(out_dir: str, encoding=None, *, specials=("<|endoftext|>",)) -> None:
    """Write encoder.json + vocab.bpe for `encoding` (default: tiktoken
    'gpt2', requires its data to be fetchable/cached)."""
    if encoding is None:
        import tiktoken

        encoding = tiktoken.get_encoding("gpt2")
    ranks = encoding._mergeable_ranks
    byte_enc = bytes_to_unicode()

    def to_str(tok: bytes) -> str:
        return "".join(byte_enc[b] for b in tok)

    encoder = {to_str(tok): rank for tok, rank in ranks.items()}
    for name in specials:
        if name in getattr(encoding, "_special_tokens", {}):
            encoder[name] = encoding._special_tokens[name]
    merges = merges_from_mergeable_ranks(ranks)

    os.makedirs(out_dir, exist_ok=True)
    # utf-8 pinned: token strings contain byte-unicode chars ('Ġ' etc.)
    # outside many locales' charsets, and ensure_ascii=False writes them raw
    with open(
        os.path.join(out_dir, "encoder.json"), "w", encoding="utf-8"
    ) as f:
        json.dump(encoder, f, ensure_ascii=False)
    with open(os.path.join(out_dir, "vocab.bpe"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{to_str(a)} {to_str(b)}\n")


def export_bpe_from_hf(src: str, out_dir: str) -> str:
    """Build encoder.json + vocab.bpe from OFFLINE HuggingFace-format
    assets, closing the no-tiktoken gap when any HF GPT-2 tokenizer data
    exists on disk. Accepts:

      * a `tokenizer.json` (HF fast tokenizer): model.vocab (token->id) +
        model.merges ("a b" strings or [a, b] pairs);
      * a directory holding `vocab.json` + `merges.txt` (classic HF GPT-2
        export — content-identical to encoder.json / vocab.bpe);
      * a `vocab.json` path (merges.txt expected alongside).

    Returns the detected source kind. The output is byte-identical in
    meaning to the tiktoken-derived export: LocalBpeTokenizer consumes it
    and the reference's tiktoken vocabulary (train_gpt2.py:241) is
    reproduced exactly."""
    vocab: Dict[str, int]
    merges: List[str]
    if os.path.isdir(src):
        vj, mt = os.path.join(src, "vocab.json"), os.path.join(src, "merges.txt")
        if not (os.path.exists(vj) and os.path.exists(mt)):
            tj = os.path.join(src, "tokenizer.json")
            if os.path.exists(tj):
                return export_bpe_from_hf(tj, out_dir)
            raise FileNotFoundError(
                f"{src}: need vocab.json+merges.txt or tokenizer.json"
            )
        src, kind = vj, "hf-vocab-merges"
    if os.path.basename(src) == "tokenizer.json":
        with open(src, encoding="utf-8") as f:
            tok = json.load(f)
        model = tok.get("model", {})
        if model.get("type") not in (None, "BPE"):
            raise ValueError(f"unsupported tokenizer model {model.get('type')}")
        vocab = dict(model["vocab"])
        merges = [
            m if isinstance(m, str) else " ".join(m) for m in model["merges"]
        ]
        for added in tok.get("added_tokens", []):
            vocab.setdefault(added["content"], added["id"])
        kind = "hf-tokenizer-json"
    else:  # vocab.json path
        with open(src, encoding="utf-8") as f:
            vocab = json.load(f)
        mt = os.path.join(os.path.dirname(src), "merges.txt")
        with open(mt, encoding="utf-8") as f:
            merges = [
                ln.rstrip("\n")
                for ln in f
                if ln.strip() and not ln.startswith("#")
            ]
        kind = "hf-vocab-merges"
    if "<|endoftext|>" not in vocab:
        raise ValueError("not a GPT-2 style vocab: missing <|endoftext|>")

    os.makedirs(out_dir, exist_ok=True)
    with open(
        os.path.join(out_dir, "encoder.json"), "w", encoding="utf-8"
    ) as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(out_dir, "vocab.bpe"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        f.write("\n".join(merges) + "\n")
    return kind


def iter_hf_gpt2_asset_candidates(roots: Optional[List[str]] = None):
    """Yield every plausible offline HF GPT-2 tokenizer source. The byte-
    level-BPE sniff ('Ġthe' in the head) also matches RoBERTa-family
    caches, whose vocab lacks <|endoftext|> — callers must try each
    candidate and skip the ones export_bpe_from_hf rejects rather than
    trust the first hit."""
    # the user's caches, then the system trees the JAX module scans (opt,
    # usr/share and the superuser's home at the filesystem's root)
    roots = roots or [
        os.path.expanduser("~/.cache/huggingface"),
        os.path.expanduser("~/.cache/tiktoken"),
        *(os.path.join(os.sep, *d) for d in (("opt",), ("usr", "share"), ("root",))),
    ]
    for root in roots:
        if not os.path.isdir(root):
            continue
        for dirpath, _dirnames, filenames in os.walk(root):
            if "vocab.json" in filenames and "merges.txt" in filenames:
                try:
                    with open(
                        os.path.join(dirpath, "vocab.json"), encoding="utf-8"
                    ) as f:
                        head = f.read(4096)
                    if "<|endoftext|>" in head or "Ġthe" in head:
                        yield dirpath
                except OSError:
                    continue
            if "tokenizer.json" in filenames:
                p = os.path.join(dirpath, "tokenizer.json")
                try:
                    if os.path.getsize(p) > 1 << 20:  # full vocab inside
                        with open(p, encoding="utf-8") as f:
                            head = f.read(4096)
                        if "<|endoftext|>" in head:
                            yield p
                except OSError:
                    continue


def find_hf_gpt2_assets(roots: Optional[List[str]] = None) -> Optional[str]:
    """First candidate from iter_hf_gpt2_asset_candidates, or None (where
    there is no tiktoken data and no HF cache, the scan comes up empty)."""
    return next(iter_hf_gpt2_asset_candidates(roots), None)
