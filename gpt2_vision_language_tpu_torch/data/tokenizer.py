"""GPT-2 BPE tokenizer with a fully offline stack.

The port's own copy of gpt2_vision_language_tpu/data/tokenizer.py (stdlib
only; same names and behaviour).

The reference uses tiktoken's Rust BPE (train_gpt2.py:241), which needs to
download `encoder.json`/`vocab.bpe` on first use — impossible in an
air-gapped machine. Resolution order here:

  1. tiktoken, if its data is already cached / reachable;
  2. a pure-Python byte-level BPE (`LocalBpeTokenizer`) reading
     encoder.json + vocab.bpe from `$GPT2_BPE_DIR`;
  3. `ByteFallbackTokenizer`: UTF-8 bytes as ids 0..255 inside the same
     50257-token id space (eot_token = 50256), so every downstream shape,
     shard format and model config is identical. Token *strings* differ
     from real GPT-2 BPE, which only matters when decoding text against
     checkpoints trained with the real vocab; training-from-scratch runs
     are self-consistent.

All tokenizers expose the tiktoken surface the reference relies on:
`encode`, `decode`, `eot_token`, `n_vocab`.
"""

from __future__ import annotations

import functools
import json
import os
from typing import List, Optional

GPT2_EOT = 50256
GPT2_VOCAB = 50257


class ByteFallbackTokenizer:
    """Deterministic offline tokenizer in the GPT-2 id space."""

    name = "byte-fallback"
    eot_token = GPT2_EOT
    n_vocab = GPT2_VOCAB

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")


class LocalBpeTokenizer:
    """GPT-2 byte-level BPE from local encoder.json + vocab.bpe files.

    Same algorithm as tiktoken/GPT-2: UTF-8 bytes mapped through the
    bytes<->unicode table, greedy lowest-rank pair merging, regex word
    splitting.
    """

    name = "local-bpe"

    def __init__(self, encoder_path: str, vocab_bpe_path: str):
        import regex

        with open(encoder_path, encoding="utf-8") as f:
            self.encoder = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(vocab_bpe_path, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines[1:] if l and len(l.split()) == 2]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = self._bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        # GPT-2's token split pattern
        self.pat = regex.compile(
            r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
        )
        self.eot_token = self.encoder.get("<|endoftext|>", GPT2_EOT)
        self.n_vocab = len(self.encoder)
        self._cache = {}

    @staticmethod
    def _bytes_to_unicode():
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

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = new_word
        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        ids = []
        for tok in self.pat.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(mapped))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder.get(i, "") for i in ids)
        data = bytes(self.byte_decoder.get(c, 32) for c in text)
        return data.decode("utf-8", errors="replace")


class _TiktokenWrapper:
    name = "tiktoken"

    def __init__(self, enc):
        self._enc = enc
        self.eot_token = enc.eot_token
        self.n_vocab = enc.n_vocab

    def encode(self, text: str):
        return self._enc.encode(text, allowed_special={"<|endoftext|>"})

    def decode(self, ids):
        return self._enc.decode(list(ids))


@functools.lru_cache(maxsize=1)
def get_tokenizer(prefer: Optional[str] = None):
    """Best available GPT-2 tokenizer (see module docstring)."""
    if prefer in (None, "tiktoken"):
        try:
            import tiktoken

            return _TiktokenWrapper(tiktoken.get_encoding("gpt2"))
        except Exception:
            if prefer == "tiktoken":
                raise
    if prefer in (None, "local-bpe"):
        bpe_dir = os.environ.get("GPT2_BPE_DIR", "")
        enc_p = os.path.join(bpe_dir, "encoder.json")
        bpe_p = os.path.join(bpe_dir, "vocab.bpe")
        if bpe_dir and os.path.exists(enc_p) and os.path.exists(bpe_p):
            return LocalBpeTokenizer(enc_p, bpe_p)
        if prefer == "local-bpe":
            raise FileNotFoundError(f"GPT2_BPE_DIR files not found in {bpe_dir!r}")
    import sys

    print(
        "=" * 70
        + "\nWARNING: falling back to the BYTE-FALLBACK tokenizer — neither\n"
        "tiktoken's GPT-2 data nor $GPT2_BPE_DIR/encoder.json+vocab.bpe are\n"
        "available. Token ids will NOT match the real GPT-2 BPE: decoding\n"
        "against real-vocab checkpoints produces garbage and eval numbers\n"
        "are not comparable. Run\n"
        "  python -m gpt2_vision_language_tpu_torch.cli.export_bpe --out gpt2_bpe\n"
        "on an online machine (or with --from-hf PATH or --scan, offline, on\n"
        "HuggingFace GPT-2 tokenizer files already on disk) and set\n"
        "GPT2_BPE_DIR to the result, which holds encoder.json and vocab.bpe.\n"
        + "=" * 70,
        file=sys.stderr,
    )
    return ByteFallbackTokenizer()
