from .tokenizer import get_tokenizer, ByteFallbackTokenizer, GPT2_EOT
from .fineweb import TokenShardLoader, write_token_shard, write_synthetic_corpus

__all__ = [
    "get_tokenizer",
    "ByteFallbackTokenizer",
    "GPT2_EOT",
    "TokenShardLoader",
    "write_token_shard",
    "write_synthetic_corpus",
]
