"""The port's host CLIs and their modules against the JAX package's on the
same files: the FineWeb shard writer (cli/prepare_fineweb), the BPE exporter
(data/bpe_export, cli/export_bpe), the HellaSwag fetcher
(data/hellaswag_download) and the tokenizer's fallback warning. Every input
is written by the test; nothing reaches the network (tiktoken is kept from
fetching, and the fetcher is only asked for a file that is there)."""

import json
import os
import sys

import numpy as np
import pytest

from gpt2_vision_language_tpu.cli import export_bpe as jcli_bpe
from gpt2_vision_language_tpu.cli import prepare_fineweb as jcli_prep
from gpt2_vision_language_tpu.data import bpe_export as jbpe
from gpt2_vision_language_tpu.data import tokenizer as jtok
from gpt2_vision_language_tpu_torch.cli import export_bpe as pcli_bpe
from gpt2_vision_language_tpu_torch.cli import prepare_fineweb as pcli_prep
from gpt2_vision_language_tpu_torch.data import bpe_export as pbpe
from gpt2_vision_language_tpu_torch.data import hellaswag_download as phs
from gpt2_vision_language_tpu_torch.data import tokenizer as ptok
from gpt2_vision_language_tpu_torch.data.fineweb import TokenShardLoader
from torch_threads import share_cores  # noqa: F401  (autouse)

PAT = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""


def _synthetic_tiktoken():
    """A byte-level BPE of 256 bytes, nine merges and <|endoftext|>, built
    locally (tests/test_data.py's)."""
    tiktoken = pytest.importorskip("tiktoken")
    ranks = {bytes([b]): b for b in range(256)}
    for tok in (b"he", b"ll", b"hell", b"hello", b" w", b"or", b" wor", b"ld", b" world"):
        ranks[tok] = len(ranks)
    return tiktoken.Encoding(name="synthetic", pat_str=PAT, mergeable_ranks=ranks,
                             special_tokens={"<|endoftext|>": len(ranks)})


def _files(d):
    """{name: bytes} of every file in directory d."""
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


@pytest.fixture
def offline_tokenizers(monkeypatch):
    """A function that points both packages' get_tokenizer at $GPT2_BPE_DIR
    (empty: the byte fallback), without tiktoken (no fetch) and with their
    caches cleared; cleared again after the test."""

    def use(bpe_dir):
        monkeypatch.setitem(sys.modules, "tiktoken", None)
        monkeypatch.setenv("GPT2_BPE_DIR", bpe_dir)
        jtok.get_tokenizer.cache_clear()
        ptok.get_tokenizer.cache_clear()

    yield use
    jtok.get_tokenizer.cache_clear()
    ptok.get_tokenizer.cache_clear()


def _write_corpus(tmp_path, suffix):
    docs = [f"hello world, document number {i}: some words and ünïcödé {i * i}"
            for i in range(40)]
    src = tmp_path / f"docs{suffix}"
    if suffix == ".jsonl":
        src.write_text("".join(json.dumps({"body": d}) + "\n" for d in docs), encoding="utf-8")
    else:
        src.write_text("\n\n".join(docs) + "\n", encoding="utf-8")
    return str(src)


def test_prepare_fineweb_through_the_port_loader(tmp_path, offline_tokenizers):
    """tests/test_prepare_fineweb.py on the port: the CLI's shards read back
    through the port's TokenShardLoader as shifted (x, y) pairs, with EOT
    between documents."""
    offline_tokenizers("")
    src = tmp_path / "docs.jsonl"
    with open(src, "w") as f:
        for i in range(30):
            f.write(json.dumps({"text": f"document number {i} with some words"}) + "\n")
    out = str(tmp_path / "shards")
    pcli_prep.main(["--input", str(src), "--out", out, "--shard-tokens", "128",
                    "--val-shards", "1"])
    names = sorted(os.listdir(out))
    assert any("_val_" in n for n in names) and any("_train_" in n for n in names)
    loader = TokenShardLoader(2, 8, split="train", data_dir=out)
    x, y = loader.next_batch()
    assert x.shape == (2, 8)
    np.testing.assert_array_equal(x[0, 1:], y[0, :-1])
    arr = np.load(os.path.join(out, [n for n in names if "_train_" in n][0]))
    assert (arr == ptok.get_tokenizer().eot_token % (1 << 16)).any()


@pytest.mark.parametrize("suffix", [".jsonl", ".txt"])
@pytest.mark.parametrize("tokenizer", ["local-bpe", "byte-fallback"])
def test_prepare_fineweb_shards_equal_the_jax_clis(tmp_path, offline_tokenizers, capsys,
                                                   suffix, tokenizer):
    """The port's CLI and the JAX CLI on one .jsonl (a --text-key of its
    own) or .txt corpus write the same shard files, byte for byte, and say
    the same lines: with the local BPE of an exported synthetic vocabulary
    and with the byte fallback."""
    bpe_dir = ""
    if tokenizer == "local-bpe":
        bpe_dir = str(tmp_path / "bpe")
        pbpe.export_bpe(bpe_dir, encoding=_synthetic_tiktoken())
    offline_tokenizers(bpe_dir)
    src = _write_corpus(tmp_path, suffix)
    outs, said = {}, {}
    for name, cli in (("jax", jcli_prep), ("port", pcli_prep)):
        outs[name] = str(tmp_path / f"shards_{name}")
        cli.main(["--input", src, "--text-key", "body", "--out", outs[name],
                  "--shard-tokens", "300", "--val-shards", "1"])
        said[name] = capsys.readouterr().out.replace(outs[name], "OUT")
    assert ptok.get_tokenizer().name == tokenizer
    port = _files(outs["port"])
    assert len(port) >= 3 and port == _files(outs["jax"])
    assert said["port"] == said["jax"]


def test_prepare_fineweb_refuses_an_empty_train_split(tmp_path, offline_tokenizers):
    """A corpus that fills only the val shards is refused, as by the JAX CLI."""
    offline_tokenizers("")
    src = _write_corpus(tmp_path, ".txt")
    for cli in (jcli_prep, pcli_prep):
        with pytest.raises(SystemExit):
            cli.main(["--input", src, "--out", str(tmp_path / "one"), "--shard-tokens",
                      "100000", "--val-shards", "1"])


def test_bytes_to_unicode_equals_jax():
    table = pbpe.bytes_to_unicode()
    assert table == jbpe.bytes_to_unicode() == ptok.LocalBpeTokenizer._bytes_to_unicode()
    assert len(table) == 256 and len(set(table.values())) == 256


def test_merges_from_mergeable_ranks_equals_jax():
    """The ordered merge list recovered from tiktoken's token -> rank map
    (tests/test_data.py's expectation), equal to the JAX module's."""
    ranks = _synthetic_tiktoken()._mergeable_ranks
    merges = pbpe.merges_from_mergeable_ranks(ranks)
    assert merges == jbpe.merges_from_mergeable_ranks(ranks)
    assert merges == [(b"h", b"e"), (b"l", b"l"), (b"he", b"ll"), (b"hell", b"o"),
                      (b" ", b"w"), (b"o", b"r"), (b" w", b"or"), (b"l", b"d"),
                      (b" wor", b"ld")]
    assert pbpe._bpe_parts(ranks, b"hello", 10**9) == [b"hello"]
    assert pbpe._bpe_parts(ranks, b"hello", ranks[b"hello"]) == [b"hell", b"o"]


def test_export_bpe_equals_jax_and_encodes_as_tiktoken(tmp_path):
    """export_bpe of one encoding writes the JAX module's bytes, and the
    port's LocalBpeTokenizer on them encodes as the tiktoken Encoding does
    (tests/test_data.py's local equivalence)."""
    enc = _synthetic_tiktoken()
    pbpe.export_bpe(str(tmp_path / "port"), encoding=enc)
    jbpe.export_bpe(str(tmp_path / "jax"), encoding=enc)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    local = ptok.LocalBpeTokenizer(str(tmp_path / "port" / "encoder.json"),
                                   str(tmp_path / "port" / "vocab.bpe"))
    for s in ("hello", "hello world", "hell or hello", "xyz hello!"):
        assert local.encode(s) == enc.encode(s), s
        assert local.decode(local.encode(s)) == s
    assert local.eot_token == enc._special_tokens["<|endoftext|>"]


def _hf_sources(tmp_path):
    """The three HuggingFace forms of the synthetic vocabulary: a
    tokenizer.json (<|endoftext|> as an added token), a directory with
    vocab.json + merges.txt, and that vocab.json's path."""
    ref = tmp_path / "ref"
    pbpe.export_bpe(str(ref), encoding=_synthetic_tiktoken())
    vocab = json.loads((ref / "encoder.json").read_text(encoding="utf-8"))
    merges = [ln for ln in (ref / "vocab.bpe").read_text(encoding="utf-8").splitlines()
              if ln and not ln.startswith("#")]
    tj = tmp_path / "hf1" / "tokenizer.json"
    tj.parent.mkdir()
    tj.write_text(json.dumps({
        "model": {"type": "BPE",
                  "vocab": {k: v for k, v in vocab.items() if k != "<|endoftext|>"},
                  "merges": [m.split(" ") for m in merges]},
        "added_tokens": [{"content": "<|endoftext|>", "id": vocab["<|endoftext|>"]}]}))
    hf2 = tmp_path / "hf2"
    hf2.mkdir()
    (hf2 / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (hf2 / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n",
                                    encoding="utf-8")
    return ref, {"tokenizer.json": (str(tj), "hf-tokenizer-json"),
                 "vocab-merges dir": (str(hf2), "hf-vocab-merges"),
                 "vocab.json path": (str(hf2 / "vocab.json"), "hf-vocab-merges")}


@pytest.mark.parametrize("form", ["tokenizer.json", "vocab-merges dir", "vocab.json path"])
def test_export_bpe_from_hf_equals_jax(tmp_path, form):
    """export_bpe_from_hf on each HuggingFace form: the source kind and the
    files of the JAX module, byte for byte, and a LocalBpeTokenizer on them
    that encodes as the tiktoken-derived export does."""
    ref, sources = _hf_sources(tmp_path)
    src, kind = sources[form]
    assert pbpe.export_bpe_from_hf(src, str(tmp_path / "port")) == kind
    assert jbpe.export_bpe_from_hf(src, str(tmp_path / "jax")) == kind
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    want = ptok.LocalBpeTokenizer(str(ref / "encoder.json"), str(ref / "vocab.bpe"))
    got = ptok.LocalBpeTokenizer(str(tmp_path / "port" / "encoder.json"),
                                 str(tmp_path / "port" / "vocab.bpe"))
    for s in ("hello", "hello world", "hell or hello"):
        assert got.encode(s) == want.encode(s), s
    assert got.eot_token == want.eot_token


def _write_roberta(d):
    """A byte-level BPE vocabulary without <|endoftext|> (RoBERTa-like), which
    the candidate scan's sniff matches and the exporter refuses."""
    (d / "vocab.json").write_text(json.dumps({"Ġthe": 0, "a": 1}, ensure_ascii=False),
                                  encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\nĠ t\n", encoding="utf-8")


def test_export_bpe_from_hf_refusals(tmp_path):
    """A directory without the files and a vocabulary without <|endoftext|>
    are refused by both modules alike."""
    (tmp_path / "empty").mkdir()
    roberta = tmp_path / "roberta"
    roberta.mkdir()
    _write_roberta(roberta)
    for mod in (jbpe, pbpe):
        with pytest.raises(FileNotFoundError, match="vocab.json"):
            mod.export_bpe_from_hf(str(tmp_path / "empty"), str(tmp_path / "out"))
        with pytest.raises(ValueError, match="endoftext"):
            mod.export_bpe_from_hf(str(roberta), str(tmp_path / "out"))


def test_export_bpe_real_gpt2_equivalence(tmp_path, monkeypatch):
    """Full-vocabulary equivalence against tiktoken's real GPT-2 where its
    data is already cached; skipped otherwise (no fetch is attempted)."""
    tiktoken = pytest.importorskip("tiktoken")
    import tiktoken.load

    def no_fetch(blobpath):
        raise OSError(f"not fetching {blobpath}")

    monkeypatch.setattr(tiktoken.load, "read_file", no_fetch)
    try:
        enc = tiktoken.get_encoding("gpt2")
    except Exception:
        pytest.skip("tiktoken gpt2 data not cached (no network)")
    pbpe.export_bpe(str(tmp_path), encoding=enc)
    local = ptok.LocalBpeTokenizer(str(tmp_path / "encoder.json"), str(tmp_path / "vocab.bpe"))
    assert local.n_vocab == 50257
    for s in ("Hello, I'm a language model,", "The quick brown fox jumps over 1234 lazy dogs!",
              "  multiple   spaces\nand newlines"):
        assert local.encode(s) == enc.encode(s), s


def _scan_roots(monkeypatch, roots):
    """Point both modules' candidate scan at `roots` (the CLIs scan the
    defaults, cache directories and system trees)."""
    for mod in (jbpe, pbpe):
        scan = mod.iter_hf_gpt2_asset_candidates
        monkeypatch.setattr(mod, "iter_hf_gpt2_asset_candidates",
                            lambda roots_=None, _scan=scan: _scan([str(r) for r in roots]))


def test_export_bpe_cli_scan_over_empty_roots_returns_1(tmp_path, monkeypatch, capsys):
    """--scan over roots with nothing in them: exit code 1 and the same
    message as the JAX CLI's, no files written; find_hf_gpt2_assets finds
    nothing there either."""
    roots = [tmp_path / "a", tmp_path / "b", tmp_path / "missing"]
    for r in roots[:2]:
        (r / "sub").mkdir(parents=True)
    (roots[0] / "sub" / "notes.txt").write_text("nothing here")
    _scan_roots(monkeypatch, roots)
    said = {}
    for name, cli in (("jax", jcli_bpe), ("port", pcli_bpe)):
        out = tmp_path / f"out_{name}"
        assert cli.main(["--scan", "--out", str(out)]) == 1
        assert not out.exists()
        said[name] = capsys.readouterr().out
    assert said["port"] == said["jax"] and "no offline GPT-2 tokenizer data found" in said["port"]
    assert pbpe.find_hf_gpt2_assets([str(r) for r in roots]) is None


def test_export_bpe_cli_scan_skips_and_converts_like_jax(tmp_path, monkeypatch, capsys):
    """--scan skips a byte-level vocabulary without <|endoftext|> and converts
    the GPT-2 one, as the JAX CLI does: the same lines and the same files."""
    _, sources = _hf_sources(tmp_path / "src")
    # the walk is top-down: the root's own files come before its subdirectory's
    root = tmp_path / "root"
    root.mkdir()
    _write_roberta(root)
    os.rename(sources["vocab-merges dir"][0], root / "gpt2")
    _scan_roots(monkeypatch, [root])
    said = {}
    for name, cli in (("jax", jcli_bpe), ("port", pcli_bpe)):
        out = tmp_path / f"out_{name}"
        assert cli.main(["--scan", "--out", str(out)]) is None
        said[name] = capsys.readouterr().out.replace(str(out), "OUT")
    assert said["port"] == said["jax"] and "scan hit" in said["port"]
    assert "skipping" in said["port"]
    assert _files(tmp_path / "out_port") == _files(tmp_path / "out_jax")


def test_export_bpe_cli_from_hf_equals_jax(tmp_path, capsys):
    """--from-hf: the same files and lines as the JAX CLI."""
    _, sources = _hf_sources(tmp_path)
    src = sources["tokenizer.json"][0]
    said = {}
    for name, cli in (("jax", jcli_bpe), ("port", pcli_bpe)):
        out = tmp_path / f"out_{name}"
        cli.main(["--from-hf", src, "--out", str(out)])
        said[name] = capsys.readouterr().out.replace(str(out), "OUT")
    assert said["port"] == said["jax"] and "hf-tokenizer-json" in said["port"]
    assert _files(tmp_path / "out_port") == _files(tmp_path / "out_jax")


def test_hellaswag_download_returns_an_existing_file_untouched(tmp_path, monkeypatch):
    """download() of a split whose file is there returns its path and leaves
    it as it was, without opening a connection; $HELLASWAG_DIR is the
    default directory. The URLs are the JAX module's."""
    import urllib.request

    def no_fetch(*args, **kwargs):
        raise AssertionError("download() opened a connection for a file that is there")

    monkeypatch.setattr(urllib.request, "urlopen", no_fetch)
    path = tmp_path / "hellaswag_val.jsonl"
    path.write_bytes(b'{"ctx": "one line"}\n')
    stamp = os.stat(path).st_mtime_ns
    assert phs.download("val", str(tmp_path)) == str(path)
    monkeypatch.setenv("HELLASWAG_DIR", str(tmp_path))
    assert phs.download() == str(path)
    assert path.read_bytes() == b'{"ctx": "one line"}\n' and os.stat(path).st_mtime_ns == stamp
    from gpt2_vision_language_tpu.data import hellaswag_download as jhs

    assert phs.URLS == jhs.URLS


def test_fallback_warning_names_the_ports_exporter(monkeypatch, capsys, offline_tokenizers):
    """Without tiktoken data and without $GPT2_BPE_DIR, the byte fallback's
    warning names the port's own exporter, as the JAX warning names the JAX
    CLI, and no command of the JAX package."""
    offline_tokenizers("")
    assert isinstance(ptok.get_tokenizer(), ptok.ByteFallbackTokenizer)
    err = capsys.readouterr().err
    assert "python -m gpt2_vision_language_tpu_torch.cli.export_bpe --out gpt2_bpe" in err
    assert "python -m gpt2_vision_language_tpu." not in err
    assert "GPT2_BPE_DIR" in err and "encoder.json" in err and "vocab.bpe" in err
