"""The port's own host modules: nothing of the port imports the JAX package,
and the copied token-shard loader, synthetic corpus, tokenizer and CSV logger
behave as the JAX package's do on the same files."""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest

import gpt2_vision_language_tpu_torch as port
from gpt2_vision_language_tpu.data import fineweb as jfw
from gpt2_vision_language_tpu.data import tokenizer as jtok
from gpt2_vision_language_tpu.obs import csvlog as jlog
from gpt2_vision_language_tpu_torch.data import fineweb as pfw
from gpt2_vision_language_tpu_torch.data import tokenizer as ptok
from gpt2_vision_language_tpu_torch.obs import csvlog as plog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.dirname(os.path.abspath(port.__file__))


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT_DIR):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_no_source_imports_the_jax_package():
    """No file of the port, nor chip_smoke.py, holds an import of jax or of
    gpt2_vision_language_tpu (a '.' or a space after the name: the port's own
    name has '_torch' there), nor of safetensors, ml_dtypes or transformers,
    which the card's machine lacks."""
    pat = re.compile(r"(?:import|from)\s+(?:gpt2_vision_language_tpu[. ]|jax\b"
                     r"|safetensors\b|ml_dtypes\b|transformers\b)")
    files = _port_sources()
    assert len(files) > 45
    # the parallel styles and their worker are read too
    for rel in ("parallel/mesh.py", "parallel/collectives.py", "parallel/sharding.py",
                "parallel/pipeline.py", "tools/dist_worker.py", "tools/dryrun_multichip.py"):
        assert os.path.join(PORT_DIR, *rel.split("/")) in files, rel
    bad = [(f, line.strip()) for f in files for line in open(f, encoding="utf-8")
           if pat.search(line)]
    assert not bad, bad


def test_no_user_facing_string_names_the_jax_package(capsys, monkeypatch):
    """No source of the port, nor chip_smoke.py, points its user at a command
    of the JAX package (docstrings cite its files by path, which stays); the
    tokenizer's fallback warning names the BPE files and the port's own
    exporter."""
    files = _port_sources() + [os.path.join(d, n) for d, _, names in os.walk(PORT_DIR)
                               for n in names if n.endswith((".cu", ".cuh"))]
    bad = [(f, line.strip()) for f in files for line in open(f, encoding="utf-8")
           if "python -m gpt2_vision_language_tpu." in line]
    assert not bad, bad
    monkeypatch.setenv("GPT2_BPE_DIR", "")
    monkeypatch.setitem(sys.modules, "tiktoken", None)  # no tiktoken data either
    ptok.get_tokenizer.cache_clear()
    try:
        assert isinstance(ptok.get_tokenizer(), ptok.ByteFallbackTokenizer)
    finally:
        ptok.get_tokenizer.cache_clear()
    err = capsys.readouterr().err
    assert "encoder.json" in err and "vocab.bpe" in err and "GPT2_BPE_DIR" in err
    assert "python -m gpt2_vision_language_tpu." not in err


def test_importing_every_port_module_loads_no_jax():
    """A subprocess imports every module of the port (cli.pretrain and
    train.pretrain included): neither jax nor the JAX package is loaded."""
    mods = [m.name for m in pkgutil.walk_packages([PORT_DIR], prefix=port.__name__ + ".")]
    assert {port.__name__ + ".cli.pretrain", port.__name__ + ".train.pretrain",
            port.__name__ + ".eval.hellaswag", port.__name__ + ".data.fineweb",
            port.__name__ + ".obs.csvlog", port.__name__ + ".train.finetune",
            port.__name__ + ".cli.finetune_xattn", port.__name__ + ".data.coco",
            port.__name__ + ".eval.caption_eval", port.__name__ + ".models.bridges",
            port.__name__ + ".tools.ab_dt_flash", port.__name__ + ".ckpt.torch_import",
            port.__name__ + ".eval.meteor", port.__name__ + ".eval.synonyms",
            port.__name__ + ".cli.eval_quality", port.__name__ + ".models.clip_vit",
            port.__name__ + ".cli.extract_clip_features",
            port.__name__ + ".cli.caption", port.__name__ + ".data.bpe_export",
            port.__name__ + ".cli.export_bpe", port.__name__ + ".data.hellaswag_download",
            port.__name__ + ".cli.prepare_fineweb"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'gpt2_vision_language_tpu', 'safetensors', 'ml_dtypes', 'transformers')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two synthetic corpora of small shards, one from each package's writer."""
    dirs = {}
    for name, mod in (("jax", jfw), ("port", pfw)):
        d = tmp_path_factory.mktemp(f"corpus_{name}")
        mod.write_synthetic_corpus(str(d), vocab_size=1000, shard_tokens=5000, n_train=3,
                                   n_val=1, seed=3, kind="markov")
        dirs[name] = str(d)
    return dirs


def test_synthetic_corpus_files_are_identical(corpus):
    names = sorted(os.listdir(corpus["jax"]))
    assert names == sorted(os.listdir(corpus["port"])) and len(names) == 4
    for n in names:
        a, b = (np.load(os.path.join(corpus[k], n)) for k in ("jax", "port"))
        assert a.dtype == b.dtype == np.uint16 and np.array_equal(a, b), n


@pytest.mark.parametrize("rank, world", [(0, 1), (1, 2)])
def test_token_shard_loader_matches_jax(corpus, rank, world):
    """The same batches from the same files: next_batch, next_accum_batch,
    next_accum_rowbuf and next_accum_buf across shard wraps, then seek."""
    kw = dict(rank=rank, world_size=world, split="train", data_dir=corpus["jax"])
    j = jfw.TokenShardLoader(4, 64, use_native=False, **kw)
    p = pfw.TokenShardLoader(4, 64, **kw)
    assert [os.path.basename(s) for s in p.shards] == [os.path.basename(s) for s in j.shards]
    for _ in range(12):  # 4,999 tokens a shard / 256-512 a window: wraps shards
        for a, b in zip(j.next_batch(), p.next_batch()):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for method in ("next_accum_batch", "next_accum_rowbuf", "next_accum_buf"):
        a, b = getattr(j, method)(5), getattr(p, method)(5)
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert x.dtype == y.dtype and np.array_equal(x, y), method
    assert (p.current_shard, p.pos) == (j.current_shard, j.pos)
    for n in (0, 7, 31, 100):
        j.seek(n)
        p.seek(n)
        assert (p.current_shard, p.pos) == (j.current_shard, j.pos), n
        assert np.array_equal(p.next_accum_rowbuf(2), j.next_accum_rowbuf(2))
    p.reset()
    j.reset()
    assert np.array_equal(p.next_batch()[0], j.next_batch()[0])


def test_tokenizer_copy_matches_jax():
    text = "Hello, I'm a language model, \u00e9\u4e2d."
    a, b = jtok.ByteFallbackTokenizer(), ptok.ByteFallbackTokenizer()
    assert a.encode(text) == b.encode(text) and a.decode(a.encode(text)) == b.decode(b.encode(text))
    assert (a.name, a.eot_token, a.n_vocab) == (b.name, b.eot_token, b.n_vocab)
    assert (ptok.GPT2_EOT, ptok.GPT2_VOCAB) == (jtok.GPT2_EOT, jtok.GPT2_VOCAB)
    assert (ptok.LocalBpeTokenizer._bytes_to_unicode()
            == jtok.LocalBpeTokenizer._bytes_to_unicode())


def _drive_logger(mod, log_dir):
    log = mod.MetricsLogger(str(log_dir))
    log.meta("tokenizer", "byte-fallback")
    log.val(0, 10.5)
    log.train(0, 10.987654321, 8.4e-7, 1.23456, 1234.567, 65432.1)
    log.train(1, 9.5, 1.68e-6, 0.98765, 1000.0, 70000.0, eta_sec=3725)
    log.hellaswag(1, 0.25, 3, 12)
    log.cider(1, 0.123456)
    log.export_xlsx()
    return log


def test_metrics_logger_matches_jax(tmp_path, capsys):
    """The same calls write the same CSV bytes apart from the timestamp
    column, the same log.txt and the same printed lines; the XLSX export
    holds the same sheet."""
    import zipfile

    j = _drive_logger(jlog, tmp_path / "jax")
    out_j = capsys.readouterr().out
    p = _drive_logger(plog, tmp_path / "port")
    out_p = capsys.readouterr().out
    assert plog.MetricsLogger.SCHEMA == jlog.MetricsLogger.SCHEMA

    def rows(path):
        lines = open(path).read().splitlines()
        return [lines[0]] + [ln.split(",", 1)[1] for ln in lines[1:]]  # drop the time column

    assert rows(p.csv_path) == rows(j.csv_path) and len(rows(p.csv_path)) == 7
    assert open(p.txt_path).read() == open(j.txt_path).read()
    strip = lambda s: [ln for ln in s.splitlines() if not ln.startswith("[excel]")]  # noqa: E731
    assert strip(out_p) == strip(out_j)

    def sheet(path):
        with zipfile.ZipFile(path.replace(".csv", ".xlsx")) as z:
            names = sorted(z.namelist())
            body = z.read("xl/worksheets/sheet1.xml").decode()
        return names, re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", "T", body)

    assert sheet(p.csv_path) == sheet(j.csv_path)
