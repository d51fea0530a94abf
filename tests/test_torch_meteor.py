"""The port's copied METEOR scorer and synonym tables against the JAX
package's on the same strings (tests/test_scorers.py's cases): the same
scores, exactly."""

import pytest

from gpt2_vision_language_tpu.eval import meteor as jmeteor
from gpt2_vision_language_tpu.eval import synonyms as jsynonyms
from gpt2_vision_language_tpu_torch.eval import meteor, synonyms

NO_SYN = object()  # the empty table: the synonym stage off


@pytest.mark.parametrize("cand, refs, table, lo, hi", [
    ("a cat on a mat", ["a cat on a mat"], None, 0.99, 1.0),  # exact
    ("a man riding a horse", ["a man rides a horse"], None, 0.8, 1.0),  # stem
    ("completely different words", ["a man rides a horse"], None, 0.0, 0.0),
    ("a cat sat on the mat", ["a cat sat on the mat"], None, 0.99, 1.0),  # in order
    ("mat the on sat cat a", ["a cat sat on the mat"], None, 1e-9, 0.9),  # shuffled
    ("a man riding a bicycle", ["a guy riding a bike"], None, 0.9, 1.0),  # synonyms
    ("a man riding a bicycle", ["a guy riding a bike"], NO_SYN, 0.0, 0.9),
    ("", ["a cat"], None, 0.0, 0.0),
    ("a dog on a couch", ["", "the dog is on the sofa"], None, 0.2, 0.5),
])
def test_meteor_single_equals_jax(cand, refs, table, lo, hi):
    kw = {} if table is None else {"syn_table": synonyms.parse_groups([])}
    jkw = {} if table is None else {"syn_table": jsynonyms.parse_groups([])}
    got = meteor.meteor_single(cand, refs, **kw)
    assert got == jmeteor.meteor_single(cand, refs, **jkw)
    assert lo <= got <= hi


def test_meteor_corpus_and_provenance_equal_jax():
    gts = {0: ["a man riding a wave on a surfboard", "a surfer rides a large wave"],
           1: ["a cat sitting on a red couch", "the cat is on the sofa"],
           2: ["two dogs play in the water"]}
    res = {0: ["a guy riding a wave"], 1: ["a kitten sitting on a sofa"], 2: ["two dogs"]}
    assert meteor.meteor_score(gts, res) == jmeteor.meteor_score(gts, res)
    assert meteor.synonym_provenance() == jmeteor.synonym_provenance()
    assert synonyms.BUILTIN_GROUPS == jsynonyms.BUILTIN_GROUPS


def test_synonym_table_env_file(tmp_path, monkeypatch):
    f = tmp_path / "syn.txt"
    f.write_text("frobnicate, twiddle\nxyzzy plugh\n")
    monkeypatch.setenv("METEOR_SYNONYMS", str(f))
    table = synonyms.load_synonym_table()
    assert synonyms.synonym_match("frobnicate", "twiddle", table)
    assert synonyms.synonym_match("xyzzy", "plugh", table)
    assert not synonyms.synonym_match("frobnicate", "plugh", table)
    assert meteor.synonym_provenance() == f"file:{f}"
    monkeypatch.setenv("METEOR_SYNONYMS", str(tmp_path / "missing.txt"))
    with pytest.raises(FileNotFoundError):
        synonyms.resolve_synonym_table()


def test_synonym_match_is_groupwise():
    table = synonyms.load_synonym_table()
    assert synonyms.synonym_match("couch", "sofa", table)
    assert synonyms.synonym_match("photo", "picture", table)
    assert not synonyms.synonym_match("couch", "photo", table)
    assert not synonyms.synonym_match("unknownword", "sofa", table)
