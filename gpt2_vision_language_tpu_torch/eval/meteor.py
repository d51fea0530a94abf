"""METEOR caption scorer (pure Python, offline).

The port's own copy of gpt2_vision_language_tpu/eval/meteor.py (host-only;
the JAX package's ``eval/__init__`` imports jax, so it cannot be imported
here). Its synonym tables come from the port's ``eval/synonyms.py``.

The reference README reports METEOR per bridge (README.md:194-196) but the
scoring script is absent from its repo; the standard pipeline uses the Java
METEOR-1.5 jar via pycocoevalcap, which is unavailable offline. This is a
faithful implementation of the METEOR algorithm with all three unigram
matching stages:

  * unigram alignment in stages (exact, then Porter stem, then synonym —
    two words synonym-match when they share a synonym group, METEOR's
    shared-WordNet-synset rule; the group table resolves via
    eval/synonyms.py: $METEOR_SYNONYMS file > NLTK WordNet corpus >
    built-in caption-domain table), choosing per stage the alignment that
    maximizes matches and, tie-broken, minimizes chunks;
  * P = m/len(cand), R = m/len(ref), F_mean = P*R/(alpha*P+(1-alpha)*R);
  * fragmentation penalty gamma*(chunks/m)^beta;
  * score = F_mean*(1-penalty), maximized over references
    (classic exact/stem/syn parameterization alpha=0.9, beta=3.0,
    gamma=0.5).

With the built-in table (air-gapped default) scores are a lower bound on
full-WordNet METEOR — a far tighter one than skipping the synonym stage.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from .synonyms import resolve_synonym_table, synonym_match

try:  # nltk's PorterStemmer is pure python, no corpus download needed
    from nltk.stem.porter import PorterStemmer

    _STEMMER = PorterStemmer()

    def _stem(w: str) -> str:
        return _STEMMER.stem(w)

except Exception:  # pragma: no cover

    def _stem(w: str) -> str:
        return w


import os

# Cache keyed on the resolution input ($METEOR_SYNONYMS value), so changing
# the env var after first use takes effect instead of silently reusing the
# first table resolved (ADVICE r2 #4). Value: (table, provenance).
_SYN_CACHE: Dict[Optional[str], Tuple[Dict[str, Set[int]], str]] = {}


def _syn_resolved() -> Tuple[Dict[str, Set[int]], str]:
    key = os.environ.get("METEOR_SYNONYMS")
    if key not in _SYN_CACHE:
        _SYN_CACHE[key] = resolve_synonym_table()
    return _SYN_CACHE[key]


def _syn_table() -> Dict[str, Set[int]]:
    return _syn_resolved()[0]


def synonym_provenance() -> str:
    """Which synonym table this process's METEOR scores used:
    ``file:<path>`` / ``nltk-wordnet`` / ``builtin``. Scores are only
    cross-machine comparable at matching provenance."""
    return _syn_resolved()[1]


def _tokenize(s: str) -> List[str]:
    return s.lower().split()


def _align(
    cand: List[str],
    ref: List[str],
    syn_table: Optional[Dict[str, Set[int]]] = None,
) -> List[Tuple[int, int]]:
    """Stage-wise greedy alignment: exact matches, then stems, then
    synonyms. Returns (cand_idx, ref_idx) pairs."""
    matches: List[Tuple[int, int]] = []
    used_c = [False] * len(cand)
    used_r = [False] * len(ref)

    def run_stage(pair_match):
        for i, cw in enumerate(cand):
            if used_c[i]:
                continue
            # prefer the closest unused ref position (reduces chunks)
            best = -1
            for j, rw in enumerate(ref):
                if used_r[j] or not pair_match(cw, rw):
                    continue
                if best == -1 or abs(j - i) < abs(best - i):
                    best = j
            if best >= 0:
                used_c[i] = True
                used_r[best] = True
                matches.append((i, best))

    run_stage(lambda c, r: c == r)
    run_stage(lambda c, r: _stem(c) == _stem(r))
    table = _syn_table() if syn_table is None else syn_table
    run_stage(lambda c, r: synonym_match(c, r, table))
    return sorted(matches)


def _chunks(matches: List[Tuple[int, int]]) -> int:
    if not matches:
        return 0
    chunks = 1
    for (c0, r0), (c1, r1) in zip(matches, matches[1:]):
        if not (c1 == c0 + 1 and r1 == r0 + 1):
            chunks += 1
    return chunks


def meteor_single(
    candidate: str,
    references: List[str],
    *,
    alpha: float = 0.9,
    beta: float = 3.0,
    gamma: float = 0.5,
    syn_table: Optional[Dict[str, Set[int]]] = None,
) -> float:
    cand = _tokenize(candidate)
    if not cand:
        return 0.0
    best = 0.0
    for ref_s in references:
        ref = _tokenize(ref_s)
        if not ref:
            continue
        matches = _align(cand, ref, syn_table)
        m = len(matches)
        if m == 0:
            continue
        p = m / len(cand)
        r = m / len(ref)
        fmean = p * r / (alpha * p + (1 - alpha) * r)
        frag = _chunks(matches) / m
        penalty = gamma * frag**beta
        best = max(best, fmean * (1 - penalty))
    return best


def meteor_score(
    gts: Dict[int, List[str]], res: Dict[int, List[str]]
) -> Tuple[float, List[float]]:
    keys = sorted(gts.keys())
    scores = [meteor_single(res[k][0], gts[k]) for k in keys]
    mean = sum(scores) / len(scores) if scores else 0.0
    return mean, scores
