"""CIDEr-D scorer, faithful pure-Python port of the pycocoevalcap math.

The port's own copy of gpt2_vision_language_tpu/eval/cider.py (host-only; the
JAX package's ``eval/__init__`` imports jax, so it cannot be imported here).

The reference scores captions with `pycocoevalcap.cider.Cider`
(gpt2_linear/data.py:9,134) — calling it directly on raw caption strings
(no PTBTokenizer pass), so tokenization is plain whitespace `split()`.
This implementation reproduces that scorer's exact quantities:

  * n-grams 1..4, corpus document frequency over the reference sets;
  * tf-idf vectors with idf = log(N_images) - log(max(1, df));
  * per-n cosine similarity with candidate counts clipped to reference
    counts (min(h, r) * r), gaussian length penalty exp(-(dl)^2 / (2*6^2));
  * the upstream quirk that "length" counts BIGRAMS (n==1 index), kept
    bug-for-bug so scores are comparable;
  * final score = mean over n of (mean over refs) * 10.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Tuple

N_GRAMS = 4
SIGMA = 6.0


def _ngram_counts(tokens: List[str], n_max: int = N_GRAMS) -> Dict[tuple, int]:
    counts: Dict[tuple, int] = defaultdict(int)
    for n in range(1, n_max + 1):
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i : i + n])] += 1
    return counts


def _cook(sentence: str) -> Dict[tuple, int]:
    return _ngram_counts(sentence.split())


class CiderScorer:
    def __init__(self, n: int = N_GRAMS, sigma: float = SIGMA):
        self.n = n
        self.sigma = sigma

    def compute_score(
        self, gts: Dict[int, List[str]], res: Dict[int, List[str]]
    ) -> Tuple[float, List[float]]:
        """gts: image -> reference captions; res: image -> [candidate]."""
        assert sorted(gts.keys()) == sorted(res.keys())
        keys = sorted(gts.keys())
        crefs = [[_cook(r) for r in gts[k]] for k in keys]
        ctest = [_cook(res[k][0]) for k in keys]

        # corpus document frequency over reference sets
        doc_freq: Dict[tuple, float] = defaultdict(float)
        for refs in crefs:
            seen = set(ng for ref in refs for ng in ref)
            for ng in seen:
                doc_freq[ng] += 1
        ref_len = math.log(float(len(crefs)))

        def counts2vec(cnts):
            vec = [defaultdict(float) for _ in range(self.n)]
            norm = [0.0] * self.n
            length = 0
            for ngram, tf in cnts.items():
                df = math.log(max(1.0, doc_freq[ngram]))
                n = len(ngram) - 1
                vec[n][ngram] = float(tf) * (ref_len - df)
                norm[n] += vec[n][ngram] ** 2
                if n == 1:  # upstream quirk: length counts bigrams
                    length += tf
            return vec, [math.sqrt(x) for x in norm], length

        def sim(vh, vr, nh, nr, lh, lr):
            delta = float(lh - lr)
            val = [0.0] * self.n
            for n in range(self.n):
                for ngram, h in vh[n].items():
                    val[n] += min(h, vr[n][ngram]) * vr[n][ngram]
                if nh[n] != 0 and nr[n] != 0:
                    val[n] /= nh[n] * nr[n]
                val[n] *= math.exp(-(delta**2) / (2 * self.sigma**2))
            return val

        scores = []
        for test, refs in zip(ctest, crefs):
            vh, nh, lh = counts2vec(test)
            acc = [0.0] * self.n
            for ref in refs:
                vr, nr, lr = counts2vec(ref)
                s = sim(vh, vr, nh, nr, lh, lr)
                for n in range(self.n):
                    acc[n] += s[n]
            score_avg = sum(acc) / self.n / len(refs) * 10.0
            scores.append(score_avg)
        mean = sum(scores) / len(scores) if scores else 0.0
        return mean, scores


def cider_score(gts, res) -> float:
    return CiderScorer().compute_score(gts, res)[0]
