"""Walker's alias method: O(1)-per-draw categorical sampling, for word2vec's
negatives.

Counterpart of ``paddlerec_tpu/data/alias.py`` (numpy only, copied): the
unigram^0.75 table of the reference's word2vec reader
(``word2vec_reader.py:76-78``) built as (prob, alias) tables, and the count
readers.  ``AliasSampler(weights, power, seed).sample(shape)`` draws the same
ids as the JAX package's from the same seed.
"""

from __future__ import annotations

import numpy as np


def build_alias(probs: np.ndarray):
    """(prob, alias) tables for Walker's method, built with two stacks of
    bucket indices (small and large)."""
    p = np.asarray(probs, np.float64)
    if (p < 0).any():
        raise ValueError("negative probabilities")
    s = p.sum()
    if s <= 0:
        raise ValueError("all-zero probabilities")
    n = len(p)
    scaled = p * (n / s)
    alias = np.arange(n, dtype=np.int64)
    prob = np.ones(n, np.float64)
    small = list(np.flatnonzero(scaled < 1.0))
    large = list(np.flatnonzero(scaled >= 1.0))
    while small and large:
        sm = small.pop()
        lg = large.pop()
        prob[sm] = scaled[sm]
        alias[sm] = lg
        scaled[lg] -= 1.0 - scaled[sm]
        (small if scaled[lg] < 1.0 else large).append(lg)
    # numerical leftovers land on prob=1 (self-alias), which is exact
    for rest in (small, large):
        for i in rest:
            prob[i] = 1.0
    return prob, alias


class AliasSampler:
    """Frequency-weighted id sampler (negatives for skip-gram)."""

    def __init__(self, weights: np.ndarray, power: float = 0.75,
                 seed: int = 0):
        w = np.asarray(weights, np.float64)
        self.prob, self.alias = build_alias(np.power(np.maximum(w, 0.0),
                                                     power))
        self.n = len(w)
        self.rng = np.random.RandomState(seed)

    def sample(self, shape) -> np.ndarray:
        i = self.rng.randint(0, self.n, size=shape)
        u = self.rng.rand(*np.shape(i)) if np.ndim(i) else self.rng.rand()
        return np.where(u < self.prob[i], i, self.alias[i]).astype(np.int64)


def counts_from_dict_file(path: str, vocab: int) -> np.ndarray:
    """The reference's word-count dict: one ``<id> <count>`` per line
    (``runner.word_count_dict_path``); a line whose first field is a word
    takes its line number as the id."""
    counts = np.zeros(vocab, np.float64)
    with open(path) as f:
        for i, line in enumerate(f):
            parts = line.split()
            if not parts:
                continue
            try:
                wid = int(parts[0])
            except ValueError:
                wid = i
            if 0 <= wid < vocab and len(parts) > 1:
                counts[wid] = float(parts[1])
    return counts


def counts_from_corpus(files, vocab: int) -> np.ndarray:
    """One counting pass over token-id line files, when no dict ships with
    the data."""
    counts = np.zeros(vocab, np.float64)
    for path in files:
        with open(path) as f:
            for line in f:
                toks = line.split()
                if not toks:
                    continue
                ids = np.asarray(toks, dtype=np.int64)
                if len(ids):
                    ids = ids[(ids >= 0) & (ids < vocab)]
                    counts += np.bincount(ids, minlength=vocab)
    return counts


def write_word_count_dict(path: str, counts: np.ndarray) -> None:
    with open(path, "w") as f:
        for i, c in enumerate(counts):
            f.write(f"{i} {int(c)}\n")
