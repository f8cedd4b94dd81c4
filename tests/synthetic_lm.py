"""Seeded synthetic word n-gram LMs in ARPA text, for the port's tests and
chip_smoke.py; it imports only numpy.

``seeded_trigram`` is a dense-collision 3-gram over the letters A, B and C;
``letter_trigram`` a 3-gram over A-Z at the size of a small real LM: every
word of 1-3 letters (so that a beam's words hit the tables) plus longer
ones, with random log10 probabilities and backoffs. Scores are rounded to 4
decimals so the ARPA text round-trips exactly.
"""

import itertools
import string

import numpy as np


def seeded_trigram(seed=5, n_words=2000, n_bi=8000, n_tri=12000):
    """A 3-gram LM as ArpaLM's ``ngrams`` dicts: words of 1-7 letters over
    A, B, C (dense hash collisions), <s>, </s> and <unk>."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("ABC"))
    words, seen = [], set()
    while len(words) < n_words:
        w = "".join(rng.choice(letters, size=rng.integers(1, 8)))
        if w not in seen:
            seen.add(w)
            words.append(w)
    return _ngrams(rng, words, n_bi, n_tri)


def letter_trigram(seed=21, n_words=20000, n_bi=200000, n_tri=400000):
    """A 3-gram over A-Z: the 18,278 words of 1-3 letters, then words of 4-8
    letters up to n_words; n_bi bigrams and n_tri trigrams drawn from them
    (duplicates merge, so a few fewer)."""
    rng = np.random.default_rng(seed)
    az = string.ascii_uppercase
    words = ["".join(p) for n in (1, 2, 3) for p in itertools.product(az, repeat=n)]
    seen = set(words)
    letters = np.array(list(az))
    while len(words) < n_words:
        w = "".join(rng.choice(letters, size=rng.integers(4, 9)))
        if w not in seen:
            seen.add(w)
            words.append(w)
    return _ngrams(rng, words, n_bi, n_tri)


def _ngrams(rng, words, n_bi, n_tri):
    def scores(n, lo, hi, backoff):
        logp = np.round(-rng.uniform(lo, hi, n), 4)
        boff = np.round(-rng.uniform(0.1, 1.0, n), 4) if backoff else np.zeros(n)
        return zip(logp.tolist(), boff.tolist())

    uni = dict(zip([(w,) for w in words], scores(len(words), 1, 5, True)))
    uni[("<s>",)] = (-99.0, -0.5)
    uni[("</s>",)] = (-1.5, 0.0)
    uni[("<unk>",)] = (-9.0, 0.0)
    vocab = np.array(words + ["<s>"], dtype=object)
    bi_idx = rng.integers(0, len(vocab), size=(n_bi, 2))
    bi = dict(zip(map(tuple, vocab[bi_idx].tolist()), scores(n_bi, 1, 6, True)))
    tri_idx = rng.integers(0, len(vocab), size=(n_tri, 3))
    tri = dict(zip(map(tuple, vocab[tri_idx].tolist()), scores(n_tri, 1, 7, False)))
    return [uni, bi, tri]


def write_arpa(path, ngrams):
    """ARPA text of ``ngrams`` (a list of {words: (logp, backoff)} by
    order; the highest order without backoffs); returns the path."""
    lines = ["\\data\\"] + [f"ngram {n + 1}={len(g)}" for n, g in enumerate(ngrams)]
    for n, g in enumerate(ngrams):
        lines += ["", f"\\{n + 1}-grams:"]
        last = n + 1 == len(ngrams)
        for words, (logp, boff) in g.items():
            lines.append(f"{logp}\t{' '.join(words)}" + ("" if last else f"\t{boff}"))
    lines += ["", "\\end\\", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return str(path)
