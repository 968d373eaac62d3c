"""The BM25 scoring variants reproduced by BM25S (Kamphuis et al., 2020).

Each variant is expressed in the *eager* form used by the paper: the full
contribution ``S(t, D)`` of token ``t`` to document ``D`` is computable at
index time from ``(tf, df, N, dl, L_avg)`` alone.

Sparse variants (``S(t,D) = 0`` whenever ``TF(t,D) = 0``):
    robertson, atire, lucene (the BM25S default)

Shifted variants (§2.1 of the paper — a non-zero *nonoccurrence score*
``S⁰(t) = S(t, ∅)`` exists, so the index stores the differential
``SΔ(t,D) = S(t,D) − S⁰(t)`` and retrieval adds ``Σᵢ S⁰(qᵢ)`` back):
    bm25l  (Lv & Zhai 2011),  bm25+  (Lv & Zhai 2011),
    tfldp  (TF_{l∘δ∘p}×IDF, Rousseau & Vazirgiannis 2013)

All functions are NumPy-vectorized and run host-side at index time; nothing
here touches JAX. Shapes: ``tf, dl`` are per-posting arrays, ``df`` is
per-posting (df of that posting's token) for ``score`` and per-token for
``idf``/``nonoccurrence``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

Array = np.ndarray


@dataclass(frozen=True)
class BM25Params:
    k1: float = 1.5
    b: float = 0.75
    delta: float = 0.5  # bm25l / tfldp default; bm25+ conventionally uses 1.0
    method: str = "lucene"


def _len_norm(dl: Array, l_avg: float, k1: float, b: float) -> Array:
    """k1 * (1 - b + b * |D| / L_avg) — the denominator's document part."""
    return k1 * (1.0 - b + b * dl / l_avg)


# --------------------------------------------------------------------------
# IDF definitions
# --------------------------------------------------------------------------

def idf_robertson(df: Array, n_docs: int) -> Array:
    return np.log((n_docs - df + 0.5) / (df + 0.5))


def idf_lucene(df: Array, n_docs: int) -> Array:
    # ln(1 + (N - df + 0.5)/(df + 0.5)) — always positive; the paper's eq.
    return np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))


def idf_atire(df: Array, n_docs: int) -> Array:
    return np.log(n_docs / df)


def idf_bm25l(df: Array, n_docs: int) -> Array:
    return np.log((n_docs + 1.0) / (df + 0.5))


def idf_bm25plus(df: Array, n_docs: int) -> Array:
    return np.log((n_docs + 1.0) / df)


# --------------------------------------------------------------------------
# Variant definitions
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class BM25Variant:
    name: str
    idf: Callable[[Array, int], Array]
    is_shifted: bool

    def score(self, tf: Array, df: Array, n_docs: int, dl: Array,
              l_avg: float, p: BM25Params) -> Array:
        """Eager score S(t, D) for postings with tf > 0."""
        raise NotImplementedError

    def nonoccurrence(self, df: Array, n_docs: int, p: BM25Params) -> Array:
        """S⁰(t) = S(t, ∅): the score of a token absent from the document."""
        return np.zeros_like(df, dtype=np.float64)


class _Robertson(BM25Variant):
    def score(self, tf, df, n_docs, dl, l_avg, p):
        return self.idf(df, n_docs) * tf / (tf + _len_norm(dl, l_avg, p.k1, p.b))


class _Lucene(BM25Variant):
    def score(self, tf, df, n_docs, dl, l_avg, p):
        return self.idf(df, n_docs) * tf / (tf + _len_norm(dl, l_avg, p.k1, p.b))


class _ATIRE(BM25Variant):
    def score(self, tf, df, n_docs, dl, l_avg, p):
        return (self.idf(df, n_docs) * (p.k1 + 1.0) * tf
                / (tf + _len_norm(dl, l_avg, p.k1, p.b)))


class _BM25L(BM25Variant):
    def score(self, tf, df, n_docs, dl, l_avg, p):
        c = tf / (1.0 - p.b + p.b * dl / l_avg)
        return (self.idf(df, n_docs) * (p.k1 + 1.0) * (c + p.delta)
                / (p.k1 + c + p.delta))

    def nonoccurrence(self, df, n_docs, p):
        # c = 0 when tf = 0
        return (self.idf(df, n_docs) * (p.k1 + 1.0) * p.delta
                / (p.k1 + p.delta))


class _BM25Plus(BM25Variant):
    def score(self, tf, df, n_docs, dl, l_avg, p):
        return self.idf(df, n_docs) * (
            (p.k1 + 1.0) * tf / (_len_norm(dl, l_avg, p.k1, p.b) + tf)
            + p.delta
        )

    def nonoccurrence(self, df, n_docs, p):
        return self.idf(df, n_docs) * p.delta


class _TFldp(BM25Variant):
    """TF_{l∘δ∘p} × IDF: 1 + ln(1 + ln(tf/(1-b+b·dl/L) + δ))."""

    def score(self, tf, df, n_docs, dl, l_avg, p):
        tfp = tf / (1.0 - p.b + p.b * dl / l_avg)
        return self.idf(df, n_docs) * (1.0 + np.log(1.0 + np.log(tfp + p.delta)))

    def nonoccurrence(self, df, n_docs, p):
        return self.idf(df, n_docs) * (1.0 + np.log(1.0 + np.log(p.delta)))


VARIANTS: dict[str, BM25Variant] = {
    "robertson": _Robertson("robertson", idf_robertson, is_shifted=False),
    "lucene": _Lucene("lucene", idf_lucene, is_shifted=False),
    "atire": _ATIRE("atire", idf_atire, is_shifted=False),
    "bm25l": _BM25L("bm25l", idf_bm25l, is_shifted=True),
    "bm25+": _BM25Plus("bm25+", idf_bm25plus, is_shifted=True),
    "bm25plus": _BM25Plus("bm25+", idf_bm25plus, is_shifted=True),
    "tfldp": _TFldp("tfldp", idf_bm25plus, is_shifted=True),
}


def get_variant(name: str) -> BM25Variant:
    try:
        return VARIANTS[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown BM25 variant {name!r}; available: {sorted(set(VARIANTS))}"
        ) from None


def dense_score_matrix(tf_matrix: Array, n_docs: int, dl: Array,
                       variant: BM25Variant, p: BM25Params) -> Array:
    """Oracle: the full dense |V| × |C| score matrix, computed lazily.

    Used only by tests/benchmarks on small corpora to pin down exactness of
    the eager-sparse (+ shifted) implementations. ``tf_matrix`` is dense
    ``|V| × |C|`` term frequencies.
    """
    df = (tf_matrix > 0).sum(axis=1).astype(np.float64)
    l_avg = float(dl.mean())
    out = np.zeros_like(tf_matrix, dtype=np.float64)
    s0 = variant.nonoccurrence(np.maximum(df, 1.0), n_docs, p)
    # nonoccurrence applies to every (t, D) with tf == 0 (and df > 0)
    out += np.where(df[:, None] > 0, s0[:, None], 0.0)
    rows, cols = np.nonzero(tf_matrix)
    if rows.size:
        out[rows, cols] = variant.score(
            tf_matrix[rows, cols].astype(np.float64),
            df[rows], n_docs, dl[cols].astype(np.float64), l_avg, p,
        )
    return out
