"""Reference retrievers.

1. :class:`ScipyBM25` — a faithful port of the BM25S retrieval path exactly
   as the paper describes it: eager scores in a ``scipy.sparse.csc_matrix``
   of shape ``|C| × |V|`` (docs × tokens, CSC ⇒ token columns contiguous);
   query = slice the query-token columns + sum across the token dimension;
   top-k via ``np.argpartition`` (average O(n) selection, Quickselect-style).

2. :class:`RankBM25Baseline` — a faithful reimplementation of the
   ``rank_bm25.BM25Okapi`` scoring loop the paper benchmarks against:
   *lazy* scoring with a per-document Python dict of term frequencies and a
   per-query-token Python-loop gather. This is the baseline column of
   Table 1 and deliberately keeps rank_bm25's per-token
   ``[doc.get(q, 0) for doc in corpus]`` list comprehension — that loop *is*
   what BM25S's eager scoring removes.

Both are host-side and used by tests (exactness) and benchmarks (Table 1).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import scipy.sparse as sp

from .index import BM25Index
from .variants import BM25Params, get_variant


class ScipyBM25:
    """Paper-faithful scipy CSC retrieval over an eager :class:`BM25Index`."""

    def __init__(self, index: BM25Index):
        self.index = index
        # docs × tokens so that CSC stores each token's postings contiguously:
        # the index already IS that CSC layout (doc ids ascending within
        # each token's run), so it is adopted without a COO re-sort
        self.matrix = sp.csc_matrix(
            (index.scores, index.doc_ids, index.indptr),
            shape=(index.doc_lens.size, index.n_vocab),
        )
        self.nonoccurrence = index.nonoccurrence

    def score(self, query_tokens: np.ndarray) -> np.ndarray:
        """Exact BM25 scores for every document ("slice rows ... and sum")."""
        q = query_tokens[query_tokens >= 0]
        if q.size == 0:
            return np.zeros(self.matrix.shape[0], dtype=np.float32)
        sliced = self.matrix[:, q]                      # |C| × |Q|
        scores = np.asarray(sliced.sum(axis=1)).ravel()  # sum token dimension
        # §2.1: add the query-constant nonoccurrence shift back (exactness)
        scores += float(self.nonoccurrence[q].sum())
        return scores.astype(np.float32)

    def retrieve(self, query_tokens: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        scores = self.score(query_tokens)
        k = min(k, scores.size)
        # average-O(n) selection, then O(k log k) ordering — §2 "Top-k selection"
        part = np.argpartition(scores, -k)[-k:]
        order = np.argsort(-scores[part], kind="stable")
        idx = part[order]
        return idx + self.index.doc_offset, scores[idx]


class RankBM25Baseline:
    """rank_bm25.BM25Okapi-equivalent lazy scorer (the Table 1 baseline)."""

    def __init__(self, corpus_tokens: Sequence[np.ndarray],
                 params: BM25Params | None = None):
        self.params = params or BM25Params(method="robertson")
        self.variant = get_variant(self.params.method)
        self.corpus_size = len(corpus_tokens)
        self.doc_freqs: list[dict[int, int]] = []
        self.doc_len = np.array([t.size for t in corpus_tokens], dtype=np.float64)
        self.avgdl = float(self.doc_len.mean()) if self.corpus_size else 0.0
        df: dict[int, int] = {}
        for toks in corpus_tokens:
            freqs: dict[int, int] = {}
            for t in toks.tolist():
                freqs[t] = freqs.get(t, 0) + 1
            self.doc_freqs.append(freqs)
            for t in freqs:
                df[t] = df.get(t, 0) + 1
        self.idf = {
            t: float(self.variant.idf(np.asarray([d], dtype=np.float64),
                                      self.corpus_size)[0])
            for t, d in df.items()
        }

    def get_scores(self, query_tokens: np.ndarray) -> np.ndarray:
        """Lazy per-query scoring — rank_bm25's exact control flow."""
        p = self.params
        score = np.zeros(self.corpus_size)
        for q in query_tokens.tolist():
            if q not in self.idf:
                continue
            # the O(|C|) Python loop BM25S eliminates:
            q_freq = np.array([doc.get(q, 0) for doc in self.doc_freqs],
                              dtype=np.float64)
            denom = q_freq + p.k1 * (1.0 - p.b + p.b * self.doc_len / self.avgdl)
            num = q_freq * (p.k1 + 1.0) if self.variant.name in ("atire",) \
                else q_freq
            score += self.idf[q] * num / denom
        return score

    def retrieve(self, query_tokens: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        scores = self.get_scores(query_tokens)
        k = min(k, scores.size)
        idx = np.argsort(-scores, kind="stable")[:k]   # rank_bm25 sorts fully
        return idx, scores[idx]


def dense_oracle_scores(corpus_tokens: Sequence[np.ndarray], n_vocab: int,
                        query_tokens: np.ndarray,
                        params: BM25Params) -> np.ndarray:
    """Brute-force lazy scorer straight from the formulas (tests only)."""
    variant = get_variant(params.method)
    n_docs = len(corpus_tokens)
    dl = np.array([t.size for t in corpus_tokens], dtype=np.float64)
    l_avg = float(dl.mean())
    df = np.zeros(n_vocab, dtype=np.float64)
    for toks in corpus_tokens:
        if toks.size:
            df[np.unique(toks)] += 1
    scores = np.zeros(n_docs, dtype=np.float64)
    for q in query_tokens.tolist():
        if q < 0 or df[q] == 0:
            continue
        for d, toks in enumerate(corpus_tokens):
            tf = float((toks == q).sum())
            if tf > 0:
                scores[d] += float(variant.score(
                    np.asarray([tf]), np.asarray([df[q]]), n_docs,
                    np.asarray([dl[d]]), l_avg, params)[0])
            else:
                scores[d] += float(variant.nonoccurrence(
                    np.asarray([df[q]]), n_docs, params)[0])
    return scores
