"""Eager index-time scoring — the core of BM25S (§2 of the paper).

``build_index`` turns a tokenized corpus into a :class:`BM25Index`: every
possible score any future query token can contribute to any document is
computed *now* and stored sparsely, CSC-style keyed by token id. For the
shifted variants (§2.1) the stored value is the differential
``SΔ(t,D) = S(t,D) − S⁰(t)`` and the per-token nonoccurrence vector ``S⁰``
is kept alongside (a |V| array — footnote 12 of the paper).

Query-time work is thereby reduced to: gather the postings of the query
tokens, sum per document, (+ the scalar ``Σ S⁰(qᵢ)`` for shifted variants),
then top-k. See ``scoring.py`` / ``retrieval.py`` for the device-side half.

Everything in this module is host-side NumPy; it is embarrassingly parallel
over document shards (each shard indexes its own documents given global
``df``/``L_avg`` statistics — see ``build_sharded_indexes``).
"""

from __future__ import annotations

import functools
import json
import os
from dataclasses import dataclass, replace
from typing import Sequence

import numpy as np

from .variants import BM25Params, BM25Variant, get_variant


@dataclass
class CorpusStats:
    """Global statistics needed to eagerly score any document shard."""

    n_docs: int
    n_vocab: int
    df: np.ndarray        # [V] int64 document frequency
    l_avg: float          # mean document length (tokens)

    @staticmethod
    def from_corpus(doc_tokens: Sequence[np.ndarray], n_vocab: int) -> "CorpusStats":
        tok, _doc, _tf, doc_lens = _corpus_coo(doc_tokens, n_vocab)
        return CorpusStats.from_coo(tok, doc_lens, len(doc_tokens), n_vocab)

    @staticmethod
    def from_coo(tok: np.ndarray, doc_lens: np.ndarray, n_docs: int,
                 n_vocab: int) -> "CorpusStats":
        """Stats straight from a ``_corpus_coo`` result — each (doc, token)
        pair appears once there, so ``df`` is a bincount of the token
        column. Lets ``build_index`` share one COO pass for stats + scores.
        """
        df = np.bincount(tok, minlength=n_vocab).astype(np.int64)
        l_avg = float(doc_lens.sum()) / max(n_docs, 1)
        return CorpusStats(n_docs=n_docs, n_vocab=n_vocab, df=df,
                           l_avg=l_avg)


@dataclass
class BM25Index:
    """Eager sparse score index in CSC-by-token layout.

    ``indptr[t] : indptr[t+1]`` delimits the postings of token ``t``;
    ``doc_ids`` are sorted ascending within each token's slice (the CSC
    invariant the distributed/blocked layouts rely on).
    """

    indptr: np.ndarray      # [V+1] int64
    doc_ids: np.ndarray     # [nnz] int32
    scores: np.ndarray      # [nnz] float32 — S or SΔ (differential)
    nonoccurrence: np.ndarray  # [V] float32 — S⁰; zeros for sparse variants
    doc_lens: np.ndarray    # [C] int32
    n_docs: int
    n_vocab: int
    l_avg: float
    variant: str
    params: BM25Params
    doc_offset: int = 0     # global id of local doc 0 (for shards)

    @property
    def nnz(self) -> int:
        return int(self.doc_ids.size)

    @functools.cached_property
    def is_shifted(self) -> bool:
        # cached: the O(V) scan runs once per index, not per property access
        # (dataclasses.replace builds a fresh instance, so shard/reshard
        # copies re-derive it from their own nonoccurrence array).
        return bool(np.any(self.nonoccurrence != 0.0))

    def token_df(self) -> np.ndarray:
        return np.diff(self.indptr)

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez(
            os.path.join(path, "arrays.npz"),
            indptr=self.indptr, doc_ids=self.doc_ids, scores=self.scores,
            nonoccurrence=self.nonoccurrence, doc_lens=self.doc_lens,
        )
        meta = {
            "n_docs": self.n_docs, "n_vocab": self.n_vocab,
            "l_avg": self.l_avg, "variant": self.variant,
            "doc_offset": self.doc_offset,
            "params": {"k1": self.params.k1, "b": self.params.b,
                       "delta": self.params.delta, "method": self.params.method},
        }
        tmp = os.path.join(path, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(path, "meta.json"))

    @staticmethod
    def load(path: str) -> "BM25Index":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        arrs = np.load(os.path.join(path, "arrays.npz"))
        return BM25Index(
            indptr=arrs["indptr"], doc_ids=arrs["doc_ids"],
            scores=arrs["scores"], nonoccurrence=arrs["nonoccurrence"],
            doc_lens=arrs["doc_lens"], n_docs=meta["n_docs"],
            n_vocab=meta["n_vocab"], l_avg=meta["l_avg"],
            variant=meta["variant"], doc_offset=meta.get("doc_offset", 0),
            params=BM25Params(**meta["params"]),
        )


def _corpus_coo(doc_tokens: Sequence[np.ndarray], n_vocab: int
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(token_ids, doc_ids, tf) postings + doc lengths for a corpus shard.

    One flattened pass: concatenate all documents, encode each occurrence as
    the scalar key ``doc·V + token``, and let a single ``np.unique`` produce
    the distinct (doc, token) pairs with their term frequencies — no
    per-document Python loop, no per-document ``np.unique`` call overhead.
    Keys stay int32 when ``n_docs·V`` fits (the sort is ~2x faster there).
    Output is sorted by (doc, token); ``build_index`` re-sorts CSC-by-token.
    """
    n = len(doc_tokens)
    doc_lens = np.fromiter((t.size for t in doc_tokens), dtype=np.int64,
                           count=n).astype(np.int32)
    nnz_total = int(doc_lens.sum())
    if n == 0 or nnz_total == 0:
        z64, zf = np.zeros(0, np.int64), np.zeros(0, np.float64)
        return z64, z64.copy(), zf, doc_lens
    flat = np.concatenate(doc_tokens)
    lo, hi = int(flat.min()), int(flat.max())
    if lo < 0 or hi >= n_vocab:
        # the key encoding would silently wrap an out-of-range token into a
        # neighboring document's postings — fail loudly instead (the seed's
        # per-doc path raised IndexError here). InvalidQueryError inherits
        # ValueError, so pre-taxonomy callers keep working.
        from ..serve.errors import InvalidQueryError
        raise InvalidQueryError(
            f"token ids must be in [0, {n_vocab}); corpus has [{lo}, {hi}]")
    if n * n_vocab < 2 ** 31:
        flat_tok = flat.astype(np.int32, copy=False)
        flat_doc = np.repeat(np.arange(n, dtype=np.int32), doc_lens)
        key = flat_doc * np.int32(n_vocab) + flat_tok
    else:
        flat_tok = flat.astype(np.int64, copy=False)
        flat_doc = np.repeat(np.arange(n, dtype=np.int64),
                             doc_lens.astype(np.int64))
        key = flat_doc * n_vocab + flat_tok
    uniq_key, tf = np.unique(key, return_counts=True)
    tok = (uniq_key % n_vocab).astype(np.int64)
    doc = (uniq_key // n_vocab).astype(np.int64)
    return tok, doc, tf.astype(np.float64), doc_lens


def build_index(
    doc_tokens: Sequence[np.ndarray],
    n_vocab: int,
    *,
    params: BM25Params | None = None,
    stats: CorpusStats | None = None,
    doc_offset: int = 0,
) -> BM25Index:
    """Eagerly score a (shard of a) corpus into a :class:`BM25Index`.

    ``stats`` carries *global* corpus statistics; when ``None`` they are
    computed from ``doc_tokens`` itself (single-shard build). Passing global
    stats while giving only a document shard is exactly how the distributed
    index build works — scores depend on other shards only through
    ``(df, N, L_avg)``.
    """
    params = params or BM25Params()
    variant: BM25Variant = get_variant(params.method)
    tok, doc, tf, doc_lens = _corpus_coo(doc_tokens, n_vocab)
    if stats is None:
        # single-shard build: stats come from the same COO pass (the seed
        # walked the corpus twice — once for df, once for postings)
        stats = CorpusStats.from_coo(tok, doc_lens, len(doc_tokens), n_vocab)

    df_per_posting = stats.df[tok].astype(np.float64)
    dl_per_posting = doc_lens[doc].astype(np.float64)
    scores = variant.score(
        tf, df_per_posting, stats.n_docs, dl_per_posting, stats.l_avg, params
    )

    # §2.1 score shifting: store the differential score so the matrix stays
    # sparse. For sparse variants nonocc ≡ 0 and this is a no-op.
    df_all = stats.df.astype(np.float64)
    nonocc = np.where(
        df_all > 0,
        variant.nonoccurrence(np.maximum(df_all, 1.0), stats.n_docs, params),
        0.0,
    )
    scores = scores - nonocc[tok]

    # CSC-by-token: sort postings by (token, doc). np.lexsort is stable.
    order = np.lexsort((doc, tok))
    tok, doc, scores = tok[order], doc[order], scores[order]
    indptr = np.zeros(n_vocab + 1, dtype=np.int64)
    np.add.at(indptr, tok + 1, 1)
    np.cumsum(indptr, out=indptr)

    return BM25Index(
        indptr=indptr,
        doc_ids=doc.astype(np.int32),
        scores=scores.astype(np.float32),
        nonoccurrence=nonocc.astype(np.float32),
        doc_lens=doc_lens,
        n_docs=stats.n_docs if doc_offset == 0 and len(doc_tokens) == stats.n_docs
        else len(doc_tokens),
        n_vocab=n_vocab,
        l_avg=stats.l_avg,
        variant=variant.name,
        params=params,
        doc_offset=doc_offset,
    )


def build_sharded_indexes(
    doc_tokens: Sequence[np.ndarray],
    n_vocab: int,
    n_shards: int,
    *,
    params: BM25Params | None = None,
) -> list[BM25Index]:
    """Distributed index build: global stats pass + per-shard eager scoring.

    Shards are contiguous document ranges (balanced ±1). This mirrors the
    production flow where each host indexes its own documents after an
    all-reduce of ``(df, Σ len, N)``.
    """
    stats = CorpusStats.from_corpus(doc_tokens, n_vocab)
    bounds = np.linspace(0, len(doc_tokens), n_shards + 1).astype(int)
    shards = []
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        shards.append(
            build_index(doc_tokens[lo:hi], n_vocab, params=params,
                        stats=stats, doc_offset=lo)
        )
    return shards


def reshard_index(shards: list[BM25Index], n_new: int) -> list[BM25Index]:
    """Elastically re-balance shards to a new shard count.

    Pure host-side re-slicing: postings are re-bucketed by global doc id
    with ONE global sort. Each posting's destination shard comes from a
    ``searchsorted`` against the new shard bounds; a single
    ``lexsort((doc, token, shard))`` then makes every new shard a contiguous
    slice already in CSC (token-major) order — no per-shard boolean masks
    over the full posting set, no per-shard re-sorts. Used when the device
    pool shrinks/grows (see serve/engine.py).
    """
    if not shards:
        raise ValueError("no shards to reshard")
    # reconstruct global COO
    v = shards[0].n_vocab
    tok = np.concatenate([
        np.repeat(np.arange(v, dtype=np.int64), np.diff(sh.indptr))
        for sh in shards])
    doc = np.concatenate([sh.doc_ids.astype(np.int64) + sh.doc_offset
                          for sh in shards])
    sc = np.concatenate([sh.scores for sh in shards])
    n_docs_total = max(sh.doc_offset + sh.doc_lens.size for sh in shards)
    doc_lens = np.zeros(n_docs_total, dtype=np.int32)
    for sh in shards:
        doc_lens[sh.doc_offset: sh.doc_offset + sh.doc_lens.size] = sh.doc_lens

    bounds = np.linspace(0, n_docs_total, n_new + 1).astype(np.int64)
    shard_of = np.searchsorted(bounds, doc, side="right") - 1
    order = np.lexsort((doc, tok, shard_of))
    tok, doc, sc, shard_of = (tok[order], doc[order], sc[order],
                              shard_of[order])
    starts = np.searchsorted(shard_of, np.arange(n_new + 1, dtype=np.int64))

    proto = shards[0]
    out = []
    for s in range(n_new):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        p0, p1 = int(starts[s]), int(starts[s + 1])
        t_s, d_s, s_s = tok[p0:p1], doc[p0:p1] - lo, sc[p0:p1]
        indptr = np.zeros(v + 1, dtype=np.int64)
        np.cumsum(np.bincount(t_s, minlength=v), out=indptr[1:])
        out.append(replace(
            proto,
            indptr=indptr, doc_ids=d_s.astype(np.int32),
            scores=s_s.astype(np.float32), doc_lens=doc_lens[lo:hi],
            n_docs=hi - lo, doc_offset=lo,
        ))
    return out
