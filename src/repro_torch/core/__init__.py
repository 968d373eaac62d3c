"""BM25S core for the PyTorch port: eager index (numpy), references,
planner, the eager torch scorer, the sharded step over a device mesh and
the text-in :class:`BM25Retriever`."""

from .index import BM25Index, CorpusStats, build_index, build_sharded_indexes, reshard_index
from .reference import RankBM25Baseline, ScipyBM25, dense_oracle_scores
from .retrieval import (RetrievalPlan, blockwise_topk, default_doc_ids,
                        merge_topk, merge_topk_batch, missing_doc_ids,
                        plan_retrieval, rank_order,
                        sharded_retrieve_adaptive, splice_default_docs,
                        topk_numpy, topk_torch, validate_query_batch)
from .scoring import (DeviceIndex, batch_posting_budget, bucket_pow2,
                      pad_queries, query_posting_budget, score_batch,
                      score_query, suggest_p_max)
from .tokenizer import Tokenizer, Vocabulary
from .variants import BM25Params, VARIANTS, get_variant

__all__ = [
    "BM25Index", "BM25Params", "BM25Retriever", "CorpusStats",
    "DeviceIndex", "RankBM25Baseline", "RetrievalPlan", "ScipyBM25",
    "Tokenizer", "VARIANTS", "Vocabulary", "batch_posting_budget",
    "blockwise_topk", "bucket_pow2", "build_index", "build_sharded_indexes",
    "default_doc_ids", "dense_oracle_scores", "get_variant", "merge_topk",
    "merge_topk_batch", "missing_doc_ids", "pad_queries", "plan_retrieval",
    "query_posting_budget", "rank_order", "reshard_index", "score_batch",
    "score_query", "sharded_retrieve_adaptive", "splice_default_docs",
    "suggest_p_max", "topk_numpy", "topk_torch", "validate_query_batch",
]


class BM25Retriever:
    """End-to-end convenience API: texts in, ranked documents out.

    >>> r = BM25Retriever(method="lucene").index(corpus_texts)
    >>> ids, scores = r.retrieve(["sparse lexical search"], k=10)

    The index lives on ``device`` (default ``cuda``; with no GPU the
    constructor raises ``ResidencyError`` — pass ``device="cpu"`` to run
    the plain torch versions of the kernels on the host). ``retrieve``
    scores the batch eagerly (:func:`score_batch`) and takes the top-k
    through ``kernels.ops.topk`` (K5 for corpora over 4,096 documents);
    ties are ordered by document id ascending. It returns ``(ids [B, k]
    int32, scores [B, k] f32)`` as tensors on the device.
    """

    def __init__(self, *, method: str = "lucene", k1: float = 1.5,
                 b: float = 0.75, delta: float = 0.5,
                 stopwords: str | None = "english",
                 stemmer: str | None = "snowball", device=None):
        from ..device import resolve_device
        self.device = resolve_device(device)
        self.params = BM25Params(k1=k1, b=b, delta=delta, method=method)
        self.tokenizer = Tokenizer(stopwords=stopwords, stemmer=stemmer)
        self.bm25_index: BM25Index | None = None
        self._device_index: DeviceIndex | None = None
        self.query_counters: dict = {}

    def index(self, corpus: list[str]) -> "BM25Retriever":
        tokens = self.tokenizer.tokenize_corpus(corpus)
        self.bm25_index = build_index(
            tokens, self.tokenizer.vocab_size, params=self.params)
        self._device_index = DeviceIndex.from_host(self.bm25_index,
                                                   device=self.device)
        return self

    def retrieve(self, queries: list[str], k: int = 10, *,
                 q_max: int = 32, p_max: int | None = None):
        if self._device_index is None:
            raise RuntimeError("call .index() first")
        from ..kernels import ops
        q_tokens = validate_query_batch(
            self.tokenizer.tokenize_queries(queries),
            self.bm25_index.n_vocab, counters=self.query_counters)
        toks, wts = pad_queries(q_tokens, q_max)
        if p_max is None:
            p_max = suggest_p_max(self.bm25_index, q_max)
        scores, overflow = score_batch(self._device_index, toks, wts,
                                       p_max=p_max, return_overflow=True)
        n_over = int(overflow.sum())
        if n_over:
            import warnings

            from ..serve.errors import TruncationWarning
            warnings.warn(
                f"{n_over}/{len(queries)} queries overflowed the posting "
                f"budget p_max={p_max}; their scores miss postings — "
                f"retry with a larger p_max", TruncationWarning,
                stacklevel=2)
        vals, ids = ops.topk(scores, min(k, self.bm25_index.doc_lens.size))
        return ids, vals
