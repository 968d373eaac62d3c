"""BM25S core for the PyTorch port: eager index (numpy), references, planner."""

from .index import BM25Index, CorpusStats, build_index, build_sharded_indexes, reshard_index
from .reference import RankBM25Baseline, ScipyBM25, dense_oracle_scores
from .retrieval import (RetrievalPlan, default_doc_ids, merge_topk,
                        merge_topk_batch, plan_retrieval, rank_order,
                        splice_default_docs, topk_numpy,
                        validate_query_batch)
from .scoring import bucket_pow2, pad_queries
from .tokenizer import Tokenizer, Vocabulary
from .variants import BM25Params, VARIANTS, get_variant

__all__ = [
    "BM25Index", "BM25Params", "CorpusStats", "RankBM25Baseline",
    "RetrievalPlan", "ScipyBM25", "Tokenizer", "VARIANTS", "Vocabulary",
    "bucket_pow2", "build_index", "build_sharded_indexes",
    "default_doc_ids", "dense_oracle_scores", "get_variant", "merge_topk",
    "merge_topk_batch", "pad_queries", "plan_retrieval", "rank_order",
    "reshard_index", "splice_default_docs", "topk_numpy",
    "validate_query_batch",
]
