"""Synthetic data of the port (numpy, copied from the JAX package):
corpora with planted relevance and Zipfian id-level corpora, LM batches,
procedural graphs and the neighbor sampler, recsys click logs."""

from .corpus import SyntheticCorpus, ndcg_at_k, zipf_corpus, zipf_queries
from .lm import lm_batches
from .graphs import (Graph, batched_molecules, neighbor_sample,
                     random_graph)
from .clicklogs import ctr_batches, seq_rec_batches

__all__ = ["SyntheticCorpus", "zipf_corpus", "zipf_queries", "ndcg_at_k",
           "lm_batches", "Graph", "random_graph", "neighbor_sample",
           "batched_molecules", "ctr_batches", "seq_rec_batches"]
