"""Synthetic retrieval corpora with planted relevance.

The BEIR datasets are not available offline, so benchmarks (Tables 1-3)
run on procedurally generated corpora whose *relevance structure is known
by construction*: documents are drawn from per-topic word distributions;
queries sample salient words of one topic; qrels = documents of that topic.
NDCG@10 and QPS are then measured exactly like the paper does per dataset.

Two generators:
  * ``SyntheticCorpus`` — text-level (real strings through the real
    tokenizer; exercises stopwords/stemming like Table 2);
  * ``zipf_corpus`` — id-level Zipfian postings for scale benchmarks
    (Table 1 throughput; millions of documents without string overhead).

A numpy copy of ``repro.data.corpus`` (the port imports nothing of the JAX
package): for a given seed every array is byte-identical to the
reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

_SYLLABLES = ("ba be bi bo bu da de di do du fa fe fi fo fu ga ge gi go gu "
              "ka ke ki ko ku la le li lo lu ma me mi mo mu na ne ni no nu "
              "pa pe pi po pu ra re ri ro ru sa se si so su ta te ti to tu "
              "va ve vi vo vu za ze zi zo zu").split()


def _word(rng: np.random.Generator) -> str:
    n = rng.integers(2, 5)
    return "".join(rng.choice(_SYLLABLES) for _ in range(n))


@dataclass
class SyntheticCorpus:
    """Topic-model corpus: known relevance for NDCG, realistic Zipf tails."""

    n_docs: int = 2000
    n_topics: int = 20
    vocab_size: int = 2000
    doc_len: tuple[int, int] = (20, 120)
    query_len: tuple[int, int] = (2, 6)
    seed: int = 0
    documents: list[str] = field(default_factory=list)
    doc_topics: np.ndarray | None = None

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        words = np.array([_word(rng) for _ in range(self.vocab_size)])
        # Zipfian global frequencies + topic-salient word subsets
        zipf = 1.0 / np.arange(1, self.vocab_size + 1)
        self._topic_words = [
            rng.choice(self.vocab_size, size=60, replace=False)
            for _ in range(self.n_topics)
        ]
        self.doc_topics = rng.integers(0, self.n_topics, size=self.n_docs)
        docs = []
        for i in range(self.n_docs):
            t = self.doc_topics[i]
            length = int(rng.integers(*self.doc_len))
            n_topic = length // 3          # 1/3 topical, 2/3 background
            topical = rng.choice(self._topic_words[t], size=n_topic)
            backgr = rng.choice(self.vocab_size, size=length - n_topic,
                                p=zipf / zipf.sum())
            ids = np.concatenate([topical, backgr])
            rng.shuffle(ids)
            docs.append(" ".join(words[ids]))
        self.documents = docs
        self._words = words
        self._rng = rng

    def queries_with_qrels(self, n_queries: int
                           ) -> tuple[list[str], list[np.ndarray]]:
        """Queries targeting one topic each; qrels = that topic's docs."""
        qs, rels = [], []
        for _ in range(n_queries):
            t = int(self._rng.integers(0, self.n_topics))
            k = int(self._rng.integers(*self.query_len))
            ids = self._rng.choice(self._topic_words[t], size=k)
            qs.append(" ".join(self._words[ids]))
            rels.append(np.where(self.doc_topics == t)[0])
        return qs, rels


def zipf_corpus(n_docs: int, n_vocab: int, *, avg_len: int = 100,
                seed: int = 0, alpha: float = 1.07) -> list[np.ndarray]:
    """Id-level Zipf corpus for throughput benchmarks (no strings)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_vocab + 1, dtype=np.float64)
    p = ranks ** -alpha
    p /= p.sum()
    lens = np.maximum(1, rng.poisson(avg_len, size=n_docs))
    return [rng.choice(n_vocab, size=int(l), p=p).astype(np.int32)
            for l in lens]


def zipf_queries(n_queries: int, n_vocab: int, *, q_len: int = 5,
                 seed: int = 1, alpha: float = 1.07) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_vocab + 1, dtype=np.float64)
    p = ranks ** -alpha
    p /= p.sum()
    return [rng.choice(n_vocab, size=q_len, p=p).astype(np.int32)
            for _ in range(n_queries)]


def ndcg_at_k(ranked_ids: np.ndarray, relevant: np.ndarray, k: int = 10
              ) -> float:
    """Binary-relevance NDCG@k."""
    rel = np.isin(ranked_ids[:k], relevant).astype(np.float64)
    dcg = (rel / np.log2(np.arange(2, rel.size + 2))).sum()
    ideal = min(k, relevant.size)
    idcg = (1.0 / np.log2(np.arange(2, ideal + 2))).sum()
    return float(dcg / idcg) if idcg > 0 else 0.0
