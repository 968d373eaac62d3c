"""BM25S tokenizer: scikit-learn regex split + stopwords + Snowball stemming.

Faithful to §2 of the paper:

* splitting uses the exact scikit-learn ``CountVectorizer`` token pattern
  ``r"(?u)\\b\\w\\w+\\b"``;
* optional stopword removal (Elastic English list);
* optional Snowball stemming, applied to the *vocabulary* ("we can stem all
  words in the vocabulary, which can be used to look up the stemmed version
  of each word in the collection") — i.e. each unique surface form is stemmed
  once and occurrences are mapped through a dict;
* finally each (stemmed) unique word maps to an integer id, so documents and
  queries become ``int32`` arrays usable to index score matrices.

Everything here is host-side NumPy/Python — devices only ever see the ids.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

from .stemmer import snowball_stem
from .stopwords import get_stopwords

TOKEN_PATTERN = re.compile(r"(?u)\b\w\w+\b")


@dataclass
class Vocabulary:
    """Bidirectional word<->id mapping over (optionally stemmed) word forms."""

    word_to_id: dict[str, int] = field(default_factory=dict)
    frozen: bool = False

    def lookup(self, word: str) -> int:
        """Return id for ``word``, adding it if the vocab is not frozen."""
        wid = self.word_to_id.get(word, -1)
        if wid < 0 and not self.frozen:
            wid = len(self.word_to_id)
            self.word_to_id[word] = wid
        return wid

    def __len__(self) -> int:
        return len(self.word_to_id)

    @property
    def id_to_word(self) -> list[str]:
        out = [""] * len(self.word_to_id)
        for w, i in self.word_to_id.items():
            out[i] = w
        return out


@dataclass
class Tokenizer:
    """Configurable BM25S analyzer.

    Parameters mirror the paper's Table 2 ablation axes: ``stopwords`` in
    {"english", None} and ``stemmer`` in {"snowball", None}.
    """

    stopwords: str | None = "english"
    stemmer: str | None = "snowball"
    lower: bool = True

    def __post_init__(self) -> None:
        self._stop = get_stopwords(self.stopwords)
        self._stem_cache: dict[str, str] = {}
        self.vocab = Vocabulary()

    # -- single text ---------------------------------------------------------
    def split(self, text: str) -> list[str]:
        if self.lower:
            text = text.lower()
        return TOKEN_PATTERN.findall(text)

    def _stem(self, word: str) -> str:
        stemmed = self._stem_cache.get(word)
        if stemmed is None:
            stemmed = snowball_stem(word)
            self._stem_cache[word] = stemmed
        return stemmed

    def tokenize_words(self, text: str) -> list[str]:
        words = [w for w in self.split(text) if w not in self._stop]
        if self.stemmer is not None:
            words = [self._stem(w) for w in words]
        return words

    def tokenize_ids(self, text: str, *, update_vocab: bool = True) -> np.ndarray:
        """Tokenize to int32 ids. Unknown words map to -1 when vocab frozen."""
        was_frozen = self.vocab.frozen
        if not update_vocab:
            self.vocab.frozen = True
        try:
            ids = [self.vocab.lookup(w) for w in self.tokenize_words(text)]
        finally:
            self.vocab.frozen = was_frozen
        ids = [i for i in ids if i >= 0]
        return np.asarray(ids, dtype=np.int32)

    # -- corpus --------------------------------------------------------------
    def _tokenize_batch(self, texts: Sequence[str], *, update_vocab: bool
                        ) -> list[np.ndarray]:
        """One vectorized pass over a batch of texts.

        The hot loop of indexing. The per-TOKEN Python work of the
        sequential path (a stopword set probe, a stem-cache probe and a
        vocab dict probe per occurrence, plus per-token interpreter
        overhead) collapses to exactly ONE ``dict.setdefault`` per
        occurrence: the flattened word stream is factorized into distinct
        surface forms in first-occurrence order, the stopword / stemmer /
        vocabulary pipeline runs once per DISTINCT form into an id lookup
        array, and the whole batch's ids come back as one array gather
        ``lut[slots]`` — Zipf word distributions make distinct forms a
        small fraction of occurrences, which is where the speedup comes
        from (measured in ``benchmarks/tokenization.py``).

        Identical output to the sequential path, including vocabulary id
        ASSIGNMENT ORDER: distinct forms are processed in first-occurrence
        order, so a stem's id is assigned at the first occurrence of its
        earliest surface form — exactly when the per-token loop would
        have assigned it.
        """
        words_per_doc = [self.split(t) for t in texts]
        lens = np.fromiter((len(w) for w in words_per_doc), dtype=np.int64,
                           count=len(words_per_doc))
        total = int(lens.sum())
        if total == 0:
            return [np.zeros(0, dtype=np.int32) for _ in words_per_doc]
        slot_of: dict[str, int] = {}
        new_slot = slot_of.setdefault
        slots = np.fromiter(
            (new_slot(w, len(slot_of)) for ws in words_per_doc
             for w in ws),
            dtype=np.int64, count=total)
        lut = np.empty(len(slot_of), dtype=np.int32)
        was_frozen = self.vocab.frozen
        if not update_vocab:
            self.vocab.frozen = True
        try:
            for w, j in slot_of.items():          # first-occurrence order
                if w in self._stop:
                    lut[j] = -1
                    continue
                if self.stemmer is not None:
                    w = self._stem(w)
                lut[j] = self.vocab.lookup(w)
        finally:
            self.vocab.frozen = was_frozen
        ids = lut[slots]
        return [seg[seg >= 0].astype(np.int32)
                for seg in np.split(ids, np.cumsum(lens)[:-1])]

    def tokenize_corpus(self, texts: Iterable[str]) -> list[np.ndarray]:
        """Tokenize a corpus, growing the vocabulary (vectorized pass)."""
        return self._tokenize_batch(list(texts), update_vocab=True)

    def _tokenize_corpus_loop(self, texts: Iterable[str]
                              ) -> list[np.ndarray]:
        """The per-token sequential path — kept as the equivalence oracle
        for ``tokenize_corpus`` and the benchmark baseline."""
        return [self.tokenize_ids(t, update_vocab=True) for t in texts]

    def tokenize_queries(self, texts: Sequence[str]) -> list[np.ndarray]:
        """Tokenize queries against the frozen corpus vocabulary.

        Out-of-vocabulary query words are dropped: they cannot match any
        document, so their score contribution is exactly zero for the sparse
        variants, and they contribute only the query-constant ``S⁰`` shift
        for the shifted variants (handled by the retriever).
        """
        return self._tokenize_batch(list(texts), update_vocab=False)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)
