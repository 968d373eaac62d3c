"""Elastic's English stopword list.

The paper's tokenizer uses "Elastic's stopword list" — this is the standard
Lucene/Elasticsearch ``_english_`` analyzer stop set (33 words).
https://www.elastic.co/guide/en/elasticsearch/guide/current/stopwords.html
"""

from __future__ import annotations

ENGLISH_STOPWORDS: frozenset[str] = frozenset(
    {
        "a", "an", "and", "are", "as", "at", "be", "but", "by",
        "for", "if", "in", "into", "is", "it",
        "no", "not", "of", "on", "or", "such",
        "that", "the", "their", "then", "there", "these",
        "they", "this", "to", "was", "will", "with",
    }
)

STOPWORD_SETS: dict[str, frozenset[str]] = {
    "english": ENGLISH_STOPWORDS,
    "en": ENGLISH_STOPWORDS,
    "none": frozenset(),
}


def get_stopwords(name: str | None) -> frozenset[str]:
    """Resolve a stopword set by name. ``None`` / "none" disables stopwords."""
    if name is None:
        return frozenset()
    try:
        return STOPWORD_SETS[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown stopword set {name!r}; available: {sorted(STOPWORD_SETS)}"
        ) from None
