"""Query padding for the batched device scorers (host-side numpy).

The port's counterpart of ``repro.core.scoring``: only the part the query
path needs — :func:`pad_queries` and the :func:`bucket_pow2` re-export.
The per-query jnp scorer (``score_query``/``score_batch``) belongs to the
multi-device slice.
"""

from __future__ import annotations

import numpy as np

# re-exported here (budget logic's public home); defined next to the other
# static-shape/bucketing machinery in the sparse layout module
from ..sparse.block_csr import bucket_pow2  # noqa: F401


def pad_queries(query_tokens: list[np.ndarray], q_max: int, *,
                return_uniq: bool = False):
    """Unique-ify + pad a batch of tokenized queries.

    Returns ``tokens [B, q_max] int32`` (pad = -1) and
    ``weights [B, q_max] float32`` (occurrence counts; 0 = pad). Queries with
    more than ``q_max`` unique tokens keep the highest-count tokens.

    Vectorized: ONE flattened ``lexsort`` over the whole batch. Unique
    (query, token) pairs are the runs of the sorted flat stream; within-query
    ranks come from run bookkeeping, never a Python loop. Truncation order
    for queries over ``q_max`` is count-descending, token-ascending.

    ``return_uniq=True`` appends the batch's sorted unique tokens as a
    third output, derived from the run set instead of re-sorting the raw
    stream. It covers ALL input tokens, including any a truncated query
    dropped.
    """
    b = len(query_tokens)
    toks = np.full((b, q_max), -1, dtype=np.int32)
    wts = np.zeros((b, q_max), dtype=np.float32)
    no_uniq = np.zeros(0, dtype=np.int64)
    if b == 0:
        return (toks, wts, no_uniq) if return_uniq else (toks, wts)
    lens = np.fromiter((q.size for q in query_tokens), dtype=np.int64,
                       count=b)
    if lens.sum() == 0:
        return (toks, wts, no_uniq) if return_uniq else (toks, wts)
    flat = np.concatenate(query_tokens).astype(np.int64, copy=False)
    qi = np.repeat(np.arange(b, dtype=np.int64), lens)
    keep = flat >= 0
    flat, qi = flat[keep], qi[keep]
    if flat.size == 0:
        return (toks, wts, no_uniq) if return_uniq else (toks, wts)
    order = np.lexsort((flat, qi))
    flat, qi = flat[order], qi[order]
    # runs of equal (query, token) = the per-query unique tokens + counts
    new = np.empty(flat.size, dtype=bool)
    new[0] = True
    new[1:] = (flat[1:] != flat[:-1]) | (qi[1:] != qi[:-1])
    run = np.flatnonzero(new)
    counts = np.diff(np.append(run, flat.size))
    u_tok, u_qi = flat[run], qi[run]
    # within-query rank in ascending-token order
    grp_new = np.empty(u_qi.size, dtype=bool)
    grp_new[0] = True
    grp_new[1:] = u_qi[1:] != u_qi[:-1]
    grp_start = np.flatnonzero(grp_new)
    grp_sizes = np.diff(np.append(grp_start, u_qi.size))
    col_asc = np.arange(u_qi.size) - np.repeat(grp_start, grp_sizes)
    # within-query rank in (count-desc, token-asc) order
    order2 = np.lexsort((col_asc, -counts, u_qi))
    rank_desc = np.empty(u_qi.size, dtype=np.int64)
    rank_desc[order2] = np.arange(u_qi.size) - np.repeat(grp_start, grp_sizes)
    over = np.repeat(grp_sizes > q_max, grp_sizes)
    col = np.where(over, rank_desc, col_asc)
    sel = col < q_max
    toks[u_qi[sel], col[sel]] = u_tok[sel].astype(np.int32)
    wts[u_qi[sel], col[sel]] = counts[sel].astype(np.float32)
    if return_uniq:
        return toks, wts, np.unique(u_tok)
    return toks, wts
