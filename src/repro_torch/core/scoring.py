"""Eager BM25S query scoring in torch, query padding and budget helpers.

The port's counterpart of ``repro.core.scoring``. The paper's eager path,

    slice the query tokens' postings  →  sum across the token dimension

becomes a ragged gather of each query's posting runs (bounded by a
postings budget ``p_max``) followed by a sum per document, one pass per
token position so that every sum has a fixed order. A query
is a padded ``(tokens[Q_max], weights[Q_max])`` pair; ``weights`` carries
the per-unique-token occurrence count (summing a token's postings ``w``
times ≡ the paper's per-occurrence summation) and 0 marks padding. The
shifted variants' query constant ``Σᵢ wᵢ·S⁰(qᵢ)`` (§2.1) is added, so the
scores are exact, not rank-equivalent. :func:`pad_queries` and the budget
helpers are host numpy, copied from the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# re-exported here (budget logic's public home); defined next to the other
# static-shape/bucketing machinery in the sparse layout module
from ..sparse.block_csr import bucket_pow2  # noqa: F401
from ..sparse.block_csr import put_posting_arrays
from .index import BM25Index

# score_batch adds at most this many gathered postings a group
_SLOTS_PER_STEP = 1 << 26


@dataclass
class DeviceIndex:
    """A :class:`BM25Index`'s CSC arrays on a torch device (one shard).

    The eager scorer's index, distinct from ``sparse.block_csr.
    DeviceIndex`` (the retriever's layouts), as in the reference.
    """

    indptr: torch.Tensor          # [V+1] int64
    doc_ids: torch.Tensor         # [nnz] int32
    scores: torch.Tensor          # [nnz] float32
    nonoccurrence: torch.Tensor   # [V] float32
    n_docs: int
    doc_offset: int = 0

    @property
    def device(self) -> torch.device:
        return self.scores.device

    @staticmethod
    def from_host(index: BM25Index, device=None) -> "DeviceIndex":
        """Upload ``index``'s arrays to ``device`` (default ``cuda``; a
        missing GPU raises ``ResidencyError``), counted as posting traffic
        by ``sparse.block_csr.TRANSFERS``."""
        return DeviceIndex.upload(index.indptr, index.doc_ids, index.scores,
                                  index.nonoccurrence,
                                  n_docs=int(index.doc_lens.size),
                                  doc_offset=int(index.doc_offset),
                                  device=device)

    @staticmethod
    def upload(indptr, doc_ids, scores, nonoccurrence, *, n_docs: int,
               doc_offset: int = 0, device=None) -> "DeviceIndex":
        """The CSC arrays (numpy, or anything ``np.array`` reads) copied
        with the port's dtypes and uploaded through ``put_posting_arrays``
        to ``device`` (default ``cuda``)."""
        from ..device import resolve_device
        arrays = put_posting_arrays(
            np.array(indptr, dtype=np.int64),
            np.array(doc_ids, dtype=np.int32),
            np.array(scores, dtype=np.float32),
            np.array(nonoccurrence, dtype=np.float32),
            device=resolve_device(device))
        return DeviceIndex(*arrays, n_docs=int(n_docs),
                           doc_offset=int(doc_offset))


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


def _query_tables(index: DeviceIndex, q_tokens, q_weights):
    """``q_tokens``/``q_weights`` ``[B, Q]`` (numpy or torch) as tensors on
    the index's device: int64 tokens, f32 weights."""
    toks = torch.as_tensor(q_tokens).to(index.device, torch.int64)
    wts = torch.as_tensor(q_weights).to(index.device, torch.float32)
    if toks.dim() != 2 or toks.shape != wts.shape:
        raise ValueError(f"q_tokens {tuple(toks.shape)} and q_weights "
                         f"{tuple(wts.shape)} must be equal [B, Q] tables")
    return toks, wts


def _run_lengths(indptr: torch.Tensor, q_tokens: torch.Tensor,
                 p_max: int):
    """Per (query, token): posting-run start, the slots the budget keeps,
    and each query's total demand ``Σᵢ df(qᵢ)``.

    Flat slot ``j`` of a query belongs to its first token ``i`` with
    ``cum[i] > j``; slots ``j >= p_max`` do not fit, so token ``i`` keeps
    ``clamp(min(cum[i], p_max) - (cum[i] - len[i]), 0)`` of its postings.
    """
    valid = q_tokens >= 0
    safe = torch.where(valid, q_tokens, 0)
    starts = indptr[safe]
    lens = torch.where(valid, indptr[safe + 1] - starts, 0)
    cum = torch.cumsum(lens, dim=1)                     # inclusive
    kept = (torch.clamp(cum, max=p_max) - (cum - lens)).clamp_(min=0)
    return starts, kept, cum[:, -1]


def _flatten_postings(indptr: torch.Tensor, q_tokens: torch.Tensor,
                      q_weights: torch.Tensor, p_max: int):
    """Ragged-gather bookkeeping for a ``[c, Q]`` block of queries.

    Returns ``(query row [S], CSC position [S], weight [S], ends [Q])`` for
    the ``S = Σ_b min(total_b, p_max)`` slots that hold a posting, ordered
    by token position ``i``, then query, then CSC order: position ``i``'s
    slots are ``[ends[i - 1], ends[i])`` (a Python list). The reference
    materialises all ``p_max`` slots of each query, token ``i``'s run
    before token ``i + 1``'s, and zeroes the empty ones; those add
    nothing, so they are left out here, and the budget drops the same
    postings: when ``total > p_max`` the trailing ``total - p_max`` slots
    of the query do not fit. Callers must surface ``total > p_max`` as an
    overflow flag, otherwise the truncation is undetectable score
    corruption.

    On ``meta`` tensors (a trace, which has no data) every query takes
    its whole budget: ``S = c · p_max`` slots in one pass, the static
    bound of the sizes above.
    """
    c, q = q_tokens.shape
    starts, kept, _ = _run_lengths(indptr, q_tokens, p_max)
    flat = kept.t().reshape(-1)                         # (position, query)
    ends = torch.cumsum(flat, 0)                        # inclusive
    if indptr.is_meta:
        n_slots = c * p_max if q else 0
    else:
        n_slots = int(ends[-1]) if q else 0
    slot = torch.arange(n_slots, device=indptr.device)
    # the run of each slot: the first whose end is past it (a binary search
    # a slot; repeat_interleave walks each run in one thread)
    owner = torch.searchsorted(ends, slot, right=True)
    pos = (starts.t().reshape(-1) - (ends - flat))[owner] + slot
    ends = ([n_slots] if indptr.is_meta
            else torch.cumsum(kept.sum(dim=0), 0).tolist())
    return owner % c, pos, q_weights.t().reshape(-1)[owner], ends


def score_batch(index: DeviceIndex, q_tokens, q_weights, *, p_max: int,
                return_overflow: bool = False):
    """Batched exact scoring: ``[B, Q_max] -> [B, n_docs]`` f32.

    The eager path: gather each query's precomputed posting scores (at most
    ``p_max`` of them, the reference's slot order), multiply by the token
    weight, add them per document, add the §2.1 shift. Queries are walked
    in groups of at most ``_SLOTS_PER_STEP`` gathered postings (a group
    holds at least one query), each added into the one ``[B, n_docs]``
    output; the grouping does not change any sum.

    Every sum has one fixed order, on the CPU and on the card alike: a
    group is added in one ``index_add_`` pass per token position ``i``
    (positions that keep no posting are skipped). One token's postings
    hit distinct documents, so within a pass every destination is written
    once and no two adds meet, whatever the device does with them. Each
    document therefore receives its postings in token-position order —
    the order of one serial ``index_add_`` over the reference's slots —
    and the §2.1 shift is summed in position order too, so the scores are
    bitwise equal on every device.

    With ``return_overflow=True`` also returns a ``[B]`` bool flag marking
    queries whose posting demand exceeded ``p_max`` (their scores miss the
    dropped postings — re-run with a larger budget or log the
    degradation; see ``BM25Retriever.retrieve``).

    On ``meta`` tensors (a trace) every query gathers its whole ``p_max``
    budget: the step's sizes at their static bound, ``B · p_max`` slots.
    """
    toks, wts = _query_tables(index, q_tokens, q_weights)
    b = toks.shape[0]
    n = index.n_docs
    out = torch.zeros((b, n), dtype=torch.float32, device=index.device)
    _, kept, total = _run_lengths(index.indptr, toks, p_max)
    per_query = ([p_max] * b if index.indptr.is_meta
                 else kept.sum(dim=1).tolist())
    b0 = 0
    while b0 < b:
        b1, slots = b0 + 1, per_query[b0]
        while b1 < b and slots + per_query[b1] <= _SLOTS_PER_STEP:
            slots += per_query[b1]
            b1 += 1
        row, pos, w, ends = _flatten_postings(index.indptr, toks[b0:b1],
                                              wts[b0:b1], p_max)
        dst = (row + b0) * n + index.doc_ids[pos]
        val = index.scores[pos] * w
        lo = 0
        for hi in ends:
            if hi > lo:           # one pass a token position: no dst twice
                out.view(-1).index_add_(0, dst[lo:hi], val[lo:hi])
            lo = hi
        b0 = b1
    valid = toks >= 0
    term = torch.where(valid, index.nonoccurrence[torch.where(
        valid, toks, 0)], 0.0) * wts
    shift = torch.zeros(b, dtype=torch.float32, device=index.device)
    for i in range(term.shape[1]):    # position order on every device
        shift += term[:, i]
    out += shift[:, None]
    if return_overflow:
        return out, total > p_max
    return out


def score_query(index: DeviceIndex, q_tokens, q_weights, *, p_max: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact BM25 scores of one query against this shard's documents.

    Returns ``(scores [n_docs], overflow [] bool)``: overflow is True iff
    ``Σᵢ df(qᵢ) > p_max``, i.e. the budget truncated postings and the
    scores are lower bounds. :func:`score_batch` on a batch of one.
    """
    scores, overflow = score_batch(
        index, torch.as_tensor(q_tokens)[None],
        torch.as_tensor(q_weights)[None], p_max=p_max, return_overflow=True)
    return scores[0], overflow[0]


def query_posting_budget(index: BM25Index, q_tokens: np.ndarray) -> int:
    """Host helper: exact Σ df(qᵢ) for a padded query batch (budget sizing)."""
    df = np.diff(index.indptr)
    safe = np.where(q_tokens >= 0, q_tokens, 0)
    return int((np.where(q_tokens >= 0, df[safe], 0)).sum(axis=-1).max())


def batch_posting_budget(index: BM25Index, q_tokens: np.ndarray) -> int:
    """Exact Σ df over the BATCH's unique tokens — the gathered path's work.

    The gather materializes each unique token's posting run once for the
    whole batch, so its budget is Σ df(unique(batch)), not the per-query
    maximum :func:`query_posting_budget` sizes.
    """
    uniq = np.unique(q_tokens[q_tokens >= 0])
    df = np.diff(index.indptr)
    return int(df[uniq].sum()) if uniq.size else 0


def suggest_p_max(index: BM25Index, q_max: int, *, quantile: float = 1.0,
                  tile: int = 1024) -> int:
    """Static budget heuristic: q_max × weighted-quantile(df), tile-rounded.

    The quantile is **df-weighted**: realistic query tokens are drawn
    roughly ∝ df (head tokens dominate traffic), so the budget question is
    "how big is the posting run of the q-quantile *query token*", not of
    the q-quantile *distinct vocabulary entry*. An unweighted quantile over
    distinct tokens wildly undersizes on Zipfian vocabularies where the
    tail is millions of df=1 tokens but queries hit the head. At
    ``quantile=1.0`` both definitions degenerate to ``max(df)`` (the
    default stays a safe upper bound).
    """
    df = np.diff(index.indptr)
    df = df[df > 0]
    if df.size:
        sdf = np.sort(df)
        cum = np.cumsum(sdf, dtype=np.float64)
        i = int(np.searchsorted(cum, quantile * cum[-1], side="left"))
        per_tok = float(sdf[min(i, sdf.size - 1)])
    else:
        per_tok = 1.0
    budget = int(q_max * per_tok)
    return max(tile, ((budget + tile - 1) // tile) * tile)
