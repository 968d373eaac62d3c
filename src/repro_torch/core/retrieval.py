"""Retrieval planner, query sanitizer, top-k helpers and the default splice.

The port's counterpart of ``repro.core.retrieval``: the numpy half
(planner, sanitizer, default-document ids, host top-k and merges) is
copied; :func:`splice_default_docs` is torch. The sharded step
(:func:`make_sharded_retrieve` over :func:`sharded_topk_step`,
:func:`sharded_retrieve_adaptive`, :func:`stack_shard_arrays`) runs the
reference's ``shard_map`` step on a ``torch.distributed`` device mesh: a
local score and top-k on each rank's shard, an all-gather of the
candidates, a global merge.

**The tie rule.** Every board the port returns is ordered by score
descending, then document id ascending (:func:`rank_order`). The
reference's sequential fold orders equal scores by schedule; the port's
kernels run blocks in parallel, so it pins one total order instead and
every kernel, twin and merge follows it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch


# -- retrieval planner (cost model over the three device regimes) ------------
#
# The full-scan regime streams EVERY posting tile: O(nnz) per batch. The
# gathered regime touches only the batch's posting runs: O(Σ df) plus
# per-run overhead. Both costs are known BEFORE any kernel runs, so the
# regime choice is a free host-side comparison of
#
#     work_ratio = nnz / Σ df(batch uniq tokens)   vs   CROSSOVER
#
# The constants are the reference's; they were calibrated off the card and
# are re-derived on the H100 by the port's benchmark slice.

DEFAULT_CROSSOVER = 2.0

# With DEVICE-side fragment planning (``sparse.fragment_device``) the
# gathered regime no longer pays the per-batch host descriptor walk or its
# upload, so the default crossover is scaled by this discount when the
# caller plans on the device.
DEVICE_PLAN_DISCOUNT = 0.75

# The PRUNED regime runs the gathered machinery over the fragments whose
# block-max bound can still beat the top-k threshold: its modeled cost is
# the gathered cost × the estimated surviving fraction / this discount (the
# bound product, the seed pass and the re-scored seed blocks are overhead),
# so pruning must be expected to cut at least (1 - PRUNE_DISCOUNT) of the
# gathered work before the planner picks it.
PRUNE_DISCOUNT = 0.5


@dataclass
class RetrievalPlan:
    """One batch's regime decision plus the evidence it was made on.

    The ``frags_*`` counters are filled in by the executing retriever (zero
    until then): ``frags_planned`` is the batch's full fragment count,
    ``frags_pruned`` how many the pre-launch threshold compaction removed,
    ``frags_skipped`` how many more the in-kernel board test skipped.

    ``degradations`` is the batch's fallback trail: one entry per ladder
    hop the executing retriever was forced to take (empty on the healthy
    path), each a dict ``{"from", "to", "error", "detail"}``.
    """

    regime: str             # "blocked" | "gathered" | "pruned"
    sum_df: int             # Σ df over the batch's unique tokens
    nnz: int                # the shard's posting count (full-scan work)
    work_ratio: float       # nnz / max(sum_df, 1)
    crossover: float        # threshold used
    forced: bool            # True when the operator pinned the regime
    plan: str = "host"      # where the fragment table is built
    survivor_frac: float | None = None  # pruning-work estimate fed to auto
    frags_planned: int = 0
    frags_pruned: int = 0
    frags_skipped: int = 0
    degradations: list = field(default_factory=list)


def plan_retrieval(sum_df: int, nnz: int, *, regime: str = "auto",
                   crossover: float | None = None,
                   plan: str = "host",
                   survivor_frac: float | None = None) -> RetrievalPlan:
    """Pick full-scan vs gathered vs pruned for one batch (free — no
    device work).

    ``regime="blocked"``/``"gathered"``/``"pruned"`` force that regime (the
    plan still records the evidence); ``"auto"`` compares modeled costs:

    * blocked   — ``nnz``;
    * gathered  — ``crossover × Σ df``;
    * pruned    — the gathered cost × ``survivor_frac / PRUNE_DISCOUNT``
      (only when the caller supplies ``survivor_frac``).

    A batch with no postings is trivially gathered. Cost ties keep the
    earlier regime (gathered over blocked, either over pruned).
    ``plan="device"`` scales the DEFAULT crossover by
    :data:`DEVICE_PLAN_DISCOUNT` (an explicit ``crossover`` is used
    verbatim).
    """
    if regime not in ("auto", "blocked", "gathered", "pruned"):
        raise ValueError(f"unknown regime {regime!r}")
    if plan not in ("host", "device"):
        raise ValueError(f"unknown plan mode {plan!r}")
    if crossover is None:
        c = DEFAULT_CROSSOVER * (DEVICE_PLAN_DISCOUNT if plan == "device"
                                 else 1.0)
    else:
        c = float(crossover)
    ratio = nnz / max(sum_df, 1)
    if regime != "auto":
        chosen, forced = regime, True
    elif sum_df == 0:
        chosen, forced = "gathered", False
    else:
        costs = {"gathered": c * sum_df, "blocked": float(nnz)}
        if survivor_frac is not None:
            costs["pruned"] = (c * sum_df * float(survivor_frac)
                               / PRUNE_DISCOUNT)
        # first-listed wins ties
        chosen = min(costs, key=lambda r: (costs[r],
                                           list(costs).index(r)))
        forced = False
    return RetrievalPlan(regime=chosen, sum_df=int(sum_df), nnz=int(nnz),
                         work_ratio=float(ratio), crossover=c,
                         forced=forced, plan=plan,
                         survivor_frac=survivor_frac)


def validate_query_batch(query_tokens, n_vocab: int, *,
                         counters: dict | None = None,
                         on_invalid: str = "sanitize") -> list[np.ndarray]:
    """The ONE query sanitizer every retriever entry point shares.

    Normalizes each entry to a 1-D int32 array in ``[0, n_vocab)``:

    * ``None`` / empty entries        -> empty queries;
    * multi-dimensional arrays        -> raveled;
    * float dtypes with integral data -> recast;
    * non-integral floats / NaN       -> those tokens dropped;
    * out-of-range / negative ids     -> those tokens dropped.

    Every repair increments ``counters`` (keys ``dropped_tokens``,
    ``recast_queries``, ``raveled_queries``, ``null_queries``).
    ``on_invalid="raise"`` surfaces
    :class:`repro_torch.serve.errors.InvalidQueryError` on the FIRST lossy
    defect instead of repairing.
    """
    if on_invalid not in ("sanitize", "raise"):
        raise ValueError(f"unknown on_invalid mode {on_invalid!r}")
    c = counters if counters is not None else {}

    def bump(key, n=1):
        c[key] = c.get(key, 0) + n

    def bad(msg):
        from ..serve.errors import InvalidQueryError
        raise InvalidQueryError(msg)

    out = []
    for i, q in enumerate(query_tokens):
        if q is None:
            if on_invalid == "raise":
                bad(f"query {i} is None")
            bump("null_queries")
            out.append(np.zeros(0, np.int32))
            continue
        a = np.asarray(q)
        if a.ndim != 1:
            if on_invalid == "raise" and a.ndim > 1:
                bad(f"query {i} has shape {a.shape}; expected 1-D token ids")
            if a.ndim > 1:
                bump("raveled_queries")
            a = a.ravel()
        if a.dtype.kind == "f":
            finite = np.isfinite(a)
            integral = finite & (a == np.floor(a))
            if not integral.all():
                if on_invalid == "raise":
                    bad(f"query {i} has non-integral or non-finite "
                        f"token ids (dtype {a.dtype})")
                bump("dropped_tokens", int((~integral).sum()))
                a = a[integral]
            bump("recast_queries")
            a = a.astype(np.int64)
        elif a.dtype.kind == "b":
            bump("recast_queries")
            a = a.astype(np.int64)
        elif a.dtype.kind not in ("i", "u"):
            if on_invalid == "raise":
                bad(f"query {i} has non-numeric dtype {a.dtype}")
            bump("dropped_tokens", int(a.size))
            a = np.zeros(0, np.int64)
        ok = (a >= 0) & (a < n_vocab)
        if not ok.all():
            if on_invalid == "raise":
                lo = int(a.min()) if a.size else 0
                hi = int(a.max()) if a.size else 0
                bad(f"query {i} token ids must be in [0, {n_vocab}); "
                    f"got range [{lo}, {hi}]")
            bump("dropped_tokens", int((~ok).sum()))
            a = a[ok]
        out.append(a.astype(np.int32, copy=False))
    return out


def default_doc_ids(vis_blocks: np.ndarray, k: int, n_docs: int,
                    block_size: int) -> np.ndarray:
    """First ``k`` doc ids from blocks a batch never visited.

    Every doc in an unvisited block has raw score exactly 0 (no posting
    touched it), so any ``k`` of them serve as the default-document
    candidates the splice needs. Entries ``>= n_docs`` mean fewer than
    ``k`` unvisited docs exist; callers mask them.

    Fully vectorized, O(k log nv): ``vis_blocks`` is sorted unique, so
    ``vis[i] - i`` counts the unvisited blocks below ``vis[i]``.
    """
    out = np.full(k, n_docs, dtype=np.int32)
    if k <= 0 or n_docs <= 0:
        return out
    vis = np.asarray(vis_blocks, dtype=np.int64)
    n_blocks = -(-n_docs // block_size)
    # first k unvisited block ids (each supplies ≥1 doc id, so k suffice)
    j = np.arange(min(k, n_blocks), dtype=np.int64)
    unvis = j + np.searchsorted(vis - np.arange(vis.size), j + 1)
    unvis = unvis[unvis < n_blocks]
    if unvis.size == 0:
        return out
    lo = unvis * block_size
    cnt = np.minimum(lo + block_size, n_docs) - lo
    cum = np.cumsum(cnt)
    cut = int(np.searchsorted(cum, k)) + 1        # blocks that reach k ids
    lo, cnt, cum = lo[:cut], cnt[:cut], cum[:cut]
    total = int(cum[-1])
    flat = np.repeat(lo, cnt) + (np.arange(total, dtype=np.int64)
                                 - np.repeat(cum - cnt, cnt))
    take = min(k, total)
    out[:take] = flat[:take].astype(np.int32)
    return out


def topk_numpy(scores: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Paper's np.argpartition path (introspective selection, O(n) average)."""
    k = min(k, scores.shape[-1])
    part = np.argpartition(scores, -k, axis=-1)[..., -k:]
    vals = np.take_along_axis(scores, part, axis=-1)
    order = np.argsort(-vals, axis=-1, kind="stable")
    idx = np.take_along_axis(part, order, axis=-1)
    return idx, np.take_along_axis(scores, idx, axis=-1)


def merge_topk(parts, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side global merge of per-shard ``(ids, scores)`` candidate
    lists (the paper's two-stage top-k, stage 2)."""
    pairs = [(np.asarray(i), np.asarray(s)) for i, s in parts]
    if k <= 0 or not pairs or sum(i.size for i, _ in pairs) == 0:
        return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float32))
    ids = np.concatenate([i.astype(np.int64, copy=False) for i, _ in pairs])
    scores = np.concatenate([s for _, s in pairs]).astype(np.float64,
                                                          copy=False)
    k = min(k, ids.size)
    part = np.argpartition(scores, -k)[-k:]
    order = np.argsort(-scores[part], kind="stable")
    sel = part[order]
    return ids[sel], scores[sel].astype(np.float32)


def merge_topk_batch(parts, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Batched stage-2 merge: per-shard ``(ids [B, k_s], scores [B, k_s])``
    candidate lists -> global ``(ids [B, k], scores [B, k])``."""
    pairs = [(np.asarray(i), np.asarray(s)) for i, s in parts]
    b = max((i.shape[0] for i, _ in pairs), default=0)
    pairs = [(i, s) for i, s in pairs if i.size]
    if k <= 0 or not pairs:
        return (np.zeros((b, 0), np.int64), np.zeros((b, 0), np.float32))
    ids = np.concatenate([i.astype(np.int64, copy=False) for i, _ in pairs],
                         axis=1)
    sc = np.concatenate([s for _, s in pairs], axis=1).astype(np.float64,
                                                              copy=False)
    k = min(k, ids.shape[1])
    part = np.argpartition(sc, -k, axis=1)[:, -k:]
    vals = np.take_along_axis(sc, part, axis=1)
    order = np.argsort(-vals, axis=1, kind="stable")
    sel = np.take_along_axis(part, order, axis=1)
    return (np.take_along_axis(ids, sel, axis=1),
            np.take_along_axis(sc, sel, axis=1).astype(np.float32))


def rank_order(vals: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Indices that sort the last axis by (value desc, id asc) — the tie rule.

    One sort over an int64 key: the float's order-preserving bit pattern,
    inverted for descending, in the high 32 bits, and ``id + 1`` (ids are
    ≥ -1 and < 2^31) in the low 32. ``-0.0`` is folded onto ``+0.0`` first
    so the key agrees with float comparison, as the kernels' compares do.
    """
    bits = (vals.float() + 0.0).view(torch.int32).to(torch.int64)
    u = bits & 0xFFFFFFFF
    asc = torch.where(bits < 0, (~u) & 0xFFFFFFFF, u | 0x80000000)
    desc = 0xFFFFFFFF - asc - 0x80000000                 # signed, desc
    key = desc * (1 << 32) + (ids.to(torch.int64) + 1)
    return torch.sort(key, dim=-1).indices


def topk_torch(scores: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis in the port's tie order (:func:`rank_order`:
    score desc, index asc). Returns ``(indices, values)``, as the
    reference's ``topk_jax`` does."""
    n = scores.shape[-1]
    pos = torch.arange(n, device=scores.device).expand(scores.shape)
    idx = rank_order(scores, pos)[..., :k]
    return idx, torch.gather(scores, -1, idx)


def blockwise_topk(scores: torch.Tensor, k: int, block: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-stage top-k: per-block top-``min(k, block)``, then a merge.

    Lossless: every global winner is a winner of its own block. The plain
    counterpart of ``kernels.ops.topk`` (whose stage 1 is K5) and the
    tests' oracle for it. A ragged last block is padded with ``-inf`` at
    indices ``>= n``, which rank after every real entry; ``k > n`` raises
    ``ValueError``. Returns ``(indices, values)`` in the port's tie order,
    as the reference's ``blockwise_topk`` returns them.
    """
    n = scores.shape[-1]
    if k > n:
        raise ValueError(f"k={k} exceeds the {n} entries")
    nb = -(-n // block)
    kb = min(k, block)
    lead = scores.shape[:-1]
    padded = torch.nn.functional.pad(scores, (0, nb * block - n),
                                     value=float("-inf"))
    blocks = padded.reshape(*lead, nb, block)
    bidx, bvals = topk_torch(blocks, kb)                 # [..., nb, kb]
    base = (torch.arange(nb, device=scores.device) * block)[:, None]
    gidx = (bidx + base).reshape(*lead, nb * kb)
    midx, mvals = topk_torch(bvals.reshape(*lead, nb * kb), k)
    return torch.gather(gidx, -1, midx), mvals


def missing_doc_ids(candidates: torch.Tensor, k: int,
                    n_docs: int) -> torch.Tensor:
    """First ``k`` doc ids NOT in a sorted candidate list (the j-th missing
    element trick, O(k log C)), as ``[k]`` int32 on ``candidates``' device.

    ``candidates`` is sorted ascending over its valid prefix, then -1
    padding (the ``GatheredPostings`` candidate table, flattened).
    ``missing_before[i] = candidates[i] - i`` counts the doc ids below
    ``candidates[i]`` that are absent; the j-th missing id (0-based) is
    then ``j + searchsorted(missing_before, j + 1)``. Returned entries
    ``>= n_docs`` mean fewer than ``k`` ids are missing — callers mask
    them.
    """
    dev = candidates.device
    iota = torch.arange(candidates.numel(), dtype=torch.int64, device=dev)
    miss_before = torch.where(candidates >= 0,
                              candidates.to(torch.int64) - iota, n_docs + 1)
    j = torch.arange(k, dtype=torch.int64, device=dev)
    return (j + torch.searchsorted(miss_before, j + 1)).to(torch.int32)


def splice_default_docs(cand_vals: torch.Tensor, cand_ids: torch.Tensor,
                        k: int, n_docs: int, *,
                        default_ids: torch.Tensor,
                        doc_limit: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge candidate winners with ``k`` DEFAULT documents per query.

    A document outside the candidate set contributes no posting, so its
    exact raw score is 0 (the §2.1 nonoccurrence shift is a per-query
    constant added later). Those defaults matter whenever a matched doc
    scores *below* zero (robertson IDF) or fewer than ``k`` docs match.
    ``default_ids`` (``[k]``) are known-default ids (the resident path's
    unvisited-block defaults, :func:`default_doc_ids`); ids at/above
    ``doc_limit`` (default ``n_docs``) are padding, masked to the float
    minimum. ``cand_vals``/``cand_ids`` are ``[B, m]`` candidate winners
    (raw scores). Returns ``(ids [B, k], raw values [B, k])`` in the
    port's tie order (:func:`rank_order`).
    """
    if doc_limit is None:
        doc_limit = n_docs
    b = cand_vals.shape[0]
    miss = default_ids.to(device=cand_ids.device, dtype=cand_ids.dtype)
    neg = torch.finfo(cand_vals.dtype).min
    def_v = torch.where(miss < doc_limit,
                        torch.zeros((), dtype=cand_vals.dtype,
                                    device=cand_vals.device),
                        torch.full((), neg, dtype=cand_vals.dtype,
                                   device=cand_vals.device))
    all_v = torch.cat([cand_vals, def_v[None].expand(b, k)], dim=1)
    all_i = torch.cat([cand_ids, miss[None].expand(b, k)], dim=1)
    sel = rank_order(all_v, all_i)[:, :k]
    return torch.gather(all_i, 1, sel), torch.gather(all_v, 1, sel)


# -- the sharded step: a document-sharded corpus on a device mesh ------------
#
# Every rank holds one shard of the corpus (``stack_shard_arrays``) and the
# same replicated query batch. A step scores and selects on the rank's own
# shard, all-gathers the ``[B, kk]`` winners of every shard over the shard
# axes' process group and ranks the ``shards × kk`` candidates — the
# reference's ``shard_map`` step, one process a shard.

# the gathered step adds at most this many postings an ``index_add_``
_SLOTS_PER_STEP = 1 << 26


def _spans(lengths: list[int], cap: int) -> list[tuple[int, int]]:
    """Consecutive ``[lo, hi)`` groups of ``lengths`` summing to at most
    ``cap`` each (a group holds at least one entry)."""
    out, lo, acc = [], 0, 0
    for i, n in enumerate(lengths):
        if i > lo and acc + n > cap:
            out.append((lo, i))
            lo, acc = i, 0
        acc += n
    if lo < len(lengths):
        out.append((lo, len(lengths)))
    return out


def _device_gathered_topk(indptr, doc_ids, scores, nonocc, q_tokens,
                          q_weights, n_docs_true, *, p_max: int, k: int,
                          n_docs: int):
    """Shard-local query-driven gather → candidate top-k, all on device.

    The port of the reference's device half of the inverted-index regime:

    1. the batch's unique tokens and their posting runs ``(start, len)``
       from the CSC ``indptr``;
    2. one gather of the runs, in ascending token order, cut at the
       ``p_max`` budget — work O(Σ df over the batch's unique tokens),
       shared by the B queries;
    3. candidate compaction (the distinct gathered documents, ascending)
       and exact sums into a ``[B, C]`` accumulator, C the number of
       candidates ≤ min(p_max, n_docs) — never O(n_docs) and never
       ``[p_max, B]``: the reference materialises every slot's ``[B]``
       contribution, 137 GB at 2^27 slots and B = 256;
    4. per-query top-k over the candidates (``kernels.ops.topk``: K5 for
       more than 4,096 candidates) + the default-document splice (a doc
       outside the candidate set scores exactly the §2.1 shift; ids at or
       past the shard's real count ``n_docs_true`` are padding, masked to
       the float minimum), then the shift, summed in position order.

    **Fixed order.** A document receives its postings in ascending token
    order: pass ``r`` adds, for every query, the run of its ``r``-th
    distinct token (its weight summed over duplicate positions, in
    position order, as the reference's weight table sums them). One
    token's run holds distinct documents and each query has one ``r``-th
    token, so every destination is written once a pass and no two adds
    meet, whatever the device does with them: the bits are the same on
    the CPU and the card. Skipping the (token, query) pairs the query
    lacks changes no bit (they add ``+0.0`` to sums that are never
    ``-0.0``).

    ``n_docs`` is the PADDED per-shard doc count. Returns ``(ids [B, kk]
    int32, scores [B, kk] f32, overflow [] bool)`` with ``kk = min(k,
    n_docs)``, in the port's tie order; overflow is True iff the batch's
    posting demand exceeded ``p_max`` (the scores are then lower bounds —
    callers retry at a larger bucket).
    """
    from ..kernels import ops

    dev = scores.device
    toks = torch.as_tensor(q_tokens).to(dev, torch.int64)
    wts = torch.as_tensor(q_weights).to(dev, torch.float32)
    b, q = toks.shape
    kk = min(k, n_docs)
    valid = toks >= 0
    safe = torch.where(valid, toks, 0)

    uniq = torch.unique(toks[valid])                            # sorted
    starts = indptr[uniq].to(torch.int64)
    lens = indptr[uniq + 1].to(torch.int64) - starts
    cum = torch.cumsum(lens, 0)
    total = int(cum[-1]) if uniq.numel() else 0
    ends = cum.clamp(max=p_max)               # the budget keeps a prefix
    kept = (ends - (cum - lens)).clamp_(min=0)
    first = ends - kept                       # a run's first kept slot
    slot = torch.arange(min(total, p_max), device=dev)
    owner = torch.searchsorted(ends, slot, right=True)
    pos = starts[owner] + (slot - first[owner])
    g_sc = scores[pos]
    cand, cslot = torch.unique(doc_ids[pos], return_inverse=True)
    del slot, owner, pos
    c = cand.numel()

    # each query's (unique token, weight) pairs, weights summed in position
    # order: a position pass writes each (token, query) at most once
    u_of = torch.searchsorted(uniq, safe)
    table = torch.zeros((uniq.numel(), b), dtype=torch.float32, device=dev)
    present = torch.zeros((uniq.numel(), b), dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)
    for i in range(q):
        v = valid[:, i]
        table[u_of[v, i], rows[v]] += wts[v, i]
        present[u_of[v, i], rows[v]] = True
    pu, pb = present.nonzero(as_tuple=True)           # by token, then query
    rank = (present.cumsum(0) - 1)[pu, pb]            # r-th token of its query
    order = torch.argsort(rank, stable=True)
    pu, pb = pu[order], pb[order]
    p_len, p_first, p_w = kept[pu], first[pu], table[pu, pb]
    n_pass = torch.bincount(rank, minlength=1).tolist()
    lengths = p_len.tolist()

    acc = torch.zeros((b, c), dtype=torch.float32, device=dev)
    lo = 0
    for n in n_pass:                                  # pass r, r ascending
        for s0, s1 in _spans(lengths[lo:lo + n], _SLOTS_PER_STEP):
            s0, s1 = lo + s0, lo + s1
            pend = torch.cumsum(p_len[s0:s1], 0)
            j = torch.arange(int(pend[-1]), device=dev)
            p = torch.searchsorted(pend, j, right=True)
            g = p_first[s0:s1][p] + (j - (pend - p_len[s0:s1])[p])
            acc.view(-1).index_add_(0, pb[s0:s1][p] * c + cslot[g],
                                    g_sc[g] * p_w[s0:s1][p])
        lo += n
    del g_sc, cslot

    m = min(kk, c)
    if m:
        vals, ci = ops.topk(acc, m)       # ties: candidate order = doc id
        ids = cand[ci.long()].to(torch.int32)
    else:
        vals = torch.empty((b, 0), dtype=torch.float32, device=dev)
        ids = torch.empty((b, 0), dtype=torch.int32, device=dev)
    del acc
    ids, mvals = splice_default_docs(
        vals, ids, kk, n_docs, default_ids=missing_doc_ids(cand, kk, n_docs),
        doc_limit=int(n_docs_true))
    term = torch.where(valid, nonocc[safe], 0.0) * wts
    shift = torch.zeros(b, dtype=torch.float32, device=dev)
    for i in range(q):                    # position order on every device
        shift += term[:, i]
    return (ids, mvals + shift[:, None],
            torch.tensor(total > p_max, device=dev))


def _mesh_sizes(mesh, shard_axes: tuple[str, ...]) -> list[int]:
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in shard_axes if a not in names]
    if missing or not shard_axes:
        raise ValueError(f"shard axes {shard_axes} must name axes of the "
                         f"mesh {names}")
    if list(shard_axes) != sorted(shard_axes, key=names.index):
        raise ValueError(f"list the shard axes {shard_axes} in the mesh's "
                         f"order {names}")
    return [int(mesh.shape[names.index(a)]) for a in shard_axes]


def _local(x) -> torch.Tensor:
    """The rank's leading-dim-1 block of a stacked index array."""
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def shard_id(mesh, shard_axes: tuple[str, ...]) -> int:
    """This rank's shard id: its mesh coordinate over ``shard_axes``,
    row-major in the mesh's order (the leading index of its block in the
    arrays :func:`stack_shard_arrays` stacks)."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    sid = 0
    for a in shard_axes:
        d = names.index(a)
        sid = sid * int(mesh.shape[d]) + int(coord[d])
    return sid


def sharded_topk_step(mesh, shard_axes: tuple[str, ...], local_topk, *,
                      k: int):
    """The sharded step's skeleton: a top-k a rank, one all-gather of the
    candidates, the global merge.

    ``step(*args)`` replaces every ``DTensor`` among ``args`` (nested
    tuples and lists too) by the rank's own shard and calls
    ``local_topk(sid, *args)``, ``sid`` being :func:`shard_id`. That
    returns the rank's ``[B, kk]`` GLOBAL ids (the step's own rule: a
    stacked offsets array, or ``sid`` times the shard's width) and
    scores, and ``[B]`` overflow flags or None; the step all-gathers them
    over the shard axes' group and returns the top ``k`` of the
    ``[B, shards · kk]`` candidates by :func:`rank_order`, and the flags
    OR-ed (None if the local step had none) — the same on every rank.

    A ``cuda`` mesh needs an NCCL group and a ``cpu`` mesh a gloo one
    (``ValueError`` otherwise). Every rank of the default group must build
    the step (several shard axes create their flattened group
    collectively); only the mesh's ranks call it.
    """
    from torch.utils._pytree import tree_map

    from ..dist import sharding
    from ..launch.mesh import check_mesh_backend

    shard_axes = tuple(shard_axes)
    n_shards = math.prod(_mesh_sizes(mesh, shard_axes))
    check_mesh_backend(mesh.device_type)
    flat_group = sharding.flat_group(mesh, shard_axes)

    def step(*args):
        gidx, vals, over = local_topk(shard_id(mesh, shard_axes),
                                      *tree_map(_local, args))
        group = (mesh.get_group(shard_axes[0]) if flat_group is None
                 else flat_group)
        return _all_gather_merge(gidx, vals, over, group, n_shards, k)

    return step


def make_sharded_retrieve(mesh, shard_axes: tuple[str, ...], *, p_max: int,
                          k: int, n_docs_per_shard: int,
                          return_overflow: bool = False,
                          gathered: bool = False):
    """Build the pod-scale retrieval step: shard-local score + top-k, an
    all-gather of the candidates, the global merge.

    ``mesh`` is a ``DeviceMesh`` (``launch.mesh.make_mesh_from``); the
    index arrays are sharded over ``shard_axes`` (:func:`stack_shard_arrays`:
    one shard a rank, leading dim = shard id) and the queries are
    replicated: every rank passes the same ``q_tokens [B, Q]`` /
    ``q_weights [B, Q]`` (numpy or tensors; they go to the rank's device).
    Returns ``retrieve(idx_arrays, q_tokens, q_weights) -> (global doc
    ids [B, k] int32, scores [B, k] f32)``, the same on every rank of the
    mesh. With ``return_overflow=True`` a third ``[B]`` bool output marks
    queries whose posting demand exceeded ``p_max`` on ANY shard (their
    scores are lower bounds).

    The local step is the port's fixed-order ``score_batch`` over the
    shard (docs at or past the shard's real count masked to the float
    minimum) and ``kernels.ops.topk`` of ``min(k, n_docs_per_shard)``
    (K5 past 4,096 documents), its ids offset by the shard's stacked
    ``offsets``; ``gathered=True`` swaps in :func:`_device_gathered_topk`,
    whose overflow flag is batch-global. The gather and the merge are
    :func:`sharded_topk_step`'s. ``k`` larger than ``shards × kk`` raises
    ``ValueError``.

    A ``cuda`` mesh needs an NCCL group and a ``cpu`` mesh a gloo one
    (``ValueError`` otherwise): nothing is copied to the host to make a
    collective work. Every rank of the default group must build the step
    (several shard axes create their flattened group collectively); only
    the mesh's ranks call it.
    """
    from ..kernels import ops
    from .scoring import DeviceIndex, score_batch

    shard_axes = tuple(shard_axes)
    n_shards = math.prod(_mesh_sizes(mesh, shard_axes))
    kk = min(k, n_docs_per_shard)
    neg = torch.finfo(torch.float32).min

    def local_score_topk(_sid, idx_arrays, toks, wts):
        indptr, doc_ids, scores, nonocc, offsets, counts = (
            x[0] for x in idx_arrays)
        if gathered:
            gidx, vals, over = _device_gathered_topk(
                indptr, doc_ids, scores, nonocc, toks, wts, counts[0],
                p_max=p_max, k=k, n_docs=n_docs_per_shard)
            return (gidx + offsets.to(torch.int32), vals,
                    over.expand(toks.shape[0]))
        dindex = DeviceIndex(indptr, doc_ids, scores, nonocc,
                             n_docs=n_docs_per_shard)
        s, over = score_batch(dindex, toks, wts, p_max=p_max,
                              return_overflow=True)        # [B, n_local]
        # docs past the shard's REAL count exist only as stacking padding
        # (uneven shards): a padded doc would score the bare shift and
        # could displace real winners — mask before selecting (a trace on
        # ``meta`` tensors has no count: it masks at the bound, every doc)
        s[:, 0 if s.is_meta else int(counts[0]):] = neg
        vals, local_idx = ops.topk(s, kk)
        return local_idx + offsets.to(torch.int32), vals, over

    step = sharded_topk_step(mesh, shard_axes, local_score_topk, k=k)

    def retrieve(idx_arrays, q_tokens, q_weights):
        if k > n_shards * kk:
            raise ValueError(f"k={k} exceeds the {n_shards} shards × "
                             f"{kk} candidates the merge receives")
        dev = _local(idx_arrays[0]).device
        toks = torch.as_tensor(q_tokens).to(dev, torch.int64)
        wts = torch.as_tensor(q_weights).to(dev, torch.float32)
        ids, mvals, over = step(idx_arrays, toks, wts)
        if return_overflow:
            return ids, mvals, over
        return ids, mvals

    return retrieve


def _all_gather_merge(gidx, vals, over, group, n_shards: int, k: int):
    """The sharded step's merge: every shard's ``[B, kk]`` ids and scores
    and ``[B]`` flags (when it has them), all-gathered in one int32 tensor
    over ``group``, then the top ``k`` of the ``[B, n_shards · kk]``
    candidates by :func:`rank_order` and the flags OR-ed (None for None).
    The same on every rank. bf16 scores travel as their exact f32
    widening and come back bf16."""
    import torch.distributed as tdist

    b, kk = gidx.shape
    dt = vals.dtype             # f32, or bf16 carried as its exact f32
    cols = [gidx.to(torch.int32), vals.float().contiguous().view(torch.int32)]
    if over is not None:
        cols.append(over.to(torch.int32)[:, None])
    packed = torch.cat(cols, dim=1)
    parts = [torch.empty_like(packed) for _ in range(n_shards)]
    tdist.all_gather(parts, packed, group=group)
    allp = torch.stack(parts, dim=1)              # [B, S, 2kk (+ 1)]
    alli = allp[..., :kk].reshape(b, -1)
    allv = allp[..., kk:2 * kk].contiguous().view(torch.float32
                                                  ).reshape(b, -1).to(dt)
    sel = rank_order(allv, alli)[:, :k]
    return (torch.gather(alli, 1, sel), torch.gather(allv, 1, sel),
            None if over is None else allp[..., -1].any(dim=1))


def sharded_retrieve_adaptive(mesh, shard_axes: tuple[str, ...], *, k: int,
                              n_docs_per_shard: int, p_floor: int = 1024,
                              gathered: bool = True):
    """Adaptive-budget wrapper: overflow becomes a larger-bucket RETRY.

    The static ``p_max`` of :func:`make_sharded_retrieve` truncates
    postings when a batch's Σ df exceeds it. This wrapper sizes the budget
    as power-of-two buckets starting at ``p_floor`` (one step per bucket,
    cached here): if the overflow flag fires, the batch re-runs at the
    next bucket until it fits or the bucket covers the shard's whole
    posting array (Σ df ≤ nnz, so that bucket cannot overflow on the
    posting budget). A call starts at the last bucket that fit, so steady
    traffic runs once a call.

    The retry is CAPPED: if the flag persists at the Σdf-covering bucket
    (a flag or metadata bug, not demand), the wrapper raises
    :class:`repro_torch.serve.errors.PlanOverflowError` carrying the
    attempted bucket trail instead of returning truncated scores.

    Returns ``retrieve(idx_arrays, q_tokens, q_weights) -> (ids [B, k],
    scores [B, k], p_max_used)``; ``retrieve.trail`` is the last call's
    bucket trail. The first bucket's step is built here, so every rank of
    the default group must call this (see :func:`make_sharded_retrieve`).
    """
    from .scoring import bucket_pow2

    cache: dict[int, object] = {}
    state = {"p": p_floor}    # last successful bucket — the steady state

    def step(p: int):
        fn = cache.get(p)
        if fn is None:
            fn = cache[p] = make_sharded_retrieve(
                mesh, shard_axes, p_max=p, k=k,
                n_docs_per_shard=n_docs_per_shard, return_overflow=True,
                gathered=gathered)
        return fn

    step(p_floor)

    def retrieve(idx_arrays, q_tokens, q_weights):
        nnz_pad = int(idx_arrays[1].shape[-1])
        cap = bucket_pow2(nnz_pad, floor=p_floor)
        p = min(state["p"], cap)
        attempted = retrieve.trail = []
        while True:
            ids, vals, over = step(p)(idx_arrays, q_tokens, q_weights)
            attempted.append(p)
            if not bool(torch.as_tensor(over).any()):
                state["p"] = p
                return ids, vals, p
            if p >= cap:
                from ..serve.errors import PlanOverflowError
                raise PlanOverflowError(
                    "posting-budget overflow persists at the Σdf-covering "
                    f"bucket: attempted p_max buckets {attempted} "
                    f"(cap {cap}, shard nnz_pad {nnz_pad}) — the overflow "
                    "flag at the cap indicates corrupt index metadata, "
                    "not query demand", attempted=attempted, cap=cap)
            p = min(p * 2, cap)

    retrieve.trail = []
    return retrieve


def _padded(a: np.ndarray, n: int, dtype) -> np.ndarray:
    """``a`` as ``dtype``, zero-padded to ``n`` entries."""
    a = np.asarray(a, dtype=dtype)
    if a.size == n:
        return a
    out = np.zeros(n, dtype=dtype)
    out[:a.size] = a
    return out


def stack_shard_arrays(shards, mesh, shard_axes: tuple[str, ...]):
    """Host → device: this rank's shard of the stacked index arrays.

    Every rank passes the same host list of ``BM25Index`` shards, one a
    position of ``shard_axes`` (row-major over them, in the mesh's order);
    the padded sizes (``nnz_pad``, ``ndoc_pad``) come from all of them,
    and each rank uploads ONLY its own shard, through the counted
    ``put_posting_arrays``, to the mesh's device. Returns the 6-tuple
    ``(indptr, doc_ids, scores, nonocc, offsets, counts)`` consumed by
    :func:`make_sharded_retrieve` — each a ``DTensor`` of a leading-dim-1
    local block, ``Shard(0)`` over ``shard_axes`` and ``Replicate()`` on
    the other mesh dims — plus the padded per-shard doc count. Padding
    postings point at doc 0 with score 0 (harmless); ``counts`` carries
    each shard's REAL doc count so the step masks the stacking padding of
    uneven shards instead of scoring phantom documents.
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ..sparse.block_csr import put_posting_arrays

    shard_axes = tuple(shard_axes)
    sizes = _mesh_sizes(mesh, shard_axes)
    if len(shards) != math.prod(sizes):
        raise ValueError(f"{len(shards)} shards for the {math.prod(sizes)} "
                         f"positions of the shard axes {shard_axes}")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh; only the mesh's "
                         "ranks hold a shard")
    names = tuple(mesh.mesh_dim_names)
    sid = 0
    for a, size in zip(shard_axes, sizes):
        sid = sid * size + int(coord[names.index(a)])
    s = shards[sid]
    nnz_pad = max(x.doc_ids.size for x in shards)
    ndoc_pad = max(x.doc_lens.size for x in shards)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    arrays = put_posting_arrays(
        np.asarray(s.indptr, dtype=np.int64),
        _padded(s.doc_ids, nnz_pad, np.int32),
        _padded(s.scores, nnz_pad, np.float32),
        np.asarray(s.nonoccurrence, dtype=np.float32),
        np.array([s.doc_offset], dtype=np.int32),
        np.array([s.doc_lens.size], dtype=np.int32), device=dev)
    placements = [Shard(0) if a in shard_axes else Replicate()
                  for a in names]
    return tuple(DTensor.from_local(t[None], mesh, placements,
                                    run_check=False)
                 for t in arrays), ndoc_pad
