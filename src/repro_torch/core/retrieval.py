"""Retrieval planner, query sanitizer, top-k helpers and the default splice.

The port's counterpart of ``repro.core.retrieval``: the numpy half
(planner, sanitizer, default-document ids, host top-k and merges) is
copied; :func:`splice_default_docs` is torch. The sharded ``shard_map``
step belongs to the multi-device slice.

**The tie rule.** Every board the port returns is ordered by score
descending, then document id ascending (:func:`rank_order`). The
reference's sequential fold orders equal scores by schedule; the port's
kernels run blocks in parallel, so it pins one total order instead and
every kernel, twin and merge follows it.
"""

from __future__ import annotations

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
