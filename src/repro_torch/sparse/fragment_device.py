"""Device-side fragment planning and the pruned regime's device half.

The port's counterpart of ``repro.sparse.fragment_device``, as plain torch
ops on the index's device. :func:`build_fragment_table` computes the batch's
``[6, nf_pad]`` fragment table (and the default-document ids) straight from
the resident CSC ``indptr``/``doc_ids`` tensors of a
:class:`~repro_torch.sparse.block_csr.DeviceIndex`: the host reads no posting
array and uploads no descriptor. The table is byte-equal to the host
:func:`~repro_torch.sparse.block_csr.fragment_plan` (the tests hold it to
that and to the reference's jnp builder):

1. posting-run descriptors ``(start, len)`` from the resident ``indptr`` for
   the padded unique-token table (sentinel ``INT32_MAX`` rows: length 0);
2. the flat posting stream over a static ``p_bucket`` budget (a
   ``searchsorted`` over the run-length cumsum), split into *segments*
   wherever the owning run or the document block of ``doc_ids[pos]``
   changes;
3. segments split into ≤``frag``-sized *fragments* (each position's
   segment start is the last segment boundary before it), compacted into
   ``nf_pad`` columns and STABLY sorted by block — the host plan's order,
   because a stable block sort commutes with per-segment fragmenting;
4. default-document ids from the unvisited blocks (the device
   ``default_doc_ids``).

Integer arithmetic stays int32 as in the reference (``torch.cumsum`` of
int32 would give int64, so every cumsum names its dtype).

The rest is the pruned regime's device half (``block_bounds_device``,
``estimate_survivors_device``, ``seed_fragment_mask``,
``prune_fragment_mask``, ``compact_fragment_table``): under
``plan="device"`` the bound product, ``auto``'s survivor estimate, the
threshold masks and the compaction read only resident tensors, so the
pruned regime also ships zero descriptor bytes per batch and an ``auto``
batch makes no host pass over the block-max rows.
"""

from __future__ import annotations

import numpy as np
import torch

from .block_csr import _BOUND_ABS, _BOUND_SLACK, bucket_pow2

_I32_BIG = int(np.iinfo(np.int32).max)
_I32 = torch.int32


def _shift_in(x: torch.Tensor, fill: int, *, right: bool) -> torch.Tensor:
    """``x`` moved one step (``right``: x[i-1] at i), ``fill`` at the edge."""
    edge = torch.full((1,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([edge, x[:-1]]) if right else torch.cat([x[1:], edge])


def build_fragment_table(uniq: torch.Tensor, indptr: torch.Tensor,
                         doc_ids_res: torch.Tensor, *, block_size: int,
                         frag: int, nf_pad: int, p_bucket: int, k: int,
                         n_docs: int):
    """Padded unique tokens × resident CSC -> fragment table, on device.

    ``uniq`` is the ``[U]`` int32 sorted unique-token table padded with
    ``INT32_MAX`` (``pack_query_batch``'s layout); ``indptr`` /
    ``doc_ids_res`` are the resident ``[V+1]`` / ``[1, nnz_pad]`` int32
    tensors. ``p_bucket`` must cover the batch's Σ df.

    Returns ``(desc [6, nf_pad] i32, def_ids [k] i32, nf, overflow)`` with
    ``nf`` an int and ``overflow`` a bool (``nf > nf_pad``). ``desc``
    equals the host ``fragment_plan(...).desc`` byte for byte and
    ``def_ids`` equals ``default_doc_ids`` on its visited blocks. On
    overflow the tables are not built (``None``): callers retry at a larger
    bucket.
    """
    dev = uniq.device
    u = uniq.shape[0]
    iota_p = torch.arange(p_bucket, dtype=_I32, device=dev)
    iota_f = torch.arange(nf_pad, dtype=_I32, device=dev)

    # 1. run descriptors from the resident indptr (sentinel rows: len 0)
    valid_u = uniq < _I32_BIG
    safe_u = torch.where(valid_u, uniq, 0).long()
    starts = indptr[safe_u]
    lens = torch.where(valid_u, indptr[safe_u + 1] - starts, 0)

    # 2. flat stream positions + (owner run, doc block) per position
    cum = torch.cumsum(lens, 0, dtype=_I32)
    total = cum[u - 1]
    owner = torch.searchsorted(cum, iota_p, right=True, out_int32=True)
    owner = torch.clamp(owner, max=u - 1).long()
    pos = starts[owner] + (iota_p - (cum[owner] - lens[owner]))
    ok = iota_p < total
    blk = torch.where(
        ok, torch.div(doc_ids_res[0, torch.where(ok, pos, 0).long()],
                      block_size, rounding_mode="floor"), _I32_BIG)
    owner = owner.to(_I32)

    # segment boundaries: owner or block changes (flat order, like host)
    new_seg = ok & ((iota_p == 0) | (owner != _shift_in(owner, -1,
                                                        right=True))
                    | (blk != _shift_in(blk, -1, right=True)))

    # 3. fragment boundaries: segment starts + frag multiples within one.
    # A position's segment start is the last segment boundary at or before
    # it — the reference's cummax over boundary positions, read here off
    # the sorted boundary list by a cumsum (torch's 1-D cummax is a slow
    # scan at 2^27 positions; chip_smoke.py times both)
    seg_at = torch.nonzero(new_seg).squeeze(1).to(_I32)
    seg_rank = torch.cumsum(new_seg, 0, dtype=_I32) - 1
    seg_start = (seg_at[seg_rank.clamp(min=0).long()] if seg_at.numel()
                 else iota_p)
    new_frag = ok & (new_seg | ((iota_p - seg_start) % frag == 0))
    # flat positions of the fragment starts, in order (nonzero is sorted)
    fpos = torch.nonzero(new_frag).squeeze(1)
    nf = int(fpos.numel())
    if nf > nf_pad:
        return None, None, nf, True
    fs = torch.full((nf_pad,), p_bucket, dtype=_I32, device=dev)
    fs[:nf] = fpos.to(_I32)
    freal = iota_f < nf
    safe_fs = torch.where(freal, fs, 0).long()
    nxt = torch.where(iota_f + 1 < nf, _shift_in(fs, p_bucket, right=False),
                      total)
    f_start = pos[safe_fs]
    f_valid = torch.where(freal, nxt - fs, 0)
    f_uniq = owner[safe_fs]
    f_blk = torch.where(freal, blk[safe_fs], _I32_BIG)

    # stable block sort of flat-order fragments == host's segment sort
    order = torch.sort(f_blk, stable=True).indices
    o_start, o_valid, o_uniq, o_blk, o_real = (
        f_start[order], f_valid[order], f_uniq[order], f_blk[order],
        freal[order])
    o_first = o_real & (o_blk != _shift_in(o_blk, -1, right=True))
    o_last = o_real & (o_blk != _shift_in(o_blk, -1, right=False))
    desc = torch.stack([
        torch.where(o_real, o_start, 0),
        o_valid,
        torch.where(o_real, o_uniq, 0),
        torch.where(o_real, o_blk, 0),
        o_first.to(_I32),
        o_last.to(_I32),
    ]).to(_I32)

    # 4. default doc ids from unvisited blocks (device default_doc_ids):
    # o_first flags are exactly the sorted visited-block set
    n_blocks = max(1, -(-n_docs // block_size))
    vis_blk = o_blk[o_first]
    nv = int(vis_blk.numel())
    vis = torch.full((nf_pad,), _I32_BIG, dtype=_I32, device=dev)
    vis[:nv] = vis_blk
    # j-th missing block via the miss-count trick (vis sorted ascending)
    miss_before = torch.where(iota_f < nv, vis - iota_f, n_blocks + 1)
    m = max(1, min(k, n_blocks))
    jj = torch.arange(m, dtype=_I32, device=dev)
    unvis = jj + torch.searchsorted(miss_before, jj + 1, out_int32=True)
    uvalid = unvis < n_blocks
    lo = torch.where(uvalid, unvis * block_size, 0)
    cnt = torch.where(uvalid, torch.clamp(lo + block_size, max=n_docs) - lo,
                      0)
    ccum = torch.cumsum(cnt, 0, dtype=_I32)
    tt = torch.arange(k, dtype=_I32, device=dev)
    bidx = torch.clamp(torch.searchsorted(ccum, tt, right=True,
                                          out_int32=True), max=m - 1).long()
    flat = lo[bidx] + (tt - (ccum[bidx] - cnt[bidx]))
    def_ids = torch.where(tt < ccum[m - 1], flat, n_docs).to(_I32)
    return desc, def_ids, nf, False


def plan_fragments_device(dindex, uniq_tab, *, sum_df: int, k: int,
                          block_size: int | None = None,
                          nf_bucket: int | None = None,
                          state: dict | None = None):
    """Build a batch's fragment table ON THE DEVICE, retrying on overflow.

    The device counterpart of ``fragment_plan`` + ``default_doc_ids`` +
    ``put_descriptor_array``: nothing O(Σ df) is read on the host and
    nothing is uploaded but the unique-token table (query data the batch
    ships anyway). ``sum_df`` (free, from host ``df``) sizes the flat-stream
    budget, so the posting dimension cannot overflow; the fragment bucket
    starts at an estimate (``2 · Σ df/frag`` + one per run) — or
    ``nf_bucket``, or the last bucket kept in ``state`` — and doubles on
    overflow up to the Σ df bucket, which always fits (every fragment
    carries a posting).

    Returns ``(desc [6, nf_pad] i32, def_ids [k] i32, nf_pad)``, both
    tensors on the index's device.
    """
    if dindex.csc_indptr is None or dindex.csc_doc_ids is None:
        from ..serve.errors import ResidencyError
        raise ResidencyError("device fragment planning needs a resident "
                             "CSC index (DeviceIndex built with "
                             "with_csc=True)")
    # fault-injection site ``plan.fragments_device``
    # (repro_torch.serve.faults): an armed overflow fault simulates
    # nf-bucket regrowth exhaustion
    import sys
    _f = sys.modules.get("repro_torch.serve.faults")
    if _f is not None and _f.ACTIVE:
        _f.fire("plan.fragments_device")
    block_size = block_size or dindex.block_size
    frag = dindex.frag
    uniq_dev = torch.as_tensor(np.asarray(uniq_tab, dtype=np.int32),
                               device=dindex.device)
    u = int(uniq_dev.shape[0])
    p_bucket = bucket_pow2(max(sum_df, 1), floor=8)
    cap = p_bucket                       # nf ≤ Σ df ≤ p_bucket, always fits
    if nf_bucket is not None:
        nf_pad = min(bucket_pow2(nf_bucket, floor=8), cap)
    else:
        est = 2 * (sum_df // frag) + u + 8
        nf_pad = min(bucket_pow2(est, floor=8), cap)
        if state is not None:
            nf_pad = min(max(nf_pad, state.get("nf", 8)), cap)
    while True:
        desc, def_ids, _nf, over = build_fragment_table(
            uniq_dev, dindex.csc_indptr, dindex.csc_doc_ids,
            block_size=block_size, frag=frag, nf_pad=nf_pad,
            p_bucket=p_bucket, k=k, n_docs=dindex.n_docs)
        if not over:
            break
        if nf_pad >= cap:
            raise RuntimeError(f"{_nf} fragments overflow the Σ df bucket "
                               f"{cap}: sum_df={sum_df} is too small")
        nf_pad = min(nf_pad * 2, cap)    # overflow -> retry, never truncate
    if state is not None:
        state["nf"] = nf_pad
    return desc, def_ids, nf_pad


# -- device half of the pruned regime ----------------------------------------


def _bound_rows(table: torch.Tensor, scale: torch.Tensor,
                uniq: torch.Tensor, *, quantized: bool) -> torch.Tensor:
    """Dequantized ``[U, nb_pad]`` f32 bound rows of the batch's tokens:
    ``BlockMaxTable.rows`` on the resident table (u8 codes times the
    per-token scale in f32, as the host multiplies them)."""
    safe = torch.clamp(uniq.long(), 0, table.shape[0] - 1)
    rows = table[safe].to(torch.float32)
    return rows * scale[safe][:, None] if quantized else rows


def _bounds(rows: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    ub = rows.double().T @ weights.double()              # [nb_pad, B]
    return (ub * (1.0 + _BOUND_SLACK) + _BOUND_ABS).to(torch.float32)


def block_bounds_device(table: torch.Tensor, scale: torch.Tensor,
                        uniq: torch.Tensor, weights: torch.Tensor, *,
                        quantized: bool) -> torch.Tensor:
    """Device ``block_csr.block_upper_bounds``: ``[nb_pad, B]`` float32.

    ``table`` is the resident ``[V, nb_pad]`` block-max tensor (u8 codes
    when ``quantized``, dequantized against the ``[V]`` per-token ``scale``
    in f32 as the host does); ``uniq``/``weights`` are the batch's packed
    query operands (sentinel rows carry zero weight). The product is taken
    in float64 and slack-inflated there, then cast to float32, as the host
    version does: so the bound never depends on a TF32 setting, whose
    ~1e-3 relative error is as large as the slack.
    """
    return _bounds(_bound_rows(table, scale, uniq, quantized=quantized),
                   weights)


# the per-query lower bounds' transient, [query tokens, query columns,
# nb_pad] f32, is cut into chunks of query columns of at most this many
# elements: 256 MB
LB_CHUNK_ELEMS = 1 << 26


def estimate_survivors_device(table: torch.Tensor, scale: torch.Tensor,
                              uniq: torch.Tensor, weights: torch.Tensor, *,
                              quantized: bool, k: int,
                              b_true: int | None = None
                              ) -> tuple[float, torch.Tensor]:
    """Device ``block_csr.estimate_prune_survivors`` on the resident table.

    The same function as the host's: ``ub`` is :func:`block_bounds_device`
    with the pow2 padding columns past ``b_true`` set to ``-inf``; the
    visited blocks are those whose bound beats ``2 · _BOUND_ABS`` for some
    real query; a query's lower bound on a block is its best single-term
    score ``max_u rows[u, b] · w[u, q]``, each product and max in f32 as
    the host takes them (so bit-identical); ``τ̂[q]`` is the
    ``min(k, nv)``-th largest lower bound over the visited blocks; the
    fraction counts the visited blocks whose bound reaches ``τ̂`` for any
    query. Returns 1.0 when there is no real query or no visited block.

    The lower bounds read only each query's own token rows (the rows of
    nonzero weight; every other row's product is ``+0.0``, which a
    non-negative maximum already covers), in chunks of query columns of at
    most :data:`LB_CHUNK_ELEMS` elements. Two host syncs: the widest
    query's token count, and the two counts of the fraction.

    Returns ``(survivor_frac, ub [nb_pad, B] f32)``, ``ub`` on the table's
    device, for the pruned regime to reuse.
    """
    rows = _bound_rows(table, scale, uniq, quantized=quantized)
    ub = _bounds(rows, weights)
    b = weights.shape[1]
    b_true = b if b_true is None else min(b_true, b)
    ub[:, b_true:] = -torch.inf
    if b_true == 0:
        return 1.0, ub
    visited = ub[:, :b_true].amax(1) > 2.0 * _BOUND_ABS    # [nb_pad]
    nv = visited.sum()
    w = weights[:, :b_true]
    nz = w != 0
    width = max(int(nz.sum(0).max()), 1)
    # each query's token rows first, in row order
    at = torch.sort((~nz).to(torch.int8), dim=0, stable=True
                    ).indices[:width]                      # [W, b_true]
    w_at = torch.gather(w, 0, at)
    nb = rows.shape[1]
    lb = torch.empty((b_true, nb), dtype=torch.float32, device=rows.device)
    step = max(1, LB_CHUNK_ELEMS // (width * nb))
    for c in range(0, b_true, step):
        prod = rows[at[:, c:c + step]]                     # [W, c, nb]
        prod.mul_(w_at[:, c:c + step, None])
        lb[c:c + step] = prod.amax(0)
    lb = torch.where(visited[None, :], lb, -torch.inf)
    # the kb-th largest over the visited blocks: the unvisited ones are
    # -inf and rank last (every lower bound is >= 0)
    top = torch.topk(lb, min(k, nb), dim=1).values         # [b_true, .]
    kb = torch.clamp(torch.clamp(nv, max=k) - 1, min=0)
    tau_hat = top.gather(1, kb.expand(b_true, 1))          # [b_true, 1]
    surv = visited & (ub[:, :b_true] >= tau_hat.T).any(1)
    n_vis, n_surv = torch.stack([nv, surv.sum()]).tolist()
    if n_vis == 0:
        return 1.0, ub
    return n_surv / n_vis, ub


def compact_fragment_table(desc: torch.Tensor, keep: torch.Tensor
                           ) -> tuple[torch.Tensor, int]:
    """Stable-partition a ``[6, nf_pad]`` table to the kept columns.

    Surviving fragments keep their relative order (a stable sort on the
    drop flag), so block grouping and first/last flags stay valid as long
    as ``keep`` is block-uniform. Dropped columns become all-zero padding
    at the tail. Returns ``(compacted [6, nf_pad], n_kept)``.
    """
    order = torch.sort((~keep).to(torch.int8), stable=True).indices
    out = torch.where(keep[order][None, :], desc[:, order], 0)
    return out, int(keep.sum())


def _visited_blocks(desc: torch.Tensor, nb: int) -> torch.Tensor:
    """``[nb]`` bool: blocks owning at least one real fragment."""
    real = desc[1] > 0
    vis = torch.zeros(nb, dtype=torch.bool, device=desc.device)
    vis[desc[3][real].long()] = True
    return vis


def seed_fragment_mask(desc: torch.Tensor, ub: torch.Tensor, *,
                       n_seed: int) -> torch.Tensor:
    """Fragments of each query's ``n_seed`` highest-bound visited blocks.

    Device ``block_csr.select_seed_blocks``: per query the visited blocks
    with the highest bounds, unioned across the batch; ties at a query's
    ``n_seed``-th bound admit extra blocks. All fragments of a block share
    its bound row, so the reference's per-fragment scatter-max is the
    bound row of each visited block (floored at the float minimum, as the
    reference's initial value floors it). Returns a block-uniform mask.
    """
    blk = desc[3].long()
    real = desc[1] > 0
    neg = torch.finfo(ub.dtype).min
    vis = _visited_blocks(desc, ub.shape[0])
    blk_score = torch.where(vis[:, None], ub.clamp(min=neg),
                            torch.full((), neg, dtype=ub.dtype,
                                       device=ub.device))    # [nb_pad, B]
    kth = torch.topk(blk_score.T, min(n_seed, ub.shape[0]),
                     dim=1).values[:, -1]                    # [B]
    kth = torch.clamp(kth, min=neg / 2)  # no-visited/padding query: none
    # the zero-bound floor keeps an all-tied trivial column (a real empty
    # query: every block bounds at the additive slack) from seeding the
    # whole table
    live = blk_score > 2.0 * _BOUND_ABS
    block_keep = ((blk_score >= kth[None, :]) & live).any(dim=1)
    return real & block_keep[blk]


def prune_fragment_mask(desc: torch.Tensor, ub: torch.Tensor,
                        tau: torch.Tensor) -> torch.Tensor:
    """Survivors of the threshold test: blocks some query can still win.

    ``tau`` is the ``[B]`` per-query threshold (the seed board's k-th row:
    a real document's full score, so a certified lower bound on each final
    k-th score). A fragment survives iff ANY query's bound on its block
    reaches its threshold; the test reads only the block, so the mask is
    block-uniform.
    """
    block_keep = (ub >= tau[None, :]).any(dim=1)
    return (desc[1] > 0) & block_keep[desc[3].long()]
