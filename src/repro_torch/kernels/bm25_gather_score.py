"""K1, K3 and K4: the gathered BM25 kernels, score → top-k.

Ports of ``repro.kernels.bm25_gather_score``:

* ``bm25_resident_score_topk`` (K1, the gathered regime) and
  ``bm25_resident_score_topk_pruned`` (K3, the pruned regime: K1 plus the
  block-max skip) walk fragment descriptors over the resident index; their
  CUDA kernels are ``csrc/bm25_resident.cu``;
* ``bm25_gather_score_topk`` (K4, the ladder's host-gather rung) scores
  host-gathered candidate chunks; its CUDA kernel is
  ``csrc/bm25_gather_score.cu``.

Each source's header note gives the design and the bound; this module
holds the wrappers, plain torch twins and launch counters, and
:func:`span_ranges`, which cuts K1/K3's fragment table into the ranges of
whole spans that their persistent CTAs walk.

K1/K3 contract: ``desc`` is the ``[6, nf]`` int32 table of
``sparse.block_csr.fragment_plan`` (rows start, valid, uniq, block, first,
last; each block's fragments contiguous — a *span*). Every span's block
accumulator sums ``fl(score · weights[uniq, b])`` over its fragments'
postings in table order; documents ``≥ n_docs`` are padding. The result is
the ``[k, B]`` board over all visited blocks in (score desc, doc id asc)
order — values and global doc ids, id -1 where the value is the padding
float minimum. Blocks the batch never visits are absent: their documents
score raw 0 and the caller splices them in as defaults.

K4 contract: the operands are ``sparse.block_csr.GatheredPostings``;
chunk ``c``'s accumulator row ``r`` sums ``fl(score · weights[u, b])`` over
the chunk's postings with slot ``r`` whose token is row ``u`` of the sorted
unique table, in posting order; slots whose candidate is -1 are padding.
The result is each chunk's ``[k, B]`` board with global doc ids
(``candidates[c, slot]``), or with ``two_level`` the ``[k, B]`` board over
all chunks, both in (score desc, id asc) order.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.retrieval import rank_order
from . import _build
from .bm25_block_score import block_accumulate

LAUNCHES = _build.LaunchCounter("bm25_resident_score_topk")
LAUNCHES_PRUNED = _build.LaunchCounter("bm25_resident_score_topk_pruned")
LAUNCHES_GATHER = _build.LaunchCounter("bm25_gather_score_topk")

_CTAS = None                   # scoring CTAs a launch; None: one an SM
_GROUP = 64                    # query columns a CTA, two a lane
_POSTINGS_PER_STEP = 1 << 20   # twin: postings added per index_add_
_COLS_PER_STEP = 32            # twin: query columns sorted per step


def _check_operands(desc, weights, doc_ids_res, scores_res,
                    block_size: int, k: int) -> None:
    if desc.dim() != 2 or desc.shape[0] != 6:
        raise ValueError(f"desc must be [6, nf], got {tuple(desc.shape)}")
    if weights.dim() != 2:
        raise ValueError("weights must be [U, B]")
    if doc_ids_res.dim() != 2 or doc_ids_res.shape[0] != 1 \
            or doc_ids_res.shape != scores_res.shape:
        raise ValueError("resident arrays must both be [1, nnz_pad]")
    for name, t, dt in (("desc", desc, torch.int32),
                        ("weights", weights, torch.float32),
                        ("doc_ids_res", doc_ids_res, torch.int32),
                        ("scores_res", scores_res, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != weights.device:
            raise ValueError(f"{name} is on {t.device}, weights on "
                             f"{weights.device}")
    if not 1 <= k <= block_size:
        raise ValueError(f"need 1 <= k <= block_size, got k={k}, "
                         f"block_size={block_size}")


def _postings(start, lens):
    """Flatten fragments to their postings, in table order: ``(frag_of,
    pos)``, the owning fragment and resident position of each posting."""
    dev = start.device
    total = int(lens.sum())
    frag_of = torch.repeat_interleave(
        torch.arange(lens.numel(), device=dev), lens)
    within = torch.arange(total, device=dev) - torch.repeat_interleave(
        torch.cumsum(lens, 0) - lens, lens)
    return frag_of, start[frag_of] + within


def bm25_resident_score_topk_plain(desc, weights, doc_ids_res, scores_res,
                                   *, block_size: int, k: int, n_docs: int
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' plain torch twin (same operands, same board).

    The fragments' postings are flattened in table order and added with
    ``index_add_`` into one ``[n_spans · block_size, B]`` accumulator (a
    span's rows are its own). On the CPU ``index_add_`` adds serially in
    index order, which is the kernel's per-element order, so the twin on
    the CPU equals the kernel bit for bit; on a CUDA tensor it uses
    atomics and agrees to rounding. The board is one sort by
    (score desc, id asc) per column (:func:`rank_order`).
    """
    dev = weights.device
    b = weights.shape[1]
    neg = torch.finfo(torch.float32).min
    d = desc.to(torch.int64)
    start, valid, uidx, blk, first = d[0], d[1], d[2], d[3], d[4]
    span = torch.cumsum(first, 0) - 1
    span_blk = blk[first == 1]
    n_spans = int(span_blk.numel())
    out_v = torch.full((k, b), neg, dtype=torch.float32, device=dev)
    out_i = torch.full((k, b), -1, dtype=torch.int32, device=dev)
    if n_spans == 0:
        return out_v, out_i
    frag_of, at = _postings(start, valid.clamp(min=0))
    total = int(frag_of.numel())
    acc = torch.zeros((n_spans * block_size, b), dtype=torch.float32,
                      device=dev)
    for lo in range(0, total, _POSTINGS_PER_STEP):
        f = frag_of[lo:lo + _POSTINGS_PER_STEP]
        pos = at[lo:lo + _POSTINGS_PER_STEP]
        doc = doc_ids_res[0, pos].to(torch.int64)
        dst = span[f] * block_size + (doc - blk[f] * block_size)
        acc.index_add_(0, dst, scores_res[0, pos][:, None] * weights[uidx[f]])
    gid = (span_blk[:, None] * block_size
           + torch.arange(block_size, device=dev)[None, :]).reshape(-1)
    pad = gid >= n_docs
    acc[pad] = neg
    gid = torch.where(pad, -1, gid)
    kk = min(k, gid.numel())
    for c0 in range(0, b, _COLS_PER_STEP):
        c1 = c0 + _COLS_PER_STEP
        vals = acc[:, c0:c1].T                            # [bc, N]
        ids = gid.expand_as(vals)
        sel = rank_order(vals, ids)[:, :kk]
        out_v[:kk, c0:c1] = torch.gather(vals, 1, sel).T
        out_i[:kk, c0:c1] = torch.gather(ids, 1, sel).T.to(torch.int32)
    return out_v, out_i


def _fns(lib):
    """The library's launch functions, with their ctypes signatures."""
    f = lib.bm25_resident_topk_launch
    if f.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, i, p, i, p, i, p, p, i, i, ctypes.c_longlong, p, p,
                      p, p, p]
        f.restype = ctypes.c_int
        g = lib.bm25_resident_pruned_launch
        g.argtypes = [p, i, p, i, p, i, p, p, p, i, i, ctypes.c_longlong, p,
                      p, p, p, p, p]
        g.restype = ctypes.c_int
    return f, lib.bm25_resident_pruned_launch


def span_ranges(desc: torch.Tensor, n_ranges: int) -> torch.Tensor:
    """Cut a fragment table into ``n_ranges`` ranges of whole spans with
    about equal postings, on ``desc``'s device (no host sync).

    Returns ``[n_ranges + 1]`` int32 fragment indices, non-decreasing:
    range ``g`` holds the spans whose leaders lie in ``[r[g], r[g + 1])``.
    Every ``r[g]`` is a span leader or ``nf`` (the table's width), so no
    range splits a span and the padding after the last span belongs to
    none. Range ``g`` starts at the first leader with at least
    ``total · g // n_ranges`` postings before it.
    """
    nf = desc.shape[1]
    dev = desc.device
    idx = torch.arange(nf + 1, device=dev)
    valid = desc[1].clamp(min=0).to(torch.int64)
    before = torch.cumsum(valid, 0) - valid       # postings before each
    # pos[j]: the j-th leader (nf past the last one; non-leaders write to
    # the spare slot nf, reset after)
    lead = desc[4] == 1
    pos = torch.full((nf + 1,), nf, dtype=torch.int64, device=dev)
    pos[torch.where(lead, torch.cumsum(lead, 0) - 1, nf)] = idx[:-1]
    pos[nf] = nf
    big = torch.full((1,), torch.iinfo(torch.int64).max, device=dev)
    key = torch.cat([before, big])[pos]           # ascending over leaders
    targets = valid.sum() * torch.arange(n_ranges, device=dev) // n_ranges
    return torch.cat([pos[torch.searchsorted(key, targets)],
                      idx[-1:]]).to(torch.int32)


def _launch_resident(lib, desc, weights, bounds, doc_ids_res, scores_res,
                     *, block_size: int, k: int, n_docs: int, n_ctas: int,
                     stream: int):
    """Launch K1 (``bounds`` None) or K3 from ``lib`` on ``stream``, with
    ``n_ctas`` scoring CTAs across the column groups of 64. Returns
    ``(values [k, B], ids [k, B], skips per CTA or None)``."""
    launch, launch_pruned = _fns(lib)
    dev = weights.device
    nf = desc.shape[1]
    b = weights.shape[1]
    n_groups = -(-b // _GROUP)
    n_ranges = max(1, min(nf, n_ctas // n_groups))
    if n_ranges > 65535:
        raise ValueError(f"{n_ranges} ranges exceed the grid's 65535")
    ranges = span_ranges(desc, n_ranges)
    ops = [t.contiguous() for t in (desc, weights, doc_ids_res, scores_res)]
    board_v = torch.empty((n_ranges, b, k), dtype=torch.float32, device=dev)
    board_g = torch.empty((n_ranges, b, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((k, b), dtype=torch.float32, device=dev)
    out_g = torch.empty((k, b), dtype=torch.int32, device=dev)
    head = (ops[0].data_ptr(), nf, ranges.data_ptr(), n_ranges,
            ops[1].data_ptr(), b)
    tail = (ops[2].data_ptr(), ops[3].data_ptr(), block_size, k, n_docs,
            board_v.data_ptr(), board_g.data_ptr())
    if bounds is None:
        skips = None
        err = launch(*head, *tail, out_v.data_ptr(), out_g.data_ptr(),
                     stream)
    else:
        bnd = bounds.contiguous()
        skips = torch.empty(n_ranges * n_groups, dtype=torch.int32,
                            device=dev)
        err = launch_pruned(*head, bnd.data_ptr(), *tail, skips.data_ptr(),
                            out_v.data_ptr(), out_g.data_ptr(), stream)
    _build.check(err, "bm25_resident_score_topk"
                 + ("" if bounds is None else "_pruned"))
    return out_v, out_g, skips


def _ctas(dev) -> int:
    """Scoring CTAs a launch: ``_CTAS``, or one a streaming multiprocessor
    (the kernel holds one CTA an SM)."""
    if _CTAS is not None:
        return _CTAS
    return torch.cuda.get_device_properties(dev).multi_processor_count


def bm25_resident_score_topk(desc, weights, doc_ids_res, scores_res, *,
                             block_size: int, frag: int, k: int,
                             n_docs: int, double_buffer: bool = True
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fragment descriptors × resident index → board (values, ids) ``[k, B]``.

    ``doc_ids_res``/``scores_res`` are the ``[1, nnz_pad]`` resident CSC
    arrays of a ``sparse.block_csr.DeviceIndex`` (padded by a ``frag``
    tail, so ``start + valid`` never leaves them). ``double_buffer`` is
    accepted for signature parity with the reference: its two TPU
    schedules are bit-identical by contract, and one CUDA kernel serves
    both. A CPU tensor runs the plain twin; a CUDA tensor launches the
    kernels (and raises if it cannot).
    """
    del double_buffer
    _check_operands(desc, weights, doc_ids_res, scores_res, block_size, k)
    if frag < 1:
        raise ValueError(f"frag must be positive, got {frag}")
    dev = weights.device
    if dev.type == "cpu":
        return bm25_resident_score_topk_plain(
            desc, weights, doc_ids_res, scores_res, block_size=block_size,
            k=k, n_docs=n_docs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        out_v, out_g, _ = _launch_resident(
            _build.load("bm25_resident"), desc, weights, None, doc_ids_res,
            scores_res, block_size=block_size, k=k, n_docs=n_docs,
            n_ctas=_ctas(dev), stream=stream)
    LAUNCHES.add()
    return out_v, out_g


def bm25_resident_score_topk_pruned_plain(desc, weights, bounds,
                                          doc_ids_res, scores_res, *,
                                          block_size: int, k: int,
                                          n_docs: int):
    """K3's plain torch twin: the reference's sequential schedule.

    One board over the whole B; spans in table order; before each span the
    live test of its block's bound row against the board's row ``k - 1``
    (``any(bounds[block] >= board[k-1])``, the reference kernel's test of
    each fragment, whose bound row is its block's); a live span's postings
    are added with ``index_add_`` (serial in table order on the CPU, so
    each element sums as the kernels sum it) and the span's block is
    folded into the board, a zero accumulator too when it was dead, as
    the reference folds it.

    Returns ``(values [k, B], ids [k, B], skipped)``, ``skipped`` a 0-d
    int64 tensor counting the real fragments that were not live. In every
    column whose bounds are finite the board equals the kernel's and K1's
    on the same table; padding columns (-inf bounds) may differ.
    """
    dev = weights.device
    b = weights.shape[1]
    neg = torch.finfo(torch.float32).min
    d = desc.to(torch.int64)
    start, valid, uidx, blk, first = d[0], d[1], d[2], d[3], d[4]
    board_v = torch.full((k, b), neg, dtype=torch.float32, device=dev)
    board_i = torch.full((k, b), -1, dtype=torch.int64, device=dev)
    skipped = torch.zeros((), dtype=torch.int64, device=dev)
    leaders = torch.nonzero(first == 1).squeeze(1).tolist()
    rows = torch.arange(block_size, device=dev)
    for s, a in enumerate(leaders):
        e = leaders[s + 1] if s + 1 < len(leaders) else int(d.shape[1])
        live = bool((bounds[blk[a]] >= board_v[k - 1]).any())
        if not live:
            skipped += (valid[a:e] > 0).sum()
        frag_of, pos = _postings(start[a:e], valid[a:e].clamp(min=0) * live)
        base = int(blk[a]) * block_size
        acc = torch.zeros((block_size, b), dtype=torch.float32, device=dev)
        acc.index_add_(0, doc_ids_res[0, pos].to(torch.int64) - base,
                       scores_res[0, pos][:, None]
                       * weights[uidx[a:e][frag_of]])
        gid = base + rows
        pad = gid >= n_docs
        acc[pad] = neg
        gid = torch.where(pad, -1, gid)
        vals = torch.cat([board_v, acc]).T                   # [B, k + bs]
        ids = torch.cat([board_i, gid[:, None].expand(block_size, b)]).T
        sel = rank_order(vals, ids)[:, :k]
        board_v = torch.gather(vals, 1, sel).T.contiguous()
        board_i = torch.gather(ids, 1, sel).T.contiguous()
    return board_v, board_i.to(torch.int32), skipped


def bm25_resident_score_topk_pruned(desc, weights, bounds, doc_ids_res,
                                    scores_res, *, block_size: int,
                                    frag: int, k: int, n_docs: int):
    """K3: K1's board with the block-max skip, plus the skip count.

    ``bounds`` is the ``[nb, B]`` float32 table of each block's upper
    bound per query (slack-inflated; -inf in padding columns), with a row
    for every block the table names; a span reads its block's row. The
    board equals K1's on the same table in every column whose bounds are
    finite: a span is skipped only when no column of a CTA's group of 64
    columns can still reach that CTA's running board. Returns ``(values
    [k, B], ids [k, B], skipped)``: ``skipped`` is a 0-d int64 tensor, the
    real fragments skipped, averaged over the column groups of 64 that the
    kernel decides apart (the twin decides over the whole B). With one
    column group (B ≤ 64) and one CTA (``_CTAS`` = 1) the kernel walks the
    table in order, as the twin does, and the counts are equal. A CPU
    tensor runs the twin; a CUDA tensor launches the kernels (and raises
    if it cannot).
    """
    _check_operands(desc, weights, doc_ids_res, scores_res, block_size, k)
    nf = desc.shape[1]
    b = weights.shape[1]
    if bounds.dim() != 2 or bounds.shape[1] != b \
            or bounds.dtype != torch.float32:
        raise ValueError(f"bounds must be float32 [nb, {b}], got "
                         f"{bounds.dtype} {tuple(bounds.shape)}")
    if bounds.device != weights.device:
        raise ValueError(f"bounds is on {bounds.device}, weights on "
                         f"{weights.device}")
    if nf:
        lo, hi = (int(x) for x in torch.aminmax(desc[3]))
        if lo < 0 or hi >= bounds.shape[0]:
            raise ValueError(f"desc names block {hi if lo >= 0 else lo}, "
                             f"outside the {bounds.shape[0]} rows of bounds")
    if frag < 1:
        raise ValueError(f"frag must be positive, got {frag}")
    dev = weights.device
    if dev.type == "cpu":
        return bm25_resident_score_topk_pruned_plain(
            desc, weights, bounds, doc_ids_res, scores_res,
            block_size=block_size, k=k, n_docs=n_docs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        out_v, out_g, skips = _launch_resident(
            _build.load("bm25_resident"), desc, weights, bounds, doc_ids_res,
            scores_res, block_size=block_size, k=k, n_docs=n_docs,
            n_ctas=_ctas(dev), stream=stream)
    LAUNCHES_PRUNED.add()
    return out_v, out_g, skips.sum(dtype=torch.int64) // -(-b // _GROUP)


# -- K4: host-gathered candidate chunks ---------------------------------------

_CHUNK_ROWS_PER_STEP = 1 << 18  # twin: accumulator rows a step


def _check_gather_operands(token_ids, slot_ids, scores, uniq_tokens,
                           weights, candidates, acc_block: int,
                           k: int) -> None:
    if token_ids.dim() != 2:
        raise ValueError("token_ids must be [n_chunks, p_pad]")
    nc, p = token_ids.shape
    if weights.dim() != 2:
        raise ValueError("weights must be [U, B]")
    u = weights.shape[0]
    for name, t, dt, shape in (
            ("token_ids", token_ids, torch.int32, (nc, p)),
            ("slot_ids", slot_ids, torch.int32, (nc, p)),
            ("scores", scores, torch.float32, (nc, p)),
            ("uniq_tokens", uniq_tokens, torch.int32, (u,)),
            ("weights", weights, torch.float32, None),
            ("candidates", candidates, torch.int32, (nc, acc_block))):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != token_ids.device:
            raise ValueError(f"{name} is on {t.device}, token_ids on "
                             f"{token_ids.device}")
    if not 1 <= k <= acc_block:
        raise ValueError(f"need 1 <= k <= acc_block, got k={k}, "
                         f"acc_block={acc_block}")


def gather_fold_fits(n_chunks: int) -> bool:
    """Can the two-level fold merge ``n_chunks`` boards in one launch?
    (One warp keeps a 4-byte head per board in shared memory.)"""
    return 4 * n_chunks <= _build.SMEM_LIMIT


def bm25_gather_score_topk_plain(token_ids, slot_ids, scores, uniq_tokens,
                                 weights, candidates, *, acc_block: int,
                                 k: int, two_level: bool = False
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's plain torch twin: the reference's schedule.

    Each chunk's sums are ``block_accumulate``'s (``index_add_`` in
    posting order, bitwise the kernel's on the CPU); padding slots take
    the float minimum; each column of a chunk is ranked by (score desc,
    candidate id asc) with :func:`rank_order` — the candidates are
    sorted, so that is slot order. ``two_level`` folds the chunk boards
    one after another into a running ``[k, B]`` board, as the reference's
    sequential grid does; the fold's board is the top-k of the union, so
    it equals the kernel's merge bit for bit.
    """
    nc = token_ids.shape[0]
    b = weights.shape[1]
    dev = weights.device
    neg = torch.finfo(torch.float32).min
    out_v = torch.empty((nc, k, b), dtype=torch.float32, device=dev)
    out_i = torch.empty((nc, k, b), dtype=torch.int32, device=dev)
    step = max(1, _CHUNK_ROWS_PER_STEP // acc_block)
    for g0 in range(0, nc, step):
        g1 = min(nc, g0 + step)
        acc = block_accumulate(token_ids[g0:g1], slot_ids[g0:g1],
                               scores[g0:g1], uniq_tokens, weights,
                               block_size=acc_block)
        cand = candidates[g0:g1]
        acc[cand < 0] = neg
        vals = acc.permute(0, 2, 1)                       # [g, B, slots]
        ids = cand[:, None, :].expand_as(vals)
        order = rank_order(vals, ids)[..., :k]
        out_v[g0:g1] = torch.gather(vals, 2, order).permute(0, 2, 1)
        out_i[g0:g1] = torch.gather(ids, 2, order).permute(0, 2, 1)
    if not two_level:
        return out_v, out_i
    board_v = torch.full((k, b), neg, dtype=torch.float32, device=dev)
    board_i = torch.full((k, b), -1, dtype=torch.int32, device=dev)
    for c in range(nc):
        vals = torch.cat([board_v, out_v[c]]).T           # [B, 2k]
        ids = torch.cat([board_i, out_i[c]]).T
        sel = rank_order(vals, ids)[:, :k]
        board_v = torch.gather(vals, 1, sel).T.contiguous()
        board_i = torch.gather(ids, 1, sel).T.contiguous()
    return board_v, board_i


def _gather_fns(lib):
    f = lib.bm25_gather_score_topk_launch
    if f.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, p, p, i, i, p, i, p, i, p, i, i, p, p, i, p, p, p,
                      p, p]
        f.restype = ctypes.c_int
        c = lib.bm25_gather_score_topk_scratch
        c.argtypes = [i]
        c.restype = ctypes.c_int
    return f


def bm25_gather_score_topk(token_ids, slot_ids, scores, uniq_tokens,
                           weights, candidates, *, acc_block: int, k: int,
                           two_level: bool = False
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: gathered candidate chunks × ``[U, B]`` query table → (values,
    GLOBAL doc ids).

    The operands are the ``GatheredPostings`` layout: ``[nc, p_pad]``
    token-sorted postings whose ``slot_ids`` index a ``[acc_block, B]``
    accumulator, and the ``[nc, acc_block]`` candidate table (-1 = pad).
    ``two_level=False`` returns the per-chunk boards ``[nc, k, B]``;
    ``two_level=True`` their fold into one ``[k, B]`` board (the kernel
    merges the chunk boards in the same launch function; see
    :func:`gather_fold_fits` for its limit). A CPU tensor runs the plain
    twin; a CUDA tensor launches the kernel (and raises if it cannot). The
    kernel takes any ``acc_block`` (512 rows at a time) and any number of
    table rows. A chunk of at most 512 slots selects its board in shared
    memory; a wider one merges into an ``[nc, B, k]`` device-memory
    board.
    """
    _check_gather_operands(token_ids, slot_ids, scores, uniq_tokens,
                           weights, candidates, acc_block, k)
    dev = token_ids.device
    if dev.type == "cpu":
        return bm25_gather_score_topk_plain(
            token_ids, slot_ids, scores, uniq_tokens, weights, candidates,
            acc_block=acc_block, k=k, two_level=two_level)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    nc, p = token_ids.shape
    u, b = weights.shape
    if nc > 65535:
        raise ValueError(f"{nc} chunks exceed the grid's 65535")
    if two_level and not gather_fold_fits(nc):
        raise ValueError(f"{nc} chunk boards do not fit the two-level "
                         "fold's shared memory; use two_level=False")
    lib = _build.load("bm25_gather_score")
    launch = _gather_fns(lib)
    ops = [t.contiguous() for t in (token_ids, slot_ids, scores,
                                    uniq_tokens, weights, candidates)]
    out_v = torch.empty((nc, k, b), dtype=torch.float32, device=dev)
    out_i = torch.empty((nc, k, b), dtype=torch.int32, device=dev)
    fold_v = torch.empty((k, b), dtype=torch.float32, device=dev) \
        if two_level else out_v
    fold_i = torch.empty((k, b), dtype=torch.int32, device=dev) \
        if two_level else out_i
    scratch = (None, None)      # the kernel selects its board in smem
    if lib.bm25_gather_score_topk_scratch(acc_block):
        scratch = (torch.empty((nc, b, k), dtype=torch.float32, device=dev),
                   torch.empty((nc, b, k), dtype=torch.int32, device=dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(ops[0].data_ptr(), ops[1].data_ptr(), ops[2].data_ptr(),
                     nc, p, ops[3].data_ptr(), u, ops[4].data_ptr(), b,
                     ops[5].data_ptr(), acc_block, k, out_v.data_ptr(),
                     out_i.data_ptr(), int(two_level), fold_v.data_ptr(),
                     fold_i.data_ptr(),
                     *(None if t is None else t.data_ptr() for t in scratch),
                     stream)
    _build.check(err, "bm25_gather_score_topk")
    LAUNCHES_GATHER.add()
    return (fold_v, fold_i) if two_level else (out_v, out_i)
