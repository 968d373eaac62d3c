"""K1 and K3: resident gather → score → top-k over fragment descriptors.

Ports of ``repro.kernels.bm25_gather_score.bm25_resident_score_topk`` (K1,
the gathered regime) and ``bm25_resident_score_topk_pruned`` (K3, the
pruned regime: K1 plus the block-max skip). The CUDA kernels are
``csrc/bm25_resident.cu`` (its header note gives the design and the
bounds); this module holds their wrappers, plain torch twins and launch
counters.

Contract: ``desc`` is the ``[6, nf]`` int32 table of
``sparse.block_csr.fragment_plan`` (rows start, valid, uniq, block, first,
last; each block's fragments contiguous — a *span*). Every span's block
accumulator sums ``fl(score · weights[uniq, b])`` over its fragments'
postings in table order; documents ``≥ n_docs`` are padding. The result is
the ``[k, B]`` board over all visited blocks in (score desc, doc id asc)
order — values and global doc ids, id -1 where the value is the padding
float minimum. Blocks the batch never visits are absent: their documents
score raw 0 and the caller splices them in as defaults.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.retrieval import rank_order
from . import _build

LAUNCHES = _build.LaunchCounter("bm25_resident_score_topk")
LAUNCHES_PRUNED = _build.LaunchCounter("bm25_resident_score_topk_pruned")

_CTAS = 4096                   # scoring CTAs per launch, across B-tiles
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
        f.argtypes = [p, i, p, i, p, p, i, i, ctypes.c_longlong, i, i, i,
                      p, p, p, p, p]
        f.restype = ctypes.c_int
        g = lib.bm25_resident_pruned_launch
        g.argtypes = [p, i, p, i, p, p, p, i, i, ctypes.c_longlong, i, i,
                      i, p, p, p, p, p, p]
        g.restype = ctypes.c_int
        s = lib.bm25_resident_topk_smem
        s.argtypes = [i, i, i]
        s.restype = ctypes.c_longlong
    return f, lib.bm25_resident_pruned_launch


def _tiling(lib, nf: int, b: int, block_size: int, k: int):
    """``(bt, n_tiles, n_boards, per_cta)``: columns per B-tile (≤ 32,
    halved until the CTA's shared memory fits), B-tiles, CTAs per tile and
    fragments per CTA slice, for at most ``_CTAS`` CTAs."""
    bt = min(32, b)
    while bt > 1 and lib.bm25_resident_topk_smem(block_size, k, bt) \
            > _build.SMEM_LIMIT:
        bt //= 2
    if lib.bm25_resident_topk_smem(block_size, k, bt) > _build.SMEM_LIMIT:
        raise ValueError(f"block_size={block_size}, k={k} do not fit a "
                         "CTA's shared memory")
    n_tiles = -(-b // bt)
    n_boards = max(1, min(nf, _CTAS // n_tiles))
    per_cta = -(-nf // n_boards)
    return bt, n_tiles, -(-nf // per_cta), per_cta


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
    nf = desc.shape[1]
    b = weights.shape[1]
    lib = _build.load("bm25_resident")
    launch, _ = _fns(lib)
    bt, _, n_boards, per_cta = _tiling(lib, nf, b, block_size, k)
    desc_c, w_c = desc.contiguous(), weights.contiguous()
    doc_c, sc_c = doc_ids_res.contiguous(), scores_res.contiguous()
    board_v = torch.empty((n_boards, k, b), dtype=torch.float32, device=dev)
    board_g = torch.empty((n_boards, k, b), dtype=torch.int32, device=dev)
    out_v = torch.empty((k, b), dtype=torch.float32, device=dev)
    out_g = torch.empty((k, b), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(desc_c.data_ptr(), nf, w_c.data_ptr(), b,
                     doc_c.data_ptr(), sc_c.data_ptr(), block_size, k,
                     n_docs, n_boards, per_cta, bt, board_v.data_ptr(),
                     board_g.data_ptr(), out_v.data_ptr(), out_g.data_ptr(),
                     stream)
    _build.check(err, "bm25_resident_score_topk")
    LAUNCHES.n += 1
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
    finite: a span is skipped only when no column of a B-tile can still
    reach that tile's running board. Returns ``(values [k, B], ids [k, B],
    skipped)``: ``skipped`` is a 0-d int64 tensor, the real fragments
    skipped, averaged over the B-tiles of up to 32 columns that the kernel
    decides apart (the twin decides over the whole B). With one B-tile and
    one CTA (``_CTAS`` = 1) the kernel walks the table in order, as the
    twin does, and the counts are equal. A CPU tensor runs the twin; a CUDA
    tensor launches the kernels (and raises if it cannot).
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
    lib = _build.load("bm25_resident")
    _, launch = _fns(lib)
    bt, n_tiles, n_boards, per_cta = _tiling(lib, nf, b, block_size, k)
    desc_c, w_c, bnd_c = desc.contiguous(), weights.contiguous(), \
        bounds.contiguous()
    doc_c, sc_c = doc_ids_res.contiguous(), scores_res.contiguous()
    board_v = torch.empty((n_boards, k, b), dtype=torch.float32, device=dev)
    board_g = torch.empty((n_boards, k, b), dtype=torch.int32, device=dev)
    skips = torch.empty(n_boards * n_tiles, dtype=torch.int32, device=dev)
    out_v = torch.empty((k, b), dtype=torch.float32, device=dev)
    out_g = torch.empty((k, b), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(desc_c.data_ptr(), nf, w_c.data_ptr(), b,
                     bnd_c.data_ptr(), doc_c.data_ptr(), sc_c.data_ptr(),
                     block_size, k, n_docs, n_boards, per_cta, bt,
                     board_v.data_ptr(), board_g.data_ptr(),
                     skips.data_ptr(), out_v.data_ptr(), out_g.data_ptr(),
                     stream)
    _build.check(err, "bm25_resident_score_topk_pruned")
    LAUNCHES_PRUNED.n += 1
    return out_v, out_g, skips.sum(dtype=torch.int64) // n_tiles
