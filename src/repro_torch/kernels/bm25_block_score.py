"""K2: fused full-scan score → per-block top-k (the O(nnz) regime), and
K6: the same scan's dense per-block scores.

Ports of ``repro.kernels.bm25_block_score.bm25_block_score_topk`` and
``bm25_block_score``. Both CUDA kernels are in ``csrc/bm25_block_score.cu``
(its header note gives the design and the bound); this module holds their
wrappers, their plain torch twins and their launch counters.

Contract, per document block ``i`` and query column ``b``: each posting of
the block whose token is in the sorted unique table ``uniq`` (row ``u``)
adds ``fl(score · weights[u, b])`` to its document's row, in posting
order; rows of documents ``≥ n_docs`` are set to the float minimum; the
output lists the block's best ``k`` rows per column in (score desc, row
asc) order as values ``[nb, k, B]`` and block-local rows ``[nb, k, B]``.
K6 returns the sums themselves, ``[nb, block_size, B]``, padding rows
included and unmasked (the reference's dense kernel masks nothing).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.retrieval import rank_order
from . import _build
from .meta import MetaOp

LAUNCHES = _build.LaunchCounter("bm25_block_score_topk")
LAUNCHES_DENSE = _build.LaunchCounter("bm25_block_score")
LAUNCHES_DENSE_BF16 = _build.LaunchCounter("bm25_block_score_bf16")

_ROWS_PER_STEP = 1 << 18       # twin: accumulator rows / postings a step


def _check_operands(token_ids, local_doc, scores, uniq_tokens, weights,
                    block_size: int, k: int | None = None,
                    score_dtype=torch.float32) -> None:
    nb, p = token_ids.shape
    u, _b = weights.shape
    for name, t, dt, shape in (("token_ids", token_ids, torch.int32, (nb, p)),
                               ("local_doc", local_doc, torch.int32, (nb, p)),
                               ("scores", scores, score_dtype, (nb, p)),
                               ("uniq_tokens", uniq_tokens, torch.int32, (u,)),
                               ("weights", weights, score_dtype, None)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != token_ids.device:
            raise ValueError(f"{name} is on {t.device}, token_ids on "
                             f"{token_ids.device}")
    if block_size < 1:
        raise ValueError(f"block_size must be positive, got {block_size}")
    if k is not None and not 1 <= k <= block_size:
        raise ValueError(f"need 1 <= k <= block_size, got k={k}, "
                         f"block_size={block_size}")


def block_accumulate(token_ids, local_doc, scores, uniq_tokens, weights,
                     *, block_size: int) -> torch.Tensor:
    """``[g, P]`` postings of ``g`` blocks (token-sorted or in any order)
    -> their ``[g, block_size, B]`` sums.

    Each posting whose token is in the sorted table ``uniq_tokens`` (row
    ``u``) adds ``fl(score · weights[u, b])`` to its row ``local_doc`` of
    its block, with ``index_add_``. On the CPU ``index_add_`` adds source
    rows serially in index order, so each element sums its postings in
    posting order — the order of the walk that K2, K4 and K6 share
    (``csrc/block_walk.cuh``) — and equals them bit for bit. On a
    CUDA tensor ``index_add_`` uses atomics: then it agrees only to
    rounding. Matched postings are added ``_ROWS_PER_STEP`` at a time to
    bound memory.
    """
    g, p = token_ids.shape
    b = weights.shape[1]
    dev = weights.device
    tok = token_ids.reshape(-1)
    idx = torch.searchsorted(uniq_tokens, tok).clamp_(
        max=uniq_tokens.numel() - 1)
    loc = local_doc.reshape(-1)
    hit = torch.nonzero((uniq_tokens[idx] == tok) & (loc >= 0)
                        & (loc < block_size)).squeeze(1)
    dst = torch.div(hit, p, rounding_mode="floor") * block_size + loc[hit]
    src_sc = scores.reshape(-1)[hit]
    src_u = idx[hit]
    acc = torch.zeros((g * block_size, b), dtype=torch.float32, device=dev)
    for lo in range(0, hit.numel(), _ROWS_PER_STEP):
        hi = lo + _ROWS_PER_STEP
        acc.index_add_(0, dst[lo:hi],
                       src_sc[lo:hi][:, None] * weights[src_u[lo:hi]])
    return acc.view(g, block_size, b)


def bm25_block_score_topk_plain(token_ids, local_doc, scores, uniq_tokens,
                                weights, *, block_size: int, k: int,
                                n_docs: int
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain torch twin (same operands, same result).

    The sums are :func:`block_accumulate`'s (bitwise the kernel's on the
    CPU); rows of documents ``≥ n_docs`` take the float minimum and each
    column is ranked by (score desc, row asc) with :func:`rank_order`.
    Blocks are processed ``_ROWS_PER_STEP`` accumulator rows at a time to
    bound memory.
    """
    nb, _p = token_ids.shape
    _u, b = weights.shape
    dev = weights.device
    neg = torch.finfo(torch.float32).min
    out_v = torch.empty((nb, k, b), dtype=torch.float32, device=dev)
    out_i = torch.empty((nb, k, b), dtype=torch.int32, device=dev)
    step = max(1, _ROWS_PER_STEP // block_size)
    rows = torch.arange(block_size, device=dev)
    for g0 in range(0, nb, step):
        g1 = min(nb, g0 + step)
        acc = block_accumulate(token_ids[g0:g1], local_doc[g0:g1],
                               scores[g0:g1], uniq_tokens, weights,
                               block_size=block_size)
        gdoc = (torch.arange(g0, g1, device=dev)[:, None] * block_size
                + rows[None, :])
        acc[gdoc >= n_docs] = neg
        vals = acc.permute(0, 2, 1)                       # [g, B, bs]
        order = rank_order(vals, rows.expand_as(vals))[..., :k]
        out_v[g0:g1] = torch.gather(vals, 2, order).permute(0, 2, 1)
        out_i[g0:g1] = order.permute(0, 2, 1).to(torch.int32)
    return out_v, out_i


def _library(n_blocks: int):
    """The library of ``csrc/bm25_block_score.cu`` with its C signatures
    declared. Raises ``ValueError`` on a grid the kernels cannot take."""
    if n_blocks > 65535:
        raise ValueError(f"{n_blocks} document blocks exceed the grid's "
                         "65535")
    lib = _build.load("bm25_block_score")
    if lib.bm25_block_score_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bm25_block_score_topk_launch.argtypes = [
            p, p, p, i, i, p, i, p, i, i, i, ctypes.c_longlong, p, p, p, p,
            p]
        lib.bm25_block_score_topk_launch.restype = ctypes.c_int
        lib.bm25_block_score_topk_scratch.argtypes = [i]
        lib.bm25_block_score_topk_scratch.restype = ctypes.c_int
        for f in (lib.bm25_block_score_launch,
                  lib.bm25_block_score_bf16_launch):
            f.argtypes = [p, p, p, i, i, p, i, p, i, i, p, p]
            f.restype = ctypes.c_int
        lib.bm25_block_score_dense_smem.argtypes = [i]
        lib.bm25_block_score_dense_smem.restype = ctypes.c_longlong
    return lib


def bm25_block_score_topk(token_ids, local_doc, scores, uniq_tokens,
                          weights, *, block_size: int, k: int, n_docs: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked postings × ``[U, B]`` query table → (values, local rows)
    ``[nb, k, B]``.

    A CPU tensor runs the plain twin; a CUDA tensor launches the kernel
    (and raises if it cannot): there is no fall-back between the two. The
    kernel takes any ``block_size`` (it walks a block 512 rows at a time)
    and any number of table rows. A block of at most 512 rows selects its
    board in shared memory; a wider block merges into a device-memory
    board of ``[nb, B, k]`` values and rows.
    """
    _check_operands(token_ids, local_doc, scores, uniq_tokens, weights,
                    block_size, k)
    dev = token_ids.device
    if dev.type == "cpu":
        return bm25_block_score_topk_plain(
            token_ids, local_doc, scores, uniq_tokens, weights,
            block_size=block_size, k=k, n_docs=n_docs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    nb, p = token_ids.shape
    u, b = weights.shape
    lib = _library(nb)
    ops = [t.contiguous() for t in (token_ids, local_doc, scores,
                                    uniq_tokens, weights)]
    out_v = torch.empty((nb, k, b), dtype=torch.float32, device=dev)
    out_i = torch.empty((nb, k, b), dtype=torch.int32, device=dev)
    scratch = (None, None)      # the kernel selects its board in smem
    if lib.bm25_block_score_topk_scratch(block_size):
        scratch = (torch.empty((nb, b, k), dtype=torch.float32, device=dev),
                   torch.empty((nb, b, k), dtype=torch.int32, device=dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bm25_block_score_topk_launch(
            ops[0].data_ptr(), ops[1].data_ptr(), ops[2].data_ptr(), nb, p,
            ops[3].data_ptr(), u, ops[4].data_ptr(), b, block_size, k,
            n_docs, out_v.data_ptr(), out_i.data_ptr(),
            *(None if t is None else t.data_ptr() for t in scratch), stream)
    _build.check(err, "bm25_block_score_topk")
    LAUNCHES.add()
    return out_v, out_i


def _dense_fake(token_ids, local_doc, scores, uniq_tokens, weights,
                block_size: int):
    return weights.new_empty((token_ids.shape[0], block_size,
                              weights.shape[1]))


def dense_cost(tok_shape, loc_shape, sc_shape, uniq_shape, w_shape,
               block_size: int) -> tuple[float, float]:
    """K6's (operations, bytes) a call for the dry run, bounded by shapes:
    every slot's token and row (8 bytes) and score read once, the table
    and the weights read once, the ``[nb, block_size, B]`` output written
    once; ``2 · B`` operations a matched slot, counted for every slot
    (``2 · nb · P · B``), since every slot may match. A score, a weight
    and an output element take the weights' ``itemsize`` bytes where the
    trace gives it (2 in bf16), else 4."""
    nb, p = tok_shape
    u, b = w_shape
    e = getattr(w_shape, "itemsize", 4)
    return (2.0 * nb * p * b,
            (8.0 + e) * nb * p + 4.0 * u + e * u * b
            + e * nb * block_size * b)


DENSE_META = MetaOp(
    "bm25_block_score",
    "(Tensor token_ids, Tensor local_doc, Tensor scores, Tensor uniq_tokens,"
    " Tensor weights, int block_size) -> Tensor", _dense_fake, dense_cost,
    compute_dtype="float32")


def bm25_block_score(token_ids, local_doc, scores, uniq_tokens, weights, *,
                     block_size: int) -> torch.Tensor:
    """K6: blocked postings × ``[U, B]`` query table → dense
    ``[nb, block_size, B]`` sums (no masking of padding rows), in the
    weights' dtype, as the reference's kernel gives them.

    The scores and the weights are both float32 or both bfloat16. The
    bf16 instantiation reads them widened exactly to f32, forms each
    product and sum in f32 in the f32 kernel's order and rounds once to
    bf16 at the store: bitwise ``bf16(K6_f32(widen(scores),
    widen(weights)))``, which is also its twin. A bf16 call never goes
    through the f32 kernel.

    A CPU tensor runs the plain twin, :func:`block_accumulate` (bitwise the
    kernel's sums); a CUDA tensor launches the kernel (and raises if it
    cannot): there is no fall-back between the two. A ``meta`` tensor (a
    trace) runs neither: :data:`DENSE_META` gives the output's shape.
    Postings may come in any order within a block; blocks whose tokens
    ascend (the layout ``block_postings_from_coo`` builds) take the
    kernel's fast path, which reads only the postings the table matches.
    The table may have any number of rows: the kernel searches it 2,048
    rows at a time.
    """
    dt = weights.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weights must be torch.float32 or torch.bfloat16, "
                        f"got {dt}")
    _check_operands(token_ids, local_doc, scores, uniq_tokens, weights,
                    block_size, score_dtype=dt)
    dev = token_ids.device
    if dev.type == "cpu":
        return block_accumulate(token_ids, local_doc, scores.float(),
                                uniq_tokens, weights.float(),
                                block_size=block_size).to(dt)
    if dev.type == "meta":
        return DENSE_META(token_ids, local_doc, scores, uniq_tokens, weights,
                          block_size)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    nb, p = token_ids.shape
    u, b = weights.shape
    lib = _library(nb)
    # the kernel's static shared memory sits beside the dynamic
    if lib.bm25_block_score_dense_smem(block_size) > _build.SMEM_LIMIT - 1024:
        raise ValueError(f"block_size={block_size} does not fit a CTA's "
                         "shared memory")
    ops = [t.contiguous() for t in (token_ids, local_doc, scores,
                                    uniq_tokens, weights)]
    out = torch.empty((nb, block_size, b), dtype=dt, device=dev)
    launch = (lib.bm25_block_score_bf16_launch if dt == torch.bfloat16
              else lib.bm25_block_score_launch)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            ops[0].data_ptr(), ops[1].data_ptr(), ops[2].data_ptr(), nb, p,
            ops[3].data_ptr(), u, ops[4].data_ptr(), b, block_size,
            out.data_ptr(), stream)
    _build.check(err, "bm25_block_score")
    (LAUNCHES_DENSE_BF16 if dt == torch.bfloat16 else LAUNCHES_DENSE).add()
    return out
