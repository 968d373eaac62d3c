"""K2: fused full-scan score → per-block top-k (the O(nnz) regime).

Port of ``repro.kernels.bm25_block_score.bm25_block_score_topk``. The
CUDA kernel is ``csrc/bm25_block_score.cu`` (its header note gives the
design and the bound); this module holds its wrapper, its plain torch
twin and its launch counter.

Contract, per document block ``i`` and query column ``b``: each posting of
the block whose token is in the sorted unique table ``uniq`` (row ``u``)
adds ``fl(score · weights[u, b])`` to its document's row, in posting
order; rows of documents ``≥ n_docs`` are set to the float minimum; the
output lists the block's best ``k`` rows per column in (score desc, row
asc) order as values ``[nb, k, B]`` and block-local rows ``[nb, k, B]``.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.retrieval import rank_order
from . import _build

LAUNCHES = _build.LaunchCounter("bm25_block_score_topk")

_ROWS_PER_STEP = 1 << 18       # twin: accumulator rows / postings a step


def _check_operands(token_ids, local_doc, scores, uniq_tokens, weights,
                    block_size: int, k: int) -> None:
    nb, p = token_ids.shape
    u, _b = weights.shape
    for name, t, dt, shape in (("token_ids", token_ids, torch.int32, (nb, p)),
                               ("local_doc", local_doc, torch.int32, (nb, p)),
                               ("scores", scores, torch.float32, (nb, p)),
                               ("uniq_tokens", uniq_tokens, torch.int32, (u,)),
                               ("weights", weights, torch.float32, None)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != token_ids.device:
            raise ValueError(f"{name} is on {t.device}, token_ids on "
                             f"{token_ids.device}")
    if not 1 <= k <= block_size:
        raise ValueError(f"need 1 <= k <= block_size, got k={k}, "
                         f"block_size={block_size}")


def bm25_block_score_topk_plain(token_ids, local_doc, scores, uniq_tokens,
                                weights, *, block_size: int, k: int,
                                n_docs: int
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain torch twin (same operands, same result).

    ``index_add_`` on the CPU adds source rows serially in index order, so
    each accumulator element sums its postings in posting order — the
    kernel's order — and the twin on the CPU equals the kernel bit for
    bit. On a CUDA tensor ``index_add_`` uses atomics: then the twin
    agrees only to rounding. Blocks are processed ``_ROWS_PER_STEP``
    accumulator rows (and matched postings) at a time to bound memory.
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
        tok = token_ids[g0:g1].reshape(-1)
        idx = torch.searchsorted(uniq_tokens, tok).clamp_(
            max=uniq_tokens.numel() - 1)
        hit = torch.nonzero(uniq_tokens[idx] == tok).squeeze(1)
        blk_of = torch.div(hit, token_ids.shape[1], rounding_mode="floor")
        dst = blk_of * block_size + local_doc[g0:g1].reshape(-1)[hit]
        src_sc = scores[g0:g1].reshape(-1)[hit]
        src_u = idx[hit]
        acc = torch.zeros(((g1 - g0) * block_size, b), dtype=torch.float32,
                          device=dev)
        for lo in range(0, hit.numel(), _ROWS_PER_STEP):
            hi = lo + _ROWS_PER_STEP
            acc.index_add_(0, dst[lo:hi],
                           src_sc[lo:hi][:, None] * weights[src_u[lo:hi]])
        acc = acc.view(g1 - g0, block_size, b)
        gdoc = (torch.arange(g0, g1, device=dev)[:, None] * block_size
                + rows[None, :])
        acc[gdoc >= n_docs] = neg
        vals = acc.permute(0, 2, 1)                       # [g, B, bs]
        order = rank_order(vals, rows.expand_as(vals))[..., :k]
        out_v[g0:g1] = torch.gather(vals, 2, order).permute(0, 2, 1)
        out_i[g0:g1] = order.permute(0, 2, 1).to(torch.int32)
    return out_v, out_i


def _fn(lib):
    f = lib.bm25_block_score_topk_launch
    if f.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, p, p, i, i, p, i, p, i, i, i, ctypes.c_longlong, p,
                      p, p]
        f.restype = ctypes.c_int
        s = lib.bm25_block_score_topk_smem
        s.argtypes = [i, i]
        s.restype = ctypes.c_longlong
    return f


def bm25_block_score_topk(token_ids, local_doc, scores, uniq_tokens,
                          weights, *, block_size: int, k: int, n_docs: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked postings × ``[U, B]`` query table → (values, local rows)
    ``[nb, k, B]``.

    A CPU tensor runs the plain twin; a CUDA tensor launches the kernel
    (and raises if it cannot): there is no fall-back between the two.
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
    if nb > 65535:
        raise ValueError(f"{nb} document blocks exceed the grid's 65535")
    lib = _build.load("bm25_block_score")
    launch = _fn(lib)
    if lib.bm25_block_score_topk_smem(block_size, u) > _build.SMEM_LIMIT:
        raise ValueError(f"block_size={block_size} with {u} unique tokens "
                         "does not fit a CTA's shared memory")
    ops = [t.contiguous() for t in (token_ids, local_doc, scores,
                                    uniq_tokens, weights)]
    out_v = torch.empty((nb, k, b), dtype=torch.float32, device=dev)
    out_i = torch.empty((nb, k, b), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(ops[0].data_ptr(), ops[1].data_ptr(), ops[2].data_ptr(),
                     nb, p, ops[3].data_ptr(), u, ops[4].data_ptr(), b,
                     block_size, k, n_docs, out_v.data_ptr(),
                     out_i.data_ptr(), stream)
    _build.check(err, "bm25_block_score_topk")
    LAUNCHES.n += 1
    return out_v, out_i
