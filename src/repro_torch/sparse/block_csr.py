"""Block-bucketed and resident CSC layouts for eager sparse scores.

The port's counterpart of ``repro.sparse.block_csr`` — the parts the
resident query path needs. Host-side layout code is the reference's numpy,
unchanged; uploads go through :func:`put_posting_arrays` /
:func:`put_descriptor_array`, which place tensors on an explicit torch
``device`` and count every byte.

Documents are grouped into fixed blocks of ``block_size``; each block's
postings live in flat arrays padded to a static per-block budget that is a
multiple of the kernel tile (the full-scan layout). The resident CSC
arrays are the gathered regime's layout: the per-batch fragment table
(:func:`fragment_plan`) names runs of them by position.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, replace

import numpy as np
import torch


# -- host→device transfer accounting -----------------------------------------
#
# The BM25S claim is that eager scoring moves ALL per-query work off the hot
# path; per-batch posting uploads would quietly re-add an O(Σ df) host→device
# copy to every call. Every posting-array upload goes through
# :func:`put_posting_arrays` so tests can ASSERT the steady-state serving
# path performs zero of them. Descriptor uploads (O(U) run metadata) are
# counted separately — they are the per-batch cost the resident design is
# allowed to pay.

@dataclass
class TransferStats:
    """Counters for host→device uploads, split by payload class."""

    posting_uploads: int = 0    # uploads carrying posting arrays
    posting_bytes: int = 0      # bytes of postings shipped
    descriptor_uploads: int = 0  # run/fragment descriptor tables
    descriptor_bytes: int = 0

    def reset(self) -> None:
        self.posting_uploads = 0
        self.posting_bytes = 0
        self.descriptor_uploads = 0
        self.descriptor_bytes = 0


TRANSFERS = TransferStats()


def reset_transfer_stats() -> TransferStats:
    TRANSFERS.reset()
    return TRANSFERS


def put_posting_arrays(*arrays, device):
    """Upload posting arrays to ``device``, counting the transfer.

    The ONLY sanctioned way to move posting data host→device: index builds
    call it once per built shard; the host-gather rung calls it per batch
    (which is exactly what the counters expose). Returns the device
    tensors in input order.

    Fault-injection site ``residency.put_posting_arrays`` (see
    ``repro_torch.serve.faults``): an armed residency fault makes the
    upload raise ``ResidencyError`` — the peek costs nothing unless the
    harness module is already imported AND a fault is armed.
    """
    import sys
    _f = sys.modules.get("repro_torch.serve.faults")
    if _f is not None and _f.ACTIVE:
        _f.fire("residency.put_posting_arrays")
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        TRANSFERS.posting_uploads += 1
        TRANSFERS.posting_bytes += a.nbytes
        out.append(_to_device(a, device))
    return out[0] if len(out) == 1 else tuple(out)


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """``a`` on ``device``. A read-only array (a snapshot's memmap) is
    copied into the upload: torch would otherwise view its bytes as a
    non-writable tensor on the CPU."""
    if a.flags.writeable:
        return torch.as_tensor(a, device=device)
    return torch.tensor(a, device=device)


def put_descriptor_array(arr, *, device):
    """Upload a run/fragment descriptor table (O(U) metadata, not postings)."""
    arr = np.ascontiguousarray(arr)
    TRANSFERS.descriptor_uploads += 1
    TRANSFERS.descriptor_bytes += arr.nbytes
    return _to_device(arr, device)


@dataclass
class BlockedPostings:
    """Postings bucketed by destination block (static-shape sparse layout).

    ``token_ids[i, p]`` is -1 for padding slots; padding slots carry
    ``scores == 0`` and ``local_doc == 0``.
    """

    token_ids: np.ndarray   # [n_blocks, nnz_pad] int32, -1 = pad
    local_doc: np.ndarray   # [n_blocks, nnz_pad] int32 in [0, block_size)
    scores: np.ndarray      # [n_blocks, nnz_pad] float32
    block_size: int
    n_docs: int             # true (unpadded) number of documents
    n_vocab: int

    @property
    def n_blocks(self) -> int:
        return int(self.token_ids.shape[0])

    @property
    def nnz_pad(self) -> int:
        return int(self.token_ids.shape[1])

    def padding_stats(self) -> dict:
        real = int((self.token_ids >= 0).sum())
        total = self.token_ids.size
        return {
            "nnz": real,
            "padded_nnz": total,
            "pad_fraction": 1.0 - real / max(total, 1),
            "n_blocks": self.n_blocks,
            "nnz_pad_per_block": self.nnz_pad,
        }


def _round_up(x: int, tile: int) -> int:
    return max(tile, ((x + tile - 1) // tile) * tile)


def bucket_pow2(n: int, *, floor: int = 512, cap: int | None = None) -> int:
    """Round ``n`` up to a power-of-two bucket (≥ ``floor``).

    Power-of-two buckets bound the distinct device shapes to
    O(log max-demand). ``cap`` (if given) clamps the bucket; callers must
    then treat ``n > cap`` as overflow, never truncate silently.
    """
    b = max(int(floor), 1)
    while b < n:
        b <<= 1
    return min(b, cap) if cap is not None else b


def block_postings_from_coo(
    token_ids: np.ndarray,
    doc_ids: np.ndarray,
    scores: np.ndarray,
    *,
    n_docs: int,
    n_vocab: int,
    block_size: int = 512,
    tile: int = 512,
    sort_tokens: bool = True,
) -> BlockedPostings:
    """Bucket COO postings by ``doc_id // block_size`` and pad per block.

    ``nnz_pad`` is the max per-block count rounded up to ``tile``. Within a
    block postings are sorted by token id. Fully vectorized: one
    ``lexsort`` by (block, token) makes each block a contiguous run and a
    single fancy-indexed scatter fills the rectangular arrays.
    """
    n_blocks = max(1, -(-n_docs // block_size))
    blk = doc_ids // block_size
    counts = np.bincount(blk, minlength=n_blocks)
    nnz_pad = _round_up(int(counts.max()) if counts.size else 0, tile)

    tok = np.full((n_blocks, nnz_pad), -1, dtype=np.int32)
    loc = np.zeros((n_blocks, nnz_pad), dtype=np.int32)
    sc = np.zeros((n_blocks, nnz_pad), dtype=np.float32)

    order = (np.lexsort((token_ids, blk)) if sort_tokens
             else np.argsort(blk, kind="stable"))
    token_ids, doc_ids, scores, blk = (
        token_ids[order], doc_ids[order], scores[order], blk[order])
    starts = np.zeros(n_blocks + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    col = np.arange(blk.size, dtype=np.int64) - starts[blk]
    tok[blk, col] = token_ids
    loc[blk, col] = doc_ids - blk * block_size
    sc[blk, col] = scores
    return BlockedPostings(tok, loc, sc, block_size=block_size,
                           n_docs=n_docs, n_vocab=n_vocab)


def block_postings_from_index(index, *, block_size: int = 512,
                              tile: int = 512) -> BlockedPostings:
    """Re-block a :class:`repro_torch.core.index.BM25Index` (CSC) shard."""
    df = np.diff(index.indptr)
    tok = np.repeat(np.arange(index.n_vocab, dtype=np.int32), df)
    return block_postings_from_coo(
        tok, index.doc_ids.astype(np.int64), index.scores,
        n_docs=int(index.doc_lens.size), n_vocab=index.n_vocab,
        block_size=block_size, tile=tile)


def block_edges(src: np.ndarray, dst: np.ndarray, weight: np.ndarray | None,
                *, n_nodes: int, block_size: int = 512,
                tile: int = 512) -> BlockedPostings:
    """GNN edge list -> destination-blocked layout (same container).

    ``token_ids`` carries the *source node id*, ``local_doc`` the destination
    offset within its block, ``scores`` the edge weight (1.0 if None).
    """
    w = np.ones(src.shape[0], np.float32) if weight is None else weight
    return block_postings_from_coo(
        src.astype(np.int32), dst.astype(np.int64), w.astype(np.float32),
        n_docs=n_nodes, n_vocab=n_nodes, block_size=block_size, tile=tile,
        sort_tokens=False)


def _flatten_run_positions(starts: np.ndarray, lens: np.ndarray
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized run flatten: flat slot ``j`` of run ``i`` reads posting
    position ``starts[i] + (j - run_start_i)``.

    Returns ``(pos [Σ lens], run_of [Σ lens])``.
    """
    total = int(lens.sum())
    run_of = np.repeat(np.arange(lens.size, dtype=np.int64), lens)
    run_start = np.repeat(np.cumsum(lens) - lens, lens)
    pos = starts[run_of] + np.arange(total, dtype=np.int64) - run_start
    return pos, run_of


def posting_runs(indptr: np.ndarray, uniq_tokens: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Per-token posting-run descriptors ``(start, len)`` from CSC indptr."""
    starts = indptr[uniq_tokens]
    lens = indptr[uniq_tokens + 1] - starts
    return starts.astype(np.int64), lens.astype(np.int64)


@dataclass
class GatheredPostings:
    """Query-driven posting gather in the candidate-compacted layout.

    Only the query tokens' posting runs are materialized — total work is
    O(Σ df(qᵢ)) over the *batch's unique tokens*, never O(nnz). Candidate
    documents (the union of gathered doc ids, sorted ascending) are mapped
    to compact slots ``0..n_candidates-1``; slots are chunked by
    ``slot // acc_block`` so chunk ``c``'s postings only touch accumulator
    rows ``[0, acc_block)`` — the ``[acc_block, B]`` accumulator of the
    host-gather kernel K4 (``kernels.bm25_gather_score
    .bm25_gather_score_topk``). ``candidates[c, r]`` recovers the global doc
    id of chunk ``c``'s slot ``r`` (-1 = padding slot, masked to the float
    minimum before top-k selection).

    The layout and its bytes are the reference's (``repro.sparse.block_csr
    .GatheredPostings``), byte for byte. ``acc_block`` stays SMALL (the
    blocked layout's block_size, 512): each chunk is one CTA of K4 whose
    accumulator lives in shared memory, so big candidate sets get more
    chunks and the work stays linear in Σ df.
    """

    token_ids: np.ndarray    # [n_chunks, p_pad] int32, -1 = pad
    slot_ids: np.ndarray     # [n_chunks, p_pad] int32 in [0, acc_block)
    scores: np.ndarray       # [n_chunks, p_pad] float32
    candidates: np.ndarray   # [n_chunks, acc_block] int32 global ids, -1 pad
    acc_block: int           # accumulator height (candidate slots per chunk)
    n_candidates: int        # true (unpadded) candidate-document count
    sum_df: int              # Σ df over the batch's unique query tokens

    @property
    def n_chunks(self) -> int:
        return int(self.token_ids.shape[0])

    @property
    def p_pad(self) -> int:
        return int(self.token_ids.shape[1])

    def work_ratio(self, nnz: int) -> float:
        """Full-scan postings / gathered postings — the asymptotic win."""
        return nnz / max(self.sum_df, 1)


def _gather_runs_cached(index, uniq_tokens: np.ndarray, starts: np.ndarray,
                        lens: np.ndarray, cache: PostingRunCache
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Per-token run gather through the LRU: hot tokens skip the re-gather.

    Cache misses are still gathered in ONE vectorized pass over the missing
    subset (then split per token to populate the cache); the assembled
    ``(doc_ids, scores)`` stream is byte-identical to the uncached path.
    """
    u = uniq_tokens.size
    runs: list[tuple[np.ndarray, np.ndarray] | None] = [None] * u
    miss = []
    for i in range(u):
        if lens[i] == 0:
            runs[i] = (np.zeros(0, np.int64), np.zeros(0, np.float32))
            continue
        hit = cache.get(int(uniq_tokens[i]))
        if hit is None:
            miss.append(i)
        else:
            runs[i] = hit
    if miss:
        m = np.asarray(miss, dtype=np.int64)
        m_lens = lens[m]
        pos, _ = _flatten_run_positions(starts[m], m_lens)
        md = index.doc_ids[pos].astype(np.int64)
        ms = index.scores[pos].astype(np.float32)
        cuts = np.cumsum(m_lens)[:-1]
        for i, d, s in zip(miss, np.split(md, cuts), np.split(ms, cuts)):
            runs[i] = (d, s)
            # copies, not np.split views: a view would pin the WHOLE miss
            # batch's arrays in memory for as long as this run stays in
            # the LRU (capacity bounds entries, not bytes)
            cache.put(int(uniq_tokens[i]), d.copy(), s.copy())
    g_doc = np.concatenate([r[0] for r in runs]) if u else \
        np.zeros(0, np.int64)
    g_sc = np.concatenate([r[1] for r in runs]) if u else \
        np.zeros(0, np.float32)
    return g_doc, g_sc


def gather_posting_runs(index, uniq_tokens: np.ndarray, *,
                        acc_block: int = 512, tile: int = 512,
                        p_bucket: int | None = None,
                        cache: PostingRunCache | None = None,
                        descriptors_only: bool = False):
    """Gather ONLY the query tokens' posting runs (host, fully vectorized).

    One ``np.repeat``-based run flattening replaces per-token slicing: flat
    position ``j`` of run ``i`` reads ``doc_ids[start_i + j]``. Candidate
    compaction is one ``np.unique`` over the gathered doc ids; chunking by
    ``slot // acc_block`` reuses :func:`block_postings_from_coo` (postings
    within a chunk stay token-sorted for the kernel's membership locality).

    Both dimensions are power-of-two bucketed, as in the reference: the
    per-chunk posting dimension rounds up to a power-of-two multiple of
    ``tile`` (``p_bucket`` overrides with an explicit floor), and the chunk
    count pads with empty chunks (all -1). The gather itself can never
    overflow: shapes are sized *from* the batch's actual Σ df.

    ``descriptors_only=True`` stops after the O(U) descriptor computation
    and returns :class:`RunDescriptors` — the ``(start, len)`` traversal
    plan with NO posting copy (the resident device path's input; see
    :func:`fragment_plan` for the kernel-ready form). ``cache`` routes the
    copy through a :class:`PostingRunCache` so hot tokens are gathered
    once across batches.
    """
    uniq_tokens = np.asarray(uniq_tokens, dtype=np.int64)
    starts, lens = posting_runs(index.indptr, uniq_tokens)
    total = int(lens.sum())
    if descriptors_only:
        return RunDescriptors(starts=starts, lens=lens, sum_df=total)
    if total == 0:
        p_pad = max(tile, p_bucket or tile)
        return GatheredPostings(
            token_ids=np.full((1, p_pad), -1, np.int32),
            slot_ids=np.zeros((1, p_pad), np.int32),
            scores=np.zeros((1, p_pad), np.float32),
            candidates=np.full((1, acc_block), -1, np.int32),
            acc_block=acc_block, n_candidates=0, sum_df=0)
    g_tok = np.repeat(uniq_tokens, lens).astype(np.int32)
    if cache is not None:
        g_doc, g_sc = _gather_runs_cached(index, uniq_tokens, starts, lens,
                                          cache)
    else:
        pos, _ = _flatten_run_positions(starts, lens)
        g_doc = index.doc_ids[pos].astype(np.int64)
        g_sc = index.scores[pos].astype(np.float32)

    candidates = np.unique(g_doc)                 # sorted ascending
    slot = np.searchsorted(candidates, g_doc)
    n_cand = int(candidates.size)

    bp = block_postings_from_coo(g_tok, slot, g_sc, n_docs=n_cand,
                                 n_vocab=int(index.n_vocab),
                                 block_size=acc_block, tile=tile)
    tok, loc, sc = bp.token_ids, bp.local_doc, bp.scores
    p_pad = max(bucket_pow2(bp.nnz_pad, floor=tile), p_bucket or 0)
    if p_pad > bp.nnz_pad:
        pad = p_pad - bp.nnz_pad
        tok = np.pad(tok, ((0, 0), (0, pad)), constant_values=-1)
        loc = np.pad(loc, ((0, 0), (0, pad)))
        sc = np.pad(sc, ((0, 0), (0, pad)))
    nc = bucket_pow2(bp.n_blocks, floor=1)        # bucket the chunk count
    if nc > bp.n_blocks:
        pad = nc - bp.n_blocks
        tok = np.pad(tok, ((0, pad), (0, 0)), constant_values=-1)
        loc = np.pad(loc, ((0, pad), (0, 0)))
        sc = np.pad(sc, ((0, pad), (0, 0)))
    cand = np.full((nc, acc_block), -1, np.int32)
    flat = cand.reshape(-1)
    flat[:n_cand] = candidates
    return GatheredPostings(token_ids=tok, slot_ids=loc, scores=sc,
                            candidates=cand, acc_block=acc_block,
                            n_candidates=n_cand, sum_df=total)


@dataclass
class RunDescriptors:
    """Descriptor-only posting gather: ``(start, len)`` per unique token.

    What :func:`gather_posting_runs` emits in ``descriptors_only`` mode —
    the traversal plan WITHOUT the O(Σ df) posting copy. O(U) to compute
    and O(U) to ship; the device-resident kernel path turns these into
    fragment reads against the resident index (:class:`DeviceIndex`),
    so postings never cross the host→device boundary per batch.
    """

    starts: np.ndarray      # [U] int64 — posting-run start in the CSC arrays
    lens: np.ndarray        # [U] int64 — run length (= df of the token)
    sum_df: int             # Σ lens — the batch's total posting work

    def work_ratio(self, nnz: int) -> float:
        return nnz / max(self.sum_df, 1)


@dataclass
class FragmentPlan:
    """Descriptor table driving the resident gather kernel.

    The batch's posting runs, split at document-block boundaries into
    *segments* (one (token, block) pair each, grouped by block) and then
    into fixed-``frag``-sized *fragments*. ``desc`` rows (all int32):

      0  start  — fragment's first posting position in the resident arrays
      1  valid  — number of real postings (≤ frag; 0 marks a padding slot)
      2  uniq   — owning row of the ``[U, B]`` query-weight table
      3  block  — global document-block id (accumulator window)
      4  first  — 1 iff first fragment of its block (kernel zeroes the acc)
      5  last   — 1 iff last fragment of its block (kernel reduces top-k)

    A block's fragments are contiguous (a *span*); per-batch upload is
    ``24 · nf_pad`` bytes.
    """

    desc: np.ndarray        # [6, nf_pad] int32
    vis_blocks: np.ndarray  # [nv] int64 — sorted blocks the batch touches
    n_frags: int            # true fragment count (before pow2 padding)
    sum_df: int
    block_size: int
    frag: int

    @property
    def nf_pad(self) -> int:
        return int(self.desc.shape[1])


def fragment_plan(index, uniq_tokens: np.ndarray, *, block_size: int,
                  frag: int = 512, nf_bucket: int | None = None
                  ) -> FragmentPlan:
    """Compile a query batch into the resident kernel's fragment table.

    Reads ONLY host metadata (``indptr`` + one pass over the runs'
    ``doc_ids`` to find block boundaries) — no posting scores are touched
    and nothing O(Σ df) is uploaded. Segments are ordered by block so each
    block's fragments are contiguous; the fragment count is pow2-bucketed.
    """
    uniq_tokens = np.asarray(uniq_tokens, dtype=np.int64)
    starts, lens = posting_runs(index.indptr, uniq_tokens)
    total = int(lens.sum())
    if total == 0:
        nf_pad = max(nf_bucket or 8, 8)
        return FragmentPlan(np.zeros((6, nf_pad), np.int32),
                            np.zeros(0, np.int64), 0, 0, block_size, frag)
    if int(index.indptr[-1]) >= 2 ** 31:
        raise ValueError("fragment starts are int32: nnz must be < 2^31")
    # flatten runs (positions only — doc ids drive the block split)
    pos, run_of = _flatten_run_positions(starts, lens)
    blk = index.doc_ids[pos].astype(np.int64) // block_size
    # segments: maximal (run, block)-constant spans of the flat stream
    new = np.empty(total, dtype=bool)
    new[0] = True
    new[1:] = (run_of[1:] != run_of[:-1]) | (blk[1:] != blk[:-1])
    seg_at = np.flatnonzero(new)
    seg_len = np.diff(np.append(seg_at, total))
    seg_start = pos[seg_at]
    seg_uniq = run_of[seg_at]
    seg_blk = blk[seg_at]
    order = np.argsort(seg_blk, kind="stable")      # group by block
    seg_start, seg_uniq, seg_blk, seg_len = (
        seg_start[order], seg_uniq[order], seg_blk[order], seg_len[order])
    # fragments: split each segment into ≤frag-sized units
    nf_seg = -(-seg_len // frag)
    nf = int(nf_seg.sum())
    fseg = np.repeat(np.arange(nf_seg.size, dtype=np.int64), nf_seg)
    fm = np.arange(nf, dtype=np.int64) - np.repeat(
        np.cumsum(nf_seg) - nf_seg, nf_seg)
    f_start = seg_start[fseg] + fm * frag
    f_valid = np.minimum(frag, seg_len[fseg] - fm * frag)
    f_uniq = seg_uniq[fseg]
    f_blk = seg_blk[fseg]
    f_first = np.empty(nf, dtype=np.int64)
    f_first[0] = 1
    f_first[1:] = f_blk[1:] != f_blk[:-1]
    f_last = np.empty(nf, dtype=np.int64)
    f_last[-1] = 1
    f_last[:-1] = f_blk[1:] != f_blk[:-1]
    nf_pad = max(bucket_pow2(nf, floor=8), nf_bucket or 0)
    desc = np.zeros((6, nf_pad), np.int32)
    desc[0, :nf] = f_start
    desc[1, :nf] = f_valid
    desc[2, :nf] = f_uniq
    desc[3, :nf] = f_blk
    desc[4, :nf] = f_first
    desc[5, :nf] = f_last
    return FragmentPlan(desc, np.unique(seg_blk), nf, total, block_size,
                        frag)


# -- block-max bounds (the pruned regime's build-time byproduct) -------------
#
# Every posting's final contribution is known at build time, so the
# per-(token, doc-block) maximum is one ``np.maximum.reduceat`` over the CSC
# run boundaries. The table is clamped at zero (a document MISSING a
# posting contributes exactly 0, and robertson's negative-IDF differentials
# never bound anything below zero), which makes the bound valid on all five
# variants:
#
#     score(d in block b, q) = Σ_t w_t · s(t, d)  ≤  Σ_t w_t · bmax[t, b]
#
# for nonnegative query weights w. The pruned regime compares that bound with
# a per-query threshold (a REAL document's full score, so a certified lower
# bound on the final k-th score) and skips every fragment whose block cannot
# alter the board.

_BOUND_SLACK = 1e-3   # relative inflation covering f32 kernel accumulation
_BOUND_ABS = 1e-6     # absolute floor so equal-to-zero bounds stay strict


@dataclass
class BlockMaxTable:
    """Dense per-(token, doc-block) score upper bounds, host + device.

    ``host[t, b]`` bounds the stored (shifted) score any document of block
    ``b`` can receive from token ``t``, clamped at 0. The column dimension
    is pow2-bucketed (``nb_pad``); columns ≥ ``n_blocks`` are zero.

    ``quantized=True`` stores u8 codes with a PER-TOKEN scale, CEIL-quantized
    (``dequant ≥ true max``) so the bound stays conservative; the auto
    builder picks u8 whenever the f32 table would exceed a quarter of the
    posting bytes. ``device``/``scale_dev`` are the same table and scales as
    torch tensors on the index's device (uploaded once, counted as
    descriptor traffic); ``build_s`` is the host seconds the build took.
    """

    host: np.ndarray        # [V, nb_pad] float32, or uint8 codes
    scale: np.ndarray       # [V] f32 per-token dequant scale (1s for f32)
    quantized: bool
    block_size: int
    n_blocks: int           # true block count (before pow2 padding)
    nb_pad: int
    over_budget: bool       # even u8 exceeded the ≤1/4-posting-bytes target
    device: torch.Tensor = None     # [V, nb_pad] on the index's device
    scale_dev: torch.Tensor = None  # [V] f32 on the index's device
    build_s: float = 0.0

    @property
    def nbytes(self) -> int:
        return int(self.host.nbytes
                   + (self.scale.nbytes if self.quantized else 0))

    def rows(self, tokens: np.ndarray) -> np.ndarray:
        """Dequantized f32 bound rows for ``tokens`` (clipped to range)."""
        safe = np.clip(np.asarray(tokens, dtype=np.int64), 0,
                       self.host.shape[0] - 1)
        r = self.host[safe].astype(np.float32)
        return r * self.scale[safe][:, None] if self.quantized else r


def build_block_max(index, *, block_size: int, dtype: str = "auto",
                    device=None) -> BlockMaxTable:
    """One vectorized pass CSC → block-max table (the reference's table).

    The CSC invariant (postings sorted by token, then doc id) makes every
    (token, doc-block) pair a contiguous run of the posting stream, so the
    per-run maxima are one ``np.maximum.reduceat`` over the run boundaries.

    ``dtype``: ``"f32"`` / ``"u8"`` force the storage; ``"auto"`` picks f32
    when it fits the ≤1/4-posting-bytes budget, else the u8 ceil-quantized
    form (kept even when it too overflows the budget: ``over_budget``).

    The u8 codes are computed from the runs alone: an element no run
    touches is 0 and quantizes to code 0, so the dense f32 table (3.3 GB at
    2M docs × 200k tokens) and its int64 codes are never materialized. Each
    code is the same f32 division, ceil and clip as the reference's dense
    pass, so the table is byte-identical to it. ``device`` (if given)
    receives the table and scales through :func:`put_descriptor_array`.
    """
    if dtype not in ("auto", "f32", "u8"):
        raise ValueError(f"unknown block-max dtype {dtype!r}")
    t0 = time.perf_counter()
    v = int(index.n_vocab)
    n_docs = int(index.doc_lens.size)
    n_blocks = max(1, -(-n_docs // block_size))
    nb_pad = bucket_pow2(n_blocks, floor=8)
    nnz = int(index.doc_ids.size)
    run_tok = run_blk = np.zeros(0, np.int64)
    run_max = np.zeros(0, np.float32)
    if nnz:
        df = np.diff(index.indptr)
        tok = np.repeat(np.arange(v, dtype=np.int64), df)
        blk = index.doc_ids.astype(np.int64) // block_size
        new = np.empty(nnz, dtype=bool)
        new[0] = True
        new[1:] = (tok[1:] != tok[:-1]) | (blk[1:] != blk[:-1])
        run_at = np.flatnonzero(new)
        # clamp: docs without the posting contribute 0, so the bound is
        # max(0, run max) — also neutralizes negative-IDF differentials
        run_max = np.maximum(np.maximum.reduceat(index.scores, run_at), 0.0)
        run_tok, run_blk = tok[run_at], blk[run_at]
        del tok, blk, new, run_at
    posting_budget = nnz * 8 // 4            # doc_ids i32 + scores f32
    f32_bytes = v * nb_pad * 4
    if dtype == "auto":
        dtype = "f32" if f32_bytes <= posting_budget else "u8"
    if dtype == "u8":
        # PER-TOKEN scales: each row quantizes against its own maximum
        # (runs are token-sorted: one reduceat over the token boundaries)
        mx = np.zeros(v, np.float32)
        if run_tok.size:
            at = np.flatnonzero(np.r_[True, run_tok[1:] != run_tok[:-1]])
            mx[run_tok[at]] = np.maximum.reduceat(run_max, at)
        scale = np.where(mx > 0, mx / 255.0, 1.0).astype(np.float32)
        codes = np.ceil(run_max / scale[run_tok]).astype(np.int64)
        host = np.zeros((v, nb_pad), np.uint8)
        host[run_tok, run_blk] = np.clip(codes, 0, 255).astype(np.uint8)
        quantized = True
    else:
        host = np.zeros((v, nb_pad), dtype=np.float32)
        host[run_tok, run_blk] = run_max
        scale, quantized = np.ones(v, np.float32), False
    bm = BlockMaxTable(host=host, scale=scale, quantized=quantized,
                       block_size=block_size, n_blocks=n_blocks,
                       nb_pad=nb_pad,
                       over_budget=host.nbytes > max(posting_budget, 1))
    if device is not None:
        bm.device = put_descriptor_array(host, device=device)
        bm.scale_dev = put_descriptor_array(scale, device=device)
    bm.build_s = time.perf_counter() - t0
    return bm


def block_upper_bounds(bmax: BlockMaxTable, uniq_tab: np.ndarray,
                       weights: np.ndarray) -> np.ndarray:
    """Per-(block, query) score upper bounds for one packed batch.

    ``uniq_tab``/``weights`` are the kernel's own query operands (sentinel
    rows carry zero weight, so clipping their token id is harmless).
    Computed in f64 and inflated by ``_BOUND_SLACK`` so the f32 kernel's
    accumulation rounding can never push a real score past its bound.
    Returns ``[nb_pad, B]`` float32.
    """
    rows = bmax.rows(uniq_tab).astype(np.float64)        # [U, nb_pad]
    ub = rows.T @ weights.astype(np.float64)             # [nb_pad, B]
    return (ub * (1.0 + _BOUND_SLACK) + _BOUND_ABS).astype(np.float32)


def prune_fragment_plan(fp: FragmentPlan, keep_blocks: np.ndarray
                        ) -> FragmentPlan:
    """Compact a fragment table to the fragments of surviving blocks.

    ``keep_blocks`` is a boolean mask over block ids. Pruning is
    BLOCK-granular, so surviving fragments keep their relative order and
    their first/last flags. ``vis_blocks`` stays UNPRUNED — the default
    splice must keep treating pruned blocks as visited (their documents
    score below the threshold, not zero) — while ``sum_df`` reflects the
    surviving work and ``nf_pad`` re-buckets.
    """
    n = fp.n_frags
    d = fp.desc[:, :n]
    keep = keep_blocks[d[3]] if n else np.zeros(0, dtype=bool)
    sel = d[:, keep]
    nf = int(sel.shape[1])
    nf_pad = bucket_pow2(max(nf, 1), floor=8)
    desc = np.zeros((6, nf_pad), np.int32)
    desc[:, :nf] = sel
    return FragmentPlan(desc, fp.vis_blocks, nf, int(sel[1].sum()),
                        fp.block_size, fp.frag)


def estimate_prune_survivors(bmax: BlockMaxTable, uniq_tab: np.ndarray,
                             weights: np.ndarray, *, k: int,
                             b_true: int | None = None
                             ) -> tuple[float, np.ndarray]:
    """Host estimate of the pruning win, BEFORE any device work.

    Each block's best single-term score ``max_t w_t · bmax[t, b]``
    approximates a score some document of the block reaches, so the k-th
    largest across blocks approximates the final k-th score from below.
    Survivors are the visited blocks whose full upper bound reaches the
    estimate for any query; the fraction is over visited blocks. Only the
    regime CHOICE consumes it — execution stays exact either way.

    Columns past ``b_true`` are pow2 padding: excluded here, their bound
    columns returned as -inf (a padding column's trivial threshold would
    veto every prune; a REAL empty query keeps that veto on purpose).

    Returns ``(survivor_frac, ub [nb_pad, B])``; host planning reuses the
    bounds so the product is paid once per batch.
    """
    ub = block_upper_bounds(bmax, uniq_tab, weights)
    b = weights.shape[1]
    if b_true is not None and b_true < b:
        ub[:, b_true:] = -np.inf
    else:
        b_true = b
    if b_true == 0:
        return 1.0, ub
    visited = ub[:, :b_true].max(axis=1) > 2.0 * _BOUND_ABS
    nv = int(visited.sum())
    if nv == 0:
        return 1.0, ub
    rows = bmax.rows(uniq_tab)                           # [U, nb_pad]
    kb = min(k, nv)
    tau_hat = np.empty(b_true, dtype=np.float32)
    for q in range(b_true):                              # B is small
        lb = (rows * weights[:, q:q + 1]).max(axis=0)    # [nb_pad]
        lb = lb[visited]
        tau_hat[q] = np.partition(lb, lb.size - kb)[lb.size - kb]
    surv = visited & (ub[:, :b_true] >= tau_hat[None, :]).any(axis=1)
    return float(surv.sum() / nv), ub


def seed_block_budget(k: int) -> int:
    """How many highest-bound blocks the threshold-seeding pass scores.

    The k winners can sit in up to k distinct blocks, so a tight seed
    threshold wants ~k blocks; the cap bounds the re-scored seed work for
    large k (the in-kernel skip refines whatever the seed pass missed).
    """
    return max(2, min(16, k))


def select_seed_blocks(ub: np.ndarray, vis_blocks: np.ndarray, *,
                       k: int, block_size: int) -> np.ndarray:
    """Threshold-seeding block choice: PER QUERY, the visited blocks with
    the highest upper bounds (:func:`seed_block_budget` each, unioned
    across the batch). Returns a boolean keep-mask over block ids, shaped
    like ``ub``'s block axis."""
    keep = np.zeros(ub.shape[0], dtype=bool)
    if vis_blocks.size == 0:
        return keep
    n_seed = min(int(vis_blocks.size), seed_block_budget(k))
    score = ub[vis_blocks]                               # [nv, B]
    for q in range(score.shape[1]):                      # B is small
        if not np.isfinite(score[:, q]).any():
            continue                                     # padding column
        top = vis_blocks[np.argsort(-score[:, q],
                                    kind="stable")[:n_seed]]
        keep[top] = True
    return keep


class PostingRunCache:
    """LRU cache of per-token gathered posting runs (host-gather fallback).

    Zipf-head query tokens recur across batches; without a cache the host
    fallback re-gathers their (large) posting runs from the CSC arrays on
    every batch. Keyed by token id; values are the ``(doc_ids, scores)``
    run copies. Bounded by ``capacity`` entries, least-recently-used out
    first. The resident device path never needs this — its index never
    leaves device memory.

    get/put are lock-guarded: the serving engine's thread pool may run the
    SAME shard's scorer for concurrent requests, and an unguarded
    ``move_to_end``/``popitem`` race corrupts the OrderedDict. Entries for
    a given token are immutable snapshots of the index, so cross-request
    interleaving is otherwise harmless (a double put stores equal arrays).
    """

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._runs: OrderedDict[int, tuple[np.ndarray, np.ndarray]] = \
            OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._runs)

    def get(self, token: int):
        with self._lock:
            run = self._runs.get(token)
            if run is None:
                self.misses += 1
                return None
            self._runs.move_to_end(token)
            self.hits += 1
            return run

    def put(self, token: int, doc_ids: np.ndarray, scores: np.ndarray
            ) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._runs[token] = (doc_ids, scores)
            self._runs.move_to_end(token)
            while len(self._runs) > self.capacity:
                self._runs.popitem(last=False)


@dataclass
class DeviceIndex:
    """Device-resident eager index: posting arrays uploaded ONCE per build.

    The shifted CSC posting arrays live on ``device`` across calls
    (``csc_doc_ids``/``csc_scores``, shaped ``[1, nnz_pad]``, padded by a
    full ``frag`` tail), alongside the block-bucketed full-scan layout — so
    BOTH retrieval regimes read resident tensors and the steady-state
    serving path ships only O(U) query tables and fragment descriptors per
    batch. Host-side it keeps the run-descriptor metadata (``indptr``/
    ``df``) the planner and fragment compiler need.

    Pass ``with_blocked`` / ``with_csc`` False to drop the regime you will
    never force. ``with_bmax`` (default: ``with_csc``) adds the pruned
    regime's :class:`BlockMaxTable` (``bmax_dtype`` as in
    :func:`build_block_max`). With device fragment planning
    (``sparse.fragment_device``) nothing on the serving path reads the host
    CSC copy, so ``host_arrays="drop"`` releases it (``host`` becomes None;
    the O(V) ``indptr``/``df`` metadata stays). ``build(reuse_from=)``
    adopts a donor's resident tensors when the postings did not change
    (``reused`` says which layouts it recycled). ``build(reorder=)``
    re-numbers the documents first (``sparse.reorder``); ``save`` /
    ``load`` persist and cold-start the layouts (``sparse.snapshot``).
    """

    host: object            # BM25Index — descriptor metadata
    indptr: np.ndarray      # [V+1] host — the run-descriptor table
    df: np.ndarray          # [V] host — per-token run lengths (Σ df is free)
    nnz: int
    n_docs: int
    n_vocab: int
    doc_offset: int
    block_size: int
    tile_p: int
    frag: int
    device: torch.device = None
    csc_doc_ids: torch.Tensor = None   # [1, nnz_pad] int32 (or None)
    csc_scores: torch.Tensor = None    # [1, nnz_pad] f32 (or None)
    csc_indptr: torch.Tensor = None    # [V+1] int32 (device plan builder)
    blk_tok: torch.Tensor = None       # [nb, p_pad] int32 (or None)
    blk_loc: torch.Tensor = None
    blk_sc: torch.Tensor = None
    bmax: BlockMaxTable = None         # pruned regime's bounds (or None)
    reused: dict = None                # which layouts a build recycled
    snapshot_report: dict = None       # set by sparse.snapshot loads
    # build-time doc-id reordering (sparse.reorder): ``perm[new] = old``
    # client id, or None when the layouts keep the client order. ``host``
    # and every resident layout live in the PERMUTED id space; retrievers
    # gather ``perm`` over the winner board at the merge.
    perm: np.ndarray = None            # [n_docs] int32 new -> old, or None
    reorder: str = "none"              # the scheme that produced ``perm``

    @staticmethod
    def _postings_identical(a, b) -> bool:
        """Byte-identical posting payload (layouts depend on nothing else
        except the doc count, checked separately where it matters)."""
        return (a is not None and b is not None
                and np.array_equal(a.indptr, b.indptr)
                and np.array_equal(a.doc_ids, b.doc_ids)
                and np.array_equal(a.scores, b.scores))

    @staticmethod
    def build(index, *, device, block_size: int = 512, tile: int = 512,
              frag: int = 512, with_blocked: bool = True,
              with_csc: bool = True, with_bmax: bool | None = None,
              bmax_dtype: str = "auto", host_arrays: str = "keep",
              reorder: str = "none",
              reuse_from: "DeviceIndex | None" = None) -> "DeviceIndex":
        """Upload a shard's resident layouts to ``device``, recycling
        ``reuse_from``'s.

        ``reorder`` (``"none"`` | ``"signature"`` | ``"minhash"``) runs the
        build-time doc-id clustering pass (``sparse.reorder``): documents
        are re-numbered so similar posting signatures share doc blocks,
        which tightens the block-max bounds. Every layout below — CSC,
        blocked, block-max — is then built on the PERMUTED order;
        ``di.perm`` carries the ``new -> old`` map retrievers gather over
        the winner board at the merge. Scores travel with their postings
        bit for bit.

        ``reuse_from`` is the incremental re-blocking path of elastic
        rescales: when the new shard's posting bytes equal the donor's
        (boundaries moved through posting-less documents, or did not move)
        and the donor lives on the same device with the same geometry, its
        resident CSC tensors are adopted as they are, and its blocked
        layout and block-max table too whenever the block grid still
        matches (same block count) — no re-blocking, no upload.
        ``reused`` records which layouts were recycled. A donor whose
        PERMUTATION differs (reordered vs. unordered, or a different
        clustering) is never adopted: its layouts index another doc space.
        """
        from .reorder import (permutations_equal, permute_index,
                              signature_permutation)
        if host_arrays not in ("keep", "drop"):
            raise ValueError(f"unknown host_arrays mode {host_arrays!r}")
        if with_bmax is None:
            with_bmax = with_csc
        perm = signature_permutation(index, mode=reorder)
        if perm is not None:
            index = permute_index(index, perm)
        nnz = int(index.doc_ids.size)
        n_docs = int(index.doc_lens.size)
        di = DeviceIndex(
            host=index, indptr=index.indptr, df=np.diff(index.indptr),
            nnz=nnz, n_docs=n_docs,
            n_vocab=int(index.n_vocab), doc_offset=int(index.doc_offset),
            block_size=block_size, tile_p=tile, frag=frag,
            device=torch.device(device),
            reused={"csc": False, "blocked": False, "bmax": False},
            perm=perm, reorder=reorder)
        old = reuse_from
        same_postings = (
            old is not None and old.host is not None
            and old.device == di.device
            and old.block_size == block_size and old.frag == frag
            and permutations_equal(perm, old.perm)
            and DeviceIndex._postings_identical(index, old.host))
        # the blocked layout and the block-max table also depend on the
        # block GRID: a doc-count change through trailing empty docs only
        # invalidates them when it moves the block count
        same_grid = (same_postings
                     and -(-n_docs // block_size)
                     == -(-old.n_docs // block_size))
        if with_csc and same_postings and old.csc_doc_ids is not None:
            di.csc_doc_ids = old.csc_doc_ids
            di.csc_scores = old.csc_scores
            di.csc_indptr = old.csc_indptr
            di.reused["csc"] = True
        elif with_csc:
            # pad so any fragment read [start, start+frag) stays in
            # bounds (starts are < nnz; padding postings carry score 0 /
            # doc 0 and are masked by the fragment's valid length)
            if nnz >= 2 ** 31:
                raise ValueError("resident CSC positions are int32: "
                                 "nnz must be < 2^31")
            nnz_pad = _round_up(max(nnz, 1), frag) + frag
            doc = np.zeros((1, nnz_pad), np.int32)
            sc = np.zeros((1, nnz_pad), np.float32)
            doc[0, :nnz] = index.doc_ids
            sc[0, :nnz] = index.scores
            di.csc_doc_ids, di.csc_scores = put_posting_arrays(
                doc, sc, device=di.device)
            # one-time O(V) upload so fragment tables can be built on
            # device (counted as the descriptor traffic it replaces)
            di.csc_indptr = put_descriptor_array(
                index.indptr.astype(np.int32), device=di.device)
        if with_blocked and same_grid and old.blk_tok is not None \
                and old.tile_p == min(tile, old.blk_tok.shape[1]):
            di.tile_p = old.tile_p
            di.blk_tok, di.blk_loc, di.blk_sc = (old.blk_tok, old.blk_loc,
                                                 old.blk_sc)
            di.reused["blocked"] = True
        elif with_blocked:
            bp = block_postings_from_index(index, block_size=block_size,
                                           tile=tile)
            di.tile_p = min(tile, bp.nnz_pad)
            di.blk_tok, di.blk_loc, di.blk_sc = put_posting_arrays(
                bp.token_ids, bp.local_doc, bp.scores, device=di.device)
        if with_bmax and with_csc and same_grid and old.bmax is not None \
                and (bmax_dtype == "auto"
                     or old.bmax.quantized == (bmax_dtype == "u8")):
            di.bmax = old.bmax
            di.reused["bmax"] = True
        elif with_bmax and with_csc:
            di.bmax = build_block_max(index, block_size=block_size,
                                      dtype=bmax_dtype, device=di.device)
        if host_arrays == "drop":
            if perm is not None:
                # keep a posting-free PERMUTED metadata copy: retrievers
                # and snapshot saves need doc_lens in the layouts' id
                # space (the O(nnz) arrays are still released)
                di.host = replace(index, doc_ids=np.zeros(0, np.int32),
                                  scores=np.zeros(0, np.float32))
            else:
                di.host = None           # serving must never read it again
        return di

    def sum_df(self, uniq_tokens: np.ndarray) -> int:
        """Batch posting work Σ df — free, from the host descriptor table."""
        u = np.asarray(uniq_tokens)
        return int(self.df[u].sum()) if u.size else 0

    # -- crash-safe persistence (sparse.snapshot) ---------------------------
    def save(self, path: str, *, index=None, algo: str | None = None) -> dict:
        """Atomic checksummed snapshot of the resident layouts (see
        ``sparse.snapshot``). ``index=`` supplies host metadata when this
        DeviceIndex was built with ``host_arrays='drop'``."""
        from . import snapshot
        return snapshot.save_device_index(self, path, index=index, algo=algo)

    @staticmethod
    def load(path: str, *, mmap: bool = False, host_arrays: str = "keep",
             verify: bool = True, corpus=None,
             device=None) -> "DeviceIndex":
        """Cold-start from a snapshot: verified (checksummed) read, then
        upload straight from the (mem)mapped padded layouts through
        ``put_posting_arrays`` — no host re-blocking, and the
        zero-steady-state-bytes invariant holds for every batch after.
        ``device`` defaults to ``"cuda"``."""
        from . import snapshot
        return snapshot.load_device_index(path, mmap=mmap,
                                          host_arrays=host_arrays,
                                          verify=verify, corpus=corpus,
                                          device=device)


def query_nonoccurrence_shift(nonoccurrence: np.ndarray,
                              q_tokens: np.ndarray,
                              q_weights: np.ndarray) -> np.ndarray:
    """Per-query §2.1 constant ``Σᵢ wᵢ·S⁰(qᵢ)`` for a padded query batch.

    ``[B]`` float32, zero for sparse variants.
    """
    safe = np.where(q_tokens >= 0, q_tokens, 0)
    return ((q_weights * nonoccurrence[safe] * (q_tokens >= 0))
            .sum(-1).astype(np.float32))


def pack_query_batch(q_tokens: np.ndarray, q_weights: np.ndarray,
                     u_max: int, *, uniq: np.ndarray | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Batch of padded queries -> (sorted unique tokens [U], weights [U, B]).

    The batched kernels score *all* queries in one pass over the postings;
    their query-side operand is the batch's unique-token table plus a
    per-query weight column. Pad token = 2^31 - 1 (sorts last, matches
    nothing since posting pads are -1).
    """
    b = q_tokens.shape[0]
    if uniq is None:
        uniq = np.unique(q_tokens[q_tokens >= 0])
    if uniq.size > u_max:
        raise ValueError(f"query batch has {uniq.size} unique tokens "
                         f"> u_max={u_max}")
    table = np.full(u_max, np.iinfo(np.int32).max, dtype=np.int32)
    table[: uniq.size] = uniq
    weights = np.zeros((u_max, b), dtype=np.float32)
    # tokens are unique within a query (pad_queries), so one scatter works
    qi, slot = np.nonzero(q_tokens >= 0)
    pos = np.searchsorted(uniq, q_tokens[qi, slot])
    weights[pos, qi] = q_weights[qi, slot]
    return table, weights
