"""The paper's own architecture: BM25S eager-sparse retrieval at pod scale.

The port's counterpart of ``repro.configs.bm25s``. Corpus: the paper's
footnote-13 example — 2M documents, 200K vocabulary (the dense score
matrix would be 1.6 TB; eager-sparse is ~250M postings). Queries arrive
in batches of 256, ≤32 unique tokens each.

Two cells (extra, beyond the 39 assigned ones):

  score_2m          — paper-faithful path: documents sharded over every mesh
                      axis, the sharded step of ``core.retrieval``
                      (``make_sharded_retrieve``: each rank's
                      ``score_batch`` + top-k through K5, one all-gather of
                      the candidates, the merge). A rank-local step on
                      ``DTensor`` shards.
  score_blocked_2m  — beyond-paper batched path: the block-bucketed layout
                      streamed once for the whole query batch. The reference
                      lowers it from its jnp oracles and leaves its
                      partitioning to GSPMD, which gathers the full [C, B]
                      scores to every chip; the port's function is K6
                      (``bm25_block_score``) and K5 (``ops.topk``). On
                      ``DTensor`` blocks it is one rank's program: K6 over
                      the rank's blocks, K5 over its 4,096-doc segments, one
                      all-gather of the candidate boards, the rank merge
                      (the scores are never gathered). With
                      ``sharded_topk=True`` it is the reference's
                      ``shard_map`` variant: a top-k a rank over its own
                      blocks (merged before the gather), global ids from
                      the shard id, one all-gather, a merge by
                      ``rank_order``.

``kernels.ref.bm25_block_score_ref`` and ``core.retrieval.blockwise_topk``
are the plain versions of the blocked cell, for the tests only: at full
width the oracle's ``[nb, P, B]`` product alone is ≈ 258 GB.
"""

from __future__ import annotations

import math

import torch

from ..core.variants import BM25Params
from ..dist import sharding
from ..dist.sharding import spec_placements
from .common import Cell, sds

N_DOCS = 2_097_152            # 2M docs (paper footnote 13 example)
N_VOCAB = 200_000
AVG_UNIQUE_TOKENS = 120       # postings per doc
QUERY_BATCH = 256
Q_MAX = 32
P_MAX = 16_384                # per-shard posting budget per query
TOP_K = 100
DOC_BLOCK = 512
U_MAX = 2048                  # unique tokens across the query batch

PARAMS = BM25Params(method="lucene", k1=1.5, b=0.75)

FAMILY = "bm25s"
CONFIG = dict(n_docs=N_DOCS, n_vocab=N_VOCAB, params=PARAMS)
SMOKE = dict(n_docs=512, n_vocab=256, params=PARAMS)


def _all_axes_shard0(mesh, args):
    """Each leaf's dim 0 over every mesh axis (index arrays, blocks)."""
    return tuple(spec_placements(mesh, tuple(mesh.mesh_dim_names))
                 for _ in args)


def _score_2m_cell() -> Cell:
    def build(mesh):
        from ..core.retrieval import make_sharded_retrieve
        axes = tuple(mesh.mesh_dim_names)
        n_shards = int(math.prod(mesh.shape))
        docs_per_shard = N_DOCS // n_shards
        nnz_per_shard = N_DOCS * AVG_UNIQUE_TOKENS // n_shards
        nnz_pad = int(-(-nnz_per_shard // 1024) * 1024)
        fn = make_sharded_retrieve(mesh, axes, p_max=P_MAX, k=TOP_K,
                                   n_docs_per_shard=docs_per_shard)
        idx_arrays = (
            sds((n_shards, N_VOCAB + 1), torch.int32),   # indptr
            sds((n_shards, nnz_pad), torch.int32),       # doc_ids
            sds((n_shards, nnz_pad), torch.float32),     # scores
            sds((n_shards, N_VOCAB), torch.float32),     # nonoccurrence
            sds((n_shards, 1), torch.int32),             # offsets
            sds((n_shards, 1), torch.int32),             # true doc counts
        )
        return fn, (idx_arrays,
                    sds((QUERY_BATCH, Q_MAX), torch.int32),
                    sds((QUERY_BATCH, Q_MAX), torch.float32))

    def shardings(mesh, args):
        idx_arrays, _qt, _qw = args
        return (_all_axes_shard0(mesh, idx_arrays), spec_placements(mesh),
                spec_placements(mesh))

    # useful work: gather+add of each query's postings on every shard
    flops = 2.0 * QUERY_BATCH * P_MAX * 1.0
    return Cell("bm25s", "score_2m", "retrieval", build, shardings, flops,
                note="paper-faithful gather+segment_sum (extra cell)",
                count_bound="score_batch's slots at their bound: every "
                            "query gathers its whole p_max budget, "
                            "B · p_max a shard")


def _score_blocked_cell(*, doc_block: int | None = None,
                        batch: int | None = None, u_max: int | None = None,
                        score_dtype=torch.float32,
                        sharded_topk: bool = False,
                        note: str = "beyond-paper batched MXU path "
                                    "(extra cell)") -> Cell:
    """The blocked cell, with the reference's keywords and defaults:
    ``doc_block``, ``batch`` and ``u_max`` default to the module's
    ``DOC_BLOCK``, ``QUERY_BATCH`` and ``U_MAX`` as they stand when the
    cell is made; ``score_dtype`` is the scores' and the ``[u_max,
    batch]`` weights' dtype (float32 or bfloat16: K6 and K5 run in it);
    ``sharded_topk=True`` is the reference's ``shard_map`` variant."""
    doc_block = DOC_BLOCK if doc_block is None else doc_block
    batch = QUERY_BATCH if batch is None else batch
    u_max = U_MAX if u_max is None else u_max
    k = TOP_K
    n_blocks = N_DOCS // doc_block
    nnz_pad = int(-(-AVG_UNIQUE_TOKENS * doc_block // 512) * 512)

    def scored(token_ids, local_doc, scores, uniq, weights):
        """K6 over the given blocks, laid out ``[B, blocks · doc_block]``."""
        from ..kernels.bm25_block_score import bm25_block_score
        out = bm25_block_score(token_ids, local_doc, scores, uniq, weights,
                               block_size=doc_block)
        return out.permute(2, 0, 1).reshape(batch, -1)

    def rank_scored(token_ids, local_doc, scores, uniq, weights):
        """:func:`scored` over each rank's own blocks (``DTensor`` blocks
        split on dim 0, the table replicated): the ``[B, n]`` scores split
        on dim 1 as the blocks are, never gathered."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        local = scored(*(t.to_local() for t in (token_ids, local_doc,
                                                scores)),
                       *(sharding.replicated_local(t) for t in (uniq,
                                                                weights)))
        n = n_blocks * doc_block
        return DTensor.from_local(
            local, token_ids.device_mesh,
            [Shard(1) if p.is_shard() else Replicate()
             for p in token_ids.placements], run_check=False,
            shape=(batch, n), stride=(n, 1))

    def build(mesh):
        from ..kernels import ops

        specs = (sds((n_blocks, nnz_pad), torch.int32),
                 sds((n_blocks, nnz_pad), torch.int32),
                 sds((n_blocks, nnz_pad), score_dtype),
                 sds((u_max,), torch.int32),
                 sds((u_max, batch), score_dtype))
        if not sharded_topk:
            def fn(token_ids, local_doc, scores, uniq, weights):
                if sharding.is_partitioned(token_ids):
                    flat = rank_scored(token_ids, local_doc, scores, uniq,
                                       weights)
                else:
                    flat = scored(token_ids, local_doc, scores, uniq,
                                  weights)
                vals, idx = ops.topk(flat, k, block=4096)
                return idx, vals

            return fn, specs

        from ..core.retrieval import sharded_topk_step

        def local_topk(sid, token_ids, local_doc, scores, uniq, weights):
            # the rank's own blocks: K6, then its top-k through K5
            flat = scored(token_ids, local_doc, scores, uniq, weights)
            vals, idx = ops.topk(flat, k, block=4096)
            return idx + sid * flat.shape[1], vals, None

        step = sharded_topk_step(mesh, tuple(mesh.mesh_dim_names),
                                 local_topk, k=k)

        def fn(*blocked_and_table):
            ids, vals, _ = step(*blocked_and_table)
            return ids, vals

        return fn, specs

    def shardings(mesh, args):
        blk = _all_axes_shard0(mesh, args[:3])
        return (*blk, spec_placements(mesh), spec_placements(mesh))

    # useful work: one multiply-add per (posting, query) with avg df hit rate
    flops = 2.0 * batch * N_DOCS * AVG_UNIQUE_TOKENS * (Q_MAX / N_VOCAB)
    return Cell("bm25s", "score_blocked_2m", "retrieval", build, shardings,
                flops, note=note)


def cells() -> list[Cell]:
    return [_score_2m_cell(), _score_blocked_cell()]
