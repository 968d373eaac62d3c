"""Build-time doc-id reordering: cluster documents by posting signature.

Block-max pruning (``block_csr.BlockMaxTable``) is only as strong as its
blocks are homogeneous: with arbitrary doc order a block's per-token upper
bound is set by its single hottest document, so the summed query-side bound
``Σ_t w_t · bmax[t, b]`` stays loose and the pruned regime still DMAs a
large fraction of the planned fragments. The classic BMW companion trick is
to RE-NUMBER documents so that docs with similar posting signatures share
blocks — per-block maxima drop, bounds tighten, skip rates rise — without
touching exactness, because winner ids are remapped back to client ids at
the merge (a single host-side gather on the ``[B, k]`` board).

Two signature schemes are provided; ``benchmarks/reorder.py`` microbenches
both and BENCH_6.json records why the default is the **top-weight token
sort**:

* ``"signature"`` (default) — each document's signature is its
  ``SIGNATURE_WIDTH`` highest-weight tokens (by the eagerly-scored posting
  weight, the exact quantity the block-max table bounds). A stable lexsort
  over the signature columns clusters docs sharing dominant tokens into
  runs, i.e. into the same 64-doc blocks. O(nnz) signature extraction +
  one O(n_docs·width) sort; on BENCH_1-scale corpora this costs ~2-4% of
  indexing throughput and wins the largest skip-rate gain because it
  concentrates exactly the per-token maxima the bounds sum over.
* ``"minhash"`` — classic Jaccard-similarity clustering: per-doc min-wise
  hashes of the token SET under ``MINHASH_WIDTH`` universal hash
  functions, lexsorted. Cheaper per doc than a content sort for huge
  vocabularies, but weight-blind: it groups docs sharing ANY tokens, not
  docs sharing HOT tokens, so its bounds stay looser (see BENCH_6's
  microbench block — it trails the signature sort at the same cost).

Both permutations are DETERMINISTIC functions of the index (ties broken by
original doc id via stable sorts). That determinism is a recovery rung:
a snapshot whose ``perm`` array (and its ``.dup`` replica) is corrupt can
recompute the permutation from the stored client-order postings and verify
it against the manifest checksum (see ``sparse.snapshot``).

The permutation convention throughout the stack is ``perm: new_id ->
old_id`` — ``perm[i]`` is the client id of the doc serving as device-side
doc ``i``. The inverse (``old -> new``) relabels postings at build time.

A numpy copy of ``repro.sparse.reorder`` (the port imports nothing of the
JAX package): for one index both modes give the reference's permutation
byte for byte, and so do ``permute_index`` / ``unpermute_index``.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

# top-weight tokens per signature; 4 keys cluster on the Zipf head that
# dominates block bounds while keeping the lexsort cheap
SIGNATURE_WIDTH = 4
MINHASH_WIDTH = 4
# deterministic odd multipliers for the universal minhash family
# (splitmix64-style mixing constants)
_MINHASH_MULT = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9,
                 0x94D049BB133111EB, 0xD6E8FEB86659FD93)

REORDER_MODES = ("none", "signature", "minhash")


def _coo_tok(index) -> np.ndarray:
    """Token id per posting, expanded from the CSC run-descriptor table."""
    return np.repeat(np.arange(index.n_vocab, dtype=np.int64),
                     np.diff(index.indptr))


def _sortable_score_key(scores) -> np.ndarray:
    """Map f32 weights to uint32-range keys with the same total order.

    Standard IEEE-754 trick: flip the sign bit for non-negative floats,
    complement negative ones. Lets the weight-descending selection below
    run on integer keys instead of a float lexsort (~3x faster).
    """
    bits = np.ascontiguousarray(scores).view(np.uint32).astype(np.uint64)
    return np.where(bits >= 0x80000000, ~bits & np.uint64(0xFFFFFFFF),
                    bits | np.uint64(0x80000000))


def doc_signatures(index, *, width: int = SIGNATURE_WIDTH) -> np.ndarray:
    """Per-doc top-weight token signature, ``[n_docs, width]`` int64.

    Row ``d`` holds doc ``d``'s ``width`` highest-weight tokens in
    descending stored-weight order (ties by ascending token id), padded
    with the sentinel ``n_vocab`` for docs with fewer postings.

    Sort-free extraction: one C-level CSC->CSR counting transpose groups
    postings doc-major, then ``width`` rounds of segmented max
    (``np.maximum.reduceat`` on composite ``weight_key << 32 | ~token``
    values, zeroing each round's winner) peel off the top tokens —
    O(width * nnz) with no comparison sort over the posting stream. Falls
    back to a stable composite argsort when scipy is unavailable; both
    paths produce identical signatures (tested in tests/test_reorder.py).
    """
    n_docs = int(index.doc_lens.size)
    sig = np.full((n_docs, width), int(index.n_vocab), dtype=np.int64)
    nnz = int(index.doc_ids.size)
    if nnz == 0:
        return sig
    skey = _sortable_score_key(index.scores)
    try:
        import scipy.sparse as sp
    except ImportError:
        sp = None
    if sp is not None:
        # skey + 1 keeps every explicit entry strictly above scipy's
        # implicit zeros so exhausted rows read back as the sentinel
        m = sp.csc_matrix((skey + np.uint64(1), index.doc_ids,
                           index.indptr),
                          shape=(n_docs, int(index.n_vocab))).tocsr()
        rs = m.indptr
        comp = ((m.data << np.uint64(32))
                | (np.uint64(0xFFFFFFFF) - m.indices.astype(np.uint64)))
        row_of = np.repeat(np.arange(n_docs, dtype=np.int64), np.diff(rs))
        nonempty = rs[:-1] < rs[1:]
        starts = rs[:-1][nonempty]
        rows_ne = np.flatnonzero(nonempty)
        for r in range(width):
            mx = np.maximum.reduceat(comp, starts)
            ok = mx > 0
            sig[rows_ne[ok], r] = (np.uint64(0xFFFFFFFF)
                                   - (mx[ok] & np.uint64(0xFFFFFFFF))
                                   ).astype(np.int64)
            if r == width - 1:
                break
            # retire each row's winner (first — lowest-token — match)
            mxe = np.zeros(n_docs, dtype=np.uint64)
            mxe[rows_ne] = mx
            match = np.flatnonzero(comp == mxe[row_of])
            first = match[np.unique(row_of[match], return_index=True)[1]]
            comp[first] = 0
        return sig
    # numpy-only fallback: composite stable sort doc-major / weight-desc
    # (stability keeps token-ascending order inside weight ties, matching
    # the reduceat path's first-match rule), then scatter within-doc rank
    tok = _coo_tok(index)
    doc = index.doc_ids.astype(np.int64)
    key = ((doc.astype(np.uint64) << np.uint64(32))
           | (np.uint64(0xFFFFFFFF) - skey))
    order = np.argsort(key, kind="stable")
    d_s, t_s = doc[order], tok[order]
    starts = np.zeros(n_docs + 1, dtype=np.int64)
    starts[1:] = np.bincount(d_s, minlength=n_docs)
    np.cumsum(starts, out=starts)
    rank = np.arange(nnz, dtype=np.int64) - starts[d_s]
    keep = rank < width
    sig[d_s[keep], rank[keep]] = t_s[keep]
    return sig


def minhash_signatures(index, *, width: int = MINHASH_WIDTH) -> np.ndarray:
    """Per-doc min-wise token-set hashes, ``[n_docs, width]`` uint64."""
    n_docs = int(index.doc_lens.size)
    sig = np.full((n_docs, width), np.iinfo(np.uint64).max, dtype=np.uint64)
    nnz = int(index.doc_ids.size)
    if nnz == 0:
        return sig
    tok = _coo_tok(index).astype(np.uint64)
    doc = index.doc_ids.astype(np.int64)
    for i in range(width):
        with np.errstate(over="ignore"):
            # additive pre-mix before the multiply so token 0 (the Zipf
            # head, present in nearly every doc) doesn't hash to 0 under
            # every function and collapse all signatures
            h = ((tok + np.uint64(_MINHASH_MULT[(i + 1)
                                                % len(_MINHASH_MULT)]))
                 * np.uint64(_MINHASH_MULT[i % len(_MINHASH_MULT)]))
            h ^= h >> np.uint64(31)
        np.minimum.at(sig[:, i], doc, h)
    return sig


def signature_permutation(index, *, mode: str = "signature"
                          ) -> np.ndarray | None:
    """``perm: new_id -> old_id`` clustering docs by posting signature.

    Returns None when the permutation degenerates to the identity (tiny
    or empty shards, or an already-clustered order) — callers treat None
    as "no reorder", keeping every fast path untouched.
    """
    if mode not in REORDER_MODES:
        raise ValueError(f"unknown reorder mode {mode!r}; "
                         f"expected one of {REORDER_MODES}")
    n_docs = int(index.doc_lens.size)
    if mode == "none" or n_docs <= 1:
        return None
    sig = (doc_signatures(index) if mode == "signature"
           else minhash_signatures(index))
    # lexsort: last key is primary -> column 0 (the hottest token) leads;
    # stable, so full-signature ties keep ascending client-id order and
    # the permutation is a pure deterministic function of the index
    perm = np.lexsort(tuple(sig[:, c] for c in range(sig.shape[1] - 1,
                                                     -1, -1)))
    perm = perm.astype(np.int32)
    if np.array_equal(perm, np.arange(n_docs, dtype=np.int32)):
        return None
    return perm


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    """``inv[old_id] = new_id`` for a ``perm: new_id -> old_id``."""
    inv = np.empty(perm.size, dtype=np.int32)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return inv


def is_permutation(perm, n_docs: int) -> bool:
    """Cheap structural validation (snapshot loads run this on untrusted
    bytes when checksum verification is off)."""
    p = np.asarray(perm)
    if p.ndim != 1 or p.size != n_docs:
        return False
    if p.size == 0:
        return True
    if p.min() < 0 or p.max() >= n_docs:
        return False
    return bool(np.unique(p).size == n_docs)


def permute_index(index, perm: np.ndarray):
    """Relabel an index's documents by ``perm`` (new_id -> old_id).

    One stable lexsort restores the CSC invariant (doc ids ascending
    within each token run) in the new id space; scores travel with their
    postings untouched, so every document's score vector is bit-identical
    — only its id changes. ``indptr``/``nonoccurrence`` are per-token and
    permutation-invariant.
    """
    inv = invert_permutation(perm)
    nnz = int(index.doc_ids.size)
    if nnz == 0:
        return replace(index, doc_lens=np.asarray(index.doc_lens)[perm])
    tok = _coo_tok(index)
    new_doc = inv[index.doc_ids].astype(np.int64)
    # (tok, new_doc) pairs are unique, so a single composite-int64 key
    # needs no stability and an unstable argsort is ~6x the lexsort speed
    order = np.argsort(tok * np.int64(index.doc_lens.size) + new_doc)
    return replace(
        index,
        doc_ids=new_doc[order].astype(np.int32),
        scores=np.asarray(index.scores)[order],
        doc_lens=np.asarray(index.doc_lens)[perm],
    )


def unpermute_index(index_p, perm: np.ndarray):
    """Exact inverse of :func:`permute_index` (client order back)."""
    return permute_index(index_p, invert_permutation(perm))


def permutations_equal(a, b) -> bool:
    """Donor-compatibility check: identical reorder (both None, or
    element-equal arrays). A reordered index must never adopt an
    unordered donor's resident layouts — and vice versa."""
    if a is None or b is None:
        return a is None and b is None
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def remap_board(ids: np.ndarray, board: np.ndarray,
                perm: np.ndarray) -> np.ndarray:
    """Winner-id remap at the merge: device-local ids -> client ids.

    A single host-side gather on the ``[B, k]`` id board — zero extra
    device bytes (TRANSFERS-asserted in tier-1). Rows are then re-sorted
    by ``(-score, client_id)``: scores are already descending, so this is
    the identity everywhere except inside bit-equal score ties, where it
    pins a deterministic ascending-client-id order independent of the
    permutation that produced the board.
    """
    out = perm.astype(np.int64, copy=False)[ids]
    if out.size == 0:
        return out
    order = np.lexsort((out, -board.astype(np.float64, copy=False)),
                       axis=-1)
    reordered = np.take_along_axis(out, order, axis=-1)
    # scores within a tie run are bit-equal, so the board itself is
    # unchanged by construction — only ids move
    return reordered


__all__ = [
    "REORDER_MODES", "SIGNATURE_WIDTH", "MINHASH_WIDTH",
    "doc_signatures", "minhash_signatures", "signature_permutation",
    "invert_permutation", "is_permutation", "permute_index",
    "unpermute_index", "permutations_equal", "remap_board",
]
