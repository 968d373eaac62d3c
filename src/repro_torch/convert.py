"""Carry an index built by the JAX package across to the port.

A system whose state is an index carries its "weights" as index arrays:
:func:`index_from_reference` reads a ``repro`` ``BM25Index`` (or the
``host`` index of a ``repro`` ``DeviceIndex``) duck-typed, as numpy
arrays, and returns the port's :class:`~repro_torch.core.index.BM25Index`
holding equal arrays — so both packages serve the same state.
:func:`block_max_from_reference` does the same for the pruned regime's
block-max table, :func:`device_index_from_reference` for a whole resident
index (a reordered one keeps its permutation: its ``host`` is in the
permuted id space, and ``perm`` / ``reorder`` come across with it), and
:func:`scoring_index_from_reference` for the eager scorer's device index,
:func:`recsys_params_from_reference` for a recsys model's params, and
:func:`lm_params_from_reference` for an LM's.
A snapshot (``sparse.snapshot``) is the other carrier of state between
the packages. It imports nothing of ``repro``.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.index import BM25Index
from .core.variants import BM25Params
from .core.scoring import DeviceIndex
from .device import resolve_device
from .models.common import tree_map
from .sparse import block_csr
from .sparse.block_csr import BlockMaxTable, put_descriptor_array


def index_from_reference(obj) -> BM25Index:
    """The port's ``BM25Index`` with the arrays and metadata of ``obj``.

    ``obj`` is anything shaped like ``repro.core.index.BM25Index``, or an
    object with a ``host`` attribute holding one (``repro``'s
    ``DeviceIndex``). Arrays are copied with the port's dtypes.
    """
    src = obj
    if hasattr(obj, "host"):
        src = obj.host
        if src is None:
            raise ValueError("the DeviceIndex holds no host index "
                             "(built with host_arrays='drop')")
    p = src.params
    return BM25Index(
        indptr=np.array(src.indptr, dtype=np.int64),
        doc_ids=np.array(src.doc_ids, dtype=np.int32),
        scores=np.array(src.scores, dtype=np.float32),
        nonoccurrence=np.array(src.nonoccurrence, dtype=np.float32),
        doc_lens=np.array(src.doc_lens, dtype=np.int32),
        n_docs=int(src.n_docs), n_vocab=int(src.n_vocab),
        l_avg=float(src.l_avg), variant=str(src.variant),
        params=BM25Params(k1=float(p.k1), b=float(p.b),
                          delta=float(p.delta), method=str(p.method)),
        doc_offset=int(src.doc_offset))


def block_max_from_reference(bmax, *, device=None) -> BlockMaxTable:
    """The port's ``BlockMaxTable`` with the arrays and metadata of ``bmax``.

    ``bmax`` is shaped like ``repro.sparse.block_csr.BlockMaxTable``; its
    host table and scales are copied as numpy. With ``device`` the table
    is uploaded there (counted as descriptor traffic, as a build does), so
    it can replace a ``DeviceIndex``'s ``bmax`` on that device.
    """
    host = np.array(bmax.host)
    scale = np.array(bmax.scale, dtype=np.float32)
    bm = BlockMaxTable(host=host, scale=scale, quantized=bool(bmax.quantized),
                       block_size=int(bmax.block_size),
                       n_blocks=int(bmax.n_blocks), nb_pad=int(bmax.nb_pad),
                       over_budget=bool(bmax.over_budget))
    if device is not None:
        bm.device = put_descriptor_array(host, device=device)
        bm.scale_dev = put_descriptor_array(scale, device=device)
    return bm


def device_index_from_reference(dindex, *, device=None
                                ) -> block_csr.DeviceIndex:
    """The port's resident ``DeviceIndex`` on ``device`` (default
    ``cuda``) holding the state of ``dindex``, shaped like
    ``repro.sparse.block_csr.DeviceIndex``: its host index (in the
    permuted id space when it was built with ``reorder=``), geometry,
    layouts, block-max table, ``perm`` and ``reorder``. The layouts are
    rebuilt from the host index, which gives the reference's bytes; the
    uploads are counted as a build's."""
    host = index_from_reference(dindex)
    di = block_csr.DeviceIndex.build(
        host, device=device if device is not None else "cuda",
        block_size=int(dindex.block_size), tile=int(dindex.tile_p),
        frag=int(dindex.frag), with_blocked=dindex.blk_tok is not None,
        with_csc=dindex.csc_doc_ids is not None, with_bmax=False)
    if dindex.bmax is not None:
        di.bmax = block_max_from_reference(dindex.bmax, device=di.device)
    perm = getattr(dindex, "perm", None)
    if perm is not None:
        di.perm = np.array(perm, dtype=np.int32)
        di.reorder = str(dindex.reorder)
    return di


def scoring_index_from_reference(dindex, *, device=None) -> DeviceIndex:
    """The port's eager-scorer ``DeviceIndex`` with the arrays of
    ``dindex``, shaped like ``repro.core.scoring.DeviceIndex`` (read as
    numpy), uploaded to ``device`` (default ``cuda``) and counted as
    posting traffic, as :meth:`DeviceIndex.from_host` does."""
    return DeviceIndex.upload(dindex.indptr, dindex.doc_ids, dindex.scores,
                              dindex.nonoccurrence,
                              n_docs=int(dindex.n_docs),
                              doc_offset=int(dindex.doc_offset),
                              device=device)


def recsys_params_from_reference(tree, *, device=None):
    """The port's params for ``repro.models.recsys``'s ``tree`` (nested
    dicts and lists of arrays, as ``jax.device_get`` of the reference's
    ``init_params`` gives them), on ``device`` (default ``cuda``): the
    same structure, every leaf an f32 tensor."""
    dev = resolve_device(device)
    return tree_map(lambda x: torch.as_tensor(np.array(x, dtype=np.float32),
                                              device=dev), tree)


def lm_params_from_reference(tree, *, device=None):
    """The port's params for ``repro.models.transformer``'s ``tree``
    (nested dicts of arrays, as ``jax.device_get`` of the reference's
    ``init_params`` gives them, cast or not), on ``device`` (default
    ``cuda``): the same structure, each leaf's dtype kept. A bfloat16
    leaf (an ``ml_dtypes`` array, which torch does not take) crosses as
    its bits through a 16-bit integer view."""
    dev = resolve_device(device)

    def one(x):
        a = np.array(x)
        if a.dtype.name == "bfloat16":
            return torch.as_tensor(a.view(np.int16)).view(
                torch.bfloat16).to(dev)
        return torch.as_tensor(a, device=dev)

    return tree_map(one, tree)
