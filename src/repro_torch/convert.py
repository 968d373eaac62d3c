"""Carry an index built by the JAX package across to the port.

A system whose state is an index carries its "weights" as index arrays:
:func:`index_from_reference` reads a ``repro`` ``BM25Index`` (or the
``host`` index of a ``repro`` ``DeviceIndex``) duck-typed, as numpy
arrays, and returns the port's :class:`~repro_torch.core.index.BM25Index`
holding equal arrays — so both packages serve the same state. It imports
nothing of ``repro``.
"""

from __future__ import annotations

import numpy as np

from .core.index import BM25Index
from .core.variants import BM25Params


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
