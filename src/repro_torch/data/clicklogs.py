"""Synthetic recsys data: CTR click logs and sequential behaviour.

Labels come from a planted logistic/affinity model so the training tests
can assert that loss decreases toward the (known) achievable level.

A numpy copy of ``repro.data.clicklogs`` (the port imports nothing of the JAX
package): for a given seed every array is byte-identical to the
reference's.
"""

from __future__ import annotations

import numpy as np


def ctr_batches(*, vocab_sizes, n_dense: int, batch: int, seed: int = 0):
    """DLRM/AutoInt batches with a planted logistic CTR model."""
    rng = np.random.default_rng(seed)
    n_fields = len(vocab_sizes)
    field_w = [rng.normal(scale=0.5, size=v) for v in vocab_sizes]
    dense_w = rng.normal(scale=0.5, size=n_dense) if n_dense else None
    while True:
        sparse = np.stack(
            [rng.integers(0, v, size=batch) for v in vocab_sizes],
            axis=1).astype(np.int32)
        logit = sum(field_w[f][sparse[:, f]] for f in range(n_fields))
        out = {"sparse": sparse}
        if n_dense:
            dense = rng.normal(size=(batch, n_dense)).astype(np.float32)
            logit = logit + dense @ dense_w
            out["dense"] = dense
        p = 1.0 / (1.0 + np.exp(-logit))
        out["labels"] = (rng.random(batch) < p).astype(np.int32)
        yield out


def seq_rec_batches(*, n_items: int, seq_len: int, batch: int, seed: int = 0,
                    per_position: bool = True):
    """SASRec/MIND batches: histories walk item clusters; positives stay
    in-cluster, negatives are uniform."""
    rng = np.random.default_rng(seed)
    n_clusters = 32
    cluster_of = rng.integers(0, n_clusters, size=n_items + 1)
    items_of = [np.where(cluster_of == c)[0] for c in range(n_clusters)]
    items_of = [c[c > 0] if (c > 0).any() else np.array([1]) for c in items_of]
    while True:
        hist = np.zeros((batch, seq_len), np.int32)
        c = rng.integers(0, n_clusters, size=batch)
        for t in range(seq_len):
            jump = rng.random(batch) < 0.05
            c = np.where(jump, rng.integers(0, n_clusters, size=batch), c)
            hist[:, t] = [int(rng.choice(items_of[ci])) for ci in c]
        if per_position:
            pos = np.roll(hist, -1, axis=1)
            pos[:, -1] = [int(rng.choice(items_of[ci])) for ci in c]
            neg = rng.integers(1, n_items, size=(batch, seq_len)).astype(np.int32)
        else:
            pos = np.array([int(rng.choice(items_of[ci])) for ci in c],
                           dtype=np.int32)
            neg = rng.integers(1, n_items, size=batch).astype(np.int32)
        yield {"history": hist, "pos_items": pos.astype(np.int32),
               "neg_items": neg}
