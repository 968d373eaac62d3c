"""LM token batcher: deterministic synthetic next-token streams.

Sequences follow a planted bigram process (each token biases the next into
a small successor set) so a model that learns reduces loss well below the
uniform baseline — used by the train-loop convergence tests and the
``train_lm`` example.

A numpy copy of ``repro.data.lm`` (the port imports nothing of the JAX
package): for a given seed every array is byte-identical to the
reference's.
"""

from __future__ import annotations

import numpy as np


def lm_batches(*, vocab_size: int, batch: int, seq_len: int, seed: int = 0,
               n_successors: int = 8):
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab_size, size=(vocab_size, n_successors))
    while True:
        toks = np.empty((batch, seq_len + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, vocab_size, size=batch)
        for t in range(seq_len):
            choice = rng.integers(0, n_successors, size=batch)
            nxt = succ[toks[:, t], choice]
            noise = rng.random(batch) < 0.1
            nxt = np.where(noise, rng.integers(0, vocab_size, size=batch),
                           nxt)
            toks[:, t + 1] = nxt
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
