"""K1/K3's range cutting, ``kernels.bm25_gather_score.span_ranges``.

The CUDA kernels K1 and K3 run one persistent CTA a (column group, range),
and each range is a run of whole spans (a block's fragments) of the
fragment table. The wrapper cuts the ranges on the table's device with
torch ops, by posting count; here the cut runs on the CPU and is held to
its contract: every span lands in exactly one range, the ranges follow
table order, each boundary is a span leader or the table's width, the
padding after the last span belongs to no range, and no range holds more
than its share of the postings plus one span. The tables are the host
plan's (``fragment_plan``) and the pruned regime's compacted table
(``compact_fragment_table``: surviving blocks first, zero padding after).
"""

import numpy as np
import pytest
import torch

from conftest import make_corpus
from repro_torch.core import BM25Params, build_index
from repro_torch.core.scoring import pad_queries
from repro_torch.kernels.bm25_gather_score import span_ranges
from repro_torch.sparse.block_csr import fragment_plan
from repro_torch.sparse.fragment_device import compact_fragment_table


def _table(kind: str) -> torch.Tensor:
    rng = np.random.default_rng(3)
    corpus = make_corpus(rng, n_docs=900, n_vocab=50, max_len=40)
    idx = build_index(corpus, 50, params=BM25Params())
    qs = [rng.integers(0, 50, size=5).astype(np.int32) for _ in range(8)]
    _, _, uniq = pad_queries(qs, 8, return_uniq=True)
    block_size, frag = (16, 8) if kind != "long" else (256, 2)
    desc = torch.as_tensor(fragment_plan(idx, uniq, block_size=block_size,
                                         frag=frag).desc)
    if kind == "compacted":          # every third block survives
        keep = (desc[3] % 3 == 0) & (desc[1] > 0)
        desc, _ = compact_fragment_table(desc, keep)
    return desc


def _spans(desc: torch.Tensor) -> list:
    """``(leader, end, postings)`` of each span, ``end`` exclusive (the
    next leader, or the first padding column after the last span)."""
    first = desc[4].tolist()
    valid = desc[1].clamp(min=0).tolist()
    real = [f for f, v in enumerate(valid) if v > 0]
    stop = real[-1] + 1 if real else 0
    leaders = [f for f in range(desc.shape[1]) if first[f] == 1]
    ends = leaders[1:] + [stop]
    return [(a, e, sum(valid[a:e])) for a, e in zip(leaders, ends)]


def _check(desc: torch.Tensor, n_ranges: int) -> None:
    nf = desc.shape[1]
    r = span_ranges(desc, n_ranges)
    assert r.dtype == torch.int32 and tuple(r.shape) == (n_ranges + 1,)
    r = r.tolist()
    spans = _spans(desc)
    first = desc[4].tolist()
    assert r[-1] == nf
    assert all(a <= b for a, b in zip(r, r[1:])), "ranges in table order"
    assert all(x == nf or first[x] == 1 for x in r), "boundaries lead spans"
    assert r[0] == (spans[0][0] if spans else nf)
    for a, _, _ in spans:            # each span in exactly one range
        assert sum(r[g] <= a < r[g + 1] for g in range(n_ranges)) == 1
    total = sum(p for _, _, p in spans)
    most = max((p for _, _, p in spans), default=0)
    for g in range(n_ranges):
        got = sum(p for a, _, p in spans if r[g] <= a < r[g + 1])
        assert got <= -(-total // n_ranges) + most


@pytest.mark.parametrize("kind", ["plan", "compacted", "long"])
@pytest.mark.parametrize("n_ranges", [1, 3, 7, 64, 4096])
def test_ranges_hold_whole_spans_in_order(kind, n_ranges):
    desc = _table(kind)
    assert int(desc[4].sum()) > 1
    _check(desc, n_ranges)


def test_ranges_of_padding_and_empty_tables_are_empty():
    for nf in (0, 8, 64):
        desc = torch.zeros((6, nf), dtype=torch.int32)
        for n_ranges in (1, 5):
            assert span_ranges(desc, n_ranges).tolist() == \
                [nf] * (n_ranges + 1)


def test_one_span_goes_to_one_range():
    """A single span never splits: the first range takes it, the others
    start past it, at the table's width."""
    desc = torch.zeros((6, 16), dtype=torch.int32)
    desc[1, :10] = 7                 # ten fragments of one block
    desc[4, 0] = 1
    desc[5, 9] = 1
    for n_ranges in (1, 2, 9):
        r = span_ranges(desc, n_ranges).tolist()
        assert r == [0] + [16] * n_ranges
        _check(desc, n_ranges)
