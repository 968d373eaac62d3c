"""The CUDA kernels against their plain torch twins, on the card.

Every test here carries the ``cuda`` marker and skips without an NVIDIA
GPU (a CUDA kernel has no CPU mode). On a machine with one, run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernels run on CUDA copies of the inputs, the twins on the CPU
tensors, and results must agree bit for bit: the kernels add in the same
fixed order as the CPU twins' ``index_add_`` and round each product and
sum separately. The file imports neither jax nor ``repro``, so it runs on
a machine that has only the port's dependencies.
"""

import numpy as np
import pytest
import torch

from conftest import make_corpus
from repro_torch.core import BM25Params, build_index
from repro_torch.core.scoring import pad_queries
from repro_torch.kernels import bm25_block_score as k2
from repro_torch.kernels import bm25_gather_score as k1
from repro_torch.serve import DeviceRetriever
from repro_torch.sparse.block_csr import (DeviceIndex, fragment_plan,
                                          pack_query_batch)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bits(a):
    a = a.cpu()
    return a.view(torch.int32) if a.dtype == torch.float32 else a


@pytest.mark.parametrize("method", ["robertson", "lucene", "bm25l"])
@pytest.mark.parametrize("k", [1, 7, 16])
def test_kernels_bitwise_equal_twins(cuda_device, method, k):
    rng = np.random.default_rng(k)
    corpus = make_corpus(rng, n_docs=1000, n_vocab=60, max_len=25)
    idx = build_index(corpus, 60, params=BM25Params(method=method))
    di = DeviceIndex.build(idx, device="cpu", block_size=16, tile=16,
                           frag=8)
    qs = [rng.integers(0, 60, size=rng.integers(0, 6)).astype(np.int32)
          for _ in range(16)]
    toks, wts, uniq = pad_queries(qs, 8, return_uniq=True)
    tab, w = pack_query_batch(toks, wts, 64, uniq=uniq)
    fp = fragment_plan(idx, uniq, block_size=16, frag=8)
    w_t = torch.as_tensor(w)
    cases = ((k1.bm25_resident_score_topk,
              (torch.as_tensor(fp.desc), w_t, di.csc_doc_ids, di.csc_scores),
              dict(frag=8)),
             (k2.bm25_block_score_topk,
              (di.blk_tok, di.blk_loc, di.blk_sc, torch.as_tensor(tab), w_t),
              {}))
    for fn, ops, extra in cases:
        kw = dict(block_size=16, k=k, n_docs=idx.n_docs, **extra)
        n0 = (k1.LAUNCHES.n, k2.LAUNCHES.n)
        ref = fn(*ops, **kw)
        got = fn(*(t.to(cuda_device) for t in ops), **kw)
        assert (k1.LAUNCHES.n + k2.LAUNCHES.n) == sum(n0) + 1
        for a, b in zip(got, ref):
            assert torch.equal(_bits(a), _bits(b))


def test_retriever_on_cuda_equals_cpu_twin_path(cuda_device):
    rng = np.random.default_rng(5)
    corpus = make_corpus(rng, n_docs=700, n_vocab=80, max_len=30)
    idx = build_index(corpus, 80, params=BM25Params(method="robertson"))
    queries = [rng.integers(0, 80, size=5).astype(np.int32)
               for _ in range(9)]
    for regime in ("gathered", "blocked"):
        on_gpu = DeviceRetriever(idx, regime=regime, block_size=64,
                                 device=cuda_device).retrieve_batch(queries,
                                                                    7)
        on_cpu = DeviceRetriever(idx, regime=regime, block_size=64,
                                 device="cpu").retrieve_batch(queries, 7)
        np.testing.assert_array_equal(on_gpu.ids, on_cpu.ids)
        np.testing.assert_array_equal(on_gpu.scores, on_cpu.scores)
