"""Crash-safe snapshots in the port (``repro_torch.sparse.snapshot``), held
against the JAX package and the scipy oracle on the CPU.

* **round trip** — five variants × f32/u8 block-max × mmap on/off: every
  array comes back bit for bit, a memmapped load hands torch no read-only
  array, and a retriever adopting the loaded index (``device_index=``)
  serves exact boards, bit for bit those of the retriever that saved it,
  with zero posting and descriptor bytes after the one upload per layout.
* **across packages** — a store written by ``repro.sparse.snapshot`` loads
  and serves exact in the port, and a store written by the port loads in
  ``repro`` (its host index and layouts equal, its scipy engine exact);
  for one index and checksum algorithm the data files are byte-identical
  and the manifests equal as parsed JSON, reordered or not, under crc32
  and xxh3_64.
* **formats** — version-1 stores load; a store whose checksum algorithm
  is not importable raises ``SnapshotVersionError``.
* **the recovery ladder** — every rung: a replica, a section rebuilt from
  the surviving layout, the permutation recomputed from signatures or
  dropped to identity, a full rebuild from ``corpus=``, a typed raise.
* **the fault sites** — ``snapshot.write`` (``torn_write``),
  ``snapshot.manifest`` (``manifest_corrupt``, ``stale_version``) and
  ``snapshot.array`` (``truncate``, ``bit_flip``) fire from the port's
  module with the reference's rungs, also on a reordered snapshot.
* **the engine** — ``RetrievalEngine.save`` / ``load`` for scipy and
  device shards, reordered shards, a shard rebuilt from its corpus slice.

No test compares against the live Pallas kernels (ROADMAP R1).
"""

import json
import os
import warnings

import numpy as np
import pytest

pytest.importorskip("jax")

from conftest import make_corpus  # noqa: E402
from repro.core import BM25Params as RefParams  # noqa: E402
from repro.core import ScipyBM25 as RefScipy  # noqa: E402
from repro.core import build_index as ref_build_index  # noqa: E402
from repro.serve import RetrievalEngine as RefEngine  # noqa: E402
from repro.sparse import snapshot as ref_snapshot  # noqa: E402
from repro.sparse.block_csr import DeviceIndex as RefDeviceIndex  # noqa: E402

from repro_torch.core import (BM25Params, ScipyBM25, build_index,  # noqa: E402
                              build_sharded_indexes, topk_numpy)
from repro_torch.serve import (DeviceRetriever, RetrievalEngine,  # noqa: E402
                               RetrievalError, SnapshotIntegrityError,
                               SnapshotVersionError)
from repro_torch.serve.faults import inject_faults  # noqa: E402
from repro_torch.sparse import reorder, snapshot  # noqa: E402
from repro_torch.sparse.block_csr import (TRANSFERS, DeviceIndex,  # noqa: E402
                                          reset_transfer_stats)

ALL_VARIANTS = ["robertson", "atire", "lucene", "bm25l", "bm25+"]
GEOM = dict(block_size=16, tile=16, frag=8)
RSMALL = dict(acc_block=16, q_max=8, device="cpu")
ALGOS = ["crc32", "xxh3_64"]


def _mk(rng, method="lucene", n_vocab=64, n_docs=90):
    corpus = make_corpus(rng, n_docs=n_docs, n_vocab=n_vocab, max_len=20)
    return corpus, build_index(corpus, n_vocab,
                               params=BM25Params(method=method))


def _queries(rng, n_vocab=64, n=3):
    return [rng.integers(0, n_vocab, size=rng.integers(1, 6)
                         ).astype(np.int32) for _ in range(n)]


def _di(idx, bmax_dtype="f32", reorder_mode="none"):
    return DeviceIndex.build(idx, device="cpu", bmax_dtype=bmax_dtype,
                             reorder=reorder_mode, **GEOM)


def _adopt(di, regime="auto", plan="device"):
    return DeviceRetriever(None, regime=regime, device_index=di, plan=plan,
                           **RSMALL)


def _check_exact(idx, qs, ids, vals, k):
    sc = ScipyBM25(idx)
    for i, q in enumerate(qs):
        ref = sc.score(q)
        _, ref_v = topk_numpy(ref[None], k)
        np.testing.assert_allclose(vals[i], ref_v[0], atol=1e-4)
        np.testing.assert_allclose(ref[ids[i] - idx.doc_offset], vals[i],
                                   atol=1e-4)


def _gen_dir(path):
    with open(os.path.join(path, "CURRENT"), encoding="utf-8") as fh:
        return os.path.join(path, json.load(fh)["generation"])


def _flip_byte(fname, offset=5):
    with open(fname, "r+b") as fh:
        fh.seek(offset)
        b = fh.read(1)
        fh.seek(offset)
        fh.write(bytes([b[0] ^ 0x10]))


def _same_boards(a, b):
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(np.asarray(a[1]).view(np.int32),
                                  np.asarray(b[1]).view(np.int32))


# -- round trip ------------------------------------------------------------------

@pytest.mark.parametrize("method", ALL_VARIANTS)
@pytest.mark.parametrize("bmax_dtype", ["f32", "u8"])
@pytest.mark.parametrize("mmap", [False, True])
def test_roundtrip_bit_identical_and_adopted_exact(method, bmax_dtype, mmap,
                                                   tmp_path, rng):
    _, idx = _mk(rng, method)
    di = _di(idx, bmax_dtype)
    path = str(tmp_path / "snap")
    di.save(path)
    reset_transfer_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # no read-only array to torch
        ld = DeviceIndex.load(path, mmap=mmap, device="cpu")
    # one upload per layout: padded CSC and the blocked layout
    assert TRANSFERS.posting_uploads == 5
    assert TRANSFERS.posting_bytes == sum(
        t.numel() * 4 for t in (di.csc_doc_ids, di.csc_scores, di.blk_tok,
                                di.blk_loc, di.blk_sc))
    rep = ld.snapshot_report
    assert rep["verified"] and not rep["hops"] and rep["mmap"] == mmap
    for f in ("indptr", "doc_ids", "scores", "nonoccurrence", "doc_lens"):
        np.testing.assert_array_equal(getattr(ld.host, f), getattr(idx, f))
    for f in ("csc_doc_ids", "csc_scores", "blk_tok", "blk_loc", "blk_sc"):
        assert getattr(ld, f).device.type == "cpu"
        np.testing.assert_array_equal(getattr(ld, f).numpy(),
                                      getattr(di, f).numpy())
    np.testing.assert_array_equal(ld.bmax.host, di.bmax.host)
    np.testing.assert_array_equal(ld.bmax.device.numpy(), di.bmax.host)
    assert ld.bmax.quantized == (bmax_dtype == "u8")
    if mmap:
        assert isinstance(ld.host.doc_ids.base, np.memmap) \
            or isinstance(ld.host.doc_ids, np.memmap)
    built = DeviceRetriever(idx, regime="auto", plan="device", **GEOM,
                            **RSMALL)
    dr = _adopt(ld)
    qs = _queries(rng)
    for regime in ("auto", "gathered", "blocked", "pruned"):
        a = dr.retrieve_batch(qs, 7, regime=regime)
        _same_boards(a, built.retrieve_batch(qs, 7, regime=regime))
        _check_exact(idx, qs, a.ids, a.scores, 7)
    reset_transfer_stats()
    dr.retrieve_batch(qs, 7)
    assert TRANSFERS.posting_bytes == TRANSFERS.descriptor_bytes == 0
    assert dr.health()["snapshot"]["generation"] == "gen-000001"


def test_adoption_resolves_to_the_layouts_the_snapshot_holds(tmp_path, rng):
    _, idx = _mk(rng)
    gathered = DeviceRetriever(idx, regime="gathered", plan="device",
                               **GEOM, **RSMALL)
    path = str(tmp_path / "g")
    assert gathered.save(path)["device"]["block_size"] == 16
    di = DeviceIndex.load(path, device="cpu")
    assert di.blk_tok is not None          # the save re-blocks the host
    blocked = DeviceRetriever(idx, regime="blocked", **GEOM, **RSMALL)
    blocked.save(str(tmp_path / "b"))
    ld = DeviceIndex.load(str(tmp_path / "b"), device="cpu")
    assert ld.bmax is None and ld.csc_doc_ids is not None
    dr = _adopt(ld)
    assert dr.regime == "auto"             # every layout a regime needs
    bare = DeviceIndex.build(idx, device="cpu", with_csc=False, **GEOM)
    assert _adopt(bare).regime == "blocked"


def test_load_host_arrays_drop_serves_exact(tmp_path, rng):
    _, idx = _mk(rng)
    path = str(tmp_path / "snap")
    _di(idx).save(path)
    ld = DeviceIndex.load(path, host_arrays="drop", device="cpu")
    assert ld.host.doc_ids.size == 0
    dr = _adopt(ld, regime="gathered", plan="host")
    assert dr.plan_mode == "device" and dr.gather_mode == "resident"
    qs = _queries(rng)
    ids, vals = dr.retrieve_batch(qs, 7)
    _check_exact(idx, qs, ids, vals, 7)


# -- across packages ---------------------------------------------------------------

@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("reorder_mode", ["none", "signature"])
def test_files_byte_identical_to_the_reference(algo, reorder_mode, tmp_path,
                                               rng):
    corpus, idx = _mk(rng, "bm25l")
    ref = ref_build_index(corpus, 64, params=RefParams(method="bm25l"))
    mine = _di(idx, "u8", reorder_mode)
    theirs = RefDeviceIndex.build(ref, bmax_dtype="u8", reorder=reorder_mode,
                                  **GEOM)
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    mine.save(a, algo=algo)
    ref_snapshot.save_device_index(theirs, b, algo=algo)
    ga, gb = _gen_dir(a), _gen_dir(b)
    files = sorted(os.listdir(ga))
    assert files == sorted(os.listdir(gb))
    assert ("perm.bin" in files) == (reorder_mode != "none")
    for f in files:
        if f.startswith("manifest"):
            with open(os.path.join(ga, f)) as fa, \
                    open(os.path.join(gb, f)) as fb:
                assert json.load(fa) == json.load(fb)
        else:
            with open(os.path.join(ga, f), "rb") as fa, \
                    open(os.path.join(gb, f), "rb") as fb:
                assert fa.read() == fb.read(), f


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("reorder_mode", ["none", "minhash"])
def test_reference_store_loads_and_serves_exact_in_the_port(algo,
                                                            reorder_mode,
                                                            tmp_path, rng):
    corpus, idx = _mk(rng, "robertson")
    ref = ref_build_index(corpus, 64, params=RefParams(method="robertson"))
    theirs = RefDeviceIndex.build(ref, reorder=reorder_mode, **GEOM)
    path = str(tmp_path / "ref")
    ref_snapshot.save_device_index(theirs, path, algo=algo)
    ld = DeviceIndex.load(path, mmap=True, device="cpu")
    assert ld.snapshot_report["algo"] == algo
    assert ld.reorder == reorder_mode
    if reorder_mode != "none":
        np.testing.assert_array_equal(ld.perm, np.asarray(theirs.perm))
    built = DeviceRetriever(idx, regime="auto", plan="device",
                            reorder=reorder_mode, **GEOM, **RSMALL)
    dr = _adopt(ld)
    qs = _queries(rng) + [np.zeros(0, np.int32)]
    for regime in ("gathered", "blocked", "pruned"):
        a = dr.retrieve_batch(qs, 9, regime=regime)
        _same_boards(a, built.retrieve_batch(qs, 9, regime=regime))
        _check_exact(idx, qs, a.ids, a.scores, 9)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("reorder_mode", ["none", "signature"])
def test_port_store_loads_and_serves_exact_in_the_reference(algo,
                                                            reorder_mode,
                                                            tmp_path, rng):
    corpus = make_corpus(rng, n_docs=80, n_vocab=64)
    p = BM25Params(method="atire")
    shards = build_sharded_indexes(corpus, 64, 2, params=p)
    eng = RetrievalEngine(shards, k=5, deadline_s=5.0, warmup=False,
                          scorer_opts=dict(reorder=reorder_mode, **GEOM,
                                           **RSMALL))
    qs = _queries(rng, n=4)
    mine = eng.retrieve_batch(qs)
    path = str(tmp_path / "engine")
    eng.save(path, algo=algo)
    # the reference's own loaders read every shard the port wrote ...
    for i, rt in enumerate(eng.runtimes):
        sdir = os.path.join(path, f"shard-{i:04d}")
        rd = ref_snapshot.load_device_index(sdir)
        di = rt._scorer.dindex
        assert rd.reorder == di.reorder
        for f in ("csc_doc_ids", "csc_scores", "blk_tok", "blk_loc",
                  "blk_sc"):
            np.testing.assert_array_equal(np.asarray(getattr(rd, f)),
                                          getattr(di, f).numpy())
        np.testing.assert_array_equal(rd.bmax.host, di.bmax.host)
        host = ref_snapshot.load_index(sdir)
        np.testing.assert_array_equal(host.doc_ids, shards[i].doc_ids)
        np.testing.assert_array_equal(host.scores, shards[i].scores)
    # ... and its scipy engine serves the port's store exactly
    theirs = RefEngine.load(path, scorer="scipy", deadline_s=5.0)
    ref_b = theirs.retrieve_batch(qs)
    np.testing.assert_allclose(ref_b.scores, mine.scores, atol=1e-5)
    full = build_index(corpus, 64, params=p)
    _check_exact(full, qs, ref_b.ids, ref_b.scores, 5)
    oracle = RefScipy(ref_build_index(corpus, 64,
                                      params=RefParams(method="atire")))
    for i, q in enumerate(qs):
        np.testing.assert_allclose(oracle.score(q)[mine.ids[i]],
                                   mine.scores[i], atol=1e-4)


# -- formats ------------------------------------------------------------------------

def _rewrite_manifest(path, edit):
    gen = _gen_dir(path)
    for name in ("manifest.json", "manifest.json.dup"):
        mpath = os.path.join(gen, name)
        with open(mpath, encoding="utf-8") as fh:
            m = json.load(fh)
        edit(m)
        m.pop("manifest_checksum", None)
        m["manifest_checksum"] = snapshot.manifest_checksum(m)
        with open(mpath, "w", encoding="utf-8") as fh:
            json.dump(m, fh)


@pytest.mark.parametrize("algo", ALGOS)
def test_version_1_store_loads(algo, tmp_path, rng):
    _, idx = _mk(rng)
    path = str(tmp_path / "v1")
    _di(idx).save(path, algo=algo)

    def to_v1(m):
        m["version"] = 1
        m["device"].pop("reorder")

    _rewrite_manifest(path, to_v1)
    ld = DeviceIndex.load(path, device="cpu")
    assert ld.perm is None and ld.reorder == "none"
    qs = _queries(rng)
    ids, vals = _adopt(ld).retrieve_batch(qs, 7)
    _check_exact(idx, qs, ids, vals, 7)


def test_missing_checksum_algorithm_is_a_version_error(tmp_path, rng,
                                                       monkeypatch):
    import builtins
    _, idx = _mk(rng)
    path = str(tmp_path / "x")
    _di(idx).save(path, algo="xxh3_64")
    assert snapshot.default_algo() in ALGOS
    real_import = builtins.__import__

    def no_xxhash(name, *a, **k):
        if name == "xxhash":
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_xxhash)
    assert snapshot.default_algo() == "crc32"
    with pytest.raises(SnapshotVersionError, match="xxhash"):
        DeviceIndex.load(path, device="cpu")
    with pytest.raises(SnapshotVersionError, match="unknown checksum"):
        snapshot.checksum_bytes(b"abc", "md5")


def test_every_manifest_bit_flip_recovers_via_the_replica(tmp_path, rng):
    """One seeded bit flipped in every byte of the manifest: each load
    verifies the manifest's checksum first, so every flip — in the
    format, version or ``algo`` field too — is corruption that the
    replica heals, never a version error or an untyped raise."""
    _, idx = _mk(rng, n_docs=30)
    path = str(tmp_path / "snap")
    snapshot.save_index(idx, path, **GEOM)
    mpath = os.path.join(_gen_dir(path), "manifest.json")
    with open(mpath, "rb") as fh:
        orig = fh.read()
    bits = np.random.default_rng(5).integers(0, 8, size=len(orig))
    for off, bit in enumerate(bits.tolist()):
        flipped = bytearray(orig)
        flipped[off] ^= 1 << bit
        with open(mpath, "wb") as fh:
            fh.write(bytes(flipped))
        ld = snapshot.load_index(path)
        assert ld.snapshot_report["hops"] == ["manifest<-dup"], off
        np.testing.assert_array_equal(ld.scores, idx.scores)


def test_unknown_algorithm_in_both_copies_is_a_version_error(tmp_path, rng):
    _, idx = _mk(rng)
    path = str(tmp_path / "snap")
    snapshot.save_index(idx, path, **GEOM)
    gen = _gen_dir(path)
    for name in ("manifest.json", "manifest.json.dup"):
        with open(os.path.join(gen, name), encoding="utf-8") as fh:
            m = json.load(fh)
        m["algo"] = "blake3"
        with open(os.path.join(gen, name), "w", encoding="utf-8") as fh:
            json.dump(m, fh)
    with pytest.raises(SnapshotVersionError, match="unknown checksum"):
        snapshot.load_index(path)


def test_stale_version_is_authoritative(tmp_path, rng):
    corpus, idx = _mk(rng)
    path = str(tmp_path / "snap")
    snapshot.save_index(idx, path, **GEOM)
    _rewrite_manifest(path, lambda m: m.update(version=snapshot.VERSION + 1))
    with pytest.raises(SnapshotVersionError, match="version"):
        snapshot.load_index(path, corpus=corpus)


# -- the recovery ladder, rung by rung ------------------------------------------------

def test_atomic_store_writes_generations_and_collects_garbage(tmp_path, rng):
    _, idx = _mk(rng)
    path = str(tmp_path / "snap")
    for _ in range(3):
        snapshot.save_index(idx, path, **GEOM)
    assert sorted(d for d in os.listdir(path) if d.startswith("gen-")) == \
        ["gen-000003"]
    os.makedirs(os.path.join(path, ".tmp-gen-000009.1"))   # crash debris
    snapshot.save_index(idx, path, **GEOM)
    assert sorted(os.listdir(path)) == ["CURRENT", "gen-000004"]


def test_recover_small_arrays_and_manifest_from_dup(tmp_path, rng):
    _, idx = _mk(rng)
    path = str(tmp_path / "snap")
    snapshot.save_index(idx, path, **GEOM)
    for name in ("index.indptr", "index.nonoccurrence", "index.doc_lens"):
        _flip_byte(os.path.join(_gen_dir(path), f"{name}.bin"))
        ld = snapshot.load_index(path)
        assert f"{name}<-dup" in ld.snapshot_report["hops"]
        np.testing.assert_array_equal(getattr(ld, name[6:]),
                                      getattr(idx, name[6:]))
        snapshot.save_index(idx, path, **GEOM)
    _flip_byte(os.path.join(_gen_dir(path), "manifest.json"), offset=40)
    ld = snapshot.load_index(path)
    assert "manifest<-dup" in ld.snapshot_report["hops"]
    np.testing.assert_array_equal(ld.doc_ids, idx.doc_ids)


@pytest.mark.parametrize("reorder_mode", ["none", "signature"])
def test_recover_sections_from_the_surviving_layout(reorder_mode, tmp_path,
                                                    rng):
    _, idx = _mk(rng, "atire")
    di = _di(idx, "u8", reorder_mode)
    path = str(tmp_path / "snap")
    qs = _queries(rng)
    want = _adopt(di).retrieve_batch(qs, 7)
    for victim, hop in (("csc.doc_ids.bin", "csc<-blocked"),
                        ("blocked.sc.bin", "blocked<-csc"),
                        ("bmax.host.bin", "bmax<-csc")):
        di.save(path)
        _flip_byte(os.path.join(_gen_dir(path), victim), offset=64)
        ld = DeviceIndex.load(path, device="cpu")
        assert hop in ld.snapshot_report["hops"]
        for f in ("csc_doc_ids", "csc_scores", "blk_tok", "blk_loc",
                  "blk_sc"):
            np.testing.assert_array_equal(getattr(ld, f).numpy(),
                                          getattr(di, f).numpy())
        np.testing.assert_array_equal(ld.bmax.host, di.bmax.host)
        _same_boards(_adopt(ld).retrieve_batch(qs, 7), want)


def test_double_corruption_rebuilds_from_corpus_or_raises_typed(tmp_path,
                                                                rng):
    corpus, idx = _mk(rng, "bm25l")
    path = str(tmp_path / "snap")
    _di(idx, reorder_mode="signature").save(path)
    gen = _gen_dir(path)
    _flip_byte(os.path.join(gen, "csc.scores.bin"), offset=64)
    _flip_byte(os.path.join(gen, "blocked.sc.bin"), offset=64)
    with pytest.raises(SnapshotIntegrityError) as ei:
        DeviceIndex.load(path, device="cpu")
    assert any("csc" in c or "blocked" in c for c in ei.value.corrupt)
    with pytest.raises(RetrievalError):
        snapshot.load_index(path)
    ld = DeviceIndex.load(path, corpus=corpus, device="cpu")
    assert ld.snapshot_report["full_rebuild"]
    assert ld.reorder == "signature" and ld.perm is not None
    qs = _queries(rng)
    ids, vals = _adopt(ld).retrieve_batch(qs, 7)
    _check_exact(idx, qs, ids, vals, 7)


def _reordered_snap(tmp_path, rng):
    _, idx = _mk(rng)
    r = DeviceRetriever(idx, regime="pruned", reorder="signature",
                        plan="host", **GEOM, **RSMALL)
    assert r.dindex.perm is not None
    path = str(tmp_path / "snap")
    r.save(path)
    return idx, r, path


def _serves_like(r, di, rng_seed=5):
    r2 = DeviceRetriever(None, regime="pruned", device_index=di,
                         plan="host", **RSMALL)
    qs = _queries(np.random.default_rng(rng_seed)) + [np.zeros(0, np.int32)]
    _same_boards(r2.retrieve_batch(qs, 7), r.retrieve_batch(qs, 7))
    return r2


def test_perm_rungs_dup_then_signatures(tmp_path, rng):
    idx, r, path = _reordered_snap(tmp_path, rng)
    gen = _gen_dir(path)
    _flip_byte(os.path.join(gen, "perm.bin"), offset=8)
    di = DeviceIndex.load(path, device="cpu")
    assert "perm<-dup" in di.snapshot_report["hops"]
    _serves_like(r, di)
    _flip_byte(os.path.join(gen, "perm.dup.bin"), offset=8)
    di = DeviceIndex.load(path, device="cpu")
    assert "perm<-signatures" in di.snapshot_report["hops"]
    np.testing.assert_array_equal(di.perm, r.dindex.perm)
    assert di.reorder == "signature"
    _serves_like(r, di)


def test_perm_checksum_mismatch_falls_to_identity(tmp_path, rng,
                                                  monkeypatch):
    idx, r, path = _reordered_snap(tmp_path, rng)
    gen = _gen_dir(path)
    _flip_byte(os.path.join(gen, "perm.bin"), offset=8)
    _flip_byte(os.path.join(gen, "perm.dup.bin"), offset=8)
    real = reorder.signature_permutation

    def drifted(index, *, mode="signature"):
        p = real(index, mode=mode)
        return None if p is None else p[::-1].copy()

    monkeypatch.setattr(reorder, "signature_permutation", drifted)
    di = DeviceIndex.load(path, device="cpu")
    assert "perm<-identity" in di.snapshot_report["hops"]
    assert di.perm is None and di.reorder == "none"
    qs = _queries(rng)
    ids, vals = DeviceRetriever(None, regime="pruned", device_index=di,
                                plan="host", **RSMALL).retrieve_batch(qs, 7)
    _check_exact(idx, qs, ids, vals, 7)


# -- the fault sites ------------------------------------------------------------------

def test_torn_write_guarded_vs_unguarded(tmp_path, rng):
    """Saves run outside any guard: a guarded torn_write never fires there;
    an unguarded one is the kill mid-save, and the previous generation
    survives it, whichever written file the seed picks."""
    _, idx = _mk(rng)
    path = str(tmp_path / "snap")
    di = _di(idx)
    di.save(path)
    with inject_faults({"site": "snapshot.write", "kind": "torn_write",
                        "times": 1, "seed": 0}) as sp:
        di.save(path)
    assert sp[0].fired == 0
    for seed in range(4):
        with inject_faults({"site": "snapshot.write", "kind": "torn_write",
                            "times": 1, "seed": seed,
                            "guarded": False}) as sp:
            with pytest.raises(OSError, match="injected"):
                di.save(path)
        assert sp[0].fired == 1
        ld = snapshot.load_index(path)
        assert not ld.snapshot_report["hops"]
        assert ld.snapshot_report["generation"] == "gen-000002"
        np.testing.assert_array_equal(ld.doc_ids, idx.doc_ids)
    di.save(path)
    assert snapshot.load_index(path).snapshot_report["generation"] == \
        "gen-000003"


def test_torn_first_save_is_typed(tmp_path, rng):
    _, idx = _mk(rng)
    path = str(tmp_path / "fresh")
    with inject_faults({"site": "snapshot.write", "kind": "torn_write",
                        "times": 1, "seed": 0, "guarded": False}):
        with pytest.raises(OSError):
            snapshot.save_index(idx, path, **GEOM)
    with pytest.raises(SnapshotIntegrityError):
        DeviceIndex.load(path, device="cpu")


@pytest.mark.parametrize("guarded", [True, False])
@pytest.mark.parametrize("kind", ["manifest_corrupt", "stale_version"])
def test_manifest_faults(kind, guarded, tmp_path, rng):
    _, idx = _mk(rng)
    path = str(tmp_path / "snap")
    snapshot.save_index(idx, path, **GEOM)
    with inject_faults({"site": "snapshot.manifest", "kind": kind,
                        "times": 1, "seed": 3, "guarded": guarded}) as sp:
        if kind == "stale_version":
            with pytest.raises(SnapshotVersionError):
                snapshot.load_index(path)
        else:
            ld = snapshot.load_index(path)
            assert "manifest<-dup" in ld.snapshot_report["hops"]
            np.testing.assert_array_equal(ld.doc_ids, idx.doc_ids)
    assert sp[0].fired == 1


@pytest.mark.parametrize("kind", ["truncate", "bit_flip"])
@pytest.mark.parametrize("seed", range(6))
def test_array_faults_recover_exact(kind, seed, tmp_path, rng):
    _, idx = _mk(rng)
    path = str(tmp_path / "snap")
    _di(idx).save(path)
    qs = _queries(rng)
    want = _adopt(_di(idx)).retrieve_batch(qs, 7)
    with inject_faults({"site": "snapshot.array", "kind": kind,
                        "times": 1, "seed": seed}) as sp:
        ld = DeviceIndex.load(path, device="cpu")
    assert sp[0].fired == 1 and ld.snapshot_report["hops"]
    for f in ("indptr", "doc_ids", "scores", "nonoccurrence", "doc_lens"):
        np.testing.assert_array_equal(getattr(ld.host, f), getattr(idx, f))
    _same_boards(_adopt(ld).retrieve_batch(qs, 7), want)


# The reference's reordered truncate case once failed for a reason never
# checked (ROADMAP R2): here every victim the seeds pick, on a reordered
# snapshot, must heal through the rung the module documents for it and
# serve bit for bit the retriever that saved it.
_RUNG_OF = {"perm": "perm<-dup", "csc.doc_ids": "csc<-blocked",
            "csc.scores": "csc<-blocked", "blocked.tok": "blocked<-csc",
            "blocked.loc": "blocked<-csc", "blocked.sc": "blocked<-csc",
            "bmax.host": "bmax<-csc", "bmax.scale": "bmax<-csc",
            "index.indptr": "index.indptr<-dup",
            "index.nonoccurrence": "index.nonoccurrence<-dup",
            "index.doc_lens": "index.doc_lens<-dup"}


@pytest.mark.parametrize("kind", ["truncate", "bit_flip"])
@pytest.mark.parametrize("seed", range(12))    # the reference's is 11
def test_reordered_array_faults_take_the_documented_rung(kind, seed,
                                                         tmp_path, rng):
    idx, r, path = _reordered_snap(tmp_path, rng)
    with inject_faults({"site": "snapshot.array", "kind": kind,
                        "times": 1, "seed": seed}) as sp:
        di = DeviceIndex.load(path, device="cpu")
    assert sp[0].fired == 1
    rep = di.snapshot_report
    assert len(rep["corrupt"]) <= 1 and rep["hops"]
    victims = {h.split("<-")[0] for h in rep["hops"]} | set(rep["corrupt"])
    for v in victims:
        if v in _RUNG_OF:
            assert _RUNG_OF[v] in rep["hops"], (v, rep)
    np.testing.assert_array_equal(di.perm, r.dindex.perm)
    _serves_like(r, di)


def test_counters_track_every_hop(tmp_path, rng):
    _, idx = _mk(rng)
    path = str(tmp_path / "snap")
    snapshot.reset_counters()
    snapshot.save_index(idx, path, **GEOM)
    snapshot.load_index(path)
    _flip_byte(os.path.join(_gen_dir(path), "index.indptr.bin"))
    snapshot.load_index(path)
    assert snapshot.COUNTERS["saves"] == 1
    assert snapshot.COUNTERS["loads"] == 2
    assert snapshot.COUNTERS["dup_recoveries"] == 1


# -- the engine ------------------------------------------------------------------------

@pytest.mark.parametrize("scorer,reorder_mode", [("scipy", "none"),
                                                 ("auto", "none"),
                                                 ("pruned", "signature")])
def test_engine_roundtrip(scorer, reorder_mode, tmp_path, rng):
    corpus = make_corpus(rng, n_docs=80, n_vocab=64)
    shards = build_sharded_indexes(corpus, 64, 2, params=BM25Params())
    opts = ({} if scorer == "scipy"
            else dict(reorder=reorder_mode, plan="device", **GEOM, **RSMALL))
    eng = RetrievalEngine(shards, k=5, deadline_s=5.0, scorer=scorer,
                          warmup=False, scorer_opts=opts)
    qs = _queries(rng, n=4)
    r0 = eng.retrieve_batch(qs)
    path = str(tmp_path / "engine")
    assert eng.save(path)["n_shards"] == 2
    eng2 = RetrievalEngine.load(path, mmap=True, warmup=False,
                                deadline_s=5.0, scorer_opts=opts)
    assert eng2.k == 5 and eng2.scorer == scorer
    r1 = eng2.retrieve_batch(qs)
    np.testing.assert_array_equal(r0.ids, r1.ids)
    np.testing.assert_array_equal(r0.scores, r1.scores)
    h = eng2.health()["shards"][0]["snapshot"]
    assert h["verified"] and h["generation"] == "gen-000001"
    for a, b in zip(eng2.shards, shards):     # client order, as saved
        np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
    eng2.rescale(3)
    np.testing.assert_array_equal(eng2.retrieve_batch(qs).scores, r0.scores)


def test_engine_load_recovers_shard_from_corpus_slice(tmp_path, rng):
    corpus = make_corpus(rng, n_docs=80, n_vocab=64)
    shards = build_sharded_indexes(corpus, 64, 2, params=BM25Params())
    eng = RetrievalEngine(shards, k=5, deadline_s=5.0, scorer="auto",
                          warmup=False, scorer_opts=dict(**GEOM, **RSMALL))
    qs = _queries(rng, n=4)
    r0 = eng.retrieve_batch(qs)
    path = str(tmp_path / "engine")
    eng.save(path)
    gen = _gen_dir(os.path.join(path, "shard-0001"))
    _flip_byte(os.path.join(gen, "csc.scores.bin"), offset=64)
    _flip_byte(os.path.join(gen, "blocked.sc.bin"), offset=64)
    eng2 = RetrievalEngine.load(path, corpus=corpus, deadline_s=5.0,
                                warmup=False,
                                scorer_opts=dict(**GEOM, **RSMALL))
    rep = eng2.runtimes[1]._scorer.dindex.snapshot_report
    assert rep["full_rebuild"]
    r1 = eng2.retrieve_batch(qs)
    np.testing.assert_array_equal(r0.ids, r1.ids)
    np.testing.assert_array_equal(r0.scores, r1.scores)


def test_engine_store_version_guard(tmp_path, rng):
    _, idx = _mk(rng)
    eng = RetrievalEngine([idx], k=3, scorer="scipy")
    path = str(tmp_path / "engine")
    eng.save(path)
    epath = os.path.join(path, "engine.json")
    with open(epath, encoding="utf-8") as fh:
        cfg = json.load(fh)
    cfg["version"] = 999
    with open(epath, "w", encoding="utf-8") as fh:
        json.dump(cfg, fh)
    with pytest.raises(SnapshotVersionError):
        RetrievalEngine.load(path)
