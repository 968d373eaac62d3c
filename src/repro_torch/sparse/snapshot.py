"""Crash-safe on-disk snapshots of the eager index (BM25S §3.3 save/load).

The availability half of the residency story: ``bm25s`` ships
``save``/``load(mmap=True)`` as a headline feature — a process restart
must cost a file read, not a full tokenize+build. This module gives
:class:`~.block_csr.DeviceIndex` the same property with the rigor of the
in-request faults: typed errors, exact recovery, deterministic injection.

The port's counterpart of ``repro.sparse.snapshot``: the same format,
files and manifests (a store written by either package loads in the
other, and for one index and checksum algorithm the data files are
byte-identical). Arrays stay numpy on disk and in memmaps; a device load
uploads them to a torch device through the counted
``put_posting_arrays`` / ``put_descriptor_array``, and a device layout
saved without its host copy is downloaded from the device first.

On-disk format (version 2; version-1 stores still load)
--------------------------------------------------------

A snapshot is a DIRECTORY; each save writes a fresh *generation* and
commits it with one atomic pointer flip::

    <path>/
      CURRENT                 # tiny JSON: {"generation": "gen-000001"}
      gen-000001/
        manifest.json         # + manifest.json.dup replica
        index.indptr.bin      # [V+1] <i8   (+ .dup.bin replica)
        index.nonoccurrence.bin  # [V] <f4  (+ .dup.bin)
        index.doc_lens.bin    # [n_docs] <i4 (+ .dup.bin)
        csc.doc_ids.bin       # [1, nnz_pad] <i4 — upload-ready padded CSC
        csc.scores.bin        # [1, nnz_pad] <f4
        perm.bin              # [n_docs] <i4 (+ .dup.bin) — v2, reordered
        blocked.tok.bin       # [nb, p_pad] <i4   (optional section)
        blocked.loc.bin       # [nb, p_pad] <i4
        blocked.sc.bin        # [nb, p_pad] <f4
        bmax.host.bin         # [V, nb_pad] <f4 or |u1 (optional section)
        bmax.scale.bin        # [V] <f4

Every array file is raw little-endian C-order bytes — exactly what
``np.memmap`` maps — and the CSC/blocked files store the PADDED layouts
``DeviceIndex.build`` would have produced, so a cold start uploads them
straight from the memmap through ``put_posting_arrays`` with no host-side
re-blocking (the unpadded ``BM25Index`` views are slices of the same
maps). The manifest records dtype/shape/byte-count and a per-array
checksum (xxh3_64 when ``xxhash`` is importable, crc32 otherwise — the
algorithm is recorded, never guessed) plus a checksum over its own
canonical JSON.

Doc-id reordering (version 2): an index built with
``DeviceIndex.build(reorder=...)`` (``sparse.reorder``) serves its
layouts in a PERMUTED doc-id space. On disk the ``index.*`` and
``csc.*`` sections always stay in CLIENT order — the order ``load_index``
hands back and the corpus rebuild rung reproduces — while ``blocked.*``
and ``bmax.*`` stay in the layout (permuted) order they are uploaded in.
The permutation itself is the ``perm`` array (``new_id -> old_id``, with
a ``.dup`` replica), and the manifest's device section records the
``reorder`` mode. Reordered device loads therefore pay one host-side
lexsort to re-permute the CSC before upload; unordered snapshots (the
default) keep the straight-from-memmap upload path. Version-1 stores
have no ``perm`` entry and load exactly as before.

Atomic write path
-----------------

``save`` writes everything into a temp sibling dir (``.tmp-gen-*``),
fsyncs every file and the dir, renames it to its generation name, fsyncs
the parent, and only then commits with a single ``os.replace`` of the
``CURRENT`` pointer (written via its own temp + fsync). A crash at ANY
point leaves ``CURRENT`` naming the previous intact generation — a
mid-save kill can never corrupt the last committed snapshot. Old
generations and crash debris are garbage-collected after the flip.

Recovery ladder (exact at every hop)
------------------------------------

Verification failures walk, in order, and record every hop:

1. **duplicate copy** — the manifest and the small ``index.*`` arrays
   carry byte-identical ``.dup`` replicas; a single corrupted copy falls
   back to its replica.
2. **rebuild from the surviving layout** — CSC and blocked store the same
   postings, so either rebuilds the other bit-exactly (``indptr`` comes
   back from blocked token counts, ``nonoccurrence`` is recomputed from
   df + params with ``build_index``'s exact f64→f32 formula, the
   block-max table rebuilds from the CSC arrays; a corrupt ``perm`` is
   recomputed from the client-order postings — the signature pass is a
   deterministic function of the index — and accepted only when its bytes
   reproduce the manifest checksum, else the load falls back to IDENTITY
   order and rebuilds the permuted layouts from the client-order CSC:
   exact either way, the fallback merely forfeits the reorder speedup).
3. **full rebuild from a provided ``corpus=``** — when both posting
   copies are gone.
4. **typed raise** — :class:`~..serve.errors.SnapshotIntegrityError`
   (listing the corrupt entries) or
   :class:`~..serve.errors.SnapshotVersionError` (unknown format /
   version / checksum algo; a well-formed manifest with a future version
   is authoritative — no dup retry, never reinterpreted).

Unlike the reference, the port verifies a manifest's own checksum before
it reads the format and the version: only a manifest that verifies is
authoritative, so a bit flipped in its ``format``, ``version`` or
``algo`` field is corruption that the replica recovers (the reference
refuses it as a version error, or raises ``KeyError`` when the flip hits
the ``algo`` key). A checksum algorithm that both copies name and this
build does not know is still a version error.

Hops land in the returned index's ``snapshot_report`` (surfaced by
``DeviceRetriever.health()``) and the module-level :data:`COUNTERS`.

Fault-injection lane (``repro_torch.serve.faults``)
---------------------------------------------

``snapshot.write`` (torn write: a file is truncated on disk and the save
raises before the commit point), ``snapshot.manifest``
(``manifest_corrupt`` / ``stale_version``) and ``snapshot.array``
(``truncate`` / ``bit_flip``) mutate the REAL files this module is about
to verify — pure functions of ``(seed, fire_count)`` — so tests and the
CI chaos job probe the whole save→crash→load→recover cycle end to end.
The sites use the standard zero-cost ``sys.modules`` peek.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import sys
import zlib
from dataclasses import dataclass, replace

import numpy as np

from ..serve.errors import SnapshotIntegrityError, SnapshotVersionError
from ..device import resolve_device
from .block_csr import (
    BlockMaxTable,
    DeviceIndex,
    _round_up,
    block_postings_from_index,
    build_block_max,
    put_descriptor_array,
    put_posting_arrays,
)

FORMAT = "repro-bm25s-snapshot"
VERSION = 2
_CHUNK = 1 << 22            # checksum/read granularity (4 MiB)
_DUP_ARRAYS = ("index.indptr", "index.nonoccurrence", "index.doc_lens",
               "perm")

# load/save observability (mirrors faults.FIRED's role for the I/O lane)
COUNTERS = {
    "saves": 0,
    "loads": 0,
    "dup_recoveries": 0,       # manifest or array served from its replica
    "section_rebuilds": 0,     # layout rebuilt from the surviving layout
    "full_rebuilds": 0,        # rebuilt from a provided corpus
    "integrity_failures": 0,   # typed SnapshotIntegrityError raises
    "version_failures": 0,     # typed SnapshotVersionError raises
}


def reset_counters() -> dict:
    for k in COUNTERS:
        COUNTERS[k] = 0
    return COUNTERS


# -- checksums ----------------------------------------------------------------

class _Crc32:
    """hashlib-shaped zlib.crc32 accumulator (stdlib fallback algo)."""

    def __init__(self):
        self._v = 0

    def update(self, data) -> None:
        self._v = zlib.crc32(data, self._v)

    def hexdigest(self) -> str:
        return f"{self._v & 0xFFFFFFFF:08x}"


def default_algo() -> str:
    try:
        import xxhash  # noqa: F401
        return "xxh3_64"
    except ImportError:
        return "crc32"


def _new_hasher(algo: str):
    if algo == "xxh3_64":
        try:
            import xxhash
        except ImportError as e:
            COUNTERS["version_failures"] += 1
            raise SnapshotVersionError(
                "snapshot uses xxh3_64 checksums but xxhash is not "
                "importable in this environment") from e
        return xxhash.xxh3_64()
    if algo == "crc32":
        return _Crc32()
    COUNTERS["version_failures"] += 1
    raise SnapshotVersionError(f"unknown checksum algorithm {algo!r}")


def checksum_bytes(data, algo: str) -> str:
    h = _new_hasher(algo)
    mv = memoryview(data).cast("B")
    for off in range(0, len(mv), _CHUNK):
        h.update(mv[off:off + _CHUNK])
    return h.hexdigest()


def checksum_file(path: str, algo: str) -> str:
    h = _new_hasher(algo)
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def manifest_checksum(manifest: dict) -> str:
    """Checksum over the manifest's canonical JSON (sans the field itself).

    Canonical form (sorted keys, compact separators) — a whitespace-only
    file mutation that still parses to the same content is harmless by
    construction, a content mutation always mismatches.
    """
    body = {k: v for k, v in manifest.items() if k != "manifest_checksum"}
    payload = json.dumps(body, sort_keys=True,
                         separators=(",", ":")).encode("utf-8")
    return checksum_bytes(payload, manifest["algo"])


# -- atomic write path --------------------------------------------------------

def _as_le(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    return a


def _write_file(dirpath: str, name: str, data) -> str:
    p = os.path.join(dirpath, name)
    with open(p, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    return p


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _gc(path: str, *, keep: str | None) -> None:
    """Best-effort removal of crash debris and superseded generations."""
    for entry in os.listdir(path):
        full = os.path.join(path, entry)
        stale_tmp = entry.startswith(".tmp-") or entry == "CURRENT.tmp"
        old_gen = (entry.startswith("gen-") and entry != keep
                   and keep is not None)
        if stale_tmp or old_gen:
            with contextlib.suppress(OSError):
                if os.path.isdir(full):
                    shutil.rmtree(full, ignore_errors=True)
                else:
                    os.unlink(full)


def _next_generation(path: str) -> str:
    gens = [int(e[4:]) for e in os.listdir(path)
            if e.startswith("gen-") and e[4:].isdigit()]
    return f"gen-{(max(gens) + 1 if gens else 1):06d}"


def _write_generation(path: str, arrays: dict, body: dict, algo: str) -> dict:
    """Write one generation and atomically commit the CURRENT pointer.

    ``arrays`` maps manifest names to numpy arrays (names listed in
    ``_DUP_ARRAYS`` get a byte-identical ``.dup.bin`` replica). Returns
    the committed manifest. Fault site ``snapshot.write`` fires once with
    the list of files just written, BEFORE the commit point — an armed
    torn-write fault truncates one of them and raises, which is exactly
    what a mid-save kill leaves behind: debris, and the previous
    generation still committed.
    """
    os.makedirs(path, exist_ok=True)
    _gc(path, keep=None)                       # debris from earlier crashes
    gen = _next_generation(path)
    tmp = os.path.join(path, f".tmp-{gen}.{os.getpid()}")
    os.makedirs(tmp)
    specs: dict[str, dict] = {}
    written: list[str] = []
    for name, arr in arrays.items():
        arr = _as_le(np.asarray(arr))
        data = arr.tobytes()
        fname = f"{name}.bin"
        written.append(_write_file(tmp, fname, data))
        spec = {"file": fname, "dtype": arr.dtype.str,
                "shape": list(arr.shape), "nbytes": len(data),
                "checksum": checksum_bytes(data, algo)}
        if name in _DUP_ARRAYS:
            spec["dup"] = f"{name}.dup.bin"
            written.append(_write_file(tmp, spec["dup"], data))
        specs[name] = spec
    manifest = {"format": FORMAT, "version": VERSION, "algo": algo,
                **body, "arrays": specs}
    manifest["manifest_checksum"] = manifest_checksum(manifest)
    mdata = json.dumps(manifest, indent=1, sort_keys=True).encode("utf-8")
    written.append(_write_file(tmp, "manifest.json", mdata))
    _write_file(tmp, "manifest.json.dup", mdata)
    _fsync_dir(tmp)
    _f = sys.modules.get("repro_torch.serve.faults")
    if _f is not None and _f.ACTIVE:
        _f.fire("snapshot.write", written)
    os.rename(tmp, os.path.join(path, gen))
    _fsync_dir(path)
    cur = json.dumps({"generation": gen}).encode("utf-8")
    _write_file(path, "CURRENT.tmp", cur)
    os.replace(os.path.join(path, "CURRENT.tmp"),
               os.path.join(path, "CURRENT"))          # the commit point
    _fsync_dir(path)
    _gc(path, keep=gen)
    COUNTERS["saves"] += 1
    return manifest


def _host_array(t) -> np.ndarray:
    """A resident layout (a torch tensor on any device) as numpy."""
    return t.cpu().numpy()


def _padded_csc(index, frag: int) -> tuple[np.ndarray, np.ndarray]:
    """Host CSC arrays in DeviceIndex.build's padded [1, nnz_pad] layout."""
    nnz = int(index.doc_ids.size)
    nnz_pad = _round_up(max(nnz, 1), frag) + frag
    doc = np.zeros((1, nnz_pad), np.int32)
    sc = np.zeros((1, nnz_pad), np.float32)
    doc[0, :nnz] = index.doc_ids
    sc[0, :nnz] = index.scores
    return doc, sc


def _manifest_body(index, *, block_size: int, tile_p: int, frag: int,
                   nnz: int, nnz_pad: int, with_blocked: bool,
                   bmax_meta: dict | None, reorder: str = "none") -> dict:
    # exactness proof computed at SAVE time: the nonoccurrence<-recompute
    # recovery hop replays build_index's formula from the LOCAL df/n_docs,
    # which diverges for shards built with global stats — the hop is
    # offered only when the replay reproduces the stored vector bit-for-bit
    # (always true for single-shard builds and for sparse variants, whose
    # vector is identically zero)
    recomputable = bool(np.array_equal(
        _recompute_nonoccurrence(np.asarray(index.indptr),
                                 int(index.n_docs), index.params),
        np.asarray(index.nonoccurrence)))
    return {
        "index": {
            "n_docs": int(index.n_docs), "n_vocab": int(index.n_vocab),
            "l_avg": float(index.l_avg), "variant": str(index.variant),
            "doc_offset": int(index.doc_offset),
            "nonocc_recomputable": recomputable,
            "params": {"k1": index.params.k1, "b": index.params.b,
                       "delta": index.params.delta,
                       "method": index.params.method},
        },
        "device": {
            "block_size": int(block_size), "tile_p": int(tile_p),
            "frag": int(frag), "nnz": int(nnz), "nnz_pad": int(nnz_pad),
            "with_blocked": bool(with_blocked), "bmax": bmax_meta,
            "reorder": str(reorder),
        },
    }


def save_device_index(di: DeviceIndex, path: str, *, index=None,
                      algo: str | None = None) -> dict:
    """Snapshot a DeviceIndex's layouts (host copies preferred, device
    copies downloaded when the host side was dropped). For a DeviceIndex
    built with ``reorder=``, the passed ``index`` is the PERMUTED serving
    copy (``di.host``): the ``index.*``/``csc.*`` sections are unpermuted
    back to CLIENT order on the way out, ``blocked.*``/``bmax.*`` keep
    the layout order they serve in, and the ``perm`` array (+ ``.dup``)
    joins the store. Returns the committed manifest."""
    index = index if index is not None else di.host
    if index is None:
        raise ValueError(
            "save_device_index needs host metadata; the DeviceIndex was "
            "built with host_arrays='drop' — pass the retriever's stripped "
            "index via index=")
    algo = algo or default_algo()
    perm = getattr(di, "perm", None)
    reorder = getattr(di, "reorder", "none") if perm is not None else "none"
    nnz = int(index.indptr[-1])
    host_intact = int(index.doc_ids.size) == nnz
    # one full posting copy in the LAYOUT (permuted) order
    if host_intact:
        index_l = index
    elif di.csc_doc_ids is not None:
        index_l = replace(index,
                          doc_ids=_host_array(di.csc_doc_ids)[0, :nnz],
                          scores=_host_array(di.csc_scores)[0, :nnz])
    else:
        raise ValueError("no intact posting copy to snapshot (host arrays "
                         "stripped and no resident CSC layout)")
    if perm is not None:
        # disk keeps index.*/csc.* in CLIENT order — load_index returns
        # client ids untouched, the corpus rebuild rung reproduces the
        # files bit-exactly, and a lost perm stays recomputable
        from .reorder import unpermute_index
        index_c = unpermute_index(index_l, perm)
    else:
        index_c = index_l
    if di.csc_doc_ids is not None and perm is None:
        doc_pad = _host_array(di.csc_doc_ids)
        sc_pad = _host_array(di.csc_scores)
    else:
        doc_pad, sc_pad = _padded_csc(index_c, di.frag)
    if di.blk_tok is not None:
        blk = (_host_array(di.blk_tok), _host_array(di.blk_loc),
               _host_array(di.blk_sc))
    elif host_intact:
        bp = block_postings_from_index(index_l, block_size=di.block_size,
                                       tile=di.tile_p)
        blk = (bp.token_ids, bp.local_doc, bp.scores)
    else:
        blk = None
    bmax_meta = None
    arrays = {
        "index.indptr": index_c.indptr,
        "index.nonoccurrence": index_c.nonoccurrence,
        "index.doc_lens": index_c.doc_lens,
        "csc.doc_ids": doc_pad,
        "csc.scores": sc_pad,
    }
    if perm is not None:
        arrays["perm"] = np.asarray(perm).astype(np.int32)
    if blk is not None:
        arrays["blocked.tok"], arrays["blocked.loc"], arrays["blocked.sc"] \
            = blk
    if di.bmax is not None:
        bm = di.bmax
        bmax_meta = {"quantized": bool(bm.quantized),
                     "n_blocks": int(bm.n_blocks), "nb_pad": int(bm.nb_pad),
                     "over_budget": bool(bm.over_budget)}
        arrays["bmax.host"] = bm.host
        arrays["bmax.scale"] = bm.scale
    body = _manifest_body(index_c, block_size=di.block_size,
                          tile_p=di.tile_p, frag=di.frag, nnz=nnz,
                          nnz_pad=int(doc_pad.shape[1]),
                          with_blocked=blk is not None, bmax_meta=bmax_meta,
                          reorder=reorder)
    return _write_generation(path, arrays, body, algo)


def save_index(index, path: str, *, block_size: int = 512, tile: int = 512,
               frag: int = 512, with_blocked: bool = True,
               algo: str | None = None) -> dict:
    """Snapshot a bare BM25Index (no device involvement — scipy shards)."""
    algo = algo or default_algo()
    doc_pad, sc_pad = _padded_csc(index, frag)
    arrays = {
        "index.indptr": index.indptr,
        "index.nonoccurrence": index.nonoccurrence,
        "index.doc_lens": index.doc_lens,
        "csc.doc_ids": doc_pad,
        "csc.scores": sc_pad,
    }
    tile_p = tile
    if with_blocked:
        bp = block_postings_from_index(index, block_size=block_size,
                                       tile=tile)
        tile_p = min(tile, bp.nnz_pad)
        arrays["blocked.tok"] = bp.token_ids
        arrays["blocked.loc"] = bp.local_doc
        arrays["blocked.sc"] = bp.scores
    body = _manifest_body(index, block_size=block_size, tile_p=tile_p,
                          frag=frag, nnz=int(index.doc_ids.size),
                          nnz_pad=int(doc_pad.shape[1]),
                          with_blocked=with_blocked, bmax_meta=None)
    return _write_generation(path, arrays, body, algo)


# -- verified read + recovery ladder ------------------------------------------

_ALGOS = ("xxh3_64", "crc32")


class _Unverifiable(SnapshotIntegrityError):
    """A manifest whose checksum algorithm is missing or unknown: corrupt,
    or written with an algorithm this build lacks (its replica decides)."""


def _parse_manifest(mpath: str) -> dict:
    """A manifest whose own checksum verifies, or a typed raise.

    The checksum is verified before the format and the version are read,
    so a manifest that verifies is authoritative (a future version is a
    :class:`SnapshotVersionError`, and no replica is consulted), while a
    bit flipped anywhere else — in the format or version value, or in the
    ``algo`` key or value — is a :class:`SnapshotIntegrityError` that the
    replica recovers.
    """
    with open(mpath, encoding="utf-8") as fh:
        m = json.load(fh)
    algo = m.get("algo") if isinstance(m, dict) else None
    if algo not in _ALGOS:
        raise _Unverifiable(f"{mpath}: checksum algorithm {algo!r} is "
                            f"unknown", corrupt=["manifest"])
    if manifest_checksum(m) != m.get("manifest_checksum"):
        raise SnapshotIntegrityError(f"{mpath}: manifest checksum mismatch",
                                     corrupt=["manifest"])
    fmt = m.get("format")
    if fmt != FORMAT:
        COUNTERS["version_failures"] += 1
        raise SnapshotVersionError(
            f"{mpath}: not a {FORMAT} manifest (format={fmt!r})")
    v = m.get("version")
    if not isinstance(v, int) or not 1 <= v <= VERSION:
        COUNTERS["version_failures"] += 1
        raise SnapshotVersionError(
            f"{mpath}: snapshot version {v!r} not supported "
            f"(this build reads versions 1..{VERSION})")
    return m


def _read_manifest(gen_dir: str, hops: list[str]) -> dict:
    mpath = os.path.join(gen_dir, "manifest.json")
    _f = sys.modules.get("repro_torch.serve.faults")
    if _f is not None and _f.ACTIVE:
        _f.fire("snapshot.manifest", mpath)
    try:
        return _parse_manifest(mpath)
    except SnapshotVersionError:
        raise                       # authoritative — a replica can't help
    except (SnapshotIntegrityError, OSError, ValueError) as primary_err:
        try:
            m = _parse_manifest(mpath + ".dup")
        except SnapshotVersionError:
            raise
        except _Unverifiable as e:
            if isinstance(primary_err, _Unverifiable):
                # both copies name an algorithm this build does not know
                COUNTERS["version_failures"] += 1
                raise SnapshotVersionError(
                    f"{mpath}: unknown checksum algorithm ({e})") from e
            COUNTERS["integrity_failures"] += 1
            raise SnapshotIntegrityError(
                f"{mpath}: manifest and replica both unreadable "
                f"({primary_err})", corrupt=["manifest"]) from primary_err
        except (SnapshotIntegrityError, OSError, ValueError):
            COUNTERS["integrity_failures"] += 1
            raise SnapshotIntegrityError(
                f"{mpath}: manifest and replica both unreadable "
                f"({primary_err})", corrupt=["manifest"]) from primary_err
        hops.append("manifest<-dup")
        COUNTERS["dup_recoveries"] += 1
        return m


def _file_ok(path: str, spec: dict, algo: str, verify: bool) -> bool:
    try:
        if os.path.getsize(path) != int(spec["nbytes"]):
            return False
        if verify and int(spec["nbytes"]) > 0:
            return checksum_file(path, algo) == spec["checksum"]
        return True
    except OSError:
        return False


def _load_array(path: str, spec: dict, mmap: bool) -> np.ndarray:
    shape = tuple(spec["shape"])
    dtype = np.dtype(spec["dtype"])
    if int(spec["nbytes"]) == 0:
        return np.zeros(shape, dtype)        # np.memmap rejects empty files
    if mmap:
        return np.memmap(path, dtype=dtype, mode="r", shape=shape)
    with open(path, "rb") as fh:
        return np.fromfile(fh, dtype=dtype).reshape(shape)


def _indptr_from_blocked(blk_tok: np.ndarray, n_vocab: int) -> np.ndarray:
    t = blk_tok[blk_tok >= 0].astype(np.int64)
    indptr = np.zeros(n_vocab + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(t, minlength=n_vocab))
    return indptr


def _csc_from_blocked(blk_tok, blk_loc, blk_sc, *, block_size: int,
                      nnz: int, nnz_pad: int, perm=None):
    """Bit-exact CSC posting arrays back out of the blocked layout.

    Blocked holds the same (token, doc, score) triples; a stable lexsort
    by (token, doc) restores the CSC invariant exactly, so the recovered
    stream is byte-identical to what was lost. For a reordered snapshot
    the blocked layout lives in the PERMUTED id space while the CSC
    section is stored in client order — ``perm`` maps each recovered doc
    id back before the sort, keeping the recovery bit-exact. Returns
    padded ``[1, nnz_pad]`` arrays, or None when the posting counts
    disagree (an internally inconsistent donor — fall through to corpus
    rebuild).
    """
    mask = blk_tok >= 0
    t = blk_tok[mask].astype(np.int64)
    if int(t.size) != nnz:
        return None
    blk_of = np.broadcast_to(
        np.arange(blk_tok.shape[0], dtype=np.int64)[:, None], blk_tok.shape)
    d = (blk_of * block_size + blk_loc)[mask]
    if perm is not None:
        d = np.asarray(perm).astype(np.int64)[d]
    s = blk_sc[mask]
    order = np.lexsort((d, t))
    doc_pad = np.zeros((1, nnz_pad), np.int32)
    sc_pad = np.zeros((1, nnz_pad), np.float32)
    doc_pad[0, :nnz] = d[order]
    sc_pad[0, :nnz] = s[order]
    return doc_pad, sc_pad


def _recompute_nonoccurrence(indptr: np.ndarray, n_docs: int,
                             params) -> np.ndarray:
    """Replay build_index's exact nonoccurrence formula (f64 → f32)."""
    from ..core.variants import get_variant
    variant = get_variant(params.method)
    df = np.diff(indptr).astype(np.float64)
    nonocc = np.where(
        df > 0, variant.nonoccurrence(np.maximum(df, 1.0), n_docs, params),
        0.0)
    return nonocc.astype(np.float32)


@dataclass
class _Loaded:
    """Everything _read_snapshot recovered, ready to wrap or upload."""

    index: object                   # BM25Index (memmap-backed when mmap)
    csc_doc: np.ndarray | None      # [1, nnz_pad] (None after full rebuild)
    csc_sc: np.ndarray | None
    blk: tuple | None               # (tok, loc, sc) or None
    bmax_host: np.ndarray | None
    bmax_scale: np.ndarray | None
    bmax_meta: dict | None
    bmax_rebuild: bool              # bmax section corrupt — rebuild on load
    manifest: dict
    report: dict
    full_rebuild: bool
    perm: np.ndarray | None = None  # new_id -> old_id (index stays CLIENT
    #                                 order; device loads re-permute)
    reorder: str = "none"           # manifest's recorded reorder mode


def _read_snapshot(path: str, *, mmap: bool, verify: bool,
                   corpus) -> _Loaded:
    from ..core.index import BM25Index, build_index
    from ..core.variants import BM25Params

    hops: list[str] = []
    _f = sys.modules.get("repro_torch.serve.faults")
    scope = _f.guard() if _f is not None else contextlib.nullcontext()

    with scope:     # guarded I/O faults fire only where recovery exists
        cur_path = os.path.join(path, "CURRENT")
        try:
            with open(cur_path, encoding="utf-8") as fh:
                gen = json.load(fh)["generation"]
            gen_dir = os.path.join(path, gen)
            if not os.path.isdir(gen_dir):
                raise OSError(f"generation dir {gen_dir} missing")
        except (OSError, ValueError, KeyError) as e:
            COUNTERS["integrity_failures"] += 1
            raise SnapshotIntegrityError(
                f"no committed snapshot at {path!r} ({e})",
                corrupt=["CURRENT"]) from e
        manifest = _read_manifest(gen_dir, hops)
        algo = manifest["algo"]
        _new_hasher(algo)           # unknown algo → typed version error
        arrays: dict[str, dict] = manifest["arrays"]
        primaries = [os.path.join(gen_dir, s["file"])
                     for s in arrays.values()]
        if _f is not None and _f.ACTIVE:
            _f.fire("snapshot.array", primaries)
        # verify every file; small arrays fall back to their replicas
        usable: dict[str, str] = {}
        bad: set[str] = set()
        for name, spec in arrays.items():
            p = os.path.join(gen_dir, spec["file"])
            if _file_ok(p, spec, algo, verify):
                usable[name] = p
            elif spec.get("dup") and _file_ok(
                    os.path.join(gen_dir, spec["dup"]), spec, algo, verify):
                usable[name] = os.path.join(gen_dir, spec["dup"])
                hops.append(f"{name}<-dup")
                COUNTERS["dup_recoveries"] += 1
            else:
                bad.add(name)

    mi = manifest["index"]
    dev = manifest["device"]
    params = BM25Params(**mi["params"])
    n_vocab = int(mi["n_vocab"])
    n_docs = int(mi["n_docs"])
    nnz, nnz_pad = int(dev["nnz"]), int(dev["nnz_pad"])
    block_size = int(dev["block_size"])

    def arr(name: str) -> np.ndarray:
        return _load_array(usable[name], arrays[name], mmap)

    blocked_present = "blocked.tok" in arrays
    blocked_names = {"blocked.tok", "blocked.loc", "blocked.sc"}
    blocked_ok = blocked_present and not (bad & blocked_names)
    csc_ok = not (bad & {"csc.doc_ids", "csc.scores"})
    recovered: dict[str, str] = {}
    full = False

    # -- perm, stage 1 (v2 reordered stores): file-level resolution.
    # blocked.*/bmax.* live in the PERMUTED doc space, index.*/csc.* in
    # client order — cross-layout recovery below needs the map between
    # them, so resolve the perm file (primary, then its .dup, both already
    # folded into usable/bad) before any posting rung runs.
    from .reorder import is_permutation, signature_permutation
    perm_present = "perm" in arrays
    perm_arr = None
    perm_file_ok = False
    if perm_present and "perm" not in bad:
        cand = np.asarray(arr("perm"))
        if is_permutation(cand, n_docs):
            perm_arr, perm_file_ok = cand.astype(np.int32), True
        else:
            bad.add("perm")     # invalid bytes slipped past verify=False

    blk = None
    if blocked_ok:
        blk = (arr("blocked.tok"), arr("blocked.loc"), arr("blocked.sc"))

    if "index.indptr" in bad:
        if blocked_ok:
            indptr = _indptr_from_blocked(blk[0], n_vocab)
            recovered["index.indptr"] = "blocked"
        else:
            full = True
    else:
        indptr = arr("index.indptr")

    csc_doc = csc_sc = None
    if csc_ok:
        csc_doc, csc_sc = arr("csc.doc_ids"), arr("csc.scores")
    elif blocked_ok and not full and (perm_file_ok or not perm_present):
        # a reordered snapshot's blocked layout holds PERMUTED doc ids —
        # without a trustworthy perm the client-order CSC can't come back
        # from it (and the perm recompute rung needs the CSC), so that
        # double corruption falls through to the corpus rung
        rebuilt = _csc_from_blocked(*blk, block_size=block_size, nnz=nnz,
                                    nnz_pad=nnz_pad, perm=perm_arr)
        if rebuilt is None:
            full = True
        else:
            csc_doc, csc_sc = rebuilt
            recovered["csc"] = "blocked"
    else:
        full = True

    if "index.nonoccurrence" in bad:
        # the replay is exact only when the save-time proof says so (a
        # shard built with GLOBAL stats stores a vector the local-df
        # replay cannot reproduce — fall through to the corpus rung)
        if not full and mi.get("nonocc_recomputable", False):
            nonocc = _recompute_nonoccurrence(indptr, n_docs, params)
            recovered["index.nonoccurrence"] = "recomputed"
        else:
            full = True
    else:
        nonocc = arr("index.nonoccurrence")

    if "index.doc_lens" in bad:
        full = True                 # replica failed too — not derivable
    else:
        doc_lens = arr("index.doc_lens")

    if full:
        if corpus is None:
            COUNTERS["integrity_failures"] += 1
            raise SnapshotIntegrityError(
                f"snapshot at {path!r} has unrecoverable corruption "
                f"({sorted(bad)}) and no corpus= was provided for a full "
                f"rebuild", corrupt=sorted(bad))
        # ``corpus`` is the FULL tokenized corpus the index came from:
        # stats are global (shards score with global df/N/L_avg) and the
        # shard's own documents are the manifest-recorded slice — exact
        # for single-shard and sharded builds alike
        from ..core.index import CorpusStats
        off = int(mi["doc_offset"])
        stats = CorpusStats.from_corpus(corpus, n_vocab)
        index = build_index(corpus[off:off + n_docs], n_vocab,
                            params=params, stats=stats, doc_offset=off)
        recovered["full"] = "corpus"
        COUNTERS["full_rebuilds"] += 1
        COUNTERS["loads"] += 1
        report = {"path": path, "generation": gen, "mmap": bool(mmap),
                  "verified": bool(verify), "algo": algo,
                  "corrupt": sorted(bad), "recovered": recovered,
                  "hops": hops + ["full<-corpus"], "full_rebuild": True}
        return _Loaded(index=index, csc_doc=None, csc_sc=None, blk=None,
                       bmax_host=None, bmax_scale=None,
                       bmax_meta=dev.get("bmax"), bmax_rebuild=False,
                       manifest=manifest, report=report, full_rebuild=True,
                       perm=None, reorder=str(dev.get("reorder", "none")))

    index = BM25Index(
        indptr=indptr, doc_ids=csc_doc[0, :nnz], scores=csc_sc[0, :nnz],
        nonoccurrence=nonocc, doc_lens=doc_lens, n_docs=n_docs,
        n_vocab=n_vocab, l_avg=float(mi["l_avg"]),
        variant=str(mi["variant"]), params=params,
        doc_offset=int(mi["doc_offset"]))

    # -- perm, stage 2: both copies corrupt — recompute the signature
    # pass from the recovered client-order postings (a deterministic
    # function of the index) and accept it ONLY when its bytes reproduce
    # the manifest checksum. Otherwise serve in IDENTITY order: the
    # on-disk permuted blocked/bmax layouts index an unmappable doc space,
    # so they are dropped and rebuilt from the client-order CSC below —
    # exact either way, identity merely forfeits the reorder speedup.
    perm = perm_arr
    perm_dropped = False
    if perm_present and not perm_file_ok:
        mode = str(dev.get("reorder", "none"))
        cand = (signature_permutation(index, mode=mode)
                if mode != "none" else None)
        if cand is not None and checksum_bytes(
                _as_le(cand.astype(np.int32)).tobytes(),
                algo) == arrays["perm"]["checksum"]:
            perm = cand
            recovered["perm"] = "signatures"
        else:
            perm = None
            perm_dropped = True
            recovered["perm"] = "identity"

    if blocked_present and (not blocked_ok or perm_dropped):
        from .reorder import permute_index
        src = permute_index(index, perm) if perm is not None else index
        bp = block_postings_from_index(src, block_size=block_size,
                                       tile=int(dev["tile_p"]))
        blk = (bp.token_ids, bp.local_doc, bp.scores)
        recovered["blocked"] = "csc"

    bmax_meta = dev.get("bmax")
    bmax_host = bmax_scale = None
    bmax_rebuild = False
    if bmax_meta is not None:
        if not (bad & {"bmax.host", "bmax.scale"}) and not perm_dropped:
            bmax_host, bmax_scale = arr("bmax.host"), arr("bmax.scale")
        else:
            bmax_rebuild = True     # device loads rebuild from the index
            recovered["bmax"] = "csc"

    section_hops = [f"{k}<-{v}" for k, v in recovered.items()]
    COUNTERS["section_rebuilds"] += len(recovered)
    COUNTERS["loads"] += 1
    report = {"path": path, "generation": gen, "mmap": bool(mmap),
              "verified": bool(verify), "algo": algo,
              "corrupt": sorted(bad), "recovered": recovered,
              "hops": hops + section_hops, "full_rebuild": False}
    return _Loaded(index=index, csc_doc=csc_doc, csc_sc=csc_sc, blk=blk,
                   bmax_host=bmax_host, bmax_scale=bmax_scale,
                   bmax_meta=bmax_meta, bmax_rebuild=bmax_rebuild,
                   manifest=manifest, report=report, full_rebuild=False,
                   perm=perm,
                   reorder=(str(dev.get("reorder", "none"))
                            if perm is not None else "none"))


def _strip_host(index):
    """Posting-free metadata copy (host_arrays='drop'): releases the
    posting memmaps while keeping what planners and packers read."""
    return replace(
        index, indptr=np.array(index.indptr),
        nonoccurrence=np.array(index.nonoccurrence),
        doc_lens=np.array(index.doc_lens),
        doc_ids=np.zeros(0, np.int32), scores=np.zeros(0, np.float32))


def load_index(path: str, *, mmap: bool = False, verify: bool = True,
               corpus=None):
    """Verified host-only load — a BM25Index, no device uploads.

    The returned index's arrays are read-only ``np.memmap`` views when
    ``mmap=True``; ``index.snapshot_report`` records the verification and
    any recovery hops. ``corpus`` arms the last recovery rung and must be
    the FULL tokenized corpus the index was built from — the loader
    derives global stats from it and rebuilds only the manifest-recorded
    document slice, so sharded indexes recover exactly too.
    """
    ld = _read_snapshot(path, mmap=mmap, verify=verify, corpus=corpus)
    ld.index.snapshot_report = ld.report
    return ld.index


def load_device_index(path: str, *, mmap: bool = False,
                      host_arrays: str = "keep", verify: bool = True,
                      corpus=None, device=None) -> DeviceIndex:
    """Cold-start a DeviceIndex on ``device`` (default ``"cuda"``) from a
    snapshot — no host re-blocking.

    The padded CSC and blocked files upload straight through
    ``put_posting_arrays`` (from the memmap when ``mmap=True``: a
    read-only map is copied into the upload, never handed to torch), so the
    TRANSFERS counters see exactly one posting upload per layout and the
    zero-steady-state-bytes invariant holds for every batch after.
    ``host_arrays="drop"`` keeps only the posting-free metadata copy as
    ``di.host`` (unlike ``DeviceIndex.build``, which sets it to None —
    loads hand the stripped copy over so adopting retrievers need no
    separate index argument).
    """
    if host_arrays not in ("keep", "drop"):
        raise ValueError(f"unknown host_arrays mode {host_arrays!r}")
    device = resolve_device(device)
    ld = _read_snapshot(path, mmap=mmap, verify=verify, corpus=corpus)
    dev = ld.manifest["device"]
    if ld.full_rebuild:
        meta = ld.bmax_meta
        di = DeviceIndex.build(
            ld.index, device=device, block_size=int(dev["block_size"]),
            tile=int(dev["tile_p"]), frag=int(dev["frag"]),
            with_blocked=bool(dev["with_blocked"]), with_csc=True,
            with_bmax=meta is not None,
            bmax_dtype=("u8" if meta and meta["quantized"] else "f32")
            if meta else "auto",
            # the signature pass is deterministic — the rebuilt
            # DeviceIndex recomputes the exact permutation the snapshot
            # was serving with
            reorder=ld.reorder)
    else:
        index = ld.index
        if ld.perm is not None:
            # disk stores index.*/csc.* in CLIENT order; the resident
            # layouts serve in the PERMUTED space — re-permute the host
            # copy (one lexsort) and pad its CSC for upload
            from .reorder import permute_index
            index = permute_index(index, ld.perm)
        di = DeviceIndex(
            host=index, indptr=index.indptr, df=np.diff(index.indptr),
            nnz=int(dev["nnz"]), n_docs=int(index.doc_lens.size),
            n_vocab=int(index.n_vocab),
            doc_offset=int(index.doc_offset),
            block_size=int(dev["block_size"]), tile_p=int(dev["tile_p"]),
            frag=int(dev["frag"]), device=device,
            reused={"csc": False, "blocked": False, "bmax": False},
            perm=ld.perm, reorder=ld.reorder)
        if ld.perm is not None:
            doc_pad, sc_pad = _padded_csc(index, di.frag)
        else:
            doc_pad, sc_pad = ld.csc_doc, ld.csc_sc
        di.csc_doc_ids, di.csc_scores = put_posting_arrays(
            doc_pad, sc_pad, device=device)
        di.csc_indptr = put_descriptor_array(
            np.asarray(index.indptr).astype(np.int32), device=device)
        if ld.blk is not None:
            di.blk_tok, di.blk_loc, di.blk_sc = put_posting_arrays(
                *ld.blk, device=device)
            di.tile_p = min(int(dev["tile_p"]), int(ld.blk[0].shape[1]))
        if ld.bmax_rebuild:
            di.bmax = build_block_max(
                index, block_size=di.block_size,
                dtype="u8" if ld.bmax_meta["quantized"] else "f32",
                device=device)
        elif ld.bmax_host is not None:
            meta = ld.bmax_meta
            bm = BlockMaxTable(
                host=np.asarray(ld.bmax_host),
                scale=np.asarray(ld.bmax_scale),
                quantized=bool(meta["quantized"]),
                block_size=di.block_size, n_blocks=int(meta["n_blocks"]),
                nb_pad=int(meta["nb_pad"]),
                over_budget=bool(meta["over_budget"]))
            bm.device = put_descriptor_array(bm.host, device=device)
            bm.scale_dev = put_descriptor_array(bm.scale, device=device)
            di.bmax = bm
    if host_arrays == "drop":
        # strip the SERVING-order host copy (permuted when reordered):
        # retrievers and re-saves need doc_lens in the layouts' id space
        di.host = _strip_host(di.host if di.host is not None else ld.index)
        di.indptr = di.host.indptr
        di.df = np.diff(di.indptr)
    di.snapshot_report = ld.report
    return di


__all__ = [
    "FORMAT", "VERSION", "COUNTERS", "reset_counters", "default_algo",
    "checksum_bytes", "checksum_file", "manifest_checksum",
    "save_device_index", "save_index", "load_index", "load_device_index",
]
