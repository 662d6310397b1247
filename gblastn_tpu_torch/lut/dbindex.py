"""Indexed megablast: prebuilt database word index (makembindex analog).

TPU-native take on the reference's dbindex subsystem (reference:
NCBI c++/src/algo/blast/dbindex/ — `makembindex` builds an
on-disk inverted index of database N-mers; `mb_indexed_lookup.c`
s_MBIdxScanSubject then resolves query words against it instead of
scanning the database). The reference motivation carries over whole:
repeated searches of the same database should not pay a pass over the
database. Here the scan phase is a device program whose work is
proportional to the SUBJECT length (`ops.seeding.scan_block`); with an
index, `ops.seeding.indexed_scan_block` walks the QUERY against the
index instead, so device scan work becomes proportional to the query.

Design differences from the reference (deliberate, TPU-first):

* The index is the same CSR layout the engine already uses for the
  query-side lookup table — ``positions`` (subject scan-grid offsets,
  ascending within a word) plus ``words`` (the sorted word code per
  position) from which the dense offsets table is rebuilt at load /
  on device (`engine.seeding.offsets_on_device`). No compressed
  delta-coding: the arrays upload once per database and live in HBM.
* The index is exact for one (word_size, lut_word) pair: it stores
  subject positions on the scan grid ``stride = word_size - lut_word
  + 1`` with word-validity identical to the scanner's, so the raw seed
  set is bit-identical to the scan path run at the same ``lut_word``
  (asserted in tests/test_dbindex.py). The reference index instead
  fixes 12-mer units and changes admission slightly vs the scan path
  (its docs call the results "similar, not identical"); we keep
  exactness and instead *force* the search's lut width to the index's
  (options.lut_word_size) when `-use_index` engages.
* Database soft-masking (`-db_soft_mask`) stays a search-time filter
  applied to gathered positions, so one index serves any masking
  configuration (the reference bakes masking into the index).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

INDEX_SUFFIX = ".tix.npz"
_FORMAT_VERSION = 1


@dataclass(frozen=True)
class DbIndex:
    word_size: int          # full word size W the index was built for
    lut_word: int           # indexed width w
    stride: int             # subject scan stride = W - w + 1
    padded_length: int      # db.padded_length at build time (layout key)
    total_length: int       # db.total_length (sanity)
    positions: np.ndarray   # int32[n] subject grid offsets, ascending
                            #   within each word
    words: np.ndarray       # int32[n] word code per position (sorted)
    max_chain: int          # longest per-word position list

    @property
    def table_size(self) -> int:
        return 1 << (2 * self.lut_word)

    def offsets(self) -> np.ndarray:
        """Dense CSR offsets int32[4^w + 1], rebuilt from ``words``."""
        counts = np.bincount(self.words, minlength=self.table_size)
        out = np.zeros(self.table_size + 1, dtype=np.int32)
        np.cumsum(counts, dtype=np.int32, out=out[1:])
        return out


def build_db_index(db, word_size: int, lut_word: int = 0) -> DbIndex:
    """Index every valid-word subject scan-grid position of ``db``.

    Replicates the scanner's admission exactly: grid positions are
    ``k * stride`` for ``k < (padded - lut_word) // stride + 1``
    (`engine.seeding.run_seeding`), a word is valid iff all
    ``lut_word`` bases are real subject bases (`ops.seeding.scan_block`
    valid mask).
    """
    if lut_word == 0:
        lut_word = 12 if word_size > 12 else word_size
    if not 4 <= lut_word <= 12:
        raise ValueError("lut_word must be in [4, 12]")
    if lut_word > word_size:
        raise ValueError("lut_word cannot exceed word_size")
    stride = word_size - lut_word + 1

    sub2 = db.unpacked().astype(np.int64)
    valid = db.valid_mask()
    s_pad = len(sub2)
    n_scan = max((s_pad - lut_word) // stride + 1, 1)
    pos = np.arange(n_scan, dtype=np.int64) * stride

    words = np.zeros(n_scan, dtype=np.int32)
    ok = np.ones(n_scan, dtype=bool)
    lim0 = (n_scan - 1) * stride + 1
    for j in range(lut_word):
        words += (sub2[j:lim0 + j:stride] << (2 * (lut_word - 1 - j))
                  ).astype(np.int32)
        ok &= valid[j:lim0 + j:stride]

    all_words = words[ok]
    all_pos = pos[ok]
    if all_pos.size and all_pos[-1] > np.iinfo(np.int32).max:
        raise ValueError(
            "database too large for an int32 index (> 2^31 bases); "
            "indexed search is resident-path only"
        )
    order = np.argsort(all_words, kind="stable")
    counts = np.bincount(all_words, minlength=1 << (2 * lut_word))
    return DbIndex(
        word_size=word_size,
        lut_word=lut_word,
        stride=stride,
        padded_length=int(s_pad),
        total_length=int(db.total_length),
        positions=all_pos[order].astype(np.int32),
        words=all_words[order].astype(np.int32),
        max_chain=int(counts.max()) if counts.size else 0,
    )


def save_db_index(index: DbIndex, path: str) -> str:
    """Write the index beside the database; returns the file written."""
    if not str(path).endswith(INDEX_SUFFIX):
        path = str(path) + INDEX_SUFFIX
    np.savez(
        path if str(path).endswith(".npz") else path,
        format_version=np.int32(_FORMAT_VERSION),
        word_size=np.int32(index.word_size),
        lut_word=np.int32(index.lut_word),
        stride=np.int32(index.stride),
        padded_length=np.int64(index.padded_length),
        total_length=np.int64(index.total_length),
        positions=index.positions,
        words=index.words,
        max_chain=np.int32(index.max_chain),
    )
    return str(path)


def load_db_index(path: str) -> DbIndex:
    if not str(path).endswith(INDEX_SUFFIX):
        path = str(path) + INDEX_SUFFIX
    with np.load(path) as z:
        if int(z["format_version"]) != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported index format version in {path}"
            )
        return DbIndex(
            word_size=int(z["word_size"]),
            lut_word=int(z["lut_word"]),
            stride=int(z["stride"]),
            padded_length=int(z["padded_length"]),
            total_length=int(z["total_length"]),
            positions=z["positions"],
            words=z["words"],
            max_chain=int(z["max_chain"]),
        )


def index_compatible(index: DbIndex, db, word_size: int) -> str | None:
    """None if the index can serve a search of ``db`` at ``word_size``;
    otherwise a human-readable reason."""
    if index.word_size != word_size:
        return (
            f"index built for word_size {index.word_size}, "
            f"search uses {word_size}"
        )
    if index.padded_length != db.padded_length or (
            index.total_length != db.total_length):
        return "index does not match this database (rebuild with makembindex)"
    return None
