"""TPU-native sequence database: 2-bit packed, block-padded, shardable.

Plays the role of the reference's BLAST database (CSeqDB reader /
CWriteDB writer, NCBI c++/src/objtools/blast/seqdb_reader and
seqdb_writer) re-designed for array processing:

* all subjects live in ONE concatenated 2-bit packed buffer;
* each subject starts at a base offset that is a multiple of ``PAD`` so a
  packed byte never spans two subjects and device blocks slice cleanly;
* ambiguous input bases are deterministically randomized in the packed data
  (as makeblastdb does) and recorded in side arrays so scores can be
  re-evaluated against the true bases (role of
  Blast_HSPListReevaluateWithAmbiguitiesGapped, blast_hits.c);
* ``shard()`` splits the database into length-balanced contiguous slices for
  placement on a device mesh.

On disk: a directory holding ``manifest.json`` + ``arrays.npz``.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from gblastn_tpu_torch.io.encoding import (
    blastna_to_2na,
    pack_2na,
    seq_to_blastna,
    unpack_2na,
)
from gblastn_tpu_torch.io.fasta import FastaRecord, parse_fasta

# Subject starts are aligned to this many bases (multiple of 4 so packed
# bytes don't straddle subjects; 128 keeps device blocks lane-aligned).
PAD = 128

FORMAT_VERSION = 1

# EBlast_filter_program values (reference:
# src/objects/blastdb/blastdb.asn Blast-filter-program) used as the
# conventional algorithm ids for -db_soft_mask / -db_hard_mask.
MASK_PROGRAMS = {
    "dust": 10,
    "seg": 20,
    "windowmasker": 30,
    "repeat": 40,
    "other": 100,
}


@dataclass(frozen=True)
class MaskSet:
    """One masking algorithm's subject intervals (the role of a CSeqDB
    mask column, reference seqdbcol.cpp / mask_column.txt): intervals
    are half-open [start, end) in ABSOLUTE padded-buffer base
    coordinates, sorted and non-overlapping."""

    program: str                  # dust / windowmasker / repeat / other
    options: str                  # free-form algorithm options string
    intervals: np.ndarray         # int64[n, 2]


@dataclass(frozen=True)
class DBInfo:
    title: str
    num_seqs: int
    total_length: int  # sum of true (unpadded) lengths
    max_length: int


def _base_offsets(dbs) -> list[int]:
    """Padded-base offset of each member in the concatenated space."""
    offs = []
    cur = 0
    for d in dbs:
        offs.append(cur)
        cur += d.padded_length
    return offs


class SequenceDB:
    """In-memory database over a packed 2-bit buffer."""

    def __init__(
        self,
        packed: np.ndarray,           # uint8, concatenated padded subjects
        starts: np.ndarray,           # int64[num_seqs] base offset of subject i
        lengths: np.ndarray,          # int64[num_seqs] true length of subject i
        ids: list[str],
        titles: list[str] | None = None,
        ambig_pos: np.ndarray | None = None,   # int64[n] absolute base positions
        ambig_code: np.ndarray | None = None,  # uint8[n] original BLASTNA codes
        title: str = "",
    ):
        self.packed = np.asarray(packed, dtype=np.uint8)
        self.starts = np.asarray(starts, dtype=np.int64)
        self.lengths = np.asarray(lengths, dtype=np.int64)
        self.ids = list(ids)
        self.titles = list(titles) if titles is not None else [""] * len(ids)
        self.ambig_pos = (
            np.asarray(ambig_pos, dtype=np.int64)
            if ambig_pos is not None else np.zeros(0, dtype=np.int64)
        )
        self.ambig_code = (
            np.asarray(ambig_code, dtype=np.uint8)
            if ambig_code is not None else np.zeros(0, dtype=np.uint8)
        )
        self.title = title
        self.masks: dict[int, MaskSet] = {}
        # algo id whose intervals get_sequence_blastna renders as N
        # (the -db_hard_mask search path); set via apply_hard_mask
        self.hard_mask_algo: int | None = None

    # ------------------------------------------------------------------ build
    @classmethod
    def from_records(
        cls, records: Iterable[FastaRecord], title: str = ""
    ) -> "SequenceDB":
        ids: list[str] = []
        titles: list[str] = []
        lengths: list[int] = []
        starts: list[int] = []
        packed_parts: list[np.ndarray] = []
        ambig_pos_parts: list[np.ndarray] = []
        ambig_code_parts: list[np.ndarray] = []
        cursor = 0
        for oid, rec in enumerate(records):
            codes = seq_to_blastna(rec.sequence)
            codes2, ambig = blastna_to_2na(codes, seed=oid)
            n = len(codes2)
            # Always keep at least one pad base between subjects so the
            # device validity mask separates them (pad plays the role of
            # the sentinel byte in the reference's unpacked sequences).
            pad = (-n) % PAD or PAD
            if pad:
                codes2 = np.concatenate([codes2, np.zeros(pad, dtype=np.uint8)])
            packed_parts.append(pack_2na(codes2))
            ids.append(rec.seq_id)
            titles.append(rec.title)
            lengths.append(n)
            starts.append(cursor)
            if ambig.any():
                idx = np.nonzero(ambig)[0]
                ambig_pos_parts.append(idx + cursor)
                ambig_code_parts.append(codes[idx])
            cursor += n + pad
        if not ids:
            raise ValueError("empty database")
        return cls(
            packed=np.concatenate(packed_parts),
            starts=np.array(starts, dtype=np.int64),
            lengths=np.array(lengths, dtype=np.int64),
            ids=ids,
            titles=titles,
            ambig_pos=(np.concatenate(ambig_pos_parts)
                       if ambig_pos_parts else None),
            ambig_code=(np.concatenate(ambig_code_parts)
                        if ambig_code_parts else None),
            title=title,
        )

    @classmethod
    def from_fasta(cls, path, title: str = "") -> "SequenceDB":
        return cls.from_records(parse_fasta(path), title=title or str(path))

    @classmethod
    def concat(cls, dbs: Sequence["SequenceDB"], title: str = "") -> "SequenceDB":
        """Concatenate member databases (the alias-database role,
        reference seqdbalias.cpp: an alias presents volumes as one DB).
        Buffers stay PAD-aligned so packed bytes never straddle
        members; mask columns merge per algorithm id."""
        if not dbs:
            raise ValueError("empty dblist")
        # Member base offsets are multiples of padded_length (round-up to
        # PAD), but an NCBI volume mmap's raw packed buffer ends at an
        # arbitrary byte count -- concatenating raw buffers would shift
        # every later member's subjects. Align each member to its padded
        # byte size first (identity for native-format members).
        def aligned(d):
            if len(d.packed) * 4 == d.padded_length:
                return d.packed
            return d.packed_padded()

        out = cls(
            packed=np.concatenate([aligned(d) for d in dbs]),
            starts=np.concatenate([
                d.starts + off
                for d, off in zip(dbs, _base_offsets(dbs))
            ]),
            lengths=np.concatenate([d.lengths for d in dbs]),
            ids=[i for d in dbs for i in d.ids],
            titles=[t for d in dbs for t in d.titles],
            ambig_pos=np.concatenate([
                d.ambig_pos + off
                for d, off in zip(dbs, _base_offsets(dbs))
            ]),
            ambig_code=np.concatenate([d.ambig_code for d in dbs]),
            title=title or " ".join(d.title for d in dbs),
        )
        algos = {a for d in dbs for a in d.masks}
        for algo in algos:
            parts = []
            program, options = "other", ""
            for d, off in zip(dbs, _base_offsets(dbs)):
                m = d.masks.get(algo)
                if m is not None:
                    parts.append(m.intervals + off)
                    program, options = m.program, m.options
            out.masks[algo] = MaskSet(
                program=program, options=options,
                intervals=np.concatenate(parts),
            )
        return out

    # ------------------------------------------------------------------ props
    @property
    def num_seqs(self) -> int:
        return len(self.ids)

    @property
    def total_length(self) -> int:
        return int(self.lengths.sum())

    @property
    def padded_length(self) -> int:
        # rounded UP to PAD: NCBI .nsq volumes end at arbitrary bytes,
        # and device buffers must stay lane-aligned (odd-length
        # XLA:CPU programs have corrupted the process; see
        # engine/search.py resident upload). Native-format buffers are
        # PAD-aligned already, so this is the identity for them.
        return -(-(len(self.packed) * 4) // PAD) * PAD

    def packed_padded(self) -> np.ndarray:
        """Heap copy of ``packed``, zero-padded to padded_length/4
        bytes -- safe to hand to the device runtime even when
        ``packed`` is a read-only memmap (mmap-backed volumes must
        never be aliased by the CPU backend's zero-copy path)."""
        out = np.zeros(self.padded_length // 4, np.uint8)
        out[: len(self.packed)] = self.packed
        return out

    def info(self) -> DBInfo:
        return DBInfo(
            title=self.title,
            num_seqs=self.num_seqs,
            total_length=self.total_length,
            max_length=int(self.lengths.max()),
        )

    # ------------------------------------------------------------------ access
    def get_sequence_2na(self, oid: int) -> np.ndarray:
        """Unpacked 2-bit codes of one subject (uint8)."""
        start = int(self.starts[oid])
        n = int(self.lengths[oid])
        b0 = start // 4
        b1 = (start + n + 3) // 4
        return unpack_2na(self.packed[b0:b1], n)

    def get_sequence_blastna(self, oid: int) -> np.ndarray:
        """Subject in BLASTNA codes with true ambiguity codes restored.

        When ``hard_mask_algo`` is set (-db_hard_mask), masked ranges
        render as N (code 14) so host re-evaluation/traceback score
        them as the reference scores hard-masked residues."""
        seq = self.get_sequence_2na(oid).copy()
        start = int(self.starts[oid])
        n = int(self.lengths[oid])
        if len(self.ambig_pos):
            sel = (self.ambig_pos >= start) & (self.ambig_pos < start + n)
            seq[self.ambig_pos[sel] - start] = self.ambig_code[sel]
        if self.hard_mask_algo is not None:
            for a, b in self.mask_intervals_for_oid(
                self.hard_mask_algo, oid
            ):
                seq[a: b] = 14
        return seq

    def unpacked(self) -> np.ndarray:
        """Whole padded buffer as 2-bit codes (uint8[padded_length])."""
        return unpack_2na(self.packed_padded(), self.padded_length)

    # budgeted per-db cache of unpacked subject fetches: large-subject
    # searches (a 300 Mb chromosome, a 3.2 Gbase single sequence) were
    # re-unpacking the whole sequence in EVERY batch's prelim and
    # traceback (seconds per batch at Gbase scale). The default budget
    # holds two unpacked forms of a ~4 Gbase subject; tune with
    # GBLASTN_TPU_SEQCACHE_MB for small-RAM hosts.
    @property
    def _seqcache_budget(self) -> int:
        import os

        return int(os.environ.get(
            "GBLASTN_TPU_SEQCACHE_MB", "8192"
        )) << 20

    def _cached_fetch(self, key, build):
        cache = getattr(self, "_seqcache", None)
        if cache is None:
            cache = {}
            self._seqcache = cache
            self._seqcache_bytes = 0
        if key in cache:
            return cache[key]
        arr = build()
        budget = self._seqcache_budget
        if arr.nbytes <= budget:
            while (self._seqcache_bytes + arr.nbytes
                   > budget and cache):
                _, old = cache.popitem()
                self._seqcache_bytes -= old.nbytes
            cache[key] = arr
            self._seqcache_bytes += arr.nbytes
        return arr

    def get_sequence_2na_cached(self, oid: int) -> np.ndarray:
        return self._cached_fetch(
            ("2na", oid), lambda: self.get_sequence_2na(oid)
        )

    def get_sequence_blastna_cached(self, oid: int) -> np.ndarray:
        # hard-mask state changes the rendered letters: key on it
        return self._cached_fetch(
            ("bna", oid, self.hard_mask_algo),
            lambda: self.get_sequence_blastna(oid),
        )

    def valid_mask(self) -> np.ndarray:
        """bool[padded_length]: True for real subject bases, False for pad.

        Pad bases separate subjects and act as extension sentinels on
        device (the unpacked-sequence sentinel byte of the reference).
        """
        mask = np.zeros(self.padded_length, dtype=bool)
        for s, n in zip(self.starts, self.lengths):
            mask[int(s): int(s) + int(n)] = True
        return mask

    def oid_of_position(self, base_pos: np.ndarray) -> np.ndarray:
        """Map absolute base positions in the packed space to subject oids."""
        return np.searchsorted(self.starts, base_pos, side="right") - 1

    def oid_of_id(self, sid: str) -> int | None:
        """id -> oid in O(log n) via a lazily built sorted index (the
        role of the reference's ISAM string index, seqdbisam.cpp;
        ours is in-memory since the manifest already loads all ids).
        Bare accessions also match ``db|accession`` style ids."""
        import bisect

        idx = getattr(self, "_id_index", None)
        if idx is None:
            keys: list[tuple[str, int]] = []
            for i, full in enumerate(self.ids):
                keys.append((full, i))
                for part in full.split("|"):
                    if part and part != full:
                        keys.append((part, i))
            keys.sort()
            idx = ([k for k, _ in keys], [o for _, o in keys])
            self._id_index = idx
        ks, oids = idx
        j = bisect.bisect_left(ks, sid)
        if j < len(ks) and ks[j] == sid:
            return oids[j]
        return None

    # ------------------------------------------------------------- masks
    def add_mask_set(
        self,
        algo_id: int,
        program: str,
        options: str,
        per_id_intervals: dict[str, list[tuple[int, int]]],
    ) -> None:
        """Attach a mask column: ``per_id_intervals`` maps sequence id
        to half-open (start, end) intervals in SEQUENCE-LOCAL
        coordinates (the CWriteDB_Impl::SetMaskData role)."""
        oid_by_id = {sid: i for i, sid in enumerate(self.ids)}
        rows = []
        for sid, ivs in per_id_intervals.items():
            oid = oid_by_id.get(sid)
            if oid is None:
                raise KeyError(f"mask data id {sid!r} not in database")
            base = int(self.starts[oid])
            n = int(self.lengths[oid])
            for a, b in ivs:
                a, b = max(int(a), 0), min(int(b), n)
                if a < b:
                    rows.append((base + a, base + b))
        rows.sort()
        self.masks[int(algo_id)] = MaskSet(
            program=program, options=options,
            intervals=np.array(rows or np.zeros((0, 2)), np.int64)
            .reshape(-1, 2),
        )

    def mask_intervals(self, algo_id: int) -> np.ndarray:
        """int64[n, 2] absolute half-open intervals of one algorithm."""
        if algo_id not in self.masks:
            avail = ", ".join(
                f"{k} ({v.program})" for k, v in self.masks.items()
            ) or "none"
            raise KeyError(
                f"masking algorithm {algo_id} not in database "
                f"(available: {avail})"
            )
        return self.masks[algo_id].intervals

    def mask_intervals_for_oid(self, algo_id: int, oid: int) -> list:
        """Sequence-local half-open intervals of one subject."""
        ivs = self.mask_intervals(algo_id)
        base = int(self.starts[oid])
        end = base + int(self.lengths[oid])
        lo = int(np.searchsorted(ivs[:, 1], base, side="right"))
        hi = int(np.searchsorted(ivs[:, 0], end, side="left"))
        return [
            (max(int(a) - base, 0), min(int(b), end) - base)
            for a, b in ivs[lo:hi]
        ]

    def apply_hard_mask(self, algo_id: int) -> None:
        self.mask_intervals(algo_id)   # validates
        self.hard_mask_algo = int(algo_id)

    # ------------------------------------------------------------------ shard
    def shard(self, n_shards: int) -> list["SequenceDB"]:
        """Split into ``n_shards`` length-balanced contiguous oid ranges."""
        if n_shards <= 0:
            raise ValueError("n_shards must be positive")
        cum = np.concatenate([[0], np.cumsum(self.lengths)])
        total = cum[-1]
        bounds = [0]
        for k in range(1, n_shards):
            target = total * k / n_shards
            b = int(np.searchsorted(cum, target))
            bounds.append(min(max(b, bounds[-1]), self.num_seqs))
        bounds.append(self.num_seqs)
        shards = []
        for a, b in zip(bounds[:-1], bounds[1:]):
            shards.append(self._slice_oids(a, b))
        return shards

    def subset_oids(self, keep) -> "SequenceDB":
        """Restricted view over an arbitrary oid subset (-seqidlist /
        -negative_seqidlist; the OID-mask role of CSeqDB restricted
        instances, seqdbimpl.cpp). Statistics (num_seqs/total_length)
        reflect the restriction, as the reference's restricted seqsrc
        reports."""
        keep = list(keep)
        if not keep:
            return self._slice_oids(0, 0)
        parts, starts, lengths, ids, titles = [], [], [], [], []
        ambp, ambc = [], []
        mask_parts = {algo: [] for algo in self.masks}
        cursor = 0
        for oid in keep:
            a = int(self.starts[oid])
            b = (
                int(self.starts[oid + 1]) if oid + 1 < self.num_seqs
                else self.padded_length
            )
            parts.append(self.packed[a // 4: b // 4])
            starts.append(cursor)
            lengths.append(int(self.lengths[oid]))
            ids.append(self.ids[oid])
            titles.append(self.titles[oid])
            sel = (self.ambig_pos >= a) & (self.ambig_pos < b)
            ambp.append(self.ambig_pos[sel] - a + cursor)
            ambc.append(self.ambig_code[sel])
            for algo, m in self.masks.items():
                ivs = m.intervals
                k2 = (ivs[:, 1] > a) & (ivs[:, 0] < b)
                mask_parts[algo].append(
                    np.clip(ivs[k2], a, b) - a + cursor
                )
            cursor += b - a
        db = SequenceDB(
            packed=np.concatenate(parts),
            starts=np.asarray(starts, np.int64),
            lengths=np.asarray(lengths, np.int64),
            ids=ids, titles=titles,
            ambig_pos=np.concatenate(ambp),
            ambig_code=np.concatenate(ambc),
            title=self.title,
        )
        for algo, m in self.masks.items():
            ivs = (
                np.concatenate(mask_parts[algo])
                if mask_parts[algo] else np.zeros((0, 2), np.int64)
            )
            db.masks[algo] = MaskSet(
                program=m.program, options=m.options, intervals=ivs
            )
        db.hard_mask_algo = self.hard_mask_algo
        return db

    def _slice_oids(self, a: int, b: int) -> "SequenceDB":
        if a >= b:
            # Empty shard: keep a single empty placeholder buffer.
            return SequenceDB(
                packed=np.zeros(PAD // 4, dtype=np.uint8),
                starts=np.zeros(0, dtype=np.int64),
                lengths=np.zeros(0, dtype=np.int64),
                ids=[], titles=[], title=self.title,
            )
        base0 = int(self.starts[a])
        end = (
            int(self.starts[b]) if b < self.num_seqs else self.padded_length
        )
        sel = (self.ambig_pos >= base0) & (self.ambig_pos < end)
        db = SequenceDB(
            packed=self.packed[base0 // 4: end // 4],
            starts=self.starts[a:b] - base0,
            lengths=self.lengths[a:b],
            ids=self.ids[a:b],
            titles=self.titles[a:b],
            ambig_pos=self.ambig_pos[sel] - base0,
            ambig_code=self.ambig_code[sel],
            title=self.title,
        )
        for algo, m in self.masks.items():
            ivs = m.intervals
            keep = (ivs[:, 1] > base0) & (ivs[:, 0] < end)
            clipped = np.clip(ivs[keep] - base0, 0, end - base0)
            db.masks[algo] = MaskSet(
                program=m.program, options=m.options, intervals=clipped
            )
        db.hard_mask_algo = self.hard_mask_algo
        return db

    # ------------------------------------------------------------------ disk
    def save(self, path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        manifest = {
            "format_version": FORMAT_VERSION,
            "title": self.title,
            "num_seqs": self.num_seqs,
            "total_length": self.total_length,
            "pad": PAD,
            "ids": self.ids,
            "titles": self.titles,
            "masks": {
                str(algo): {"program": m.program, "options": m.options}
                for algo, m in self.masks.items()
            },
        }
        (path / "manifest.json").write_text(json.dumps(manifest))
        # the packed buffer is the O(DB) payload: a RAW .npy so load()
        # can memory-map it (the reference's bounded-memory atlas role,
        # seqdbatlas.cpp) -- an NT-scale db must not need O(DB) host
        # RAM to open. Everything else is O(num_seqs) metadata.
        np.save(path / "packed.npy", self.packed)
        arrays = {
            "starts": self.starts,
            "lengths": self.lengths,
            "ambig_pos": self.ambig_pos,
            "ambig_code": self.ambig_code,
        }
        for algo, m in self.masks.items():
            arrays[f"mask_{algo}"] = m.intervals
        np.savez_compressed(path / "arrays.npz", **arrays)

    @classmethod
    def load(cls, path) -> "SequenceDB":
        path = Path(path)
        if (path / "alias.json").exists():
            # native alias database (blastdb_aliastool output): a list
            # of member db paths presented as one database
            alias = json.loads((path / "alias.json").read_text())
            members = [
                cls.load(Path(p) if os.path.isabs(p) else path.parent / p)
                for p in alias["dblist"]
            ]
            return cls.concat(members, title=alias.get("title", ""))
        if not (path / "manifest.json").exists():
            # fall back to NCBI BLAST database format (.nin/.nal),
            # so makeblastdb-built dbs work directly
            from gblastn_tpu_torch.io.ncbidb import is_ncbi_db, load_ncbi_db

            if is_ncbi_db(path):
                return load_ncbi_db(path)
            raise FileNotFoundError(
                f"{path}: no native db (manifest.json) and no NCBI "
                "BLAST db (.nin/.nal) found"
            )
        manifest = json.loads((path / "manifest.json").read_text())
        arrays = np.load(path / "arrays.npz")
        packed_path = path / "packed.npy"
        if packed_path.exists():
            # bounded-memory open: the packed buffer stays on disk and
            # pages in per access (blastdbcmd -entry/-info and the
            # streamed block fetch touch only what they read)
            packed = np.load(packed_path, mmap_mode="r")
        else:
            packed = arrays["packed"]    # legacy all-in-npz layout
        db = cls(
            packed=packed,
            starts=arrays["starts"],
            lengths=arrays["lengths"],
            ids=manifest["ids"],
            titles=manifest["titles"],
            ambig_pos=arrays["ambig_pos"],
            ambig_code=arrays["ambig_code"],
            title=manifest["title"],
        )
        for algo, meta in manifest.get("masks", {}).items():
            db.masks[int(algo)] = MaskSet(
                program=meta["program"],
                options=meta["options"],
                intervals=np.asarray(arrays[f"mask_{algo}"], np.int64)
                .reshape(-1, 2),
            )
        # remembered so -use_index can find the default <db>.tix.npz
        db._source_path = str(path)
        return db


def read_gi_list(path) -> set[int]:
    """Read an NCBI GI list, text or binary.

    Text: one GI per line, '#' comments (SeqDB_ReadMemoryGiList,
    seqdbcommon.cpp:852). Binary: Int4 -1 marker, big-endian count,
    then big-endian Int4 GIs (s_SeqDB_IsBinaryGiList,
    seqdbcommon.cpp:821: first byte 0xFF = binary, leading digit or
    '#' = text).
    """
    data = Path(path).read_bytes()
    if not data:
        raise ValueError(f"GI list {path} is empty")
    if data[0] == 0xFF:
        if len(data) < 8:
            raise ValueError(f"{path} is not a valid binary GI file")
        marker = int.from_bytes(data[:4], "big", signed=True)
        count = int.from_bytes(data[4:8], "big")
        body = data[8:]
        if marker != -1 or count * 4 != len(body):
            raise ValueError(f"{path} is not a valid binary GI file")
        return {
            int.from_bytes(body[i: i + 4], "big")
            for i in range(0, len(body), 4)
        }
    # anything without the binary marker is text, as in the reference
    # (tolerates BOM / CRLF / arbitrary leading whitespace)
    gis: set[int] = set()
    text = data.decode("utf-8-sig", "replace")
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        try:
            gis.add(int(line))
        except ValueError:
            raise ValueError(
                f"{path} is not a valid GI list: bad line {line!r}"
            )
    return gis


def seq_id_gi(seq_id: str) -> int | None:
    """The GI embedded in a bar-separated Seq-id string, or None."""
    parts = seq_id.split("|")
    for i, p in enumerate(parts[:-1]):
        if p == "gi" and parts[i + 1].isdigit():
            return int(parts[i + 1])
    return None
