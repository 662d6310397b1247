"""NCBI BLAST database volume reader/writer (.nin/.nhr/.nsq, .nal).

Lets a user point this framework at databases built by NCBI
``makeblastdb`` (the format the reference searches through CSeqDB,
NCBI c++/src/objtools/blast/seqdb_reader/seqdb.cpp) and,
in the other direction, export our databases for NCBI tools.

Format sources (reference documentation, transcribed not copied):
* index file  — seqdb_reader/index_files.txt: big-endian Int4 fields,
  the one little-endian Int8X volume-length quirk, and the
  header/sequence/ambiguity offset arrays (num_oids + 1 entries each);
* sequence file — seqdb_reader/sequence_files.txt: ncbi2na packing
  (first base in the high bits), the 0-3 "remainder" count stored in
  the low 2 bits of the final byte, and the old (Int4) / new (Int8)
  ambiguity segment formats selected by the high bit of num-segments;
* header file — seqdb_reader/header_files.txt: concatenated BER
  Blast-def-line-set objects (schema src/objects/blastdb/blastdb.asn);
  NCBI's binary ASN.1 wraps every SEQUENCE member and CHOICE variant
  in a context-specific constructed tag numbered by declaration order
  (src/serial/objostrasnb.cpp:1000-1046,1206) with indefinite lengths;
* alias file — seqdb_reader/alias_files.txt: text key/value lines,
  DBLIST aggregation and TITLE override.

Versions: v4 (the reference's own format, BLAST 2.2.28) and v5 (modern
NCBI DBs; post-dates the reference).  A v5 volume's .nhr/.nsq are
byte-identical to v4; the .nin header inserts the LMDB id-index file
name ahead of the title.  The LMDB sidecar (.ndb etc.) only serves
id->oid lookup, which this reader performs by defline scan instead, so
v5 databases load without it.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from gblastn_tpu_torch.io.encoding import NCBI4NA_TO_BLASTNA, unpack_2na
from gblastn_tpu_torch.io.fasta import FastaRecord

# ----------------------------------------------------------------- BER decode

_EOC = object()


def _ber_parse(buf: bytes, off: int):
    """Parse one BER element at ``off``.

    Returns (cls, tag, constructed, value, end): ``value`` is a list of
    child elements when constructed, else the raw content bytes;
    returns (_EOC, ...) for an end-of-contents marker.
    """
    ident = buf[off]
    off += 1
    cls = ident >> 6
    constructed = bool(ident & 0x20)
    tag = ident & 0x1F
    if tag == 0x1F:  # high tag number form
        tag = 0
        while True:
            b = buf[off]
            off += 1
            tag = (tag << 7) | (b & 0x7F)
            if not b & 0x80:
                break
    if ident == 0 and buf[off] == 0:  # end-of-contents
        return _EOC, 0, False, b"", off + 1
    length = buf[off]
    off += 1
    if length == 0x80:  # indefinite
        if not constructed:
            raise ValueError("indefinite length on primitive")
        children = []
        while True:
            c, t, k, v, off = _ber_parse(buf, off)
            if c is _EOC:
                return cls, tag, True, children, off
            children.append((c, t, k, v))
    if length & 0x80:
        nb = length & 0x7F
        length = int.from_bytes(buf[off: off + nb], "big")
        off += nb
    end = off + length
    if constructed:
        children = []
        while off < end:
            c, t, k, v, off = _ber_parse(buf, off)
            if c is _EOC:
                continue
            children.append((c, t, k, v))
        return cls, tag, True, children, end
    return cls, tag, False, buf[off:end], end


def _ber_int(node) -> int:
    _, _, _, v = node
    return int.from_bytes(v, "big", signed=True) if v else 0


def _ber_str(node) -> str:
    _, _, _, v = node
    return v.decode("ascii", "replace")


def _unwrap(node):
    """NCBI member/variant wrappers hold exactly one child."""
    _, _, constructed, v = node
    if constructed and len(v) == 1:
        return v[0]
    return node


def _textseq_id(children) -> str:
    name = accession = None
    version = 0
    for ch in children:
        cls, tag, _, _ = ch
        if cls != 2:
            continue
        inner = _unwrap(ch)
        if tag == 0:
            name = _ber_str(inner)
        elif tag == 1:
            accession = _ber_str(inner)
        elif tag == 3:
            version = _ber_int(inner)
    base = accession or name or ""
    return f"{base}.{version}" if version else base


def _seq_id_str(choice) -> str:
    """Render a Seq-id CHOICE (seqloc.asn declaration order: local=0,
    gibbsq, gibbmt, giim, genbank, embl, pir, swissprot, patent, other,
    general, gi, ddbj, prf, pdb)."""
    cls, tag, _, v = choice
    if cls != 2:
        return ""
    inner = _unwrap(choice)
    if tag == 0:  # local Object-id: CHOICE id [0] / str [1]
        icl, itag, _, _ = inner
        obj = _unwrap(inner)
        if itag == 1:
            return _ber_str(obj)
        return str(_ber_int(obj))
    if tag == 11:  # gi
        return f"gi|{_ber_int(inner)}"
    if tag in (4, 5, 6, 7, 9, 12, 13):  # Textseq-id families
        _, _, _, ch = inner
        return _textseq_id(ch if isinstance(ch, list) else [])
    if tag == 10:  # general Dbtag {db [0], tag Object-id [1]}
        _, _, _, ch = inner
        db = tagv = ""
        for m in ch if isinstance(ch, list) else []:
            mcls, mtag, _, _ = m
            if mcls != 2:
                continue
            mi = _unwrap(m)
            if mtag == 0:
                db = _ber_str(mi)
            elif mtag == 1:
                oi = _unwrap(mi)
                _, otag, _, _ = mi
                tagv = (_ber_str(oi) if otag == 1 else str(_ber_int(oi)))
        return f"{db}|{tagv}"
    return f"seqid{tag}"


def parse_defline_set(blob: bytes) -> list[tuple[str, str, int]]:
    """Parse one Blast-def-line-set -> [(seq_id, title, taxid), ...]."""
    cls, tag, constructed, deflines, _ = _ber_parse(blob, 0)
    out = []
    for dl in deflines if constructed else []:
        _, _, _, members = dl
        title, sid, taxid = "", "", 0
        for m in members if isinstance(members, list) else []:
            mcls, mtag, _, mv = m
            if mcls != 2:
                continue
            if mtag == 0:
                title = _ber_str(_unwrap(m))
            elif mtag == 1 and isinstance(mv, list):
                # seqid SEQUENCE OF Seq-id: wrapper -> SEQUENCE -> ids
                seq = mv[0] if len(mv) == 1 and mv[0][2] else m
                _, _, _, ids = seq
                for sid_node in ids if isinstance(ids, list) else []:
                    s = _seq_id_str(sid_node)
                    if s and not sid:
                        sid = s
            elif mtag == 2:
                taxid = _ber_int(_unwrap(m))
        out.append((sid, title, taxid))
    return out


# ----------------------------------------------------------------- BER encode

def _enc_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    b = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(b)]) + b


def _enc_prim(tag: int, content: bytes, cls: int = 0) -> bytes:
    return bytes([(cls << 6) | tag]) + _enc_len(len(content)) + content


def _enc_member(tag: int, inner: bytes) -> bytes:
    """Context-specific constructed wrapper, indefinite length (the
    NCBI style, objostrasnb.cpp:1000)."""
    return bytes([0xA0 | tag, 0x80]) + inner + b"\x00\x00"


def _enc_vstring(s: str) -> bytes:
    return _enc_prim(26, s.encode("ascii"))


def _enc_int(v: int) -> bytes:
    n = 1
    while not -(1 << (8 * n - 1)) <= v < (1 << (8 * n - 1)):
        n += 1
    return _enc_prim(2, v.to_bytes(n, "big", signed=True))


def _enc_seq(inner: bytes) -> bytes:
    return b"\x30\x80" + inner + b"\x00\x00"


def encode_defline_set(seq_id: str, title: str, taxid: int = 0) -> bytes:
    """Encode a one-defline Blast-def-line-set with a local string id."""
    object_id = _enc_member(1, _enc_vstring(seq_id))       # str variant
    seqid = _enc_member(0, object_id)                      # local variant
    members = (
        _enc_member(0, _enc_vstring(title))
        + _enc_member(1, _enc_seq(seqid))
        + _enc_member(2, _enc_int(taxid))
    )
    return _enc_seq(_enc_seq(members))


# ----------------------------------------------------------------- index file

def _parse_index_body(buf: bytes, off: int, n_strings: int) -> dict:
    """Parse the string fields + counts + offset arrays of a .nin file
    starting at ``off``.  v4 has two strings (title, date); v5 inserts
    the LMDB file name ahead of them (three strings total).  Raises
    ValueError when the remaining bytes do not hold exactly the three
    ``num + 1``-entry offset arrays, which lets the caller probe
    layouts safely."""
    strings: list[str] = []
    for _ in range(n_strings):
        slen, = struct.unpack_from(">i", buf, off)
        off += 4
        if slen < 0 or off + slen > len(buf):
            raise ValueError("string field out of bounds")
        strings.append(
            buf[off: off + slen].rstrip(b"\x00").decode("ascii", "replace")
        )
        off += slen
    num, = struct.unpack_from(">i", buf, off)
    off += 4
    total, = struct.unpack_from("<q", buf, off)  # the Int8X quirk
    off += 8
    maxlen, = struct.unpack_from(">i", buf, off)
    off += 4
    if num < 0 or len(buf) - off != 12 * (num + 1):
        raise ValueError("offset arrays do not fill the file")
    arr = np.frombuffer(buf, dtype=">u4", count=3 * (num + 1), offset=off)
    return {
        "lmdb": strings[0] if n_strings == 3 else "",
        "title": strings[-2],
        "date": strings[-1],
        "num": num,
        "total": total,
        "maxlen": maxlen,
        "hdr": arr[: num + 1].astype(np.int64),
        "seq": arr[num + 1: 2 * (num + 1)].astype(np.int64),
        "amb": arr[2 * (num + 1):].astype(np.int64),
    }


def parse_index(path) -> dict:
    buf = Path(path).read_bytes()
    version, seqtype = struct.unpack_from(">ii", buf, 0)
    if version not in (4, 5):
        raise ValueError(f"{path}: unsupported BLAST db version {version}")
    if seqtype != 0:
        raise ValueError(f"{path}: protein volume (this engine is "
                         "nucleotide-only, like G-BLASTN)")
    if version == 5:
        # v5 = v4 plus the LMDB id-index file name ahead of the title;
        # probe that layout first and fall back to the v4 field order
        # (self-validating: the offset arrays must fill the file)
        for n_strings in (3, 2):
            try:
                idx = _parse_index_body(buf, 8, n_strings)
                break
            except (ValueError, struct.error):
                if n_strings == 2:
                    raise
    else:
        idx = _parse_index_body(buf, 8, 2)
    idx["version"] = version
    return idx


def _ambiguity_segments(amb: bytes) -> list[tuple[int, int, int]]:
    """Decode an ambiguity blob -> [(start, length, blastna_code), ...]
    (sequence_files.txt: old Int4 / new Int8 segment formats, selected
    by the high bit of the segment count)."""
    if len(amb) < 4:
        return []
    head, = struct.unpack_from(">I", amb, 0)
    new_fmt = bool(head & 0x80000000)
    n_words = head & 0x7FFFFFFF
    words = np.frombuffer(amb, dtype=">u4", count=n_words, offset=4)
    segs = []
    if new_fmt:
        for k in range(0, n_words, 2):
            w0, w1 = int(words[k]), int(words[k + 1])
            segs.append((
                w1, ((w0 >> 16) & 0xFFF) + 1,
                int(NCBI4NA_TO_BLASTNA[(w0 >> 28) & 0xF]),
            ))
    else:
        for k in range(n_words):
            w = int(words[k])
            segs.append((
                w & 0xFFFFFF, ((w >> 24) & 0xF) + 1,
                int(NCBI4NA_TO_BLASTNA[(w >> 28) & 0xF]),
            ))
    return segs


def _apply_ambiguities(codes: np.ndarray, amb: bytes) -> None:
    """Overwrite BLASTNA codes in place from an ambiguity blob."""
    for start, ln, code in _ambiguity_segments(amb):
        codes[start: start + ln] = code


def read_volume_records(prefix):
    """Yield FastaRecord-compatible entries from one .n?? volume."""
    prefix = Path(prefix)
    idx = parse_index(prefix.with_suffix(".nin"))
    seq_data = np.fromfile(prefix.with_suffix(".nsq"), dtype=np.uint8)
    hdr_data = Path(prefix.with_suffix(".nhr")).read_bytes()
    for oid in range(idx["num"]):
        s0, a0, s1 = int(idx["seq"][oid]), int(idx["amb"][oid]), int(
            idx["seq"][oid + 1])
        packed = seq_data[s0:a0]
        remainder = int(packed[-1]) & 3
        length = (len(packed) - 1) * 4 + remainder
        codes = unpack_2na(packed, length)
        _apply_ambiguities(codes, seq_data[a0:s1].tobytes())
        deflines = parse_defline_set(
            hdr_data[int(idx["hdr"][oid]): int(idx["hdr"][oid + 1])]
        )
        sid, title, _tax = deflines[0] if deflines else ("", "", 0)
        yield sid or f"oid{oid}", title, codes


# ----------------------------------------------------------------- alias file

def parse_alias(path) -> dict:
    values: dict[str, str] = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split(None, 1)
        if len(parts) == 2:
            values[parts[0]] = parts[1].strip()
    return values


def resolve_db(prefix) -> tuple[list[Path], str]:
    """Resolve a db name to volume prefixes, following .nal aliases
    (DBLIST entries are relative to the alias file's directory)."""
    prefix = Path(prefix)
    if prefix.with_suffix(".nin").exists():
        return [prefix], ""
    nal = prefix.with_suffix(".nal")
    if prefix.suffix != ".nal" and not nal.exists():
        nal = Path(str(prefix) + ".nal")
    if not nal.exists():
        raise FileNotFoundError(f"no .nin or .nal for {prefix}")
    values = parse_alias(nal)
    vols: list[Path] = []
    for name in values.get("DBLIST", "").split():
        name = name.strip('"')
        sub = nal.parent / name
        v, _ = resolve_db(sub)
        vols.extend(v)
    return vols, values.get("TITLE", "")


def is_ncbi_db(prefix) -> bool:
    p = Path(prefix)
    return (p.with_suffix(".nin").exists() or p.with_suffix(".nal").exists()
            or Path(str(p) + ".nin").exists()
            or Path(str(p) + ".nal").exists())


def load_volume_mmap(prefix):
    """Bounded-memory SequenceDB over ONE NCBI volume.

    The .nsq file IS a valid 2-bit packed payload for the array engine:
    subjects start at byte (= 4-base) boundaries, and the final byte of
    every sequence carries the remainder count in its low 2 bits, so at
    least one non-subject base slot separates adjacent subjects -- the
    validity mask derived from (starts, lengths) excludes it, exactly
    like the native format's pad bases.  So the volume memory-maps
    straight in as ``SequenceDB.packed`` with ``starts = 4 * byte
    offset``: no decode, no re-pack, and resident RSS stays O(metadata)
    until something actually reads the pages (the seqdbatlas role,
    reference NCBI c++/src/objtools/blast/seqdb_reader/
    seqdbatlas.cpp -- there a mapped-region atlas over all volume
    files; here the OS page cache behind np.memmap).

    The ambiguity sections that sit between sequences inside .nsq
    decode as junk bases in the padded space; they are outside every
    (start, length) range, so scanning masks them off.  True ambiguity
    letters are restored via the standard ambig_pos/ambig_code side
    arrays (the randomized 2na bases in .nsq are makeblastdb's own, so
    seed-level behavior matches the reference bit for bit).
    """
    from gblastn_tpu_torch.io.seqdb import SequenceDB

    prefix = Path(prefix)
    idx = parse_index(prefix.with_suffix(".nin"))
    num = idx["num"]
    seq_map = np.memmap(prefix.with_suffix(".nsq"), np.uint8, mode="r")
    hdr_map = np.memmap(prefix.with_suffix(".nhr"), np.uint8, mode="r")
    s_off = idx["seq"][:-1]
    a_off = idx["amb"][:num]
    s_end = idx["seq"][1:]
    # last packed byte of each sequence carries the remainder in its
    # low 2 bits (sequence_files.txt); fancy-indexing the memmap pages
    # in only those num bytes
    lastb = np.asarray(seq_map[a_off - 1])
    lengths = (a_off - s_off - 1) * 4 + (lastb & 3)
    starts = s_off * 4

    ids: list[str] = []
    titles: list[str] = []
    for oid in range(num):
        deflines = parse_defline_set(
            bytes(hdr_map[int(idx["hdr"][oid]): int(idx["hdr"][oid + 1])])
        )
        sid, rtitle, _tax = deflines[0] if deflines else ("", "", 0)
        ids.append(sid or f"oid{oid}")
        titles.append(rtitle)

    amb_pos_parts: list[np.ndarray] = []
    amb_code_parts: list[np.ndarray] = []
    for oid in np.flatnonzero(a_off < s_end):
        blob = bytes(seq_map[int(a_off[oid]): int(s_end[oid])])
        for st, ln, code in _ambiguity_segments(blob):
            amb_pos_parts.append(
                int(starts[oid]) + st + np.arange(ln, dtype=np.int64)
            )
            amb_code_parts.append(np.full(ln, code, np.uint8))

    db = SequenceDB(
        packed=seq_map,
        starts=starts.astype(np.int64),
        lengths=lengths.astype(np.int64),
        ids=ids,
        titles=titles,
        ambig_pos=(np.concatenate(amb_pos_parts)
                   if amb_pos_parts else None),
        ambig_code=(np.concatenate(amb_code_parts)
                    if amb_code_parts else None),
        title=idx["title"],
    )
    return db


def load_ncbi_db(prefix):
    """Read an NCBI BLAST nucleotide db (volumes + aliases) as a
    SequenceDB.  Single-volume databases memory-map the .nsq payload
    directly (load_volume_mmap: O(metadata) RSS); multi-volume
    databases concatenate per-volume mmaps into one packed buffer
    (0.25 B/base RSS -- still 8-40x below the old decode-to-text
    path)."""
    from gblastn_tpu_torch.io.seqdb import SequenceDB

    vols, title = resolve_db(prefix)
    if not vols:
        raise ValueError(f"{prefix}: empty NCBI database")
    dbs = [load_volume_mmap(v) for v in vols]
    if len(dbs) == 1:
        db = dbs[0]
        if title:
            db.title = title
    else:
        db = SequenceDB.concat(dbs, title=title or str(prefix))
    if not db.num_seqs:
        raise ValueError(f"{prefix}: empty NCBI database")
    db._source_path = str(prefix)
    return db


# ----------------------------------------------------------------- writer

def write_volume(prefix, records, title: str = "",
                 date: str = "Jan 1, 2026  12:00 AM",
                 version: int = 4) -> None:
    """Write records (FastaRecord or (id, title, blastna codes)) as an
    NCBI nucleotide volume: .nin + .nhr + .nsq.

    ``version`` 4 (default, fully interoperable) or 5.  A v5 volume's
    data files are identical to v4; its index carries the name of an
    LMDB id-index file (``<db>.ndb``) ahead of the title.  We do not
    emit the LMDB sidecar -- our own reader resolves ids by defline
    scan -- so v4 is the export format NCBI tools should be given."""
    from gblastn_tpu_torch.io.encoding import (
        BLASTNA_TO_NCBI4NA,
        blastna_to_2na,
        pack_2na,
        seq_to_blastna,
    )

    prefix = Path(prefix)
    hdr_parts: list[bytes] = []
    seq_parts: list[bytes] = []
    hdr_off = [0]
    seq_off = [0]
    amb_off: list[int] = []
    total = 0
    maxlen = 0
    for oid, rec in enumerate(records):
        if isinstance(rec, tuple):
            sid, rtitle, codes = rec
        else:
            sid, rtitle = rec.seq_id, rec.title
            codes = seq_to_blastna(rec.sequence)
        n = len(codes)
        total += n
        maxlen = max(maxlen, n)
        hdr_parts.append(encode_defline_set(sid, rtitle))
        hdr_off.append(hdr_off[-1] + len(hdr_parts[-1]))

        codes2, ambig = blastna_to_2na(codes, seed=oid)
        packed = pack_2na(codes2)
        remainder = n % 4
        if remainder == 0:
            packed = np.concatenate([packed, np.zeros(1, np.uint8)])
        else:
            packed = packed.copy()
        packed[-1] = (packed[-1] & 0xFC) | remainder
        seq_parts.append(packed.tobytes())
        amb_off.append(seq_off[-1] + len(packed))

        # old-format segments; split runs longer than 16 bases
        segs: list[int] = []
        if ambig.any():
            idx = np.flatnonzero(ambig)
            run_start = int(idx[0])
            prev = run_start
            val = int(BLASTNA_TO_NCBI4NA[codes[run_start]])
            for i in list(idx[1:]) + [None]:
                same = (
                    i is not None and int(i) == prev + 1
                    and int(BLASTNA_TO_NCBI4NA[codes[int(i)]]) == val
                    and (prev - run_start) < 15
                )
                if same:
                    prev = int(i)
                    continue
                segs.append(
                    (val << 28) | ((prev - run_start) << 24) | run_start
                )
                if i is not None:
                    run_start = prev = int(i)
                    val = int(BLASTNA_TO_NCBI4NA[codes[int(i)]])
        amb_blob = struct.pack(">I", len(segs)) + b"".join(
            struct.pack(">I", s) for s in segs
        )
        seq_parts.append(amb_blob)
        seq_off.append(amb_off[-1] + len(amb_blob))

    if version not in (4, 5):
        raise ValueError(f"unsupported BLAST db version {version}")
    num = len(hdr_off) - 1
    lb = (Path(prefix).name + ".ndb").encode("ascii") if version == 5 \
        else b""
    tb = title.encode("ascii")
    db = date.encode("ascii")
    # String#: NUL-pad so the fields after it land 4-byte aligned
    db += b"\x00" * ((-(len(lb) + len(tb) + len(db))) % 4)
    head = struct.pack(">ii", version, 0)
    if version == 5:
        head += struct.pack(">i", len(lb)) + lb
    head += struct.pack(">i", len(tb)) + tb
    head += struct.pack(">i", len(db)) + db
    head += struct.pack(">i", num)
    head += struct.pack("<q", total)  # Int8X little-endian quirk
    head += struct.pack(">i", maxlen)
    # index layout: hdr[num+1], seq[num+1], amb[num+1]; amb[i] points at
    # each sequence's ambiguity start, closed by the final seq end
    # (np.concatenate would silently normalize >u4 to native order)
    arrays = np.array(
        hdr_off + seq_off + amb_off + [seq_off[-1]], dtype=">u4"
    )
    prefix.with_suffix(".nin").write_bytes(head + arrays.tobytes())
    prefix.with_suffix(".nhr").write_bytes(b"".join(hdr_parts))
    prefix.with_suffix(".nsq").write_bytes(b"".join(seq_parts))
