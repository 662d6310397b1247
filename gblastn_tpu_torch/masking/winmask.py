"""WindowMasker: genome-frequency-based repeat masking.

Host-side reimplementation of the reference WindowMasker (reference:
NCBI c++/src/algo/winmask/):

* counts generation -- CWinMaskCountsGenerator (win_mask_gen_counts.cpp):
  canonical (min of unit/revcomp) n-mer counts over the genome, unit
  size chosen so genome_size >> 2n >= 5 then +1 (:245-262), percentile
  thresholds t_low/t_extend/t_threshold/t_high from the "90,99,99.5,
  99.8" score distribution over distinct units (:320-334), second pass
  drops units below t_low and clamps at t_high (:480-489);
* the NCBI "ascii" statistics file format (seq_masker_istat_ascii.cpp):
  unit-size line, "hex_unit count" lines, ">t_xxx value" parameters --
  read and written for interop with NCBI-generated files;
* runtime masking -- CSeqMasker::DoMask (seq_masker.cpp:137-238) with
  the blastn parameterization (winmask_filter.cpp:80-103: window =
  unit_size + 4, steps 1, trigger "mean", no merge pass): sliding
  window mean of clamped unit counts, three-state interval machine
  (below t_extend / between / above t_threshold).

blastn applies this to queries via -window_masker_db as a soft mask
(lookup-table indexing only), alongside DUST.
"""
from __future__ import annotations

import io
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from gblastn_tpu_torch.masking.dust import _BLASTNA_TO_2BIT

DEFAULT_THRESHOLDS = (90.0, 99.0, 99.5, 99.8)
MAX_COUNT = 500  # score histogram size (win_mask_gen_counts.cpp:190)


def reverse_complement_unit(units: np.ndarray, size: int) -> np.ndarray:
    """Reverse complement of packed 2-bit units (CSeqMaskerUtil)."""
    u = np.asarray(units, dtype=np.uint64)
    out = np.zeros_like(u)
    for _ in range(size):
        out = (out << np.uint64(2)) | ((u ^ np.uint64(3)) & np.uint64(3))
        u = u >> np.uint64(2)
    return out


@dataclass
class WindowMaskerStats:
    """Unit counts + thresholds (CSeqMaskerIstat analog)."""

    unit_size: int
    units: np.ndarray      # uint32/uint64 sorted canonical units
    counts: np.ndarray     # uint32 counts (clamped at t_high)
    t_low: int
    t_extend: int
    t_threshold: int
    t_high: int

    @property
    def use_min_count(self) -> int:
        return (self.t_low + 1) // 2

    def at(self, unit_values: np.ndarray) -> np.ndarray:
        """Clamped count lookup (CSeqMaskerIstatAscii::at + UsetSimple
        canonicalization)."""
        u = np.asarray(unit_values, dtype=np.uint64)
        ru = reverse_complement_unit(u, self.unit_size)
        cu = np.minimum(u, ru)
        idx = np.searchsorted(self.units, cu)
        idx_c = np.minimum(idx, max(len(self.units) - 1, 0))
        if len(self.units):
            found = self.units[idx_c] == cu
            res = np.where(found, self.counts[idx_c], 0).astype(np.int64)
        else:
            res = np.zeros(len(cu), dtype=np.int64)
        res = np.where(res < self.t_low, self.use_min_count, res)
        return np.minimum(res, self.t_high)

    # ------------------------------------------------------------- files
    def save_ascii(self, path) -> None:
        """NCBI windowmasker 'ascii' statistics format."""
        with open(path, "w") as f:
            f.write(f"{self.unit_size}\n")
            for u, c in zip(self.units, self.counts):
                f.write(f"{int(u):x} {int(c)}\n")
            f.write(f">t_low       {self.t_low}\n")
            f.write(f">t_extend    {self.t_extend}\n")
            f.write(f">t_threshold {self.t_threshold}\n")
            f.write(f">t_high      {self.t_high}\n")

    def save_binary(self, path) -> None:
        """NCBI windowmasker 'binary' statistics format
        (seq_masker_ostat_bin.cpp): LE uint32 words -- format id 0,
        unit size, (unit, count) pairs, then the four thresholds."""
        words = [0, self.unit_size]
        for u, c in zip(self.units, self.counts):
            words.extend([int(u), int(c)])
        words.extend([self.t_low, self.t_extend, self.t_threshold,
                      self.t_high])
        Path(path).write_bytes(
            np.asarray(words, dtype="<u4").tobytes()
        )

    @classmethod
    def load_binary(cls, path) -> "WindowMaskerStats":
        """Inverse of save_binary (seq_masker_istat_bin.cpp)."""
        w = np.frombuffer(Path(path).read_bytes(), dtype="<u4")
        if len(w) < 6 or w[0] != 0:
            raise ValueError(f"{path}: not a windowmasker binary file")
        unit_size = int(w[1])
        if not 1 <= unit_size <= 16:
            raise ValueError(f"{path}: illegal unit size {unit_size}")
        pairs = w[2:-4]
        if len(pairs) % 2:
            raise ValueError(f"{path}: wrong length")
        u = pairs[0::2].astype(np.uint64)
        c = pairs[1::2].astype(np.uint32)
        order = np.argsort(u)
        t_low, t_extend, t_threshold, t_high = (int(x) for x in w[-4:])
        return cls(
            unit_size=unit_size, units=u[order], counts=c[order],
            t_low=t_low, t_extend=t_extend, t_threshold=t_threshold,
            t_high=t_high,
        )

    @classmethod
    def _from_hash_tables(
        cls, unit_size, k, roff, bc, t_low, t_extend, t_threshold,
        t_high, ht, vt,
    ) -> "WindowMaskerStats":
        """Decode the optimized hash container (CSeqMaskerUsetHash,
        seq_masker_uset_hash.cpp:72-110) back to (unit, count) arrays.

        hash_code splits a unit into a k-bit key (bits [roff, roff+k))
        and an 8-bit remainder ((high_bits << roff) | low_bits), so
        every stored unit is exactly recoverable from (key, rem):
        unit = (rem >> roff) << (roff + k) | key << roff | low(rem).
        Counts are capped at 0xFFF (direct) / 0x1FF (collision table).
        """
        units: list[int] = []
        counts: list[int] = []
        cmask = (1 << bc) - 1
        lowmask = (1 << roff) - 1

        def unit_of(key: int, rem: int) -> int:
            return (
                ((rem >> roff) << (roff + k))
                | (key << roff)
                | (rem & lowmask)
            )

        for key, hval in enumerate(ht):
            hval = int(hval)
            coll = hval & cmask
            if coll == 0:
                continue
            if coll == 1:
                rem = hval >> 24
                units.append(unit_of(key, rem))
                counts.append((hval >> bc) & 0xFFF)
            else:
                idx = hval >> bc
                for e in vt[idx: idx + coll]:
                    e = int(e)
                    units.append(unit_of(key, e >> 9))
                    counts.append(e & 0x1FF)
        u = np.asarray(units, dtype=np.uint64)
        c = np.asarray(counts, dtype=np.uint32)
        order = np.argsort(u)
        return cls(
            unit_size=unit_size, units=u[order], counts=c[order],
            t_low=t_low, t_extend=t_extend, t_threshold=t_threshold,
            t_high=t_high,
        )

    def _to_hash_tables(self):
        """Encode the optimized hash container (inverse of
        _from_hash_tables; layout: seq_masker_uset_hash.cpp:72-110).

        Parameters: roff = 0 (remainder is the unit's high bits only),
        k chosen so the remainder fits the 7 bits available in a
        collision-table uint16 entry (count takes the low 9). Counts
        cap at 0xFFF direct / 0x1FF in collision lists, as in the
        reference container. Returns (k, roff, bc, ht, vt)."""
        u2 = 2 * self.unit_size
        R = min(7, max(u2 - 1, 0))
        k = u2 - R
        key = (self.units & np.uint64((1 << k) - 1)).astype(np.int64)
        rem = (self.units >> np.uint64(k)).astype(np.int64)
        order = np.argsort(key, kind="stable")
        key_s, rem_s = key[order], rem[order]
        cnt_s = self.counts.astype(np.int64)[order]
        uniq, start, bucket = np.unique(
            key_s, return_index=True, return_counts=True
        )
        max_bucket = int(bucket.max()) if len(bucket) else 0
        bc = 2
        while (1 << bc) - 1 < max_bucket and bc < 12:
            bc += 1
        if (1 << bc) - 1 < max_bucket:
            # direct entries store a 12-bit count above bc, so bc is
            # capped at 12 (bc + 12 <= 24, remainder sits at bit 24)
            raise ValueError(
                f"bucket of {max_bucket} units does not fit bc={bc}"
            )
        ht = np.zeros(1 << k, dtype=np.uint32)
        vt: list[int] = []
        for j, ky in enumerate(uniq):
            s, n = int(start[j]), int(bucket[j])
            if n == 1:
                c = min(int(cnt_s[s]), 0xFFF)
                ht[ky] = (int(rem_s[s]) << 24) | (c << bc) | 1
            else:
                idx = len(vt)
                if (idx << bc) >> bc != idx:
                    raise ValueError("values table overflows the index")
                ht[ky] = np.uint32((idx << bc) | n)
                for t in range(s, s + n):
                    c = min(int(cnt_s[t]), 0x1FF)
                    vt.append((int(rem_s[t]) << 9) | c)
        return k, 0, bc, ht, np.asarray(vt, dtype=np.uint16)

    def save_obinary(self, path) -> None:
        """NCBI 'obinary' optimized format, format word 1 (no cache
        bit array) -- the exact inverse of load_obinary."""
        k, roff, bc, ht, vt = self._to_hash_tables()
        head = np.asarray(
            [1, self.unit_size, len(vt), k, roff, bc,
             self.t_low, self.t_extend, self.t_threshold, self.t_high],
            dtype="<u4",
        )
        Path(path).write_bytes(
            head.tobytes()
            + ht.astype("<u4").tobytes()
            + vt.astype("<u2").tobytes()
        )

    def save_oascii(self, path) -> None:
        """NCBI 'oascii' optimized format (first four bytes 'AAAA', the
        factory's sniff key) -- the exact inverse of load_oascii."""
        k, roff, bc, ht, vt = self._to_hash_tables()
        with open(path, "w") as f:
            f.write("AAAA\n")
            f.write(f"{self.unit_size}\n")
            f.write(f"{len(vt)} {k} {roff} {bc}\n")
            for t in (self.t_low, self.t_extend, self.t_threshold,
                      self.t_high):
                f.write(f"{t}\n")
            for h in ht:
                f.write(f"{int(h)}\n")
            for v in vt:
                f.write(f"{int(v)}\n")

    @classmethod
    def load_obinary(cls, path) -> "WindowMaskerStats":
        """NCBI 'obinary' optimized format (seq_masker_istat_obinary
        .cpp): format word 1/2, unit size, M, k, roff, bc, the four
        thresholds, [cache bit array if format 2], 2^k-word hash
        table, M uint16 values table."""
        raw = Path(path).read_bytes()
        w = np.frombuffer(raw[: 10 * 4], dtype="<u4")
        fmt, unit_size, M, k, roff, bc = (int(x) for x in w[:6])
        t_low, t_extend, t_threshold, t_high = (int(x) for x in w[6:10])
        off = 10 * 4
        if fmt == 2:
            divisor = int(
                np.frombuffer(raw[off: off + 4], dtype="<u4")[0]
            )
            off += 4
            if divisor > 0:
                off += (1 << (2 * unit_size)) // 8   # skip bit array
        ht = np.frombuffer(raw[off: off + 4 * (1 << k)], dtype="<u4")
        off += 4 * (1 << k)
        vt = np.frombuffer(raw[off: off + 2 * M], dtype="<u2")
        return cls._from_hash_tables(
            unit_size, k, roff, bc, t_low, t_extend, t_threshold,
            t_high, ht, vt,
        )

    @classmethod
    def load_oascii(cls, path) -> "WindowMaskerStats":
        """NCBI 'oascii' optimized format (seq_masker_istat_oascii
        .cpp): format line, unit size, 'M k roff bc', four threshold
        lines, 2^k hash-table lines, M values-table lines."""
        lines = Path(path).read_text().split("\n")
        unit_size = int(lines[1])
        M, k, roff, bc = (int(x) for x in lines[2].split())
        t_low, t_extend, t_threshold, t_high = (
            int(lines[i]) for i in (3, 4, 5, 6)
        )
        ht = [int(x) for x in lines[7: 7 + (1 << k)]]
        vt = [int(x) for x in lines[7 + (1 << k): 7 + (1 << k) + M]]
        return cls._from_hash_tables(
            unit_size, k, roff, bc, t_low, t_extend, t_threshold,
            t_high, ht, vt,
        )

    @classmethod
    def load(cls, path) -> "WindowMaskerStats":
        """Load any NCBI unit-counts format, discriminated exactly as
        CSeqMaskerIstatFactory::create (seq_masker_istat_factory.cpp:
        first LE uint32: 0 = binary, 'AAAA' = oascii, 1/2 = obinary,
        anything else = ascii)."""
        with open(path, "rb") as f:
            head = f.read(4)
        if len(head) == 4:
            word = int.from_bytes(head, "little")
            if word == 0:
                return cls.load_binary(path)
            if head == b"AAAA":
                return cls.load_oascii(path)
            if word in (1, 2):
                return cls.load_obinary(path)
        return cls.load_ascii(path)

    @classmethod
    def load_ascii(cls, path) -> "WindowMaskerStats":
        unit_size = None
        units: list[int] = []
        counts: list[int] = []
        params = {}
        for line in Path(path).read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith(">"):
                parts = line[1:].split()
                if len(parts) >= 2:
                    params[parts[0]] = int(parts[1], 0)
                continue
            if unit_size is None:
                unit_size = int(line)
                continue
            parts = line.split()
            units.append(int(parts[0], 16))
            counts.append(int(parts[1]))
        if unit_size is None:
            raise ValueError(f"{path}: not a windowmasker ascii file")
        u = np.array(units, dtype=np.uint64)
        c = np.array(counts, dtype=np.uint32)
        order = np.argsort(u)
        return cls(
            unit_size=unit_size,
            units=u[order],
            counts=c[order],
            t_low=params.get("t_low", 1),
            t_extend=params.get("t_extend", 1),
            t_threshold=params.get("t_threshold", 1),
            t_high=params.get("t_high", MAX_COUNT),
        )


def _sequence_units(seq2: np.ndarray, valid: np.ndarray, n: int):
    """Packed n-mer units at every start position with an all-valid
    window. Returns (units uint64[num], unit_valid bool[num])."""
    L = len(seq2)
    num = L - n + 1
    if num <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    w = np.lib.stride_tricks.sliding_window_view(
        seq2.astype(np.uint64), n
    )
    weights = (np.uint64(4) ** np.arange(n - 1, -1, -1, dtype=np.uint64))
    units = (w * weights).sum(axis=1, dtype=np.uint64)
    cs = np.concatenate([[0], np.cumsum(valid.astype(np.int64))])
    ok = (cs[n:] - cs[:-n]) == n
    return units, ok


def generate_counts(
    sequences: list[np.ndarray],
    unit_size: int = 0,
    genome_size: int = 0,
    thresholds: tuple[float, float, float, float] = DEFAULT_THRESHOLDS,
    t_high_override: int = 0,
    t_low_override: int = 0,
) -> WindowMaskerStats:
    """CWinMaskCountsGenerator::operator() over in-memory sequences
    (BLASTNA codes; ambiguity codes break units exactly as the
    reference's ambig() check does)."""
    if genome_size == 0:
        genome_size = sum(len(s) for s in sequences)
    if unit_size == 0:
        n = 15
        while n > 0 and (genome_size >> (2 * n)) < 5:
            n -= 1
        unit_size = n + 1

    # canonical unit counts over all sequences
    count_map: dict[int, int] = {}
    all_units = []
    for seq in sequences:
        codes = np.asarray(seq, dtype=np.uint8)
        valid = codes < 4
        seq2 = _BLASTNA_TO_2BIT[codes]
        units, ok = _sequence_units(seq2, valid, unit_size)
        units = units[ok]
        runits = reverse_complement_unit(units, unit_size)
        all_units.append(np.minimum(units, runits))
    if all_units:
        cat = np.concatenate(all_units)
        uniq, cnt = np.unique(cat, return_counts=True)
    else:
        uniq = np.zeros(0, np.uint64)
        cnt = np.zeros(0, np.int64)

    # score distribution over distinct units; non-palindromic units
    # represent both orientations (win_mask_gen_counts.cpp:465-489)
    pal = uniq == reverse_complement_unit(uniq, unit_size)
    weight = np.where(pal, 1, 2).astype(np.int64)
    total_ecodes = int(weight.sum())
    clamped = np.minimum(cnt, MAX_COUNT).astype(np.int64)
    score_counts = np.bincount(
        clamped - 1, weights=weight, minlength=MAX_COUNT
    ).astype(np.int64)
    cum = np.cumsum(score_counts)

    index = [0, 0, 0, 0]
    previous = 0.0
    for i in range(1, MAX_COUNT + 1):
        current = (
            100.0 * cum[i - 1] / total_ecodes if total_ecodes else 100.0
        )
        for j in range(4):
            if previous < thresholds[j] <= current:
                index[j] = i
        previous = current

    t_low = t_low_override or index[0] or 1
    t_extend = index[1] or 1
    t_threshold = index[2] or 1
    t_high = t_high_override or index[3] or MAX_COUNT

    keep = cnt >= t_low
    return WindowMaskerStats(
        unit_size=unit_size,
        units=uniq[keep],
        counts=np.minimum(cnt[keep], t_high).astype(np.uint32),
        t_low=t_low,
        t_extend=t_extend,
        t_threshold=t_threshold,
        t_high=t_high,
    )


def window_mask(
    seq: np.ndarray, stats: WindowMaskerStats
) -> list[tuple[int, int]]:
    """CSeqMasker::DoMask (seq_masker.cpp:137-238), blastn parameters:
    window = unit_size + 4, window/unit step 1, trigger mean, no merge.
    Returns inclusive (start, end) base intervals."""
    n = stats.unit_size
    window_size = n + 4
    codes = np.asarray(seq, dtype=np.uint8)
    L = len(codes)
    if L < window_size:
        return []
    valid = codes < 4
    seq2 = _BLASTNA_TO_2BIT[codes]
    units, unit_ok = _sequence_units(seq2, valid, n)
    scores = stats.at(units)

    num_units = window_size - n + 1
    # window w covers bases [w, w+window_size); valid iff all its units
    # are ambiguity-free (FillWindow restarts past ambiguities)
    cs = np.concatenate([[0], np.cumsum(unit_ok.astype(np.int64))])
    num_win = L - window_size + 1
    win_ok = (cs[num_units:num_units + num_win] - cs[:num_win]) == num_units
    ssum = np.concatenate([[0], np.cumsum(scores, dtype=np.int64)])
    win_sum = ssum[num_units:num_units + num_win] - ssum[:num_win]
    win_score = win_sum // num_units

    textend = stats.t_extend
    cutoff = stats.t_threshold
    out: list[tuple[int, int]] = []
    start = end = cend = 0
    for w in np.flatnonzero(win_ok):
        w = int(w)
        s = int(win_score[w])
        w_end = w + window_size - 1
        if s < textend:
            if end > start and w > cend:
                out.append((start, end))
                start = end = cend = 0
        elif s < cutoff:
            if end > start:
                if w > cend + 1:
                    out.append((start, end))
                    start = end = cend = 0
                else:
                    cend = w_end
        else:
            if end > start:
                if w > cend + 1:
                    out.append((start, end))
                    start = w
            else:
                start = w
            cend = end = w_end
    if end > start:
        out.append((start, end))
    return out


def query_window_masks(qblock, stats: WindowMaskerStats):
    """Per-context masked buffer ranges (the -window_masker_db soft
    mask), mirroring masking/dust.query_dust_masks."""
    per_query: dict[int, list[tuple[int, int]]] = {}
    masks: list[list[tuple[int, int]]] = []
    for ctx in qblock.contexts:
        qi = ctx.query_index
        if qi not in per_query:
            plus = next(
                (c for c in qblock.contexts
                 if c.query_index == qi and c.frame >= 0), ctx
            )
            seq = qblock.buffer[plus.offset: plus.offset + plus.length]
            if plus.frame < 0:
                seq = seq[::-1]
            per_query[qi] = window_mask(seq, stats)
        intervals = per_query[qi]
        L = ctx.length
        ctx_masks: list[tuple[int, int]] = []
        for a, b in intervals:
            if ctx.frame >= 0:
                ctx_masks.append((ctx.offset + a, ctx.offset + b))
            else:
                ctx_masks.append(
                    (ctx.offset + L - 1 - b, ctx.offset + L - 1 - a)
                )
        ctx_masks.sort()
        masks.append(ctx_masks)
    return masks
