"""Synthetic workloads shared by ``chip_smoke.py`` and the profilers.

``make_genome`` and ``sample_reads`` are bench.py's ``_make_genome`` and
``_sample_reads`` (the same draws in the same order), with bench.py's
seed and sizes; ``wobble_reads`` is the third-position wobble of bench.py's
``bench_config2d``, and ``config2d_reads`` its reads (dc-megablast's
config 2d) from their own generator; ``make_workload`` is
``tools/prof_scan_rate.py``'s (whose genome is bench.py's 4.6 Mb too).
``tests/test_torch_import.py`` holds them equal to their originals.
``offdiag_reads`` and ``below_cutoff_reads`` are the off-diagonal
workloads of ``tests/test_oracle_parity.py`` (``test_off_diagonal_range``
and ``test_off_diagonal_below_cutoff_admission``, the same draws).
"""
from __future__ import annotations

import numpy as np

SEED = 20260816                 # bench.py's workload seed and sizes
GENOME_LEN = 4_600_000
NUM_QUERIES = 500
QUERY_LEN = 1000
BIG_GENOME_LEN = 300_000_000
C2_QUERIES = 200                # configs 2, 2w and 2d: 200 x 1.5 kb reads
C2_QUERY_LEN = 1500


def make_genome(rng, n):
    """bench.py's _make_genome."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    return bases[rng.integers(0, 4, n)].tobytes().decode()


def sample_reads(rng, genome, num, qlen, prefix):
    """bench.py's _sample_reads (the same draws in the same order), as
    (sequence name, sequence) pairs, and each read's source start."""
    reads, starts = [], []
    for i in range(num):
        start = int(rng.integers(0, len(genome) - qlen))
        read = list(genome[start: start + qlen])
        for p in np.flatnonzero(rng.random(qlen) < 0.02):
            read[p] = "ACGT"[(("ACGT".index(read[p])) + 1 +
                              int(rng.integers(0, 3))) % 4]
        seq = "".join(read)
        if rng.random() < 0.3:  # occasional short deletion
            cut = int(rng.integers(100, qlen - 100))
            seq = seq[:cut] + seq[cut + 3:]
        reads.append((f"{prefix}{i}", seq))
        starts.append(start)
    return reads, starts


def wobble_reads(rng, pairs, rate=0.25):
    """bench_config2d's wobble of (name, sequence) pairs: ``rate`` of the
    positions drawn, those at a third codon position (p % 3 == 2)
    redrawn to another base."""
    out = []
    for name, seq in pairs:
        s = list(seq)
        for p in np.flatnonzero(rng.random(len(s)) < rate):
            if p % 3 == 2:
                s[p] = "ACGT"[("ACGT".index(s[p]) + 1 +
                               int(rng.integers(0, 3))) % 4]
        out.append((name, "".join(s)))
    return out


def config2d_reads(genome, num=C2_QUERIES, qlen=C2_QUERY_LEN):
    """Config 2d's reads (bench.py's bench_config2d): ``num`` reads of
    ``qlen`` bases from generator SEED + 6, wobbled by the same
    generator. Returns ((name, sequence) pairs, source starts)."""
    rng = np.random.default_rng(SEED + 6)
    pairs, starts = sample_reads(rng, genome, num, qlen, "d")
    return wobble_reads(rng, pairs), starts


def make_workload(seed=0, num_queries=64, qlen=1000,
                  genome_len=GENOME_LEN):
    """tools/prof_scan_rate.py's make_workload: (db, reads), one random
    genome and reads copied from it with 2% of bases redrawn."""
    from gblastn_tpu_torch.io.fasta import FastaRecord
    from gblastn_tpu_torch.io.seqdb import SequenceDB

    rng = np.random.default_rng(seed)
    g = make_genome(rng, genome_len)
    reads = []
    for i in range(num_queries):
        s = int(rng.integers(0, genome_len - qlen - 100))
        frag = list(g[s: s + qlen])
        for j in range(len(frag)):
            if rng.random() < 0.02:
                frag[j] = "ACGT"[int(rng.integers(0, 4))]
        reads.append(FastaRecord(f"q{i}", "", "".join(frag)))
    db = SequenceDB.from_records([FastaRecord("chr1", "", g)])
    return db, reads


_CODE = np.full(256, 255, np.uint8)
_CODE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
_BASES = np.frombuffer(b"ACGT", np.uint8)


def _mutate(rng, codes, rate):
    """``codes`` (0-3) with ``rate`` of the positions redrawn to another
    base, in place."""
    p = np.flatnonzero(rng.random(len(codes)) < rate)
    codes[p] = (codes[p] + rng.integers(1, 4, len(p))) % 4
    return codes


def strain_query(rng, genome, length, seg=20_000, rate=0.02):
    """A second strain's assembly against ``genome`` as one query of
    ``length`` bases: ``seg``-base segments, each from a random place and
    strand of ``genome`` with ``rate`` substitutions; the first segment is
    half as long, so that a chunk boundary at a multiple of ``seg`` falls
    inside a segment. Returns the sequence and each segment's (query
    start, genome start, length, minus)."""
    g = _CODE[np.frombuffer(genome.encode(), np.uint8)]
    parts, pieces, q = [], [], 0
    while q < length:
        n = min(seg // 2 if q == 0 else seg, length - q)
        st = int(rng.integers(0, len(g) - n))
        codes = _mutate(rng, g[st: st + n].copy(), rate)
        minus = bool(rng.random() < 0.5)
        parts.append(3 - codes[::-1] if minus else codes)
        pieces.append((q, st, n, minus))
        q += n
    return _BASES[np.concatenate(parts)].tobytes().decode(), pieces


def plant_repeats(rng, genome, n_elements=1000, elem_len=300, share=0.10,
                  divergence=(0.10, 0.20)):
    """A RepeatMasker-style library of ``n_elements`` random elements of
    ``elem_len`` bases, and ``genome`` with ``share`` of it replaced by
    copies of them: one copy in each of equal slots of the genome, at a
    random place in its slot and strand, with a divergence drawn
    uniformly from ``divergence``. Copy numbers differ between families
    as in a real library: element k (from 0) is drawn with weight
    1 / (k + 1). Returns (elements, new genome, each copy's (start,
    element, minus))."""
    elems = rng.integers(0, 4, (n_elements, elem_len)).astype(np.uint8)
    g = _CODE[np.frombuffer(genome.encode(), np.uint8)].copy()
    n_copies = int(len(g) * share) // elem_len
    slot = len(g) // n_copies
    weight = 1.0 / np.arange(1, n_elements + 1)
    family = rng.choice(n_elements, n_copies, p=weight / weight.sum())
    copies = []
    for k in range(n_copies):
        st = k * slot + int(rng.integers(0, slot - elem_len + 1))
        e = int(family[k])
        codes = _mutate(rng, elems[e].copy(), rng.uniform(*divergence))
        minus = bool(rng.random() < 0.5)
        g[st: st + elem_len] = 3 - codes[::-1] if minus else codes
        copies.append((st, e, minus))
    return ([_BASES[e].tobytes().decode() for e in elems],
            _BASES[g].tobytes().decode(), copies)


GIANT_BASES = 3_200_000_000     # bench.py's bench_config4
GENOME_QUERIES = 100            # reads planted in giant and chroms
# GRCh38's primary chromosomes (NCBI RefSeq assembly GCF_000001405.40):
# 3,088,269,832 bases; chr13 straddles 2^31 and chr14-chrY lie past it
GRCH38_CHROMS = (
    ("chr1", 248_956_422), ("chr2", 242_193_529), ("chr3", 198_295_559),
    ("chr4", 190_214_555), ("chr5", 181_538_259), ("chr6", 170_805_979),
    ("chr7", 159_345_973), ("chr8", 145_138_636), ("chr9", 138_394_717),
    ("chr10", 133_797_422), ("chr11", 135_086_622),
    ("chr12", 133_275_309), ("chr13", 114_364_328),
    ("chr14", 107_043_718), ("chr15", 101_991_189),
    ("chr16", 90_338_345), ("chr17", 83_257_441), ("chr18", 80_373_285),
    ("chr19", 58_617_616), ("chr20", 64_444_167), ("chr21", 46_709_983),
    ("chr22", 50_818_468), ("chrX", 156_040_895), ("chrY", 57_227_415),
)
PAST_2G_FROM = "chr14"          # the first chromosome past 2^31


def _planted_read(rng, packed, start, qlen, rate=0.02):
    """The ``qlen`` codes of the packed subject from base ``start`` with
    ``rate`` of them redrawn to another base, as bench_config4 draws them
    (one uniform a base, then one integer a substituted base); a read
    string."""
    from gblastn_tpu_torch.io.encoding import unpack_2na

    lo, hi = start // 4, (start + qlen) // 4 + 2
    codes = unpack_2na(packed[lo:hi], (hi - lo) * 4)[
        start % 4: start % 4 + qlen].copy()
    for p in np.flatnonzero(rng.random(qlen) < rate):
        codes[p] = (codes[p] + 1 + int(rng.integers(0, 3))) % 4
    return "".join("ACGT"[c] for c in codes)


def giant_workload(bases=GIANT_BASES, num=GENOME_QUERIES, qlen=QUERY_LEN):
    """bench.py's bench_config4 (the same draws from SEED + 4): one
    subject of ``bases`` random packed bytes' bases (a 3.2 Gbase genome by
    default, built with no string), and ``num`` reads of ``qlen`` bases
    planted at uniform places with 2% substitutions. Returns (db,
    (name, sequence) pairs, plant starts)."""
    from gblastn_tpu_torch.io.seqdb import SequenceDB

    rng = np.random.default_rng(SEED + 4)
    packed = rng.integers(0, 256, (bases + 3) // 4, dtype=np.uint8)
    bases = len(packed) * 4
    db = SequenceDB(packed=packed, starts=np.zeros(1, np.int64),
                    lengths=np.array([bases], np.int64), ids=["giant1"],
                    title="giant_synth")
    pairs, starts = [], []
    for i in range(num):
        start = int(rng.integers(0, bases - qlen - 4))
        pairs.append((f"g{i}", _planted_read(rng, packed, start, qlen)))
        starts.append(start)
    return db, pairs, starts


def chroms_workload(chroms=GRCH38_CHROMS, num=GENOME_QUERIES,
                    qlen=QUERY_LEN, far=35, seed=SEED + 11):
    """GRCh38's 24 primary chromosomes as random subjects of their
    lengths (``chroms``: (name, length) pairs), built from random packed
    bytes with the pad between subjects that ``SequenceDB.from_records``
    leaves (zero codes, at least one base, to a multiple of its PAD), and
    ``num`` reads of ``qlen`` bases with 2% substitutions: ``far`` of them
    planted on the chromosomes from PAST_2G_FROM on (past 2^31 at full
    size), the rest on those before, each chromosome drawn by its length
    and a place uniformly in it. Returns (db, (name, sequence) pairs,
    plant starts in database coordinates, each read's chromosome)."""
    from gblastn_tpu_torch.io.seqdb import PAD, SequenceDB

    rng = np.random.default_rng(seed)
    lengths = np.array([n for _c, n in chroms], np.int64)
    padded = lengths + np.where(lengths % PAD, -lengths % PAD, PAD)
    starts = np.concatenate([[0], np.cumsum(padded)[:-1]]).astype(np.int64)
    packed = rng.integers(0, 256, int(padded.sum()) // 4, dtype=np.uint8)
    for st, n, p in zip(starts, lengths, padded):
        end = int(st + n)                 # the pad's bases get code 0
        if end % 4:
            packed[end // 4] &= (0xFF << (8 - 2 * (end % 4))) & 0xFF
        packed[-(-end // 4): int(st + p) // 4] = 0
    db = SequenceDB(packed=packed, starts=starts, lengths=lengths,
                    ids=[c for c, _n in chroms], title="grch38_synth")
    split = [c for c, _n in chroms].index(PAST_2G_FROM)
    groups = (np.arange(split), np.arange(split, len(chroms)))
    pairs, plants, owner = [], [], []
    for i in range(num):
        pick = groups[1] if i < far else groups[0]
        k = int(rng.choice(pick, p=lengths[pick] / lengths[pick].sum()))
        st = int(starts[k]) + int(rng.integers(0, lengths[k] - qlen))
        pairs.append((f"h{i}", _planted_read(rng, packed, st, qlen)))
        plants.append(st)
        owner.append(k)
    return db, pairs, plants, owner


def _rand_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _oracle_mutate(rng, s, sub_rate, indel_rate):
    """tests/test_oracle_parity.py's mutate (the same draws)."""
    out = []
    for c in s:
        r = rng.random()
        if r < indel_rate / 2:
            continue
        if r < indel_rate:
            out.append("ACGT"[rng.integers(0, 4)])
        if rng.random() < sub_rate:
            c = "ACGT"[("ACGT".index(c) + 1 + rng.integers(0, 3)) % 4]
        out.append(c)
    return "".join(out)


def offdiag_reads():
    """test_off_diagonal_range's workload: a 50 kb genome, six 600-base
    reads of it with 5% substitutions and 1% indels and two exact
    400-base reads (double words), as (genome, [(name, "", sequence)])."""
    genome = _rand_seq(np.random.default_rng(1234), 50000)
    rng = np.random.default_rng(904)
    reads = []
    for i in range(6):
        st = int(rng.integers(0, len(genome) - 900))
        reads.append((f"od{i}", "", _oracle_mutate(
            rng, genome[st: st + 600], 0.05, 0.01)))
    for i in range(2):
        st = int(rng.integers(0, len(genome) - 600))
        reads.append((f"ox{i}", "", genome[st: st + 400]))
    return genome, reads


def below_cutoff_reads():
    """test_off_diagonal_below_cutoff_admission's workload: ten 57-base
    reads, each a 56-base piece of a 50 kb genome with one base inserted
    at 28 and four substitutions, so that each read's ungapped halves lie
    on neighbouring diagonals and only the off-diagonal probe admits them
    (blastn, window 40, no dust, e-value 20), as (genome, [(name, "",
    sequence)])."""
    rng = np.random.default_rng(11)
    genome = _rand_seq(rng, 50000)
    reads = []
    for i in range(10):
        st = int(rng.integers(0, len(genome) - 100))
        frag = list(genome[st: st + 56])
        frag.insert(28, "ACGT"[int(rng.integers(0, 4))])
        for pp in (8, 20, 36, 48):
            frag[pp] = "ACGT"[("ACGT".index(frag[pp]) + 1
                               + int(rng.integers(0, 3))) % 4]
        reads.append((f"sb{i}", "", "".join(frag)))
    return genome, reads
