"""Synthetic workloads shared by ``chip_smoke.py`` and the profilers.

``make_genome`` and ``sample_reads`` are bench.py's ``_make_genome`` and
``_sample_reads`` (the same draws in the same order), with bench.py's
seed and sizes; ``wobble_reads`` is the third-position wobble of bench.py's
``bench_config2d``, and ``config2d_reads`` its reads (dc-megablast's
config 2d) from their own generator; ``make_workload`` is
``tools/prof_scan_rate.py``'s (whose genome is bench.py's 4.6 Mb too).
``tests/test_torch_import.py`` holds them equal to their originals.
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
