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
