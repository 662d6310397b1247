"""The generators: the same seed gives the same inputs, the recipe's
shapes, and the CLI's batching."""
import numpy as np

from gblastn_tpu_torch.io.fasta import FastaRecord, batch_records
from harness import data, spec
from tiny import SUBJECTS

PAD = 128


def _reads(traffic, seed, n_batches=3, budget=5_000):
    g = data.make_genome(SUBJECTS, seed, PAD)
    return g, data.make_reads(g, traffic, seed, budget, n_batches)


def test_genome_repeats_by_seed_and_pads_with_zero_codes():
    a = data.make_genome(SUBJECTS, 2**31 + 5, PAD)
    b = data.make_genome(SUBJECTS, 2**31 + 5, PAD)
    c = data.make_genome(SUBJECTS, 2**31 + 6, PAD)
    assert np.array_equal(a.packed, b.packed)
    assert not np.array_equal(a.packed, c.packed)
    assert a.starts.tolist() == [0, 60_032]
    end = int(a.starts[0] + a.lengths[0])
    codes = a.codes(0, 0, int(a.starts[1]))          # into the pad
    assert codes[end:].tolist() == [0] * (len(codes) - end)


def test_negative_and_huge_seeds_are_taken():
    for s in (-1, 2**40 + 3):
        data.make_genome(SUBJECTS, s, PAD)


def test_reads_repeat_by_seed_and_follow_the_megablast_recipe():
    traffic = spec.traffic("reads_1kb_2pct")
    g, a = _reads(traffic, 77)
    _g, b = _reads(traffic, 77)
    assert np.array_equal(a.flat, b.flat) and a.batches == b.batches
    lens = np.diff(a.offsets)
    assert set(lens.tolist()) <= {1000, 997}
    i = int(np.flatnonzero(lens == 1000)[0])        # no deletion
    src = g.codes(int(a.subject[i]), int(a.src_start[i]),
                  int(a.src_start[i]) + 1000)
    read = a.codes(i)
    if a.minus[i]:
        read = 3 - read[::-1]
    assert (read != src).mean() < 0.08


def test_reads_follow_the_blastn_recipe():
    traffic = spec.traffic("reads_1500_8pct_indel")
    _g, a = _reads(traffic, 5, budget=20_000)
    lens = np.diff(a.offsets)
    assert abs(lens.mean() - 1500) < 20 and lens.min() != lens.max()
    assert 0.3 < a.minus.mean() < 0.7


def test_batching_equals_the_clis():
    rng = np.random.default_rng(3)
    lengths = rng.integers(900, 1100, 500)
    recs = [FastaRecord(f"q{i}", "", b"A" * int(n))
            for i, n in enumerate(lengths)]
    for budget in (5_000, 20_000, 100_000, 10**9):
        want = [len(b) for b in batch_records(recs, budget)]
        assert data.batch_lengths(lengths, budget) == want


def test_a_pool_holds_only_full_cli_batches():
    traffic = spec.traffic("reads_1kb_2pct")
    _g, a = _reads(traffic, 9, n_batches=4)
    assert len(a.batches) == 4
    lens = np.diff(a.offsets)
    first = np.concatenate([[0], np.cumsum(a.batches)])
    for lo, hi in zip(first[:-1], first[1:]):
        assert lens[lo:hi].sum() >= 5_000 > lens[lo:hi - 1].sum()


def test_a_random_share_plants_reads_nowhere_and_leaves_other_mixes_alone():
    traffic = spec.traffic("reads_1kb_2pct")
    g, plain = _reads(traffic, 31)
    _g, zero = _reads(dict(traffic, random_share=0.0), 31)
    assert np.array_equal(plain.flat, zero.flat)        # the key is inert
    assert plain.planted.all()
    _g, a = _reads(dict(traffic, random_share=0.5), 31, budget=40_000)
    _g, b = _reads(dict(traffic, random_share=0.5), 31, budget=40_000)
    assert np.array_equal(a.flat, b.flat)
    assert 0.3 < (~a.planted).mean() < 0.7
    i = int(np.flatnonzero(~a.planted)[0])
    assert len(a.codes(i)) == 1000 and a.src_start[i] == -1
    j = int(np.flatnonzero(a.planted)[0])
    src = g.codes(int(a.subject[j]), int(a.src_start[j]),
                  int(a.src_start[j]) + len(a.codes(j)))
    read = 3 - a.codes(j)[::-1] if a.minus[j] else a.codes(j)
    if len(read) == 1000:
        assert (read != src).mean() < 0.08
