"""The benchmark's inputs, made from ``--seed``: a database and reads.

Frozen copies of the program's recipes, so that a change to the program
cannot move them:

- the genome: ``gblastn_tpu_torch/tools/workloads.py::chroms_workload``'s
  layout (subjects of the configuration's lengths from random packed
  bytes, each padded with zero codes to a multiple of the pad, at least
  one base), made on the device in one call;
- the reads: ``tools/workloads.py::sample_reads`` (substitutions, then a
  deletion in a share of the reads) and ``_oracle_mutate`` (a deletion or
  an insertion at each base), drawn in whole arrays rather than a base at
  a time, placed on a subject drawn by its length and on either strand;
  and, where a mix asks for them, reads of random bases planted nowhere
  (``random_share``), as a screen's query file holds;
- the batching: ``gblastn_tpu_torch/io/fasta.py::batch_records`` with the
  CLI's residue budgets (NCBI's ``GetQueryBatchSize``).

Nothing here imports the program.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# the CLI's query batch budgets by task (io/fasta.py, blast_input_aux.cpp)
BATCH_MEGABLAST = 5_000_000
BATCH_BLASTN = 100_000
ASCII = np.frombuffer(b"ACGT", np.uint8)
# a packed byte's four codes, first base in the high bits
UNPACK = ((np.arange(256)[:, None] >> np.array([6, 4, 2, 0])) & 3).astype(
    np.int8)


def seed_words(seed: int) -> int:
    """Any whole number as the 64-bit word the generators take."""
    return int(seed) % (1 << 64)


def batch_budget(task: str) -> int:
    """Residues a query batch holds for ``task`` (GetQueryBatchSize)."""
    return BATCH_MEGABLAST if task == "megablast" else BATCH_BLASTN


def batch_lengths(lengths, budget: int) -> list[int]:
    """``batch_records``' grouping of records of ``lengths``: each batch
    closes at the record that brings it to ``budget`` residues or more;
    the last batch may fall short. Returns the records a batch."""
    out, n, total = [], 0, 0
    for length in lengths:
        n += 1
        total += int(length)
        if total >= budget:
            out.append(n)
            n, total = 0, 0
    if n:
        out.append(n)
    return out


@dataclass
class Genome:
    """Subjects in one 2-bit packed buffer (first base in the high bits)."""

    packed: np.ndarray      # uint8[padded / 4]
    starts: np.ndarray      # int64[n]: each subject's first base
    lengths: np.ndarray     # int64[n]
    ids: list[str]

    def index_of(self, name: str):
        """The subject named ``name``, or None."""
        if not hasattr(self, "_index"):
            self._index = {n: k for k, n in enumerate(self.ids)}
        return self._index.get(name)

    def codes(self, k: int, a: int, b: int) -> np.ndarray:
        """Codes (0-3) of subject ``k``'s bases [a, b), 0-based."""
        g = int(self.starts[k]) + a
        raw = UNPACK[self.packed[g >> 2: (int(self.starts[k]) + b + 3) >> 2]]
        return raw.reshape(-1)[g & 3: (g & 3) + (b - a)]

    def stretches(self, first: np.ndarray, n: int) -> np.ndarray:
        """Codes [len(first), n] of the ``n`` bases from each of the
        buffer offsets ``first``."""
        nb = (n + 3) // 4 + 1
        raw = UNPACK[self.packed[(first >> 2)[:, None] + np.arange(nb)]]
        raw = raw.reshape(len(first), nb * 4)
        out = np.empty((len(first), n), np.int8)
        for r in range(4):
            rows = np.flatnonzero((first & 3) == r)
            out[rows] = raw[rows, r: r + n]
        return out


def layout(lengths, pad: int):
    """Subject starts and the padded total, as ``SequenceDB.from_records``
    lays subjects out: each followed by zero codes to a multiple of
    ``pad``, at least one."""
    lengths = np.asarray(lengths, np.int64)
    padded = lengths + np.where(lengths % pad, -lengths % pad, pad)
    starts = np.concatenate([[0], np.cumsum(padded)[:-1]]).astype(np.int64)
    return starts, int(padded.sum())


def make_genome(subjects, seed: int, pad: int, device="cpu") -> Genome:
    """Random bases for ``subjects`` ((name, length) pairs) from ``seed``,
    drawn as bytes on ``device`` by one torch generator there."""
    import torch

    ids = [str(n) for n, _l in subjects]
    lengths = np.array([int(length) for _n, length in subjects], np.int64)
    starts, total = layout(lengths, pad)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_words(seed))
    buf = torch.empty(total // 4, dtype=torch.uint8, device=device)
    buf.random_(0, 256, generator=gen)
    for st, n in zip(starts.tolist(), lengths.tolist()):
        end = st + n                       # the pad's bases get code 0
        if end % 4:
            buf[end // 4] &= (0xFF << (8 - 2 * (end % 4))) & 0xFF
        nxt = st + n + (-n % pad or pad)
        buf[-(-end // 4): nxt // 4] = 0
    return Genome(buf.cpu().numpy(), starts, lengths, ids)


@dataclass
class Reads:
    """A pool of reads and where each was planted."""

    flat: np.ndarray        # int8: every read's codes, one after another
    offsets: np.ndarray     # int64[n + 1]
    subject: np.ndarray     # int64[n]: the subject it was drawn from (-1:
                            # random bases, planted nowhere)
    src_start: np.ndarray   # int64[n]: 0-based start of its source there
    src_len: np.ndarray     # int64[n]: bases of the source
    minus: np.ndarray       # bool[n]: drawn from the minus strand
    batches: list[int]      # reads a batch, in order

    @property
    def planted(self) -> np.ndarray:
        return self.subject >= 0

    def __len__(self) -> int:
        return len(self.subject)

    def codes(self, i: int) -> np.ndarray:
        return self.flat[self.offsets[i]: self.offsets[i + 1]]

    def text(self, i: int) -> bytes:
        return ASCII[self.codes(i)].tobytes()


def _draw(rng, genome: Genome, n: int, traffic: dict):
    """``n`` reads by ``traffic``'s recipe: (codes [n, L, s] with slots
    valid [n, L, s], subject (-1 where planted nowhere), start, minus).
    A key that a mix leaves out draws nothing, so a mix draws the same
    reads whatever keys later mixes add."""
    L = int(traffic["read_length"])
    w = genome.lengths / genome.lengths.sum()
    k = rng.choice(len(w), n, p=w)
    st = (rng.random(n) * (genome.lengths[k] - L)).astype(np.int64)
    codes = genome.stretches(genome.starts[k] + st, L)
    sub = rng.random((n, L), dtype=np.float32) < traffic["substitution_rate"]
    codes[sub] = (codes[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    rate = float(traffic.get("indel_rate", 0.0))
    if rate > 0:        # _oracle_mutate: delete, or insert a base before
        r = rng.random((n, L), dtype=np.float32)
        ins = rng.integers(0, 4, (n, L)).astype(np.int8)
        arr = np.stack([ins, codes], 2)
        valid = np.stack([(r >= rate / 2) & (r < rate), r >= rate / 2], 2)
    else:
        arr = codes[:, :, None]
        valid = np.ones((n, L, 1), bool)
    share = float(traffic.get("deletion_share", 0.0))
    if share > 0:       # sample_reads: one short deletion in a share
        dl = int(traffic["deletion_length"])
        margin = int(traffic["deletion_margin"])
        rows = np.flatnonzero(rng.random(n) < share)
        cut = rng.integers(margin, L - margin, len(rows))
        for t in range(dl):
            valid[rows, cut + t, -1] = False
    minus = rng.random(n) < float(traffic.get("minus_share", 0.0))
    arr[minus] = 3 - arr[minus][:, ::-1, ::-1]
    valid[minus] = valid[minus][:, ::-1, ::-1]
    random = float(traffic.get("random_share", 0.0))
    if random > 0:      # a screen's reads from no subject: random bases
        rows = np.flatnonzero(rng.random(n) < random)
        arr[rows] = rng.integers(0, 4, (len(rows), L, arr.shape[2]))
        valid[rows] = False
        valid[rows, :, -1] = True
        k, st, minus = k.copy(), st.copy(), minus.copy()
        k[rows], st[rows], minus[rows] = -1, -1, False
    return arr, valid, k, st, minus


CHUNK = 8192            # reads drawn at a time


def make_reads(genome: Genome, traffic: dict, seed: int, budget: int,
               n_batches: int) -> Reads:
    """The first ``n_batches`` full batches of a stream of reads drawn by
    ``traffic``'s recipe from ``seed`` and grouped by the CLI's rule at
    ``budget`` residues."""
    rng = np.random.default_rng([seed_words(seed), 0x5EED])
    parts, lens, total = [], [], 0
    need = n_batches * budget
    step = min(CHUNK, need // int(traffic["read_length"]) + 64)
    while total < need + budget:
        arr, valid, k, st, minus = _draw(rng, genome, step, traffic)
        n_read = valid.sum((1, 2))
        parts.append((arr[valid], n_read, k, st, minus))
        lens.append(n_read)
        total += int(n_read.sum())
    lengths = np.concatenate(lens)
    batches = batch_lengths(lengths, budget)[:n_batches]
    n = sum(batches)
    flat = np.concatenate([p[0] for p in parts])
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    L = int(traffic["read_length"])
    return Reads(
        flat=flat[: offsets[n]],
        offsets=offsets[: n + 1],
        subject=np.concatenate([p[2] for p in parts])[:n],
        src_start=np.concatenate([p[3] for p in parts])[:n],
        src_len=np.full(n, L, np.int64),
        minus=np.concatenate([p[4] for p in parts])[:n],
        batches=batches,
    )
