"""The comparison that decides ``correct``.

A read is planted (the reference knows where its alignment lies) or, in
a mix with a ``random_share``, made of random bases planted nowhere. For
a sample of the reads that the window's batches searched (drawn from the
seed, or all of them where they are fewer than ``SAMPLE``), the tabular
lines that the program wrote are held to what the configuration
guarantees:

- every read: at most ``-max_target_seqs`` subjects, every e-value
  within ``-evalue``, twelve fields a line;
- a planted read: a line on the planted subject and strand, over the
  plant, whose bit score is the one of the best local alignment of the
  read against the plant's stretch of subject (``reference/align.py``,
  with the configuration's scores and gap costs), and whose four
  coordinates bound an alignment of that same score (a global alignment
  of the two ranges);
- a read planted nowhere may have no line; where it has some, the four
  coordinates of its best line bound an alignment of the bit score that
  the line prints;
- the line so held, where it has no gap: its length, mismatches and
  identity as the bases give them; where its bit score passes 1000, an
  e-value printed ``0.0``.

A read that fails any of these is wrong. The number compared is the share
of wrong reads, ``wrong_reads_pct``, against the cell's limit.
"""
from __future__ import annotations

import numpy as np

from reference.align import (
    bit_score,
    bit_score_text,
    global_scores,
    local_scores,
    raw_score,
)

SAMPLE = 4000          # reads compared a run at most
MARGIN = 32            # subject bases beside the plant the reference sees
FIELDS = 12            # qseqid sseqid pident length mismatch gapopen
                       # qstart qend sstart send evalue bitscore


def parse_tabular(path, wanted: set[str]) -> dict[str, list[list[str]]]:
    """The lines of the reads in ``wanted``, by read id."""
    out: dict[str, list[list[str]]] = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            if f[0] in wanted:
                out.setdefault(f[0], []).append(f)
    return out


def sample(emitted: list[tuple[int, int]], seed: int):
    """``emitted``: (emission, read index) pairs due in the window; the
    pairs compared, drawn from the seed where there are more than
    ``SAMPLE``."""
    if len(emitted) <= SAMPLE:
        return list(emitted)
    rng = np.random.default_rng([seed, 0xC4EC])
    pick = np.sort(rng.choice(len(emitted), SAMPLE, replace=False))
    return [emitted[i] for i in pick]


def read_id(i: int) -> str:
    return f"r{i}"


def _rc(codes):
    return (3 - codes[::-1]).astype(np.int8)


def _oriented(reads, i):
    """Read ``i`` as its source strand reads it."""
    c = reads.codes(i)
    return _rc(c) if reads.minus[i] else c.astype(np.int8)


def _window(genome, reads, i):
    k = int(reads.subject[i])
    a = max(0, int(reads.src_start[i]) - MARGIN)
    b = min(int(genome.lengths[k]),
            int(reads.src_start[i] + reads.src_len[i]) + MARGIN)
    return k, a, b


def _line_ranges(f, genome, read_len):
    """A line's subject, strand and 0-based ranges ((q0, q1), (s0, s1)),
    or None where they lie outside the read or the subject."""
    k = genome.index_of(f[1])
    q0, q1, s0, s1 = (int(x) for x in f[6:10])
    lo, hi = min(s0, s1) - 1, max(s0, s1)
    if k is None or q0 < 1 or q1 > read_len or q1 < q0 or lo < 0 \
            or hi > int(genome.lengths[k]):
        return None
    return k, s0 > s1, (q0 - 1, q1), (lo, hi)


def judge(genome, reads, config, picked, lines_of, device="cpu"):
    """Per picked read, the first check it fails ("" where none).

    ``picked``: (emission, read index) pairs; ``lines_of[emission]``: the
    lines by read id that emission wrote."""
    opts = config["check"]
    scoring, karlin = config["scoring"], config["karlin"]
    cut, mts = float(opts["evalue"]), int(opts["max_target_seqs"])
    planted = [p for p, (_e, i) in enumerate(picked) if reads.subject[i] >= 0]
    qs, ss = [], []
    for p in planted:
        i = picked[p][1]
        k, a, b = _window(genome, reads, i)
        qs.append(_oriented(reads, i))
        ss.append(genome.codes(k, a, b))
    best_raw = dict(zip(planted, (raw_score(v, scoring) for v in
                                  local_scores(qs, ss, scoring, device))))
    verdict = [""] * len(picked)
    chosen = {}          # pick -> (line, subject, minus, q range, s range)
    for p, (e, i) in enumerate(picked):
        lines = lines_of[e].get(read_id(i), [])
        try:
            ev = [float(f[10]) for f in lines]
        except (ValueError, IndexError):
            verdict[p] = "malformed"
            continue
        if any(len(f) != FIELDS for f in lines):
            verdict[p] = "malformed"
            continue
        if len({f[1] for f in lines}) > mts:
            verdict[p] = "subjects"
            continue
        if any(v > cut for v in ev):
            verdict[p] = "evalue"
            continue
        n = len(reads.codes(i))
        if p not in best_raw:            # planted nowhere
            if not lines:
                continue
            f = max(lines, key=lambda f: float(f[11]))
            got = _line_ranges(f, genome, n)
            if got is None:
                verdict[p] = "range"
                continue
            chosen[p] = (f, *got)
            continue
        k, a, b = _window(genome, reads, i)
        mine = []
        for f in lines:
            got = _line_ranges(f, genome, n)
            if got is None or got[0] != k or got[1] != bool(reads.minus[i]):
                continue
            lo, hi = got[3]
            if hi <= a or lo >= b:
                continue
            mine.append((float(f[11]), f, got))
        if not mine:
            verdict[p] = "missed"
            continue
        _bits, f, got = max(mine, key=lambda m: m[0])
        want = bit_score(best_raw[p], karlin)
        if f[11].strip() != bit_score_text(want).strip():
            verdict[p] = "bit_score"
            continue
        if want > 1000 and f[10] != "0.0":
            verdict[p] = "evalue_text"
            continue
        qr, sr = got[2], got[3]
        if max(qr[1] - qr[0], sr[1] - sr[0]) > 2 * (n + MARGIN):
            verdict[p] = "range"
            continue
        chosen[p] = (f, *got)
    # the chosen lines' ranges must bound an alignment of the score wanted
    keys = sorted(chosen)
    gq, gs = [], []
    for p in keys:
        i = picked[p][1]
        _f, k, minus, (q0, q1), (s0, s1) = chosen[p]
        q = reads.codes(i)[q0:q1].astype(np.int8)
        gq.append(_rc(q) if minus else q)
        gs.append(genome.codes(k, s0, s1))
    g = global_scores(gq, gs, scoring, device) if keys else []
    for p, gscore, q, s in zip(keys, g, gq, gs):
        f = chosen[p][0]
        raw = raw_score(gscore, scoring)
        if p in best_raw:
            ok = raw == best_raw[p]
        else:
            ok = (bit_score_text(bit_score(raw, karlin)).strip()
                  == f[11].strip())
        if not ok:
            verdict[p] = "range"
        elif f[5] == "0" and not _fields_ok(f, q, s):
            verdict[p] = "fields"
    return verdict


def _fields_ok(f, q, s) -> bool:
    """An ungapped line's length, mismatches and identity, from the bases."""
    n = len(q)
    if len(s) != n or int(f[3]) != n:
        return False
    mm = int((q != s).sum())
    return int(f[4]) == mm and abs(float(f[2]) - 100.0 * (n - mm) / n) < 0.006


def summarize(verdict: list[str], limit: float) -> dict:
    """The numbers compared, each with its limit, and the failures by kind."""
    n = len(verdict)
    wrong = sum(1 for v in verdict if v)
    pct = 100.0 * wrong / n if n else 100.0
    kinds: dict[str, int] = {}
    for v in verdict:
        if v:
            kinds[v] = kinds.get(v, 0) + 1
    return {
        "correct": bool(n) and pct <= limit,
        "numbers": {"wrong_reads_pct": {"value": pct, "limit": limit}},
        "compared": n,
        "wrong": wrong,
        "kinds": kinds,
    }
