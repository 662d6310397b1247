"""Inputs of the device finish's kernels RR, G and R (ops/replay.py) for
the comparisons with their plain versions and for the profilers: the
search path's own at a batch (``batch_cases``, ``batch_run_case``), and
random sets that reach the cases the search path seldom does
(``random_gate_case``, ``random_replay_cases``, ``random_run_cases``,
``random_two_hit_cases``; the last two from numpy arrays that the CPU
tests also hold against the host twins: ``run_arrays``,
``two_hit_arrays``). Each is built on the given device from a seeded
numpy generator.
"""
from __future__ import annotations

import numpy as np
import torch

from gblastn_tpu_torch.engine.seeding import (
    diag_table_mask,
    gate_inputs,
    replay_inputs,
    run_inputs,
    ungapped_inputs,
)
from gblastn_tpu_torch.io.fasta import FastaRecord
from gblastn_tpu_torch.io.seqdb import SequenceDB
from gblastn_tpu_torch.ops.replay import (
    approx_gate,
    query_bytes,
    replay_keys,
    right_run,
)
from gblastn_tpu_torch.ops.seeding import pack_query_nibbles, pack_subject_words
from gblastn_tpu_torch.ops.ungapped import ungapped_extend_window
from gblastn_tpu_torch.params.derived import nucl_score_table_packed


def _k1(batch):
    kw = batch.seed_kw
    dev = batch.seed_dev
    ctx, k1_args, _n = ungapped_inputs(dev, **kw)
    ung = ungapped_extend_window(*k1_args)
    return k1_args, gate_inputs(dev, k1_args, ctx, ung), ung


def batch_run_case(batch):
    """RR's inputs on a batch's search path: (args, kw) of ``right_run``
    for K1's seeds, as ``engine.seeding.device_finish`` builds them, or
    None where the path runs no RR (one-hit, or the ``rr_zero`` rule)."""
    k1_args, g_args, _ung = _k1(batch)
    rr_args = run_inputs(batch.seed_dev, k1_args, g_args, batch.seed_kw)
    return (None if rr_args is None
            else (rr_args, dict(word_size=batch.seed_kw["word_size"])))


def batch_cases(batch):
    """G's and R's inputs on a batch's search path (a ``BatchSetup``):
    scan, mini-extension and K1 on its device (and RR where the path runs
    it, its runs in both keyword sets), then (g_args, g_kw, r_args,
    r_kw): ``approx_gate``'s arguments for K1's outputs, and
    ``diag_replay``'s for the rows after the gate, as
    ``engine.seeding.device_finish`` builds them."""
    kw = batch.seed_kw
    dev = batch.seed_dev
    k1_args, g_args, ung = _k1(batch)
    rr_args = run_inputs(dev, k1_args, g_args, kw)
    runs = (None if rr_args is None
            else right_run(*rr_args, word_size=kw["word_size"]))
    n_ctx = len(kw["x_dropoffs"])
    concat_end = int(kw["context_offsets"][n_ctx]) - 1
    word = kw["word_size"]
    g_kw = dict(word_size=word, concat_end=concat_end, right_run=runs)
    rows = approx_gate(*g_args, **g_kw)[:4] if word >= 11 else ung[:4]
    r_args, shift, _flag = replay_inputs(dev, g_args[6:10], rows,
                                         concat_end=concat_end)
    return g_args, g_kw, r_args, dict(word_size=word, window=dev.window,
                                      right_run=runs, key_shift=shift)


def batch_key_case(batch, g_args, g_kw, r_args):
    """``replay_keys``' (args, kw) for a batch's ``batch_cases``: K1's
    q_off, R's subject-local s, the oid, the batch's diagonal mask, and
    its bounds (subject count, longest subject, query buffer), as
    ``engine.seeding.replay_inputs`` gives them."""
    dev = batch.seed_dev
    mask = diag_table_mask(g_kw["concat_end"] - 1, dev.window)
    return ((g_args[6], r_args[2], g_args[9], mask),
            dict(n_sub=dev.resident.starts.numel(),
                 s_len=dev.resident.longest,
                 q_len=dev.query_packed.numel()))


def random_gate_case(device, n=65536, seed=4242):
    """G's random set: six subjects, one of them a 4-base unit tiled 6,000
    times; a query with planted matches, the same repeat (phase-matched to
    the subject, so the walks run for hundreds of byte-steps: the long
    repeat the JAX package's clamp left unresolved), N (14), R (4), Y (5)
    and sentinels; seeds at random, on the plants, on the repeat and at
    subject ends; two contexts (cutoff, reduced cutoff, x_drop). Returns
    (args, kw) of ``approx_gate``."""
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, 4, 4)
    subs = [rng.integers(0, 4, int(rng.integers(5000, 60000)))
            for _ in range(5)] + [np.tile(unit, 6000)]
    db = SequenceDB.from_records(
        [FastaRecord(f"s{i}", "", "".join("ACGT"[c] for c in x))
         for i, x in enumerate(subs)], title="gate-random")
    sub2 = db.unpacked()
    starts = np.asarray(db.starts, np.int64)
    ends = starts + np.asarray(db.lengths, np.int64)
    Q = 1 << 16
    query = rng.integers(0, 4, Q).astype(np.uint8)
    plants = []
    for _ in range(300):
        o = int(rng.integers(0, 5))
        L = int(rng.integers(60, 900))
        sp = int(rng.integers(starts[o], ends[o] - L))
        qp = int(rng.integers(8, Q - L - 8))
        query[qp: qp + L] = sub2[sp: sp + L]
        plants.append((qp, sp, L, o))
    rq0, rlen = 20001, 8000        # the repeat: query[rq0] is unit[0]
    query[rq0: rq0 + rlen] = np.tile(unit, rlen // 4 + 1)[:rlen]
    query[rng.integers(1, Q - 1, 500)] = 14
    query[rng.integers(1, Q - 1, 100)] = 4
    query[rng.integers(1, Q - 1, 100)] = 5
    query[::1021] = 15
    query[0] = query[-1] = 15
    oid = rng.integers(0, 6, n)
    s = starts[oid] + (rng.random(n) * db.lengths[oid]).astype(np.int64)
    q = rng.integers(1, Q - 2, n).astype(np.int64)
    for k in range(0, n, 3):
        qp, sp, L, o = plants[int(rng.integers(0, len(plants)))]
        d = int(rng.integers(0, L))
        q[k], s[k], oid[k] = qp + d, sp + d, o
    rep = np.arange(1, n, 97)
    d = 4 * rng.integers(500, 1500, len(rep))
    q[rep] = rq0 + d               # in phase: q - rq0 = s_loc (mod 4)
    s[rep] = starts[5] + 4 * rng.integers(1000, 5000, len(rep))
    oid[rep] = 5
    tail = np.arange(2, n, 89)
    s[tail] = ends[oid[tail]] - rng.integers(1, 8, len(tail))
    ctx = (rng.random(n) < 0.5).astype(np.int64)
    ug_q = q - rng.integers(0, 30, n)
    ug_s = s - (q - ug_q)
    ug_len = (q - ug_q) + rng.integers(11, 300, n)
    ug_score = rng.integers(10, 60, n)
    ug_score[rep] = 100
    tabs = np.array([[25, 30], [22, 10_000], [20, 16]], np.int32)

    def t(a, dt=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    args = (query_bytes(t(query, torch.uint8)),
            t(db.packed_padded(), torch.uint8),
            t(nucl_score_table_packed(1, -2)), t(tabs),
            t(starts, torch.int64), t(ends, torch.int64),
            *(t(a, torch.int64 if k in (1, 5) else torch.int32)
              for k, a in enumerate((q, s, ctx, oid, ug_q, ug_s, ug_len,
                                     ug_score))))
    return args, dict(word_size=11, concat_end=Q - 1)


def key_bounds(q, s, oid) -> dict:
    """``replay_keys``' bounds (n_sub, s_len, q_len) of numpy seeds: one
    past the largest oid, subject-local s and q."""
    return dict(n_sub=int(oid.max()) + 1, s_len=int(s.max()) + 1,
                q_len=int(q.max()) + 1)


def _chains(rng, n, word, n_oid, chain_max, dense):
    q = np.zeros(n, np.int64)
    s = np.zeros(n, np.int64)
    oid = np.zeros(n, np.int64)
    i = 0
    if dense:                      # one seed a base along one diagonal
        m = min(dense, n)
        s[:m] = 5000 + np.arange(m)
        q[:m] = s[:m] - 4000
        i = m
    while i < n:
        o = int(rng.integers(0, n_oid))
        d = int(rng.integers(0, 300000))
        pos = int(rng.integers(1, 500)) + d
        for _ in range(min(int(rng.integers(1, chain_max)), n - i)):
            q[i], s[i], oid[i] = pos - d, pos, o
            i += 1
            pos += int(rng.integers(1, 2 * word + 10))
    return q, s, oid


def random_replay_cases(device, n=262144, seed=777):
    """R's random sets, [(label, args, kw)] of ``diag_replay``: chains of
    seeds on shared diagonals spaced about a word apart (skips, saves and
    failures), shuffled, with 2% identical seeds and ends at the seed; one
    set with exact diagonals and a dense chain of 20,000 seeds (one a
    base), one with the aliasing mask of a 4,000-base query
    (``diag_table_mask``)."""
    out = []
    for label, word, mask, dense in (
            ("random chains, dense chain, exact diagonals", 11, 0, 20000),
            ("random chains, aliasing mask", 28,
             diag_table_mask(4000, 0), 0)):
        rng = np.random.default_rng(seed + word)
        q, s, oid = _chains(rng, n, word, 4, 60, dense)
        k = n // 50
        src, dst = rng.integers(0, n, k), rng.integers(0, n, k)
        q[dst], s[dst], oid[dst] = q[src], s[src], oid[src]
        score = rng.integers(0, 44, n)
        end = s - rng.integers(0, 10, n) + rng.integers(word, 60, n)
        end[::17] = s[::17]
        perm = rng.permutation(n)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a[perm])).to(
                device, torch.int32)

        key, order, shift = replay_keys(t(q), t(s), t(oid), mask,
                                        **key_bounds(q, s, oid))
        out.append((label, (key, order, t(s), t(end), t(score),
                            t(np.full(n, 22))),
                    dict(word_size=word, key_shift=shift)))
    return out


def run_arrays(word, n=65536, seed=909):
    """RR's random set as numpy arrays: (db, query, q_off, s_off, oid).
    Eight subjects; a 64 Ki-base query (a multiple of 8) with sentinels
    at both ends, stretches copied from the subjects with a mismatch, an
    N (14), an R (4) or a Y (5) every 1 to 2 * word + 2 bases, so that a
    seed on a stretch has a run of every length 0 .. word; stretches
    copied from the last bases of a subject (the subject's end inside the
    run) and to the query's last bases (the query's end inside it), and
    sentinels through the query. Half the seeds lie on the stretches, an
    eighth at subject ends, an eighth at the query's end, the rest at
    random."""
    rng = np.random.default_rng(seed + word)
    subs = [rng.integers(0, 4, int(rng.integers(3000, 40000)))
            for _ in range(8)]
    db = SequenceDB.from_records(
        [FastaRecord(f"s{i}", "", "".join("ACGT"[c] for c in x))
         for i, x in enumerate(subs)], title="run-random")
    sub2 = db.unpacked()
    starts = np.asarray(db.starts, np.int64)
    ends = starts + np.asarray(db.lengths, np.int64)
    Q = 1 << 16
    query = rng.integers(0, 4, Q).astype(np.uint8)
    plants = []
    for k in range(400):
        o = int(rng.integers(0, 8))
        L = int(rng.integers(100, 600))
        if k % 8 == 0:                    # the subject's last bases
            sp = int(ends[o] - L)
        else:
            sp = int(rng.integers(starts[o], ends[o] - L))
        qp = Q - L if k == 1 else int(rng.integers(8, Q - L - 8))
        seg = sub2[sp: sp + L].astype(np.uint8).copy()
        p = int(rng.integers(0, word))
        while p < L:                      # a break every 1 .. 2 word + 2
            seg[p] = rng.choice([(seg[p] + 1) % 4, 14, 4, 5])
            p += int(rng.integers(1, 2 * word + 3))
        query[qp: qp + L] = seg
        plants.append((qp, sp, L, o))
    query[::1531] = 15                    # none inside the last stretch
    # a seed's word lies inside its subject and the query, as the scan's
    # do (past the subject's end the host twin reads the next subject)
    oid = rng.integers(0, 8, n)
    s = starts[oid] + (rng.random(n) * (db.lengths[oid] - word)).astype(
        np.int64)
    q = rng.integers(1, Q - word, n).astype(np.int64)
    for k in range(0, n, 2):
        qp, sp, L, o = plants[int(rng.integers(0, len(plants)))]
        d = int(rng.integers(0, L - word))
        q[k], s[k], oid[k] = qp + d, sp + d, o
    end = np.arange(1, n, 8)              # word end near the subject's end
    back = rng.integers(word, 2 * word + 2, len(end))
    plant_end = plants[::8]
    for j, k in enumerate(end):
        qp, sp, L, o = plant_end[j % len(plant_end)]
        s[k] = sp + L - back[j]
        q[k] = qp + L - back[j]
        oid[k] = o
    qend = np.arange(3, n, 8)             # word end near the query's end
    qp, sp, L, o = plants[1]
    d = L - rng.integers(word, 2 * word + 2, len(qend))
    q[qend], s[qend], oid[qend] = qp + d, sp + d, o
    return db, query, q, s, oid


def random_run_cases(device, n=65536, seed=909):
    """RR's random sets, [(label, args, kw)] of ``right_run``, at words 11
    and 28 (``run_arrays``)."""
    out = []
    for word in (11, 28):
        db, query, q, s, oid = run_arrays(word, n, seed)

        def t(a, dt=torch.int32):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

        starts = np.asarray(db.starts, np.int64)
        args = (pack_query_nibbles(t(query, torch.uint8)),
                pack_subject_words(t(db.packed_padded(), torch.uint8)),
                t(starts + np.asarray(db.lengths, np.int64), torch.int64),
                t(q), t(s, torch.int64), t(oid))
        out.append((f"random seeds, word {word}, runs 0..{word}, N/R/Y, "
                    "sentinels, subject and query ends", args,
                    dict(word_size=word)))
    return out


def two_hit_arrays(n, word, window, mask, dense, seed):
    """Two-hit R's random set as numpy arrays (subject-local s): q, s,
    oid, end, score, cutoff, run. Chains on shared diagonals spaced 1 to
    2 word + window bases apart (second hits inside and outside the
    window), each chain's seeds failing or ready as their runs say
    (three in ten with a run, one in ten a double word); pairs at exactly
    s + word == last_hit + window and one base past it; single seeds on
    virgin diagonals; a dense chain of ``dense`` seeds, one a base; 2%
    identical seeds; shuffled."""
    rng = np.random.default_rng(seed + word)
    q, s, oid = _chains(rng, n, word + window // 2, 4, 60, dense)
    run = np.where(rng.random(n) < 0.7, 0, rng.integers(1, word, n))
    run[rng.random(n) < 0.1] = word
    # boundary pairs on fresh diagonals: the first seed fails as a first
    # hit (run r < word, so last_hit = s0 + word + r), the second starts
    # where s + word - last_hit - window is 0 (second hit) or 1 (first)
    m = min(n // 20, 4000) // 2 * 2
    base = n - 2 * m - n // 50
    for j in range(0, m, 2):
        i = base + j
        r0 = int(rng.integers(0, word))
        d = 400000 + 7 * j
        q0 = int(rng.integers(1, 5000))
        q1 = q0 + r0 + window + (j // 2) % 2
        q[i], s[i], oid[i], run[i] = q0, q0 + d, 2, r0
        q[i + 1], s[i + 1], oid[i + 1] = q1, q1 + d, 2
    vb = base + m                       # virgin diagonals: one seed each
    for i in range(vb, vb + n // 50):
        q[i] = int(rng.integers(1, 5000))
        s[i] = q[i] + 900000 + 3 * i
        oid[i] = 3
    k = n // 50
    src, dst = rng.integers(0, n, k), rng.integers(0, n, k)
    q[dst], s[dst], oid[dst], run[dst] = q[src], s[src], oid[src], run[src]
    score = rng.integers(0, 44, n)
    score[base: base + m] = 40          # the pairs pass when ready
    end = s - rng.integers(0, 10, n) + rng.integers(word, 60, n)
    end[::17] = s[::17]
    cutoff = np.full(n, 22)
    perm = rng.permutation(n)
    return tuple(a[perm] for a in (q, s, oid, end, score, cutoff, run))


def random_two_hit_cases(device, n=262144, seed=4040, window=40):
    """Two-hit R's random sets, [(label, args, kw)] of ``diag_replay``
    with ``window`` (``two_hit_arrays``): word 11 with exact diagonals
    and a dense chain of 20,000 seeds; word 28 with the aliasing mask of
    a 4,000-base query, the window in its length."""
    out = []
    for label, word, mask, dense in (
            ("two-hit, dense chain, exact diagonals", 11, 0, 20000),
            ("two-hit, aliasing mask", 28, diag_table_mask(4000, window),
             0)):
        q, s, oid, end, score, cutoff, run = two_hit_arrays(
            n, word, window, mask, dense, seed)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device, torch.int32)

        key, order, shift = replay_keys(t(q), t(s), t(oid), mask,
                                        **key_bounds(q, s, oid))
        out.append((label, (key, order, t(s), t(end), t(score), t(cutoff)),
                    dict(word_size=word, window=window, right_run=t(run),
                         key_shift=shift)))
    return out


def past_2g_cases(dev, n_seg=48, seg=1200):
    """K1, G, RR and R's inputs on a single random subject of 2^31 + 2^22
    bases made on ``dev`` from a seeded torch.Generator (packed bytes,
    codes and 16-base words, as the resident form holds them): a query
    of ``n_seg`` copies of its stretches from just before 2^31 to 2^31 +
    2^21 (2% substitutions, sentinels between them), and seeds along
    each copy's diagonal plus random ones past 2^31. Megablast's word
    28; each kernel's inputs come from the plain versions of the kernels
    before it, so K1's walks cross 2^31, G's and RR's read the subject
    there, and R orders and replays subject-local s past 2^31 (on int64
    coordinates: two sorts, as the packed key needs 64 bits). Returns
    {"k1", "g", "rr", "r", "r_two_hit"}: (args, kw) of
    ``ungapped_extend_window``, ``approx_gate``, ``right_run`` and
    ``diag_replay`` (window 0 and 40)."""
    from gblastn_tpu_torch.engine.search import device_matrix16
    from gblastn_tpu_torch.ops.replay import (
        approx_gate_ref,
        right_run_ref,
    )
    from gblastn_tpu_torch.ops.seeding import unpack_2na
    from gblastn_tpu_torch.ops.ungapped import (
        make_table64,
        pack_query,
        ungapped_extend_window_ref,
    )

    S = (1 << 31) + (1 << 22)
    g = torch.Generator(device=dev)
    g.manual_seed(2031)
    packed = torch.randint(0, 256, (S // 4,), generator=g, device=dev,
                           dtype=torch.uint8)
    subject2 = unpack_2na(packed)
    rng = np.random.default_rng(2031)
    where = (1 << 31) - seg // 2 + np.arange(n_seg) * ((1 << 21) // n_seg)
    parts, q_at = [np.array([15], np.uint8)], []
    for s0 in where:
        codes = subject2[int(s0): int(s0) + seg].cpu().numpy().astype(
            np.uint8)
        sub = rng.random(seg) < 0.02
        codes[sub] = (codes[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        q_at.append(sum(len(p) for p in parts))
        parts += [codes, np.array([15], np.uint8)]
    query = np.concatenate(parts)
    query = np.concatenate([query, np.full(-len(query) % 8, 15, np.uint8)])
    qs, ss = [], []
    for q0, s0 in zip(q_at, where):
        d = np.arange(0, seg - 40, 23)
        qs.append(q0 + d)
        ss.append(s0 + d)
    n_rand = 4096
    qs.append(rng.integers(1, len(query) - 40, n_rand))
    ss.append(rng.integers((1 << 31) - (1 << 20), S - 40, n_rand))
    q_np = np.concatenate(qs)
    s_np = np.concatenate(ss).astype(np.int64)
    Q, n = len(query), len(q_np)
    i32 = torch.int32
    q_t = torch.from_numpy(query).to(dev)
    q_off = torch.from_numpy(q_np.astype(np.int32)).to(dev)
    s_off = torch.from_numpy(s_np).to(dev)
    zeros = torch.zeros(n, dtype=i32, device=dev)
    k1_args = (pack_query(q_t), subject2,
               torch.from_numpy(make_table64(device_matrix16(1, -2))).to(dev),
               q_off, s_off, torch.full((n,), 20, dtype=i32, device=dev),
               torch.from_numpy(np.minimum(q_np, s_np).astype(np.int32)
                                ).to(dev),
               torch.from_numpy(np.minimum(Q - q_np, S - s_np).astype(
                   np.int32)).to(dev))
    ung = ungapped_extend_window_ref(*k1_args)
    ends = torch.full((1,), S, dtype=torch.int64, device=dev)
    rr_args = (pack_query_nibbles(q_t), pack_subject_words(packed), ends,
               q_off, s_off, zeros)
    rr_kw = dict(word_size=28)
    runs = right_run_ref(*rr_args, **rr_kw)
    g_args = (query_bytes(q_t), packed,
              torch.from_numpy(nucl_score_table_packed(1, -2).astype(
                  np.int32)).to(dev),
              torch.tensor([[22], [30], [16]], dtype=i32, device=dev),
              torch.zeros(1, dtype=torch.int64, device=dev), ends, q_off,
              s_off, zeros, zeros, *ung[:4])
    g_kw = dict(word_size=28, concat_end=Q - 1, right_run=runs)
    gated = approx_gate_ref(*g_args, **g_kw)
    key, order, shift = replay_keys(q_off, s_off, zeros, 0, n_sub=1,
                                    s_len=S, q_len=Q)
    r_args = (key, order, s_off, gated[1] + gated[2], gated[3],
              torch.full((n,), 22, dtype=i32, device=dev))
    r_kw = dict(word_size=28, right_run=runs, key_shift=shift)
    return {"k1": (k1_args, {}), "g": (g_args, g_kw), "rr": (rr_args, rr_kw),
            "r": (r_args, dict(r_kw, window=0)),
            "r_two_hit": (r_args, dict(r_kw, window=40))}
