"""The designs of the device finish's kernels, on the CPU: G's walk by
groups (csrc/approx_gate.cu's seed_walk: a group of steps taken without
a branch and kept where nothing dropped, else taken again step by step)
against the plain walk ``_reset_walk_ref`` and the host twin
``approx_ungapped_one``; the one-sort packed key of R's order
(``replay_keys``) against the two-sort order and the host's
``np.lexsort``. Inputs come from seeded numpy generators; every
comparison is exact."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gblastn_tpu_torch.engine.approx import approx_ungapped_one
from gblastn_tpu_torch.ops import replay as rp

torch.set_num_threads(1)

SHIFT = 30            # table index = score + SHIFT


def group_walk(sc, x, steps):
    """(best, pos, steps taken) of the reset walk over the step scores
    ``sc``, as csrc/approx_gate.cu's seed_walk takes it: groups of
    ``steps``; a full group runs through every step (scores past the
    budget are the kernel's unloaded bytes: here a large score, which must
    not count) and is kept where no step dropped; otherwise, and in the
    last, partial group, it is taken again step by step up to the drop or
    the budget, and the walk ends."""
    n = len(sc)
    total, best, pos, done, taken = 0, 0, 0, 0, 0
    while done < n:
        rem = n - done
        g = list(sc[done: done + steps]) + [99] * max(steps - rem, 0)
        s2, b2, k2, drop = total, best, 0, False
        for k, v in enumerate(g):
            s2 += v
            if s2 > 0:
                b2, k2, s2 = b2 + s2, k + 1, 0
            drop = drop or s2 < -x
        if not drop and rem >= steps:
            total, best = s2, b2
            pos = done + k2 if k2 else pos
            taken += steps
            done += steps
            continue
        for k in range(min(steps, rem)):
            total += g[k]
            taken += 1
            if total > 0:
                best, pos, total = best + total, done + k + 1, 0
            elif total < -x:
                break
        break
    return best, pos, taken


def _sequences(rng):
    """(scores, x) pairs: random walks of 0 to 400 steps (positive and
    negative drifts, long runs), ties at the maximum, drops to exactly -x
    (no stop) and to -x - 1 (a stop), walks of 0 and 1 steps."""
    out = [([], 5), ([4], 5), ([-6], 5), ([-7], 5), ([0], 3),
           ([3, -3, 3], 9),                 # a tie at the best: pos 1
           ([2, -2, 2, -2, 3], 9),           # ties, then a rise: pos 5
           ([5, -10, 4, 1, -1], 10),         # exactly -x: no stop
           ([5, -11, 9], 10),                # -x - 1: stops at step 2
           ([1] * 70 + [-20] + [1] * 50, 19)]
    for k in range(60):
        n = int(rng.integers(0, 400))
        drift = rng.choice([-2, -1, 0, 1])
        sc = np.clip(rng.integers(-6, 6, n) + drift, -SHIFT, SHIFT)
        if k % 5 == 0 and n > 10:            # plateaus at the maximum
            sc[rng.integers(0, n, n // 4)] = 0
        out.append(([int(v) for v in sc], int(rng.integers(1, 40))))
    return out


def _ref_walks(seqs):
    """_reset_walk_ref over every sequence at once: step j of walk w reads
    qbytes[q0_w + j] ^ packed[0] = score + SHIFT."""
    qb = np.concatenate([[0]] + [np.asarray(sc, np.int64) + SHIFT
                                 for sc, _ in seqs])
    lens = np.array([len(sc) for sc, _ in seqs], np.int64)
    q0 = np.concatenate([[0], np.cumsum(lens)[:-1]])
    table = torch.arange(256, dtype=torch.int64) - SHIFT
    n = len(seqs)
    best, pos, steps = rp._reset_walk_ref(
        torch.from_numpy(qb), torch.zeros(1, dtype=torch.int64), table,
        torch.from_numpy(q0), 1, torch.zeros(n, dtype=torch.int64), 0,
        torch.from_numpy(lens), torch.tensor([x for _, x in seqs]))
    return best.tolist(), pos.tolist(), steps.tolist()


def _host_walk(sc, x):
    """approx_ungapped_one's right walk over ``sc`` (its left walk has no
    step): (best, pos)."""
    n = len(sc)
    byte = np.asarray(sc, np.int64) + SHIFT
    query = np.zeros(4 * n + 8, np.uint8)
    for k, sh in enumerate((6, 4, 2, 0)):
        query[1 + k: 1 + k + 4 * n: 4] = (byte >> sh) & 3
    table = np.arange(256, dtype=np.int32) - SHIFT
    score, _qs, _ss, new_q = approx_ungapped_one(
        query, 4 * n + 1, np.zeros(n + 1, np.uint8), 0, 4 * n, 1, 0, x,
        table)
    return score, (new_q + 1) // 4


def test_group_walk_equals_the_plain_and_host_walks():
    """The walk by groups of the kernel's 16 steps gives the plain walk's
    best, pos and steps and the host twin's best and pos, ties, exact
    drops, walks shorter than a group and empty walks included."""
    rng = np.random.default_rng(1010)
    seqs = _sequences(rng)
    best, pos, steps = _ref_walks(seqs)
    for w, (sc, x) in enumerate(seqs):
        want = (best[w], pos[w], steps[w])
        assert _host_walk(sc, x) == want[:2], (w, sc[:20], x)
        assert group_walk(sc, x, 16) == want, w
    # the hand-made cases mean what they say
    assert best[5:9] == [3, 3, 5, 5] and pos[5:9] == [1, 5, 1, 1]
    assert steps[7:9] == [5, 2]


def _lexsort_order(q, s, oid, mask):
    diag = (s - q) & mask if mask else s - q
    return np.lexsort((q, s, diag, oid))


def _seeds(rng, n, n_sub, s_len, q_len):
    """Seeds on shared diagonals (negative ones too), 5% repeated
    verbatim, over ``n_sub`` subjects."""
    oid = rng.integers(0, n_sub, n)
    q = rng.integers(0, q_len, n)
    s = rng.integers(0, s_len, n)
    k = n // 3                                  # chains: s - q shared
    d = rng.integers(-q_len + 1, s_len, k // 8)[rng.integers(0, k // 8, k)]
    s[:k] = np.clip(q[:k] + d, 0, s_len - 1)
    src, dst = rng.integers(0, n, n // 20), rng.integers(0, n, n // 20)
    q[dst], s[dst], oid[dst] = q[src], s[src], oid[src]
    return q, s, oid


@pytest.mark.parametrize("n_sub,s_len,q_len,mask", [
    (5, 3000, 2000, 0),
    (5, 3000, 2000, 1023),          # an aliasing mask
    (1, 70000, 9000, 0),            # one subject: no oid bits
    (300, 50, 4000, 4095),
])
def test_packed_key_order_equals_the_two_sorts(n_sub, s_len, q_len, mask):
    """One sort of the packed key gives the two sorts' order, which is the
    host's stable lexsort over (oid, masked diagonal, s, q); its segments
    (key >> key_shift) are the primary key's, and R's plain version saves
    the same seeds on both."""
    rng = np.random.default_rng(77 + n_sub + mask)
    q, s, oid = _seeds(rng, 6000, n_sub, s_len, q_len)
    t = [torch.from_numpy(a.astype(np.int32)) for a in (q, s, oid)]
    bounds = dict(n_sub=n_sub, s_len=s_len, q_len=q_len)
    k1, o1, shift = rp.replay_keys(*t, mask, **bounds)
    k2, o2, zero = rp.replay_keys(*t, mask, **bounds, two_sorts=True)
    assert shift > 0 and zero == 0
    want = _lexsort_order(q, s, oid, mask)
    np.testing.assert_array_equal(o1.numpy(), want)
    np.testing.assert_array_equal(o2.numpy(), want)
    seg1 = (k1 >> shift).numpy()
    seg2 = k2.numpy()
    np.testing.assert_array_equal(seg1[1:] != seg1[:-1],
                                  seg2[1:] != seg2[:-1])
    end = torch.from_numpy((s + rng.integers(0, 40, len(s))).astype(
        np.int32))
    score = torch.from_numpy(rng.integers(0, 44, len(s)).astype(np.int32))
    cut = torch.full_like(score, 22)
    a = rp.diag_replay(k1, o1, t[1], end, score, cut, word_size=11,
                       key_shift=shift)
    b = rp.diag_replay(k2, o2, t[1], end, score, cut, word_size=11)
    assert torch.equal(a, b) and 0 < int(a.sum()) < len(s)


@pytest.mark.parametrize("mask", [0, 255])
def test_packed_key_at_63_bits_and_past(mask):
    """At exactly 63 bits the key is packed and sorted once (in the same
    order); one bit more and replay_keys takes the two sorts."""
    rng = np.random.default_rng(5 + mask)
    # mask 0: oid 10 + diagonal 27 + s 26 bits; mask 255: 21 + 8 + 17 + 17
    b = (dict(n_sub=1 << 10, s_len=1 << 26, q_len=1 << 26) if not mask
         else dict(n_sub=1 << 21, s_len=1 << 17, q_len=1 << 17))
    layout = rp.key_layout(b["n_sub"], b["s_len"], b["q_len"], mask)
    assert layout is not None
    assert (b["n_sub"] - 1).bit_length() + sum(layout) == 63
    q, s, oid = _seeds(rng, 3000, 40, 5000, 3000)
    q[:50] = b["q_len"] - 1 - np.arange(50)       # the bounds' own edges
    s[50:100] = b["s_len"] - 1 - np.arange(50)
    oid[100:150] = b["n_sub"] - 1
    t = [torch.from_numpy(a.astype(np.int32)) for a in (q, s, oid)]
    want = _lexsort_order(q, s, oid, mask)
    _k, order, shift = rp.replay_keys(*t, mask, **b)
    assert shift == layout[1] + layout[2]
    np.testing.assert_array_equal(order.numpy(), want)
    wide = dict(b, n_sub=b["n_sub"] * 2)
    assert rp.key_layout(wide["n_sub"], wide["s_len"], wide["q_len"],
                         mask) is None
    _k, order, shift = rp.replay_keys(*t, mask, **wide)
    assert shift == 0
    np.testing.assert_array_equal(order.numpy(), want)


@pytest.mark.parametrize("field,value", [
    ("q", 3000), ("s", 5000), ("oid", 40), ("s", -1)])
def test_replay_keys_refuses_values_past_their_bounds(field, value):
    """A q, s or oid outside the bounds the key was packed for raises
    ValueError on the CPU: its field would overwrite the next, and the
    order would be wrong with no error."""
    rng = np.random.default_rng(31)
    q, s, oid = _seeds(rng, 500, 40, 5000, 3000)
    args = {k: torch.from_numpy(a.astype(np.int32))
            for k, a in (("q", q), ("s", s), ("oid", oid))}
    bounds = dict(n_sub=40, s_len=5000, q_len=3000)
    rp.replay_keys(*args.values(), 0, **bounds)     # at the bounds: taken
    args[field][7] = value
    with pytest.raises(ValueError, match=f"{field} outside"):
        rp.replay_keys(*args.values(), 0, **bounds)
