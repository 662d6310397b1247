"""RR's design and the sort's range flag, on the CPU.

``rr_windows`` is a torch emulation of csrc/right_run.cu's arithmetic,
sixteen bases a step: the query window from two funnel shifts of three
4na-nibble words, the subject window from one funnel shift of two code
words, the subject codes spread into one-hot nibbles, and the run from
the leading zero nibbles of their XOR, capped at the limit. It is held
equal to RR's plain version ``right_run_ref`` and to the JAX package's
``right_run_packed`` on RR's random sets at words 11 and 28, with every
query and subject phase. ``key_range_flag`` is held to its bits, and
``run_seeding`` with the flag set raises at its fetch. Inputs come from
seeded numpy generators; every comparison is exact."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gblastn_tpu.ops.seeding import pack_query_nibbles as jax_pack_nib
from gblastn_tpu.ops.seeding import pack_subject_words as jax_pack_words
from gblastn_tpu.ops.seeding import right_run_packed
from gblastn_tpu_torch.engine import seeding as tseed
from gblastn_tpu_torch.ops import replay as rp
from gblastn_tpu_torch.ops.seeding import pack_query_nibbles, pack_subject_words
from gblastn_tpu_torch.tools import replay_sets
from tests.test_torch_two_hit import _batch

torch.set_num_threads(1)

U32 = 0xFFFFFFFF
LOW = 0x1111111111111111        # bit 0 of each nibble


def _shr(x, k: int):
    """Logical right shift of int64 bit patterns (as uint64) by k > 0."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def funnel_l(lo, hi, sh):
    """__funnelshift_l(lo, hi, sh) for 32-bit words and sh in [0, 31]:
    the high 32 bits of (hi:lo) << sh."""
    return ((hi << sh) | (lo >> (32 - sh))) & U32


def one_hot(codes):
    """The kernel's one_hot: sixteen 2-bit codes (the first in bits 31-30)
    as sixteen nibbles (the first in bits 63-60), each 1 << code."""
    x = codes
    x = (x | (x << 16)) & 0x0000FFFF0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0F
    x = (x | (x << 2)) & 0x3333333333333333
    y = _shr(x, 1)
    return ((~(x | y) & LOW) | ((x & ~y & LOW) << 1)
            | ((y & ~x & LOW) << 2) | ((x & y & LOW) << 3))


def lead_nibbles(diff):
    """__clzll(diff) >> 2: the leading zero nibbles of a 64-bit pattern,
    16 where it is 0."""
    nz = torch.stack([_shr(diff, 60 - 4 * j) & 15 if j < 15 else diff & 15
                      for j in range(16)], dim=1) != 0
    return torch.where(nz.any(dim=1), nz.int().argmax(dim=1), 16)


def rr_windows(query_nib, subject_w, sub_ends, q_off, s_off, oid, *,
               word_size: int):
    """The kernel's walk for every seed at once: (runs, windows taken)."""
    W = word_size
    n = q_off.numel()
    q8, s16, n_sub = query_nib.numel(), subject_w.numel(), sub_ends.numel()
    o = oid.long()
    q, s = q_off.long() + W, s_off.long() + W
    live = ((o >= 0) & (o < n_sub) & (q >= 0) & (s >= 0) & (q < 8 * q8)
            & (s < 16 * s16))
    q, s = torch.where(live, q, 0), torch.where(live, s, 0)
    q_last = torch.minimum((q + W - 1) >> 3, torch.tensor(q8 - 1))
    s_last = torch.minimum((s + W - 1) >> 4, torch.tensor(s16 - 1))

    def word_at(words, i, last):
        v = words[i.clamp(0, words.numel() - 1)] & U32
        return torch.where(i <= last, v, 0)

    qw, sw = q >> 3, s >> 4
    qsh, ssh = (q & 7) << 2, (s & 15) << 1
    w0, w1, w2 = (word_at(query_nib, qw + k, q_last) for k in range(3))
    u0, u1 = (word_at(subject_w, sw + k, s_last) for k in range(2))
    s_hi = sub_ends[o.clamp(0, n_sub - 1)].clamp(max=16 * s16)
    lim = torch.minimum(torch.minimum(torch.full_like(q, W), 8 * q8 - q),
                        s_hi - s).clamp(min=0)
    lim = torch.where(live, lim, 0)
    run = torch.zeros(n, dtype=torch.int64)
    steps = torch.zeros(n, dtype=torch.int64)
    walking = run < lim
    while walking.any():
        qwin = (funnel_l(w1, w0, qsh) << 32) | funnel_l(w2, w1, qsh)
        diff = qwin ^ one_hot(funnel_l(u1, u0, ssh))
        left = lim - run
        m = lead_nibbles(diff)
        stop = (m < 16) | (left <= 16)
        run = torch.where(walking, run + torch.where(stop, torch.minimum(
            m, left), 16), run)
        steps += walking.long()
        walking &= ~stop
        qw, sw = qw + 2, sw + 1
        w0, u0 = w2, u1
        w1 = word_at(query_nib, qw + 1, q_last)
        w2 = word_at(query_nib, qw + 2, q_last)
        u1 = word_at(subject_w, sw + 1, s_last)
    return run.to(torch.int32), steps


def _t(a, dt=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dt)


@pytest.mark.parametrize("word", [11, 28])
def test_window_arithmetic_equals_the_plain_walk_and_jax(word):
    """The emulated kernel gives right_run_ref's runs and JAX's
    right_run_packed's on RR's random set (runs of every length 0..word,
    N/R/Y, sentinels, subject and query ends), with seeds at every one of
    the 8 query and 16 subject phases; a run takes one window at word 11
    and at most two at word 28."""
    db, query, q, s, oid = replay_sets.run_arrays(word, n=16000)
    ends = np.asarray(db.starts, np.int64) + np.asarray(db.lengths, np.int64)
    args = (pack_query_nibbles(_t(query, torch.uint8)),
            pack_subject_words(_t(db.packed_padded(), torch.uint8)),
            _t(ends, torch.int64), _t(q), _t(s), _t(oid))
    got, steps = rr_windows(*args, word_size=word)
    want = rp.right_run_ref(*args, word_size=word)
    assert torch.equal(got, want)
    packed = right_run_packed(
        jax_pack_nib(jnp.asarray(query)),
        jax_pack_words(jnp.asarray(db.packed_padded())),
        jnp.asarray(q.astype(np.int32)), jnp.asarray(s.astype(np.int32)),
        jnp.ones(len(q), bool), jnp.asarray(ends[oid].astype(np.int32)),
        word_size=word)
    np.testing.assert_array_equal(got.numpy(), np.asarray(packed))
    assert set(np.unique(got.numpy())) == set(range(word + 1))
    # every phase pair among the seeds that compare a base, and among
    # those whose run reaches the second window at word 28
    phase = ((q + word) % 8) * 16 + (s + word) % 16
    assert len(set(phase[steps.numpy() > 0])) == 128
    assert int(steps.max()) == (1 if word <= 16 else 2)
    if word > 16:
        assert len(set(phase[got.numpy() >= 16])) == 128


def test_one_hot_and_funnel_shift_bit_order():
    """The first code lands in the highest nibble, each code c as 1 << c;
    a funnel shift by 4p starts the window at nibble p of the first
    word."""
    codes = torch.tensor([0b00_01_10_11 << 24 | 0b11 << 22])
    assert hex(int(one_hot(codes))) == hex(0x1248_8111_1111_1111)
    w0, w1 = torch.tensor([0x12345678]), torch.tensor([0x9ABCDEF0])
    assert [int(funnel_l(w1, w0, torch.tensor([4 * p])))
            for p in (0, 1, 7)] == [0x12345678, 0x23456789, 0x89ABCDEF]
    assert int(lead_nibbles(torch.tensor([0]))) == 16
    assert int(lead_nibbles(torch.tensor([-1]))) == 0       # top bit set
    assert int(lead_nibbles(torch.tensor([0x0000_0100_0000_0000]))) == 5


@pytest.mark.parametrize("field,value,bit", [
    ("oid", 40, 1), ("oid", -1, 1), ("s", 5000, 2), ("s", -1, 2),
    ("q", 3000, 4), ("q", -7, 4)])
def test_key_range_flag_marks_each_field_past_its_bound(field, value, bit):
    """key_range_flag is 0 at the bounds and sets its field's bit for a
    value past them; check_key_flag names the field."""
    rng = np.random.default_rng(41)
    n = 500
    seeds = {"q": rng.integers(0, 3000, n), "s": rng.integers(0, 5000, n),
             "oid": rng.integers(0, 40, n)}
    seeds["q"][3], seeds["s"][4], seeds["oid"][5] = 2999, 4999, 39
    bounds = dict(n_sub=40, s_len=5000, q_len=3000)

    def flag():
        return rp.key_range_flag(_t(seeds["q"]), _t(seeds["s"]),
                                 _t(seeds["oid"]), **bounds)
    zero = flag()
    assert zero.dtype == torch.int32 and zero.dim() == 0 and int(zero) == 0
    rp.check_key_flag(zero)
    seeds[field][11] = value
    got = flag()
    assert int(got) == bit
    with pytest.raises(ValueError, match=f"{field} outside"):
        rp.check_key_flag(got)
    seeds["q" if field != "q" else "s"][12] = -1
    assert int(flag()) == bit | (4 if field != "q" else 2)
    assert int(rp.key_range_flag(*(_t(np.zeros(0)),) * 3, **bounds)) == 0


def test_run_seeding_raises_the_key_flag_at_the_fetch(monkeypatch):
    """A batch whose subject-local s lies past the bound the sort packed
    it for (the longest subject, here made too short): the flag rides in
    the head of run_seeding's one fetch and raises ValueError there,
    before a row is used. (The sort itself takes the true bound here, so
    that its own CPU check does not raise first.)"""
    batch = _batch("mb")
    res = batch.seed_dev.resident
    true_len, res.longest = res.longest, 100
    real = tseed.replay_keys

    def sort_true_bound(q, s, o, mask, **bounds):
        return real(q, s, o, mask, **dict(bounds, s_len=true_len))

    def no_rows(*a, **kw):
        raise AssertionError("a row was used before the flag was checked")
    monkeypatch.setattr(tseed, "replay_keys", sort_true_bound)
    monkeypatch.setattr(tseed, "sort_by_score_order", no_rows)
    with pytest.raises(ValueError, match="s outside the bounds"):
        tseed.run_seeding(batch.seed_dev, **batch.seed_kw)
    res.longest = true_len
    monkeypatch.undo()
    assert len(tseed.run_seeding(batch.seed_dev, **batch.seed_kw)) > 3
