"""K1, K2, the table gather, and the device finish's RR, G and R on the card
against their plain versions, on the same CUDA tensors.

Needs a CUDA card (skips elsewhere). Imports no JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gblastn_tpu_torch.engine.search import device_matrix16
from gblastn_tpu_torch.ops.ungapped import (
    make_table64,
    pack_query,
    ungapped_extend_window,
    ungapped_extend_window_ref,
)


def _k1_random(dev):
    """K1's random set: planted matches, N, R and sentinels in the query,
    whole-buffer budgets."""
    rng = np.random.default_rng(99)
    S, Q, n = 50000, 40000, 8192
    subject = rng.integers(0, 4, S).astype(np.int8)
    query = rng.integers(0, 4, Q).astype(np.uint8)
    for _ in range(50):
        so = int(rng.integers(0, S - 400))
        qo = int(rng.integers(0, Q - 400))
        query[qo: qo + 350] = subject[so: so + 350]
    query[rng.integers(0, Q, 300)] = 14      # N
    query[rng.integers(0, Q, 100)] = 4       # R
    query[::401] = 15                        # sentinels
    q_off = rng.integers(0, Q, n)
    s_off = rng.integers(0, S, n)
    max_l = np.minimum(q_off, s_off)
    max_r = np.minimum(Q - q_off, S - s_off)
    i32 = torch.int32

    def t(a, dt=i32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    return (
        pack_query(t(query, torch.uint8)), t(subject, torch.int8),
        t(make_table64(device_matrix16(1, -2))), t(q_off),
        t(s_off, torch.int64),
        t(rng.choice([16, 22], n)), t(max_l), t(max_r),
    )


def _k1_mixed(dev):
    """K1's mixed set, every array a view at an odd offset into a larger
    buffer: even seeds on a 1,600-base planted match (walks of ~1,500
    steps), odd seeds at random (walks of a few steps) in the same
    warps; a stretch of 1-base contexts (a sentinel every other byte);
    x = 0 on every fifth seed, zero budgets on every seventh, and
    budgets cut short on every eleventh."""
    rng = np.random.default_rng(5)
    S, Q, n = 60000, 50000, 4096
    subject = rng.integers(0, 4, S).astype(np.int8)
    query = rng.integers(0, 4, Q).astype(np.uint8)
    qp0, sp0 = 10000, 30000
    query[qp0: qp0 + 1600] = subject[sp0: sp0 + 1600]
    query[30000:34000:2] = 15
    q_off = rng.integers(0, Q, n)
    s_off = rng.integers(0, S, n)
    d = rng.integers(0, 1600, n // 2)
    q_off[0::2] = qp0 + d
    s_off[0::2] = sp0 + d
    q_off[2::6] = rng.integers(30000, 34000, len(q_off[2::6]))
    max_l = np.minimum(q_off, s_off)
    max_r = np.minimum(Q - q_off, S - s_off)
    max_l[::7] = 0
    max_r[::7] = 0
    max_l[3::11] //= 3
    max_r[3::11] //= 5
    x = rng.choice([16, 22, 30], n)
    x[::5] = 0

    def view(a, dt, off):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
        buf = torch.zeros(t.numel() + off, dtype=dt, device=dev)
        buf[off:] = t
        return buf[off:]

    i32 = torch.int32
    packed = pack_query(torch.from_numpy(query).to(dev)).cpu().numpy()
    return (view(packed, torch.uint8, 3), view(subject, torch.int8, 7),
            view(make_table64(device_matrix16(2, -3)), i32, 1),
            view(q_off, i32, 1), view(s_off, torch.int64, 3),
            view(x, i32, 1),
            view(max_l, i32, 1), view(max_r, i32, 1))


@pytest.mark.cuda
def test_kernel_bit_equal_to_plain_version():
    """K1 bit-equal to its plain version on the random set and on the
    mixed set."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gblastn_tpu_torch.ops.ungapped import check_flags

    dev = torch.device("cuda:0")
    for args in (_k1_random(dev), _k1_mixed(dev)):
        want = ungapped_extend_window_ref(*args)
        before = ungapped_extend_window.launches
        got = ungapped_extend_window(*args)
        torch.cuda.synchronize()
        assert ungapped_extend_window.launches == before + 1
        check_flags(got[4])
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g, w)
    flags = want[4].cpu().numpy()
    assert (flags & 2).any() and (flags & 4).any()
    assert int(want[2].max()) > 1400            # the long walks


@pytest.mark.cuda
def test_kernel_in_a_cuda_graph_and_its_range_flags():
    """K1's wrapper waits on nothing: a CUDA graph captures it (counted
    in ``captured``, not ``launches``) and its replays equal the plain
    version. A seed whose budget reaches outside the query, or whose
    x_drop is past the kernel's limit, launches all the same and raises
    at the fetch (check_flags); the other seeds keep their results."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gblastn_tpu_torch.ops.ungapped import (
        FLAG_RANGE,
        X_LIMIT,
        check_flags,
    )

    dev = torch.device("cuda:0")
    args = _k1_mixed(dev)
    want = ungapped_extend_window_ref(*args)
    ungapped_extend_window(*args)                       # warm-up
    torch.cuda.synchronize()
    launches = ungapped_extend_window.launches
    captured = ungapped_extend_window.captured
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = ungapped_extend_window(*args)
    assert ungapped_extend_window.captured == captured + 1
    assert ungapped_extend_window.launches == launches
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        for a, w in zip(got, want):
            assert torch.equal(a, w)
    bad = list(args)
    bad[6] = args[6].clone()
    bad[6][5] = args[3][5] + 1                 # max_l > q_off
    bad[7] = args[7].clone()
    bad[7][9] = args[0].numel()                # past the query's end
    bad[5] = args[5].clone()
    bad[5][12] = X_LIMIT                       # x_drop past the kernel's
    out = ungapped_extend_window(*bad)                  # no raise
    f = out[4].cpu().numpy()
    assert f[5] == f[9] == f[12] == FLAG_RANGE
    assert int(out[2][5]) == 0 and int(out[0][5]) == int(args[3][5])
    with pytest.raises(ValueError, match="outside"):
        check_flags(out[4])
    keep = torch.ones(len(f), dtype=torch.bool, device=dev)
    keep[[5, 9, 12]] = False
    for a, w in zip(out, want):
        assert torch.equal(a[keep], w[keep])


@pytest.mark.cuda
def test_gapped_kernel_bit_equal_to_plain_version():
    """K2 against its plain version on a small random job set: both
    scorings, planted stretches with a long insertion (band edge), N in
    the query, a short row budget (FLAG_ROWS) and empty jobs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gblastn_tpu_torch.ops.gapped import (
        banded_gapped_scores,
        banded_gapped_scores_ref,
    )

    dev = torch.device("cuda:0")
    for args, kw in _gapped_cases(dev):
        before = banded_gapped_scores.launches
        got = banded_gapped_scores(*args, **kw)
        want = banded_gapped_scores_ref(*args, **kw)
        torch.cuda.synchronize()
        assert banded_gapped_scores.launches == before + 1
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g, w)
        flags = want[1].cpu().numpy()
        assert (flags & 1).any() and (flags & 2).any()


@pytest.mark.cuda
def test_gapped_kernel_in_a_cuda_graph():
    """K2's launch waits on nothing, so a CUDA graph captures it: after a
    replay the graph's outputs equal the plain version's, the capture is
    counted in ``captured`` and not in ``launches``, and a job set that
    check_jobs did not check is refused before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    from gblastn_tpu_torch.ops.gapped import (
        banded_gapped_scores,
        banded_gapped_scores_ref,
    )

    dev = torch.device("cuda:0")
    for args, kw in _gapped_cases(dev):
        want = banded_gapped_scores_ref(*args, **kw)
        banded_gapped_scores(*args, **kw)           # warm-up, outside
        torch.cuda.synchronize()
        launches = banded_gapped_scores.launches
        captured = banded_gapped_scores.captured
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            got = banded_gapped_scores(*args, **kw)
        assert banded_gapped_scores.captured == captured + 1
        assert banded_gapped_scores.launches == launches
        for _ in range(2):
            g.replay()
            torch.cuda.synchronize()
            for a, w in zip(got, want):
                assert torch.equal(a, w)
        unchecked = dataclasses.replace(args[3], checked=None)
        with pytest.raises(ValueError, match="check_jobs"):
            banded_gapped_scores(*args[:3], unchecked, **kw)
        assert banded_gapped_scores.launches == launches


def _gapped_cases(dev):
    """((query, subject, matrix, jobs), keywords) on ``dev`` for both
    scorings: a small random job set with planted stretches and a long
    insertion (band edge), N in the query, a short row budget (FLAG_ROWS)
    and empty jobs; jobs checked on the host (check_jobs), then moved; the
    third case reads query and subject through views at odd byte offsets
    (the kernel's copies align addresses, not indices)."""
    from gblastn_tpu_torch.engine.gapped import device_gapped_params
    from gblastn_tpu_torch.ops.gapped import check_jobs, gapped_jobs
    from gblastn_tpu_torch.params.options import (
        blastn_options,
        megablast_options,
    )

    rng = np.random.default_rng(11)
    S, Q, n = 40000, 30000, 600
    sub = rng.integers(0, 4, S).astype(np.int8)
    q = rng.integers(0, 4, Q).astype(np.uint8)
    qs = rng.integers(600, Q - 600, n)
    ss = rng.integers(600, S - 600, n)
    for k in range(0, n, 2):
        L = 400
        seg = sub[ss[k]: ss[k] + L].astype(np.uint8).copy()
        mut = rng.random(L) < 0.03
        seg[mut] = rng.integers(0, 4, int(mut.sum()))
        if k % 6 == 0:
            seg = np.concatenate([seg[:150], rng.integers(0, 4, 70).astype(
                np.uint8), seg[150:]])
        qs[k] = min(qs[k], Q - len(seg) - 1)
        q[qs[k]: qs[k] + len(seg)] = seg
    q[rng.random(Q) < 0.01] = 14
    q_lo = np.maximum(qs - rng.integers(0, 600, n), 0)
    q_hi = np.minimum(qs + rng.integers(0, 600, n), Q)
    s_lo = np.maximum(ss - rng.integers(0, 600, n), 0)
    s_hi = np.minimum(ss + rng.integers(0, 600, n), S)
    q_hi[1::7] = qs[1::7]
    s_lo[2::9] = ss[2::9]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def view(a, off):
        """a on the card as a view ``off`` bytes into a larger buffer."""
        buf = torch.zeros(len(a) + off, dtype=t(a[:1]).dtype, device=dev)
        buf[off:] = t(a)
        return buf[off:]

    h = torch.from_numpy
    cases = []
    for opts, gxd, offs in ((blastn_options(), 33, (0, 0)),
                            (megablast_options(), 27, (0, 0)),
                            (blastn_options(), 33, (3, 7))):
        mat, _dbl, go, ge, xd = device_gapped_params(opts, gxd)
        x = np.where(rng.random(n) < 0.1, 400, xd).astype(np.int32)
        jobs = check_jobs(gapped_jobs(h(qs), h(ss), h(q_lo), h(q_hi),
                                      h(s_lo), h(s_hi), h(x)), Q, S, 256)
        cases.append(((view(q, offs[0]), view(sub, offs[1]), t(mat),
                       jobs.to(dev)),
                      dict(rows=256, gap_open=go, gap_extend=ge)))
    return cases


@pytest.mark.cuda
def test_table_gather_bit_equal_to_plain_version():
    """P1-P3: both modes against the plain version, numpy's tab[idx] and
    torch.take at P1's and P3's shapes and 16 Mi probes; the staged mode
    on a 128 KiB table (one block, above the 48 KiB that needs the
    shared-memory opt-in) and on P1-P3's own 2 MiB table (a cluster of
    16 blocks); ragged probe counts (the scalar tail); index and table
    views at an odd element offset (the scalar path, the unaligned head
    and tail of each slice); the refusal above the staged capacity."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gblastn_tpu_torch.ops.gather import (
        MAX_STAGED_ENTRIES,
        max_active_clusters,
        slice_layout,
        slice_smem_bytes,
        table_gather,
        table_gather_ref,
    )

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(1)
    buf = torch.from_numpy(rng.integers(0, 1 << 30, 4 ** 12 // 32 + 8,
                                        np.int32)).to(dev)
    tab = buf[:4 ** 12 // 32]
    c, sl, _ = slice_layout(tab.numel())
    assert (c, sl) == (16, 32768)
    pv_fits = max_active_clusters(0, c, slice_smem_bytes(sl)) > 0

    def check(t, i, staged):
        if staged and t.numel() > 32768 and not pv_fits:
            with pytest.raises(RuntimeError, match="no cluster of 16"):
                table_gather(t, i, staged=True)
            return
        before = table_gather.launches
        got = table_gather(t, i, staged=staged)
        want = table_gather_ref(t, i)
        torch.cuda.synchronize()
        assert table_gather.launches == before + 1
        assert got.is_cuda and got.shape == i.shape
        assert torch.equal(got, want)
        assert torch.equal(got.reshape(-1), torch.take(t, i.long()).reshape(-1))
        assert np.array_equal(got.cpu().numpy(),
                              t.cpu().numpy()[i.cpu().numpy()])

    def modes(t, i):
        return ((t, i, False), (t[:32768], i & 32767, True), (t, i, True))

    for shape in ((8, 128), (2048, 128), (16 * 2**20,)):
        idx = torch.from_numpy(rng.integers(0, tab.numel(), shape,
                                            np.int32)).to(dev)
        for args in modes(tab, idx):
            check(*args)
    for n in (1, 3, 1023, 262_145):
        ibuf = torch.from_numpy(rng.integers(0, tab.numel(), n + 1,
                                             np.int32)).to(dev)
        for i in (ibuf[:n], ibuf[1:]):          # aligned; odd offset
            for args in modes(tab, i):
                check(*args)
            for args in modes(buf[1:1 + tab.numel()], i):   # odd table
                check(*args)
    over = torch.zeros(MAX_STAGED_ENTRIES + 1, dtype=torch.int32,
                       device=dev)
    before = table_gather.launches
    with pytest.raises(ValueError, match="at most"):
        table_gather(over, idx, staged=True)
    assert table_gather.launches == before
    assert torch.equal(table_gather(over, idx[:1000]),
                       torch.zeros(1000, dtype=torch.int32, device=dev))


@pytest.mark.cuda
def test_table_gather_counts_the_kernels_a_graph_runs():
    """A launch recorded while a CUDA graph is captured counts in
    ``captured``, not ``launches``; graph_ms adds it to ``launches`` at
    each of its two replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gblastn_tpu_torch.ops.gather import table_gather
    from gblastn_tpu_torch.tools.timing import graph_ms

    dev = torch.device("cuda:0")
    tab = torch.arange(4096, dtype=torch.int32, device=dev)
    idx = torch.arange(0, 4096, 3, dtype=torch.int32, device=dev)
    launches, captured = table_gather.launches, table_gather.captured
    ms = graph_ms(lambda: table_gather(tab, idx), reps=10,
                  counted=(table_gather,))
    assert ms > 0
    assert table_gather.captured == captured + 10
    # one warm-up call, then two replays of ten
    assert table_gather.launches == launches + 1 + 2 * 10


@pytest.mark.cuda
def test_gate_and_replay_bit_equal_to_plain_versions():
    """G and R against their plain versions on their random sets (the
    long repeat, ambiguity codes and subject ends for G; a dense chain,
    identical seeds and the aliasing mask for R), also replayed from a
    CUDA graph that captured each wrapper (counted in ``captured``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gblastn_tpu_torch.ops.replay import (
        FLAG_DEMOTE,
        approx_gate,
        approx_gate_ref,
        check_gate_flags,
        diag_replay,
        diag_replay_ref,
    )
    from gblastn_tpu_torch.tools.replay_sets import (
        random_gate_case,
        random_replay_cases,
    )

    dev = torch.device("cuda:0")
    g_args, g_kw = random_gate_case(dev)
    cases = [(approx_gate, approx_gate_ref, g_args, g_kw)] + [
        (diag_replay, diag_replay_ref, a, kw)
        for _label, a, kw in random_replay_cases(dev)]
    for fn, ref, args, kw in cases:
        want = ref(*args, **kw)
        want = want if isinstance(want, tuple) else (want,)
        before = fn.launches
        got = fn(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g, w)
        captured, launches = fn.captured, fn.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(*args, **kw)
        assert fn.captured == captured + 1 and fn.launches == launches
        out = out if isinstance(out, tuple) else (out,)
        graph.replay()
        torch.cuda.synchronize()
        for g, w in zip(out, want):
            assert torch.equal(g, w)
    g_flags = approx_gate_ref(*g_args, **g_kw)[4].cpu().numpy()
    check_gate_flags(g_flags)
    assert (g_flags & FLAG_DEMOTE).any()


@pytest.mark.cuda
def test_gate_range_flag_raises():
    """A seed whose approximate walk would read past the query buffer,
    or whose subject index is out of range, launches all the same: it
    carries FLAG_RANGE and K1's rows, the other seeds equal the plain
    version, and check_gate_flags raises ValueError."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gblastn_tpu_torch.ops.replay import (
        FLAG_RANGE,
        approx_gate,
        approx_gate_ref,
        check_gate_flags,
    )
    from gblastn_tpu_torch.tools.replay_sets import random_gate_case

    dev = torch.device("cuda:0")
    args, kw = random_gate_case(dev, n=4096)
    args = list(args)
    args[9] = args[9].clone()
    args[9][7] = 99                                 # no such subject
    args[13] = torch.full_like(args[13], 100)       # every seed gated
    kw = dict(kw, concat_end=kw["concat_end"] + 64)     # past the buffer
    want = approx_gate_ref(*args, **kw)
    got = approx_gate(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    f = got[4].cpu().numpy()
    assert f[7] & FLAG_RANGE and (f & FLAG_RANGE).sum() > FLAG_RANGE
    bad = torch.from_numpy((f & FLAG_RANGE) != 0).to(dev)
    for g, k in zip(got[:4], args[10:14]):
        assert torch.equal(g[bad], k[bad])
    with pytest.raises(ValueError, match="outside"):
        check_gate_flags(got[4])


@pytest.mark.cuda
def test_right_run_and_two_hit_replay_bit_equal_to_plain_versions():
    """RR against its plain version on its random sets (words 11 and 28:
    runs of every length, N/R/Y, sentinels, subject and query ends), two-hit
    R on its (a dense chain, double words, the window's boundary pairs,
    virgin diagonals, identical seeds, the aliasing mask with the window),
    and G with the runs of a random set, also replayed from a CUDA graph
    that captured each wrapper."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gblastn_tpu_torch.ops.replay import (
        approx_gate,
        approx_gate_ref,
        diag_replay,
        diag_replay_ref,
        right_run,
        right_run_ref,
    )
    from gblastn_tpu_torch.tools.replay_sets import (
        random_gate_case,
        random_run_cases,
        random_two_hit_cases,
    )

    dev = torch.device("cuda:0")
    g_args, g_kw = random_gate_case(dev, n=8192)
    runs = torch.randint(0, 12, (8192,), dtype=torch.int32, device=dev)
    cases = ([(right_run, right_run_ref, a, kw)
              for _label, a, kw in random_run_cases(dev, n=16384)]
             + [(diag_replay, diag_replay_ref, a, kw)
                for _label, a, kw in random_two_hit_cases(dev, n=65536)]
             + [(approx_gate, approx_gate_ref, g_args,
                 dict(g_kw, right_run=runs))])
    for fn, ref, args, kw in cases:
        want = ref(*args, **kw)
        want = want if isinstance(want, tuple) else (want,)
        before = fn.launches
        got = fn(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g, w)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(*args, **kw)
        out = out if isinstance(out, tuple) else (out,)
        graph.replay()
        torch.cuda.synchronize()
        for g, w in zip(out, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_dc_megablast_cuda_bytes_equal_cpu_bytes(tmp_path):
    """A small dc-megablast search (coding_and_optimal: two templates, one
    K1, window 40) and a blastn search with -window_size 40 through the
    CLI: -device cuda writes the -device cpu bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gblastn_tpu_torch.cli.main import main
    from gblastn_tpu_torch.ops.replay import diag_replay

    rng = np.random.default_rng(61)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 60000))
    reads = []
    for k in range(12):
        st = int(rng.integers(0, 58000))
        r = list(genome[st: st + 1200])
        for p in range(2, 1200, 3):
            if rng.random() < 0.3:
                r[p] = "ACGT"[("ACGT".index(r[p]) + 1) % 4]
        reads.append(f">d{k}\n{''.join(r)}\n")
    (tmp_path / "q.fa").write_text("".join(reads))
    (tmp_path / "g.fa").write_text(">g\n" + genome + "\n")
    assert main(["makedb", "-in", str(tmp_path / "g.fa"), "-out",
                 str(tmp_path / "db"), "-title", "g"]) == 0
    for extra in (["-task", "dc-megablast", "-template_type",
                   "coding_and_optimal"],
                  ["-task", "blastn", "-window_size", "40"]):
        args = ["blastn", "-query", str(tmp_path / "q.fa"), "-db",
                str(tmp_path / "db"), "-outfmt", "6", "-evalue", "1e-5",
                *extra]
        before = diag_replay.launches
        assert main(args + ["-device", "cuda", "-out",
                            str(tmp_path / "c.tsv")]) == 0
        assert diag_replay.launches > before
        assert main(args + ["-device", "cpu", "-out",
                            str(tmp_path / "p.tsv")]) == 0
        got = (tmp_path / "c.tsv").read_bytes()
        assert got.count(b"\n") >= 6
        assert got == (tmp_path / "p.tsv").read_bytes()


def _two_hit_batch(dev):
    """A small megablast batch with window 40 on ``dev`` (word 28 over a
    narrower lookup word, so RR probes): six reads of 600 bases with 3%
    substitutions from two random subjects, one reverse-complemented,
    one with an N."""
    from gblastn_tpu_torch import FastaRecord, SequenceDB, megablast_options
    from gblastn_tpu_torch.engine.search import setup_batch

    rng = np.random.default_rng(17)
    g = ["".join("ACGT"[c] for c in rng.integers(0, 4, L))
         for L in (30000, 9000)]
    db = SequenceDB.from_records(
        [FastaRecord(f"g{i}", "", x) for i, x in enumerate(g)], title="t")
    reads = []
    for k in range(6):
        src = g[k % 2]
        st = int(rng.integers(0, len(src) - 700))
        r = list(src[st: st + 600])
        for p in np.flatnonzero(rng.random(600) < 0.03):
            r[p] = "ACGT"[("ACGT".index(r[p]) + 1) % 4]
        if k == 2:
            r[300] = "N"
        seq = "".join(r)
        if k == 3:
            seq = seq[::-1].translate(str.maketrans("ACGTN", "TGCAN"))
        reads.append(FastaRecord(f"r{k}", "", seq))
    return setup_batch(reads, db, megablast_options(evalue=1e-5,
                                                    window_size=40), dev)


@pytest.mark.cuda
def test_right_run_at_config_1w_and_from_a_graph():
    """RR (sixteen bases a step) bit-equal to its plain version at config
    1w's search-path seeds (bench.py's genome and reads, megablast with
    -window_size 40) and on its full random sets at words 11 and 28, also
    replayed from a CUDA graph that captured the wrapper; one launch
    counted a call, none while capturing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gblastn_tpu_torch import FastaRecord, SequenceDB
    from gblastn_tpu_torch.engine.search import setup_batch
    from gblastn_tpu_torch.ops.replay import right_run, right_run_ref
    from gblastn_tpu_torch.tools.prof_e2e import config_options
    from gblastn_tpu_torch.tools.replay_sets import (
        batch_run_case,
        random_run_cases,
    )
    from gblastn_tpu_torch.tools.workloads import (
        GENOME_LEN,
        NUM_QUERIES,
        QUERY_LEN,
        SEED,
        make_genome,
        sample_reads,
    )

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(SEED)
    genome = make_genome(rng, GENOME_LEN)
    pairs, _ = sample_reads(rng, genome, NUM_QUERIES, QUERY_LEN, "w0_")
    db = SequenceDB.from_records([FastaRecord("g", "", genome)], title="g")
    batch = setup_batch([FastaRecord(n, "", s) for n, s in pairs], db,
                        config_options("config1w"), dev)
    cases = [batch_run_case(batch)] + [
        (a, kw) for _label, a, kw in random_run_cases(dev)]
    assert cases[0] is not None and cases[0][1]["word_size"] == 28
    for args, kw in cases:
        want = right_run_ref(*args, **kw)
        assert int(want.max()) == kw["word_size"] and int(want.min()) == 0
        before = right_run.launches
        got = right_run(*args, **kw)
        torch.cuda.synchronize()
        assert right_run.launches == before + 1
        assert got.is_cuda and torch.equal(got, want)
        captured, launches = right_run.captured, right_run.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = right_run(*args, **kw)
        assert right_run.captured == captured + 1
        assert right_run.launches == launches
        out.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.cuda
def test_key_range_flag_raises_at_the_fetch():
    """On CUDA tensors replay_keys checks nothing itself: key_range_flag
    marks a planted s past the sort's bound (bit 2) without a wait, and
    a batch whose s lie past the bound (its longest subject cut to 100
    bases) raises ValueError at run_seeding's one fetch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gblastn_tpu_torch.engine.seeding import run_seeding
    from gblastn_tpu_torch.ops.replay import check_key_flag, key_range_flag

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(3)
    q, s, oid = (torch.from_numpy(rng.integers(0, b, 4096)).to(
        dev, torch.int32) for b in (3000, 5000, 40))
    bounds = dict(n_sub=40, s_len=5000, q_len=3000)
    assert int(key_range_flag(q, s, oid, **bounds)) == 0
    s[77] = 5000
    flag = key_range_flag(q, s, oid, **bounds)
    assert flag.is_cuda and int(flag) == 2
    with pytest.raises(ValueError, match="s outside"):
        check_key_flag(flag)
    batch = _two_hit_batch(dev)
    res = batch.seed_dev.resident
    assert len(run_seeding(batch.seed_dev, **batch.seed_kw)) > 3
    longest, res.longest = res.longest, 100
    try:
        with pytest.raises(ValueError, match="s outside the bounds"):
            run_seeding(batch.seed_dev, **batch.seed_kw)
    finally:
        res.longest = longest


@pytest.mark.cuda
def test_device_finish_waits_on_nothing_before_the_nonzero():
    """device_finish (RR, G, the sort, its range flag and R) runs under
    torch.cuda.set_sync_debug_mode("error"), which raises at any operation
    that waits on the card, while the nonzero after it does raise there;
    its head and saved seeds equal the same finish on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gblastn_tpu_torch.engine import seeding as es
    from gblastn_tpu_torch.ops.ungapped import ungapped_extend_window

    out = {}
    for name in ("cuda:0", "cpu"):
        batch = _two_hit_batch(torch.device(name))
        dev, kw = batch.seed_dev, batch.seed_kw
        assert es.probes_double_words(dev, kw)
        ctx, k1_args, _n = es.ungapped_inputs(dev, **kw)
        ung = ungapped_extend_window(*k1_args)
        if name == "cpu":
            out[name] = es.device_finish(dev, k1_args, ctx, ung, kw)
            continue
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out[name] = es.device_finish(dev, k1_args, ctx, ung, kw)
            with pytest.raises(RuntimeError):
                torch.nonzero(out[name][2])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for got, want in zip(out["cuda:0"], out["cpu"]):
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_pipelined_mode_on_the_card(tmp_path, monkeypatch):
    """-mode 2 gives -mode 1's bytes on the card (four CLI batches of
    three reads), and run_seeding_steps waits on nothing between the
    scan (which sizes its seed arrays) and its yield, under
    torch.cuda.set_sync_debug_mode("error"); the seeds it then fetches
    equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import gblastn_tpu_torch.cli.main as cli
    from gblastn_tpu_torch.engine import seeding as es

    monkeypatch.setattr(cli, "BATCH_SIZE_MEGABLAST", 1200)
    rng = np.random.default_rng(313)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, 40000))
    (tmp_path / "g.fa").write_text(">c\n" + genome + "\n")
    (tmp_path / "q.fa").write_text("".join(
        f">q{k}\n{genome[1000 + k * 2500: 1400 + k * 2500]}\n"
        for k in range(12)))
    assert cli.main(["makedb", "-in", str(tmp_path / "g.fa"), "-out",
                     str(tmp_path / "db")]) == 0
    out = {}
    for mode in ("1", "2"):
        assert cli.main(["blastn", "-query", str(tmp_path / "q.fa"), "-db",
                         str(tmp_path / "db"), "-outfmt", "6", "-mode", mode,
                         "-out", str(tmp_path / f"m{mode}.tsv")]) == 0
        out[mode] = (tmp_path / f"m{mode}.tsv").read_bytes()
    assert out["2"] == out["1"] and out["1"].count(b"\n") >= 12

    got = {}
    for name in ("cuda:0", "cpu"):
        batch = _two_hit_batch(torch.device(name))
        pre = es.ungapped_inputs(batch.seed_dev, **batch.seed_kw)
        monkeypatch.setattr(es, "ungapped_inputs", lambda _d, **_k: pre)
        gen = es.run_seeding_steps(batch.seed_dev, **batch.seed_kw)
        if name == "cpu":
            next(gen)
        else:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                next(gen)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        got[name] = es.drive(gen)
        monkeypatch.undo()
    for f in ("q_off", "s_off", "q_start", "s_start", "length", "score",
              "context", "oid"):
        assert np.array_equal(getattr(got["cuda:0"], f),
                              getattr(got["cpu"], f)), f
    assert len(got["cpu"]) > 0


@pytest.mark.cuda
def test_kernels_past_2g_bit_equal_to_plain_versions():
    """K1, G, RR and R (one-hit and two-hit, on int64 coordinates: R's
    wide kernels) bit-equal to their plain versions on seeds of a single
    subject past 2^31 bases, made on the card
    (``replay_sets.past_2g_cases``): K1's walks cross 2^31 and return
    s_start past it, G's walks read the packed bytes there, RR's runs the
    subject words there, and R orders and replays subject-local s past
    2^31 (two sorts: the packed key needs 64 bits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gblastn_tpu_torch.ops import replay as rp
    from gblastn_tpu_torch.tools.replay_sets import past_2g_cases

    dev = torch.device("cuda:0")
    cases = past_2g_cases(dev)
    k1_args = cases["k1"][0]
    n = k1_args[3].numel()
    want = ungapped_extend_window_ref(*k1_args)
    got = ungapped_extend_window(*k1_args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[1].dtype == torch.int64 and int(got[2].max()) > 1000
    assert int(got[1].min()) < (1 << 31) < int(got[1].max())
    rr_args, rr_kw = cases["rr"]
    runs = rp.right_run(*rr_args, **rr_kw)
    assert torch.equal(runs, rp.right_run_ref(*rr_args, **rr_kw))
    assert int((runs == 28).sum()) > 100
    g_args, g_kw = cases["g"]
    g_got = rp.approx_gate(*g_args, **g_kw)
    g_want = rp.approx_gate_ref(*g_args, **g_kw)
    for a, b in zip(g_got, g_want):
        assert torch.equal(a, b)
    assert int(((g_got[4] & rp.FLAG_NEED) != 0).sum()) > 500
    r_args = cases["r"][0]
    assert cases["r"][1]["key_shift"] == 0
    assert int(rp.key_range_flag(k1_args[3], r_args[2], g_args[9], n_sub=1,
                                 s_len=g_args[5].item(),
                                 q_len=g_kw["concat_end"] + 1)) == 0
    for name in ("r", "r_two_hit"):
        r_args, kw = cases[name]
        saved = rp.diag_replay(*r_args, **kw)
        assert torch.equal(saved, rp.diag_replay_ref(*r_args, **kw))
        assert 24 < int(saved.sum()) < n


@pytest.mark.cuda
def test_resident_database_too_large_raises():
    """A database whose resident form does not fit in the card's free
    memory raises MemoryError naming the bytes needed and the bytes free,
    before anything is uploaded; blocks that PyTorch's allocator caches
    count as free, so one just under the free memory with them passes
    the check."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import types

    from gblastn_tpu_torch.engine.resident import (
        SEARCH_WORK_BYTES,
        check_fits,
        free_bytes,
        resident_bytes,
        resident_from_reference,
    )

    dev = torch.device("cuda:0")
    free, _total = torch.cuda.mem_get_info(dev)
    fake = types.SimpleNamespace(padded_length=int(free) // 2 * 2,
                                 num_seqs=1)
    need = resident_bytes(fake.padded_length, 1)
    assert need > free
    with pytest.raises(MemoryError, match=f"needs {need} bytes") as e:
        resident_from_reference(fake, dev)
    assert " free" in str(e.value)
    assert fake._torch_resident == {}
    cached = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    del cached
    assert torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(
        dev) >= 1 << 30
    room = free_bytes(dev)
    assert room >= torch.cuda.mem_get_info(dev)[0] + (1 << 30)
    check_fits(room - SEARCH_WORK_BYTES, dev)
    with pytest.raises(MemoryError):
        check_fits(room - SEARCH_WORK_BYTES + 1, dev)


def _offdiag_batch(dev, task, window=40, scan_range=4, **kw):
    """tests/test_oracle_parity.py's off-diagonal workload
    (tools.workloads.offdiag_reads: eight reads of a 50 kb genome, two
    of them exact) as one batch on ``dev``."""
    from gblastn_tpu_torch import FastaRecord, SequenceDB
    from gblastn_tpu_torch.engine.search import setup_batch
    from gblastn_tpu_torch.params.options import options_for_task
    from gblastn_tpu_torch.tools.workloads import offdiag_reads

    genome, reads = offdiag_reads()
    db = SequenceDB.from_records([FastaRecord("chr1", "", genome)])
    opts = options_for_task(task, evalue=1e-3, window_size=window,
                            off_diagonal_range=scan_range, **kw)
    return setup_batch([FastaRecord(*r) for r in reads], db, opts, dev)


@pytest.mark.cuda
def test_off_diagonal_device_path_equals_host_finish():
    """-off_diagonal_range on the card: run_seeding (scan, K1, RR where it
    probes and G on the card, no sort and no R; the host replay on the
    rows of one fetch) equals the host finish on K1's rows, field by
    field, and the CPU's run_seeding; blastn, megablast (RR probes) and
    two-template dc-megablast."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gblastn_tpu_torch.engine import seeding as es
    from gblastn_tpu_torch.ops import replay as rp

    for task, kw in (("blastn", {}), ("megablast", {}),
                     ("dc-megablast",
                      {"template_type": "coding_and_optimal"})):
        got = {}
        for name in ("cuda:0", "cpu"):
            batch = _offdiag_batch(torch.device(name), task, **kw)
            before = rp.diag_replay.launches
            got[name] = es.run_seeding(batch.seed_dev, **batch.seed_kw)
            assert rp.diag_replay.launches == before        # no R
        kw_b, okw = batch.seed_kw, batch.oracle_kw
        ctx, k1_args, _n = es.ungapped_inputs(batch.seed_dev, **kw_b)
        ung = ungapped_extend_window(*k1_args)
        runs = np.zeros(k1_args[3].numel(), np.int32)
        if es.probes_double_words(batch.seed_dev, kw_b):
            res = batch.seed_dev.resident
            oid = torch.searchsorted(res.starts, k1_args[4], right=True) - 1
            runs = rp.right_run(batch.seed_dev.query_nib, res.subject_w,
                                res.ends, k1_args[3], k1_args[4],
                                oid.to(torch.int32),
                                word_size=kw_b["word_size"]).numpy()
        n_ctx = len(kw_b["x_dropoffs"])
        want = es._finish_init_hits(
            *(t.numpy() for t in (k1_args[3], k1_args[4], ctx, *ung[:4])),
            okw["word_cutoffs"], okw["subject_starts"], kw_b["word_size"],
            concat_qlen=int(kw_b["context_offsets"][n_ctx]) - 2,
            approx_ctx=okw["approx_ctx"], window_size=40, right_run=runs,
            scan_range=4)
        assert len(want) > 0
        for field in ("q_off", "s_off", "q_start", "s_start", "length",
                      "score", "context", "oid"):
            for h in got.values():
                np.testing.assert_array_equal(getattr(h, field),
                                              getattr(want, field))


@pytest.mark.cuda
def test_streamed_seeding_equals_resident_on_the_card(monkeypatch):
    """A database streamed through the card in blocks of 2048 bases
    (GBLASTN_TPU_STREAM=1) gives the resident path's InitHits on the card,
    field by field: blastn, megablast with a window (RR probes per
    block), two-template dc-megablast, blastn with -off_diagonal_range,
    and a 3 kb exact read across two block edges, whose walks stop at
    their buffers' edges and are re-extended on the host; K1 and G
    launch once a block with seeds, R once (none with a scan range,
    whose replay is the host's); no resident form is uploaded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gblastn_tpu_torch.engine import seeding as es
    from gblastn_tpu_torch.engine.stream import run_seeding_streamed
    from gblastn_tpu_torch.ops import replay as rp
    from gblastn_tpu_torch.utils.profiling import slog

    from gblastn_tpu_torch import FastaRecord, SequenceDB
    from gblastn_tpu_torch.engine.search import setup_batch
    from gblastn_tpu_torch.params.options import options_for_task

    def long_read(dev):
        rng = np.random.default_rng(3)
        genome = "".join("ACGT"[i] for i in rng.integers(0, 4, 12000))
        db = SequenceDB.from_records([FastaRecord("g", "", genome)])
        return setup_batch([FastaRecord("long", "", genome[3500:6500])],
                           db, options_for_task("blastn", evalue=1e-3), dev)

    dev = torch.device("cuda:0")
    escalated = {}
    for name, make in (
            ("blastn", lambda d: _offdiag_batch(d, "blastn", window=0,
                                                scan_range=0)),
            ("megablast", lambda d: _offdiag_batch(d, "megablast")),
            ("dc-megablast", lambda d: _offdiag_batch(
                d, "dc-megablast", template_type="coding_and_optimal")),
            ("off-diagonal", lambda d: _offdiag_batch(d, "blastn")),
            ("long read", long_read)):
        for var in ("GBLASTN_TPU_STREAM", "GBLASTN_TPU_BLOCK_BASES",
                    "GBLASTN_TPU_BLOCK_HALO"):
            monkeypatch.delenv(var, raising=False)
        ref = make(dev)
        assert ref.stream is None
        want = es.run_seeding(ref.seed_dev, **ref.seed_kw)
        monkeypatch.setenv("GBLASTN_TPU_STREAM", "1")
        monkeypatch.setenv("GBLASTN_TPU_BLOCK_BASES", "2048")
        monkeypatch.setenv("GBLASTN_TPU_BLOCK_HALO", "256")
        b = make(dev)
        assert b.stream is not None and b.seed_dev.resident is None
        slog.reset()
        k1_before = ungapped_extend_window.launches
        g_before = rp.approx_gate.launches
        r_before = rp.diag_replay.launches
        got = run_seeding_streamed(b.stream, b.seed_dev, **b.seed_kw)
        blocks = int(slog.values["seeding.stream_blocks"])
        escalated[name] = int(slog.values["seeding.stream_escalated"])
        assert blocks >= 5
        n_k1 = ungapped_extend_window.launches - k1_before
        assert 0 < n_k1 <= blocks
        assert rp.approx_gate.launches - g_before == n_k1
        assert rp.diag_replay.launches - r_before == (
            0 if b.seed_kw["scan_range"] else 1)
        assert len(want) > 0
        for field in ("q_off", "s_off", "q_start", "s_start", "length",
                      "score", "context", "oid"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
        assert not hasattr(b.stream.db, "_torch_resident")
    assert escalated["long read"] > 0, escalated


def _hsp_rows(res):
    """Every HSP of a search result, all fields (the edit script as a
    list), in result order."""
    def fields(h):
        return tuple((k, list(v) if k == "edit_script" and v is not None
                      else v) for k, v in vars(h).items())

    return [(q.query_index, lst.oid, lst.best_evalue, fields(h))
            for q in res.queries for lst in q.hsplists for h in lst.hsps]


@pytest.mark.cuda
def test_sharded_search_equals_resident_on_the_card(monkeypatch):
    """At 4 shards, all on the one card, search() gives the resident
    search's HSPs on tests/test_oracle_parity.py's off-diagonal workload
    (one-hit blastn, two-hit megablast with RR, and -off_diagonal_range
    4): K1 and G launch once a shard with seeds, R once a batch (none with
    the scan range), K2 never, and no shard lies on the CPU. A shard whose
    form and a search's working memory do not fit in the card's free
    memory raises MemoryError naming both numbers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gblastn_tpu_torch import FastaRecord, SequenceDB
    from gblastn_tpu_torch.engine import resident
    from gblastn_tpu_torch.engine.search import search
    from gblastn_tpu_torch.ops import gapped as og
    from gblastn_tpu_torch.ops import replay as rp
    from gblastn_tpu_torch.params.options import options_for_task
    from gblastn_tpu_torch.tools.workloads import offdiag_reads
    from gblastn_tpu_torch.utils.profiling import slog

    dev = torch.device("cuda:0")
    genome, reads = offdiag_reads()
    recs = [FastaRecord(*r) for r in reads]
    for task, kw in (("blastn", {}), ("megablast", {"window_size": 40}),
                     ("blastn", {"window_size": 40,
                                 "off_diagonal_range": 4})):
        opts = options_for_task(task, evalue=1e-3, **kw)
        monkeypatch.delenv("GBLASTN_TPU_SHARDS", raising=False)
        want = _hsp_rows(search(recs, SequenceDB.from_records(
            [FastaRecord("chr1", "", genome)]), opts, device=dev))
        monkeypatch.setenv("GBLASTN_TPU_SHARDS", "4")
        db = SequenceDB.from_records([FastaRecord("chr1", "", genome)])
        counts = [ungapped_extend_window.launches, rp.approx_gate.launches,
                  rp.diag_replay.launches, og.banded_gapped_scores.launches]
        slog.reset()
        got = _hsp_rows(search(recs, db, opts, device=dev))
        counts = [c - b for c, b in zip(
            (ungapped_extend_window.launches, rp.approx_gate.launches,
             rp.diag_replay.launches, og.banded_gapped_scores.launches),
            counts)]
        assert got == want and len(want) >= 4, task
        assert slog.values["seeding.shards"] == 4
        assert 2 <= counts[0] <= 4 and counts[1] == counts[0]
        assert counts[2] == (0 if kw.get("off_diagonal_range") else 1)
        assert counts[3] == 0
        assert all(v.device == dev for v in db._torch_shards.values()
                   if isinstance(v, resident.ResidentDB))
        assert not hasattr(db, "_torch_resident")
    # a search's working memory as large as the card: no shard fits
    monkeypatch.setattr(resident, "SEARCH_WORK_BYTES",
                        torch.cuda.mem_get_info(dev)[1])
    db = SequenceDB.from_records([FastaRecord("chr1", "", genome)])
    with pytest.raises(MemoryError,
                       match=r"shard 0 of 4 needs \d+ bytes.* \d+ free"):
        search(recs, db, options_for_task("megablast"), device=dev)


@pytest.mark.cuda
def test_bare_cuda_shards_over_every_card():
    """On a machine with several cards, a bare ``cuda`` batch shards the
    database over all of them (GBLASTN_TPU_SHARDS unset): a shard a card,
    HSPs equal to one card's resident search."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    from gblastn_tpu_torch import FastaRecord, SequenceDB
    from gblastn_tpu_torch.engine.resident import ResidentDB
    from gblastn_tpu_torch.engine.search import search
    from gblastn_tpu_torch.params.options import options_for_task
    from gblastn_tpu_torch.tools.workloads import offdiag_reads

    genome, reads = offdiag_reads()
    genome = genome * 4            # four cards' worth of 13,312-base shards
    recs = [FastaRecord(*r) for r in reads]
    opts = options_for_task("blastn", evalue=1e-3, window_size=40)
    want = _hsp_rows(search(recs, SequenceDB.from_records(
        [FastaRecord("chr1", "", genome)]), opts, device="cuda:0"))
    db = SequenceDB.from_records([FastaRecord("chr1", "", genome)])
    got = _hsp_rows(search(recs, db, opts, device="cuda"))
    assert got == want and len(want) >= 4
    cards = {v.device for v in db._torch_shards.values()
             if isinstance(v, ResidentDB)}
    assert cards == {torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())}



@pytest.mark.cuda
def test_gloo_ranks_on_their_own_cards(tmp_path):
    """A process a card over gloo (GBLASTN_TPU_COORDINATOR, no
    GBLASTN_TPU_SHARDS: a shard a process, each on its rank's card):
    every rank writes the bytes of one process alone on one card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from gblastn_tpu_torch import FastaRecord, SequenceDB
    from gblastn_tpu_torch.tools.workloads import offdiag_reads

    genome, reads = offdiag_reads()
    SequenceDB.from_records([FastaRecord("chr1", "", genome * 4)]).save(
        tmp_path / "db")
    (tmp_path / "q.fa").write_text("".join(f">{n}\n{s}\n"
                                           for n, _t, s in reads))
    args = [sys.executable, "-m", "gblastn_tpu_torch", "blastn", "-task",
            "blastn", "-query", str(tmp_path / "q.fa"), "-db",
            str(tmp_path / "db"), "-outfmt", "6", "-evalue", "1e-3"]
    repo = Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": str(repo)}
    env.pop("GBLASTN_TPU_SHARDS", None)
    subprocess.run(args + ["-device", "cuda:0", "-out",
                           str(tmp_path / "alone.tsv")],
                   env=env, cwd=repo, check=True, timeout=600)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    n = torch.cuda.device_count()
    procs = [subprocess.Popen(
        args + ["-device", "cuda", "-out", str(tmp_path / f"rank{r}.tsv")],
        cwd=repo, env={**env, "GBLASTN_TPU_COORDINATOR": f"localhost:{port}",
                       "GBLASTN_TPU_NUM_PROCESSES": str(n),
                       "GBLASTN_TPU_PROCESS_ID": str(r)})
        for r in range(n)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert codes == [0] * n
    want = (tmp_path / "alone.tsv").read_bytes()
    assert want.count(b"\n") >= 4
    for r in range(n):
        assert (tmp_path / f"rank{r}.tsv").read_bytes() == want, r
