"""Sum-statistics HSP linking for ungapped searches.

Faithful re-derivation of ``Blast_EvenGapLinkHSPs`` (reference:
NCBI c++/src/algo/blast/core/link_hsps.c:419-1103) and the
sum e-value machinery (blast_stat.c:4147-4533). Ungapped blastn links
HSPs on the same query context into chains under two orderings --
"small gaps" (both query and subject gaps within
``gap_size + overlap_size + 1``) and "large gaps" (any colinear
placement) -- picks the ordering with the lower sum e-value per chain,
assigns that e-value to every chain member, removes the chain, and
repeats.

The reference maintains incremental caches (``first_pass`` /
``use_current_max`` / ``next_larger``) purely to avoid recomputing
unchanged best-path sums between rounds; recomputing from scratch each
round (done here) selects identical chains, which the reference's own
comments state as the caching invariant (link_hsps.c:601-605, 787-791).

Linking parameters (blast_parameters.c:594-643): gap_prob 0.5, gap
decay 0.5, gap_size 40, overlap_size 9; cutoff_small_gap = the
ungapped word cutoff; cutoff_big_gap stays 0 for blastn.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from gblastn_tpu_torch.hits import HSP

BLAST_GAP_SIZE = 40
BLAST_OVERLAP_SIZE = 9
BLAST_GAP_PROB = 0.5
BLAST_GAP_DECAY_RATE = 0.5
INT4_MAX = 2**31 - 1


def gap_decay_divisor(decay_rate: float, nsegs: int) -> float:
    """BLAST_GapDecayDivisor (blast_stat.c:4033)."""
    return (1.0 - decay_rate) * decay_rate ** (nsegs - 1)


def _ln_factorial(n: float) -> float:
    return math.lgamma(n + 1.0) if n > 0 else 0.0


def _karlin_p_to_e(p: float) -> float:
    """BLAST_KarlinPtoE: E = -ln(1 - P)."""
    if p >= 1.0:
        return INT4_MAX
    if p <= 0.0:
        return 0.0
    return -math.log1p(-p)


_MAX_DIAGS = 20


def _romberg(f, p: float, q: float, eps: float, itmin: int = 1,
             epsit: int = 0) -> float:
    """Exact port of BLAST_RombergIntegrate (ncbi_math.c:351): rolled
    extrapolation array, same-row convergence test (|R(i,i)-R(i,i-1)|
    against eps), HUGE_VAL (inf) on non-convergence within MAX_DIAGS.
    Bit parity of linked sum e-values depends on matching this
    stopping rule exactly."""
    itmin = min(max(1, itmin), _MAX_DIAGS - 1)
    epsit = min(max(epsit, 1), 3)
    epsck = itmin - epsit

    romb = [0.0] * _MAX_DIAGS
    npts = 1
    h = q - p
    y0, y1 = f(p), f(q)
    if math.isinf(y0) or math.isinf(y1):
        return math.inf
    romb[0] = 0.5 * h * (y0 + y1)
    epsit_cnt = 0
    for i in range(1, _MAX_DIAGS):
        s = 0.0
        x = p + 0.5 * h
        for _ in range(npts):
            y = f(x)
            if math.isinf(y):
                # HUGE_VAL short-circuit (ncbi_math.c:375-389)
                return math.inf
            s += y
            x += h
        romb[i] = 0.5 * (romb[i - 1] + h * s)
        n = 4
        for j in range(i - 1, -1, -1):
            romb[j] = (n * romb[j + 1] - romb[j]) / (n - 1)
            n *= 4
        if i > epsck:
            if abs(romb[1] - romb[0]) > eps * abs(romb[0]):
                epsit_cnt = 0
            else:
                epsit_cnt += 1
                if i >= itmin and epsit_cnt >= epsit:
                    return romb[0]
        npts *= 2
        h *= 0.5
    return math.inf


def _sum_p_calc(r: int, s: float) -> float:
    """s_BlastSumPCalc (blast_stat.c:4223): Karlin-Altschul 1993 eqn 4
    double integral."""
    if r == 1:
        if s > 8.0:
            return math.exp(-s)
        return -math.expm1(-math.exp(-s))
    if r < 1:
        return 0.0
    if r < 8:
        if s <= -2.3 * r:
            return 1.0
    elif r < 15:
        if s <= -2.5 * r:
            return 1.0
    elif r < 27:
        if s <= -3.0 * r:
            return 1.0
    elif r < 51:
        if s <= -3.4 * r:
            return 1.0
    elif r < 101:
        if s <= -4.0 * r:
            return 1.0
    stddev = math.sqrt(r)
    stddev4 = 4.0 * stddev
    r1 = r - 1
    if r > 100 and s <= -r * r1 - stddev4:
        return 1.0
    logr = math.log(r)
    mean = r * (1.0 - logr) - 0.5
    if s <= mean - stddev4:
        return 1.0
    t = (s if s >= mean else mean) + 6.0 * stddev
    adj1 = (r - 2) * logr - _ln_factorial(r1 - 1) - _ln_factorial(r1)

    def outer(x: float, sv: float) -> float:
        sdvir = sv / r
        try:
            y = math.exp(x - sdvir)
        except OverflowError:
            return 0.0
        if r - 2 == 0:
            try:
                return math.exp(adj1 - sv - y)
            except OverflowError:
                return 0.0
        if x == 0.0:
            return 0.0
        try:
            return math.exp((r - 2) * math.log(x) + adj1 - sv - y)
        except OverflowError:
            return 0.0

    def inner(sv: float) -> float:
        mx = sv / r + 3.0 if sv > 0.0 else 3.0
        return _romberg(lambda x: outer(x, sv), 0.0, mx, 0.002, itmin=1)

    # the reference refines with increasing itmin while the result
    # stays below 0.4 (s_BlastSumPCalc retry loop, blast_stat.c:4295)
    itmin = 1 if s >= mean else 2
    while True:
        d = _romberg(inner, s, t, 0.002, itmin=itmin)
        if math.isinf(d):
            return d
        stop = not (s < mean and d < 0.4 and itmin < 4)
        itmin += 1
        if stop:
            break
    return d if d < 1.0 else 1.0


_TAB2 = [0.01669, 0.0249, 0.03683, 0.05390, 0.07794, 0.1111, 0.1559,
         0.2146, 0.2890, 0.3794, 0.4836, 0.5965, 0.7092, 0.8114,
         0.8931, 0.9490, 0.9806, 0.9944, 0.9989]
_TAB3 = [0.9806, 0.9944, 0.9989, 0.0001682, 0.0002542, 0.0003829,
         0.0005745, 0.0008587, 0.001278, 0.001893, 0.002789, 0.004088,
         0.005958, 0.008627, 0.01240, 0.01770, 0.02505, 0.03514,
         0.04880, 0.06704, 0.09103, 0.1220, 0.1612, 0.2097, 0.2682,
         0.3368, 0.4145, 0.4994, 0.5881, 0.6765, 0.7596, 0.8326,
         0.8922, 0.9367, 0.9667, 0.9846, 0.9939, 0.9980]
_TAB4 = [2.658e-07, 4.064e-07, 6.203e-07, 9.450e-07, 1.437e-06,
         2.181e-06, 3.302e-06, 4.990e-06, 7.524e-06, 1.132e-05,
         1.698e-05, 2.541e-05, 3.791e-05, 5.641e-05, 8.368e-05,
         0.0001237, 0.0001823, 0.0002677, 0.0003915, 0.0005704,
         0.0008275, 0.001195, 0.001718, 0.002457, 0.003494, 0.004942,
         0.006948, 0.009702, 0.01346, 0.01853, 0.02532, 0.03431,
         0.04607, 0.06128, 0.08068, 0.1051, 0.1352, 0.1719, 0.2157,
         0.2669, 0.3254, 0.3906, 0.4612, 0.5355, 0.6110, 0.6849,
         0.7544, 0.8168, 0.8699, 0.9127, 0.9451, 0.9679, 0.9827,
         0.9915, 0.9963]


def sum_p(r: int, s: float) -> float:
    """s_BlastSumP (blast_stat.c:4311)."""
    if r == 1:
        return -math.expm1(-math.exp(-s))
    if r <= 4:
        if r < 1:
            return 0.0
        r1 = r - 1
        if s >= r * r + r1:
            a = _ln_factorial(r)
            return r * math.exp(r1 * math.log(s) - s - a - a)
        if s > -2 * r:
            tables = [_TAB2, _TAB3, _TAB4]
            sizes = [len(_TAB2) - 1, len(_TAB3) - 1, len(_TAB4) - 1]
            a = s + s + (4 * r)
            i = int(a)
            a -= i
            r2 = r - 2
            i = sizes[r2] - i
            return a * tables[r2][i - 1] + (1.0 - a) * tables[r2][i]
        return 1.0
    return _sum_p_calc(r, s)


def small_gap_sum_e(starting_points: int, num: int, xsum: float,
                    query_length: int, subject_length: int,
                    searchsp_eff: int, weight_divisor: float) -> float:
    """BLAST_SmallGapSumE (blast_stat.c:4372)."""
    if num == 1:
        sum_e = searchsp_eff * math.exp(-xsum)
    else:
        pair_sp = float(subject_length) * float(query_length)
        xsum -= math.log(pair_sp) + 2 * (num - 1) * math.log(
            float(starting_points)
        )
        xsum -= _ln_factorial(num)
        p = sum_p(num, xsum)
        sum_e = _karlin_p_to_e(p) * (float(searchsp_eff) / pair_sp)
    if weight_divisor == 0.0 or (sum_e / weight_divisor) > INT4_MAX:
        return INT4_MAX
    return sum_e / weight_divisor


def large_gap_sum_e(num: int, xsum: float, query_length: int,
                    subject_length: int, searchsp_eff: int,
                    weight_divisor: float) -> float:
    """BLAST_LargeGapSumE (blast_stat.c:4486)."""
    if num == 1:
        sum_e = searchsp_eff * math.exp(-xsum)
    else:
        q = float(query_length)
        s = float(subject_length)
        xsum -= num * math.log(s * q) - _ln_factorial(num)
        p = sum_p(num, xsum)
        sum_e = _karlin_p_to_e(p) * (float(searchsp_eff) / (q * s))
    if weight_divisor == 0.0 or (sum_e / weight_divisor) > INT4_MAX:
        return INT4_MAX
    return sum_e / weight_divisor


@dataclass
class _Link:
    hsp: HSP
    q_off_trim: int = 0
    q_end_trim: int = 0
    s_off_trim: int = 0
    s_end_trim: int = 0
    # per ordering method [small, large]
    sum: list = field(default_factory=lambda: [0, 0])
    num: list = field(default_factory=lambda: [0, 0])
    xsum: list = field(default_factory=lambda: [0.0, 0.0])
    link: list = field(default_factory=lambda: [None, None])
    removed: bool = False
    start_of_chain: bool = False
    chain_num: int = 1
    order_index: int = 0


def even_gap_link_hsps(
    hsps: list[HSP],
    kbp_by_context,                 # context -> KarlinBlock
    contexts,                       # context -> ContextParams
    subject_length: int,
    cutoff_small_gap: int,
    cutoff_big_gap: int = 0,
    gap_size: int = BLAST_GAP_SIZE,
    overlap_size: int = BLAST_OVERLAP_SIZE,
    gap_prob: float = BLAST_GAP_PROB,
    gap_decay_rate: float = BLAST_GAP_DECAY_RATE,
) -> list[HSP]:
    """Link one subject's HSP list; sets evalue and ``num`` on every
    HSP and returns them in the reference's final chain order."""
    if not hsps:
        return hsps
    window_size = gap_size + overlap_size + 1
    trim_size = (overlap_size + 1) // 2
    cutoff = [cutoff_small_gap, cutoff_big_gap]
    ignore_small_gaps = cutoff[0] == 0

    links = [_Link(hsp=h) for h in hsps]
    for L in links:
        h = L.hsp
        q_len = (h.q_end - h.q_off) // 4
        s_len = (h.s_end - h.s_off) // 4
        L.q_off_trim = h.q_off + min(q_len, trim_size)
        L.q_end_trim = h.q_end - min(q_len, trim_size)
        L.s_off_trim = h.s_off + min(s_len, trim_size)
        L.s_end_trim = h.s_end - min(s_len, trim_size)

    # reverse position sort (s_RevCompareHSPs): context asc, q_off desc,
    # s_off desc
    links.sort(key=lambda L: (L.hsp.context, -L.hsp.q_off, -L.hsp.s_off))

    # frame groups: one per context (strand_factor == 1)
    groups: dict[int, list[_Link]] = {}
    for L in links:
        groups.setdefault(L.hsp.context, []).append(L)

    for ctx, group in groups.items():
        cp = contexts[ctx]
        kbp = kbp_by_context[ctx]
        query_length = max(cp.query_length - cp.length_adjustment, 1)
        subj_len = max(subject_length - cp.length_adjustment, 1)
        live = [L for L in group]
        while live:
            # forward pass over the rev-sorted list: H walks from the
            # largest q_off down; H2 candidates lie earlier in the list
            # (larger offsets), i.e. H chains to alignments on its right
            for index in (0, 1):
                if index == 0 and ignore_small_gaps:
                    continue
                for hi, H in enumerate(live):
                    best_num = 0
                    best_sum = 0
                    best_xsum = 0.0
                    best_link = None
                    if H.hsp.score > cutoff[index]:
                        q_et = H.q_end_trim
                        s_et = H.s_end_trim
                        q_et_gap = q_et + window_size
                        s_et_gap = s_et + window_size
                        for h2i in range(hi - 1, -1, -1):
                            H2 = live[h2i]
                            q_off_t = H2.q_off_trim
                            s_off_t = H2.s_off_trim
                            if index == 0 and (
                                q_off_t > q_et_gap + trim_size
                            ):
                                # rev-sorted: q_off only grows walking
                                # up; past the window we can stop
                                # (small gaps only, link_hsps.c:734)
                                break
                            if q_off_t <= q_et or s_off_t <= s_et:
                                continue
                            if index == 0 and (
                                q_off_t > q_et_gap or s_off_t > s_et_gap
                            ):
                                continue
                            if H2.sum[index] > best_sum:
                                best_num = H2.num[index]
                                best_sum = H2.sum[index]
                                best_xsum = H2.xsum[index]
                                best_link = H2
                    score = H.hsp.score
                    H.xsum[index] = (
                        best_xsum + score * kbp.Lambda - kbp.logK
                    )
                    H.sum[index] = best_sum + (score - cutoff[index])
                    H.num[index] = best_num + 1
                    H.link[index] = best_link

            # pick the best chain across ordering methods
            prob = [float(INT4_MAX), float(INT4_MAX)]
            best = [None, None]
            for index in (0, 1):
                if index == 0 and ignore_small_gaps:
                    continue
                maxscore = -cutoff[index]
                for H in live:
                    if H.sum[index] >= maxscore:
                        maxscore = H.sum[index]
                        best[index] = H
            if not ignore_small_gaps:
                b0, b1 = best[0], best[1]
                b0.sum[0] += b0.num[0] * cutoff[0]
                prob[0] = small_gap_sum_e(
                    window_size, b0.num[0], b0.xsum[0], query_length,
                    subj_len, cp.eff_searchsp,
                    gap_decay_divisor(gap_decay_rate, b0.num[0]),
                )
                if b0.num[0] > 1:
                    if gap_prob == 0 or prob[0] / gap_prob > INT4_MAX:
                        prob[0] = INT4_MAX
                    else:
                        prob[0] /= gap_prob
                prob[1] = large_gap_sum_e(
                    b1.num[1], b1.xsum[1], query_length, subj_len,
                    cp.eff_searchsp,
                    gap_decay_divisor(gap_decay_rate, b1.num[1]),
                )
                if b1.num[1] > 1:
                    if 1 - gap_prob == 0 or (
                        prob[1] / (1 - gap_prob) > INT4_MAX
                    ):
                        prob[1] = INT4_MAX
                    else:
                        prob[1] /= 1 - gap_prob
                method = 0 if prob[0] <= prob[1] else 1
            else:
                b1 = best[1]
                b1.sum[1] += b1.num[1] * cutoff[1]
                prob[1] = large_gap_sum_e(
                    b1.num[1], b1.xsum[1], query_length, subj_len,
                    cp.eff_searchsp,
                    gap_decay_divisor(gap_decay_rate, b1.num[1]),
                )
                method = 1

        # remove the chain, assign e-values
            head = best[method]
            head.start_of_chain = True
            chain = []
            H = head
            while H is not None:
                chain.append(H)
                H = H.link[method]
            for H in chain:
                H.hsp.evalue = prob[method]
                H.hsp.num = len(chain) if len(chain) > 1 else 1
                H.removed = True
                H.chain_num = len(chain)
            head.chain_members = chain
            live = [L for L in live if not L.removed]

    # final ordering (link_hsps.c:1000-1062): forward sort by
    # (context, q_off, s_off); chains emitted at their head's position
    order = sorted(
        (L for L in links),
        key=lambda L: (L.hsp.context, L.hsp.q_off, L.hsp.s_off),
    )
    out: list[HSP] = []
    emitted = set()
    for L in order:
        if id(L) in emitted:
            continue
        if L.start_of_chain:
            for M in L.chain_members:
                out.append(M.hsp)
                emitted.add(id(M))
    return out
