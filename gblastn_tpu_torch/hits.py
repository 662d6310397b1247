"""HSP (high-scoring segment pair) management.

Host-side reimplementation of the reference HSP machinery (reference:
NCBI c++/src/algo/blast/core/blast_hits.c):

* ``HSP`` / ``HSPList`` / ``HitList`` mirror BlastHSP / BlastHSPList /
  BlastHitList (blast_hits.h);
* sort orders reproduce ``ScoreCompareHSPs`` (blast_hits.c:1182),
  ``s_EvalueCompareHSPs`` (:1264, fuzzy e-value compare :1250) and
  ``s_EvalueCompareHSPLists`` (:2759);
* ``get_evalues`` / ``get_bit_scores`` / ``reap_by_evalue`` reproduce
  Blast_HSPListGetEvalues (:1655), GetBitScores (:1740), ReapByEvalue (:1807);
* ``adjust_odd_scores`` reproduces Blast_HSPListAdjustOddBlastnScores (:2734)
  (the round-down rule for odd reward with even penalty combos);
* ``purge_common_endpoints`` reproduces
  Blast_HSPListPurgeHSPsWithCommonEndpoints (:2224) including the blastn
  keep-and-cut mode (s_CutOffGapEditScript :2162);
* ``ContainmentIndex`` reproduces the interval-tree containment pruning
  of BLAST_GetGappedScore (s_HSPIsContained, blast_itree.c:815): flat
  scan while saved-HSP counts stay small, midpoint interval tree past
  that (``hsp_contained_in_saved`` is the flat-scan reference form).

Edit scripts are lists of ``(op, num)`` with the reference op codes
(gapinfo.h:45-52): ``OP_DEL``=0 gap in query, ``OP_SUB``=3 substitution,
``OP_INS``=6 gap in subject.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

from gblastn_tpu_torch.stats.evalue import gap_decay_divisor, karlin_stoe
from gblastn_tpu_torch.stats.karlin import LN2, KarlinBlock

OP_DEL = 0   # gap in query (subject letters consumed)
OP_SUB = 3   # substitution / match
OP_INS = 6   # gap in subject (query letters consumed)

EditScript = list[tuple[int, int]]

FUZZY_EVALUE_COMPARE_FACTOR = 1e-6


@dataclass
class HSP:
    """One high-scoring segment pair (BlastHSP, blast_hits.h:126-147).

    Offsets are 0-based half-open [offset, end) in context-local
    coordinates (query) and subject-local coordinates.
    """

    q_off: int
    q_end: int
    s_off: int
    s_end: int
    score: int
    context: int = 0
    q_frame: int = 1
    s_frame: int = 1
    q_gapped_start: int = 0
    s_gapped_start: int = 0
    evalue: float = 0.0
    bit_score: float = 0.0
    num_ident: int = 0
    edit_script: EditScript | None = None
    was_cut: bool = False   # trimmed by the common-endpoint purge
    num: int = 1            # linked-set size (sum statistics)

    def copy(self) -> "HSP":
        es = list(self.edit_script) if self.edit_script is not None else None
        return HSP(
            self.q_off, self.q_end, self.s_off, self.s_end, self.score,
            self.context, self.q_frame, self.s_frame,
            self.q_gapped_start, self.s_gapped_start,
            self.evalue, self.bit_score, self.num_ident, es,
        )


@dataclass
class HSPList:
    """All HSPs of one (query set, subject) pair (BlastHSPList)."""

    oid: int = 0
    hsps: list[HSP] = field(default_factory=list)
    best_evalue: float = 0.0

    def __len__(self) -> int:
        return len(self.hsps)


@dataclass
class HitList:
    """Per-query collection of HSP lists (BlastHitList)."""

    hitlist_size: int = 500
    hsplists: list[HSPList] = field(default_factory=list)


# --------------------------------------------------------------------- sorts
def score_sort_key(h: HSP):
    """Total order of ScoreCompareHSPs (blast_hits.c:1182)."""
    return (-h.score, h.s_off, -h.s_end, h.q_off, -h.q_end)


def sort_by_score(hsps: list[HSP]) -> None:
    hsps.sort(key=score_sort_key)


def fuzzy_evalue_comp(e1: float, e2: float) -> int:
    """s_FuzzyEvalueComp (blast_hits.c:1250)."""
    if e1 < (1 - FUZZY_EVALUE_COMPARE_FACTOR) * e2:
        return -1
    if e1 > (1 + FUZZY_EVALUE_COMPARE_FACTOR) * e2:
        return 1
    return 0


def _evalue_cmp(h1: HSP, h2: HSP) -> int:
    r = fuzzy_evalue_comp(h1.evalue, h2.evalue)
    if r:
        return r
    k1, k2 = score_sort_key(h1), score_sort_key(h2)
    return -1 if k1 < k2 else (1 if k1 > k2 else 0)


def sort_by_evalue(hsps: list[HSP]) -> None:
    """s_EvalueCompareHSPs order (blast_hits.c:1264)."""
    hsps.sort(key=functools.cmp_to_key(_evalue_cmp))


def hsplist_cmp(a: HSPList, b: HSPList) -> int:
    """s_EvalueCompareHSPLists (blast_hits.c:2759): best e-value, then best
    score, then larger oid first."""
    if not a.hsps and not b.hsps:
        return 0
    if not a.hsps:
        return 1
    if not b.hsps:
        return -1
    r = fuzzy_evalue_comp(a.best_evalue, b.best_evalue)
    if r:
        return r
    if a.hsps[0].score != b.hsps[0].score:
        return -1 if a.hsps[0].score > b.hsps[0].score else 1
    return -1 if a.oid > b.oid else (1 if a.oid < b.oid else 0)


def sort_hsplists_by_evalue(lists: list[HSPList]) -> None:
    lists.sort(key=functools.cmp_to_key(hsplist_cmp))


# ------------------------------------------------------------------- scoring
def get_evalues(
    hsp_list: HSPList,
    kbp: KarlinBlock,
    eff_searchsp_by_context,
    gap_decay_rate: float = 0.0,
) -> None:
    """Blast_HSPListGetEvalues (blast_hits.c:1655). HSPs must be sorted by
    score on entry; sets per-HSP evalue and the list's best_evalue."""
    divisor = 1.0
    if gap_decay_rate != 0.0:
        divisor = gap_decay_divisor(gap_decay_rate, 1)
    for h in hsp_list.hsps:
        h.evalue = karlin_stoe(
            h.score, kbp, int(eff_searchsp_by_context[h.context])
        ) / divisor
    hsp_list.best_evalue = min(
        (h.evalue for h in hsp_list.hsps), default=0.0
    )


def get_bit_scores(hsp_list: HSPList, kbp: KarlinBlock) -> None:
    """Blast_HSPListGetBitScores (blast_hits.c:1740)."""
    for h in hsp_list.hsps:
        h.bit_score = (h.score * kbp.Lambda - kbp.logK) / LN2


def reap_by_evalue(hsp_list: HSPList, expect_value: float) -> None:
    """Blast_HSPListReapByEvalue (blast_hits.c:1807)."""
    hsp_list.hsps = [h for h in hsp_list.hsps if h.evalue <= expect_value]


def adjust_odd_scores(hsps: list[HSP], round_down: bool) -> None:
    """Blast_HSPListAdjustOddBlastnScores (blast_hits.c:2734): round raw
    scores down to even when the scoring system requires it, then re-sort."""
    if not round_down or not hsps:
        return
    for h in hsps:
        h.score &= ~1
    sort_by_score(hsps)


# ------------------------------------------------------- containment pruning
def hsp_contained_in_saved(
    saved: list[HSP],
    cand_q_off: int,
    cand_q_end: int,
    cand_s_off: int,
    cand_s_end: int,
    cand_score: int,
    cand_context: int,
    min_diag_separation: int,
) -> bool:
    """s_HSPIsContained over all saved HSPs (blast_itree.c:815-852).

    A candidate ungapped region is skipped when a saved HSP of the same
    context with >= score envelops both its endpoints and (for nonzero
    min_diag_separation) one endpoint pair lies within that many diagonals.
    The reference keys on query strand offset + subject frame sign; for
    nucleotide searches one context == one (query, strand), so comparing
    contexts is equivalent.
    """
    for t in saved:
        if t.context != cand_context or cand_score > t.score:
            continue
        if not (
            t.q_off <= cand_q_off <= t.q_end
            and t.s_off <= cand_s_off <= t.s_end
            and t.q_off <= cand_q_end <= t.q_end
            and t.s_off <= cand_s_end <= t.s_end
        ):
            continue
        if min_diag_separation == 0:
            return True
        if (
            abs((t.q_off - t.s_off) - (cand_q_off - cand_s_off))
            < min_diag_separation
            or abs((t.q_end - t.s_end) - (cand_q_end - cand_s_end))
            < min_diag_separation
        ):
            return True
    return False


class _ITreeNode:
    """Midpoint-split node: items cross ``mid``; halves are lazy."""

    __slots__ = ("lo", "hi", "mid", "items", "left", "right")

    def __init__(self, lo: int, hi: int):
        self.lo = lo
        self.hi = hi
        self.mid = (lo + hi) // 2
        self.items: list[HSP] = []
        self.left: "_ITreeNode | None" = None
        self.right: "_ITreeNode | None" = None


class ContainmentIndex:
    """Incremental containment queries over saved HSPs
    (BlastIntervalTree analog, blast_itree.c:815 s_HSPIsContained over
    a midpoint interval tree keyed on query offsets).

    Small per-context sets use a flat scan (faster in Python); past
    ``_TREE_THRESHOLD`` saved HSPs a context switches to a midpoint
    tree, making each query O(path + crossing items) instead of
    O(saved) -- the quadratic-blowup guard for repeat-rich queries.
    """

    _TREE_THRESHOLD = 32

    def __init__(self, min_diag_separation: int, q_span: int = 1 << 30):
        self.min_diag_separation = min_diag_separation
        self._span = max(int(q_span), 2)
        self._flat: dict[int, list[HSP]] = {}
        self._tree: dict[int, _ITreeNode] = {}

    def add(self, hsp: HSP) -> None:
        ctx = hsp.context
        tree = self._tree.get(ctx)
        if tree is not None:
            self._insert(tree, hsp)
            return
        lst = self._flat.setdefault(ctx, [])
        lst.append(hsp)
        if len(lst) > self._TREE_THRESHOLD:
            root = _ITreeNode(0, self._span)
            for h in lst:
                self._insert(root, h)
            self._tree[ctx] = root
            del self._flat[ctx]

    def _insert(self, node: _ITreeNode, hsp: HSP) -> None:
        lo, hi = hsp.q_off, hsp.q_end
        while True:
            if hi < node.mid:
                if node.left is None:
                    node.left = _ITreeNode(node.lo, node.mid)
                node = node.left
            elif lo > node.mid:
                if node.right is None:
                    node.right = _ITreeNode(node.mid, node.hi)
                node = node.right
            else:
                node.items.append(hsp)
                return

    def _check(self, t: HSP, q_off, q_end, s_off, s_end, score) -> bool:
        if score > t.score:
            return False
        if not (
            t.q_off <= q_off <= t.q_end
            and t.s_off <= s_off <= t.s_end
            and t.q_off <= q_end <= t.q_end
            and t.s_off <= s_end <= t.s_end
        ):
            return False
        sep = self.min_diag_separation
        if sep == 0:
            return True
        return (
            abs((t.q_off - t.s_off) - (q_off - s_off)) < sep
            or abs((t.q_end - t.s_end) - (q_end - s_end)) < sep
        )

    def contains(
        self, q_off: int, q_end: int, s_off: int, s_end: int,
        score: int, context: int,
    ) -> bool:
        """True when a saved HSP envelops the candidate (s_HSPIsContained
        semantics; see hsp_contained_in_saved)."""
        lst = self._flat.get(context)
        if lst is not None:
            for t in lst:
                if self._check(t, q_off, q_end, s_off, s_end, score):
                    return True
            return False
        node = self._tree.get(context)
        # a container's query interval covers the candidate's, so it
        # crosses every midpoint on the candidate's descent path
        while node is not None:
            for t in node.items:
                if self._check(t, q_off, q_end, s_off, s_end, score):
                    return True
            if q_end < node.mid:
                node = node.left
            elif q_off > node.mid:
                node = node.right
            else:
                return False
        return False

    def contains_hsp(self, hsp: HSP) -> bool:
        return self.contains(
            hsp.q_off, hsp.q_end, hsp.s_off, hsp.s_end, hsp.score,
            hsp.context,
        )


# ------------------------------------------------------ common-endpoint purge
def _cut_edit_script(hsp: HSP, q_cut: int, s_cut: int, cut_begin: bool) -> None:
    """s_CutOffGapEditScript (blast_hits.c:2162): trim an HSP's edit script
    at the first position where both query and subject counters reach the
    cut coordinates."""
    esp = hsp.edit_script
    if not esp:
        return
    q_cut -= hsp.q_off
    s_cut -= hsp.s_off
    qid = sid = 0
    found = False
    opid = 0
    for index, (op, num) in enumerate(esp):
        opid = 0
        while opid < num:
            if op == OP_SUB:
                qid += 1
                sid += 1
                opid += 1
            elif op == OP_DEL:
                sid += num
                opid += num
            else:  # OP_INS
                qid += num
                opid += num
            if qid >= q_cut and sid >= s_cut:
                found = True
            if found:
                break
        if found:
            break
    if not found:
        return
    if cut_begin:
        new: EditScript = []
        if opid < esp[index][1]:
            new.append((esp[index][0], esp[index][1] - opid))
        new.extend(esp[index + 1:])
        hsp.edit_script = new
        hsp.q_off += qid
        hsp.s_off += sid
    else:
        new = esp[:index]
        if opid < esp[index][1]:
            new.append((esp[index][0], opid))
        else:
            new.append(esp[index])
        hsp.edit_script = new
        hsp.q_end = hsp.q_off + qid
        hsp.s_end = hsp.s_off + sid


def _query_offset_key(h: HSP):
    """s_QueryOffsetCompareHSPs (blast_hits.c:2037)."""
    return (h.context, h.q_off, h.s_off, -h.score, -h.q_end, -h.s_end)


def _query_end_key(h: HSP):
    """s_QueryEndCompareHSPs (blast_hits.c:2102): ties break by
    DECREASING score, then DECREASING start offsets ("the shortest
    range means the largest sequence offset must come first"), so the
    shortest duplicate survives intact and the longer one is cut."""
    return (h.context, h.q_end, h.s_end, -h.score, -h.q_off, -h.s_off)


def purge_common_endpoints(hsps: list[HSP], purge: bool) -> list[HSP]:
    """Blast_HSPListPurgeHSPsWithCommonEndpoints (blast_hits.c:2224).

    With ``purge`` (non-blastn, or explicit) duplicates sharing a start or
    end point are removed; for blastn (purge=False) a longer duplicate is
    kept but cut back so it no longer overlaps the better HSP.
    """
    arr = sorted(hsps, key=_query_offset_key)
    out: list[HSP] = []
    i = 0
    while i < len(arr):
        out.append(arr[i])
        j = i + 1
        while (
            j < len(arr)
            and arr[j].context == arr[i].context
            and arr[j].q_off == arr[i].q_off
            and arr[j].s_off == arr[i].s_off
        ):
            h = arr[j]
            if not purge and h.q_end > arr[i].q_end:
                _cut_edit_script(h, arr[i].q_end, arr[i].s_end, True)
                h.was_cut = True   # caller must rescore (traceback :719)
                out.append(h)
            j += 1
        i = j

    arr = sorted(out, key=_query_end_key)
    out = []
    i = 0
    while i < len(arr):
        out.append(arr[i])
        j = i + 1
        while (
            j < len(arr)
            and arr[j].context == arr[i].context
            and arr[j].q_end == arr[i].q_end
            and arr[j].s_end == arr[i].s_end
        ):
            h = arr[j]
            if not purge and h.q_off < arr[i].q_off:
                _cut_edit_script(h, arr[i].q_off, arr[i].s_off, False)
                h.was_cut = True
                out.append(h)
            j += 1
        i = j
    return out


# ---------------------------------------------------------- hitlist updating
def hitlist_update(hit_list: HitList, hsp_list: HSPList) -> None:
    """Blast_HitListUpdate (blast_hits.c:2921): keep the hitlist_size best
    HSP lists by (fuzzy best e-value, best score, oid)."""
    if not hsp_list.hsps:
        return
    hsp_list.best_evalue = min(h.evalue for h in hsp_list.hsps)
    hit_list.hsplists.append(hsp_list)
    if len(hit_list.hsplists) > hit_list.hitlist_size:
        sort_hsplists_by_evalue(hit_list.hsplists)
        del hit_list.hsplists[hit_list.hitlist_size:]
