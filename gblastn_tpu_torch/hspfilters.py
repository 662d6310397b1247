"""Prelim-stage HSP filter writers: best-hit and culling.

Host-side reimplementation of the reference's pluggable HSP writers
(reference: NCBI c++/src/algo/blast/core/hspfilter_besthit.c
and hspfilter_culling.c), which replace the default collector when
``-best_hit_overhang``/``-best_hit_score_edge`` or ``-culling_limit``
are given:

* BestHitWriter -- s_BlastHSPBestHitRun (:252): per query, a sorted
  list of surviving hits in plus-strand query coordinates; a new hit A
  is rejected when an existing B with B.end >= A.end, B.begin <= A.begin,
  evalueB <= evalueA and scoreB/lenB > (scoreA/lenA)/(1-score_edge)
  exists; an accepted A evicts old hits whose overhang-trimmed range
  lies within A's overhang-extended range with worse e-value and
  density (:304-336). Stored ranges are overhang-extended exactly as
  the reference stores them.
* CullingWriter -- hspfilter_culling.c: each hit carries a merit
  (initially culling_limit); a dominating hit (s_DominateTest :84:
  weighted score/length criterion + >50% overlap) decrements it, and
  hits reaching merit 0 are dropped. This is a faithful port of the
  reference's INTERVAL TREE (midpoint-subdivided over [0, qlen),
  nodes forked at 20 resident hits): candidate merit counts only
  dominators in nodes along the descent path (s_FirstPass low-merit
  screen + s_SecondPass full count, :427-487), and an accepted hit
  that covers a node's whole range MARKS DOWN the entire subtree
  without re-testing scores (s_MarkDownCTree :321) -- the spatial
  semantics the round-4 pairwise approximation lacked.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from gblastn_tpu_torch.hits import HSP, HSPList


@dataclass
class _BHNode:
    hsp: HSP
    sid: int
    begin: int
    end: int
    len: int


class BestHitWriter:
    """-best_hit_overhang / -best_hit_score_edge filter."""

    def __init__(self, num_queries: int, overhang: float,
                 score_edge: float):
        self.overhang = overhang
        self.score_edge = score_edge
        self.best: list[list[_BHNode]] = [[] for _ in range(num_queries)]

    def add_hsplist(self, lst: HSPList, qblock) -> None:
        param_s = 1.0 - self.score_edge
        for hsp in lst.hsps:
            ctx = qblock.contexts[hsp.context]
            qid = ctx.query_index
            qlen = qblock.lengths[qid]
            if ctx.frame < 0:
                begin = qlen - hsp.q_end
            else:
                begin = hsp.q_off
            lenA = hsp.q_end - hsp.q_off
            end = begin + lenA
            scoreA = hsp.score
            evalueA = hsp.evalue
            denA = scoreA / lenA / param_s

            blist = self.best[qid]
            # is A bad? (:287-301)
            bad = False
            i = 0
            while i < len(blist) and blist[i].end < end:
                i += 1
            while i < len(blist) and blist[i].begin < begin:
                p = blist[i]
                if (
                    p.end >= end
                    and p.hsp.evalue <= evalueA
                    and p.hsp.score / p.len > denA
                ):
                    bad = True
                    break
                i += 1
            if bad:
                continue

            # does A make old hits bad? (:304-336)
            oh = int(2.0 * lenA * self.overhang /
                     (1.0 - 2.0 * self.overhang))
            allowed_begin = begin - oh
            allowed_end = end + oh
            oh = int(lenA * self.overhang)
            begin -= oh
            end += oh
            denA = scoreA / lenA * param_s
            i = 0
            while i < len(blist) and blist[i].begin < allowed_begin:
                i += 1
            while i < len(blist) and blist[i].begin < allowed_end:
                p = blist[i]
                p_oh = (p.end - p.begin - p.len) // 2
                if (
                    p.begin + p_oh >= begin
                    and p.end - p_oh <= end
                    and p.hsp.evalue >= evalueA
                    and p.hsp.score / p.len < denA
                ):
                    del blist[i]
                else:
                    i += 1

            # insert A keeping the list sorted by begin (:338-352)
            i = 0
            while i < len(blist) and blist[i].begin < begin:
                i += 1
            blist.insert(
                i, _BHNode(hsp=hsp, sid=lst.oid, begin=begin, end=end,
                           len=lenA)
            )

    def export(self, qid: int) -> list[HSPList]:
        """Surviving hits of one query, grouped by subject oid."""
        by_sid: dict[int, HSPList] = {}
        for node in self.best[qid]:
            by_sid.setdefault(
                node.sid, HSPList(oid=node.sid)
            ).hsps.append(node.hsp)
        return [by_sid[k] for k in sorted(by_sid)]


def dominate_test(p_begin, p_end, p_score, y_begin, y_end, y_score,
                  drop_y_if_tie: bool) -> bool:
    """s_DominateTest (hspfilter_culling.c:84)."""
    l1 = p_end - p_begin
    l2 = y_end - y_begin
    d = 3 * p_score * l1 + p_score * l2 - y_score * l1 - 3 * y_score * l2
    if d < 0 or (
        (p_end + p_begin - 2 * y_begin) * (p_end + p_begin - 2 * y_end) > 0
        and (y_end + y_begin - 2 * p_begin)
        * (y_end + y_begin - 2 * p_end) > 0
    ):
        return False
    if d > 0 or (drop_y_if_tie and p_score == y_score and l1 == l2):
        return True
    return p_score > y_score


@dataclass
class _CullHSP:
    hsp: HSP
    sid: int
    begin: int
    end: int
    merit: int


_FORK_AT = 20   # kNumHSPtoFork (hspfilter_culling.c:454)


class _CTree:
    """One culling interval-tree node (CTreeNode,
    hspfilter_culling.c:200): midpoint-subdivided range with a
    front-inserted resident HSP list."""

    __slots__ = ("begin", "end", "left", "right", "hsps")

    def __init__(self, begin: int, end: int):
        self.begin = begin
        self.end = end
        self.left: "_CTree | None" = None
        self.right: "_CTree | None" = None
        self.hsps: list[_CullHSP] = []


def _dom(p: _CullHSP, y: _CullHSP, drop_y_if_tie: bool) -> bool:
    return dominate_test(p.begin, p.end, p.hsp.score,
                         y.begin, y.end, y.hsp.score, drop_y_if_tie)


def _process_hsplist(node: _CTree, y: _CullHSP) -> int:
    """s_ProcessHSPList: decrement merits of residents y dominates,
    dropping dead ones; returns the remaining count."""
    kept = []
    for r in node.hsps:
        if r is not y and _dom(y, r, False):
            r.merit -= 1
            if r.merit <= 0:
                continue
        kept.append(r)
    node.hsps = kept
    return len(kept)


def _mark_down(node: "_CTree | None") -> "_CTree | None":
    """s_MarkDownCTree: blanket merit decrement of a fully-covered
    subtree (no dominate re-test)."""
    if node is None:
        return None
    node.left = _mark_down(node.left)
    node.right = _mark_down(node.right)
    kept = []
    for r in node.hsps:
        r.merit -= 1
        if r.merit > 0:
            kept.append(r)
    node.hsps = kept
    if not kept and node.left is None and node.right is None:
        return None
    return node


def _fork_children(node: _CTree) -> None:
    """s_ForkChildren: push residents wholly inside a half down to the
    (front of the) matching child list."""
    midpt = (node.begin + node.end) // 2
    stay = []
    for r in node.hsps:
        if r.end < midpt:
            if node.left is None:
                node.left = _CTree(node.begin, midpt)
            node.left.hsps.insert(0, r)
        elif r.begin > midpt:
            if node.right is None:
                node.right = _CTree(midpt, node.end)
            node.right.hsps.insert(0, r)
        else:
            stay.append(r)
    node.hsps = stay


def _process_ctree(node: "_CTree | None", x: _CullHSP) -> "_CTree | None":
    """s_ProcessCTree: recursive merit update for the addition of x,
    with the fully-covered-subtree markdown shortcut."""
    if node is None:
        return None
    if x.begin <= node.begin and x.end >= node.end:
        return _mark_down(node)
    if node.left is None and node.right is None:
        if _process_hsplist(node, x) <= 0:
            return None
        return node
    midpt = (node.begin + node.end) // 2
    if x.end < midpt:
        node.left = _process_ctree(node.left, x)
    elif x.begin > midpt:
        node.right = _process_ctree(node.right, x)
    else:
        node.left = _process_ctree(node.left, x)
        node.right = _process_ctree(node.right, x)
        if (_process_hsplist(node, x) <= 0
                and node.left is None and node.right is None):
            return None
    return node


class CullingWriter:
    """-culling_limit filter: merit counting over per-context culling
    interval trees, port of hspfilter_culling.c."""

    def __init__(self, num_contexts: int, culling_limit: int):
        self.culling_limit = culling_limit
        self.trees: list[_CTree | None] = [None] * num_contexts

    def add_hsplist(self, lst: HSPList, qblock) -> None:
        for hsp in lst.hsps:
            cid = hsp.context
            A = _CullHSP(
                hsp=hsp, sid=lst.oid, begin=hsp.q_off, end=hsp.q_end,
                merit=self.culling_limit,
            )
            tree = self.trees[cid]
            if tree is None:
                ctx = qblock.contexts[cid]
                tree = _CTree(0, ctx.length)
                self.trees[cid] = tree
            if self._first_pass(tree, A):
                self._second_pass(cid, A)

    def _first_pass(self, tree: "_CTree | None", A: _CullHSP) -> bool:
        """s_FirstPass: low-merit screen along the descent path."""
        while tree is not None:
            for p in tree.hsps:
                if p.merit == 1 and _dom(p, A, True):
                    return False
            midpt = (tree.begin + tree.end) // 2
            if A.end < midpt:
                tree = tree.left
            elif A.begin > midpt:
                tree = tree.right
            else:
                return True
        return True

    def _second_pass(self, cid: int, A: _CullHSP) -> bool:
        """s_FullPass along the path + insertion + merit updates."""
        tree = self.trees[cid]
        node = tree
        while tree is not None:
            for p in tree.hsps:
                if _dom(p, A, True):
                    A.merit -= 1
                    if A.merit <= 0:
                        return False
            midpt = (tree.begin + tree.end) // 2
            node = tree
            if A.end < midpt:
                tree = tree.left
            elif A.begin > midpt:
                tree = tree.right
            else:
                break
        node.hsps.insert(0, A)
        if node.left is None and node.right is None:
            if _process_hsplist(node, A) >= _FORK_AT:
                _fork_children(node)
            return True
        # node may be emptied by the markdown path; reattach through
        # the root reference when it was the root
        new_node = _process_ctree(node, A)
        if node is self.trees[cid]:
            self.trees[cid] = new_node
        elif new_node is None:
            self._detach(self.trees[cid], node)
        return True

    def _detach(self, tree: "_CTree | None", target: _CTree) -> bool:
        if tree is None:
            return False
        if tree.left is target:
            tree.left = None
            return True
        if tree.right is target:
            tree.right = None
            return True
        return (self._detach(tree.left, target)
                or self._detach(tree.right, target))

    def export_query(self, qblock, qid: int) -> list[HSPList]:
        by_sid: dict[int, HSPList] = {}
        order: list[int] = []

        def rip(node: "_CTree | None"):
            """s_RipHSPOffCTree collection order: node list, left
            subtree, right subtree."""
            if node is None:
                return
            for r in node.hsps:
                if r.sid not in by_sid:
                    by_sid[r.sid] = HSPList(oid=r.sid)
                    order.append(r.sid)
                by_sid[r.sid].hsps.append(r.hsp)
            rip(node.left)
            rip(node.right)

        for cid, tree in enumerate(self.trees):
            if qblock.contexts[cid].query_index != qid:
                continue
            rip(tree)
        return [by_sid[k] for k in sorted(by_sid)]
