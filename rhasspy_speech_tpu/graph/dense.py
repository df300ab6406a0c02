"""Dense decode-graph tensors: the device-facing product of graph compilation.

Replaces Kaldi's on-disk HCLG.fst + LatticeFasterDecoder token machinery
(/root/reference/kaldi/src/decoder/lattice-faster-decoder.cc:580-870) with a
flat arc-table representation designed for frame-synchronous dense Viterbi on
device: every arc emits a pdf (input epsilons are folded away at build time), so
one decode step is a pure gather + segment-max over the arc table, batched
over streams.

Epsilon folding: eps-input arcs (graph-only transitions, word emissions from
meta labels, final epsilon chains) are closed over and merged into the
emitting arcs/initial distribution/final weights. Output word sequences
collected along folded paths are interned into ``word_seqs`` and referenced
by id, so backtraces stay integer-only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..fst.core import EPS_ID, INF, Fst

# A weight larger than any real path cost but safely inside float32
NEG_INF_F32 = 1.0e30


@dataclass
class DenseGraph:
    """Flat emitting-arc table for batched dense Viterbi."""

    num_states: int
    arc_src: np.ndarray  # int32 [A]
    arc_dst: np.ndarray  # int32 [A]
    arc_pdf: np.ndarray  # int32 [A] — pdf id consumed by this arc
    arc_wseq: np.ndarray  # int32 [A] — index into word_seqs
    arc_weight: np.ndarray  # float32 [A] — graph cost
    final_weight: np.ndarray  # float32 [S] — NEG_INF_F32 if non-final
    final_wseq: np.ndarray  # int32 [S] — words emitted by final closure
    init_weight: np.ndarray  # float32 [S] — initial distribution (closure)
    init_wseq: np.ndarray  # int32 [S]
    word_seqs: List[Tuple[int, ...]] = field(default_factory=list)
    num_pdfs: int = 0
    # Optional HMM metadata (graph/transitions.py), zeros when absent:
    # lang phone id at phone-entry arcs (0 elsewhere), unscaled transition
    # -log prob, and the self-loop flag — the lattice rescore chain's inputs.
    arc_phone: Optional[np.ndarray] = None  # int32 [A]
    arc_tcost: Optional[np.ndarray] = None  # float32 [A]
    arc_self: Optional[np.ndarray] = None  # int8 [A]

    @property
    def num_arcs(self) -> int:
        return int(self.arc_src.shape[0])

    @property
    def has_phone_info(self) -> bool:
        return self.arc_phone is not None and bool(self.arc_phone.any())

    def words_of(self, wseq_id: int) -> Tuple[int, ...]:
        return self.word_seqs[wseq_id]

    def save(self, path: str) -> None:
        extras = {}
        if self.arc_phone is not None:
            extras["arc_phone"] = self.arc_phone
        if self.arc_tcost is not None:
            extras["arc_tcost"] = self.arc_tcost
        if self.arc_self is not None:
            extras["arc_self"] = self.arc_self
        np.savez_compressed(
            path,
            num_states=self.num_states,
            arc_src=self.arc_src,
            arc_dst=self.arc_dst,
            arc_pdf=self.arc_pdf,
            arc_wseq=self.arc_wseq,
            arc_weight=self.arc_weight,
            final_weight=self.final_weight,
            final_wseq=self.final_wseq,
            init_weight=self.init_weight,
            init_wseq=self.init_wseq,
            word_seq_flat=np.array(
                [w for seq in self.word_seqs for w in seq], dtype=np.int32
            ),
            word_seq_len=np.array([len(s) for s in self.word_seqs], dtype=np.int32),
            num_pdfs=self.num_pdfs,
            **extras,
        )

    @staticmethod
    def load(path: str) -> "DenseGraph":
        data = np.load(path)
        lens = data["word_seq_len"]
        flat = data["word_seq_flat"]
        seqs: List[Tuple[int, ...]] = []
        pos = 0
        for length in lens:
            seqs.append(tuple(int(x) for x in flat[pos : pos + length]))
            pos += length
        return DenseGraph(
            num_states=int(data["num_states"]),
            arc_src=data["arc_src"],
            arc_dst=data["arc_dst"],
            arc_pdf=data["arc_pdf"],
            arc_wseq=data["arc_wseq"],
            arc_weight=data["arc_weight"],
            final_weight=data["final_weight"],
            final_wseq=data["final_wseq"],
            init_weight=data["init_weight"],
            init_wseq=data["init_wseq"],
            word_seqs=seqs,
            num_pdfs=int(data["num_pdfs"]),
            arc_phone=data["arc_phone"] if "arc_phone" in data.files else None,
            arc_tcost=data["arc_tcost"] if "arc_tcost" in data.files else None,
            arc_self=data["arc_self"] if "arc_self" in data.files else None,
        )


def _eps_closure(
    fst: Fst, state: int, max_items: int = 100000
) -> List[Tuple[int, float, Tuple[int, ...]]]:
    """All (target, weight, output words) reachable via input-eps arcs,
    including the trivial (state, 0, ()). Distinct word sequences are kept
    as separate items; same-sequence targets keep the min weight."""
    best: Dict[Tuple[int, Tuple[int, ...]], float] = {(state, ()): 0.0}
    stack: List[Tuple[int, float, Tuple[int, ...]]] = [(state, 0.0, ())]
    while stack:
        q, w, words = stack.pop()
        if w > best.get((q, words), INF):
            continue
        for il, ol, aw, ns in fst.arcs[q]:
            if il != EPS_ID:
                continue
            if ns == q and ol == EPS_ID:
                continue  # trivial eps self loop
            new_words = words + ((ol,) if ol != EPS_ID else ())
            nw = w + aw
            key = (ns, new_words)
            if nw < best.get(key, INF) - 1e-12:
                best[key] = nw
                stack.append((ns, nw, new_words))
                if len(best) > max_items:
                    raise ValueError("epsilon-closure explosion in dense build")
    return [(q, w, words) for (q, words), w in best.items()]


def dense_from_hclg(hclg: Fst, num_pdfs: int, transitions=None) -> DenseGraph:
    """Fold input epsilons and flatten to the dense arc table.

    hclg convention: ilabel = pdf+1 (0 = eps), olabel = word id. When the
    HCLG was built with a :class:`~..graph.transitions.TransitionTable`,
    pass it here: ilabels are then transition indices (+1) and the decoded
    pdf/phone/transition-cost metadata is stored alongside each arc.
    """
    n = hclg.num_states
    wseq_intern: Dict[Tuple[int, ...], int] = {(): 0}
    word_seqs: List[Tuple[int, ...]] = [()]

    def intern(words: Tuple[int, ...]) -> int:
        wid = wseq_intern.get(words)
        if wid is None:
            wid = len(word_seqs)
            wseq_intern[words] = wid
            word_seqs.append(words)
        return wid

    closures = [_eps_closure(hclg, s) for s in range(n)]

    # Final weights: best (weight + final) over the closure of each state
    final_weight = np.full(n, NEG_INF_F32, dtype=np.float32)
    final_wseq = np.zeros(n, dtype=np.int32)
    for s in range(n):
        best_w = INF
        best_words: Tuple[int, ...] = ()
        for q, w, words in closures[s]:
            if hclg.finals[q] != INF:
                total = w + hclg.finals[q]
                if total < best_w:
                    best_w = total
                    best_words = words
        if best_w != INF:
            final_weight[s] = best_w
            final_wseq[s] = intern(best_words)

    # Initial distribution: closure of the start state
    init_weight = np.full(n, NEG_INF_F32, dtype=np.float32)
    init_wseq = np.zeros(n, dtype=np.int32)
    if hclg.start >= 0:
        init_best: Dict[int, Tuple[float, Tuple[int, ...]]] = {}
        for q, w, words in closures[hclg.start]:
            if q not in init_best or w < init_best[q][0]:
                init_best[q] = (w, words)
        for q, (w, words) in init_best.items():
            init_weight[q] = w
            init_wseq[q] = intern(words)

    # Emitting arcs with epsilon suffix-closure folded in
    srcs: List[int] = []
    dsts: List[int] = []
    pdfs: List[int] = []
    wseqs: List[int] = []
    weights: List[float] = []
    phones: List[int] = []
    tcosts: List[float] = []
    selfs: List[int] = []

    for s in range(n):
        for il, ol, w, ns in hclg.arcs[s]:
            if il == EPS_ID:
                continue  # handled via closures
            if transitions is not None:
                tr = transitions.get(il)
                pdf = tr.pdf
                phone = tr.phone if tr.is_entry else 0
                tcost = tr.trans_cost
                is_self = int(tr.is_self_loop)
            else:
                pdf, phone, tcost, is_self = il - 1, 0, 0.0, 0
            head_words = (ol,) if ol != EPS_ID else ()
            # Merge identical (dst, words) continuations, keep min weight
            merged: Dict[Tuple[int, Tuple[int, ...]], float] = {}
            for q, cw, cwords in closures[ns]:
                key = (q, head_words + cwords)
                total = w + cw
                if total < merged.get(key, INF):
                    merged[key] = total
            for (q, words), total in merged.items():
                srcs.append(s)
                dsts.append(q)
                pdfs.append(pdf)
                wseqs.append(intern(words))
                weights.append(total)
                phones.append(phone)
                tcosts.append(tcost)
                selfs.append(is_self)

    return chain_reorder(
        DenseGraph(
            num_states=n,
            arc_src=np.asarray(srcs, dtype=np.int32),
            arc_dst=np.asarray(dsts, dtype=np.int32),
            arc_pdf=np.asarray(pdfs, dtype=np.int32),
            arc_wseq=np.asarray(wseqs, dtype=np.int32),
            arc_weight=np.asarray(weights, dtype=np.float32),
            final_weight=final_weight,
            final_wseq=final_wseq,
            init_weight=init_weight,
            init_wseq=init_wseq,
            word_seqs=word_seqs,
            num_pdfs=num_pdfs,
            arc_phone=np.asarray(phones, dtype=np.int32),
            arc_tcost=np.asarray(tcosts, dtype=np.float32),
            arc_self=np.asarray(selfs, dtype=np.int8),
        )
    )


def _path_cover_child(g: DenseGraph) -> np.ndarray:
    """child[s] = the state to number directly after s, or -1.

    Chooses a maximum-cardinality set of non-self arcs such that every
    state has at most one chosen in-arc and one chosen out-arc (a path/
    cycle cover via maximum bipartite matching, Hopcroft–Karp through
    scipy); numbering along those paths maximizes how many states get the
    decode kernel's gather-free ``src == state-1`` chain lane. Falls back
    to the round-3 greedy (lowest-arc-id parent claims) when scipy is
    unavailable."""
    S = g.num_states
    A = g.arc_src.shape[0]
    nonself = g.arc_src != g.arc_dst
    child = np.full(S, -1, dtype=np.int64)
    try:
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import maximum_bipartite_matching

        src = g.arc_src[nonself].astype(np.int64)
        dst = g.arc_dst[nonself].astype(np.int64)
        if src.size == 0:
            return child
        m = csr_matrix(
            (np.ones(src.size, dtype=np.int8), (src, dst)), shape=(S, S)
        )
        match = maximum_bipartite_matching(m, perm_type="column")
        child = np.asarray(match, dtype=np.int64)  # per src row: dst or -1
    except Exception:  # pragma: no cover - scipy always present in env
        parent = np.full(S, -1, dtype=np.int64)
        order_desc = np.arange(A - 1, -1, -1)
        sel = order_desc[nonself[order_desc]]
        parent[g.arc_dst[sel]] = g.arc_src[sel]
        for d in range(S):
            p = parent[d]
            if p >= 0 and p != d and child[p] < 0:
                child[p] = d
    return child


def chain_reorder(g: DenseGraph) -> DenseGraph:
    """Renumber states so each state's forward-lane source sits at id-1
    wherever possible (an equivalent FST, states permuted).

    HCLG phone-internal sequences are linear chains; a maximum path cover
    (see _path_cover_child) picks one in-arc per state to chain, and this
    reorder numbers the cover's paths consecutively. The decode kernel's
    forward-arc relaxation for chained states is then a SHIFT of the alpha
    row instead of a gather (ops/decoder.py SelfLoopHybridGraph detects
    ``src == state - 1`` in-arcs structurally, so graphs saved before this
    pass still decode — they just use the chain lane less). Arc order
    (and therefore min-arc-id tie-breaks) is unchanged; only state ids are
    relabeled.
    """
    S = g.num_states
    if S == 0:
        return g
    child = _path_cover_child(g)

    # Walk paths from heads (states with no chosen in-arc); a matching's
    # chosen-edge graph is disjoint simple paths + simple cycles, so any
    # state not reached from a head sits on a cycle — start there and the
    # walk severs the cycle's final edge naturally (its target is already
    # numbered).
    has_parent = np.zeros(S, dtype=bool)
    valid = child >= 0
    has_parent[child[valid]] = True
    perm = np.full(S, -1, dtype=np.int64)  # old id -> new id
    nxt = 0
    for s in range(S):
        if has_parent[s] or perm[s] >= 0:
            continue
        cur = s
        while cur >= 0 and perm[cur] < 0:
            perm[cur] = nxt
            nxt += 1
            cur = child[cur]
    for s in range(S):  # pure cycles (no head)
        if perm[s] < 0:
            cur = s
            while cur >= 0 and perm[cur] < 0:
                perm[cur] = nxt
                nxt += 1
                cur = child[cur]
    assert nxt == S

    inv = np.empty(S, dtype=np.int64)
    inv[perm] = np.arange(S)
    p32 = perm.astype(np.int32)
    return DenseGraph(
        num_states=S,
        arc_src=p32[g.arc_src],
        arc_dst=p32[g.arc_dst],
        arc_pdf=g.arc_pdf,
        arc_wseq=g.arc_wseq,
        arc_weight=g.arc_weight,
        final_weight=g.final_weight[inv],
        final_wseq=g.final_wseq[inv],
        init_weight=g.init_weight[inv],
        init_wseq=g.init_wseq[inv],
        word_seqs=g.word_seqs,
        num_pdfs=g.num_pdfs,
        arc_phone=g.arc_phone,
        arc_tcost=g.arc_tcost,
        arc_self=g.arc_self,
    )


# ---------------------------------------------------------------------------
# NumPy reference Viterbi (ground truth for the device decoder; also used by
# host-side tests)
# ---------------------------------------------------------------------------


def viterbi_numpy(
    graph: DenseGraph, log_probs: np.ndarray, acoustic_scale: float = 1.0
) -> Tuple[Optional[List[int]], float]:
    """Best-path decode over [T, num_pdfs] log-probs. Returns (word ids,
    total cost) or (None, inf) if no complete path."""
    T = log_probs.shape[0]
    n = graph.num_states
    alpha = graph.init_weight.astype(np.float64).copy()
    # Backpointers: per frame, per state: best incoming arc index
    bp = np.zeros((T, n), dtype=np.int64)

    src = graph.arc_src
    dst = graph.arc_dst
    for t in range(T):
        am_cost = -acoustic_scale * log_probs[t]
        scores = alpha[src] + graph.arc_weight + am_cost[graph.arc_pdf]
        new_alpha = np.full(n, NEG_INF_F32, dtype=np.float64)
        best_arc = np.full(n, -1, dtype=np.int64)
        order = np.argsort(scores, kind="stable")
        # Iterate ascending so the first write per dst is the best
        for idx in order:
            d = dst[idx]
            if best_arc[d] < 0:
                best_arc[d] = idx
                new_alpha[d] = scores[idx]
        alpha = new_alpha
        bp[t] = best_arc

    totals = alpha + graph.final_weight.astype(np.float64)
    best_state = int(np.argmin(totals))
    best_cost = float(totals[best_state])
    if best_cost >= NEG_INF_F32:
        return None, float("inf")

    # Backtrace
    words_rev: List[Tuple[int, ...]] = [graph.words_of(int(graph.final_wseq[best_state]))]
    state = best_state
    for t in range(T - 1, -1, -1):
        arc = int(bp[t, state])
        assert arc >= 0
        words_rev.append(graph.words_of(int(graph.arc_wseq[arc])))
        state = int(graph.arc_src[arc])
    words_rev.append(graph.words_of(int(graph.init_wseq[state])))

    words: List[int] = []
    for seq in reversed(words_rev):
        words.extend(seq)
    return words, best_cost
