"""Batched dense Viterbi decoding on the accelerator.

Replaces Kaldi's LatticeFasterDecoder beam search
(kaldi/src/decoder/lattice-faster-decoder.cc:580-870: per-frame
ProcessEmitting/ProcessNonemitting over a sparse token frontier) with a
dense max-plus dynamic program over the whole state set, batched over
streams: template-grammar HCLGs are small, so keeping every state active is
cheaper than managing a sparse frontier, and it removes all
data-dependent control flow — one ``lax.scan`` over frames, each step a
gather + scatter-min over the flat arc table.

Epsilon arcs were folded into the arc table / initial / final closures by
graph/dense.py, so every decode step consumes exactly one acoustic frame.

Two entry points:
- ``viterbi``: 1-best per stream, backpointers [T, B, S] for host backtrace.
- ``viterbi_kbest``: K hypotheses per state (track-merge K-best Viterbi),
  giving n-best word sequences for the fuzzy-match / rescore stages
  (replaces lattice-to-nbest | nbest-to-linear, latbin/lattice-to-nbest.cc).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..graph.dense import NEG_INF_F32, DenseGraph

INF_COST = jnp.float32(NEG_INF_F32)

# Backpointer sentinel for masked (past-end) frames: "stay in state"
STAY = -2


def _state_pdf(g: DenseGraph):
    """Per-SOURCE-state pdf table, or None when out-arcs disagree.

    Kaldi HMM semantics make the pdf a function of the source HMM state:
    every transition out of an HMM state (self-loop and forward alike)
    carries that state's pdf (kaldi/src/hmm/transition-model.h tuples are
    (phone, hmm-state, forward-pdf, self-loop-pdf) and the standard
    topologies use one pdf per state), and graph/dense.py's epsilon
    folding keeps the emitting arc's source. Verified to hold on the
    flagship test_en HCLG (8k source states, zero conflicts). When it
    holds, every decode step can fold the acoustic cost into alpha ONCE
    per frame (alpha_e = alpha + am[state_pdf], a single [B, S] gather)
    instead of gathering am per arc slot — removing the largest gather of
    the decode step. States with no out-arcs map to pdf 0 (never read)."""
    S = g.num_states
    if g.arc_src.size == 0:
        return np.zeros(S, np.int32)
    sp = np.full(S, -1, dtype=np.int64)
    sp[g.arc_src] = g.arc_pdf
    if not (sp[g.arc_src] == g.arc_pdf).all():
        return None
    return np.where(sp < 0, 0, sp).astype(np.int32)


@dataclass(frozen=True)
class DeviceGraph:
    """DenseGraph tensors resident on device (jnp arrays)."""

    num_states: int
    num_pdfs: int
    arc_src: jnp.ndarray  # int32 [A]
    arc_dst: jnp.ndarray  # int32 [A]
    arc_pdf: jnp.ndarray  # int32 [A]
    arc_weight: jnp.ndarray  # f32 [A]
    init_weight: jnp.ndarray  # f32 [S]
    final_weight: jnp.ndarray  # f32 [S]
    # pdf-per-source-state fold (see _state_pdf); None when the graph's
    # arc pdfs are not a function of the source state.
    src_pdf: Optional[jnp.ndarray] = None  # int32 [S]

    @staticmethod
    def from_dense(g: DenseGraph) -> "DeviceGraph":
        sp = _state_pdf(g)
        return DeviceGraph(
            num_states=g.num_states,
            num_pdfs=g.num_pdfs,
            arc_src=jnp.asarray(g.arc_src),
            arc_dst=jnp.asarray(g.arc_dst),
            arc_pdf=jnp.asarray(g.arc_pdf),
            arc_weight=jnp.asarray(g.arc_weight),
            init_weight=jnp.asarray(g.init_weight),
            final_weight=jnp.asarray(g.final_weight),
            src_pdf=None if sp is None else jnp.asarray(sp),
        )

    @property
    def num_arcs(self) -> int:
        return int(self.arc_src.shape[0])

    @property
    def base(self) -> "DeviceGraph":
        """Uniform access to the scatter-form tensors: the alternative
        layouts (Padded/Hybrid) carry a `base` field; on the scatter graph
        itself it is the identity, so every decode entry point can write
        `graph.base` for any layout."""
        return self


@dataclass(frozen=True)
class PaddedDeviceGraph:
    """Scatter-free decode layout: incoming arcs grouped per destination
    state into fixed-width slot rows, so one frame's relaxation is a gather
    + reshape + min — no scatter.

    Regular states use width D (p99 in-degree); the few hub states with
    larger in-degree get their own padded table and a static index update.

    DeviceGraph's scatter-min step is the default; this layout is kept as
    the numerically-identical alternative (the gathers' cost depends on
    how XLA lowers alpha[:, slot_src]) and as the natural layout for a
    hand-written decode kernel."""

    base: DeviceGraph
    width: int
    slot_src: jnp.ndarray  # int32 [S * D]
    slot_pdf: jnp.ndarray  # int32 [S * D]
    slot_weight: jnp.ndarray  # f32 [S * D]  (INF for padding)
    slot_arc: jnp.ndarray  # int32 [S * D]  (-1 for padding)
    hub_states: jnp.ndarray  # int32 [H]
    hub_src: jnp.ndarray  # int32 [H * DH]
    hub_pdf: jnp.ndarray  # int32 [H * DH]
    hub_weight: jnp.ndarray  # f32 [H * DH]
    hub_arc: jnp.ndarray  # int32 [H * DH]
    hub_width: int

    @staticmethod
    def from_dense(g: DenseGraph, width: Optional[int] = None) -> "PaddedDeviceGraph":
        S = g.num_states
        indeg = np.bincount(g.arc_dst, minlength=S)
        if width is None:
            width = max(int(np.percentile(indeg, 99)), 2)
        order = np.argsort(g.arc_dst, kind="stable")
        regular = indeg <= width
        hub_states = np.where(~regular)[0].astype(np.int32)
        hub_width = int(indeg[hub_states].max()) if hub_states.size else 1

        def build(n_rows, row_of_state, w):
            src = np.zeros(n_rows * w, dtype=np.int32)
            pdf = np.zeros(n_rows * w, dtype=np.int32)
            wt = np.full(n_rows * w, NEG_INF_F32, dtype=np.float32)
            arc = np.full(n_rows * w, -1, dtype=np.int32)
            fill = np.zeros(n_rows, dtype=np.int64)
            for a in order:
                d = int(g.arc_dst[a])
                row = row_of_state.get(d)
                if row is None:
                    continue
                k = fill[row]
                if k >= w:
                    continue
                slot = row * w + k
                src[slot] = g.arc_src[a]
                pdf[slot] = g.arc_pdf[a]
                wt[slot] = g.arc_weight[a]
                arc[slot] = a
                fill[row] = k + 1
            return src, pdf, wt, arc

        reg_rows = {s: s for s in range(S) if regular[s]}
        src, pdf, wt, arc = build(S, reg_rows, width)
        hub_rows = {int(s): i for i, s in enumerate(hub_states)}
        if hub_states.size:
            hsrc, hpdf, hwt, harc = build(len(hub_states), hub_rows, hub_width)
        else:
            hsrc = np.zeros(1, np.int32)
            hpdf = np.zeros(1, np.int32)
            hwt = np.full(1, NEG_INF_F32, np.float32)
            harc = np.full(1, -1, np.int32)
            hub_width = 1

        return PaddedDeviceGraph(
            base=DeviceGraph.from_dense(g),
            width=width,
            slot_src=jnp.asarray(src),
            slot_pdf=jnp.asarray(pdf),
            slot_weight=jnp.asarray(wt),
            slot_arc=jnp.asarray(arc),
            hub_states=jnp.asarray(
                hub_states if hub_states.size else np.zeros(0, np.int32)
            ),
            hub_src=jnp.asarray(hsrc),
            hub_pdf=jnp.asarray(hpdf),
            hub_weight=jnp.asarray(hwt),
            hub_arc=jnp.asarray(harc),
            hub_width=hub_width,
        )


def viterbi_step_padded(
    graph: PaddedDeviceGraph, alpha: jnp.ndarray, am_cost: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Scatter-free decode frame: (new_alpha [B, S], best_arc [B, S])."""
    B = alpha.shape[0]
    S = graph.base.num_states
    D = graph.width
    folded = graph.base.src_pdf is not None
    if folded:
        alpha = alpha + _fold_am(graph, am_cost)
        scores = (
            alpha[:, graph.slot_src] + graph.slot_weight[None, :]
        ).reshape(B, S, D)
    else:
        scores = (
            alpha[:, graph.slot_src]
            + graph.slot_weight[None, :]
            + am_cost[:, graph.slot_pdf]
        ).reshape(B, S, D)
    scores = jnp.minimum(scores, INF_COST)
    new_alpha = jnp.min(scores, axis=-1)
    kmin = jnp.argmin(scores, axis=-1)  # [B, S]
    slot = jnp.arange(S)[None, :] * D + kmin
    best_arc = graph.slot_arc[slot]
    best_arc = jnp.where(new_alpha >= INF_COST, -1, best_arc)

    H = graph.hub_states.shape[0]
    if H:
        DH = graph.hub_width
        if folded:
            hscores = (
                alpha[:, graph.hub_src] + graph.hub_weight[None, :]
            ).reshape(B, H, DH)
        else:
            hscores = (
                alpha[:, graph.hub_src]
                + graph.hub_weight[None, :]
                + am_cost[:, graph.hub_pdf]
            ).reshape(B, H, DH)
        hscores = jnp.minimum(hscores, INF_COST)
        h_alpha = jnp.min(hscores, axis=-1)
        h_k = jnp.argmin(hscores, axis=-1)
        h_arc = graph.hub_arc[jnp.arange(H)[None, :] * DH + h_k]
        h_arc = jnp.where(h_alpha >= INF_COST, -1, h_arc)
        new_alpha = new_alpha.at[:, graph.hub_states].set(h_alpha)
        best_arc = best_arc.at[:, graph.hub_states].set(h_arc)
    return new_alpha, best_arc


@dataclass(frozen=True)
class HybridDeviceGraph:
    """Width-W padded in-arc slots + scatter-min spill.

    HMM states overwhelmingly have exactly two in-arcs (forward +
    self-loop), so a width-2 slot table covers ~75% of arcs with zero
    padding waste and turns their relaxation into a gather + min over a
    [B, S, 2] tensor; only the word-boundary/LM hub arcs (the remaining
    quarter) go through the slow scatter-min. Unlike PaddedDeviceGraph's
    all-padded layout — whose hub tier pads every high-in-degree state to
    the max in-degree and loses 7-15x — the spill stays in the scatter
    form that XLA lowers well, just 4x smaller."""

    base: DeviceGraph
    width: int
    slot_src: jnp.ndarray  # int32 [S * W]
    slot_pdf: jnp.ndarray  # int32 [S * W]
    slot_weight: jnp.ndarray  # f32 [S * W] (INF padding)
    slot_arc: jnp.ndarray  # int32 [S * W] (-1 padding)
    spill_src: jnp.ndarray  # int32 [Nspill]
    spill_dst: jnp.ndarray  # int32 [Nspill]
    spill_pdf: jnp.ndarray  # int32 [Nspill]
    spill_weight: jnp.ndarray  # f32 [Nspill]
    spill_arc: jnp.ndarray  # int32 [Nspill]

    @staticmethod
    def from_dense(g: DenseGraph, width: int = 2) -> "HybridDeviceGraph":
        S = g.num_states
        # vectorized slot assignment: stable-sort arcs by destination, rank
        # each arc within its destination group; ranks < width go to slots
        # (so slot arc ids stay ascending per state — the tie-break relies
        # on that), the rest spill.
        order = np.argsort(g.arc_dst, kind="stable")
        dst_sorted = g.arc_dst[order].astype(np.int64)
        indeg = np.bincount(dst_sorted, minlength=S)
        group_start = np.concatenate([[0], np.cumsum(indeg)[:-1]])
        rank = np.arange(order.size, dtype=np.int64) - group_start[dst_sorted]
        in_slot = rank < width
        slot_arcs = order[in_slot]
        slot_idx = dst_sorted[in_slot] * width + rank[in_slot]

        src = np.zeros(S * width, dtype=np.int32)
        pdf = np.zeros(S * width, dtype=np.int32)
        wt = np.full(S * width, NEG_INF_F32, dtype=np.float32)
        arc = np.full(S * width, -1, dtype=np.int32)
        src[slot_idx] = g.arc_src[slot_arcs]
        pdf[slot_idx] = g.arc_pdf[slot_arcs]
        wt[slot_idx] = g.arc_weight[slot_arcs]
        arc[slot_idx] = slot_arcs
        spill = np.sort(order[~in_slot])
        return HybridDeviceGraph(
            base=DeviceGraph.from_dense(g),
            width=width,
            slot_src=jnp.asarray(src),
            slot_pdf=jnp.asarray(pdf),
            slot_weight=jnp.asarray(wt),
            slot_arc=jnp.asarray(arc),
            spill_src=jnp.asarray(g.arc_src[spill]),
            spill_dst=jnp.asarray(g.arc_dst[spill]),
            spill_pdf=jnp.asarray(g.arc_pdf[spill]),
            spill_weight=jnp.asarray(g.arc_weight[spill]),
            spill_arc=jnp.asarray(spill.astype(np.int32)),
        )


@dataclass(frozen=True)
class SelfLoopHybridGraph:
    """Gather-free lanes + width-2 gathered slots + scatter-min spill.

    Three tiers, cheapest first:
    - **self lane**: states with a self-loop (src == dst) relax it
      elementwise — no alpha gather;
    - **chain lane**: states with an in-arc from exactly ``state - 1``
      (graph/dense.chain_reorder's maximum path cover numbers states to
      maximize these) relax it against a SHIFT of the alpha row — no
      gather either;
    - **slots**: up to ``width`` of each state's remaining in-arcs ride
      the gathered width-W relaxation (the round-2 hybrid form);
    - **spill**: everything else scatter-mins.

    Correct for any state numbering — graphs saved before chain_reorder
    simply use the chain lane less. Numerically identical to the scatter
    kernel including the global min-arc-id tie-break (all tier winners
    compare (cost, arc id))."""

    base: DeviceGraph
    # self-loop lane (arc < 0 where the state has none; weight INF there)
    self_pdf: jnp.ndarray  # int32 [S]
    self_weight: jnp.ndarray  # f32 [S]
    self_arc: jnp.ndarray  # int32 [S]
    # chain lane: lowest-id non-self in-arc when its src == state-1
    fwd_pdf: jnp.ndarray  # int32 [S]
    fwd_weight: jnp.ndarray  # f32 [S]
    fwd_arc: jnp.ndarray  # int32 [S]
    # width-W gathered slots over remaining in-arcs
    width: int
    slot_src: jnp.ndarray  # int32 [S * W]
    slot_pdf: jnp.ndarray  # int32 [S * W]
    slot_weight: jnp.ndarray  # f32 [S * W] (INF padding)
    slot_arc: jnp.ndarray  # int32 [S * W] (-1 padding)
    # spill: all remaining in-arcs
    spill_src: jnp.ndarray
    spill_dst: jnp.ndarray
    spill_pdf: jnp.ndarray
    spill_weight: jnp.ndarray
    spill_arc: jnp.ndarray

    @staticmethod
    def from_dense(g: DenseGraph, width: int = 2) -> "SelfLoopHybridGraph":
        S = g.num_states
        A = g.arc_src.shape[0]
        is_self = g.arc_src == g.arc_dst
        self_pdf = np.zeros(S, dtype=np.int32)
        self_w = np.full(S, NEG_INF_F32, dtype=np.float32)
        self_arc = np.full(S, -1, dtype=np.int32)
        # lowest-id self arc per state (iterate descending so low ids win)
        order_desc = np.arange(A - 1, -1, -1)
        sel = order_desc[is_self[order_desc]]
        self_pdf[g.arc_dst[sel]] = g.arc_pdf[sel]
        self_w[g.arc_dst[sel]] = g.arc_weight[sel]
        self_arc[g.arc_dst[sel]] = sel
        taken = np.zeros(A, dtype=bool)
        taken[self_arc[self_arc >= 0]] = True

        # chain lane: lowest-id in-arc whose src == dst-1 (ANY such arc
        # qualifies — the tier merge's (cost, arc id) tie-break is global,
        # so the lane needn't hold the state's lowest-id in-arc overall;
        # graph/dense.chain_reorder's max path cover numbers states to
        # maximize how many have one)
        fwd_pdf = np.zeros(S, dtype=np.int32)
        fwd_w = np.full(S, NEG_INF_F32, dtype=np.float32)
        fwd_arc = np.full(S, -1, dtype=np.int32)
        chained_arcs = (~is_self) & (g.arc_src == g.arc_dst - 1)
        sel2 = order_desc[chained_arcs[order_desc]]
        fwd_pdf[g.arc_dst[sel2]] = g.arc_pdf[sel2]
        fwd_w[g.arc_dst[sel2]] = g.arc_weight[sel2]
        fwd_arc[g.arc_dst[sel2]] = sel2
        taken[fwd_arc[fwd_arc >= 0]] = True

        # width-W slots over the remaining arcs (stable dst-sorted rank,
        # exactly the round-2 hybrid's assignment but on the residue)
        rem = np.where(~taken)[0]
        order = rem[np.argsort(g.arc_dst[rem], kind="stable")]
        dst_sorted = g.arc_dst[order].astype(np.int64)
        indeg = np.bincount(dst_sorted, minlength=S)
        group_start = np.concatenate([[0], np.cumsum(indeg)[:-1]])
        rank = np.arange(order.size, dtype=np.int64) - group_start[dst_sorted]
        in_slot = rank < width
        slot_arcs = order[in_slot]
        slot_idx = dst_sorted[in_slot] * width + rank[in_slot]
        src = np.zeros(S * width, dtype=np.int32)
        pdf = np.zeros(S * width, dtype=np.int32)
        wt = np.full(S * width, NEG_INF_F32, dtype=np.float32)
        arc = np.full(S * width, -1, dtype=np.int32)
        src[slot_idx] = g.arc_src[slot_arcs]
        pdf[slot_idx] = g.arc_pdf[slot_arcs]
        wt[slot_idx] = g.arc_weight[slot_arcs]
        arc[slot_idx] = slot_arcs

        spill = np.sort(order[~in_slot])
        return SelfLoopHybridGraph(
            base=DeviceGraph.from_dense(g),
            self_pdf=jnp.asarray(self_pdf),
            self_weight=jnp.asarray(self_w),
            self_arc=jnp.asarray(self_arc),
            fwd_pdf=jnp.asarray(fwd_pdf),
            fwd_weight=jnp.asarray(fwd_w),
            fwd_arc=jnp.asarray(fwd_arc),
            width=width,
            slot_src=jnp.asarray(src),
            slot_pdf=jnp.asarray(pdf),
            slot_weight=jnp.asarray(wt),
            slot_arc=jnp.asarray(arc),
            spill_src=jnp.asarray(g.arc_src[spill]),
            spill_dst=jnp.asarray(g.arc_dst[spill]),
            spill_pdf=jnp.asarray(g.arc_pdf[spill]),
            spill_weight=jnp.asarray(g.arc_weight[spill]),
            spill_arc=jnp.asarray(spill.astype(np.int32)),
        )


def viterbi_step_selfloop(
    graph: SelfLoopHybridGraph, alpha: jnp.ndarray, am_cost: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One decode frame over the lanes+slots+spill layout. Numerically
    identical to the other layouts including the min-arc-id tie-break
    (every tier's winner carries its arc id; ties resolve to the global
    minimum id)."""
    base = graph.base
    B = alpha.shape[0]
    S = base.num_states
    W = graph.width
    A = base.num_arcs

    def merge(cost_a, id_a, cost_b, id_b):
        """(cost, id) lexicographic min, broadcasting ids as needed."""
        take_a = (cost_a < cost_b) | ((cost_a == cost_b) & (id_a <= id_b))
        return (
            jnp.where(take_a, cost_a, cost_b),
            jnp.where(take_a, id_a, id_b),
        )

    folded = base.src_pdf is not None
    if folded:
        # pdf-per-source fold: after this, BOTH lanes are entirely
        # gather-free (the am terms below vanish) — the layout's original
        # weakness (two extra [B, S] am gathers) disappears.
        alpha = alpha + _fold_am(graph, am_cost)

    # self-loop lane: elementwise
    s_self = alpha + graph.self_weight[None, :]
    if not folded:
        s_self = s_self + am_cost[:, graph.self_pdf]
    s_self = jnp.minimum(s_self, INF_COST)
    self_id = jnp.broadcast_to(
        jnp.where(graph.self_arc < 0, A, graph.self_arc)[None, :], (B, S)
    )
    # chain lane: shifted alpha (fwd_weight is INF for non-chain states;
    # state 0 sees the INF pad column)
    alpha_prev = jnp.pad(
        alpha[:, :-1], ((0, 0), (1, 0)), constant_values=NEG_INF_F32
    )
    s_fwd = alpha_prev + graph.fwd_weight[None, :]
    if not folded:
        s_fwd = s_fwd + am_cost[:, graph.fwd_pdf]
    s_fwd = jnp.minimum(s_fwd, INF_COST)
    fwd_id = jnp.broadcast_to(
        jnp.where(graph.fwd_arc < 0, A, graph.fwd_arc)[None, :], (B, S)
    )
    best_cost, best_id = merge(s_self, self_id, s_fwd, fwd_id)

    # gathered width-W slots over the remaining in-arcs
    pad_scores = alpha[:, graph.slot_src] + graph.slot_weight[None, :]
    if not folded:
        pad_scores = pad_scores + am_cost[:, graph.slot_pdf]
    pad_scores = jnp.minimum(pad_scores.reshape(B, S, W), INF_COST)
    slot_ids = jnp.where(graph.slot_arc < 0, A, graph.slot_arc).reshape(S, W)
    for w in range(W):
        best_cost, best_id = merge(
            best_cost,
            best_id,
            pad_scores[:, :, w],
            jnp.broadcast_to(slot_ids[None, :, w], (B, S)),
        )

    n_spill = graph.spill_src.shape[0]
    if n_spill:
        s_scores = alpha[:, graph.spill_src] + graph.spill_weight[None, :]
        if not folded:
            s_scores = s_scores + am_cost[:, graph.spill_pdf]
        s_scores = jnp.minimum(s_scores, INF_COST)
        spill_alpha = (
            jnp.full((B, S), INF_COST).at[:, graph.spill_dst].min(s_scores)
        )
        s_cand = jnp.where(
            s_scores <= spill_alpha[:, graph.spill_dst],
            graph.spill_arc[None, :],
            A,
        )
        spill_bp = (
            jnp.full((B, S), A, dtype=jnp.int32)
            .at[:, graph.spill_dst]
            .min(s_cand)
        )
        best_cost, best_id = merge(best_cost, best_id, spill_alpha, spill_bp)

    best_arc = jnp.where((best_cost >= INF_COST) | (best_id >= A), -1, best_id)
    return best_cost, best_arc


def make_decode_graph(g: DenseGraph, width: Optional[int] = None):
    """Production decode layout for a dense graph. All decode entry
    points (viterbi_decode, viterbi_decode_checkpointed,
    viterbi_kbest_decode, streaming decode_step) accept any layout.

    Selection is driven by the pdf-per-source fold (_state_pdf):

    - fold available (Kaldi HMM graphs — pdf is a function of the source
      state): the gather-free lane layout at slot width 1. With the
      per-arc am gathers folded away its lanes are pure elementwise/shift
      work, chain_reorder's max path cover feeds the chain lane, and the
      narrow slot tier halves the one remaining big gather.
    - no fold (arc pdfs not a function of src): the width-2 hybrid, since
      the lane layout would add per-lane am gathers there.

    Both choices await a measurement on the GPU."""
    if _state_pdf(g) is not None:
        return SelfLoopHybridGraph.from_dense(
            g, width=1 if width is None else width
        )
    return HybridDeviceGraph.from_dense(g, width=2 if width is None else width)


def viterbi_step_hybrid(
    graph: HybridDeviceGraph, alpha: jnp.ndarray, am_cost: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One decode frame over the hybrid layout: (new_alpha, best_arc)."""
    base = graph.base
    B = alpha.shape[0]
    S = base.num_states
    W = graph.width
    A = base.num_arcs

    folded = base.src_pdf is not None
    if folded:
        # pdf-per-source fold: ONE [B, S] am fold replaces the [B, S*W]
        # slot-pdf gather AND the [B, Nspill] spill-pdf gather below — the
        # largest HBM streams of the decode frame.
        alpha = alpha + _fold_am(graph, am_cost)
        pad_scores = (
            alpha[:, graph.slot_src] + graph.slot_weight[None, :]
        ).reshape(B, S, W)
    else:
        pad_scores = (
            alpha[:, graph.slot_src]
            + graph.slot_weight[None, :]
            + am_cost[:, graph.slot_pdf]
        ).reshape(B, S, W)
    pad_scores = jnp.minimum(pad_scores, INF_COST)
    slot_alpha = jnp.min(pad_scores, axis=-1)  # [B, S]

    # slot winner: min arc id achieving the slot min. Slots are filled in
    # ascending arc-id order per state, so for W=2 this is a plain select
    # (<= keeps the lower id on ties) — no candidate/min pass.
    arcs2 = graph.slot_arc.reshape(S, W)
    if W == 2:
        slot_bp = jnp.where(
            pad_scores[:, :, 0] <= pad_scores[:, :, 1],
            arcs2[None, :, 0],
            arcs2[None, :, 1],
        )
    else:
        pad_cand = jnp.where(
            pad_scores <= slot_alpha[:, :, None], arcs2[None, :, :], A
        )
        pad_cand = jnp.where(pad_cand < 0, A, pad_cand)
        slot_bp = jnp.min(pad_cand, axis=-1)

    n_spill = graph.spill_src.shape[0]
    if not n_spill:
        best_arc = jnp.where(slot_alpha >= INF_COST, -1, slot_bp)
        return slot_alpha, best_arc

    if folded:
        s_scores = alpha[:, graph.spill_src] + graph.spill_weight[None, :]
    else:
        s_scores = (
            alpha[:, graph.spill_src]
            + graph.spill_weight[None, :]
            + am_cost[:, graph.spill_pdf]
        )  # [B, Nspill]
    s_scores = jnp.minimum(s_scores, INF_COST)
    spill_alpha = (
        jnp.full((B, S), INF_COST).at[:, graph.spill_dst].min(s_scores)
    )
    s_cand = jnp.where(
        s_scores <= spill_alpha[:, graph.spill_dst],
        graph.spill_arc[None, :],
        A,
    )
    spill_bp = (
        jnp.full((B, S), A, dtype=jnp.int32)
        .at[:, graph.spill_dst]
        .min(s_cand)
    )
    # every spill arc id of a state exceeds all its slot arc ids (slots
    # take the lowest-id in-arcs), so on a slot/spill tie the slot wins —
    # exactly the global min-arc-id tie-break.
    use_spill = spill_alpha < slot_alpha
    new_alpha = jnp.minimum(slot_alpha, spill_alpha)
    best_arc = jnp.where(use_spill, spill_bp, slot_bp)
    best_arc = jnp.where(new_alpha >= INF_COST, -1, best_arc)
    return new_alpha, best_arc


# ---------------------------------------------------------------------------
# 1-best
# ---------------------------------------------------------------------------


def viterbi_step(
    graph: DeviceGraph, alpha: jnp.ndarray, am_cost: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One decode frame.

    alpha: [B, S] path costs; am_cost: [B, P] = -scale * log p(pdf).
    Returns (new_alpha [B, S], best_arc [B, S] int32, -1 if unreached).
    """
    B = alpha.shape[0]
    S = graph.num_states
    A = graph.num_arcs
    if graph.src_pdf is not None:
        # pdf-per-source fold: one [B, S] am fold instead of [B, A]
        alpha_e = alpha + _fold_am(graph, am_cost)
        scores = alpha_e[:, graph.arc_src] + graph.arc_weight[None, :]
    else:
        scores = (
            alpha[:, graph.arc_src] + graph.arc_weight[None, :]
            + am_cost[:, graph.arc_pdf]
        )  # [B, A]
    scores = jnp.minimum(scores, INF_COST)
    new_alpha = jnp.full((B, S), INF_COST).at[:, graph.arc_dst].min(scores)
    # winning arc = min arc index among score == new_alpha[dst]
    is_best = scores <= new_alpha[:, graph.arc_dst]
    arc_ids = jnp.arange(A, dtype=jnp.int32)
    cand = jnp.where(is_best, arc_ids[None, :], A)
    best_arc = jnp.full((B, S), A, dtype=jnp.int32).at[:, graph.arc_dst].min(cand)
    best_arc = jnp.where(new_alpha >= INF_COST, -1, best_arc)
    return new_alpha, best_arc


def decode_step(
    graph, alpha: jnp.ndarray, am_cost: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One decode frame, dispatched on the graph layout (scatter / padded /
    hybrid). All layouts are numerically identical including the min-arc-id
    tie-break; they differ only in how the arc relaxation is laid out."""
    if isinstance(graph, PaddedDeviceGraph):
        return viterbi_step_padded(graph, alpha, am_cost)
    if isinstance(graph, HybridDeviceGraph):
        return viterbi_step_hybrid(graph, alpha, am_cost)
    if isinstance(graph, SelfLoopHybridGraph):
        return viterbi_step_selfloop(graph, alpha, am_cost)
    return viterbi_step(graph, alpha, am_cost)


# Largest arc id storable in the compact uint16 backpointer encoding
# (arc + 2, reserving 0 for STAY and 1 for "dead"): 65535 - 2.
_COMPACT_BP_MAX_ARC = 65533


def viterbi(
    graph: DeviceGraph,
    log_probs: jnp.ndarray,
    acoustic_scale: float = 1.0,
    lengths: Optional[jnp.ndarray] = None,
    compact_bp: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched dense Viterbi over [B, T, P] log-probs.

    lengths: optional [B] int32 per-stream frame counts; frames at or past a
    stream's length are no-ops (alpha carried, backpointer = STAY = -2), so
    mixed-length utterances batch into one padded tensor.

    compact_bp stores backpointers as uint16 ``arc + 2`` (0 = STAY,
    1 = dead) instead of int32 — the [T, B, S] backpointer write is the
    single largest HBM stream of the decode, so halving its width is a
    direct bandwidth win whenever the graph has <= 65533 arcs. Callers
    opting in must decode accordingly (viterbi_decode does).

    Returns (alpha_final [B, S], backptr [T, B, S] int32, or uint16 encoded
    when compact_bp). Jittable; the backtrace runs on host (see
    backtrace_words)."""
    base = graph.base
    if compact_bp and base.num_arcs > _COMPACT_BP_MAX_ARC:
        raise ValueError(
            f"compact_bp needs <= {_COMPACT_BP_MAX_ARC} arcs, "
            f"got {base.num_arcs}"
        )
    am_costs = -acoustic_scale * jnp.swapaxes(log_probs, 0, 1)  # [T, B, P]
    B = log_probs.shape[0]
    alpha0 = jnp.broadcast_to(base.init_weight[None, :], (B, base.num_states))
    # scan unroll per layout: 1 for the folded lane layout, 2 for the
    # unfolded hybrid (chosen by an earlier A/B; not yet measured on the
    # GPU).
    unroll = 1 if isinstance(graph, SelfLoopHybridGraph) else 2

    def encode(bp):
        return (bp + 2).astype(jnp.uint16) if compact_bp else bp

    if lengths is None:
        def step(alpha, am_t):
            new_alpha, bp = decode_step(graph, alpha, am_t)
            return new_alpha, encode(bp)

        alpha_final, bps = jax.lax.scan(step, alpha0, am_costs, unroll=unroll)
        return alpha_final, bps

    ts = jnp.arange(am_costs.shape[0], dtype=jnp.int32)

    def step_masked(alpha, xs):
        am_t, t = xs
        new_alpha, bp = decode_step(graph, alpha, am_t)
        active = (t < lengths)[:, None]  # [B, 1]
        out_alpha = jnp.where(active, new_alpha, alpha)
        out_bp = jnp.where(active, encode(bp), encode(jnp.full_like(bp, STAY)))
        return out_alpha, out_bp

    alpha_final, bps = jax.lax.scan(
        step_masked, alpha0, (am_costs, ts), unroll=unroll
    )
    return alpha_final, bps


def backtrace_words(
    graph: DenseGraph,
    alpha_final: np.ndarray,
    backptr: np.ndarray,
    stream: int,
    num_frames: Optional[int] = None,
) -> Tuple[Optional[List[int]], float]:
    """Host-side 1-best backtrace for one stream.

    Returns (word ids, total cost) or (None, inf) when no complete path."""
    T = backptr.shape[0] if num_frames is None else num_frames
    alpha = alpha_final[stream]
    totals = alpha + graph.final_weight
    state = int(np.argmin(totals))
    if totals[state] >= NEG_INF_F32:
        return None, float("inf")
    cost = float(totals[state])

    words_rev: List[Tuple[int, ...]] = [graph.words_of(int(graph.final_wseq[state]))]
    for t in range(T - 1, -1, -1):
        arc = int(backptr[t, stream, state])
        if arc == STAY:
            continue
        if arc < 0:
            return None, float("inf")
        words_rev.append(graph.words_of(int(graph.arc_wseq[arc])))
        state = int(graph.arc_src[arc])
    words_rev.append(graph.words_of(int(graph.init_wseq[state])))

    words: List[int] = []
    for seq in reversed(words_rev):
        words.extend(seq)
    return words, cost


def viterbi_decode(
    graph: DeviceGraph,
    log_probs: jnp.ndarray,
    acoustic_scale: float = 1.0,
    lengths: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Forward + ON-DEVICE backtrace: only O(B*T) ints leave the chip.

    Returns (arc_trace [B, T] int32 winning arc per frame (STAY/-1 for
    masked/dead frames), final_state [B] int32, total_cost [B] f32 = best
    alpha+final, +inf-like NEG_INF if no complete path). Decode words on
    host with trace_to_words.

    RSTPU_DECODE_IMPL=alpha opts into the alpha-storing implementation
    (viterbi_decode_alpha, bit-identical outputs). bp is the default: the
    alpha variant's cheaper forward pays for a random-gather backtrace
    (not yet measured on the GPU)."""
    if os.environ.get("RSTPU_DECODE_IMPL", "bp") == "alpha" and (
        _max_indeg(graph) <= _ALPHA_MAX_INDEG
    ):
        return viterbi_decode_alpha(graph, log_probs, acoustic_scale, lengths)
    base = graph.base
    compact = base.num_arcs <= _COMPACT_BP_MAX_ARC
    alpha_final, bps = viterbi(
        graph, log_probs, acoustic_scale, lengths, compact_bp=compact
    )
    totals = alpha_final + base.final_weight[None, :]  # [B, S]
    final_state = jnp.argmin(totals, axis=-1).astype(jnp.int32)  # [B]
    total_cost = jnp.take_along_axis(totals, final_state[:, None], axis=1)[:, 0]

    B = log_probs.shape[0]
    rows = jnp.arange(B)

    def back_step(state, bp_t):
        arc = bp_t[rows, state]  # [B]
        if compact:
            arc = arc.astype(jnp.int32) - 2
        is_stay = arc == STAY
        is_dead = arc == -1
        src = jnp.where(
            is_stay | is_dead, state, base.arc_src[jnp.maximum(arc, 0)]
        )
        return src, arc

    # scan over reversed frames
    _, arcs_rev = jax.lax.scan(back_step, final_state, bps[::-1])
    arc_trace = arcs_rev[::-1].T  # [B, T]
    return arc_trace, final_state, total_cost


# ---------------------------------------------------------------------------
# Alpha-storing decode: no forward arc tracking. The forward drops the
# scatter-min of winner-id candidates, but the arc-recomputing backtrace
# is latency-bound on its [B, max_indeg] random gathers. Kept as an
# opt-in (RSTPU_DECODE_IMPL=alpha) with bit-exact parity pinned by tests:
# it can win when T is large and backtrace cost amortizes differently,
# and it is the reference semantics for a fused decode kernel.
# ---------------------------------------------------------------------------


def _relax_costs(graph, alpha: jnp.ndarray, am_t: jnp.ndarray) -> jnp.ndarray:
    """Cost half of decode_step: new_alpha [B, S] with NO winner tracking.

    Candidate costs are computed with the exact same expressions and clamps
    as the id-tracking steps, so the result is bit-identical to the alpha
    returned by decode_step for every layout."""
    base = graph.base
    B = alpha.shape[0]
    S = base.num_states
    folded = base.src_pdf is not None

    if isinstance(graph, SelfLoopHybridGraph):
        if folded:
            alpha_e = alpha + _fold_am(graph, am_t)
        else:
            alpha_e = alpha
        s_self = alpha_e + graph.self_weight[None, :]
        if not folded:
            s_self = s_self + am_t[:, graph.self_pdf]
        best = jnp.minimum(s_self, INF_COST)
        alpha_prev = jnp.pad(
            alpha_e[:, :-1], ((0, 0), (1, 0)), constant_values=NEG_INF_F32
        )
        s_fwd = alpha_prev + graph.fwd_weight[None, :]
        if not folded:
            s_fwd = s_fwd + am_t[:, graph.fwd_pdf]
        best = jnp.minimum(best, jnp.minimum(s_fwd, INF_COST))
        ps = alpha_e[:, graph.slot_src] + graph.slot_weight[None, :]
        if not folded:
            ps = ps + am_t[:, graph.slot_pdf]
        ps = jnp.minimum(ps.reshape(B, S, graph.width), INF_COST)
        best = jnp.minimum(best, jnp.min(ps, axis=-1))
        if graph.spill_src.shape[0]:
            ss = alpha_e[:, graph.spill_src] + graph.spill_weight[None, :]
            if not folded:
                ss = ss + am_t[:, graph.spill_pdf]
            ss = jnp.minimum(ss, INF_COST)
            spill = (
                jnp.full((B, S), INF_COST).at[:, graph.spill_dst].min(ss)
            )
            best = jnp.minimum(best, spill)
        return best

    if isinstance(graph, HybridDeviceGraph):
        if folded:
            alpha_e = alpha + _fold_am(graph, am_t)
            ps = alpha_e[:, graph.slot_src] + graph.slot_weight[None, :]
        else:
            alpha_e = alpha
            ps = (
                alpha[:, graph.slot_src]
                + graph.slot_weight[None, :]
                + am_t[:, graph.slot_pdf]
            )
        ps = jnp.minimum(ps.reshape(B, S, graph.width), INF_COST)
        best = jnp.min(ps, axis=-1)
        if graph.spill_src.shape[0]:
            ss = alpha_e[:, graph.spill_src] + graph.spill_weight[None, :]
            if not folded:
                ss = ss + am_t[:, graph.spill_pdf]
            ss = jnp.minimum(ss, INF_COST)
            spill = (
                jnp.full((B, S), INF_COST).at[:, graph.spill_dst].min(ss)
            )
            best = jnp.minimum(best, spill)
        return best

    # scatter / padded forms: relax over the flat arc table
    if folded:
        alpha_e = alpha + _fold_am(graph, am_t)
        scores = alpha_e[:, base.arc_src] + base.arc_weight[None, :]
    else:
        scores = (
            alpha[:, base.arc_src]
            + base.arc_weight[None, :]
            + am_t[:, base.arc_pdf]
        )
    scores = jnp.minimum(scores, INF_COST)
    return jnp.full((B, S), INF_COST).at[:, base.arc_dst].min(scores)


# one-hot am fold: opt-in (RSTPU_ONEHOT=1). It trades the am gather for a
# matmul against a one-hot table, whose HLO literal is large (7 MB on the
# flagship graph) and slows compilation several-fold; it can only pay for
# graphs that reference thousands of pdfs.
_ONEHOT_MAX_ELEMS = 16 * 1024 * 1024


def _onehot_enabled() -> bool:
    return os.environ.get("RSTPU_ONEHOT", "0") == "1"


def _onehot_tables(graph):
    """(sel [NU] i32, onehot [NU, S] f32) NUMPY tables over the graph's
    USED pdfs, or (None, None). Cached on the layout object as host arrays
    (device conversion happens at the use site: a cache built while
    tracing must not hold tracers)."""
    cached = getattr(graph, "_onehot_cache", None)
    if cached is not None:
        return cached
    base = graph.base
    sel = onehot = None
    if base.src_pdf is not None:
        sp = np.asarray(base.src_pdf)
        used = np.unique(sp)
        if used.size * base.num_states <= _ONEHOT_MAX_ELEMS:
            remap = np.zeros(int(sp.max()) + 1, np.int64)
            remap[used] = np.arange(used.size)
            oh = np.zeros((used.size, base.num_states), np.float32)
            oh[remap[sp], np.arange(base.num_states)] = 1.0
            onehot = oh
            sel = used.astype(np.int32)
    cached = (sel, onehot)
    object.__setattr__(graph, "_onehot_cache", cached)
    return cached


def _fold_am(graph, am_t: jnp.ndarray) -> jnp.ndarray:
    """am_t[:, src_pdf] as a one-hot matmul when exact, else a gather.

    The [B, S] am gather is decode's costliest HBM pattern — inside the
    decode scan XLA lowers it as random element reads of the un-staged am
    row (latency-bound). A Precision.HIGHEST one-hot matmul over the
    graph's USED pdfs computes the identical values (HIGHEST f32 is exact
    for one-hot operands), streaming the am row once. Falls back to the
    gather when disabled (default — see _ONEHOT_MAX_ELEMS note) or when
    the used-pdf count would make the one-hot table large."""
    base = graph.base
    if not _onehot_enabled():
        return am_t[:, base.src_pdf]
    sel, onehot = _onehot_tables(graph)
    if onehot is None:
        return am_t[:, base.src_pdf]
    return jax.lax.dot(
        am_t[:, sel].astype(onehot.dtype),
        onehot,
        precision=jax.lax.Precision.HIGHEST,
    )


@dataclass(frozen=True)
class _AlphaTables:
    """Backtrace-side tables for the alpha-storing decode (host numpy —
    a cache built while tracing must not hold tracers; users convert)."""

    in_src: np.ndarray  # i32 [S, D] in-arc sources (ascending arc id)
    in_weight: np.ndarray  # f32 [S, D] (INF pad)
    in_arc: np.ndarray  # i32 [S, D] (A pad)
    in_pdf: np.ndarray  # i32 [S, D]
    max_indeg: int


def _alpha_tables(graph) -> _AlphaTables:
    cached = getattr(graph, "_alpha_tables_cache", None)
    if cached is not None:
        return cached
    base = graph.base
    S = base.num_states
    A = base.num_arcs
    arc_src = np.asarray(base.arc_src)
    arc_dst = np.asarray(base.arc_dst)
    arc_pdf = np.asarray(base.arc_pdf)
    arc_w = np.asarray(base.arc_weight)

    order = np.argsort(arc_dst, kind="stable")  # ascending arc id per dst
    dst_sorted = arc_dst[order].astype(np.int64)
    indeg = np.bincount(dst_sorted, minlength=S)
    D = max(int(indeg.max()) if A else 1, 1)
    starts = np.concatenate([[0], np.cumsum(indeg)[:-1]])
    rank = np.arange(order.size, dtype=np.int64) - starts[dst_sorted]
    slot = dst_sorted * D + rank
    in_src = np.zeros(S * D, np.int32)
    in_w = np.full(S * D, NEG_INF_F32, np.float32)
    in_arc = np.full(S * D, A, np.int32)
    in_pdf = np.zeros(S * D, np.int32)
    in_src[slot] = arc_src[order]
    in_w[slot] = arc_w[order]
    in_arc[slot] = order
    in_pdf[slot] = arc_pdf[order]

    tabs = _AlphaTables(
        in_src=in_src.reshape(S, D),
        in_weight=in_w.reshape(S, D),
        in_arc=in_arc.reshape(S, D),
        in_pdf=in_pdf.reshape(S, D),
        max_indeg=D,
    )
    object.__setattr__(graph, "_alpha_tables_cache", tabs)
    return tabs


# in-arc tables above this width would dwarf the forward win (pathological
# hub graphs); such graphs stay on the backpointer impl
_ALPHA_MAX_INDEG = 512


def _max_indeg(graph) -> int:
    cached = getattr(graph, "_max_indeg_cache", None)
    if cached is None:
        base = graph.base
        arc_dst = np.asarray(base.arc_dst)
        cached = (
            int(np.bincount(arc_dst, minlength=base.num_states).max())
            if arc_dst.size
            else 1
        )
        object.__setattr__(graph, "_max_indeg_cache", cached)
    return cached


def viterbi_decode_alpha(
    graph: DeviceGraph,
    log_probs: jnp.ndarray,
    acoustic_scale: float = 1.0,
    lengths: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """viterbi_decode with NO forward arc tracking.

    The forward scan stores each frame's PRE-update alpha [T, B, S] instead
    of backpointers; the reverse scan recomputes the winning arc of the
    traced state only — a [B, max_indeg] gather per frame — picking the
    first (= lowest arc id) candidate achieving the stored minimum.
    Candidates recompute with the identical f32 expressions, and min is
    exact, so (arc_trace, final_state, total_cost) are bit-identical to
    viterbi_decode's. Replaces the forward's two scatter-min passes, the
    winner-candidate gather, and the [T, B, S] bp write; costs one f32
    alpha row per frame instead (2x the compact bp bytes). Opt-in, not
    default: its random-gather backtrace offsets the faster forward
    (reference hot loop: lattice-faster-decoder.cc:714-820)."""
    base = graph.base
    tabs = _alpha_tables(graph)
    in_src = jnp.asarray(tabs.in_src)
    in_weight = jnp.asarray(tabs.in_weight)
    in_arc = jnp.asarray(tabs.in_arc)
    in_pdf = jnp.asarray(tabs.in_pdf)
    B, T, _P = log_probs.shape
    am_costs = -acoustic_scale * jnp.swapaxes(log_probs, 0, 1)  # [T, B, P]
    alpha0 = jnp.broadcast_to(base.init_weight[None, :], (B, base.num_states))
    ts = jnp.arange(T, dtype=jnp.int32)

    def fwd(alpha, xs):
        am_t, t = xs
        new_alpha = _relax_costs(graph, alpha, am_t)
        if lengths is not None:
            new_alpha = jnp.where((t < lengths)[:, None], new_alpha, alpha)
        return new_alpha, alpha  # emit the PRE-frame alpha

    alpha_final, alphas = jax.lax.scan(fwd, alpha0, (am_costs, ts))

    totals = alpha_final + base.final_weight[None, :]
    final_state = jnp.argmin(totals, axis=-1).astype(jnp.int32)
    total_cost = jnp.take_along_axis(totals, final_state[:, None], axis=1)[
        :, 0
    ]

    rows = jnp.arange(B)[:, None]
    folded = base.src_pdf is not None

    def back(state, xs):
        alpha_t, am_t, t = xs
        srcs = in_src[state]  # [B, D]
        if folded:
            # match the forward's association exactly: the forward folds
            # am into alpha FIRST (fl(fl(alpha+am)+w), _relax_costs), and
            # f32 addition is non-associative — recomputing as
            # (alpha+w)+am could pick a different argmin on tie-adjacent
            # candidates and break the documented bit-identical arc_trace
            # parity with the bp path
            cand = (
                alpha_t[rows, srcs] + am_t[rows, base.src_pdf[srcs]]
            ) + in_weight[state]
        else:
            cand = (
                alpha_t[rows, srcs] + in_weight[state]
            ) + am_t[rows, in_pdf[state]]
        cand = jnp.minimum(cand, INF_COST)
        j = jnp.argmin(cand, axis=1)  # first min = lowest arc id
        best = jnp.take_along_axis(cand, j[:, None], axis=1)[:, 0]
        arc = jnp.take_along_axis(in_arc[state], j[:, None], axis=1)[:, 0]
        arc = jnp.where(best >= INF_COST, -1, arc)
        if lengths is not None:
            arc = jnp.where(t < lengths, arc, STAY)
        new_state = jnp.where(
            arc < 0, state, base.arc_src[jnp.maximum(arc, 0)]
        )
        return new_state, arc

    _, arcs = jax.lax.scan(
        back, final_state, (alphas, am_costs, ts), reverse=True
    )
    return arcs.T.astype(jnp.int32), final_state, total_cost


def traces_to_words_batch(
    graph: DenseGraph,
    arc_trace: np.ndarray,
    final_state: np.ndarray,
    total_cost: np.ndarray,
) -> List[Tuple[Optional[List[int]], float]]:
    """Vectorized word assembly for a whole batch (NumPy per stream, no
    per-frame Python loop): the hot host-tail of batched decode."""
    B, T = arc_trace.shape
    arc_wseq = graph.arc_wseq
    arc_src = graph.arc_src
    out: List[Tuple[Optional[List[int]], float]] = []
    for b in range(B):
        cost = float(total_cost[b])
        if cost >= NEG_INF_F32:
            out.append((None, float("inf")))
            continue
        arcs = arc_trace[b]
        valid = arcs >= 0
        if not valid.any():
            fs = int(final_state[b])
            words = list(graph.words_of(int(graph.init_wseq[fs])))
            words.extend(graph.words_of(int(graph.final_wseq[fs])))
            out.append((words, cost))
            continue
        real = arcs[valid]
        if (arcs == -1).any():
            out.append((None, float("inf")))
            continue
        first_state = int(arc_src[real[0]])
        words: List[int] = list(graph.words_of(int(graph.init_wseq[first_state])))
        wseqs = arc_wseq[real]
        for wid in wseqs[wseqs != 0]:
            words.extend(graph.words_of(int(wid)))
        words.extend(
            graph.words_of(int(graph.final_wseq[int(final_state[b])]))
        )
        out.append((words, cost))
    return out


def trace_to_words(
    graph: DenseGraph,
    arc_trace: np.ndarray,
    final_state: np.ndarray,
    total_cost: np.ndarray,
    stream: int,
) -> Tuple[Optional[List[int]], float]:
    """Host word assembly from a device backtrace."""
    cost = float(total_cost[stream])
    if cost >= NEG_INF_F32:
        return None, float("inf")
    arcs = arc_trace[stream]
    words: List[int] = []
    # first real arc's source state closure gives the init words
    first_state = None
    segs: List[Tuple[int, ...]] = []
    for t in range(arcs.shape[0]):
        arc = int(arcs[t])
        if arc == STAY:
            continue
        if arc < 0:
            return None, float("inf")
        if first_state is None:
            first_state = int(graph.arc_src[arc])
        segs.append(graph.words_of(int(graph.arc_wseq[arc])))
    if first_state is None:
        first_state = int(final_state[stream])
    words.extend(graph.words_of(int(graph.init_wseq[first_state])))
    for seg in segs:
        words.extend(seg)
    words.extend(graph.words_of(int(graph.final_wseq[int(final_state[stream])])))
    return words, cost


def _checkpoint_fns(graph: DeviceGraph, segment: int):
    """Compiled forward/backtrace for the sqrt-remat decoder, cached on the
    graph object: rebuilding the jitted closures per call meant a full
    recompilation every decode.
    Everything that varies per call (am costs, lengths, segment index) is
    an argument; jit re-specializes per shape and caches. Accepts any
    decode layout (scatter / padded / hybrid) via decode_step."""
    base = graph.base
    cache = getattr(graph, "_ckpt_fns", None)
    if cache is None:
        cache = {}
        object.__setattr__(graph, "_ckpt_fns", cache)
    fns = cache.get(segment)
    if fns is not None:
        return fns

    @jax.jit
    def forward_checkpoints(am, lengths):
        T_pad, B, _P = am.shape
        n_seg = T_pad // segment
        alpha0 = jnp.broadcast_to(
            base.init_weight[None, :], (B, base.num_states)
        )
        seg_costs = am.reshape(n_seg, segment, B, -1)
        ts = jnp.arange(T_pad, dtype=jnp.int32).reshape(n_seg, segment)

        def seg_step(alpha, xs):
            costs, seg_ts = xs

            def frame(a, x):
                am_t, t = x
                new_a, _bp = decode_step(graph, a, am_t)
                active = (t < lengths)[:, None]
                return jnp.where(active, new_a, a), None

            out_alpha, _ = jax.lax.scan(frame, alpha, (costs, seg_ts))
            return out_alpha, alpha  # emit the alpha BEFORE this segment

        final_alpha, boundary_alphas = jax.lax.scan(
            seg_step, alpha0, (seg_costs, ts)
        )
        return final_alpha, boundary_alphas  # [n_seg, B, S]

    @jax.jit
    def segment_backtrace(am, lengths, seg_idx, boundary_alpha, end_state):
        """Recompute one segment's bps and walk back from end_state."""
        B = end_state.shape[0]
        costs = jax.lax.dynamic_slice_in_dim(
            am, seg_idx * segment, segment, axis=0
        )
        ts = seg_idx * segment + jnp.arange(segment, dtype=jnp.int32)

        def frame(a, x):
            am_t, t = x
            new_a, bp = decode_step(graph, a, am_t)
            active = (t < lengths)[:, None]
            return (
                jnp.where(active, new_a, a),
                jnp.where(active, bp, STAY),
            )

        _, bps = jax.lax.scan(frame, boundary_alpha, (costs, ts))

        rows = jnp.arange(B)

        def back(state, bp_t):
            arc = bp_t[rows, state]
            keep = (arc == STAY) | (arc == -1)
            src = jnp.where(keep, state, base.arc_src[jnp.maximum(arc, 0)])
            return src, arc

        start_state, arcs_rev = jax.lax.scan(back, end_state, bps[::-1])
        return start_state, arcs_rev[::-1]  # [segment, B]

    fns = (forward_checkpoints, segment_backtrace)
    cache[segment] = fns
    return fns


def viterbi_decode_checkpointed(
    graph: DeviceGraph,
    log_probs: jnp.ndarray,
    acoustic_scale: float = 1.0,
    segment: int = 32,
    lengths: Optional[jnp.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Memory-bounded decode: sqrt-rematerialization of backpointers.

    The plain path materializes bp [T, B, S] (4·T·B·S bytes) — fine for
    template graphs, prohibitive for big LMs × long audio. Here the forward
    pass stores only per-segment boundary alphas; the backtrace then
    recomputes each segment's backpointers on demand (one extra forward
    pass of compute, [segment, B, S] peak memory).

    Returns host arrays (arc_trace [B, T], final_state [B], total_cost [B])
    identical to viterbi_decode's outputs."""
    B, T, _P = log_probs.shape
    n_seg = -(-T // segment)
    T_pad = n_seg * segment
    if T_pad != T:
        pad = jnp.zeros((B, T_pad - T, log_probs.shape[2]), log_probs.dtype)
        log_probs = jnp.concatenate([log_probs, pad], axis=1)
    if lengths is None:
        lengths = jnp.full((B,), T, dtype=jnp.int32)

    am_costs = -acoustic_scale * jnp.swapaxes(log_probs, 0, 1)  # [T_pad, B, P]
    forward_checkpoints, segment_backtrace = _checkpoint_fns(graph, segment)

    final_alpha, boundary_alphas = forward_checkpoints(am_costs, lengths)
    totals = final_alpha + graph.base.final_weight[None, :]
    final_state = jnp.argmin(totals, axis=-1).astype(jnp.int32)
    total_cost = jnp.take_along_axis(totals, final_state[:, None], axis=1)[:, 0]

    # The segment chain's only cross-iteration dependency (``state``)
    # stays on device, so every backtrace dispatch queues asynchronously;
    # all D2H transfers batch into ONE device_get at the end (each
    # per-segment np.asarray was a blocking RPC round-trip on a
    # remote-dispatch transport).
    state = final_state
    traces = []
    for seg_idx in range(n_seg - 1, -1, -1):
        state, arcs = segment_backtrace(
            am_costs,
            lengths,
            jnp.asarray(seg_idx, dtype=jnp.int32),
            boundary_alphas[seg_idx],
            state,
        )
        traces.append(arcs)
    traces, final_state, total_cost = jax.device_get(
        (traces, final_state, total_cost)
    )
    arc_trace = np.concatenate(traces[::-1], axis=0).T  # [B, T_pad]
    return arc_trace[:, :T], final_state, total_cost


# ---------------------------------------------------------------------------
# K-best (n-best extraction)
# ---------------------------------------------------------------------------


def kbest_step(
    graph: DeviceGraph, alpha: jnp.ndarray, am_cost: jnp.ndarray, k: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One frame of K-best Viterbi.

    alpha: [B, S, K]; returns (new_alpha [B, S, K],
    bp [B, S, K] int32 = winning flat candidate arc*K + k_prev, or -1).
    Accepts any decode layout (always runs the scatter form)."""
    graph = graph.base
    B, S, K = alpha.shape
    A = graph.num_arcs
    # candidate costs for (arc a, prev-rank k): [B, A, K]
    if graph.src_pdf is not None:
        alpha = alpha + _fold_am(graph, am_cost)[:, :, None]
        cand = alpha[:, graph.arc_src, :] + graph.arc_weight[None, :, None]
    else:
        cand = (
            alpha[:, graph.arc_src, :]
            + graph.arc_weight[None, :, None]
            + am_cost[:, graph.arc_pdf, None]
        )
    cand = jnp.minimum(cand, INF_COST).reshape(B, A * K)
    dst_flat = jnp.repeat(graph.arc_dst, K)  # [A*K]
    flat_ids = jnp.arange(A * K, dtype=jnp.int32)

    alphas = []
    bps = []
    for _ in range(k):
        m = jnp.full((B, S), INF_COST).at[:, dst_flat].min(cand)  # [B, S]
        is_best = cand <= m[:, dst_flat]
        sel = jnp.where(is_best, flat_ids[None, :], A * K)
        bp = jnp.full((B, S), A * K, dtype=jnp.int32).at[:, dst_flat].min(sel)
        bp = jnp.where(m >= INF_COST, -1, bp)
        alphas.append(m)
        bps.append(bp)
        # knock out the selected candidate so the next round finds rank+1
        taken = bp[:, dst_flat] == flat_ids[None, :]
        cand = jnp.where(taken, INF_COST, cand)
    return jnp.stack(alphas, axis=-1), jnp.stack(bps, axis=-1)


def viterbi_kbest(
    graph: DeviceGraph,
    log_probs: jnp.ndarray,
    k: int,
    acoustic_scale: float = 1.0,
    lengths: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """K-best batched Viterbi. Returns (alpha_final [B, S, K],
    backptr [T, B, S, K] int32 flat ids arc*K + k_prev; STAY for masked
    frames). Any decode layout is accepted; K-best always runs the scatter
    form (its [B, A, K] candidate tensor dwarfs the layout difference)."""
    graph = graph.base
    B = log_probs.shape[0]
    am_costs = -acoustic_scale * jnp.swapaxes(log_probs, 0, 1)
    alpha0 = jnp.full((B, graph.num_states, k), INF_COST)
    alpha0 = alpha0.at[:, :, 0].set(
        jnp.broadcast_to(graph.init_weight[None, :], (B, graph.num_states))
    )
    ts = jnp.arange(am_costs.shape[0], dtype=jnp.int32)

    def step(alpha, xs):
        am_t, t = xs
        new_alpha, bp = kbest_step(graph, alpha, am_t, k)
        if lengths is not None:
            active = (t < lengths)[:, None, None]
            new_alpha = jnp.where(active, new_alpha, alpha)
            bp = jnp.where(active, bp, STAY)
        return new_alpha, bp

    alpha_final, bps = jax.lax.scan(step, alpha0, (am_costs, ts))
    return alpha_final, bps


def viterbi_kbest_decode(
    graph: DeviceGraph,
    log_probs: jnp.ndarray,
    k: int,
    acoustic_scale: float = 1.0,
    lengths: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """K-best forward + ON-DEVICE backtrace of the global top-k hypotheses.

    Returns (arc_traces [B, K, T] int32 (STAY/-1 sentinels), seed_states
    [B, K] int32, seed_costs [B, K] f32). Only O(B*K*T) ints leave the chip
    (vs the full [T, B, S, K] backpointer tensor)."""
    graph = graph.base
    alpha_final, bps = viterbi_kbest(graph, log_probs, k, acoustic_scale, lengths)
    B = log_probs.shape[0]
    S = graph.num_states
    totals = alpha_final + graph.final_weight[None, :, None]  # [B, S, K]
    flat = totals.reshape(B, S * k)
    seed_costs, seed_flat = jax.lax.top_k(-flat, k)  # top-k smallest
    seed_costs = -seed_costs
    seed_states = (seed_flat // k).astype(jnp.int32)  # [B, K]
    seed_ranks = (seed_flat % k).astype(jnp.int32)

    rows = jnp.arange(B)[:, None]

    def back_step(carry, bp_t):
        states, ranks = carry  # [B, K] each
        entry = bp_t[rows, states, ranks]  # [B, K]
        is_stay = entry == STAY
        is_dead = entry == -1
        arc = jnp.where(is_stay | is_dead, 0, jnp.maximum(entry, 0)) // k
        new_states = jnp.where(
            is_stay | is_dead, states, graph.arc_src[arc]
        )
        new_ranks = jnp.where(
            is_stay | is_dead, ranks, jnp.maximum(entry, 0) % k
        )
        emit = jnp.where(is_stay, STAY, jnp.where(is_dead, -1, arc))
        return (new_states, new_ranks), emit

    (_, _), arcs_rev = jax.lax.scan(
        back_step, (seed_states, seed_ranks), bps[::-1]
    )
    arc_traces = jnp.transpose(arcs_rev[::-1], (1, 2, 0))  # [B, K, T]
    return arc_traces, seed_states, seed_costs


def kbest_traces_to_nbest(
    graph: DenseGraph,
    arc_traces: np.ndarray,
    seed_states: np.ndarray,
    seed_costs: np.ndarray,
    stream: int,
    n: int,
    dedup: bool = True,
) -> List[Tuple[List[int], float]]:
    """Host word assembly for viterbi_kbest_decode outputs."""
    results: List[Tuple[List[int], float]] = []
    seen = set()
    K = arc_traces.shape[1]
    for kk in range(K):
        cost = float(seed_costs[stream, kk])
        if cost >= NEG_INF_F32:
            continue
        arcs = arc_traces[stream, kk]
        if (arcs == -1).any():
            continue
        real = arcs[arcs >= 0]
        if real.shape[0]:
            first_state = int(graph.arc_src[real[0]])
        else:
            first_state = int(seed_states[stream, kk])
        words: List[int] = list(graph.words_of(int(graph.init_wseq[first_state])))
        wseqs = graph.arc_wseq[real]
        for wid in wseqs[wseqs != 0]:
            words.extend(graph.words_of(int(wid)))
        words.extend(
            graph.words_of(int(graph.final_wseq[int(seed_states[stream, kk])]))
        )
        key = tuple(words)
        if dedup and key in seen:
            continue
        seen.add(key)
        results.append((words, cost))
        if len(results) >= n:
            break
    return results


def backtrace_nbest(
    graph: DenseGraph,
    alpha_final: np.ndarray,
    backptr: np.ndarray,
    stream: int,
    n: int,
    num_frames: Optional[int] = None,
    dedup: bool = True,
) -> List[Tuple[List[int], float]]:
    """Host-side n-best backtrace for one stream from K-best tensors.

    Returns up to n (word ids, cost) pairs sorted by cost; word-sequence
    duplicates keep the cheapest (like nbest after lattice determinization)."""
    T = backptr.shape[0] if num_frames is None else num_frames
    S, K = alpha_final.shape[1], alpha_final.shape[2]
    totals = alpha_final[stream] + graph.final_weight[:, None]  # [S, K]
    flat_order = np.argsort(totals, axis=None, kind="stable")

    results: List[Tuple[List[int], float]] = []
    seen = set()
    for flat in flat_order:
        state, rank = divmod(int(flat), K)
        cost = float(totals[state, rank])
        if cost >= NEG_INF_F32:
            break
        words_rev: List[Tuple[int, ...]] = [
            graph.words_of(int(graph.final_wseq[state]))
        ]
        s, r = state, rank
        dead = False
        for t in range(T - 1, -1, -1):
            entry = int(backptr[t, stream, s, r])
            if entry == STAY:
                continue
            if entry < 0:
                dead = True
                break
            arc, r = divmod(entry, K)
            words_rev.append(graph.words_of(int(graph.arc_wseq[arc])))
            s = int(graph.arc_src[arc])
        if dead:
            continue
        words_rev.append(graph.words_of(int(graph.init_wseq[s])))
        words: List[int] = []
        for seq in reversed(words_rev):
            words.extend(seq)
        key = tuple(words)
        if dedup and key in seen:
            continue
        seen.add(key)
        results.append((words, cost))
        if len(results) >= n:
            break
    return results
