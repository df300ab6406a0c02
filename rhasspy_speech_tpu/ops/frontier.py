"""Top-K sparse-frontier Viterbi: the big-graph escape hatch.

Dense decoding (ops/decoder.py) keeps every state active — ideal for
template grammars, wasteful past ~1e5 states. This decoder keeps only the
K best states per stream (LatticeFasterDecoder's max-active cutoff,
lattice-faster-decoder.h:38-66, recast without data-dependent control
flow): each frame expands the frontier's out-arcs, deduplicates
destinations by a lexicographic (state, cost) sort, and retains the top K.

All shapes are static: [B, K] frontier, [B, K, D] expansions (D = max
out-degree, padded). Backpointers are [T, B, K] — independent of graph
size, so arbitrarily large graphs decode in bounded memory.

Exact when K >= the number of simultaneously-reachable states; otherwise a
beam approximation like Kaldi's max-active. The two dedup strategies
(dense scatter-min scratch vs lexicographic sort, chosen by scratch size)
agree exactly in the exact regime; under pruning they may keep different
equal-cost candidates at the beam boundary — both valid beams, like
Kaldi's heap ordering.

Performance note: at dense-feasible graph sizes this path does far more
gather and sort work than the dense decoder; it exists for graphs whose
[B, S] alpha/backpointer tensors cannot fit at all.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..graph.dense import NEG_INF_F32, DenseGraph
from .decoder import INF_COST, STAY, DeviceGraph

# Default per-frame dedup scratch cap in BYTES ([B, S] f32+i32 scatter
# targets for the dense-dedup path); larger graphs/batches fall back to
# the sort path. Callers with a decode memory budget pass it through
# (scratch_bytes), so the frontier never out-allocates the budget that
# routed decoding to it in the first place.
DEFAULT_DEDUP_SCRATCH_BYTES = 2 << 30


@dataclass(frozen=True)
class FrontierGraph:
    """DeviceGraph plus the out-degree-padded arc table."""

    base: DeviceGraph
    arcs_out: jnp.ndarray  # int32 [S, D], -1 padding
    out_degree: int

    @staticmethod
    def from_dense(g: DenseGraph) -> "FrontierGraph":
        S = g.num_states
        outdeg = np.bincount(g.arc_src, minlength=S)
        D = max(int(outdeg.max()), 1)
        arcs_out = np.full((S, D), -1, dtype=np.int32)
        fill = np.zeros(S, dtype=np.int64)
        for a in range(g.arc_src.shape[0]):
            s = int(g.arc_src[a])
            arcs_out[s, fill[s]] = a
            fill[s] += 1
        return FrontierGraph(
            base=DeviceGraph.from_dense(g),
            arcs_out=jnp.asarray(arcs_out),
            out_degree=D,
        )


def frontier_step(
    graph: FrontierGraph,
    states: jnp.ndarray,  # [B, K] int32 (-1 = empty slot)
    alpha: jnp.ndarray,  # [B, K] f32
    am_cost: jnp.ndarray,  # [B, P]
    k: int,
    scratch_bytes: int = DEFAULT_DEDUP_SCRATCH_BYTES,
    beam: Optional[float] = None,
    min_active: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One frame: returns (new_states [B,K], new_alpha [B,K], arcs [B,K]).

    ``beam``/``min_active`` implement LatticeFasterDecoder's GetCutoff
    (lattice-faster-decoder.cc:644-712) under static shapes: after the
    top-K (the max_active cap), candidates costlier than best+beam are
    dropped — except the first ``min_active`` slots, which survive any
    beam (Kaldi's min-active floor keeps the search alive through bad
    acoustic stretches). beam=None keeps every top-K candidate."""
    base = graph.base
    B = states.shape[0]
    D = graph.out_degree
    safe_states = jnp.maximum(states, 0)
    arcs = graph.arcs_out[safe_states]  # [B, K, D]
    valid = (arcs >= 0) & (states >= 0)[:, :, None] & (
        alpha < INF_COST
    )[:, :, None]
    safe_arcs = jnp.maximum(arcs, 0)
    if base.src_pdf is not None:
        # pdf-per-source fold (decoder._state_pdf): every out-arc of a
        # frontier state shares that state's am term, so gather it once
        # per slot ([B, K]) instead of per expanded arc ([B, K*D]).
        am_state = jnp.take_along_axis(
            am_cost, base.src_pdf[safe_states], axis=1
        )  # [B, K]
        cost = (alpha + am_state)[:, :, None] + base.arc_weight[safe_arcs]
    else:
        cost = (
            alpha[:, :, None]
            + base.arc_weight[safe_arcs]
            + jnp.take_along_axis(
                am_cost, base.arc_pdf[safe_arcs].reshape(B, -1), axis=1
            ).reshape(B, states.shape[1], D)
        )
    cost = jnp.where(valid, jnp.minimum(cost, INF_COST), INF_COST)
    dst = jnp.where(valid, base.arc_dst[safe_arcs], jnp.int32(2**30))

    flat_cost = cost.reshape(B, -1)
    flat_dst = dst.reshape(B, -1)
    flat_arc = jnp.where(valid, safe_arcs, -1).reshape(B, -1)

    S = base.num_states
    # Per-destination dedup. Two strategies, chosen by scratch size:
    #
    # (a) dense scatter-min dedup: a per-FRAME [B, S] scratch (T times
    #     smaller than the [T, B, S] backpointers this decoder exists to
    #     avoid) — two scatter-mins replace the two stable argsorts of the
    #     sort path, the frontier step's dominant cost;
    # (b) lexicographic (dst, cost) ordering via two stable sorts (JAX
    #     default int width is 32, so a packed 64-bit key isn't
    #     available) when even [B, S] scratch is too large.
    if B * S * 8 <= scratch_bytes:  # f32 + i32 scratch
        rows = jnp.arange(B)[:, None]
        clamped_dst = jnp.minimum(flat_dst, S - 1)  # 2**30 pad -> in range
        pad_mask = flat_dst >= S
        dense_cost = (
            jnp.full((B, S), INF_COST).at[rows, clamped_dst].min(
                jnp.where(pad_mask, INF_COST, flat_cost)
            )
        )
        A = base.num_arcs
        is_best = (flat_cost <= dense_cost[rows, clamped_dst]) & ~pad_mask
        cand = jnp.where(is_best, jnp.maximum(flat_arc, 0), A)
        arc_best = (
            jnp.full((B, S), A, dtype=jnp.int32)
            .at[rows, clamped_dst]
            .min(cand)
        )
        # unique winner per destination: the min-arc-id candidate that
        # achieves the min cost (same tie-break as the dense kernel)
        winner = (cand == arc_best[rows, clamped_dst]) & (cand < A)
        uniq_cost = jnp.where(winner, flat_cost, INF_COST)
        top_cost, top_idx = jax.lax.top_k(-uniq_cost, k)
        top_cost = -top_cost
        new_states = jnp.take_along_axis(
            clamped_dst, top_idx, axis=1
        ).astype(jnp.int32)
        new_arcs = jnp.take_along_axis(flat_arc, top_idx, axis=1)
    else:
        order1 = jnp.argsort(flat_cost, axis=1, stable=True)
        dst1 = jnp.take_along_axis(flat_dst, order1, axis=1)
        cost1 = jnp.take_along_axis(flat_cost, order1, axis=1)
        arc1 = jnp.take_along_axis(flat_arc, order1, axis=1)
        order2 = jnp.argsort(dst1, axis=1, stable=True)
        s_dst = jnp.take_along_axis(dst1, order2, axis=1)
        s_cost = jnp.take_along_axis(cost1, order2, axis=1)
        s_arc = jnp.take_along_axis(arc1, order2, axis=1)
        # first occurrence per dst = its min cost
        first = jnp.concatenate(
            [
                jnp.ones((B, 1), dtype=bool),
                s_dst[:, 1:] != s_dst[:, :-1],
            ],
            axis=1,
        )
        uniq_cost = jnp.where(first & (s_cost < INF_COST), s_cost, INF_COST)

        top_cost, top_idx = jax.lax.top_k(-uniq_cost, k)
        top_cost = -top_cost
        new_states = jnp.take_along_axis(s_dst, top_idx, axis=1).astype(
            jnp.int32
        )
        new_arcs = jnp.take_along_axis(s_arc, top_idx, axis=1)
    if beam is not None and np.isfinite(beam):
        # top_k over -cost yields slots sorted best-first, so slot index
        # IS the rank: the min_active floor is a prefix mask.
        best = top_cost[:, :1]
        keep = (top_cost <= best + jnp.float32(beam)) | (
            jnp.arange(top_cost.shape[1])[None, :] < min_active
        )
        top_cost = jnp.where(keep, top_cost, INF_COST)
    dead = top_cost >= INF_COST
    new_states = jnp.where(dead, -1, new_states)
    new_arcs = jnp.where(dead, -1, new_arcs)
    return new_states, top_cost, new_arcs


def viterbi_topk(
    graph: FrontierGraph,
    log_probs: jnp.ndarray,
    k: int,
    acoustic_scale: float = 1.0,
    lengths: Optional[jnp.ndarray] = None,
    scratch_bytes: int = DEFAULT_DEDUP_SCRATCH_BYTES,
    beam: Optional[float] = None,
    min_active: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sparse-frontier decode over [B, T, P] log-probs.

    lengths: optional [B] int32 per-stream frame counts; frames at or past
    a stream's length keep the carried frontier and record STAY arcs.

    beam/min_active: per-frame beam pruning with a survivor floor on top
    of the top-K cap (see frontier_step).

    Returns (states [T, B, K], alphas [T, B, K], arcs [T, B, K])."""
    base = graph.base
    B = log_probs.shape[0]
    am_costs = -acoustic_scale * jnp.swapaxes(log_probs, 0, 1)

    init = base.init_weight
    init_top, init_states = jax.lax.top_k(-init, min(k, init.shape[0]))
    init_alpha = jnp.broadcast_to(-init_top[None, :], (B, init_states.shape[0]))
    init_state = jnp.broadcast_to(init_states[None, :], (B, init_states.shape[0]))
    if init_states.shape[0] < k:
        pad = k - init_states.shape[0]
        init_alpha = jnp.pad(init_alpha, ((0, 0), (0, pad)),
                             constant_values=NEG_INF_F32)
        init_state = jnp.pad(init_state, ((0, 0), (0, pad)),
                             constant_values=-1)
    init_state = jnp.where(init_alpha >= INF_COST, -1, init_state).astype(
        jnp.int32
    )

    if lengths is None:
        def step(carry, am_t):
            states, alpha = carry
            new_states, new_alpha, arcs = frontier_step(
                graph, states, alpha, am_t, k, scratch_bytes,
                beam, min_active,
            )
            return (new_states, new_alpha), (new_states, new_alpha, arcs)

        _, (states_t, alphas_t, arcs_t) = jax.lax.scan(
            step, (init_state, init_alpha), am_costs
        )
        return states_t, alphas_t, arcs_t

    ts = jnp.arange(am_costs.shape[0], dtype=jnp.int32)

    def step_masked(carry, xs):
        am_t, t = xs
        states, alpha = carry
        new_states, new_alpha, arcs = frontier_step(
            graph, states, alpha, am_t, k, scratch_bytes,
            beam, min_active,
        )
        active = (t < lengths)[:, None]  # [B, 1]
        out_states = jnp.where(active, new_states, states)
        out_alpha = jnp.where(active, new_alpha, alpha)
        out_arcs = jnp.where(active, arcs, STAY)
        return (out_states, out_alpha), (out_states, out_alpha, out_arcs)

    _, (states_t, alphas_t, arcs_t) = jax.lax.scan(
        step_masked, (init_state, init_alpha), (am_costs, ts)
    )
    return states_t, alphas_t, arcs_t


def topk_backtrace(
    dense: DenseGraph,
    states_t: np.ndarray,  # [T, B, K]
    alphas_t: np.ndarray,
    arcs_t: np.ndarray,
    stream: int,
) -> Tuple[Optional[List[int]], float]:
    """Host backtrace of a stream's best complete hypothesis."""
    T = states_t.shape[0]
    last_states = states_t[-1, stream]
    totals = np.where(
        last_states >= 0,
        alphas_t[-1, stream] + dense.final_weight[np.maximum(last_states, 0)],
        NEG_INF_F32,
    )
    slot = int(np.argmin(totals))
    if totals[slot] >= NEG_INF_F32:
        return None, float("inf")
    cost = float(totals[slot])

    words, _used = _walk_back(dense, states_t, arcs_t, stream, slot)
    if words is None:
        return None, float("inf")
    return words, cost


def _walk_back(
    dense: DenseGraph,
    states_t: np.ndarray,
    arcs_t: np.ndarray,
    stream: int,
    slot: int,
) -> Tuple[Optional[List[int]], Optional[Tuple[int, ...]]]:
    """Backtrace one final slot to (word ids, arc tuple) or (None, None)."""
    T = states_t.shape[0]
    cur_state = int(states_t[-1, stream, slot])
    words_rev = [dense.words_of(int(dense.final_wseq[cur_state]))]
    arc_path = []
    for t in range(T - 1, -1, -1):
        slots = np.where(states_t[t, stream] == cur_state)[0]
        assert slots.size, (t, cur_state)
        arc = int(arcs_t[t, stream, slots[0]])
        if arc == STAY:
            continue  # masked padding frame: frontier carried over
        if arc < 0:
            return None, None
        arc_path.append(arc)
        words_rev.append(dense.words_of(int(dense.arc_wseq[arc])))
        cur_state = int(dense.arc_src[arc])
    words_rev.append(dense.words_of(int(dense.init_wseq[cur_state])))
    words: List[int] = []
    for seq in reversed(words_rev):
        words.extend(seq)
    return words, tuple(arc_path)


def topk_backtrace_nbest(
    dense: DenseGraph,
    states_t: np.ndarray,  # [T, B, K]
    alphas_t: np.ndarray,
    arcs_t: np.ndarray,
    stream: int,
    n: int,
) -> List[Tuple[List[int], float]]:
    """N-best distinct word sequences from one stream's frontier trellis.

    The K final slots each carry an independent best-path-to-state; sorted
    by total cost and backtraced, they yield up to K alternatives — the
    max-active-bounded analogue of the dense decoder's exact k-best."""
    last_states = states_t[-1, stream]
    totals = np.where(
        last_states >= 0,
        alphas_t[-1, stream] + dense.final_weight[np.maximum(last_states, 0)],
        NEG_INF_F32,
    )
    results: List[Tuple[List[int], float]] = []
    seen = set()
    for slot in np.argsort(totals, kind="stable"):
        if totals[slot] >= NEG_INF_F32 or len(results) >= n:
            break
        words, _arcs = _walk_back(dense, states_t, arcs_t, stream, int(slot))
        if words is None:
            continue
        key = tuple(words)
        if key in seen:
            continue
        seen.add(key)
        results.append((words, float(totals[slot])))
    return results


def viterbi_topk_cached(
    graph: FrontierGraph,
    log_probs: jnp.ndarray,
    k: int,
    acoustic_scale: float = 1.0,
    lengths: Optional[jnp.ndarray] = None,
    scratch_bytes: int = DEFAULT_DEDUP_SCRATCH_BYTES,
    beam: Optional[float] = None,
    min_active: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """viterbi_topk through a compiled function cached on the graph object.

    The raw function rebuilds its scan closures per call, which recompiles
    on every decode. The cache
    key is (k, acoustic_scale, scratch_bytes, beam, min_active); jit
    re-specializes per input shape."""
    B, T, _P = log_probs.shape
    if lengths is None:
        lengths = jnp.full((B,), T, dtype=jnp.int32)

    cache = getattr(graph, "_topk_fns", None)
    if cache is None:
        cache = {}
        object.__setattr__(graph, "_topk_fns", cache)
    beam_key = None if beam is None or not np.isfinite(beam) else float(beam)
    key = (
        int(k), float(acoustic_scale), int(scratch_bytes),
        beam_key, int(min_active),
    )
    fn = cache.get(key)
    if fn is None:
        fn = jax.jit(
            lambda lp, lens: viterbi_topk(
                graph, lp, k, acoustic_scale, lens, scratch_bytes,
                beam, min_active,
            )
        )
        cache[key] = fn
    return fn(log_probs, lengths)
