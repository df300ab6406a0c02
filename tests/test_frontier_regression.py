"""Frontier-pruning regression bound on the PRODUCTION graph class.

`examples/frontier_curve.py` characterizes accuracy-vs-K offline on the
genuinely-truncating order-5 flagship rescore graph (the committed
grammar, testing/flagship_grammar.py: 35,485 states); this pins the two
operating points as CI regressions:

  * max_active=7000 (the production default, transcribe_wav.py:21-24 of
    the reference) -> ZERO transcript divergence vs the exact dense
    kernel;
  * K=1024 -> bounded cost regret.

Acoustics are path-consistent (peaked around a pdf sequence sampled by
walking the graph's emitting arcs) — the serving regime — rather than
white noise, so the beam/min_active cutoff roles
(lattice-faster-decoder.cc:644-712) act like they do on real speech.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.graph.dense import NEG_INF_F32
from rhasspy_speech_tpu.ops.decoder import (
    make_decode_graph,
    traces_to_words_batch,
    viterbi_decode,
)
from rhasspy_speech_tpu.ops.frontier import (
    FrontierGraph,
    topk_backtrace,
    viterbi_topk,
)
from rhasspy_speech_tpu.testing.flagship import build_flagship_graph

T, B = 30, 4


@pytest.fixture(scope="module")
def rescore_graph():
    graph, _fuzzy, _lang = build_flagship_graph(order=5, with_fuzzy=False)
    # the production frontier regime requires genuine truncation at the
    # default max_active — keep this fixture honest if the grammar changes
    assert graph.num_states > 7000, graph.num_states
    return graph


def _path_acoustics(graph, rng):
    """[B, T, P] log-probs peaked (+6) along a pdf sequence sampled by a
    random walk over the graph's arcs from the start state."""
    order = np.argsort(graph.arc_src, kind="stable")
    srcs = graph.arc_src[order]
    starts = np.searchsorted(srcs, np.arange(graph.num_states))
    ends = np.searchsorted(srcs, np.arange(graph.num_states) + 1)
    lp = rng.randn(B, T, graph.num_pdfs).astype(np.float32)
    for b in range(B):
        state = int(np.argmax(graph.init_weight))
        for t in range(T):
            lo, hi = starts[state], ends[state]
            if lo == hi:  # dead end: restart from the init state
                state = int(np.argmax(graph.init_weight))
                lo, hi = starts[state], ends[state]
            a = order[rng.randint(lo, hi)]
            lp[b, t, graph.arc_pdf[a]] += 6.0
            state = int(graph.arc_dst[a])
    return jnp.asarray(lp)


@pytest.fixture(scope="module")
def exact_and_frontier(rescore_graph):
    graph = rescore_graph
    lp = _path_acoustics(graph, np.random.RandomState(11))
    trace, fstate, cost = viterbi_decode(make_decode_graph(graph), lp)
    assembled = traces_to_words_batch(
        graph, np.asarray(trace), np.asarray(fstate), np.asarray(cost)
    )
    fg = FrontierGraph.from_dense(graph)
    return graph, lp, np.asarray(cost), assembled, fg


def _frontier_result(graph, fg, lp, k):
    states_t, alphas_t, arcs_t = viterbi_topk(
        fg, lp, k, beam=24.0, min_active=200
    )
    states = np.asarray(states_t)
    alphas = np.asarray(alphas_t)
    arcs = np.asarray(arcs_t)
    last = states[-1]
    totals = np.where(
        last >= 0,
        alphas[-1] + graph.final_weight[np.maximum(last, 0)],
        NEG_INF_F32,
    )
    costs = totals.min(axis=1)
    words = [
        topk_backtrace(graph, states, alphas, arcs, i)[0] for i in range(B)
    ]
    return costs, words


def test_production_max_active_is_exact(exact_and_frontier):
    """K=7000 (production max_active) on the order-5 rescore graph:
    zero cost regret AND zero transcript divergence."""
    graph, lp, exact_cost, assembled, fg = exact_and_frontier
    costs, words = _frontier_result(graph, fg, lp, 7000)
    np.testing.assert_allclose(costs, exact_cost, atol=1e-3)
    for b in range(B):
        assert words[b] == assembled[b][0], (
            f"stream {b}: frontier transcript diverged at max_active=7000"
        )


def test_k1024_regret_bounded(exact_and_frontier):
    """K=1024 genuinely truncates (under 3% of the graph's states);
    regret stays within a pinned envelope. Measured on this graph and
    seed's path-peaked acoustics: 1.92 / 3.47 / 3.18 / 14.12 per stream.
    The 20.0 bound catches a pruning-semantics regression (one that keeps
    the wrong end of the beam loses every final path or costs hundreds)
    without flaking on the acoustics draw."""
    graph, lp, exact_cost, _assembled, fg = exact_and_frontier
    costs, _words = _frontier_result(graph, fg, lp, 1024)
    regret = costs - exact_cost
    assert np.all(np.isfinite(costs)), "truncation lost every final path"
    assert regret.max() <= 20.0, f"max regret {regret.max():.3f} > 20.0"
