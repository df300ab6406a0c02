"""Frontier accuracy-vs-K on the genuinely-truncating rescore graph.

Builds the flagship grammar's order-N ARPA decode graph through the
triphone machinery (testing.flagship.build_flagship_graph), then decodes
random acoustics with the exact dense kernel and the top-K frontier across
K, reporting per-K cost regret and best-path agreement — the documented
accuracy-vs-K curve.

Run (CPU is fine; graph build is host-side):
    JAX_PLATFORMS=cpu python examples/frontier_curve.py [order] [T] [B]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    order = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    T = int(sys.argv[2]) if len(sys.argv) > 2 else 50
    B = int(sys.argv[3]) if len(sys.argv) > 3 else 4

    from rhasspy_speech_tpu.ops.decoder import make_decode_graph, viterbi_decode
    from rhasspy_speech_tpu.ops.frontier import FrontierGraph, viterbi_topk
    from rhasspy_speech_tpu.testing.flagship import build_flagship_graph

    graph, _g_fuzzy, _lang = build_flagship_graph(order=order, with_fuzzy=False)
    print(
        f"order-{order} graph: {graph.num_states} states / "
        f"{graph.num_arcs} arcs / {graph.num_pdfs} pdfs"
    )

    rng = np.random.RandomState(0)
    import jax.numpy as jnp

    lp = jnp.asarray(rng.randn(B, T, graph.num_pdfs).astype(np.float32))

    trace, fstate, exact_cost = viterbi_decode(make_decode_graph(graph), lp)
    exact_cost = np.asarray(exact_cost)
    exact_trace = np.asarray(trace)

    fg = FrontierGraph.from_dense(graph)
    from rhasspy_speech_tpu.graph.dense import NEG_INF_F32

    print(f"{'K':>7} {'max regret':>12} {'mean regret':>12} {'path match':>11}")
    for k in (64, 256, 1024, 4096, 7000, min(graph.num_states, 20000)):
        states_t, alphas_t, arcs_t = viterbi_topk(
            fg, lp, k, beam=24.0, min_active=200
        )
        states_np = np.asarray(states_t)
        alphas_np = np.asarray(alphas_t)
        arcs_np = np.asarray(arcs_t)
        last = states_np[-1]
        totals = np.where(
            last >= 0,
            alphas_np[-1] + graph.final_weight[np.maximum(last, 0)],
            NEG_INF_F32,
        )
        cost_k = totals.min(axis=1)
        regret = cost_k - exact_cost
        # optimal-path recovery rate: frontier cost == exact cost
        agree = float((regret <= 1e-3).mean())
        print(
            f"{k:>7} {regret.max():>12.4f} {regret.mean():>12.4f} "
            f"{agree:>10.0%}"
        )


if __name__ == "__main__":
    main()
