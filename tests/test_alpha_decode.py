"""Alpha-storing decode (no forward arc tracking) vs the bp decode.

viterbi_decode_alpha must return bit-identical (arc_trace, final_state,
total_cost) to the backpointer implementation: candidates recompute with
the same f32 expressions and argmin's first-occurrence rule reproduces the
min-arc-id tie-break.
"""

import os
from unittest import mock

import numpy as np
import pytest

import jax.numpy as jnp

from rhasspy_speech_tpu.ops.decoder import (
    DeviceGraph,
    HybridDeviceGraph,
    SelfLoopHybridGraph,
    _alpha_tables,
    make_decode_graph,
    viterbi_decode,
    viterbi_decode_alpha,
)

from test_decoder import _hubby_graph, _make_src_pdf_graph, _random_graph


def _bp_decode(graph, lp, scale, lengths):
    with mock.patch.dict(os.environ, {"RSTPU_DECODE_IMPL": "bp"}):
        return viterbi_decode(graph, lp, scale, lengths=lengths)


def _check(dense, layout, B=8, T=11, lengths=None, seed=0):
    rng = np.random.RandomState(seed + 41)
    lp = jnp.asarray(rng.randn(B, T, dense.num_pdfs).astype(np.float32))
    lens = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    ref = _bp_decode(layout, lp, 0.7, lens)
    got = viterbi_decode_alpha(layout, lp, 0.7, lengths=lens)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(g))


def test_selfloop_layout_bit_exact():
    rng = np.random.RandomState(3)
    dense = _make_src_pdf_graph(rng, num_states=21, extra_arcs=60)
    _check(dense, make_decode_graph(dense), seed=1)


def test_hub_graph_bit_exact():
    rng = np.random.RandomState(5)
    dense = _hubby_graph(rng, num_states=33)
    layout = make_decode_graph(dense)
    assert isinstance(layout, SelfLoopHybridGraph)
    _check(dense, layout, seed=2)


def test_unfolded_hybrid_layout_bit_exact():
    rng = np.random.RandomState(7)
    dense = _random_graph(rng, num_states=17, extra_arcs=40)
    layout = make_decode_graph(dense)
    if not isinstance(layout, HybridDeviceGraph):
        layout = HybridDeviceGraph.from_dense(dense)
    assert layout.base.src_pdf is None  # per-arc pdf path
    _check(dense, layout, seed=3)


def test_scatter_layout_bit_exact():
    rng = np.random.RandomState(11)
    dense = _make_src_pdf_graph(rng, num_states=14, extra_arcs=30)
    _check(dense, DeviceGraph.from_dense(dense), seed=4)


def test_lengths_masking_bit_exact():
    rng = np.random.RandomState(13)
    dense = _hubby_graph(rng, num_states=25)
    lengths = [11, 0, 5, 8, 1, 11, 3, 6]
    _check(dense, make_decode_graph(dense), lengths=lengths, seed=5)


def test_tie_break_bit_exact():
    rng = np.random.RandomState(17)
    dense = _make_src_pdf_graph(rng, num_states=12, extra_arcs=20)
    dense.arc_src = np.concatenate([dense.arc_src, dense.arc_src[:10]])
    dense.arc_dst = np.concatenate([dense.arc_dst, dense.arc_dst[:10]])
    dense.arc_pdf = np.concatenate([dense.arc_pdf, dense.arc_pdf[:10]])
    dense.arc_weight = np.concatenate(
        [dense.arc_weight, dense.arc_weight[:10]]
    )
    dense.arc_wseq = np.concatenate([dense.arc_wseq, dense.arc_wseq[:10]])
    _check(dense, make_decode_graph(dense), seed=6)


def test_onehot_fold_used_and_exact():
    """RSTPU_ONEHOT=1 activates the one-hot am fold; outputs stay
    bit-identical to the gather path (opt-in: on the flagship graph the
    fold is a perf wash but a 9x compile-time hit)."""
    rng = np.random.RandomState(19)
    dense = _make_src_pdf_graph(rng, num_states=20, extra_arcs=50)
    layout = make_decode_graph(dense)
    from rhasspy_speech_tpu.ops.decoder import _onehot_tables

    sel, onehot = _onehot_tables(layout)
    assert onehot is not None  # small pdf set -> table built
    with mock.patch.dict(os.environ, {"RSTPU_ONEHOT": "1"}):
        _check(dense, layout, seed=7)


def test_default_dispatch_is_bp():
    """viterbi_decode's default impl is the bp path (alpha is opt-in via
    RSTPU_DECODE_IMPL=alpha; its random-gather backtrace offsets the forward)."""
    rng = np.random.RandomState(23)
    dense = _make_src_pdf_graph(rng, num_states=15, extra_arcs=30)
    layout = make_decode_graph(dense)
    lp = jnp.asarray(rng.randn(8, 7, dense.num_pdfs).astype(np.float32))
    lens = jnp.asarray([7, 3, 5, 7, 1, 6, 2, 4], jnp.int32)
    env = dict(os.environ)
    env.pop("RSTPU_DECODE_IMPL", None)
    with mock.patch.dict(os.environ, env, clear=True):
        got = viterbi_decode(layout, lp, 0.7, lengths=lens)
    want = _bp_decode(layout, lp, 0.7, lens)
    alt = viterbi_decode_alpha(layout, lp, 0.7, lengths=lens)
    for r, g, a in zip(want, got, alt):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(g))
        np.testing.assert_array_equal(np.asarray(r), np.asarray(a))

    # the opt-in env reroutes to the alpha impl
    with mock.patch.dict(os.environ, {"RSTPU_DECODE_IMPL": "alpha"}):
        got_alpha = viterbi_decode(layout, lp, 0.7, lengths=lens)
    for r, g in zip(want, got_alpha):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(g))
