"""Dense Viterbi decoder tests vs the NumPy reference DP."""

import pytest
import numpy as np

import jax.numpy as jnp

from rhasspy_speech_tpu.graph.dense import NEG_INF_F32, DenseGraph, viterbi_numpy
from rhasspy_speech_tpu.ops.decoder import (
    DeviceGraph,
    backtrace_nbest,
    backtrace_words,
    viterbi,
    viterbi_kbest,
)


def _random_graph(rng, num_states=12, num_pdfs=6, extra_arcs=30) -> DenseGraph:
    """Random connected left-to-right-ish graph; every state final-able."""
    srcs, dsts, pdfs, weights, wseqs = [], [], [], [], []
    word_seqs = [()]
    wseq_ids = {(): 0}

    def intern(seq):
        if seq not in wseq_ids:
            wseq_ids[seq] = len(word_seqs)
            word_seqs.append(seq)
        return wseq_ids[seq]

    # chain to guarantee connectivity + self loops
    for s in range(num_states):
        nxt = (s + 1) % num_states
        srcs += [s, s]
        dsts += [nxt, s]
        pdfs += [int(rng.randint(num_pdfs)), int(rng.randint(num_pdfs))]
        weights += [float(rng.rand()), float(rng.rand())]
        wseqs += [intern((s + 1,)), intern(())]
    for _ in range(extra_arcs):
        s, d = rng.randint(num_states, size=2)
        srcs.append(int(s))
        dsts.append(int(d))
        pdfs.append(int(rng.randint(num_pdfs)))
        weights.append(float(rng.rand()))
        wseqs.append(intern((int(rng.randint(1, 50)),)))

    init = np.full(num_states, NEG_INF_F32, dtype=np.float32)
    init[0] = 0.0
    final = np.full(num_states, NEG_INF_F32, dtype=np.float32)
    final[num_states - 1] = 0.25
    final[num_states // 2] = 0.5
    return DenseGraph(
        num_states=num_states,
        arc_src=np.asarray(srcs, dtype=np.int32),
        arc_dst=np.asarray(dsts, dtype=np.int32),
        arc_pdf=np.asarray(pdfs, dtype=np.int32),
        arc_wseq=np.asarray(wseqs, dtype=np.int32),
        arc_weight=np.asarray(weights, dtype=np.float32),
        final_weight=final,
        final_wseq=np.zeros(num_states, dtype=np.int32),
        init_weight=init,
        init_wseq=np.zeros(num_states, dtype=np.int32),
        word_seqs=word_seqs,
        num_pdfs=num_pdfs,
    )


def test_viterbi_matches_numpy():
    rng = np.random.RandomState(0)
    graph = _random_graph(rng)
    dev = DeviceGraph.from_dense(graph)

    B, T = 3, 15
    log_probs = np.log(
        rng.dirichlet(np.ones(graph.num_pdfs), size=(B, T))
    ).astype(np.float32)

    alpha, bp = viterbi(dev, jnp.asarray(log_probs), acoustic_scale=0.8)
    alpha = np.asarray(alpha)
    bp = np.asarray(bp)

    for b in range(B):
        want_words, want_cost = viterbi_numpy(graph, log_probs[b], 0.8)
        got_words, got_cost = backtrace_words(graph, alpha, bp, b)
        assert got_words is not None
        np.testing.assert_allclose(got_cost, want_cost, rtol=1e-4, atol=1e-4)
        assert got_words == want_words


def test_viterbi_no_path():
    """A graph whose final states are unreachable yields None."""
    graph = _random_graph(np.random.RandomState(1), num_states=4, extra_arcs=0)
    graph.final_weight[:] = NEG_INF_F32
    dev = DeviceGraph.from_dense(graph)
    lp = np.log(np.full((1, 5, graph.num_pdfs), 1.0 / graph.num_pdfs, np.float32))
    alpha, bp = viterbi(dev, jnp.asarray(lp))
    words, cost = backtrace_words(graph, np.asarray(alpha), np.asarray(bp), 0)
    assert words is None and cost == float("inf")


def test_kbest_rank0_matches_1best():
    rng = np.random.RandomState(2)
    graph = _random_graph(rng)
    dev = DeviceGraph.from_dense(graph)
    B, T = 2, 10
    log_probs = np.log(
        rng.dirichlet(np.ones(graph.num_pdfs), size=(B, T))
    ).astype(np.float32)

    alpha1, bp1 = viterbi(dev, jnp.asarray(log_probs))
    alphak, bpk = viterbi_kbest(dev, jnp.asarray(log_probs), k=4)
    np.testing.assert_allclose(
        np.asarray(alphak)[:, :, 0], np.asarray(alpha1), rtol=1e-5, atol=1e-5
    )
    for b in range(B):
        best1 = backtrace_words(graph, np.asarray(alpha1), np.asarray(bp1), b)
        nbest = backtrace_nbest(graph, np.asarray(alphak), np.asarray(bpk), b, n=4)
        assert nbest[0][0] == best1[0]
        np.testing.assert_allclose(nbest[0][1], best1[1], rtol=1e-5, atol=1e-5)
        # costs must be sorted
        costs = [c for _, c in nbest]
        assert costs == sorted(costs)


def test_nbest_two_path_graph():
    """Two-word graph: 'a' (cheap) and 'b' (expensive); n-best ranks them."""
    #    0 --pdf0/'a'/0.0--> 1(final)
    #    0 --pdf1/'b'/1.0--> 1
    graph = DenseGraph(
        num_states=2,
        arc_src=np.array([0, 0], dtype=np.int32),
        arc_dst=np.array([1, 1], dtype=np.int32),
        arc_pdf=np.array([0, 1], dtype=np.int32),
        arc_wseq=np.array([1, 2], dtype=np.int32),
        arc_weight=np.array([0.0, 1.0], dtype=np.float32),
        final_weight=np.array([NEG_INF_F32, 0.0], dtype=np.float32),
        final_wseq=np.zeros(2, dtype=np.int32),
        init_weight=np.array([0.0, NEG_INF_F32], dtype=np.float32),
        init_wseq=np.zeros(2, dtype=np.int32),
        word_seqs=[(), (101,), (102,)],
        num_pdfs=2,
    )
    dev = DeviceGraph.from_dense(graph)
    lp = np.log(np.array([[[0.5, 0.5]]], dtype=np.float32))  # [1, 1, 2]
    alphak, bpk = viterbi_kbest(dev, jnp.asarray(lp), k=3)
    nbest = backtrace_nbest(graph, np.asarray(alphak), np.asarray(bpk), 0, n=3)
    assert [w for w, _ in nbest] == [[101], [102]]
    assert abs(nbest[1][1] - nbest[0][1] - 1.0) < 1e-5


def test_device_decoder_on_grammar_graph():
    """The device decoder decodes the real grammar-built dense graph (same setup as
    test_graph.py) with oracle posteriors, batched over two streams."""
    from tests.test_graph import LEXICON, _phone_frames
    import io as _io
    from rhasspy_speech_tpu.grammar import Intents, compile_intents
    from rhasspy_speech_tpu.graph import Topology, TransitionModel, dense_from_hclg, make_hclg
    from rhasspy_speech_tpu.lang import make_grammar_g, make_lg, prepare_lang
    from rhasspy_speech_tpu.lexicon import LexiconDatabase

    intents = Intents.from_dict(
        {"language": "en",
         "intents": {"Main": {"data": [{"sentences": ["red alert", "never mind"]}]}}}
    )
    lexicon = LexiconDatabase()
    for word, phones in LEXICON:
        lexicon.add(word, [phones])
    ctx = compile_intents(intents, _io.StringIO(), lexicon, number_language="en")
    lang = prepare_lang(LEXICON, silence_phones=["SIL", "SPN"])
    g = make_grammar_g(ctx.fst_file, lang.words)
    lg = make_lg(lang, g)
    phone_ids = sorted(
        pid for (_p, pid) in lang.phones if pid != 0 and not _p.startswith("#")
    )
    tm = TransitionModel.monophone(Topology.chain(phone_ids))
    graph = dense_from_hclg(make_hclg(lang, lg, tm), tm.num_pdfs)
    dev = DeviceGraph.from_dense(graph)

    lp_red = _phone_frames(
        lang, tm, ["SIL", "r_B", "eh_I", "d_E", "ah_B", "l_I", "er_I", "t_E", "SIL"]
    )
    lp_never = _phone_frames(
        lang, tm, ["n_B", "eh_I", "v_I", "er_E", "m_B", "ay_I", "n_I", "d_E", "SIL"]
    )
    lp = np.stack([lp_red, lp_never])  # [2, T, P]

    alpha, bp = viterbi(dev, jnp.asarray(lp))
    w0, _ = backtrace_words(graph, np.asarray(alpha), np.asarray(bp), 0)
    w1, _ = backtrace_words(graph, np.asarray(alpha), np.asarray(bp), 1)
    assert [lang.words.find_id(w) for w in w0] == ["red", "alert"]
    assert [lang.words.find_id(w) for w in w1] == ["never", "mind"]

    # n-best over the same graph: best hypothesis matches, alternatives exist
    alphak, bpk = viterbi_kbest(dev, jnp.asarray(lp), k=4)
    nbest = backtrace_nbest(graph, np.asarray(alphak), np.asarray(bpk), 0, n=4)
    assert [lang.words.find_id(w) for w in nbest[0][0]] == ["red", "alert"]


def test_viterbi_lengths_masking():
    """Padded frames past a stream's length must not change its result."""
    rng = np.random.RandomState(7)
    graph = _random_graph(rng)
    dev = DeviceGraph.from_dense(graph)
    T_real, T_pad = 9, 15
    lp_real = np.log(rng.dirichlet(np.ones(graph.num_pdfs), size=(1, T_real))).astype(
        np.float32
    )
    lp_pad = np.concatenate(
        [lp_real, np.zeros((1, T_pad - T_real, graph.num_pdfs), np.float32)], axis=1
    )

    a1, b1 = viterbi(dev, jnp.asarray(lp_real))
    w1, c1 = backtrace_words(graph, np.asarray(a1), np.asarray(b1), 0)

    a2, b2 = viterbi(dev, jnp.asarray(lp_pad), lengths=jnp.asarray([T_real]))
    w2, c2 = backtrace_words(graph, np.asarray(a2), np.asarray(b2), 0)
    assert w1 == w2
    np.testing.assert_allclose(c1, c2, rtol=1e-5)

    ak1, bk1 = viterbi_kbest(dev, jnp.asarray(lp_real), k=3)
    ak2, bk2 = viterbi_kbest(
        dev, jnp.asarray(lp_pad), k=3, lengths=jnp.asarray([T_real])
    )
    n1 = backtrace_nbest(graph, np.asarray(ak1), np.asarray(bk1), 0, n=3)
    n2 = backtrace_nbest(graph, np.asarray(ak2), np.asarray(bk2), 0, n=3)
    assert [w for w, _ in n1] == [w for w, _ in n2]


def test_device_backtrace_matches_host():
    from rhasspy_speech_tpu.ops.decoder import trace_to_words, viterbi_decode

    rng = np.random.RandomState(11)
    graph = _random_graph(rng)
    dev = DeviceGraph.from_dense(graph)
    B, T_real, T_pad = 3, 12, 16
    lp = np.log(rng.dirichlet(np.ones(graph.num_pdfs), size=(B, T_pad))).astype(
        np.float32
    )
    lengths = jnp.asarray([T_real, T_pad, T_real - 2])

    alpha, bp = viterbi(dev, jnp.asarray(lp), lengths=lengths)
    trace, fstate, cost = viterbi_decode(dev, jnp.asarray(lp), lengths=lengths)
    trace, fstate, cost = map(np.asarray, (trace, fstate, cost))
    for b in range(B):
        want = backtrace_words(graph, np.asarray(alpha), np.asarray(bp), b)
        got = trace_to_words(graph, trace, fstate, cost, b)
        assert got[0] == want[0], b
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5)


def test_traces_to_words_batch_matches_single():
    from rhasspy_speech_tpu.ops.decoder import (
        trace_to_words,
        traces_to_words_batch,
        viterbi_decode,
    )

    rng = np.random.RandomState(21)
    graph = _random_graph(rng)
    dev = DeviceGraph.from_dense(graph)
    B, T = 4, 14
    lp = np.log(rng.dirichlet(np.ones(graph.num_pdfs), size=(B, T))).astype(
        np.float32
    )
    trace, fstate, cost = map(
        np.asarray, viterbi_decode(dev, jnp.asarray(lp))
    )
    batch = traces_to_words_batch(graph, trace, fstate, cost)
    for b in range(B):
        single = trace_to_words(graph, trace, fstate, cost, b)
        assert batch[b][0] == single[0]
        np.testing.assert_allclose(batch[b][1], single[1], rtol=1e-6)


def test_kbest_device_backtrace_matches_host():
    from rhasspy_speech_tpu.ops.decoder import (
        kbest_traces_to_nbest,
        viterbi_kbest_decode,
    )

    rng = np.random.RandomState(23)
    graph = _random_graph(rng)
    dev = DeviceGraph.from_dense(graph)
    B, T, K = 2, 12, 4
    lp = np.log(rng.dirichlet(np.ones(graph.num_pdfs), size=(B, T))).astype(
        np.float32
    )

    alphak, bpk = viterbi_kbest(dev, jnp.asarray(lp), k=K)
    traces, seeds, costs = map(
        np.asarray, viterbi_kbest_decode(dev, jnp.asarray(lp), k=K)
    )
    for b in range(B):
        want = backtrace_nbest(graph, np.asarray(alphak), np.asarray(bpk), b, n=K)
        got = kbest_traces_to_nbest(graph, traces, seeds, costs, b, n=K)
        assert [w for w, _ in got] == [w for w, _ in want], b
        np.testing.assert_allclose(
            [c for _, c in got], [c for _, c in want], rtol=1e-5
        )


def test_padded_graph_matches_scatter():
    from rhasspy_speech_tpu.ops.decoder import (
        PaddedDeviceGraph,
        trace_to_words,
        viterbi_decode,
    )

    rng = np.random.RandomState(31)
    graph = _random_graph(rng, num_states=20, extra_arcs=80)
    dev = DeviceGraph.from_dense(graph)
    pad = PaddedDeviceGraph.from_dense(graph)
    B, T = 3, 12
    lp = np.log(rng.dirichlet(np.ones(graph.num_pdfs), size=(B, T))).astype(
        np.float32
    )
    lengths = jnp.asarray([T, T - 3, T])

    r1 = viterbi_decode(dev, jnp.asarray(lp), lengths=lengths)
    r2 = viterbi_decode(pad, jnp.asarray(lp), lengths=lengths)
    a1 = [np.asarray(x) for x in r1]
    a2 = [np.asarray(x) for x in r2]
    np.testing.assert_allclose(a1[2], a2[2], rtol=1e-5)  # costs
    for b in range(B):
        w1 = trace_to_words(graph, a1[0], a1[1], a1[2], b)
        w2 = trace_to_words(graph, a2[0], a2[1], a2[2], b)
        assert w1[0] == w2[0], b


def test_padded_graph_hub_states():
    """A graph with one huge-in-degree hub still decodes exactly."""
    from rhasspy_speech_tpu.ops.decoder import PaddedDeviceGraph, viterbi_decode, trace_to_words

    rng = np.random.RandomState(32)
    graph = _random_graph(rng, num_states=10, extra_arcs=0)
    # add 30 arcs all into state 0 (hub)
    extra_src = rng.randint(10, size=30)
    graph.arc_src = np.concatenate([graph.arc_src, extra_src.astype(np.int32)])
    graph.arc_dst = np.concatenate([graph.arc_dst, np.zeros(30, np.int32)])
    graph.arc_pdf = np.concatenate(
        [graph.arc_pdf, rng.randint(graph.num_pdfs, size=30).astype(np.int32)]
    )
    graph.arc_weight = np.concatenate(
        [graph.arc_weight, rng.rand(30).astype(np.float32)]
    )
    graph.arc_wseq = np.concatenate([graph.arc_wseq, np.zeros(30, np.int32)])

    pad = PaddedDeviceGraph.from_dense(graph, width=4)
    assert pad.hub_states.shape[0] >= 1
    dev = DeviceGraph.from_dense(graph)
    lp = np.log(
        np.random.RandomState(33).dirichlet(
            np.ones(graph.num_pdfs), size=(1, 8)
        )
    ).astype(np.float32)
    r1 = [np.asarray(x) for x in viterbi_decode(dev, jnp.asarray(lp))]
    r2 = [np.asarray(x) for x in viterbi_decode(pad, jnp.asarray(lp))]
    np.testing.assert_allclose(r1[2], r2[2], rtol=1e-5)
    assert trace_to_words(graph, *r1, 0)[0] == trace_to_words(graph, *r2, 0)[0]


def test_hybrid_graph_matches_scatter_exactly():
    """Width-2 slots + scatter spill reproduce the scatter kernel bit-exact.

    The hybrid layout fills slots in stable dst-sorted arc order, so the
    min-arc-id tie-break must coincide with viterbi_step's — the whole arc
    trace (not just costs) must match."""
    from rhasspy_speech_tpu.ops.decoder import (
        HybridDeviceGraph,
        trace_to_words,
        viterbi_decode,
    )

    rng = np.random.RandomState(51)
    graph = _random_graph(rng, num_states=20, extra_arcs=80)
    dev = DeviceGraph.from_dense(graph)
    hyb = HybridDeviceGraph.from_dense(graph)
    assert hyb.spill_src.shape[0] > 0  # exercise the spill path
    B, T = 3, 12
    lp = np.log(rng.dirichlet(np.ones(graph.num_pdfs), size=(B, T))).astype(
        np.float32
    )
    lengths = jnp.asarray([T, T - 3, T])

    r1 = [np.asarray(x) for x in viterbi_decode(dev, jnp.asarray(lp), lengths=lengths)]
    r2 = [np.asarray(x) for x in viterbi_decode(hyb, jnp.asarray(lp), lengths=lengths)]
    np.testing.assert_array_equal(r1[0], r2[0])  # arc traces bit-exact
    np.testing.assert_array_equal(r1[1], r2[1])
    np.testing.assert_allclose(r1[2], r2[2], rtol=1e-5)
    for b in range(B):
        assert (
            trace_to_words(graph, *r1, b)[0] == trace_to_words(graph, *r2, b)[0]
        ), b


def test_hybrid_graph_hub_states():
    """A huge-in-degree hub (all spill) decodes exactly on the hybrid path."""
    from rhasspy_speech_tpu.ops.decoder import (
        HybridDeviceGraph,
        trace_to_words,
        viterbi_decode,
    )

    rng = np.random.RandomState(52)
    graph = _random_graph(rng, num_states=10, extra_arcs=0)
    extra_src = rng.randint(10, size=30)
    graph.arc_src = np.concatenate([graph.arc_src, extra_src.astype(np.int32)])
    graph.arc_dst = np.concatenate([graph.arc_dst, np.zeros(30, np.int32)])
    graph.arc_pdf = np.concatenate(
        [graph.arc_pdf, rng.randint(graph.num_pdfs, size=30).astype(np.int32)]
    )
    graph.arc_weight = np.concatenate(
        [graph.arc_weight, rng.rand(30).astype(np.float32)]
    )
    graph.arc_wseq = np.concatenate([graph.arc_wseq, np.zeros(30, np.int32)])

    hyb = HybridDeviceGraph.from_dense(graph, width=2)
    dev = DeviceGraph.from_dense(graph)
    lp = np.log(
        np.random.RandomState(53).dirichlet(
            np.ones(graph.num_pdfs), size=(1, 8)
        )
    ).astype(np.float32)
    r1 = [np.asarray(x) for x in viterbi_decode(dev, jnp.asarray(lp))]
    r2 = [np.asarray(x) for x in viterbi_decode(hyb, jnp.asarray(lp))]
    np.testing.assert_array_equal(r1[0], r2[0])
    np.testing.assert_allclose(r1[2], r2[2], rtol=1e-5)
    assert trace_to_words(graph, *r1, 0)[0] == trace_to_words(graph, *r2, 0)[0]


def test_hybrid_graph_no_spill():
    """A pure left-to-right chain (in-degree <= 2 everywhere) has an empty
    spill and still traces the n_spill==0 branch correctly."""
    from rhasspy_speech_tpu.ops.decoder import HybridDeviceGraph, viterbi_decode

    rng = np.random.RandomState(54)
    graph = _random_graph(rng, num_states=12, extra_arcs=0)
    hyb = HybridDeviceGraph.from_dense(graph, width=4)
    assert hyb.spill_src.shape[0] == 0
    dev = DeviceGraph.from_dense(graph)
    lp = np.log(rng.dirichlet(np.ones(graph.num_pdfs), size=(2, 9))).astype(
        np.float32
    )
    r1 = [np.asarray(x) for x in viterbi_decode(dev, jnp.asarray(lp))]
    r2 = [np.asarray(x) for x in viterbi_decode(hyb, jnp.asarray(lp))]
    np.testing.assert_array_equal(r1[0], r2[0])
    np.testing.assert_allclose(r1[2], r2[2], rtol=1e-5)


def test_checkpointed_decode_matches_plain():
    from rhasspy_speech_tpu.ops.decoder import (
        trace_to_words,
        viterbi_decode,
        viterbi_decode_checkpointed,
    )

    rng = np.random.RandomState(41)
    graph = _random_graph(rng)
    dev = DeviceGraph.from_dense(graph)
    B, T = 3, 23  # not a multiple of the segment size
    lp = np.log(rng.dirichlet(np.ones(graph.num_pdfs), size=(B, T))).astype(
        np.float32
    )

    plain = [np.asarray(v) for v in viterbi_decode(dev, jnp.asarray(lp))]
    ckpt = viterbi_decode_checkpointed(dev, jnp.asarray(lp), segment=8)

    np.testing.assert_allclose(plain[2], ckpt[2], rtol=1e-5)
    np.testing.assert_array_equal(plain[1], ckpt[1])
    for b in range(B):
        w1 = trace_to_words(graph, plain[0], plain[1], plain[2], b)
        w2 = trace_to_words(graph, ckpt[0], ckpt[1], ckpt[2], b)
        assert w1[0] == w2[0], b


def test_compact_backpointers_encode_exactly():
    """viterbi(compact_bp=True) stores uint16 arc+2 codes that decode to
    the int32 backpointers bit-exactly (STAY/-1 sentinels included)."""
    from rhasspy_speech_tpu.ops.decoder import viterbi

    rng = np.random.RandomState(60)
    graph = _random_graph(rng, num_states=15, extra_arcs=40)
    dev = DeviceGraph.from_dense(graph)
    B, T = 2, 9
    lp = np.log(rng.dirichlet(np.ones(graph.num_pdfs), size=(B, T))).astype(
        np.float32
    )
    lengths = jnp.asarray([T, T - 4])
    a1, bp1 = viterbi(dev, jnp.asarray(lp), lengths=lengths)
    a2, bp2 = viterbi(dev, jnp.asarray(lp), lengths=lengths, compact_bp=True)
    assert np.asarray(bp2).dtype == np.uint16
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), rtol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(bp1), np.asarray(bp2).astype(np.int32) - 2
    )


def test_compact_backpointers_reject_big_graphs():
    from rhasspy_speech_tpu.ops.decoder import _COMPACT_BP_MAX_ARC, viterbi

    rng = np.random.RandomState(61)
    graph = _random_graph(rng, num_states=8, extra_arcs=0)
    dev = DeviceGraph.from_dense(graph)
    import unittest.mock as mock

    lp = np.zeros((1, 3, graph.num_pdfs), np.float32)
    with mock.patch(
        "rhasspy_speech_tpu.ops.decoder._COMPACT_BP_MAX_ARC", 2
    ):
        with pytest.raises(ValueError):
            viterbi(dev, jnp.asarray(lp), compact_bp=True)


def test_selfloop_layout_matches_scatter_exactly():
    """The production self-loop-lane layout reproduces the scatter kernel
    bit-exact (arc traces, not just costs), including states without
    self-loops, duplicate self-loops, and a crafted equal-cost tie whose
    winner must be the min arc id."""
    from rhasspy_speech_tpu.ops.decoder import (
        SelfLoopHybridGraph,
        trace_to_words,
        viterbi_decode,
    )

    rng = np.random.RandomState(61)
    graph = _random_graph(rng, num_states=18, extra_arcs=60)
    # state 3: strip its self-loop (exercise the no-self-loop lane)
    keep = ~((graph.arc_src == 3) & (graph.arc_dst == 3))
    for f in ("arc_src", "arc_dst", "arc_pdf", "arc_weight", "arc_wseq"):
        setattr(graph, f, getattr(graph, f)[keep])
    # state 5: duplicate self-loop (the extra one must spill)
    # and a crafted exact tie into state 6: two arcs with identical
    # weight+pdf from the same src
    add = dict(
        arc_src=[5, 4, 4],
        arc_dst=[5, 6, 6],
        arc_pdf=[1, 2, 2],
        arc_weight=[0.25, 0.5, 0.5],
        arc_wseq=[0, 0, 0],
    )
    for f, vals in add.items():
        dt = getattr(graph, f).dtype
        setattr(
            graph, f, np.concatenate([getattr(graph, f), np.asarray(vals, dt)])
        )

    dev = DeviceGraph.from_dense(graph)
    slh = SelfLoopHybridGraph.from_dense(graph)
    assert int(np.asarray(slh.self_arc[3])) == -1
    assert slh.spill_src.shape[0] > 0

    B, T = 3, 11
    lp = np.log(rng.dirichlet(np.ones(graph.num_pdfs), size=(B, T))).astype(
        np.float32
    )
    lengths = jnp.asarray([T, T - 4, T])
    r1 = [np.asarray(x) for x in viterbi_decode(dev, jnp.asarray(lp), lengths=lengths)]
    r2 = [np.asarray(x) for x in viterbi_decode(slh, jnp.asarray(lp), lengths=lengths)]
    np.testing.assert_array_equal(r1[0], r2[0])
    np.testing.assert_array_equal(r1[1], r2[1])
    np.testing.assert_allclose(r1[2], r2[2], rtol=1e-5)
    for b in range(B):
        assert (
            trace_to_words(graph, *r1, b)[0] == trace_to_words(graph, *r2, b)[0]
        ), b


def _make_src_pdf_graph(rng, num_states=16, extra_arcs=50) -> DenseGraph:
    """Random graph whose arc pdfs are a function of the SOURCE state —
    the Kaldi HMM property (transition-model.h: every transition out of an
    HMM state carries the state's pdf) that enables the decode step's
    pdf-per-source am fold."""
    graph = _random_graph(rng, num_states=num_states, extra_arcs=extra_arcs)
    state_pdf = rng.randint(graph.num_pdfs, size=num_states).astype(np.int32)
    graph.arc_pdf = state_pdf[graph.arc_src]
    return graph


def _hubby_graph(rng, num_states=40, width=2):
    """src-pdf-folded graph with genuine hub states (in-degree far above
    any slot width) — shared fixture for the hub-handling paths of the
    alternative decode implementations (alpha decode, a fused kernel)."""
    g = _make_src_pdf_graph(rng, num_states=num_states, extra_arcs=60)
    hub_arcs = []
    for hub in (num_states - 1, num_states // 2):
        for s in range(0, num_states, 2):
            hub_arcs.append((s, hub))
    state_pdf = np.zeros(num_states, np.int32)
    state_pdf[g.arc_src] = g.arc_pdf
    add_src = np.asarray([a[0] for a in hub_arcs], np.int32)
    add_dst = np.asarray([a[1] for a in hub_arcs], np.int32)
    g.arc_src = np.concatenate([g.arc_src, add_src])
    g.arc_dst = np.concatenate([g.arc_dst, add_dst])
    g.arc_pdf = np.concatenate([g.arc_pdf, state_pdf[add_src]])
    g.arc_weight = np.concatenate(
        [g.arc_weight, rng.rand(len(hub_arcs)).astype(np.float32)]
    )
    g.arc_wseq = np.concatenate(
        [g.arc_wseq, np.zeros(len(hub_arcs), np.int32)]
    )
    return g


def test_src_pdf_fold_detection():
    from rhasspy_speech_tpu.ops.decoder import _state_pdf

    rng = np.random.RandomState(70)
    folded = _make_src_pdf_graph(rng)
    sp = _state_pdf(folded)
    assert sp is not None
    np.testing.assert_array_equal(sp[folded.arc_src], folded.arc_pdf)
    dev = DeviceGraph.from_dense(folded)
    assert dev.src_pdf is not None

    # conflicting pdfs out of one state -> fold disabled
    conflicted = _make_src_pdf_graph(rng)
    conflicted.arc_pdf = conflicted.arc_pdf.copy()
    conflicted.arc_pdf[0] = (conflicted.arc_pdf[0] + 1) % conflicted.num_pdfs
    conflicted.arc_pdf[1] = (conflicted.arc_pdf[0] + 1) % conflicted.num_pdfs
    # ensure arcs 0 and 1 share a src so the conflict is real
    conflicted.arc_src[1] = conflicted.arc_src[0]
    assert _state_pdf(conflicted) is None
    assert DeviceGraph.from_dense(conflicted).src_pdf is None


def test_src_pdf_fold_all_layouts_match():
    """With the pdf-per-source fold active, every decode layout matches the
    scatter kernel bit-exact AND the NumPy reference DP's transcripts; the
    folded scatter matches an unfolded decode within f32 reassociation
    tolerance (the fold computes (alpha+am)+w instead of (alpha+w)+am)."""
    from dataclasses import replace

    from rhasspy_speech_tpu.graph.dense import viterbi_numpy
    from rhasspy_speech_tpu.ops.decoder import (
        HybridDeviceGraph,
        PaddedDeviceGraph,
        SelfLoopHybridGraph,
        trace_to_words,
        viterbi_decode,
        viterbi_kbest,
        backtrace_nbest,
    )

    rng = np.random.RandomState(71)
    graph = _make_src_pdf_graph(rng, num_states=20, extra_arcs=70)
    dev = DeviceGraph.from_dense(graph)
    assert dev.src_pdf is not None
    layouts = [
        HybridDeviceGraph.from_dense(graph),
        SelfLoopHybridGraph.from_dense(graph),
        PaddedDeviceGraph.from_dense(graph, width=4),
    ]
    for lay in layouts:
        assert lay.base.src_pdf is not None

    B, T = 3, 13
    lp = np.log(rng.dirichlet(np.ones(graph.num_pdfs), size=(B, T))).astype(
        np.float32
    )
    lengths = jnp.asarray([T, T - 5, T])
    ref = [
        np.asarray(x)
        for x in viterbi_decode(dev, jnp.asarray(lp), lengths=lengths)
    ]
    for lay in layouts:
        got = [
            np.asarray(x)
            for x in viterbi_decode(lay, jnp.asarray(lp), lengths=lengths)
        ]
        np.testing.assert_array_equal(ref[0], got[0])  # arc traces
        np.testing.assert_array_equal(ref[1], got[1])
        np.testing.assert_allclose(ref[2], got[2], rtol=1e-5)

    # unfolded scatter (src_pdf stripped) agrees up to reassociation
    unfolded = replace(dev, src_pdf=None)
    base = [
        np.asarray(x)
        for x in viterbi_decode(unfolded, jnp.asarray(lp), lengths=lengths)
    ]
    np.testing.assert_allclose(ref[2], base[2], rtol=1e-5)
    for b in range(B):
        words = trace_to_words(graph, *ref, b)[0]
        assert words == trace_to_words(graph, *base, b)[0], b
        # and the NumPy reference DP agrees on the transcript
        np_words, _np_cost = viterbi_numpy(graph, lp[b][: int(lengths[b])])
        assert words == np_words, b

    # k-best path: folded kbest_step matches the unfolded one
    a1, bp1 = viterbi_kbest(dev, jnp.asarray(lp), k=3)
    a2, bp2 = viterbi_kbest(unfolded, jnp.asarray(lp), k=3)
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), rtol=1e-5)
    n1 = backtrace_nbest(graph, np.asarray(a1), np.asarray(bp1), 0, 3)
    n2 = backtrace_nbest(graph, np.asarray(a2), np.asarray(bp2), 0, 3)
    assert [w for w, _ in n1] == [w for w, _ in n2]
