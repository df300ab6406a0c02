"""Kaldi lattice binary I/O: round-trips + export from decode lattices."""

import io

import numpy as np

import jax.numpy as jnp

from rhasspy_speech_tpu.io.lattice_io import (
    KaldiCompactLattice,
    compact_lattice_from_decode,
    determinize_compact_lattice,
    read_lattice,
    read_lattice_ark,
    write_compact_lattice,
    write_lattice_ark,
)


def _all_paths(clat, limit=100000):
    """Enumerate (word tuple, total cost, tids) over every complete path."""
    out = []
    stack = [(clat.start, (), 0.0, ())]
    while stack:
        s, words, cost, tids = stack.pop()
        if len(out) > limit:
            raise RuntimeError("path explosion")
        f = clat.finals.get(s)
        if f is not None:
            out.append((words, cost + f[0] + f[1], tids + f[2]))
        for word, g, a, atids, ns in clat.arcs[s]:
            nwords = words + ((word,) if word != 0 else ())
            stack.append((ns, nwords, cost + g + a, tids + atids))
    return out


def _toy_lattice():
    lat = KaldiCompactLattice()
    for _ in range(4):
        lat.add_state()
    lat.start = 0
    lat.arcs[0].append((5, 1.0, 2.5, (3, 4, 5), 1))
    lat.arcs[0].append((7, 0.5, 1.5, (9,), 2))
    lat.arcs[1].append((8, 0.25, 0.0, (), 3))
    lat.arcs[2].append((8, 0.75, 0.25, (1, 2), 3))
    lat.finals[3] = (0.125, 0.25, (11,))
    return lat


def test_compact_lattice_roundtrip():
    lat = _toy_lattice()
    buf = io.BytesIO()
    write_compact_lattice(buf, lat)
    buf.seek(0)
    got = read_lattice(buf)
    assert got.start == 0 and got.num_states == 4
    assert got.arcs == lat.arcs
    assert got.finals == lat.finals


def test_lattice_ark_roundtrip(tmp_path):
    lat = _toy_lattice()
    path = tmp_path / "lat.ark"
    write_lattice_ark(path, [("utt1", lat), ("utt2", lat)])
    entries = list(read_lattice_ark(path))
    assert [k for k, _ in entries] == ["utt1", "utt2"]
    for _, got in entries:
        assert got.arcs == lat.arcs and got.finals == lat.finals


def test_plain_lattice_converts_to_compact():
    """Arc type lattice4 (ilabel=tid, olabel=word) reads as a word acceptor
    with singleton tid strings."""
    import struct

    from rhasspy_speech_tpu.io.openfst import (
        FST_MAGIC,
        _write_i32,
        _write_i64,
        _write_string,
        _write_u64,
    )

    buf = io.BytesIO()
    _write_i32(buf, FST_MAGIC)
    _write_string(buf, "vector")
    _write_string(buf, "lattice4")
    _write_i32(buf, 2)
    _write_i32(buf, 0)
    _write_u64(buf, 0)
    _write_i64(buf, 0)  # start
    _write_i64(buf, 2)  # states
    _write_i64(buf, 1)  # arcs
    INF = float("inf")
    # state 0: non-final, one arc tid=42, word=7, (g=0.5, a=1.25) -> state 1
    buf.write(struct.pack("<ff", INF, INF))
    _write_i64(buf, 1)
    _write_i32(buf, 42)
    _write_i32(buf, 7)
    buf.write(struct.pack("<ff", 0.5, 1.25))
    _write_i32(buf, 1)
    # state 1: final (0.0, 0.0), no arcs
    buf.write(struct.pack("<ff", 0.0, 0.0))
    _write_i64(buf, 0)
    buf.seek(0)
    lat = read_lattice(buf)
    assert lat.arcs[0] == [(7, 0.5, 1.25, (42,), 1)]
    assert lat.finals[1] == (0.0, 0.0, ())


def test_export_decode_lattice(tmp_path):
    """A device decode lattice exports to CompactLattice whose best path (word
    sequence + cost) matches the in-memory lattice's."""
    from rhasspy_speech_tpu.fst.core import EPS_ID
    from rhasspy_speech_tpu.fst.ops import shortest_path
    from rhasspy_speech_tpu.ops.decoder import DeviceGraph
    from rhasspy_speech_tpu.ops.lattice import build_lattice, forward_backward

    from tests.test_decoder import _random_graph

    rng = np.random.RandomState(77)
    graph = _random_graph(rng)
    dev = DeviceGraph.from_dense(graph)
    lp = np.log(rng.dirichlet(np.ones(graph.num_pdfs), size=(1, 9))).astype(
        np.float32
    )
    alphas, betas = (
        np.asarray(v) for v in forward_backward(dev, jnp.asarray(lp))
    )
    lat = build_lattice(graph, alphas, betas, lp, 0, lattice_beam=10.0)
    want_words, want_cost = lat.shortest_path_words(graph)

    clat = compact_lattice_from_decode(lat, graph)
    # binary round-trip, then best path via the generic toolbox
    buf = io.BytesIO()
    write_compact_lattice(buf, clat)
    buf.seek(0)
    clat2 = read_lattice(buf)
    best = shortest_path(clat2.to_fst(acoustic_scale=1.0), nshortest=1)
    paths = best.paths()
    assert len(paths) == 1
    ipath, _opath, weight = paths[0]
    got_words = [w for w in ipath if w != EPS_ID]
    assert got_words == [w for w in want_words if w != 0]
    np.testing.assert_allclose(weight, want_cost, rtol=1e-4)


def test_determinize_merges_duplicate_word_sequences():
    """Two paths carrying the same word sequence collapse to one, keeping
    the cheaper cost; distinct sequences survive; epsilons are removed."""
    lat = KaldiCompactLattice()
    for _ in range(5):
        lat.add_state()
    lat.start = 0
    # "5 8" twice (costs 3.75 and 1.5 total), "7 8" once, via an eps arc
    lat.arcs[0].append((5, 1.0, 2.5, (3,), 1))
    lat.arcs[0].append((0, 0.0, 0.25, (), 2))  # epsilon
    lat.arcs[2].append((5, 0.5, 0.25, (4,), 3))
    lat.arcs[0].append((7, 0.5, 1.5, (9,), 2))
    lat.arcs[1].append((8, 0.25, 0.0, (), 4))
    lat.arcs[3].append((8, 0.25, 0.0, (), 4))
    lat.arcs[2].append((8, 0.75, 0.25, (1,), 4))
    lat.finals[4] = (0.0, 0.0, ())

    pre = _all_paths(lat)
    pre_best = {}
    for words, cost, _t in pre:
        pre_best[words] = min(pre_best.get(words, float("inf")), cost)
    assert len(pre) > len(pre_best)  # genuinely ambiguous input

    det = determinize_compact_lattice(lat)
    post = _all_paths(det)
    post_words = [w for w, _c, _t in post]
    assert len(post_words) == len(set(post_words))  # unique sequences
    assert not any(
        word == 0 for arcs in det.arcs for (word, *_rest) in arcs
    )  # epsilon-free
    got = {w: c for w, c, _t in post}
    assert got.keys() == pre_best.keys()
    for w, c in pre_best.items():
        np.testing.assert_allclose(got[w], c, rtol=1e-5)


def test_determinize_exported_decode_lattice():
    """End-to-end: an ambiguous decode exports determinized by default —
    unique word sequences, best costs preserved, binary round-trip OK."""
    from rhasspy_speech_tpu.ops.decoder import DeviceGraph
    from rhasspy_speech_tpu.ops.lattice import build_lattice, forward_backward

    from tests.test_decoder import _random_graph

    rng = np.random.RandomState(78)
    graph = _random_graph(rng)
    dev = DeviceGraph.from_dense(graph)
    lp = np.log(rng.dirichlet(np.ones(graph.num_pdfs), size=(1, 9))).astype(
        np.float32
    )
    alphas, betas = (
        np.asarray(v) for v in forward_backward(dev, jnp.asarray(lp))
    )
    lat = build_lattice(graph, alphas, betas, lp, 0, lattice_beam=3.0)
    clat = compact_lattice_from_decode(lat, graph)
    pre = _all_paths(clat)
    pre_best = {}
    for words, cost, _t in pre:
        pre_best[words] = min(pre_best.get(words, float("inf")), cost)

    det = determinize_compact_lattice(clat)
    buf = io.BytesIO()
    write_compact_lattice(buf, det)
    buf.seek(0)
    det2 = read_lattice(buf)
    post = _all_paths(det2)
    post_words = [w for w, _c, _t in post]
    assert len(post_words) == len(set(post_words))
    got = {w: c for w, c, _t in post}
    assert got.keys() == pre_best.keys()
    for w, c in pre_best.items():
        np.testing.assert_allclose(got[w], c, rtol=1e-4, atol=1e-4)


def _toy_transition_model(num_phones=3):
    """1-state chain-topology transition model: phone p has transition
    state p with tids 2p-1 (self-loop) and 2p (forward = phone start
    marker: hmm-state 0, not a self-loop)."""
    from rhasspy_speech_tpu.io.transition_model import (
        KaldiHmmTopology,
        KaldiTransitionModel,
    )

    phones = list(range(1, num_phones + 1))
    topo = KaldiHmmTopology.chain(phones)
    tuples = np.zeros((num_phones, 4), dtype=np.int64)
    for i, p in enumerate(phones):
        tuples[i] = (p, 0, 2 * i, 2 * i + 1)
    log_probs = np.full(2 * num_phones + 1, np.log(0.5), dtype=np.float32)
    log_probs[0] = 0.0
    return KaldiTransitionModel(
        topology=topo, tuples=tuples, log_probs=log_probs
    )


def test_phone_pruned_determinization_merges_timing_variants():
    """DeterminizeLatticePhonePruned semantics: two alignments of the
    same phone sequence (different self-loop counts) merge in the phone
    pass, keeping the best path's transition-ids; the final lattice is
    canonical (epsilon-free, one path per word sequence, best cost, best
    alignment) and path-identical to word-level determinization."""
    from rhasspy_speech_tpu.io.lattice_io import (
        determinize_lattice_phone_pruned,
        insert_phone_labels,
    )

    tm = _toy_transition_model()
    # word 5 = phone 1 with two timings: A=(1,1,2) cost 1.0 (best),
    # B=(1,2) cost 2.0; word 7 = phone 2, shared continuation
    lat = KaldiCompactLattice()
    for _ in range(4):
        lat.add_state()
    lat.start = 0
    lat.arcs[0].append((5, 0.5, 0.5, (1, 1, 2), 1))
    lat.arcs[0].append((5, 1.0, 1.0, (1, 2), 2))
    lat.arcs[1].append((7, 0.25, 0.25, (3, 4), 3))
    lat.arcs[2].append((7, 0.25, 0.25, (3, 4), 3))
    lat.finals[3] = (0.0, 0.0, ())

    # the phone pass genuinely tags boundaries (arc counts grow), and
    # pass 1 merges the two timings of word 5's phone sequence
    tagged, fpl = insert_phone_labels(lat, tm)
    assert fpl == 8  # max word label 7 + 1
    assert tagged.num_arcs() > lat.num_arcs()
    det1 = determinize_compact_lattice(tagged)
    tagged_paths = _all_paths(tagged)
    det1_paths = _all_paths(det1)
    assert len(tagged_paths) == 2 and len(det1_paths) == 1

    det = determinize_lattice_phone_pruned(lat, tm)
    paths = _all_paths(det)
    assert len(paths) == 1
    words, cost, tids = paths[0]
    assert words == (5, 7)
    np.testing.assert_allclose(cost, 1.0 + 0.5)
    # best path's alignment survives the merge
    assert tids == (1, 1, 2, 3, 4)
    assert not any(
        word == 0 for arcs in det.arcs for (word, *_rest) in arcs
    )

    # path-identical to plain word-level determinization (the passes
    # differ in intermediate growth, not final semantics)
    det_w = determinize_compact_lattice(lat)
    assert sorted(_all_paths(det_w)) == sorted(paths)


def test_phone_pruned_skips_boundary_on_start_arcs():
    """A phone-start tid at string position 0 of an arc leaving the
    start state gets no tag (reference skips arcs out of Start(),
    determinize-lattice-pruned.cc:1313-1314)."""
    from rhasspy_speech_tpu.io.lattice_io import insert_phone_labels

    tm = _toy_transition_model()
    lat = KaldiCompactLattice()
    for _ in range(2):
        lat.add_state()
    lat.start = 0
    # forward tid 2 at position 0 out of start: skipped; the same tid at
    # position 1 of a non-start arc: tagged
    lat.arcs[0].append((5, 0.0, 0.0, (2,), 1))
    lat.finals[1] = (0.0, 0.0, ())
    tagged, _fpl = insert_phone_labels(lat, tm)
    assert tagged.num_arcs() == lat.num_arcs()

    lat.add_state()
    lat.arcs[1].append((7, 0.0, 0.0, (1, 4), 2))
    lat.finals[2] = (0.0, 0.0, ())
    del lat.finals[1]
    tagged2, _ = insert_phone_labels(lat, tm)
    assert tagged2.num_arcs() == lat.num_arcs() + 1


def test_phone_pruned_degenerates_without_alignments():
    """Decode exports carry empty tid strings: the phone pass is a no-op
    and phone-pruned output equals word-level determinization exactly."""
    from rhasspy_speech_tpu.io.lattice_io import (
        determinize_lattice_phone_pruned,
    )

    tm = _toy_transition_model()
    lat = KaldiCompactLattice()
    for _ in range(5):
        lat.add_state()
    lat.start = 0
    lat.arcs[0].append((5, 1.0, 2.5, (), 1))
    lat.arcs[0].append((0, 0.0, 0.25, (), 2))
    lat.arcs[2].append((5, 0.5, 0.25, (), 3))
    lat.arcs[0].append((7, 0.5, 1.5, (), 2))
    lat.arcs[1].append((8, 0.25, 0.0, (), 4))
    lat.arcs[3].append((8, 0.25, 0.0, (), 4))
    lat.arcs[2].append((8, 0.75, 0.25, (), 4))
    lat.finals[4] = (0.0, 0.0, ())

    det_p = determinize_lattice_phone_pruned(lat, tm)
    det_w = determinize_compact_lattice(lat)
    assert sorted(_all_paths(det_p)) == sorted(_all_paths(det_w))
