"""The committed flagship grammar (testing/flagship_grammar.py): its
expansion count and decode-graph sizes are pinned, it is plain data, and
the main path needs neither PyYAML nor the ``regex`` module."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from rhasspy_speech_tpu.grammar import intents_to_fst
from rhasspy_speech_tpu.testing.flagship import (
    build_flagship_graph,
    flagship_intents,
)
from rhasspy_speech_tpu.testing.flagship_grammar import FLAGSHIP_GRAMMAR

REPO = Path(__file__).resolve().parent.parent


def test_sentence_count():
    fst = intents_to_fst(flagship_intents(), number_language="en")
    fst = fst.remove_spaces()
    fst.prune()
    sentences = fst.to_strings(True)
    assert len(sentences) == 3701
    # the sentences the full-scale pipeline tests decode
    for text in ("turn on the kitchen lights", "what time is it",
                 "turn off the kitchen lights"):
        assert text in sentences


@pytest.mark.parametrize(
    "order,states,arcs", [(3, 14272, 37722), (5, 35485, 95024)]
)
def test_graph_size(order, states, arcs):
    graph, g_fuzzy, _lang = build_flagship_graph(order=order, with_fuzzy=False)
    assert g_fuzzy is None
    assert (graph.num_states, graph.num_arcs, graph.num_pdfs) == (
        states, arcs, 212
    )


def test_num_pdfs_pads_the_pdf_axis():
    graph, _g, _lang = build_flagship_graph(
        order=3, with_fuzzy=False, num_pdfs=3072
    )
    assert graph.num_pdfs == 3072


def test_grammar_is_plain_data():
    assert json.loads(json.dumps(FLAGSHIP_GRAMMAR)) == FLAGSHIP_GRAMMAR


def test_main_path_imports_without_yaml_or_regex():
    """Grammar compile, training and serving modules import and run with
    ``yaml`` and ``regex`` unimportable (only YAML *text* input needs
    PyYAML)."""
    script = f"""
import sys
sys.modules["yaml"] = None
sys.modules["regex"] = None
sys.path.insert(0, {str(REPO)!r})
import rhasspy_speech_tpu
import rhasspy_speech_tpu.pipeline.train
import rhasspy_speech_tpu.pipeline.scheduler
import rhasspy_speech_tpu.lexicon.g2p
from rhasspy_speech_tpu.grammar import Intents, intents_to_fst
from rhasspy_speech_tpu.testing.flagship import flagship_intents
fst = intents_to_fst(flagship_intents(), number_language="en")
try:
    Intents.from_yaml("language: en")
except ImportError:
    print("YAML_NEEDS_PYYAML")
"""
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "YAML_NEEDS_PYYAML" in proc.stdout
