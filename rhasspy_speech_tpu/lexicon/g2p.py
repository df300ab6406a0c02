"""Lexicon database and grapheme→phoneme helpers.

Same capabilities as the reference's g2p layer
(/root/reference/rhasspy_speech/g2p.py:23-290): a SQLite-backed pronunciation
lexicon (tables ``word_phonemes(word, phonemes, pron_order)`` and
``g2p_alignments(word, alignment)``) with case-variation lookup and an
in-memory overlay, plus "sounds like" pronunciation synthesis from word
references, literal ``/phoneme/`` strings, and ``[part]ial`` word segments via
stored g2p alignments. Pronunciation *guessing* for unknown words is served by
our own FST shortest-path G2P decoder (lexicon/guess.py) instead of a
Phonetisaurus subprocess.
"""

from __future__ import annotations

import itertools
import re
import sqlite3
import unicodedata
from collections.abc import Iterable
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

_SOUNDS_LIKE_PARTIAL = re.compile(r"^([^[]*)\[([^]]+)].*$")
_NUMBER_SPLIT = re.compile(r"(\d+(?:\.\d+)?)")
_NUMBER = re.compile(r"^\d+(\.\d+)?$")


class LexiconDatabase:
    """Pronunciation lexicon over SQLite with an in-memory overlay cache."""

    def __init__(self, db_path: Optional[Union[str, Path]] = None) -> None:
        self.db_path = Path(db_path) if db_path else None
        self._conn = sqlite3.Connection(str(self.db_path)) if self.db_path else None
        self._cache: Dict[str, Optional[List[List[str]]]] = {}

    def add(self, word: str, pronunciations: List[List[str]]) -> None:
        cached = self._cache.get(word)
        if cached is None:
            self._cache[word] = pronunciations
        else:
            cached.extend(pronunciations)

    def exists(self, word: str) -> bool:
        if (not self._cache) and (self._conn is not None):
            # Preload the word list as placeholders for fast membership checks
            for row in self._conn.execute("SELECT DISTINCT word FROM word_phonemes"):
                self._cache[row[0]] = None

        return any(variant in self._cache for variant in self._word_variations(word))

    def lookup(self, word: str) -> List[List[str]]:
        variants = list(self._word_variations(word))
        for variant in variants:
            cached = self._cache.get(variant)
            if cached is not None:
                return cached

        if self._conn is None:
            return []

        prons: List[List[str]] = []
        for variant in variants:
            rows = self._conn.execute(
                "SELECT phonemes FROM word_phonemes WHERE word = ? ORDER by pron_order",
                (variant,),
            )
            prons.extend(row[0].split() for row in rows)
            if prons:
                # First matching variation wins
                self._cache[variant] = prons
                break

        self._cache[word] = prons
        return prons

    def alignments(self, word: str) -> List[str]:
        if self._conn is None:
            return []

        for variant in self._word_variations(word):
            rows = self._conn.execute(
                "SELECT alignment FROM g2p_alignments WHERE word = ?", (variant,)
            )
            found = [row[0] for row in rows]
            if found:
                return found

        return []

    @staticmethod
    def _word_variations(word: str) -> Iterable[str]:
        yield word
        word_lower = word.lower()
        if word_lower != word:
            yield word_lower
        word_casefold = word.casefold()
        if word_casefold != word_lower:
            yield word_casefold
        word_upper = word.upper()
        if word_upper != word:
            yield word_upper


# ---------------------------------------------------------------------------


SplitWord = Union[str, Tuple[str, Optional[str]]]


def split_words(
    text: str, lexicon: LexiconDatabase, number_engine=None
) -> List[SplitWord]:
    """Split template text into speakable words for the lexicon.

    Unknown tokens get digit/letter expansion: ``abc123`` → ``abc 123``,
    ``NASA``/``A.B.C.`` → letters, numbers → words (tagged with the original
    digit string as the output label; capability of reference g2p.py:116-153).
    """
    words: List[SplitWord] = []
    for token in text.split():
        if lexicon.exists(token):
            words.append(token)
        else:
            # Separate digit runs from letter runs, then expand each run.
            for run in _NUMBER_SPLIT.split(token):
                if run:
                    words.extend(_expand_run(run, lexicon, number_engine))
    return words


def _is_initialism(run: str) -> bool:
    """Two or more uppercase letters ("NASA"), or two or more letter-dot
    pairs ("n.a.s.a."): the Unicode classes Lu and L of the reference's
    regexes (g2p.py: ``^(?:\\p{Lu}){2,}$`` / ``^(?:\\p{L}\\.){2,}$``)."""
    if len(run) >= 2 and all(unicodedata.category(c) == "Lu" for c in run):
        return True
    return (
        len(run) >= 4
        and len(run) % 2 == 0
        and all(c.isalpha() for c in run[0::2])
        and all(c == "." for c in run[1::2])
    )


def _expand_run(
    run: str, lexicon: LexiconDatabase, number_engine
) -> List[SplitWord]:
    """Expand one homogeneous run of a token into speakable words."""
    if lexicon.exists(run):
        return [run]

    if _is_initialism(run):
        return [char for char in run if char != "."]

    if number_engine is not None and _NUMBER.match(run):
        spoken = number_engine.format_number(run).text.replace("-", " ").split()
        # The first spoken word carries the digits as its output label.
        return [
            (word, run if idx == 0 else None) for idx, word in enumerate(spoken)
        ]

    return [run]  # pronunciation guessed later


# ---------------------------------------------------------------------------


def _phoneme_spans(tokens: Iterable[str]):
    """Group "sounds like" tokens into ``("phones", [...])`` literal spans
    (``/P1 P2/`` syntax) and plain ``("word", token)`` items."""
    span: Optional[List[str]] = None
    for token in tokens:
        if token.startswith("/"):
            token = token[1:]
            span = []

        closes = token.endswith("/")
        if closes:
            token = token[:-1]

        if span is None:
            yield ("word", token)
            continue

        span.append(token)
        if closes:
            if span:
                yield ("phones", span)
            span = None
    # An unterminated /span is silently dropped, like the reference.


def get_sounds_like(
    sounds_like: Iterable[str], lexicon: LexiconDatabase
) -> List[List[str]]:
    """Build pronunciations from a "sounds like" description.

    Tokens may be known words, ``/P1 P2/`` literal phoneme strings, or
    ``[seg]ment`` partial-word references resolved via g2p alignments.
    Returns the cartesian product of all alternatives
    (capability of reference g2p.py:159-225).
    """
    alternatives: List[List[List[str]]] = []

    for kind, item in _phoneme_spans(sounds_like):
        if kind == "phones":
            alternatives.append([list(item)])
            continue

        partial = _SOUNDS_LIKE_PARTIAL.match(item)
        if partial:
            word = item.replace("[", "").replace("]", "")
            alternatives.append(
                list(
                    get_aligned_phonemes(
                        lexicon, word, partial.group(1), partial.group(2)
                    )
                )
            )
        else:
            alternatives.append(lexicon.lookup(item))

    return [
        list(itertools.chain(*combo)) for combo in itertools.product(*alternatives)
    ]


def _parse_alignment(alignment: str) -> List[Tuple[List[str], List[str]]]:
    """Parse one g2p joint-model alignment string into (graphemes, phonemes)
    pairs: ``t}t e}..`` with ``|`` separating multi-tokens and ``_`` marking
    an empty output."""
    pairs: List[Tuple[List[str], List[str]]] = []
    for chunk in alignment.split():
        graph_part, phone_part = chunk.split("}")
        pairs.append(
            (
                graph_part.split("|"),
                [] if phone_part == "_" else phone_part.split("|"),
            )
        )
    return pairs


def _segment_phonemes(
    pairs: List[Tuple[List[str], List[str]]], prefix: str, body: str
) -> Optional[List[str]]:
    """Phonemes the alignment assigns to ``body`` when the alignment's
    graphemes start with ``prefix + body``; None on any mismatch.

    Prefix graphemes consume no phonemes; each matched body grapheme takes
    the next phoneme of its pair (pairs may straddle the boundary).
    """
    consumed_prefix = 0
    consumed_body = 0
    collected: List[str] = []

    for graphemes, phonemes in pairs:
        grapheme_idx = 0
        phoneme_idx = 0

        while consumed_prefix < len(prefix) and grapheme_idx < len(graphemes):
            if graphemes[grapheme_idx] != prefix[consumed_prefix]:
                return None
            consumed_prefix += 1
            grapheme_idx += 1

        while consumed_body < len(body) and grapheme_idx < len(graphemes):
            if graphemes[grapheme_idx] != body[consumed_body]:
                return None
            consumed_body += 1
            grapheme_idx += 1
            if phoneme_idx < len(phonemes):
                collected.append(phonemes[phoneme_idx])
                phoneme_idx += 1

        if consumed_body >= len(body):
            break

    return collected or None


def get_aligned_phonemes(
    lexicon: LexiconDatabase, word: str, prefix: str, body: str
) -> Iterable[List[str]]:
    """Yield phoneme sequences for the ``body`` segment of ``word``, one per
    stored alignment that matches."""
    for alignment in lexicon.alignments(word):
        phones = _segment_phonemes(_parse_alignment(alignment), prefix, body)
        if phones is not None:
            yield phones
