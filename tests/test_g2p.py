"""Lexicon / G2P helper tests (contract from /root/reference/tests/test_g2p.py,
using a synthetic SQLite lexicon instead of a downloaded model)."""

import sqlite3

import pytest

from rhasspy_speech_tpu.lexicon import (
    LexiconDatabase,
    get_sounds_like,
    split_words,
)
from rhasspy_speech_tpu.grammar.numbers import NumberEngine


@pytest.fixture
def lexicon(tmp_path) -> LexiconDatabase:
    db_path = tmp_path / "lexicon.db"
    conn = sqlite3.connect(db_path)
    conn.executescript(
        """
        CREATE TABLE word_phonemes (
            word TEXT, phonemes TEXT, pron_order INTEGER
        );
        CREATE TABLE g2p_alignments (word TEXT, alignment TEXT);
        """
    )
    rows = [
        ("test", "t ˈɛ s t", 0),
        ("read", "ɹ ˈiː d", 0),
        ("read", "ɹ ˈɛ d", 1),
        ("moon", "m ˈuː n", 0),
        ("cake", "k ˈeɪ k", 0),
        ("Branch", "b ɹ ˈæ n tʃ", 0),
    ]
    conn.executemany("INSERT INTO word_phonemes VALUES (?, ?, ?)", rows)
    conn.executemany(
        "INSERT INTO g2p_alignments VALUES (?, ?)",
        [("testing", "t}t e}ˈɛ s}s t}t i}ɪ n|g}ŋ")],
    )
    conn.commit()
    conn.close()
    return LexiconDatabase(db_path)


def test_lookup_and_case_variants(lexicon: LexiconDatabase) -> None:
    assert lexicon.lookup("test") == [["t", "ˈɛ", "s", "t"]]
    # Multiple pronunciations in order
    assert lexicon.lookup("read") == [["ɹ", "ˈiː", "d"], ["ɹ", "ˈɛ", "d"]]
    # Case variations fall back: branch -> Branch (upper), TEST -> test
    assert lexicon.lookup("TEST") == [["t", "ˈɛ", "s", "t"]]
    assert lexicon.exists("Test")
    assert not lexicon.exists("nonexistent")


def test_in_memory_overlay(lexicon: LexiconDatabase) -> None:
    lexicon.add("zigzag", [["z", "ɪ", "g", "z", "æ", "g"]])
    assert lexicon.exists("zigzag")
    assert lexicon.lookup("zigzag") == [["z", "ɪ", "g", "z", "æ", "g"]]


def test_sounds_like_words(lexicon: LexiconDatabase) -> None:
    # Combination of two known words
    prons = get_sounds_like(["moon", "cake"], lexicon)
    assert prons == [["m", "ˈuː", "n", "k", "ˈeɪ", "k"]]


def test_sounds_like_literal_phonemes(lexicon: LexiconDatabase) -> None:
    prons = get_sounds_like(["moon", "/k", "æ/"], lexicon)
    assert prons == [["m", "ˈuː", "n", "k", "æ"]]


def test_sounds_like_partial(lexicon: LexiconDatabase) -> None:
    # [test]ing -> phonemes aligned to the "test" segment of "testing"
    prons = get_sounds_like(["[test]ing"], lexicon)
    assert prons == [["t", "ˈɛ", "s", "t"]]

    # te[st]ing -> only the "st" segment
    prons = get_sounds_like(["te[st]ing"], lexicon)
    assert prons == [["s", "t"]]


def test_split_words(lexicon: LexiconDatabase) -> None:
    engine = NumberEngine.for_language("en")

    # Known word passes through
    assert split_words("test", lexicon, engine) == ["test"]

    # abc123 -> abc + number words (first tagged with digits)
    result = split_words("abc123", lexicon, engine)
    assert result == [
        "abc",
        ("one", "123"),
        ("hundred", None),
        ("twenty", None),
        ("three", None),
    ]

    # Initialisms
    assert split_words("NASA", lexicon, engine) == ["N", "A", "S", "A"]
    assert split_words("A.B.C.", lexicon, engine) == ["A", "B", "C"]


@pytest.mark.parametrize(
    "run, expected",
    [
        # today's behaviour of the Unicode-class regexes this replaces:
        # ^(?:\p{Lu}){2,}$ and ^(?:\p{L}\.){2,}$
        ("NASA", True), ("AB", True), ("ÉTÉ", True), ("ΣΩ", True),
        ("ДНК", True), ("N.A.S.A.", True), ("n.a.", True),
        ("A", False), ("Ab", False), ("N.A", False), ("A.", False),
        ("ǅǅ", False), ("ⒶⒷ", False), ("ⅠⅡ", False), ("1.2.", False),
        ("a.b.c", False), ("USA2", False), ("nasa", False),
    ],
)
def test_initialism_detection(run, expected):
    from rhasspy_speech_tpu.lexicon.g2p import _is_initialism

    assert _is_initialism(run) is expected


@pytest.mark.parametrize(
    "item, groups",
    [("[hel]lo", ("", "hel")), ("hel[lo]", ("hel", "lo")),
     ("a[b]c[d]", ("a", "b")), ("abc", None), ("[]x", None), ("x[y", None)],
)
def test_sounds_like_partial_pattern(item, groups):
    from rhasspy_speech_tpu.lexicon.g2p import _SOUNDS_LIKE_PARTIAL

    m = _SOUNDS_LIKE_PARTIAL.match(item)
    assert (m.groups() if m else None) == groups


def test_split_words_spells_initialisms(lexicon: LexiconDatabase) -> None:
    assert split_words("NASA test", lexicon, None) == ["N", "A", "S", "A", "test"]
    assert split_words("n.a. test", lexicon, None) == ["n", "a", "test"]
