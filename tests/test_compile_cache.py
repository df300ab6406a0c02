"""Persistent compilation cache: a second serving process reuses the first
process's compiled XLA programs.

The reference's decoder is AOT-compiled C++ (no per-process compile cost);
the equivalent here is persisting XLA executables across processes. The
cache honours ``JAX_COMPILATION_CACHE_DIR`` and otherwise sits at one
fixed directory inside the checkout.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from rhasspy_speech_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parent.parent

DRIVE = r"""
import sys, time
sys.path.insert(0, {repo!r})

from jax._src import monitoring
hits = []
monitoring.register_event_listener(
    lambda event, **kw: hits.append(1)
    if event == "/jax/compilation_cache/cache_hits" else None
)

from rhasspy_speech_tpu.const import LangSuffix
from rhasspy_speech_tpu.pipeline import Nnet3WavTranscriber, lang_dir_name
from rhasspy_speech_tpu.pipeline.train import train_model_sync
from rhasspy_speech_tpu.testing import build_synthetic_profile, synthesize_sentence

root = {root!r}
lexicon = {{"turn": ["t", "er", "n"], "on": ["aa", "n"], "light": ["l", "ay", "t"]}}
profile = build_synthetic_profile(root + "/m", lexicon)
train_model_sync(
    "en",
    {{"language": "en",
      "intents": {{"M": {{"data": [{{"sentences": ["turn on light"]}}]}}}}}},
    root + "/t", profile.model_dir, lang_suffixes=[LangSuffix.GRAMMAR],
)
t = Nnet3WavTranscriber(
    profile.model_dir, root + "/t/" + lang_dir_name(LangSuffix.GRAMMAR)
)
pcm = synthesize_sentence(profile, "turn on light", seed=1)
assert t.transcribe_pcm_batch([pcm])[0] == ["turn on light"]
print("CACHE_HITS", len(hits))
"""


def _run(tmp_path, cache_dir) -> int:
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        JAX_COMPILATION_CACHE_DIR=str(cache_dir),
        # the synthetic profile's programs compile in well under JAX's
        # default 1 s persistence floor; persist all of them
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
    )
    env.pop("RSTPU_NO_COMPILE_CACHE", None)
    script = DRIVE.format(repo=str(REPO), root=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True,
        text=True,
        env=env,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("CACHE_HITS")]
    return int(line[-1].split()[1])


def test_second_process_hits_persistent_cache(tmp_path):
    cache_dir = tmp_path / "xla_cache"
    hits1 = _run(tmp_path / "p1", cache_dir)
    entries = [p for p in cache_dir.rglob("*") if p.is_file()]
    assert entries, "first process persisted no compiled programs"
    assert hits1 == 0  # fresh dir: all misses

    hits2 = _run(tmp_path / "p2", cache_dir)
    assert hits2 > 0, "second process compiled everything again"
    # the second process found every program it needed: nothing new written
    assert len([p for p in cache_dir.rglob("*") if p.is_file()]) == len(entries)


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "c"))
    assert compile_cache.cache_dir() == tmp_path / "c"
    # JAX configures itself from the variable: the module returns it and
    # touches no JAX setting
    import jax

    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compilation_cache() == str(tmp_path / "c")
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_defaults_to_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    monkeypatch.setenv("HOME", "/nonexistent-home")
    monkeypatch.setenv("XDG_CACHE_HOME", "/nonexistent-cache")
    assert compile_cache.cache_dir() == REPO / ".jax_cache"
    assert compile_cache.REPO_CACHE_DIR == REPO / ".jax_cache"
    gitignore = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in gitignore


@pytest.mark.parametrize("env", ["RSTPU_NO_COMPILE_CACHE", None])
def test_cache_skipped_on_cpu_or_when_disabled(monkeypatch, env):
    """Unset variable on the CPU backend (or the opt-out) enables nothing:
    XLA:CPU executables do not reload reliably."""
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    if env:
        monkeypatch.setenv(env, "1")
    assert compile_cache.enable_compilation_cache() is None
