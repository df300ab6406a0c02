"""Persistent XLA compilation cache for serving processes.

Within one process the shape buckets bound recompiles, but a fresh
serving process would re-pay every flagship compile. JAX's persistent
compilation cache makes the second process's time-to-first-transcript
seconds instead of minutes.

The reference has no equivalent concern (Kaldi binaries are AOT C++); this
is the counterpart of "the decoder binary is already compiled".

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module configures nothing. Otherwise the cache lives at one fixed
directory inside the checkout (:data:`REPO_CACHE_DIR`): the directory is
part of what a later process must find again, so it never depends on the
home directory, the host, the process or the time.

Enabled automatically by the serving entry points (AcousticModel /
StreamScheduler); opt out with RSTPU_NO_COMPILE_CACHE=1.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Optional

_LOGGER = logging.getLogger(__name__)

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"

_enabled_dir: Optional[str] = None


def cache_dir() -> Path:
    """Where compiled programs persist: ``$JAX_COMPILATION_CACHE_DIR`` when
    set, else :data:`REPO_CACHE_DIR`."""
    env = os.environ.get(ENV_VAR)
    return Path(env) if env else REPO_CACHE_DIR


def enable_compilation_cache() -> Optional[str]:
    """Turn on JAX's persistent compilation cache (idempotent).

    Returns the active cache directory, or None when disabled via
    RSTPU_NO_COMPILE_CACHE or skipped on the CPU backend. Safe to call
    before or after JAX backends initialize; programs compiled after the
    call are persisted and reloaded across processes (same program
    fingerprint + compile options + platform).
    """
    global _enabled_dir
    if os.environ.get("RSTPU_NO_COMPILE_CACHE"):
        return None
    env = os.environ.get(ENV_VAR)
    if env:
        return env  # JAX configured itself from the variable

    import jax

    # XLA:CPU AOT deserialization is not trustworthy: entries recorded on
    # this very host reload with "machine feature +prefer-no-scatter /
    # +prefer-no-gather not supported" (cpu_aot_loader.cc) and the
    # resulting executables have misexecuted (wrong streaming
    # transcripts). The cache exists for the accelerator's cold start, so
    # skip it on the CPU backend unless the variable above asks for it.
    if jax.default_backend() == "cpu":
        _LOGGER.debug("persistent compilation cache skipped on the CPU backend")
        return None

    # Respect an embedding application's own cache configuration: if the
    # process already points jax_compilation_cache_dir somewhere (and it
    # wasn't us), leave every cache knob alone.
    existing = getattr(jax.config, "jax_compilation_cache_dir", None)
    if existing and existing != _enabled_dir:
        _LOGGER.debug(
            "persistent compilation cache already configured at %s; "
            "leaving it untouched",
            existing,
        )
        return existing

    path = str(REPO_CACHE_DIR)
    if _enabled_dir == path:
        return path

    try:
        REPO_CACHE_DIR.mkdir(parents=True, exist_ok=True)
        _trim_cache_dir(REPO_CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
        # Persist any program whose compile took noticeable time (the
        # serving programs range from ~1 s chunk steps to minute-long
        # flagship compiles); the 0.2 s floor keeps throwaway
        # sub-millisecond programs from unrelated JAX code in the same
        # process out of the cache.
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    except Exception as exc:  # pragma: no cover - best-effort on odd backends
        _LOGGER.warning("persistent compilation cache unavailable: %s", exc)
        return None
    _enabled_dir = path
    _LOGGER.debug("persistent compilation cache at %s", path)
    return path


def _trim_cache_dir(path: Path) -> None:
    """Bound the on-disk cache: JAX never evicts, so a long-lived host
    would otherwise grow the directory without limit. Oldest-first
    removal down to RSTPU_COMPILE_CACHE_MAX_GB (default 10); best-effort.

    Recency is max(mtime, atime): JAX touches atime (not mtime) on cache
    reads, so entries a concurrent serving process is actively reusing
    rank as fresh. Entries newer than a grace period (default 24 h,
    RSTPU_COMPILE_CACHE_TRIM_GRACE_HOURS) are never evicted, so
    process-start trims in one process can't evict an entry another
    process wrote moments ago and is about to reuse."""
    try:
        limit = float(os.environ.get("RSTPU_COMPILE_CACHE_MAX_GB", "10"))
        grace_h = float(
            os.environ.get("RSTPU_COMPILE_CACHE_TRIM_GRACE_HOURS", "24")
        )
        now = time.time()
        entries = []
        for f in path.iterdir():
            if not f.is_file():
                continue
            st = f.stat()
            entries.append((max(st.st_mtime, st.st_atime), st.st_size, f))
        total = sum(size for _m, size, _f in entries)
        budget = limit * (1 << 30)
        if total <= budget:
            return
        for recency, size, f in sorted(entries):
            if now - recency < grace_h * 3600.0:
                break  # sorted oldest-first: everything left is fresher
            try:
                f.unlink()
                total -= size
            except OSError:
                continue
            if total <= budget:
                break
        _LOGGER.info(
            "trimmed persistent compilation cache at %s to %.1f GiB",
            path,
            total / (1 << 30),
        )
    except OSError:  # pragma: no cover
        pass
