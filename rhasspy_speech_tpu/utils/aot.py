"""Ahead-of-time program store: serve without re-tracing the pipeline.

The persistent XLA compilation cache (utils/compile_cache.py) removes the
*compile* cost of a warm start, but a fresh serving process still pays
JAX tracing + StableHLO lowering for every flagship program.
``jax.export`` snapshots the lowered StableHLO to disk; loading it
restores a callable with NO
Python tracing or lowering — the first call costs only a (cached) XLA
compile. Reference analogue: Kaldi binaries are ahead-of-time compiled
C++, so a second `online2-wav-nnet3-latgen-faster` start pays no
compilation at all; this store gives the JAX pipeline the same property.

Blobs are keyed by program name + input shapes/dtypes + jax version +
lowering platform (``jax.export``'s name for it: "cpu", or "cuda" for an
NVIDIA GPU), so a shape or environment change falls back to normal
tracing (never a wrong program). The program is StableHLO (portable),
NOT an XLA:CPU executable — the unsafe-CPU-AOT caveat in
compile_cache.py does not apply here.

Blob format: the pickled ``jax.export.Exported`` without its VJP closure.
``Exported.serialize`` needs the optional ``flatbuffers`` package, which a
serving host may lack; pickle needs nothing beyond JAX. Blobs are only
ever read from a store this program wrote (``save_aot`` / ``cli
warmup``), and the key's JAX version keeps one JAX from reading another's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import pickle
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import jax

_LOGGER = logging.getLogger(__name__)


def _arg_specs(args: Sequence) -> Tuple:
    """ShapeDtypeStruct pytrees mirroring ``args`` (each element may be an
    array or a pytree of arrays, e.g. the scheduler's am_state dict)."""
    return tuple(
        jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), a)
        for a in args
    )


def export_platform(backend: str) -> str:
    """``jax.export``'s lowering platform for a JAX backend name: it names
    an NVIDIA GPU by its toolkit, "cuda", where the backend says "gpu"."""
    return "cuda" if backend == "gpu" else backend


def _args_platform(args: Sequence) -> str:
    """Lowering platform of the devices ``args`` live on (the default
    backend for host arrays)."""
    for leaf in jax.tree.leaves(args):
        if isinstance(leaf, jax.Array):
            return export_platform(next(iter(leaf.devices())).platform)
    return export_platform(jax.default_backend())


class AotStore:
    """Directory of serialized ``jax.export`` programs.

    ``load(name, args)`` returns a jitted callable restored from disk (or
    None when absent/mismatched); ``save(name, fn, args)`` exports ``fn``
    for the given example args and writes the blob. The in-memory cache
    makes repeated load() calls free.
    """

    def __init__(self, directory) -> None:
        self.dir = Path(directory)
        self._loaded: dict = {}

    # bumped whenever an exported program's OUTPUT contract changes (the
    # hash below only sees input specs, so a stale blob with the old
    # outputs would otherwise restore and fail at unpack time):
    # 2 = round-5 packed serving tick (u16 trace + folded endpoint stats)
    # 3 = pickled Exported blobs
    _FORMAT = "3"

    def _path(self, name: str, specs, platform: str) -> Path:
        h = hashlib.sha256()
        h.update(self._FORMAT.encode())
        h.update(jax.__version__.encode())
        h.update(platform.encode())
        leaves, treedef = jax.tree.flatten(specs)
        h.update(str(treedef).encode())
        for s in leaves:
            h.update(str(s.shape).encode())
            h.update(str(s.dtype).encode())
        return self.dir / f"{name}-{h.hexdigest()[:16]}.jaxexport"

    def load(
        self, name: str, args: Sequence, donate_argnums: Tuple[int, ...] = ()
    ) -> Optional[Callable]:
        specs = _arg_specs(args)
        path = self._path(name, specs, _args_platform(args))
        key = str(path)  # the path hash already encodes name+specs
        if key in self._loaded:
            return self._loaded[key]
        fn = None
        if path.is_file():
            try:
                exp = pickle.loads(path.read_bytes())
                # donation is a property of the CALLING jit, so the
                # restored program keeps the original's buffer reuse
                fn = jax.jit(exp.call, donate_argnums=donate_argnums)
                _LOGGER.debug("AOT program %s loaded from %s", name, path)
            except Exception as exc:  # wrong jax/backed version etc.
                _LOGGER.warning(
                    "AOT program %s at %s unusable (%s); re-tracing",
                    name, path, exc,
                )
                fn = None
        self._loaded[key] = fn
        return fn

    def save(
        self,
        name: str,
        fn: Callable,
        args: Sequence,
        donate_argnums: Tuple[int, ...] = (),
    ) -> Path:
        """Export ``fn`` (traceable; jitted or not) at ``args``' shapes."""
        from jax import export as jax_export

        specs = _arg_specs(args)
        platform = _args_platform(args)
        path = self._path(name, specs, platform)
        self.dir.mkdir(parents=True, exist_ok=True)
        wrapped = fn if isinstance(fn, jax.stages.Wrapped) else jax.jit(fn)
        exp = jax_export.export(wrapped, platforms=[platform])(*specs)
        # atomic publish: a serving process loading this store while a
        # warmup is writing must never read a truncated blob (deserialize
        # failure degrades to re-tracing, silently forfeiting the AOT win)
        tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
        tmp.write_bytes(
            pickle.dumps(dataclasses.replace(exp, _get_vjp=None))
        )
        os.replace(tmp, path)
        self._loaded[str(path)] = jax.jit(
            exp.call, donate_argnums=donate_argnums
        )
        _LOGGER.info("AOT program %s exported to %s", name, path)
        return path
