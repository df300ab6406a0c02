"""Stream-parallel sharding over a device mesh.

The reference has no distributed execution at all (SURVEY §2.3: asyncio
subprocess overlap only). The scale-out axis here is **concurrent
streams**: decode state is embarrassingly parallel over streams, so the
design shards the batch dimension across a 1-D device mesh with pjit and
keeps the decode graph + acoustic model replicated. Cross-device traffic
is only the final scalar metrics reduction (psum). The cards of one host
are joined all to all, so the mesh follows the stream axis alone.

With n devices the same compiled program serves n× the streams.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_stream_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = "streams",
    devices: Optional[Sequence] = None,
) -> Mesh:
    """1-D mesh over all (or the first n) of ``devices`` (default: the
    default backend's devices). Too few devices is an error: the mesh
    never moves to another platform."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)} "
                f"({devices[0].platform if devices else 'none'})"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def shard_streams(mesh: Mesh, *arrays, axis_name: str = "streams"):
    """Place arrays with their leading (stream/batch) dim sharded on the mesh."""
    out = []
    for arr in arrays:
        spec = P(axis_name, *([None] * (arr.ndim - 1)))
        out.append(jax.device_put(arr, NamedSharding(mesh, spec)))
    return out[0] if len(out) == 1 else tuple(out)


def sharded_decode_fn(
    mesh: Mesh,
    decode_fn: Callable,
    axis_name: str = "streams",
    num_batch_args: int = 1,
) -> Callable:
    """jit decode_fn with its first num_batch_args arguments batch-sharded
    over the mesh and every other operand replicated.

    decode_fn must be shape-polymorphic over the leading dim only in the
    sense that per-device shards see B/n streams; all decode ops are
    per-stream, so XLA partitions them with zero collectives.
    """
    batch_spec = NamedSharding(mesh, P(axis_name))

    def wrapper(*args):
        placed = []
        for i, a in enumerate(args):
            if i < num_batch_args and hasattr(a, "ndim") and a.ndim >= 1:
                spec = NamedSharding(
                    mesh, P(axis_name, *([None] * (a.ndim - 1)))
                )
                placed.append(jax.device_put(a, spec))
            else:
                placed.append(a)
        return _jitted(*placed)

    _jitted = jax.jit(decode_fn)
    _ = batch_spec  # placement happens via device_put; jit propagates it
    return wrapper
