"""Multi-chip batch transcription: the stream-sharded serving facade.

The reference serves one process per host with no distributed execution
(SURVEY §2.3); the scale-out axis is concurrent streams.
ShardedWavTranscriber is Nnet3WavTranscriber with its batch device
programs partitioned over a 1-D stream mesh: inputs are placed with a
``P("streams", None)`` sharding and XLA partitions the MFCC, i-vector,
TDNN-F, and Viterbi programs over the mesh with zero collectives (every
op is per-stream; only host word assembly sees gathered outputs).

On n devices the same compiled step serves n× the streams. Validated on
the virtual CPU mesh (tests/test_parallel.py) and on four GPUs by
``python chip_smoke.py --four``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..pipeline.transcribe import Nnet3WavTranscriber
from .sharding import make_stream_mesh


class ShardedWavTranscriber(Nnet3WavTranscriber):
    """Nnet3WavTranscriber whose batch decodes shard over a device mesh.

    Same API and results as the single-chip transcriber; batches are
    padded up to a multiple of the mesh size with empty streams (their
    results are dropped), and sub-batches align to shard boundaries."""

    def __init__(self, *args, mesh: Optional[Mesh] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.mesh = mesh if mesh is not None else make_stream_mesh()
        self._shard_count = int(np.prod(self.mesh.devices.shape))
        axis = self.mesh.axis_names[0]
        self.input_sharding = NamedSharding(self.mesh, P(axis, None))

    def _decode_batch(
        self, pcm_batch: List[np.ndarray], nbest: int
    ) -> List[List[Tuple[List[int], float]]]:
        n = self._shard_count
        pad = (-len(pcm_batch)) % n
        if pad:
            filler = np.zeros(1600, dtype=np.float32)
            pcm_batch = list(pcm_batch) + [filler] * pad
        out = super()._decode_batch(pcm_batch, nbest)
        return out[: len(out) - pad] if pad else out
