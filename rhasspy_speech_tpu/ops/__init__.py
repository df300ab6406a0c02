"""Device compute ops: feature frontend, acoustic forward, dense decoding."""

from .frontend import (
    FrontendConfig,
    FrontendParams,
    make_frontend_params,
    mfcc_batch,
    mfcc_numpy,
    num_frames,
)

__all__ = [
    "FrontendConfig",
    "FrontendParams",
    "make_frontend_params",
    "mfcc_batch",
    "mfcc_numpy",
    "num_frames",
]
