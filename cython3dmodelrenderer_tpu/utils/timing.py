"""Timing and profiling helpers.

The reference's only instrumentation was tqdm + printf debug lines (SURVEY
§5); this module provides the device-side equivalents: a block-until-ready
frame timer, a simple FrameStats aggregate, and a context manager around
``jax.profiler.trace`` for perfetto traces.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional

import jax


@dataclasses.dataclass
class FrameStats:
    """Per-frame render statistics (SURVEY §5 'metrics/observability')."""

    ms_per_frame: float
    frames: int
    triangles: int
    #: triangle→tile pairs binned in the last frame (None for jnp backend)
    pairs: Optional[int] = None
    #: non-empty image tiles in the last frame (None for jnp backend)
    active_tiles: Optional[int] = None

    @property
    def mtris_per_sec(self) -> float:
        return self.triangles / self.ms_per_frame / 1e3


def time_frames(fn: Callable[[], object], n_warm: int = 3,
                n_iter: int = 20) -> float:
    """Average ms per call of ``fn``, warmed and block_until_ready-fenced."""
    for _ in range(n_warm):
        out = fn()
        jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n_iter * 1e3


@contextlib.contextmanager
def profile_trace(log_dir: str = "/tmp/crender_trace"):
    """Wrap a region in a jax profiler trace (perfetto-compatible)."""
    with jax.profiler.trace(log_dir):
        yield log_dir
