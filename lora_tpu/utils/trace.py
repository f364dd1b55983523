"""Profiling / tracing hooks (SURVEY.md §5 "tracing").

The reference's observability is GUI plotters on demod debug taps plus
stream labels (LoRaDemod.cpp:81-83,314-324).  Here:

  - `profile(dir)` wraps a region in a jax.profiler trace (view with
    TensorBoard / xprof, or reduce with tools/trace_stages.py).
  - `frame_events(dem, cfg)` turns a DemodResult bank into the structured
    per-frame records the reference emitted as labels/signals.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import numpy as np
import jax


@contextlib.contextmanager
def profile(trace_dir: str | None) -> Iterator[None]:
    """jax.profiler trace around a region; None disables.  Errors, the
    region's or the profiler's, propagate."""
    if not trace_dir:
        yield
        return
    with jax.profiler.trace(trace_dir):
        yield


def frame_events(dem, cfg) -> list[dict]:
    """Per-frame event records from a (batched) DemodResult — the
    equivalent of the reference's stream labels + error/power/snr signals."""
    found = np.atleast_1d(np.asarray(dem.found))
    out = []
    for b in range(found.shape[0]):
        if not found[b]:
            continue
        t_sync = int(np.atleast_1d(np.asarray(dem.t_sync))[b])
        out.append(
            {
                "channel": b,
                "event": "frame",
                "t_preamble": t_sync - cfg.preamble_symbols * cfg.N,
                "t_sync": t_sync,
                "symbols": int(np.atleast_1d(np.asarray(dem.count))[b]),
                "snr_db": float(np.atleast_1d(np.asarray(dem.snr))[b]),
                "power_db": float(np.atleast_1d(np.asarray(dem.power))[b]),
                "cfo_bins": int(np.atleast_1d(np.asarray(dem.freq_error))[b]),
                "fine_cfo": float(
                    np.atleast_1d(np.asarray(dem.fine_freq))[b]
                ),
            }
        )
    return out
