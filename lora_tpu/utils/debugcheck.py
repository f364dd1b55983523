"""Opt-in numeric sanitizer for the demod path (SURVEY.md §5 "race
detection / sanitizers" equivalent).

The framework is pure by construction (no shared mutable state to race
on), so the remaining class of silent corruption is NUMERIC: a NaN/Inf
entering the pipeline propagates through dechirp -> |FFT|^2 -> argmax and
comes out the other end as a perfectly plausible-looking (wrong) symbol
stream.  ``debug_checks()`` arms host-side finite/range assertions on
every ``demodulate`` result:

    with lora_tpu.debug_checks():
        dem = lora_tpu.demodulate(iq, cfg)   # raises on NaN/Inf/garbage

Checked per call (on the found lanes):
  * power / snr / fine CFO are finite,
  * symbols lie in [0, 2^sf),
  * t_sync / consumed lie inside the buffer,
  * payload spectra (fft_mag2) are finite and non-negative — demodulate
    is re-routed through its spectra-carrying path while checks are armed
    so the dechirped payload windows are actually inspected.

This is a debug mode: each call synchronizes with the device (host
readback) and the spectra tap changes the compiled program, exactly like
the reference's debug ports (LoRaDemod.cpp:81-83).  The reference build
has no sanitizer mode at all (CMakeLists.txt:1-47).
"""

from __future__ import annotations

import contextlib
import contextvars
import warnings

import numpy as np

# ContextVar, not a module global: arming is scoped to the arming
# thread/context, so a concurrent ingest/device pipeline thread (e.g.
# StreamDemodulator.pump's) keeps its unsynchronized fast path, and nested
# contexts cannot race across threads.
_ARMED: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "lora_debug_checks", default=False
)


def armed() -> bool:
    """True while inside a debug_checks() context (in this thread/context)."""
    return _ARMED.get()


@contextlib.contextmanager
def debug_checks():
    """Context manager arming numeric sanitizer checks on demodulate()."""
    token = _ARMED.set(True)
    try:
        yield
    finally:
        _ARMED.reset(token)


class DemodCheckError(AssertionError):
    """A demodulate() output failed the armed numeric sanitizer."""


def _fail(what: str, where) -> None:
    idx = np.argwhere(where)
    raise DemodCheckError(
        f"demodulate sanitizer: {what} at lane(s) {idx[:8].tolist()}"
        + (" ..." if len(idx) > 8 else "")
    )


_warned_traced = False


def check_demod(res, cfg, T: int) -> None:
    """Host-side assertions on a DemodResult (leading axes arbitrary).

    When the result leaves are tracers (demodulate invoked inside an
    outer jit/shard_map trace — api.channelized_demodulate, the halo /
    dispatch paths), host readback is impossible: skip with a one-time
    warning instead of crashing the trace.  The spectra re-route in
    demodulate() still happens under tracing, so armed sharded/streaming
    runs keep the checkable program; callers wanting the assertions there
    can check the fetched result explicitly via check_demod()."""
    import jax

    if isinstance(res.found, jax.core.Tracer):
        global _warned_traced
        if not _warned_traced:
            _warned_traced = True
            warnings.warn(
                "debug_checks(): demodulate traced under an outer "
                "jit/shard_map — host-side sanitizer assertions skipped "
                "for traced calls (checks still run on un-traced calls)",
                stacklevel=3,
            )
        return
    found = np.asarray(res.found)
    for name in ("power", "snr", "fine_freq"):
        a = np.asarray(getattr(res, name))
        bad = ~np.isfinite(a) & found
        if bad.any():
            _fail(f"non-finite {name}", bad)
    syms = np.asarray(res.symbols)
    bad = ((syms < 0) | (syms >= cfg.N)) & found[..., None]
    if bad.any():
        _fail(f"symbol out of [0, {cfg.N})", bad.any(axis=-1))
    t_sync = np.asarray(res.t_sync)
    bad = ((t_sync < 0) | (t_sync > T)) & found
    if bad.any():
        _fail("t_sync outside buffer", bad)
    consumed = np.asarray(res.consumed)
    bad = ((consumed < 0) | (consumed > T)) & found
    if bad.any():
        _fail("consumed outside buffer", bad)
    if res.fft_mag2 is not None:
        m = np.asarray(res.fft_mag2)
        bad = (~np.isfinite(m) | (m < 0)).any(axis=(-1, -2)) & found
        if bad.any():
            _fail("non-finite/negative payload spectra", bad)
