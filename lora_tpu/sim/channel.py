"""Channel impairment models (test/simulation fabric).

Replaces the reference's Pothos comms blocks used as the loopback channel:
/comms/noise_source NORMAL + /comms/arithmetic ADD (TestLoopback.cpp:75-76,
97-99) and /comms/rotate (lora_simulation.pth, phase pi/1.2345), plus CFO
and integer sample timing offset injection for receiver-recovery tests.
All functions are pure, batched, jit-friendly, and operate on planar IQ
(ops/cplx.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import cplx
from ..ops.cplx import IQ


def awgn(key: jax.Array, x, amplitude: float = 1.0) -> IQ:
    """Complex white Gaussian noise, matching the Pothos noise source's
    NORMAL waveform convention: `amplitude` scales a unit-variance complex
    normal (std 1 per I/Q leg)."""
    x = cplx.as_iq(x)
    kr, ki = jax.random.split(key)
    return IQ(
        x.re + amplitude * jax.random.normal(kr, x.shape, jnp.float32),
        x.im + amplitude * jax.random.normal(ki, x.shape, jnp.float32),
    )


def rotate(x, phase: float) -> IQ:
    """Static phase rotation (the simulation topology's /comms/rotate with
    phase pi/1.2345)."""
    x = cplx.as_iq(x)
    r = IQ(jnp.cos(jnp.float32(phase)), jnp.sin(jnp.float32(phase)))
    return IQ(x.re * r.re - x.im * r.im, x.re * r.im + x.im * r.re)


def cfo(x, offset_bins: float, N: int) -> IQ:
    """Carrier frequency offset of `offset_bins` FFT bins (at symbol size N):
    multiply by exp(2j*pi*offset*n/N)."""
    x = cplx.as_iq(x)
    n = jnp.arange(x.shape[-1], dtype=jnp.float32)
    ang = (2 * np.pi / N) * jnp.float32(offset_bins) * n
    return cplx.mul(x, cplx.broadcast_to(IQ(jnp.cos(ang), jnp.sin(ang)), x.shape))


def time_offset(x, samples: int) -> IQ:
    """Delay the stream by prepending `samples` zeros (static shift)."""
    x = cplx.as_iq(x)
    pad = [(0, 0)] * (x.ndim - 1) + [(samples, 0)]
    out = cplx.pad(x, pad)
    return out[..., : x.shape[-1] + samples]


def clock_drift(x, ppm: float) -> IQ:
    """Sample-clock frequency offset between TX and RX: resample by
    (1 + ppm*1e-6) through the polyphase fractional resampler, so each
    received sample lands ppm*1e-6 later (in TX time) than the last.

    Neither side of the reference models this (its loopback shares one
    clock), but every real radio pair has tens of ppm of combined crystal
    error; the demodulator's preamble retiming absorbs the accumulated
    drift up to ~1 sample over a frame (tests/test_loopback.py pins the
    tolerance)."""
    from ..ops import resample as rs

    x = cplx.as_iq(x)
    T = x.shape[-1]
    ratio = 1.0 + ppm * 1e-6
    y = rs.resample(x, ratio)
    pad = [(0, 0)] * (x.ndim - 1) + [(0, T - y.shape[-1])]
    return cplx.pad(y, pad)
