"""Batched dechirp + FFT + argmax symbol detection (planar complex).

Reformulates the reference's per-symbol scalar path — dechirp multiply loop
(LoRaDemod.cpp:157-166) feeding kissfft + argmax/power scan + fractional-bin
interpolation (LoRaDetector.hpp:29-64) — as one fused batched array op over
[..., W, N] sample windows.  The fine-CFO rotator table of N*128 phasors
(LoRaDemod.cpp:108-116) becomes the analytic rotator exp(-2j*pi*ferr*n/N)
folded into the dechirp multiply (a constant per-window phase does not
affect |FFT|, so no cross-window rotator continuity is needed).

All complex data is planar (ops/cplx.py); the transform is cuFFT through
jnp.fft, with the dechirp multiply and the |X|^2 reductions fused around it
by XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import cplx
from .chirp import dechirp_table
from .cplx import IQ


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DetectResult:
    """Per-window detector outputs (shape [...] = input batch/window axes)."""

    value: jax.Array      # int32 argmax bin (the symbol measurement)
    power: jax.Array      # float32 peak power, dB (scaled by 20*log10(N))
    noise: jax.Array      # float32 residual power, dB (total minus peak)
    f_index: jax.Array    # float32 fractional-bin offset of the peak
    mag2: Optional[jax.Array] = None  # float32 [..., N] |FFT|^2 (debug tap)


def rotator(ferr, N: int) -> IQ:
    """Fine-CFO derotator exp(-2j*pi*ferr*n/N); ferr in (fractional) bins,
    traced or static, broadcasting over leading axes."""
    n = jnp.arange(N, dtype=jnp.float32)
    ang = (-2 * np.pi / N) * jnp.asarray(ferr, jnp.float32)[..., None] * n
    return IQ(jnp.cos(ang), jnp.sin(ang))


def dechirp(x, down: bool = False, ferr=None) -> IQ:
    """Multiply sample windows [..., N] by the dechirp table (and optional
    fine-CFO derotator)."""
    x = cplx.as_iq(x)
    N = x.shape[-1]
    d = cplx.mul(x, cplx.broadcast_to(dechirp_table(N, down), x.shape))
    if ferr is not None:
        r = rotator(ferr, N)
        d = cplx.mul(d, cplx.broadcast_to(r, d.shape))
    return d


def _from_mag2(mag2: jax.Array, want_mag2: bool) -> DetectResult:
    """Reductions of |FFT|^2 windows [..., N] into detector outputs."""
    N = mag2.shape[-1]
    value = jnp.argmax(mag2, axis=-1).astype(jnp.int32)
    peak2 = jnp.max(mag2, axis=-1)
    total = jnp.sum(mag2, axis=-1)

    power_scale = jnp.float32(20.0 * np.log10(N))
    fundamental = jnp.sqrt(peak2)
    noise_amp = jnp.sqrt(jnp.maximum(total - peak2, 0.0))
    power = 20.0 * jnp.log10(jnp.maximum(fundamental, 1e-20)) - power_scale
    noise = 20.0 * jnp.log10(jnp.maximum(noise_amp, 1e-20)) - power_scale

    left_i = (value - 1) % N
    right_i = (value + 1) % N
    mag = jnp.sqrt(mag2)
    left = jnp.take_along_axis(mag, left_i[..., None], axis=-1)[..., 0]
    right = jnp.take_along_axis(mag, right_i[..., None], axis=-1)[..., 0]
    denom = 2.0 * fundamental - right - left
    f_index = jnp.where(denom == 0.0, 0.0, 0.5 * (right - left) / denom)

    return DetectResult(
        value=value,
        power=power,
        noise=noise,
        f_index=f_index,
        mag2=mag2 if want_mag2 else None,
    )


def fft(x: IQ) -> IQ:
    """Batched complex FFT over the last axis (planar in, planar out)."""
    spec = jnp.fft.fft(jax.lax.complex(x.re, x.im))
    return IQ(jnp.real(spec), jnp.imag(spec))


def detect(dechirped, want_mag2: bool = False) -> DetectResult:
    """argmax(|FFT|^2) detection over dechirped windows [..., N].

    Returns bin index, peak/noise powers in dB (normalized by 20*log10(N),
    LoRaDetector.hpp:18,50-54) and the 3-point fractional-bin interpolation
    (LoRaDetector.hpp:56-61).
    """
    spectrum = fft(cplx.as_iq(dechirped))
    return _from_mag2(cplx.mag2(spectrum), want_mag2)


def dechirp_detect(
    x, down: bool = False, ferr=None, want_mag2: bool = False
) -> DetectResult:
    """Dechirp + detect over sample windows [..., N], one XLA fusion
    chain around the FFT."""
    return detect(dechirp(x, down, ferr), want_mag2=want_mag2)
