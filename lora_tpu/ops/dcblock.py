"""Streaming DC blocker (single-pole high-pass) for SDR ingest.

The reference's SDR receive topology inserts a DC-removal block between
the SDR source and the demodulator (/root/reference/examples/rx_RN2483.pth,
graph node "/comms/dc_removal"): zero-IF tuners such as the RTL-SDR used
by RN2483Capture.py park a DC spike at band center, and a spike larger
than the signal floods the dechirped spectrum's noise estimate until the
squelch blinds the sync scan.

The classic block is the one-pole IIR

    m[n] = (1 - alpha) * x[n] + alpha * m[n-1]        (DC estimate)
    y[n] = x[n] - m[n]

A first-order linear recurrence is sequential on a CPU but *associative*
in the pair representation m[n] = A*m[n-1] + B: two steps compose as
(A2*A1, A2*B1 + B2).  `lax.associative_scan` therefore evaluates the
whole recurrence in O(log T) depth with full data parallelism — the
batched form of the reference's per-sample loop.  The carried state
(the last DC estimate) makes chunked streaming seam-free; it is the
moral twin of ops/resample.ResampleState.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from . import cplx
from .cplx import IQ


class DcState(NamedTuple):
    """Last DC estimate per stream (shape = the input's batch dims)."""

    re: jax.Array
    im: jax.Array


def _ema(x: jax.Array, alpha: jax.Array, m0: jax.Array) -> jax.Array:
    """m[n] = alpha*m[n-1] + (1-alpha)*x[n] along the last axis, seeded
    with m[-1] = m0, via associative scan over (A, B) pairs."""
    b = (1.0 - alpha) * x
    # fold the carried state into the first step: m[0] = alpha*m0 + b[0]
    b = b.at[..., 0].add(alpha * m0)
    a = jnp.broadcast_to(alpha, x.shape)

    def combine(l, r):
        return (l[0] * r[0], l[1] * r[0] + r[1])

    _, m = jax.lax.associative_scan(combine, (a, b), axis=-1)
    return m


@functools.partial(jax.jit, static_argnames=())
def _dcblock(x: IQ, alpha: jax.Array, m_re, m_im):
    mr = _ema(x.re, alpha, m_re)
    mi = _ema(x.im, alpha, m_im)
    y = IQ(x.re - mr, x.im - mi)
    return y, DcState(mr[..., -1], mi[..., -1])


def dcblock(
    x, alpha: float = 0.999, state: Optional[DcState] = None
) -> tuple[IQ, DcState]:
    """High-pass `x` [..., T] with a one-pole DC blocker; returns
    (y, state).  Pass the returned state back in to continue a chunked
    stream with no seam (the estimate survives the chunk boundary).

    alpha sets the tracking constant: the -3 dB cutoff is roughly
    (1-alpha)/pi of the sample rate — the 0.999 default settles in ~1000
    samples, well under one LoRa symbol at SF10+, and passes the 125-500
    kHz signal band untouched at any capture rate.
    """
    x = cplx.as_iq(x)
    a = jnp.float32(alpha)
    if state is None:
        z = jnp.zeros(x.shape[:-1], jnp.float32)
        state = DcState(z, z)
    return _dcblock(x, a, state.re, state.im)
