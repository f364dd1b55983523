"""Closed-form chirp synthesis (batched reformulation).

The reference integrates a sawtooth instantaneous frequency through a
per-sample phase accumulator (/root/reference/ChirpGenerator.hpp:21-47):

    f_i   = fMin + f0 + (i+1)*fStep - range*w_i      (one wrap per symbol max)
    phase = phase0 +/- cumsum(f)

with fMin = -pi/ovs, fStep = 2pi/(N*ovs^2), range = 2pi/ovs and f0 = 2pi*s/NN
for symbol s.  Here the cumulative phase is computed *analytically*: with all
frequencies rational multiples of 2pi/D, D = N*ovs^2, the phase at sample i is

    phase_i / 2pi = [ (i+1)*(s*ovs - N*ovs/2) + (i+1)(i+2)/2
                      - N*ovs * max(0, i+1 - ovs*(N - s)) ] / D   (mod 1)

— exact integer arithmetic mod D (a power of two for power-of-two ovs), so
waveforms are phase-exact with no float accumulation error, fully vectorized,
and vmappable over symbols/batches.  The wrap count has the closed form above
because f crosses fMax exactly once per symbol, at step ovs*(N - s).

Demodulator dechirp tables use the reference demod's own convention
(LoRaDemod.cpp:97-107): phase ramp from -pi stepping 2pi/N, accumulated, i.e.
phase_i / pi = i(i+1)/N - (i+1)  — also exact in integers (mod 2).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import cplx
from .cplx import IQ


def chirp_phase_nums(
    s, n_samples: int, N: int, ovs: int = 1, down: bool = False
):
    """Exact integer phase numerators of one chirp symbol: phase_i =
    2*pi*num_i/D with D = N*ovs^2, plus the end-of-symbol carry numerator.

    s: traced or static symbol frequency offset in FFT bins (int; f0 =
       2*pi*s/NN in the reference's terms).  n_samples: samples to emit
       (NN for a full symbol, NN/4 for the quarter chirp).
    Returns (num[n_samples] uint32 in [0, D), carry uint32).
    """
    D = N * ovs * ovs
    if D & (D - 1):
        raise ValueError("oversampling ratio must be a power of two")
    if D * 2 > 1 << 31:
        raise ValueError("N*ovs^2 too large for exact int32 phase arithmetic")
    i1 = jnp.arange(1, n_samples + 1, dtype=jnp.uint32)  # i+1
    s = jnp.asarray(s, jnp.uint32)
    A = s * np.uint32(ovs) + np.uint32((2 * D - N * ovs // 2) % D)
    # triangular term (i+1)(i+2)/2 mod D: compute the product mod 2D via
    # natural uint32 wraparound (2D divides 2^32), halve exactly.
    tri = ((i1 * (i1 + 1)) & np.uint32(2 * D - 1)) >> 1
    # Wrap count: the sawtooth crosses fMax at step i+1 == ovs*(N - s); the
    # reference's float-accumulated f lands epsilon above fMax there and
    # wraps *at equality*, so W_i = max(0, i+2 - ovs*(N-s)).  (For ovs == 1
    # the wrap is exactly 2*pi and the convention is invisible; for ovs > 1
    # it is a constant phase offset on the symbol tail.)
    w = jnp.maximum(
        jnp.int32(0), i1.astype(jnp.int32) + 1 - (ovs * (N - s.astype(jnp.int32)))
    )
    wrap_term = (w.astype(jnp.uint32) * np.uint32((D - N * ovs % D) % D))
    num = (i1 * A + tri + wrap_term) & np.uint32(D - 1)
    carry = num[-1]
    if down:
        num = (np.uint32(D) - num) & np.uint32(D - 1)
        carry = (np.uint32(D) - carry) & np.uint32(D - 1)
    return num, carry


def chirp_phase_turns(
    s, n_samples: int, N: int, ovs: int = 1, down: bool = False
):
    """Phase (in turns, mod 1) of one chirp symbol + end carry (int numerator)."""
    D = N * ovs * ovs
    num, carry = chirp_phase_nums(s, n_samples, N, ovs, down)
    return num.astype(jnp.float32) / np.float32(D), carry.astype(jnp.int32)


def gen_chirp(
    s,
    N: int,
    ovs: int = 1,
    n_samples: int | None = None,
    down: bool = False,
    ampl: float = 1.0,
    phase0_turns=0.0,
):
    """One chirp symbol as planar IQ, matching the reference generator's
    waveform (ChirpGenerator.hpp:21-47) with analytically exact phase.

    phase0_turns: starting phase carry (turns) for phase continuity across
    symbols.  Returns (IQ[n_samples], end_phase_turns).
    """
    if n_samples is None:
        n_samples = N * ovs
    turns, carry = chirp_phase_turns(s, n_samples, N, ovs, down)
    D = N * ovs * ovs
    phase0_turns = jnp.asarray(phase0_turns, jnp.float32)
    iq = cplx.from_turns(turns + phase0_turns, jnp.float32(ampl))
    end = jnp.mod(phase0_turns + carry.astype(jnp.float32) / np.float32(D), 1.0)
    return iq, end


@functools.lru_cache(maxsize=None)
def _dechirp_turns_np(N: int, down: bool) -> np.ndarray:
    """Dechirp multiplier phase table (turns): the exact conjugate of this
    framework's own base (s=0) up/down chirp, so that for an aligned window
    the detector reads bin == symbol and for a window starting delta samples
    late into a preamble it reads bin == delta (consume N-delta aligns).

    The reference demod instead builds its table with a slightly different
    phase ramp (LoRaDemod.cpp:97-107) that reads one bin high against its
    own modulator; its FSM absorbs the bias by retiming one extra sample
    (`consume N-value`, LoRaDemod.cpp:219) and settles at the same observable
    symbol values.  Using the self-consistent table removes that transient.
    """
    i1 = np.arange(1, N + 1, dtype=np.int64)  # i+1
    w = np.maximum(0, i1 + 1 - N)  # wrap-at-equality, see chirp_phase_turns
    num = (i1 * (N // 2) * (-1) + i1 * (i1 + 1) // 2 - N * w) % N
    turns = (num / N) % 1.0  # base upchirp phase, s = 0, ovs = 1
    if not down:
        turns = (-turns) % 1.0  # conj(upchirp) flattens up-chirps
    # down=True: conj(downchirp) == upchirp itself
    return turns.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dechirp_table_np(N: int, down: bool) -> tuple[np.ndarray, np.ndarray]:
    t = 2 * np.pi * _dechirp_turns_np(N, down).astype(np.float64)
    return np.cos(t).astype(np.float32), np.sin(t).astype(np.float32)


def dechirp_table(N: int, down: bool = False) -> IQ:
    """Unit-amplitude dechirp multiplier of length N (planar IQ).

    down=False: multiplier that flattens *up*-chirps (data/preamble/sync).
    down=True:  multiplier that flattens *down*-chirps.
    """
    re, im = _dechirp_table_np(N, down)
    return IQ(jnp.asarray(re), jnp.asarray(im))
