"""Critically-sampled polyphase DFT channelizer (wideband -> channel bank).

The reference processes exactly one narrowband stream; multi-channel
reception exists only as separate radio topologies (SURVEY.md §6,
BASELINE.json config 3 makes the channelizer a first-class target).  This module splits one wideband capture at rate K*BW into K
critically-sampled channels of rate BW:

    y_k[m] = sum_t h[t] x[mK - t] e^{-2 pi i k (mK - t) / K}
           = sum_p e^{+2 pi i p k / K} * sum_l h[lK+p] x[(m-l)K - p]

i.e. a *flipped* commutator Xrev[r, p] = x[rK - p] (each K-block reversed,
with LK-1 samples of filter history), per-phase FIR with the prototype's
polyphase components, then a K-point IDFT across phases; the FIR and
the IDFT collapse into one planar matmul (_fir_idft_matrix).  Each channel is an exact time-invariant bandpass
filter + decimator; on this decimation grid the channel-k residual
carrier e^{2 pi i k m} is exactly 1, so each output is true baseband at
the channel rate.

The prototype is a Kaiser-windowed sinc designed at import time (numpy,
host).  Channel k is centered at +k/K of the wideband sample rate
(negative frequencies = K-k).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import cplx
from .cplx import IQ


@functools.lru_cache(maxsize=None)
def prototype(K: int, taps_per_phase: int = 8, beta: float = 8.0) -> np.ndarray:
    """Kaiser lowpass prototype, length K*taps_per_phase, passband 0.5/K
    of the wideband rate, unit DC gain per channel."""
    L = K * taps_per_phase
    n = np.arange(L) - (L - 1) / 2
    h = np.sinc(n / K) * np.kaiser(L, beta)
    return (h / h.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _idft_k(K: int) -> tuple[np.ndarray, np.ndarray]:
    p = np.arange(K)
    ang = 2 * np.pi / K * np.outer(p, p)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _fir_idft_matrix(
    K: int, taps_per_phase: int, G: int
) -> tuple[np.ndarray, np.ndarray]:
    """[(L+G-1)*K, G*K] combined filterbank matrix producing G consecutive
    channelized output samples per im2col row:

        WB[(r, p), (j, k)] = H[j+L-1-r, p] * W[p, k]   (0 <= j+L-1-r < L)

    The prototype FIR and the K-point IDFT collapse into one contraction,
    and grouping G outputs widens the matmul result to G*K columns."""
    L = taps_per_phase
    H = prototype(K, taps_per_phase).reshape(L, K).astype(np.float64)
    wre, wim = _idft_k(K)
    W = wre.astype(np.float64) + 1j * wim.astype(np.float64)  # [p, k]
    R = L + G - 1
    wb = np.zeros((R, K, G, K), np.complex128)
    for r in range(R):
        for j in range(G):
            l = j + L - 1 - r
            if 0 <= l < L:
                wb[r, :, j, :] = H[l][:, None] * W
    wb = wb.reshape(R * K, G * K)
    return wb.real.astype(np.float32), wb.imag.astype(np.float32)


def _grouped_rows(a, K: int, taps_per_phase: int, G: int):
    """[..., rows, K] -> [..., Q, R*K] grouped matmul operand:
    Z[q, r*K + p] = a[qG + r, p] (R = L + G - 1, Q = (rows - L + 1) // G).

    Rows qG..qG+G-1 are exactly row q of the (Q, G*K) reshape, rows
    qG+G.. come from row q+1 of G-shifted reshapes — so Z is a lane-axis
    concat of ceil(R/G) contiguous reshaped views instead of R stride-G
    row gathers.  Shared by the
    analysis (channelize) and synthesis (synthesize) banks — their
    block-Toeplitz operands are identical up to the constant matrix."""
    L = taps_per_phase
    R = L + G - 1
    Q = (a.shape[-2] - L + 1) // G
    lead = a.shape[:-2]
    pieces = []
    r0 = 0
    while r0 < R:
        w = min(G, R - r0) * K
        seg = a[..., r0 : r0 + Q * G, :]
        short = Q * G - seg.shape[-2]
        if short:  # missing tail rows land in lanes sliced off below
            seg = jnp.pad(
                seg, [(0, 0)] * len(lead) + [(0, short), (0, 0)]
            )
        pieces.append(seg.reshape(*lead, Q, G * K)[..., :w])
        r0 += G
    return jnp.concatenate(pieces, -1)


@functools.lru_cache(maxsize=None)
def _fir_dft_syn_matrix(
    K: int, taps_per_phase: int, G: int
) -> tuple[np.ndarray, np.ndarray]:
    """[(L+G-1)*K, G*K] combined synthesis-bank matrix producing G*K
    consecutive wideband samples per grouped row of channel samples:

        WS[(r, k), (j, p)] = E[k, p] * Gh[j - r + L - 1, p]
                             (0 <= j - r + L - 1 < L)

    with E[k, p] = e^{+2 pi i k p / K} (the channel-k carrier on the
    commutator phase grid) and Gh[l, p] = K * h[l*K + p] the interpolating
    polyphase components.  The per-row K-point DFT across channels and the
    per-phase FIR collapse into one contraction, exactly mirroring
    _fir_idft_matrix on the analysis side."""
    L = taps_per_phase
    Gh = (prototype(K, taps_per_phase).astype(np.float64) * K).reshape(L, K)
    ere, eim = _idft_k(K)
    E = ere.astype(np.float64) + 1j * eim.astype(np.float64)  # [k, p]
    R = L + G - 1
    ws = np.zeros((R, K, G, K), np.complex128)
    for r in range(R):
        for j in range(G):
            l = j - r + L - 1
            if 0 <= l < L:
                ws[r, :, j, :] = E * Gh[l][None, :]
    ws = ws.reshape(R * K, G * K)
    return ws.real.astype(np.float32), ws.imag.astype(np.float32)


def synthesize(
    u,
    taps_per_phase: int = 8,
    state: IQ | None = None,
    group: int | None = None,
) -> tuple[IQ, IQ]:
    """Synthesis filterbank (TX combiner): merge K channel streams into
    one wideband stream — the exact transpose of :func:`channelize`.

    u: IQ [..., K, M] channel-k baseband at rate BW (channel k lands at
    +k/K of the wideband rate; negative frequencies = K-k).
    Returns (x, new_state):
      x          IQ [..., M*K] wideband at rate K*BW (causal: the
                 prototype's L*K-1-sample group delay is NOT compensated,
                 so chunked calls concatenate exactly)
      new_state  IQ [..., K, L-1] tail channel samples to pass as `state`
                 for streaming continuity (zeros on the first block)

    Each channel is zero-stuffed, interpolated with the same Kaiser
    prototype as the analysis bank (unit passband gain: K*h) and mixed to
    its carrier — algebraically identical to summing
    :func:`upconvert` over channels, but as ONE block-Toeplitz
    contraction over all K channels (upconvert is O(K*L) per output
    sample, usable for test vectors only).

    The reference has no multi-channel TX (one radio = one stream,
    SURVEY.md §2.2); this is the TX side of BASELINE.json config 3.
    """
    u = cplx.as_iq(u)
    K, M = u.shape[-2], u.shape[-1]
    L = taps_per_phase
    if state is None:
        state = cplx.zeros((*u.shape[:-2], K, L - 1))
    new_state = u[..., :, M - (L - 1):] if L > 1 else state
    # rows[m, k]: state rows first (V-history), then the block's rows
    rows_u = IQ(
        jnp.swapaxes(u.re, -1, -2), jnp.swapaxes(u.im, -1, -2)
    )
    rows_s = IQ(
        jnp.swapaxes(state.re, -1, -2), jnp.swapaxes(state.im, -1, -2)
    )
    rows = cplx.concatenate([rows_s, rows_u], axis=-2)  # [..., M+L-1, K]
    G = group or next(g for g in (8, 4, 2, 1) if M % g == 0)
    if M % G:
        raise ValueError(f"group={G} must divide M={M}")
    Z = IQ(
        _grouped_rows(rows.re, K, taps_per_phase, G),
        _grouped_rows(rows.im, K, taps_per_phase, G),
    )
    wsr, wsi = _fir_dft_syn_matrix(K, taps_per_phase, G)
    x = cplx.matmul(Z, IQ(jnp.asarray(wsr), jnp.asarray(wsi)))
    x = x.reshape(*u.shape[:-2], M * K)
    return x, new_state


def channelize(
    x,
    K: int,
    taps_per_phase: int = 8,
    state: IQ | None = None,
    group: int | None = None,
) -> tuple[IQ, IQ]:
    """Split wideband IQ [..., T] (T % K == 0) into K channels.

    Returns (y, new_state):
      y          IQ [..., K, T//K] channel-k baseband at rate fs/K
      new_state  IQ [..., taps_per_phase*K - 1] tail samples to prepend to
                 the next block (streaming continuity; pass as `state`)

    With state=None the filter history starts at zero (first block).
    `group` sets G, the outputs per matmul row (default: the largest of
    8, 4, 2, 1 that divides T//K).
    """
    x = cplx.as_iq(x)
    T = x.shape[-1]
    if T % K:
        raise ValueError(f"block length {T} not divisible by K={K}")
    L = taps_per_phase
    hist = L * K - 1  # filter length minus one
    if state is None:
        state = cplx.zeros((*x.shape[:-1], hist))
    xp = cplx.concatenate([state, x], axis=-1)  # [..., hist + T]
    new_state = xp[..., -hist:]

    M = T // K
    # flipped commutator: Xrev[r, p] = xp[rK + (K-1-p)] = x[rK - p - hist_adj]
    rows = M + L - 1
    Xc = xp[..., : rows * K].reshape(*x.shape[:-1], rows, K)
    Xrev = IQ(jnp.flip(Xc.re, axis=-1), jnp.flip(Xc.im, axis=-1))

    # FIR + IDFT as ONE wide contraction:
    #   y[m, k] = sum_{l,p} Xrev[m+(L-1)-l, p] * H[l, p] * W[p, k]
    # Group G consecutive outputs per row: ZB[q, (r, p)] = Xrev[Gq+r, p]
    # (r < L+G-1), times the block-Toeplitz WB of _fir_idft_matrix, gives
    # y[Gq+j, k] directly — one matmul with an (L+G-1)K contraction and a
    # G*K-wide result does the entire filterbank.
    G = group or next(g for g in (8, 4, 2, 1) if M % g == 0)
    if M % G:
        raise ValueError(f"group={G} must divide M={M}")
    Z = IQ(
        _grouped_rows(Xrev.re, K, L, G),
        _grouped_rows(Xrev.im, K, L, G),
    )
    wbr, wbi = _fir_idft_matrix(K, taps_per_phase, G)
    y = cplx.matmul(Z, IQ(jnp.asarray(wbr), jnp.asarray(wbi)))
    y = y.reshape(*x.shape[:-1], M, K)
    # [..., M, K] -> [..., K, M]
    y = IQ(jnp.swapaxes(y.re, -1, -2), jnp.swapaxes(y.im, -1, -2))
    return y, new_state


def synthesize_tone(T: int, freq_cycles_per_sample: float, ampl: float = 1.0) -> IQ:
    """Test helper: complex exponential e^{2 pi i f n} (host-built)."""
    n = np.arange(T)
    ang = 2 * np.pi * freq_cycles_per_sample * n
    return IQ(
        jnp.asarray(ampl * np.cos(ang), jnp.float32),
        jnp.asarray(ampl * np.sin(ang), jnp.float32),
    )


def upconvert(x, K: int, channel: int, T_out: int | None = None) -> IQ:
    """Test/TX helper: place narrowband IQ [..., M] onto wideband channel
    `channel` of a K-channel grid by zero-stuffing, lowpass interpolation
    with the same prototype, and mixing to +channel/K.

    A real TX combiner would use the synthesis filterbank; this direct
    form is O(K L) per output sample and meant for test vectors and small
    banks.
    """
    x = cplx.as_iq(x)
    M = x.shape[-1]
    T = M * K if T_out is None else T_out
    # zero-stuff: w[nK] = x[n]
    z = cplx.zeros((*x.shape[:-1], M, K))
    z = IQ(
        z.re.at[..., :, 0].set(x.re),
        z.im.at[..., :, 0].set(x.im),
    ).reshape(*x.shape[:-1], M * K)
    # interpolate: convolution with K * prototype (unit passband gain)
    h = prototype(K) * K
    L = h.shape[0]
    zp = cplx.pad(z, [(0, 0)] * (x.ndim - 1) + [(L - 1, L - 1)])
    out = cplx.zeros((*x.shape[:-1], M * K + L - 1))
    for t in range(L):
        sl = zp[..., L - 1 - t : L - 1 - t + M * K + L - 1]
        out = IQ(out.re + h[t] * sl.re, out.im + h[t] * sl.im)
    delay = (L - 1) // 2
    out = out[..., delay : delay + T]
    # mix to channel center +channel/K
    n = np.arange(out.shape[-1])
    ang = 2 * np.pi * channel / K * n
    mix = IQ(
        jnp.asarray(np.cos(ang), jnp.float32),
        jnp.asarray(np.sin(ang), jnp.float32),
    )
    return cplx.mul(out, cplx.broadcast_to(mix, out.shape))
