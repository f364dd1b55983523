"""Soft-decision decoding: FFT spectra -> ML codewords -> payload bytes.

A capability the reference does not have (its decoder consumes hard symbol
values only, LoRaDecoder.cpp:196-222; the demod's per-bin powers are
discarded after the argmax, LoRaDetector.hpp:29-64).  The demodulator's
debug spectra (`demodulate(debug=True).fft_mag2`, the reference's `fft`
tap) carry the full per-bin evidence — this module uses it:

  1. *Word metrics*: each Gray-mapped PPM-bit word w gets the max |FFT|^2
     over the bins that hard-decode to it (the max-log approximation of
     the CSS symbol likelihood).
  2. *Bit LLRs*: L_k = max_{w: bit k = 1} M_w - max_{w: bit k = 0} M_w,
     per symbol, via hypercube reductions over the 2^ppm word metrics.
  3. *Diagonal deinterleave of the LLR tensor* (the same static gather as
     ops/codes.deinterleave, applied to bit beliefs instead of bits).
  4. *ML codeword selection*: for each codeword slot, score the 16 valid
     candidates `enc(nibble) ^ whitening_stream` against the LLRs and
     keep the best — exact maximum-likelihood decoding of the Hamming /
     parity block codes (vs the reference's bounded-distance LUT, which
     corrects at most 1 bit and only for Hamming).
  5. *Reconstruction*: the corrected codewords re-interleave into clean
     symbol values that feed the ordinary bit-exact decoder
     (models/decoder.decode) for header / CRC / drop-status handling —
     the hard pipeline is reused unchanged downstream.

Gain: ~1-2 dB of payload sensitivity in the FEC-limited regime (measured
head-to-head in tools/bench_sensitivity.py --soft; the win over the
reference demod grows accordingly at SF12 where payload errors, not sync,
dominate).

Caveat — detection vs correction: ML selection always returns a VALID
codeword, so the FEC-based drop signals (DROP_HEADER_FEC / DROP_FEC,
`fec_errors`) cannot fire on the soft path; false-positive rejection
rests on the payload CRC.  In deep noise a corrupted header can decode
to crc_present=0 and report a clean status over garbage bytes — the hard
path has the same avenue (>= 3 header bit errors defeat Hamming(8,4)
detection too), soft decoding just reaches it at lower SNR.  Deployments
that ride the soft path below the hard threshold should require
CRC-bearing frames and treat no-CRC statuses as suspect.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    LoRaConfig,
    HEADER_RDD,
    N_HEADER_CODEWORDS,
    N_HEADER_SYMBOLS,
)
from ..ops import codes
from .decoder import DecodeResult, decode


@functools.lru_cache(maxsize=None)
def _bin_word_gather(sf: int, ppm: int) -> np.ndarray:
    """IDX[w, j] = bins whose hard decode is word w (padded by repetition;
    max over the row == max over the true bin set).  Identity-permutation
    case (ppm == sf) degenerates to one bin per word."""
    N = 1 << sf
    shift = sf - ppm
    half = (1 << shift) // 2
    v = np.arange(N)
    q = (v + half) >> shift
    w = (q ^ (q >> 1)) & ((1 << ppm) - 1)  # binary_to_gray, ppm bits
    groups = [np.nonzero(w == ww)[0] for ww in range(1 << ppm)]
    width = max(len(g) for g in groups)
    idx = np.stack([np.pad(g, (0, width - len(g)), mode="edge") for g in groups])
    return idx.astype(np.int32)


def _word_metrics(mag2: jax.Array, cfg: LoRaConfig) -> jax.Array:
    """|FFT|^2 windows [..., N] -> word metrics [..., 2^ppm]."""
    idx = _bin_word_gather(cfg.sf, cfg.PPM)
    if idx.shape[1] == 1:  # ppm == sf: pure permutation
        return mag2[..., jnp.asarray(idx[:, 0])]
    return jnp.max(mag2[..., jnp.asarray(idx)], axis=-1)


def _bit_llrs(metrics: jax.Array, ppm: int) -> jax.Array:
    """Word metrics [..., 2^ppm] -> per-bit LLRs [..., ppm] (max-log)."""
    lead = metrics.shape[:-1]
    cube = metrics.reshape(*lead, *([2] * ppm))  # axis i = bit ppm-1-i
    llrs = []
    for k in range(ppm):
        ax = tuple(
            len(lead) + i for i in range(ppm) if i != ppm - 1 - k
        )
        pair = jnp.max(cube, axis=ax)  # [..., 2] = (bit k = 0, bit k = 1)
        llrs.append(pair[..., 1] - pair[..., 0])
    return jnp.stack(llrs, axis=-1)


def _deinterleave_llrs(
    llr: jax.Array, ppm: int, rdd: int
) -> jax.Array:
    """LLRs [..., nsym, ppm] -> codeword-bit LLRs [..., nblocks*ppm, 4+rdd]
    (the diagonal gather of ops/codes.deinterleave applied to beliefs)."""
    nbits = 4 + rdd
    *lead, nsym, _ = llr.shape
    nblocks = nsym // nbits
    lb = llr[..., : nblocks * nbits, :].reshape(*lead, nblocks, nbits, ppm)
    i = np.arange(ppm)[:, None]
    k = np.arange(nbits)[None, :]
    m_idx = jnp.asarray(((i - k) % ppm).astype(np.int32))  # (ppm, nbits)
    karr = jnp.broadcast_to(
        jnp.arange(nbits, dtype=jnp.int32)[None, :], m_idx.shape
    )
    cw = lb[..., karr, m_idx]  # [..., nblocks, ppm, nbits]
    return cw.reshape(*lead, nblocks * ppm, nbits)


def _ml_codewords(llr: jax.Array, stream: jax.Array, rdd: int) -> jax.Array:
    """Exact ML over the 16 valid codewords.

    llr: [..., n, 4+rdd] deinterleaved bit LLRs (pre-whitening domain);
    stream: int32 [n] whitening values the decoder will XOR onto each slot
    (0 where unwhitened).  Candidate nibble m appears on air as
    enc(m) ^ stream, so score_m = sum_b sign(bit_b) * llr_b.  Returns the
    winning PRE-whitening codewords int32 [..., n] (decode()'s whiten pass
    maps them back onto enc(m))."""
    nbits = 4 + rdd
    cand = jnp.asarray(codes.ENC_LUTS[rdd])  # [16]
    patt = cand[None, :] ^ stream[:, None]  # [n, 16]
    bits = (patt[..., None] >> jnp.arange(nbits)) & 1  # [n, 16, nbits]
    sgn = (2 * bits - 1).astype(llr.dtype)
    # float32 products: TF32 rounding could flip near-tied ML choices
    score = jnp.einsum(
        "...nb,nmb->...nm", llr, sgn, precision=jax.lax.Precision.HIGHEST
    )
    best = jnp.argmax(score, axis=-1)  # [..., n]
    top = jnp.max(score, axis=-1)
    second = jnp.max(
        jnp.where(
            jnp.arange(score.shape[-1]) == best[..., None], -jnp.inf, score
        ),
        axis=-1,
    )
    margin = top - second  # [..., n] ML decision margin per codeword
    slot = jnp.arange(patt.shape[0], dtype=jnp.int32)
    return patt[slot, best], margin  # slot [n] broadcasts against best


@functools.partial(jax.jit, static_argnames=("cfg", "num_symbols"))
@jax.named_scope("soft_decode")
def soft_symbols(
    mag2: jax.Array, cfg: LoRaConfig, num_symbols: int | None = None
) -> tuple[jax.Array, jax.Array]:
    """FFT spectra [..., S, N] -> (symbols [..., S'], margin [...]).

    S' covers whole interleaver blocks (decode() pads identically).  The
    returned symbols carry the ML-corrected codewords; feeding them to
    models/decoder.decode reproduces the entire reference pipeline
    (header quirks, CRC, drop taxonomy) on the cleaned stream.  `margin`
    is the per-frame confidence: the minimum ML decision margin
    (best-score minus runner-up) across the FIRST interleaver block's
    codewords — the header (payload length / CRC flag / rate) plus the
    first payload nibbles, exactly the fields whose silent corruption the
    module-docstring caveat warns about.  Later blocks are CRC-covered
    and excluded so mtu-padding tail slots (score ties of exactly 0)
    cannot mask the signal."""
    ppm, rdd, sf = cfg.PPM, cfg.rdd, cfg.sf
    if num_symbols is None:
        num_symbols = mag2.shape[-2]
    if not cfg.interleaving:
        raise ValueError("soft decoding requires interleaving mode")
    metrics = _word_metrics(mag2, cfg)
    llr = _bit_llrs(metrics, ppm)  # [..., S, ppm]
    nsym = ((num_symbols + (4 + rdd) - 1) // (4 + rdd)) * (4 + rdd)
    pad = nsym - llr.shape[-2]
    if pad > 0:
        llr = jnp.pad(llr, [(0, 0)] * (llr.ndim - 2) + [(0, pad), (0, 0)])
    elif pad < 0:
        llr = llr[..., :nsym, :]

    start = N_HEADER_CODEWORDS if cfg.explicit_header else 0
    lead = llr.shape[:-2]
    if rdd != HEADER_RDD:
        # mixed-rate frame: 8-symbol header block at 4/8, rest at cfg rate
        # (mirrors decode()'s split and whitening offsets)
        l0 = _deinterleave_llrs(llr[..., :N_HEADER_SYMBOLS, :], ppm, HEADER_RDD)
        s0 = jnp.concatenate(
            [
                jnp.zeros(start, jnp.int32),
                jnp.asarray(codes.WHITEN_SEQ[0, : ppm - start])
                & ((1 << (4 + HEADER_RDD)) - 1),
            ]
        )
        cw0, m0 = _ml_codewords(l0, s0, HEADER_RDD)
        lr = _deinterleave_llrs(llr[..., N_HEADER_SYMBOLS:, :], ppm, rdd)
        n_r = lr.shape[-2]
        mode = 1 if rdd == 1 else 0
        sr = jnp.asarray(
            codes.WHITEN_SEQ[mode, ppm - start : ppm - start + n_r]
        ) & ((1 << (4 + rdd)) - 1)
        cwr, mr = _ml_codewords(lr, sr, rdd)
        sym0 = codes.interleave(cw0, ppm, HEADER_RDD)
        symr = codes.interleave(cwr, ppm, rdd)
        words = jnp.concatenate([sym0, symr], axis=-1)
        margin = jnp.min(m0, axis=-1)  # first block: header + first nibbles
    else:
        lcw = _deinterleave_llrs(llr, ppm, rdd)
        n = lcw.shape[-2]
        mode = 1 if rdd == 1 else 0
        seq = jnp.asarray(codes.WHITEN_SEQ[mode, : n - start]) & (
            (1 << (4 + rdd)) - 1
        )
        stream = jnp.concatenate([jnp.zeros(start, jnp.int32), seq])
        # the header codewords (slots < start) are unwhitened but always
        # Hamming84 == cfg rate here (rdd == HEADER_RDD)
        cw, m = _ml_codewords(lcw, stream, rdd)
        words = codes.interleave(cw, ppm, rdd)
        margin = jnp.min(m[..., :ppm], axis=-1)  # first block only
    syms = (codes.gray_to_binary(words) << (sf - ppm)).astype(jnp.int32)
    return syms, margin


def decode_soft(
    mag2: jax.Array, cfg: LoRaConfig, num_symbols: int | None = None
) -> DecodeResult:
    """Soft-decision decode of demod spectra (demodulate(spectra=True)
    .fft_mag2) — ML codeword selection, then the ordinary bit-exact
    decoder on the corrected stream.  Use soft_symbols directly when the
    per-frame confidence margin is needed."""
    syms, _ = soft_symbols(mag2, cfg, num_symbols)
    return decode(syms, cfg)


def guard_soft_status(dec_soft: DecodeResult, dec_hard: DecodeResult):
    """Default false-positive policy for the soft path (the module
    docstring's caveat, operationalized): ML selection always returns a
    valid codeword, so a CRC-less frame whose header was corrupted below
    the hard threshold can soft-decode "cleanly" over garbage.  A soft OK
    is therefore only trusted when either (a) the frame carries a payload
    CRC (which did fire or didn't), or (b) the hard-decision decode of
    the same frame independently agrees — status OK with identical bytes
    (i.e. the frame is at/above the hard threshold and soft decoding
    changed nothing).  Everything else becomes SOFT_UNVERIFIED.

    Returns an int32 status array (host numpy) of dec_soft.status with
    the policy applied.  Used by StreamDemodulator(soft=True) and
    ChannelDispatcher(soft=True); callers wanting raw soft statuses can
    read dec_soft.status directly."""
    from .decoder import OK, SOFT_UNVERIFIED

    st = np.asarray(dec_soft.status).copy()
    crc = np.asarray(dec_soft.crc_present)
    sdata = np.asarray(dec_soft.data)
    hdata = np.asarray(dec_hard.data)
    hst = np.asarray(dec_hard.status)
    soff = np.asarray(dec_soft.offset)
    slen = np.asarray(dec_soft.length)
    hoff = np.asarray(dec_hard.offset)
    hlen = np.asarray(dec_hard.length)
    suspect = (st == OK) & ~crc
    for i in np.nonzero(suspect.reshape(-1))[0]:
        idx = np.unravel_index(i, st.shape)
        agree = (
            hst[idx] == OK
            and hlen[idx] == slen[idx]
            and np.array_equal(
                sdata[idx][soff[idx] : soff[idx] + slen[idx]],
                hdata[idx][hoff[idx] : hoff[idx] + hlen[idx]],
            )
        )
        if not agree:
            st[idx] = SOFT_UNVERIFIED
    return st
