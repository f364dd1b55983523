"""Vectorized bit-domain codecs (batched formulation).

Every codec of the reference's `LoRaCodes.hpp` is reformulated as an array
operation over int32 tensors so that thousands of packets encode/decode as a
single XLA program:

  - Hamming(8,4)/(7,4), parity(5,4)/(6,4): 16-entry encode LUTs and 256-entry
    decode LUTs gathered with `jnp.take` (result packs nibble|error<<4|bad<<5).
  - Gray mapping: xor-shift cascades on whole arrays.
  - Whitening: the dual interleaved 0x1D LFSR streams are precomputed once as
    numpy constants; application is a masked XOR with a static slice.
  - Diagonal interleaver: a static (bit-position) gather per (PPM, RDD).
  - CRC16: `lax.scan` over the (static) byte length, batched over packets.

Shapes: all functions take arrays whose leading axes are batch-like and whose
trailing axis is the codeword/nibble/byte stream; everything is static-shape.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import _bitref as ref

# ---------------------------------------------------------------------------
# LUT construction (host, import time)
# ---------------------------------------------------------------------------

ENC_LUTS = np.zeros((5, 16), np.int32)  # [rdd, nibble] -> codeword
for _n in range(16):
    ENC_LUTS[0, _n] = _n
    ENC_LUTS[1, _n] = ref.encode_parity54(_n)
    ENC_LUTS[2, _n] = ref.encode_parity64(_n)
    ENC_LUTS[3, _n] = ref.encode_hamming74(_n)
    ENC_LUTS[4, _n] = ref.encode_hamming84(_n)

# decode LUT packs: nibble | error << 4 | bad << 5
DEC_LUTS = np.zeros((5, 256), np.int32)
for _c in range(256):
    DEC_LUTS[0, _c] = _c & 0xF
    _v, _e = ref.check_parity54(_c & 0x1F)
    DEC_LUTS[1, _c] = _v | (int(_e) << 4)
    _v, _e = ref.check_parity64(_c & 0x3F)
    DEC_LUTS[2, _c] = _v | (int(_e) << 4)
    _v, _e = ref.decode_hamming74(_c & 0x7F)
    DEC_LUTS[3, _c] = _v | (int(_e) << 4)
    _v, _e, _b = ref.decode_hamming84(_c)
    DEC_LUTS[4, _c] = _v | (int(_e) << 4) | (int(_b) << 5)

# Whitening streams, precomputed long enough for the max frame:
# max payload 255 B (+2 CRC) -> <= 2*257+5+PPM codewords; 2048 is ample.
_WHITEN_LEN = 2048
WHITEN_SEQ = np.stack(
    [
        np.asarray(ref.whitening_sequence(_WHITEN_LEN, rdd1_mode=False), np.int32),
        np.asarray(ref.whitening_sequence(_WHITEN_LEN, rdd1_mode=True), np.int32),
    ]
)  # [mode, pos]


# ---------------------------------------------------------------------------
# Gray mapping
# ---------------------------------------------------------------------------

def binary_to_gray(x: jax.Array) -> jax.Array:
    return x ^ (x >> 1)


def gray_to_binary(x: jax.Array) -> jax.Array:
    x = x ^ (x >> 8)
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x


# ---------------------------------------------------------------------------
# FEC
# ---------------------------------------------------------------------------

def fec_encode(nibbles: jax.Array, rdd: int) -> jax.Array:
    """nibbles int32 [..., n] in [0,16) -> codewords int32."""
    return jnp.take(jnp.asarray(ENC_LUTS[rdd]), nibbles, axis=0)


def fec_decode(codewords: jax.Array, rdd) -> tuple[jax.Array, jax.Array, jax.Array]:
    """codewords int32 [..., n] -> (nibble, error, bad) arrays.

    `rdd` may be a traced scalar (header-announced coding rate,
    LoRaDecoder.cpp:296): the LUT row is selected dynamically.
    """
    if isinstance(rdd, int):
        packed = jnp.take(jnp.asarray(DEC_LUTS[rdd]), codewords, axis=0)
    else:
        # traced rdd (may be per-batch, broadcastable against codewords):
        # flat gather over the stacked LUTs
        flat = jnp.asarray(DEC_LUTS.reshape(-1))
        packed = jnp.take(flat, rdd * 256 + codewords, axis=0)
    return packed & 0xF, (packed >> 4) & 1, (packed >> 5) & 1


# ---------------------------------------------------------------------------
# Whitening
# ---------------------------------------------------------------------------

def whiten(codewords: jax.Array, bit_ofs: int, rdd) -> jax.Array:
    """XOR codewords [..., n] with the whitening stream starting at absolute
    position `bit_ofs` (static).  Masked to 4+rdd bits.  `rdd` may be traced
    (decoder path); the whitening *mode* (rdd==1 vs not) follows it.
    """
    n = codewords.shape[-1]
    seq = jnp.asarray(WHITEN_SEQ[:, bit_ofs : bit_ofs + n])  # (2, n)
    if isinstance(rdd, int):
        stream = seq[1 if rdd == 1 else 0]
        mask = (1 << (4 + rdd)) - 1
    else:
        stream = jnp.where(rdd == 1, seq[1], seq[0])
        mask = (1 << (4 + rdd)) - 1
    return codewords ^ (stream & mask)


# ---------------------------------------------------------------------------
# Diagonal interleaver
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _interleave_gather(ppm: int, rdd: int) -> np.ndarray:
    """idx[k, m] = (m + k) % ppm : symbol k takes bit k of codeword idx[k,m]
    into bit position m (LoRaCodes.hpp:348-360)."""
    k = np.arange(4 + rdd)[:, None]
    m = np.arange(ppm)[None, :]
    return ((m + k) % ppm).astype(np.int32)


def interleave(codewords: jax.Array, ppm: int, rdd: int) -> jax.Array:
    """codewords int32 [..., nblocks*ppm] -> symbols int32 [..., nblocks*(4+rdd)].

    Whole-block diagonal interleave; static permutation per (ppm, rdd).
    """
    nbits = 4 + rdd
    *lead, ncw = codewords.shape
    nblocks = ncw // ppm  # partial trailing blocks are ignored (reference loop)
    cw = codewords[..., : nblocks * ppm].reshape(*lead, nblocks, ppm)
    # bits[..., x, i, k] = bit k of codeword i of block x
    kk = jnp.arange(nbits, dtype=codewords.dtype)
    bits = (cw[..., :, :, None] >> kk) & 1  # [..., x, ppm, nbits]
    idx = jnp.asarray(_interleave_gather(ppm, rdd))  # (nbits, ppm)
    karr = jnp.broadcast_to(jnp.arange(nbits, dtype=jnp.int32)[:, None], idx.shape)
    # sym_bits[..., x, k, m] = bits[..., x, idx[k, m], k]
    sym_bits = bits[..., idx, karr]  # [..., x, nbits, ppm]
    weights = jnp.ones((), codewords.dtype) << jnp.arange(ppm, dtype=codewords.dtype)
    symbols = jnp.einsum("...km,m->...k", sym_bits, weights)
    return symbols.reshape(*lead, nblocks * nbits)


def deinterleave(symbols: jax.Array, ppm: int, rdd: int) -> jax.Array:
    """symbols int32 [..., nblocks*(4+rdd)] -> codewords int32 [..., nblocks*ppm].

    Inverse diagonal map (LoRaCodes.hpp:362-378): codeword i bit k equals
    symbol k bit m where i = (m + k) % ppm, i.e. m = (i - k) % ppm.
    """
    nbits = 4 + rdd
    *lead, nsym = symbols.shape
    nblocks = nsym // nbits  # partial trailing blocks are ignored (reference loop)
    sym = symbols[..., : nblocks * nbits].reshape(*lead, nblocks, nbits)
    mm = jnp.arange(ppm, dtype=symbols.dtype)
    sym_bits = (sym[..., :, :, None] >> mm) & 1  # [..., x, nbits(k), ppm(m)]
    i = np.arange(ppm)[:, None]
    k = np.arange(nbits)[None, :]
    m_idx = jnp.asarray(((i - k) % ppm).astype(np.int32))  # (ppm, nbits)
    karr = jnp.broadcast_to(jnp.arange(nbits, dtype=jnp.int32)[None, :], m_idx.shape)
    # cw_bits[..., x, i, k] = sym_bits[..., x, k, m_idx[i, k]]
    cw_bits = sym_bits[..., karr, m_idx]  # [..., x, ppm, nbits]
    weights = jnp.ones((), symbols.dtype) << jnp.arange(nbits, dtype=symbols.dtype)
    codewords = jnp.einsum("...ik,k->...i", cw_bits, weights)
    return codewords.reshape(*lead, nblocks * ppm)


# ---------------------------------------------------------------------------
# Header checksum / payload CRC16
# ---------------------------------------------------------------------------

def header_checksum(h0: jax.Array, h1: jax.Array) -> jax.Array:
    """Vectorized 5-bit header checksum (LoRaCodes.hpp:31-55)."""
    a = [(h0 >> (4 + i)) & 1 for i in range(4)]
    b = [(h0 >> i) & 1 for i in range(4)]
    c = [(h1 >> i) & 1 for i in range(4)]
    res = (a[0] ^ a[1] ^ a[2] ^ a[3]) << 4
    res |= (a[3] ^ b[1] ^ b[2] ^ b[3] ^ c[0]) << 3
    res |= (a[2] ^ b[0] ^ b[3] ^ c[1] ^ c[3]) << 2
    res |= (a[1] ^ b[0] ^ b[2] ^ c[0] ^ c[1] ^ c[2]) << 1
    res |= a[0] ^ b[1] ^ c[0] ^ c[1] ^ c[2] ^ c[3]
    return res


def _crc16_shift8(crc: jax.Array) -> jax.Array:
    """8 unrolled steps of the 0x1021 shift register over int32 lanes."""
    for _ in range(8):
        top = (crc >> 15) & 1
        crc = ((crc << 1) & 0xFFFF) ^ (top * 0x1021)
    return crc


def _xsum8(t: jax.Array) -> jax.Array:
    t = t ^ (t >> 4)
    t = t ^ (t >> 2)
    t = t ^ (t >> 1)
    return t & 1


def sx1272_data_checksum(data: jax.Array) -> jax.Array:
    """Batched SX1272 payload CRC16 (LoRaCodes.hpp:80-93).

    data: int32 [..., L] bytes; returns int32 [...] CRC.
    The scan runs over the static byte axis; all batch lanes advance together.
    """
    data = jnp.moveaxis(data, -1, 0)  # (L, ...)
    res0 = jnp.zeros(data.shape[1:], jnp.int32)
    v0 = jnp.full(data.shape[1:], 0xFF, jnp.int32)

    def step(carry, byte):
        res, v = carry
        crc = _crc16_shift8(res)
        v = (_xsum8(v & 0xB8) | (v << 1)) & 0xFF
        res = crc ^ byte
        return (res, v), None

    (res, v), _ = jax.lax.scan(step, (res0, v0), data.astype(jnp.int32))
    res = res ^ v
    v = (_xsum8(v & 0xB8) | (v << 1)) & 0xFF
    res = res ^ (v << 8)
    return res & 0xFFFF
