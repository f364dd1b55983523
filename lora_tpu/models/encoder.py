"""Batched LoRa encoder: payload bytes -> modulation symbols.

Behavioral parity with the reference encoder pipeline
(/root/reference/LoRaEncoder.cpp:161-232): optional CRC16 appended
little-endian, optional explicit header as 5 Hamming(8,4) codewords, first
interleaver block always rate 4/8, codeword whitening that skips the header
codewords and keeps a running stream offset, diagonal interleaving, Gray
*decode* (grayToBinary) plus LSB padding for reduced symbol sets.

Batched formulation: one packet is one row; the whole pipeline is pure
array ops with static shapes derived from (config, payload_len), so a batch
of B packets encodes as a single fused XLA program and vmaps/shard_maps over
channel banks.  One deliberate divergence: padding nibbles beyond the
payload encode zeros, where the reference encodes uninitialized memory
(LoRaEncoder.cpp reads past the byte vector); decoded payloads are
byte-identical either way.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import LoRaConfig, HEADER_RDD, N_HEADER_CODEWORDS, N_HEADER_SYMBOLS
from ..ops import codes


def _bytes_to_nibbles(data: jax.Array, n_nibbles: int) -> jax.Array:
    """data int32 [..., L] -> nibble stream [..., n_nibbles]; even stream
    positions take the low nibble (LoRaEncoder.cpp:132-158)."""
    n_bytes_needed = (n_nibbles + 1) // 2
    pad = n_bytes_needed - data.shape[-1]
    if pad > 0:
        data = jnp.pad(data, [(0, 0)] * (data.ndim - 1) + [(0, pad)])
    lo = data & 0xF
    hi = (data >> 4) & 0xF
    nibbles = jnp.stack([lo, hi], axis=-1).reshape(*data.shape[:-1], -1)
    return nibbles[..., :n_nibbles]


@functools.partial(jax.jit, static_argnames=("cfg", "payload_len"))
def encode(payload: jax.Array, cfg: LoRaConfig, payload_len: int | None = None):
    """Encode packets.

    payload: uint8/int32 [B, L] (or [L]) payload bytes.
    Returns uint16 [B, S] modulation symbols, S = cfg.num_symbols(L).
    """
    if payload_len is None:
        payload_len = payload.shape[-1]
    squeeze = payload.ndim == 1
    # payload_len is static: bytes beyond it take no part in the frame
    # (CRC, header length, and nibble stream all agree on payload_len)
    data = jnp.atleast_2d(payload).astype(jnp.int32)[..., :payload_len]
    ppm, rdd, sf = cfg.PPM, cfg.rdd, cfg.sf

    if cfg.crc:
        crc = codes.sx1272_data_checksum(data)
        data = jnp.concatenate(
            [data, (crc & 0xFF)[..., None], ((crc >> 8) & 0xFF)[..., None]], axis=-1
        )

    ncw = cfg.num_codewords(payload_len)
    start = N_HEADER_CODEWORDS if cfg.explicit_header else 0
    n_payload_nibbles = ncw - start
    nibbles = _bytes_to_nibbles(data, n_payload_nibbles)

    # FEC: first block payload nibbles always Hamming(8,4); rest at cfg rate
    # (LoRaEncoder.cpp:202-213).
    n_first = ppm - start
    cw_first = codes.fec_encode(nibbles[..., :n_first], HEADER_RDD)
    cw_rest = codes.fec_encode(nibbles[..., n_first:], rdd)

    if cfg.whitening:
        cw_first = codes.whiten(cw_first, 0, HEADER_RDD)
        if ncw > ppm:
            cw_rest = codes.whiten(cw_rest, ppm - start, rdd)

    if cfg.explicit_header:
        hdr0 = jnp.full(data.shape[:-1], payload_len, jnp.int32)
        hdr1 = jnp.full(data.shape[:-1], (1 if cfg.crc else 0) | (rdd << 1), jnp.int32)
        hdr2 = codes.header_checksum(hdr0, hdr1)
        hdr_cw = codes.fec_encode(
            jnp.stack(
                [hdr0 >> 4, hdr0 & 0xF, hdr1 & 0xF, hdr2 >> 4, hdr2 & 0xF], axis=-1
            ),
            HEADER_RDD,
        )
        block0 = jnp.concatenate([hdr_cw, cw_first], axis=-1)
    else:
        block0 = cw_first

    # Diagonal interleave: header block at rate 4/8, payload blocks at cfg
    # rate (LoRaEncoder.cpp:216-220).
    sym0 = codes.interleave(block0, ppm, HEADER_RDD)
    if ncw > ppm:
        sym_rest = codes.interleave(cw_rest, ppm, rdd)
        symbols = jnp.concatenate([sym0, sym_rest], axis=-1)
    else:
        symbols = sym0

    # Gray decode + LSB padding for reduced symbol sets (LoRaEncoder.cpp:222-226).
    symbols = codes.gray_to_binary(symbols) << (sf - ppm)
    symbols = symbols.astype(jnp.uint16)
    return symbols[0] if squeeze else symbols
