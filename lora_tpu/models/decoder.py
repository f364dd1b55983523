"""Batched LoRa decoder: modulation symbols -> payload bytes.

Behavioral parity with the reference decoder pipeline
(/root/reference/LoRaDecoder.cpp:196-397): Gray encode with half-LSB
rounding for reduced symbol sets, diagonal deinterleave (header block at
rate 4/8), LFSR dewhitening with the running stream offset, explicit-header
decode (payload length / CRC-present / header-announced coding rate), FEC
decode with the rate announced by the header, CRC16 verify + unmask, and
the reference's drop taxonomy.

Batched formulation: the deinterleave/dewhiten/LUT-decode pipeline is
static-shape; only two things are data-dependent and both stay inside the
traced program: the header-announced coding rate (a 5-way LUT row select)
and the payload length (masks + gathers).  A batch of B packets decodes as
one XLA program; drops become per-packet status codes reduced across the
mesh instead of a mutable counter + signal.

Preserved reference quirks (documented, deliberately kept for parity):
  - the decoder's whitening flag is never consulted: dewhitening is
    unconditional inside the interleaving branch (LoRaDecoder.cpp:410 vs
    225-255);
  - the header checksum is XORed into byte 2 but never verified
    (LoRaDecoder.cpp:291);
  - in explicit mode without payload CRC, the output length is
    packetLength-2 (`dataLength -= 5` after `packetLength+3`,
    LoRaDecoder.cpp:300,375-378).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..config import LoRaConfig, HEADER_RDD, N_HEADER_CODEWORDS, N_HEADER_SYMBOLS
from ..ops import codes

# Drop taxonomy (SURVEY.md §5 failure detection): per-packet status codes.
OK = 0
DROP_HEADER_FEC = 1   # header Hamming error w/ error_check  (LoRaDecoder.cpp:293)
DROP_HEADER_RDD = 2   # announced rate > 4/8                 (LoRaDecoder.cpp:297)
DROP_LENGTH = 3       # announced length overflows block     (LoRaDecoder.cpp:313)
DROP_FEC = 4          # payload FEC error w/ error_check     (LoRaDecoder.cpp:342,363)
DROP_CRC = 5          # payload CRC mismatch w/ crc_check    (LoRaDecoder.cpp:371,384)
SOFT_UNVERIFIED = 6   # soft path only: decoded "cleanly" but carries no
#                       payload CRC and the hard-decision decode disagrees
#                       — ML selection always emits a valid codeword, so
#                       FEC drops cannot fire on the soft path
#                       (models/softdec caveat); this status is the guard

STATUS_NAMES = {
    OK: "ok",
    DROP_HEADER_FEC: "drop_header_fec",
    DROP_HEADER_RDD: "drop_header_rdd",
    DROP_LENGTH: "drop_length",
    DROP_FEC: "drop_fec",
    DROP_CRC: "drop_crc",
    SOFT_UNVERIFIED: "soft_unverified",
}


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DecodeResult:
    """Per-packet decode outputs (leading axes = batch)."""

    data: jax.Array      # uint8 [..., max_bytes] decoded bytes (header at 0)
    offset: jax.Array    # int32 [...] first output byte (3 in explicit w/o hdr)
    length: jax.Array    # int32 [...] output byte count
    status: jax.Array    # int32 [...] OK or DROP_* code
    packet_length: jax.Array  # int32 [...] payload length (hdr or config)
    rdd: jax.Array       # int32 [...] coding rate used for the payload
    crc_present: jax.Array    # bool [...]
    fec_errors: jax.Array     # int32 [...] corrected/detected FEC error count
    bad: jax.Array       # int32 [...] uncorrectable Hamming84 codeword count


def _masked_crc16(data: jax.Array, length: jax.Array) -> jax.Array:
    """sx1272 CRC16 over data[..., :length] with traced per-lane length."""
    data = jnp.moveaxis(data, -1, 0).astype(jnp.int32)  # (L, ...)
    res0 = jnp.zeros(data.shape[1:], jnp.int32)
    v0 = jnp.full(data.shape[1:], 0xFF, jnp.int32)

    def step(carry, x):
        res, v, i = carry
        byte = x
        crc = codes._crc16_shift8(res)
        v_n = (codes._xsum8(v & 0xB8) | (v << 1)) & 0xFF
        res_n = crc ^ byte
        active = i < length
        res = jnp.where(active, res_n, res)
        v = jnp.where(active, v_n, v)
        return (res, v, i + 1), None

    (res, v, _), _ = jax.lax.scan(step, (res0, v0, jnp.zeros((), jnp.int32)), data)
    res = res ^ v
    v = (codes._xsum8(v & 0xB8) | (v << 1)) & 0xFF
    res = res ^ (v << 8)
    return res & 0xFFFF


@functools.partial(jax.jit, static_argnames=("cfg", "num_symbols"))
@jax.named_scope("decode")
def decode(symbols: jax.Array, cfg: LoRaConfig, num_symbols: int | None = None):
    """Decode packets.

    symbols: int [B, S] (or [S]) demodulated symbol values.
    Returns a :class:`DecodeResult` (or, with cfg.interleaving=False, the
    Gray-mapped symbols passthrough, matching LoRaDecoder.cpp:264-270).
    """
    if num_symbols is None:
        num_symbols = symbols.shape[-1]
    squeeze = symbols.ndim == 1
    sym = jnp.atleast_2d(symbols).astype(jnp.int32)
    ppm, cfg_rdd, sf = cfg.PPM, cfg.rdd, cfg.sf

    # Gray encode with half-LSB rounding (LoRaDecoder.cpp:217-222).
    half = (1 << (sf - ppm)) // 2
    sym = codes.binary_to_gray((sym + half) >> (sf - ppm))

    if not cfg.interleaving:
        out = sym.astype(jnp.uint16)
        return out[0] if squeeze else out

    # Pad to whole payload blocks with zero symbols (the reference zero-fills
    # its rounded-up symbol vector, LoRaDecoder.cpp:210-213).
    nsym = ((num_symbols + (4 + cfg_rdd) - 1) // (4 + cfg_rdd)) * (4 + cfg_rdd)
    sym = jnp.pad(sym, [(0, 0)] * (sym.ndim - 1) + [(0, nsym - num_symbols)])
    ncw = (nsym // (4 + cfg_rdd)) * ppm

    # Deinterleave + dewhiten.  The header block is rate 4/8; payload blocks
    # use the *configured* rate (the header-announced rate feeds only the
    # FEC decode stage, LoRaDecoder.cpp:225-255 vs 296).
    start = N_HEADER_CODEWORDS if cfg.explicit_header else 0
    if cfg_rdd != HEADER_RDD:
        cw0 = codes.deinterleave(sym[..., :N_HEADER_SYMBOLS], ppm, HEADER_RDD)
        cw0 = jnp.concatenate(
            [cw0[..., :start], codes.whiten(cw0[..., start:], 0, HEADER_RDD)],
            axis=-1,
        )
        # The reference sizes its codeword buffer as numSymbols/(4+rdd)*PPM,
        # which over-counts the 8-symbol header block at rates != 4/8, and
        # zero-fills the tail BEFORE dewhitening (LoRaDecoder.cpp:211,224,
        # 243) — so the tail decodes as the raw whitening stream, not as
        # zeros.  Reproduce that: pad the deinterleaved codewords first,
        # then dewhiten the whole payload span.
        if nsym > N_HEADER_SYMBOLS:
            cwr = codes.deinterleave(sym[..., N_HEADER_SYMBOLS:], ppm, cfg_rdd)
        else:
            cwr = sym[..., :0]
        tail = ncw - ppm - cwr.shape[-1]
        if tail > 0:
            cwr = jnp.pad(cwr, [(0, 0)] * (cwr.ndim - 1) + [(0, tail)])
        cwr = codes.whiten(cwr, ppm - start, cfg_rdd)
        codewords = jnp.concatenate([cw0, cwr], axis=-1)
    else:
        codewords = codes.deinterleave(sym, ppm, cfg_rdd)
        codewords = jnp.concatenate(
            [
                codewords[..., :start],
                codes.whiten(codewords[..., start:], 0, cfg_rdd),
            ],
            axis=-1,
        )

    batch_shape = codewords.shape[:-1]
    max_bytes = (ncw + 1) // 2
    zeros = jnp.zeros(batch_shape, jnp.int32)

    # ---- explicit header decode (LoRaDecoder.cpp:282-303) -----------------
    if cfg.explicit_header:
        h_nib, h_err, h_bad = codes.fec_decode(codewords[..., :5], HEADER_RDD)
        b0 = (h_nib[..., 0] << 4) | h_nib[..., 1]      # payload length
        b1 = h_nib[..., 2]                              # crc flag | rdd<<1
        b2 = (h_nib[..., 3] << 4) | h_nib[..., 4]      # header checksum
        b2 = b2 ^ codes.header_checksum(b0, b1)        # never verified (quirk)
        hdr_error = jnp.any(h_err > 0, axis=-1)
        hdr_bad = jnp.sum(h_bad, axis=-1)
        crc_present = (b1 & 1) == 1
        rdd = (b1 >> 1) & 0x7
        packet_length = b0
        data_length = packet_length + jnp.where(crc_present, 5, 3)
        d_ofs0 = 6
    else:
        b0 = jnp.full(batch_shape, cfg.data_length, jnp.int32)
        b1 = zeros
        b2 = zeros
        hdr_error = jnp.zeros(batch_shape, bool)
        hdr_bad = zeros
        crc_present = jnp.full(batch_shape, cfg.crc_check, bool)
        rdd = jnp.full(batch_shape, cfg_rdd, jnp.int32)
        packet_length = b0
        data_length = packet_length + (2 if cfg.crc_check else 0)
        d_ofs0 = 0

    check_crc = jnp.logical_and(cfg.crc_check, crc_present) if cfg.explicit_header \
        else jnp.full(batch_shape, cfg.crc_check, bool)

    # ---- payload FEC decode (LoRaDecoder.cpp:315-361) ----------------------
    pay_cw = codewords[..., start:]
    n_pay = ncw - start
    n0 = ppm - start  # first loop: header-block codewords, always Hamming84
    nib84, err84, bad84 = codes.fec_decode(pay_cw, HEADER_RDD)
    nib_dyn, err_dyn, bad_dyn = codes.fec_decode(pay_cw, rdd[..., None])
    j = jnp.arange(n_pay, dtype=jnp.int32)
    in_first = j < n0
    nib = jnp.where(in_first, nib84, nib_dyn)
    err = jnp.where(in_first, err84, err_dyn)

    # Error accumulation mask mirrors the reference's loop bounds: all of the
    # first block, the odd-nibble straggler, then 2 codewords per byte up to
    # dataLength (LoRaDecoder.cpp:315-361).
    has_straggler = (d_ofs0 + n0) % 2 == 1
    n1 = n0 + (1 if has_straggler else 0)
    pair_nibbles = 2 * jnp.maximum(
        data_length[..., None] - ((d_ofs0 + n1) // 2), 0
    )
    err_mask = in_first | (
        (j >= n1) & (j < n1 + pair_nibbles)
    )
    if has_straggler:
        err_mask = err_mask | (j == n0)
    fec_error = jnp.any((err > 0) & err_mask, axis=-1)
    fec_errors = jnp.sum(err * err_mask, axis=-1)
    # uncorrectable (double-bit) counts exist only for Hamming(8,4): the
    # always-4/8 first block plus payload codewords when the header
    # announces rate 4/8 (LoRaDecoder.cpp:330,355)
    bad = jnp.where(in_first, bad84, jnp.where(rdd[..., None] == 4, bad_dyn, 0))
    bad_count = hdr_bad + jnp.sum(bad * err_mask, axis=-1)

    # ---- byte assembly ------------------------------------------------------
    # nibble j lands at stream position d_ofs0 + j; even positions are low
    # nibbles.  The 3 header bytes occupy positions 0..5 in explicit mode.
    if d_ofs0 % 2 != 0:
        raise AssertionError("header nibble offset must be even")
    pad_to_even = (-n_pay) % 2
    nib_p = jnp.pad(nib, [(0, 0)] * (nib.ndim - 1) + [(0, pad_to_even)])
    pairs = nib_p.reshape(*batch_shape, -1, 2)
    pay_bytes = pairs[..., 0] | (pairs[..., 1] << 4)
    if cfg.explicit_header:
        head = jnp.stack([b0, b1, b2], axis=-1)
        all_bytes = jnp.concatenate([head, pay_bytes], axis=-1)
    else:
        all_bytes = pay_bytes
    all_bytes = all_bytes[..., :max_bytes]
    nbytes = all_bytes.shape[-1]

    # ---- CRC verify + unmask (LoRaDecoder.cpp:367-388) ----------------------
    crc_start = 3 if cfg.explicit_header else 0
    idx = jnp.arange(nbytes, dtype=jnp.int32)
    pl = packet_length[..., None]
    in_payload = (idx >= crc_start) & (idx < crc_start + pl)
    crc_input = jnp.where(in_payload, all_bytes, 0)
    # shift payload to start of lane: roll by -crc_start (static)
    crc_input = jnp.roll(crc_input, -crc_start, axis=-1)
    crc = _masked_crc16(crc_input, packet_length)

    crc_lo_pos = crc_start + packet_length
    crc_hi_pos = crc_lo_pos + 1
    pkt_crc = (
        jnp.take_along_axis(all_bytes, crc_lo_pos[..., None] % nbytes, axis=-1)[..., 0]
        | (
            jnp.take_along_axis(all_bytes, crc_hi_pos[..., None] % nbytes, axis=-1)[
                ..., 0
            ]
            << 8
        )
    )
    crc_mismatch = pkt_crc != crc
    do_unmask = crc_present if cfg.explicit_header else check_crc
    unmask = (
        jnp.where(idx == crc_lo_pos[..., None], crc[..., None] & 0xFF, 0)
        | jnp.where(idx == crc_hi_pos[..., None], (crc[..., None] >> 8) & 0xFF, 0)
    )
    all_bytes = jnp.where(do_unmask[..., None], all_bytes ^ unmask, all_bytes)

    # ---- status / output framing -------------------------------------------
    status = jnp.full(batch_shape, OK, jnp.int32)

    def set_status(status, cond, code):
        return jnp.where((status == OK) & cond, code, status)

    if cfg.explicit_header:
        if cfg.error_check:
            status = set_status(status, hdr_error, DROP_HEADER_FEC)
        status = set_status(status, rdd > 4, DROP_HEADER_RDD)
    status = set_status(status, data_length > nbytes, DROP_LENGTH)
    if cfg.error_check:
        status = set_status(status, fec_error, DROP_FEC)
    status = set_status(status, check_crc & crc_mismatch, DROP_CRC)

    if cfg.explicit_header and not cfg.hdr:
        offset = jnp.full(batch_shape, 3, jnp.int32)
        out_length = data_length - 5  # reference quirk: -5 even without CRC
    else:
        offset = zeros
        out_length = data_length

    result = DecodeResult(
        data=all_bytes.astype(jnp.uint8),
        offset=offset,
        length=out_length,
        status=status,
        packet_length=packet_length,
        rdd=rdd,
        crc_present=crc_present,
        fec_errors=fec_errors,
        bad=bad_count,
    )
    if squeeze:
        result = jax.tree.map(lambda x: x[0], result)
    return result
