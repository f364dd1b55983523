"""Batched LoRa frame modulator: symbols -> complex baseband.

Frame structure on air (reference FSM order, LoRaMod.cpp:140-229):

    10 preamble upchirps | 2 sync-word upchirps (bin nibble*8) |
    2 downchirps | 1/4 downchirp | data upchirps | zero padding

Batched formulation: the reference emits one symbol per scheduler
callback through a running float phase accumulator.  Here the whole frame
is one array program: per-symbol phase profiles come from the closed-form
integer-turns chirp (ops/chirp.py), and phase continuity across symbols is
a *parallel* exclusive prefix-sum of per-symbol phase increments (integer
numerators mod D wrap correctly through uint32 cumsum because D divides
2^32) — no sequential accumulator anywhere.  A batch of B frames modulates
as a single XLA program, vmappable/shardable over channel banks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LoRaConfig
from ..ops import cplx
from ..ops.chirp import chirp_phase_nums as _phase_nums
from ..ops.cplx import IQ


def preamble_nums(cfg: LoRaConfig):
    """Static head of the frame: 10 preamble + 2 sync + 2 down + 1/4 down.
    Returns (nums [head_len], end_carry) — constants folded at trace time."""
    N, ovs, NN = cfg.N, cfg.ovs, cfg.NN
    D = N * ovs * ovs
    segs = []
    carry = jnp.uint32(0)
    plan = (
        [(0, NN, False)] * cfg.preamble_symbols
        + [((cfg.sync >> 4) * 8, NN, False), ((cfg.sync & 0xF) * 8, NN, False)]
        + [(0, NN, True), (0, NN, True), (0, NN // 4, True)]
    )
    for s, n, down in plan:
        num, end = _phase_nums(s, n, N, ovs, down)
        segs.append((num + carry) & np.uint32(D - 1))
        carry = (carry + end) & np.uint32(D - 1)
    return jnp.concatenate(segs), carry


def tx_frame_events(cfg: LoRaConfig, num_symbols: int) -> dict:
    """Per-frame TX sample-index metadata — the batched equivalent of the
    reference modulator's output-stream state labels and `txEnd` label
    (LoRaMod.cpp:226,233-236).  All offsets index into the corresponding
    `modulate()` output row (static per config + symbol count), for
    aligning hardware captures with emitted frames."""
    NN = cfg.NN
    t_sync = cfg.preamble_symbols * NN
    t_down = t_sync + 2 * NN
    t_data = t_down + 2 * NN + NN // 4
    t_end = t_data + num_symbols * NN
    return {
        "t_preamble": 0,
        "t_sync": t_sync,
        "t_downchirps": t_down,
        "t_data": t_data,
        "tx_end": t_end,
        "t_pad_end": t_end + cfg.padding * NN,
    }


@functools.partial(jax.jit, static_argnames=("cfg",))
def modulate(symbols: jax.Array, cfg: LoRaConfig) -> jax.Array:
    """Modulate frames.

    symbols: uint16/int32 [B, S] (or [S]) data symbols (already Gray-decoded
    and LSB-padded by the encoder).
    Returns planar IQ [B, T] baseband at cfg.ovs samples/chip,
    T = cfg.frame_samples(S).
    """
    squeeze = symbols.ndim == 1
    syms = jnp.atleast_2d(symbols).astype(jnp.int32)
    B, S = syms.shape
    N, ovs, NN = cfg.N, cfg.ovs, cfg.NN
    D = N * ovs * ovs
    ampl = jnp.float32(cfg.ampl)

    head_nums, head_carry = preamble_nums(cfg)
    head_iq = cplx.from_turns(head_nums.astype(jnp.float32) / np.float32(D), ampl)

    # per-data-symbol phase profiles + parallel phase-continuity prefix sum
    def one_symbol(s):
        return _phase_nums(s, NN, N, ovs, False)

    nums, carries = jax.vmap(jax.vmap(one_symbol))(syms)  # [B,S,NN], [B,S]
    starts = jnp.cumsum(carries, axis=-1, dtype=jnp.uint32) - carries
    starts = (starts + head_carry) & np.uint32(D - 1)
    nums = (nums + starts[..., None]) & np.uint32(D - 1)
    data_iq = cplx.from_turns(nums.astype(jnp.float32) / np.float32(D), ampl)
    data_iq = data_iq.reshape(B, S * NN)

    out = cplx.concatenate(
        [
            cplx.broadcast_to(head_iq, (B, head_iq.shape[0])),
            data_iq,
            cplx.zeros((B, cfg.padding * NN)),
        ],
        axis=-1,
    )
    return out[0] if squeeze else out
