"""Time-axis sharding with overlap-save halo exchange.

The reference consumes its sample stream strictly sequentially with
data-dependent strides (LoRaDemod.cpp:320) — sequence parallelism does not
exist there (SURVEY.md §2.2/§5).  Here a long capture is split into fixed
blocks across the mesh's `time` axis; each shard pulls a *left margin* from
its left neighbour and a *right halo* from its right neighbour via
`jax.lax.ppermute` (NCCL over NVLink between cards) (the SDR analogue of ring attention's neighbour
exchange) and runs the block-parallel frame search locally.

Ownership rule: a frame belongs to the shard whose main region contains its
preamble start.  Both margins are multiples of N and every shard sees the
same samples on the same N-aligned window grid, so neighbouring shards
compute *bit-identical* detections shifted by exactly t_local — a frame
straddling a boundary is claimed exactly once, with no reconciliation
collective.  The left margin must cover the largest preamble run a frame
can present (10 preamble + 2 sync symbols); frames starting within the
margin of the previous block are detected here too but disowned, and
detected in-range by their owner.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import LoRaConfig
from ..models.demodulator import demodulate, required_samples, DemodResult
from ..ops import cplx
from ..ops.cplx import IQ

def left_margin(cfg: LoRaConfig) -> int:
    """Samples of left-neighbour context: full preamble + sync + slack."""
    return (cfg.preamble_symbols + 2 + 2) * cfg.N


def halo_exchange(
    x: jax.Array,
    left: int,
    right: int,
    axis_name: str = "time",
    wrap: bool = False,
) -> jax.Array:
    """Extend each shard's block [..., T_local] to
    [..., left + T_local + right] with neighbour samples via ppermute.

    x may be any pytree of same-shaped arrays (e.g. planar IQ); the exchange
    applies leafwise.  With wrap=False (a linear, non-circular capture)
    shard 0's left margin and the last shard's right halo are zeroed.
    Requires left, right <= T_local.
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)

    def leaf(a):
        suffix = a[..., -left:] if left else a[..., :0]
        prefix = a[..., :right] if right else a[..., :0]
        if n == 1:
            recv_l, recv_r = suffix, prefix
        else:
            # shard j's suffix travels right to j+1; prefix left to j-1
            recv_l = jax.lax.ppermute(
                suffix, axis_name, [(j, (j + 1) % n) for j in range(n)]
            )
            recv_r = jax.lax.ppermute(
                prefix, axis_name, [((j + 1) % n, j) for j in range(n)]
            )
        if not wrap:
            recv_l = jnp.where(idx == 0, 0, 1).astype(a.dtype) * recv_l
            recv_r = jnp.where(idx == n - 1, 0, 1).astype(a.dtype) * recv_r
        return jnp.concatenate([recv_l, a, recv_r], axis=-1)

    return jax.tree.map(leaf, x)


def demodulate_stream(
    x: jax.Array,
    cfg: LoRaConfig,
    mesh: Mesh,
    halo: int | None = None,
    max_frames: int = 1,
) -> DemodResult:
    """Demodulate a bank of long captures sharded along time.

    x: planar IQ [B, T_global], B sharded over 'channel', T_global over
    'time'.  Each time shard reports (at most) one frame whose preamble
    starts in its main region; t_sync/consumed are in global sample
    coordinates.  Callers that need every frame of a dense stream step the
    stream through frame-sized slots (runtime/stream.py drives that loop).

    halo defaults to required_samples(cfg): enough to finish a frame whose
    preamble starts on the block's last sample.
    """
    if halo is None:
        halo = required_samples(cfg)
    x = cplx.as_iq(x)
    L = left_margin(cfg)
    n_time = mesh.shape["time"]
    B, T = x.shape
    if T % n_time:
        raise ValueError(f"T={T} not divisible by time axis {n_time}")
    t_local = T // n_time
    if t_local % cfg.N:
        raise ValueError(
            f"local block {t_local} must be a multiple of N={cfg.N} so all "
            "shards share one window grid"
        )
    if max(halo, L) > t_local:
        raise ValueError(
            f"margins (left {L}, right {halo}) exceed local block {t_local};"
            " use fewer time shards"
        )

    def local(block):  # [B_local, t_local] -> max_frames frame slots
        ext = halo_exchange(block, L, halo, "time")
        dem = demodulate(ext, cfg, max_frames=max_frames)
        start = dem.t_sync - cfg.preamble_symbols * cfg.N  # approx preamble start
        own = dem.found & (start >= L) & (start < L + t_local)
        t_off = jax.lax.axis_index("time").astype(jnp.int32) * t_local - L
        return DemodResult(
            symbols=jnp.where(own[..., None], dem.symbols, 0),
            count=jnp.where(own, dem.count, 0),
            found=own,
            freq_error=jnp.where(own, dem.freq_error, 0),
            fine_freq=jnp.where(own, dem.fine_freq, 0.0),
            power=dem.power,
            snr=dem.snr,
            t_sync=jnp.where(own, dem.t_sync + t_off, -1),
            consumed=jnp.where(own, dem.consumed + t_off, 0),
        )

    k_ax = (None,) if max_frames > 1 else ()
    spec_out_leaf = {
        "symbols": P(("channel",), *k_ax, None),
        "count": P(("channel",), *k_ax),
        "found": P(("channel",), *k_ax),
        "freq_error": P(("channel",), *k_ax),
        "fine_freq": P(("channel",), *k_ax),
        "power": P(("channel",), *k_ax),
        "snr": P(("channel",), *k_ax),
        "t_sync": P(("channel",), *k_ax),
        "consumed": P(("channel",), *k_ax),
    }

    # one frame slot per (time shard, channel): the time axis maps to a
    # leading result axis.
    def wrapped(blk):
        r = local(blk)
        return jax.tree.map(lambda a: a[None], r)

    out_specs = DemodResult(
        **{k: P(("time",), *p) for k, p in spec_out_leaf.items()}
    )
    fn = shard_map(
        wrapped,
        mesh=mesh,
        in_specs=(IQ(P(("channel",), "time"), P(("channel",), "time")),),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)(x)
