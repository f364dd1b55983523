"""Distributed channelizer: time-sharded wideband in, channel-sharded out.

A wideband capture arrives naturally sharded along *time* (each ingest host
holds a contiguous slice).  Demodulation wants the *channel* axis parallel.
This module runs the polyphase channelizer locally on every time shard —
with the filter history pulled from the left neighbour (ppermute, NCCL over
NVLink between cards),
exactly the streaming `state` of ops/channelizer.py — and then corner-turns
the result with one `all_to_all` so each device ends up holding a channel
group over the full capture (SURVEY.md §2.2 "distributed comm backend").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from ..ops import channelizer as chz
from ..ops import cplx
from ..ops.cplx import IQ


def channelize_stream(
    x,
    K: int,
    mesh: Mesh,
    taps_per_phase: int = 8,
    axis_name: str = "time",
) -> IQ:
    """Channelize a bank of wideband captures sharded along time.

    x: IQ [B, T_global]; B sharded over 'channel', T_global over `axis_name`.
    Returns IQ [B, K, T_global // K] with the K axis sharded over
    `axis_name` (the corner-turn output layout) and time unsharded within
    each channel row.

    Requires K % n_time == 0 and T_local % K == 0.
    """
    x = cplx.as_iq(x)
    n_time = mesh.shape[axis_name]
    B, T = x.shape
    if T % (K * n_time):
        raise ValueError(f"T={T} must divide into {n_time} K-aligned blocks")
    t_local = T // n_time
    if K % n_time:
        raise ValueError(f"K={K} must be divisible by time shards {n_time}")
    hist = K * taps_per_phase - 1

    def local(blk: IQ) -> IQ:
        # filter history = last hist samples of the left neighbour
        n = jax.lax.axis_size(axis_name)
        idx = jax.lax.axis_index(axis_name)

        def leaf(a):
            suffix = a[..., -hist:]
            if n > 1:
                suffix = jax.lax.ppermute(
                    suffix, axis_name, [(j, (j + 1) % n) for j in range(n)]
                )
            return jnp.where(idx == 0, 0.0, 1.0).astype(a.dtype) * suffix

        state = IQ(leaf(blk.re), leaf(blk.im))
        y, _ = chz.channelize(blk, K, taps_per_phase, state=state)
        # corner-turn: channel groups scatter over the time axis, local time
        # blocks gather along the last axis
        if n > 1:
            y = IQ(
                jax.lax.all_to_all(
                    y.re, axis_name, split_axis=1, concat_axis=2, tiled=True
                ),
                jax.lax.all_to_all(
                    y.im, axis_name, split_axis=1, concat_axis=2, tiled=True
                ),
            )
        return y

    spec_in = IQ(P(("channel",), axis_name), P(("channel",), axis_name))
    spec_out = IQ(
        P(("channel",), axis_name, None), P(("channel",), axis_name, None)
    )
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(spec_in,),
        out_specs=spec_out,
        check_vma=False,
    )
    return jax.jit(fn)(x)
