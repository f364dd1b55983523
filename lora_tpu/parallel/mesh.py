"""Device mesh + channel-bank sharding.

The reference is a single-process, single-stream pipeline; its only
parallelism is the external Pothos thread-per-block scheduler
(/root/reference/examples/lora_simulation.pth topologies; SURVEY.md §2.2).
This framework's primary scaling axis is instead *data parallelism over
channels*: thousands of independent LoRa channels demodulated as one
sharded array program over a `jax.sharding.Mesh`.

Two mesh axes are used framework-wide:

  channel  embarrassingly parallel channel bank (DP analogue)
  time     overlap-save time-sharding of one wideband stream (SP analogue,
           see halo.py)

Collectives ride NCCL over NVLink between the cards of a host; metric
reductions (`aggregate_metrics`) use `psum`/mean over both axes and are the
batched equivalent of the reference's
async `error`/`power`/`snr`/`dropped` signals (LoRaDemod.cpp:85-87,267-269;
LoRaDecoder.cpp:123,401-405).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import LoRaConfig
from ..models.demodulator import demodulate, DemodResult


def make_mesh(
    channel: int = 0,
    time: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ('time', 'channel') mesh.

    channel=0 means "all remaining devices on the channel axis".
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if channel == 0:
        if n % time:
            raise ValueError(f"{n} devices not divisible by time={time}")
        channel = n // time
    if time * channel != n:
        raise ValueError(f"mesh {time}x{channel} != {n} devices")
    arr = np.asarray(devices).reshape(time, channel)
    return Mesh(arr, ("time", "channel"))


def channel_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for [B, ...] channel-bank arrays: batch split over every mesh
    device (time axis folded in — a pure channel bank uses all chips)."""
    return NamedSharding(mesh, P(("time", "channel")))


def shard_demodulate(
    x: jax.Array,
    cfg: LoRaConfig,
    mesh: Mesh,
    debug: bool = False,
    max_frames: int = 1,
    spectra: bool = False,
) -> DemodResult:
    """Demodulate a channel bank [B, T] sharded over the whole mesh.

    The per-channel program is independent, so a sharding constraint on the
    batch axis is all XLA needs; no collectives are inserted in the hot path.
    B must be divisible by the device count.  spectra=True carries the
    payload |FFT|^2 windows for soft-decision decoding (demodulate docs).
    """
    sh = channel_sharding(mesh)
    x = jax.lax.with_sharding_constraint(x, sh)
    return demodulate(
        x, cfg, debug=debug, max_frames=max_frames, spectra=spectra
    )


def aggregate_metrics(dem: DemodResult, statuses: Optional[jax.Array] = None):
    """Global health report over a (possibly sharded) channel bank.

    Replaces the reference's per-frame async signals with one reduced
    struct: counts and means are computed with jnp reductions, which XLA
    lowers to psum/all-reduce over the mesh when inputs are sharded.
    """
    found = dem.found.astype(jnp.int32)
    n_found = jnp.sum(found)
    denom = jnp.maximum(n_found, 1).astype(jnp.float32)

    def mean_found(v):
        return jnp.sum(jnp.where(dem.found, v.astype(jnp.float32), 0.0)) / denom

    out = {
        "frames": jnp.asarray(dem.found.size, jnp.int32),
        "synced": n_found,
        "mean_snr_db": mean_found(dem.snr),
        "mean_power_db": mean_found(dem.power),
        "mean_cfo_bins": mean_found(dem.freq_error),
        "symbols": jnp.sum(dem.count),
    }
    if statuses is not None:
        # only synced frames are decode candidates; a non-synced row's
        # zero-symbol decode is meaningless
        out["decoded_ok"] = jnp.sum((dem.found & (statuses == 0)).astype(jnp.int32))
        out["dropped"] = jnp.sum((dem.found & (statuses != 0)).astype(jnp.int32))
    return out
