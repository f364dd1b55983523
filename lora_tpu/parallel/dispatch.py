"""Heterogeneous channel-group dispatcher (the EP analogue, SURVEY.md §2.2).

A deployment monitors channels with mixed (SF, BW, CR, sync) settings.  One
XLA program cannot mix symbol sizes (static shapes), so channels route
host-side into per-config groups — each group compiles once and runs as one
batched demodulate — and results map back to the caller's channel ids.
This is the moral equivalent of expert-parallel token routing: group =
expert, channel = token, with capacity padding to the group's batch.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import jax.numpy as jnp

from ..config import LoRaConfig
from ..models.demodulator import (
    DemodResult,
    demodulate,
    payload_rows,
    required_samples,
)
from ..models.decoder import decode
from ..ops import cplx
from ..ops.cplx import IQ


def _fetch(a):
    """Global host value of a (possibly non-addressable) sharded array."""
    if getattr(a, "is_fully_addressable", True):
        return np.asarray(a)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(a, tiled=True))


@dataclasses.dataclass
class GroupResult:
    """Demod/decode results for one channel (see DemodResult/DecodeResult)."""

    channel: int
    cfg: LoRaConfig
    found: bool
    symbols: np.ndarray
    snr: float
    status: int | None = None
    payload: bytes | None = None


class ChannelDispatcher:
    """Route per-channel sample streams to per-config batched programs.

    configs: one LoRaConfig per channel.  Streams may have per-channel
    lengths; each group pads to its own (required_samples, max length) so a
    group is exactly one jit cache entry.

    mesh: an optional jax.sharding.Mesh — each group's bank is then padded
    to the device count, device_put with the channel sharding, and
    demodulated via parallel.shard_demodulate, so the expert groups run
    data-parallel over the mesh (EP routing host-side, DP execution
    per-expert; padding rows demodulate to found=False and are dropped).
    """

    def __init__(self, configs: Sequence[LoRaConfig], soft: bool = False,
                 mesh=None):
        # soft=True decodes every group with the soft-decision path
        # (models/softdec): spectra-mode demod + ML codewords
        self.soft = soft
        self.mesh = mesh
        self.configs = list(configs)
        self.groups: dict[LoRaConfig, list[int]] = {}
        for ch, cfg in enumerate(self.configs):
            self.groups.setdefault(cfg, []).append(ch)

    def run(self, streams: Sequence, with_decode: bool = True) -> list[GroupResult]:
        """streams: per-channel IQ/complex 1-D arrays (host).

        Returns one GroupResult per channel, in channel order.
        """
        if len(streams) != len(self.configs):
            raise ValueError("one stream per configured channel required")
        out: list[GroupResult | None] = [None] * len(self.configs)
        for cfg, members in self.groups.items():
            need = required_samples(cfg)
            # zero-pad past the longest stream by the payload gather's
            # row-grid slack, so a frame ending at the stream's last sample
            # still passes demodulate's payload-fit check
            slack = (
                payload_rows(cfg.N, cfg.mtu) - (cfg.mtu + 1) + 1
            ) * cfg.N
            T = max(need, slack + max(
                np.shape(streams[ch])[-1] if not isinstance(streams[ch], IQ)
                else streams[ch].shape[-1] for ch in members))
            bank_re = np.zeros((len(members), T), np.float32)
            bank_im = np.zeros((len(members), T), np.float32)
            for i, ch in enumerate(members):
                s = streams[ch]
                if isinstance(s, IQ):
                    re, im = np.asarray(s.re), np.asarray(s.im)
                else:
                    arr = np.asarray(s)
                    re, im = arr.real.astype(np.float32), arr.imag.astype(
                        np.float32
                    )
                bank_re[i, : re.shape[-1]] = re
                bank_im[i, : im.shape[-1]] = im
            bank = IQ(jnp.asarray(bank_re), jnp.asarray(bank_im))
            pre_dec = pre_hard = None
            if self.mesh is not None:
                import jax

                from .mesh import channel_sharding, shard_demodulate

                ndev = int(self.mesh.devices.size)
                padb = (-len(members)) % ndev
                if padb:  # all-zero rows: no preamble run, found=False
                    bank = cplx.pad(bank, ((0, padb), (0, 0)))
                bank = jax.device_put(bank, channel_sharding(self.mesh))
                dem = shard_demodulate(
                    bank, cfg, self.mesh, spectra=self.soft
                )
                if with_decode:
                    # decode UNDER the sharding, before any host fetch:
                    # allgathering the sharded spectra ([B, mtu, N] f32)
                    # to every process and re-decoding the global batch
                    # per host would move GBs and duplicate the work
                    # x n_processes
                    if self.soft:
                        from ..models.softdec import decode_soft

                        pre_dec = decode_soft(dem.fft_mag2, cfg)
                        pre_hard = decode(
                            dem.symbols.astype(jnp.int32), cfg
                        )
                    else:
                        pre_dec = decode(dem.symbols.astype(jnp.int32), cfg)
                # host-side routing needs host values; under multi-process
                # jax.distributed the shards span non-addressable devices,
                # so gather the global values (single-process: plain
                # fetch).  The spectra stay on device — only compact
                # results cross to the host.
                dem = jax.tree.map(
                    _fetch, dataclasses.replace(dem, fft_mag2=None)
                )
                pre_dec = jax.tree.map(_fetch, pre_dec)
                pre_hard = jax.tree.map(_fetch, pre_hard)
            else:
                dem = demodulate(bank, cfg, spectra=self.soft)
            # a frame only counts if its payload fits the buffer — the
            # demodulator's centralized fit check (symbols are truncated
            # garbage when data_start was clamped)
            found = np.asarray(dem.found) & np.asarray(dem.payload_complete)
            counts = np.asarray(dem.count)
            symbols = np.asarray(dem.symbols)
            snr = np.asarray(dem.snr)
            statuses = payloads = None
            if with_decode:
                if self.soft:
                    from ..models.softdec import decode_soft, guard_soft_status

                    dec = (pre_dec if pre_dec is not None
                           else decode_soft(dem.fft_mag2, cfg))
                    # false-positive guard: a CRC-less soft OK must be
                    # confirmed by the hard-decision decode, else it is
                    # reported as SOFT_UNVERIFIED (models/softdec caveat)
                    dec_hard = (pre_hard if pre_hard is not None
                                else decode(dem.symbols.astype(jnp.int32),
                                            cfg))
                    statuses = guard_soft_status(dec, dec_hard)
                else:
                    dec = (pre_dec if pre_dec is not None
                           else decode(dem.symbols.astype(jnp.int32), cfg))
                    statuses = np.asarray(dec.status)
                data = np.asarray(dec.data)
                off = np.asarray(dec.offset)
                length = np.asarray(dec.length)
            for i, ch in enumerate(members):
                r = GroupResult(
                    channel=ch,
                    cfg=cfg,
                    found=bool(found[i]),
                    symbols=symbols[i, : counts[i]].copy(),
                    snr=float(snr[i]),
                )
                if with_decode and found[i]:
                    r.status = int(statuses[i])
                    if r.status == 0:
                        o, l = int(off[i]), int(length[i])
                        r.payload = bytes(data[i, o : o + l].tolist())
                out[ch] = r
        return out  # type: ignore[return-value]
