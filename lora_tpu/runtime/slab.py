"""Slab execution: demodulate channel banks larger than one dispatch.

The demod step's working set (input bank + payload row gather + scan
blocks) must fit device memory at once.  This runner processes an
arbitrarily large host-resident bank in fixed-size slabs through ONE
compiled program, software-pipelined so slab k+1's host->device transfer
and dispatch overlap slab k's readback — the device never idles between
slabs and peak HBM usage is bounded by one slab (BASELINE.json configs
4-5: 10k+ concurrent channels on one chip).

Reference analogue: none — the reference demodulates one stream per
process (LoRaDemod.cpp); scaling out is external.  Cited for behavior
parity only: each slab row demodulates exactly like `demodulate`.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from ..config import LoRaConfig
from ..models.demodulator import DemodResult, demodulate, required_samples
from ..ops.cplx import IQ


def demodulate_bank(
    re: np.ndarray,
    im: np.ndarray,
    cfg: LoRaConfig,
    slab: int = 4096,
    max_frames: int = 1,
) -> DemodResult:
    """Demodulate a host bank [B, T] of any B in device-sized slabs.

    re/im: host float32 arrays (numpy; never materialized on device as a
    whole).  Returns a DemodResult with numpy leaves of leading dim B.
    Every slab runs the same compiled program (the last is zero-padded to
    `slab` rows; padding rows report found=False and are dropped).
    """
    B, T = re.shape
    need = required_samples(cfg)
    if T < need:
        pad = need - T
        re = np.pad(re, ((0, 0), (0, pad)))
        im = np.pad(im, ((0, 0), (0, pad)))
        T = need

    outs: list = []
    pending = None

    def resolve(p):
        outs.append(jax.tree.map(lambda a: np.asarray(a), p))

    for s in range(0, B, slab):
        blk_re = re[s : s + slab]
        blk_im = im[s : s + slab]
        if blk_re.shape[0] < slab:  # zero-pad the tail slab
            pad = slab - blk_re.shape[0]
            blk_re = np.pad(blk_re, ((0, pad), (0, 0)))
            blk_im = np.pad(blk_im, ((0, pad), (0, 0)))
        x = IQ(jnp.asarray(blk_re), jnp.asarray(blk_im))  # async H2D
        r = demodulate(x, cfg, max_frames=max_frames)  # async dispatch
        if pending is not None:
            resolve(pending)  # block on slab k-1 while k runs
        pending = r
    if pending is not None:
        resolve(pending)

    def cat(*leaves):
        return np.concatenate(leaves, axis=0)[:B]

    return jax.tree.map(cat, *outs)
