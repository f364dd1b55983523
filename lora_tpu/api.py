"""Top-level PHY API: encode / modulate / demodulate / decode.

The reference exposes four Pothos blocks wired into a topology
(/lora/lora_encoder -> /lora/lora_mod -> channel -> /lora/lora_demod ->
/lora/lora_decoder); here the same surface is four pure batched functions
over a shared :class:`LoRaConfig`, composable under jit/vmap/shard_map.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .config import LoRaConfig
from .models.encoder import encode
from .models.decoder import decode, DecodeResult, OK, STATUS_NAMES
from .models.softdec import decode_soft, soft_symbols
from .models.modulator import modulate
from .models.demodulator import demodulate, DemodResult, required_samples
from .ops import cplx
from .ops.cplx import IQ

__all__ = [
    "LoRaConfig",
    "IQ",
    "encode",
    "decode",
    "decode_soft",
    "soft_symbols",
    "modulate",
    "demodulate",
    "DecodeResult",
    "DemodResult",
    "required_samples",
    "OK",
    "STATUS_NAMES",
    "extract_payloads",
    "channelized_demodulate",
    "loopback",
]


def extract_payloads(result: DecodeResult) -> list[bytes | None]:
    """Host-side helper: slice each packet's output bytes (None if dropped)."""
    data = np.atleast_2d(np.asarray(result.data))
    offset = np.atleast_1d(np.asarray(result.offset))
    length = np.atleast_1d(np.asarray(result.length))
    status = np.atleast_1d(np.asarray(result.status))
    out = []
    for i in range(data.shape[0]):
        if status[i] != OK:
            out.append(None)
        else:
            o, l = int(offset[i]), int(length[i])
            out.append(bytes(data[i, o : o + l].tolist()))
    return out


@functools.partial(
    jax.jit,
    static_argnames=("K", "cfg", "taps_per_phase", "max_frames", "spectra"),
)
def _channelize_demod_step(
    wb, K, cfg, taps_per_phase, max_frames, state, spectra=False
):
    """One XLA program: polyphase filterbank + IDFT corner + the whole
    K-channel demod bank — a single device dispatch per wideband block."""
    from .ops import channelizer as chz

    with jax.named_scope("channelize"):
        y, new_state = chz.channelize(wb, K, taps_per_phase, state=state)
    Bw, _, M = y.shape
    bank = y.reshape(Bw * K, M)
    dem = demodulate(bank, cfg, max_frames=max_frames, spectra=spectra)
    # reshape the [Bw*K, ...] result leaves to [Bw, K, ...] inside the jit
    dem = jax.tree.map(lambda a: a.reshape(Bw, K, *a.shape[1:]), dem)
    return dem, new_state


def channelized_demodulate(
    wide,
    K: int,
    cfg: LoRaConfig,
    taps_per_phase: int = 8,
    max_frames: int = 1,
    state=None,
    spectra: bool = False,
):
    """Wideband front-end: polyphase-channelize [..., T] at rate K*BW into
    K channels and demodulate every channel in one program (BASELINE.json
    config 3).  Returns (DemodResult with leading [..., K] axes,
    channelizer state for streaming continuity).

    spectra=True carries the payload |FFT|^2 windows in fft_mag2 so the
    wideband bank can soft-decode:
    decode_soft(dem.fft_mag2.reshape(-1, cfg.mtu, cfg.N)) or per-channel
    via the [..., K, mtu, N] leaves.
    """
    wide = cplx.as_iq(wide)
    squeeze = wide.ndim == 1
    wb = wide if not squeeze else wide.reshape(1, -1)
    if state is None:  # concrete zero state keeps the jit signature stable
        state = cplx.zeros((*wb.shape[:-1], taps_per_phase * K - 1))
    dem, new_state = _channelize_demod_step(
        wb, K, cfg, taps_per_phase, max_frames, state, spectra
    )
    if squeeze:
        dem = jax.tree.map(lambda a: a[0], dem)
    return dem, new_state


def loopback(
    payload,
    cfg: LoRaConfig,
    noise_amplitude: float = 0.0,
    phase: float = 0.0,
    cfo_bins: float = 0.0,
    delay: int = 0,
    seed: int = 0,
    debug: bool = False,
    soft: bool = False,
):
    """Full-chain simulation: encode -> modulate -> channel -> demodulate ->
    decode.  payload: uint8 [B, L] (or [L]).  Returns (DecodeResult,
    DemodResult).  Mirrors the reference loopback test topology
    (TestLoopback.cpp:115-124) with optional impairments.

    soft=True decodes with the soft-decision path (decode_soft over the
    demod spectra, ~1.5 dB payload sensitivity over hard decoding)."""
    from .sim import channel as ch

    payload = jnp.atleast_2d(jnp.asarray(payload, jnp.uint8))
    symbols = encode(payload, cfg)
    # pad so the demod has search room + a full MTU window grid; round the
    # buffer up to a 4096 block so nearby delays share one compiled shape
    iq = modulate(symbols, cfg)
    need = required_samples(cfg) + delay
    need = -(-need // 4096) * 4096
    if iq.shape[-1] < need:
        iq = cplx.pad(iq, ((0, 0), (0, need - iq.shape[-1])))
    if delay:
        iq = ch.time_offset(iq, delay)[..., : need]
    if cfo_bins:
        iq = ch.cfo(iq, cfo_bins, cfg.N)
    if phase:
        iq = ch.rotate(iq, phase)
    if noise_amplitude:
        iq = ch.awgn(jax.random.PRNGKey(seed), iq, noise_amplitude)
    dem = demodulate(iq, cfg, debug=debug, spectra=soft and not debug)
    if soft:
        dec = decode_soft(dem.fft_mag2, cfg)
    else:
        dec = decode(dem.symbols.astype(jnp.int32), cfg)
    return dec, dem
