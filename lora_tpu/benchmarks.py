"""Headline benchmark: SF10 demodulator throughput on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

metric  : batched full-frame demod (coarse preamble search, sync scan,
          CFO recovery, payload dechirp + FFT + argmax) at the reference's
          verified operating point (SF10, CR 4/8, TestLoopback.cpp:93-101),
          B = 4096 channels of planar float32 IQ resident on the device.
value   : Msamples/s of baseband consumed per chip, from the median of
          warm steps, each timed to block_until_ready.
vs_baseline : the reference is a single-stream CPU pipeline whose hard
          requirement is real time at max BW x ovs = 0.5 Msamp/s
          (BASELINE.md "Required complex-sample throughput"); the ratio is
          "how many max-rate reference modems one chip replaces".

Every payload is decoded and checked byte-exact before timing.  With no
GPU the run fails: there is no CPU fallback.

    python bench.py
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np

METRIC = "demod_throughput_sf10"
BASELINE_MSPS = 0.5
BATCH = 4096  # channels in the SF10 bank
ITERS = 10  # warm steps timed


def require_gpu():
    """The first JAX device, which must be a GPU; raises otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this measurement runs only on the card"
        )
    return dev


def card_info() -> str:
    """`nvidia-smi` name and power limit of the card(s), read in a child
    process that stays off JAX.  Raises where nvidia-smi fails: a speed
    number without its card's power limit cannot be compared."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi named no card")
    return out.replace("\n", "; ")


def device_record() -> dict:
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def flagship_cfg(sf: int = 10):
    """CR 4/8, 32-byte payloads, mtu = num_symbols(32) + 4: the bank
    geometry bench.py, __graft_entry__.entry() and chip_smoke.py share."""
    from .config import LoRaConfig

    cfg = LoRaConfig(sf=sf, cr="4/8", ampl=1.0)
    return cfg.replace(mtu=cfg.num_symbols(32) + 4)


def build_bank(cfg, B: int, sigma: float = 0.1, seed: int = 0):
    """(IQ [B, required_samples(cfg)], payload uint8 [B, 32]): one frame
    per channel at sample 0 plus AWGN of amplitude sigma per rail, made on
    the default device from `seed` (no bulk host-to-device copy)."""
    import jax
    import jax.numpy as jnp

    from . import api
    from .ops import cplx

    payload = np.random.default_rng(seed).integers(
        0, 256, (B, 32), dtype=np.uint8
    )
    iq = api.modulate(api.encode(jnp.asarray(payload), cfg), cfg)
    T = api.required_samples(cfg)
    iq = cplx.pad(iq, ((0, 0), (0, max(0, T - iq.shape[-1]))))[:, :T]
    if sigma:
        kr, ki = jax.random.split(jax.random.PRNGKey(seed))
        iq = cplx.IQ(
            iq.re + sigma * jax.random.normal(kr, (B, T), jnp.float32),
            iq.im + sigma * jax.random.normal(ki, (B, T), jnp.float32),
        )
    return jax.block_until_ready(iq), payload


def check_payloads(dem, cfg, payload: np.ndarray) -> None:
    """Raise unless every channel synced and decoded its payload exactly."""
    import jax.numpy as jnp

    from . import api

    found = np.asarray(dem.found)
    if not found.all():
        raise AssertionError(f"{int((~found).sum())} frames not found")
    dec = api.decode(dem.symbols.astype(jnp.int32), cfg)
    got = api.extract_payloads(dec)
    bad = [i for i, (g, p) in enumerate(zip(got, payload))
           if g != bytes(p.tolist())]
    if bad:
        raise AssertionError(f"{len(bad)} payloads differ, first {bad[:8]}")


def time_steps(step, x, iters: int) -> list[float]:
    """Seconds per warm step, each ended by block_until_ready."""
    import jax

    jax.block_until_ready(step(x))  # warm: compile + first run
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(step(x))
        times.append(time.perf_counter() - t0)
    return times


def main() -> None:
    import jax

    from . import api
    from .utils.compile_cache import enable_compile_cache

    require_gpu()
    enable_compile_cache()
    cfg = flagship_cfg(10)
    iq, payload = build_bank(cfg, BATCH)
    step = jax.jit(lambda x: api.demodulate(x, cfg))
    check_payloads(step(iq), cfg, payload)
    times = time_steps(step, iq, ITERS)
    B, T = iq.shape
    med = statistics.median(times)
    msps = B * T / med / 1e6
    print(json.dumps({
        "metric": METRIC,
        "value": msps,
        "unit": "Msamples/s/chip",
        "vs_baseline": msps / BASELINE_MSPS,
        "batch": B,
        "samples_per_channel": T,
        "step_s_median": med,
        "step_s_min": min(times),
        "iters": ITERS,
        "device": device_record(),
        "card": card_info(),
    }))


if __name__ == "__main__":
    main()
