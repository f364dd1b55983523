"""Bring-up check: the LoRa PHY's main path on one GPU, at full width,
against the plain path on the CPU in the same process.

    python chip_smoke.py               # phases 1-8 on one card
    python chip_smoke.py --multichip   # only the four-card phase

Phases (each prints its comparison; any failure raises and exits non-zero):
  1 device      first JAX device must be a GPU; kind, count, nvidia-smi
  2 SF10        B=4096 loopback, sigma=0.1: every frame found and
                byte-exact; first 64 channels against the CPU
  3 SF7, SF12   the same at B=4096 and B=1024
  4 reference   SF10, sigma=4.0, 64 frames (`cli loopback` defaults):
                decoded counts on both sides, symbol decisions identical on
                every frame both sides find
  5 soft        demodulate(spectra=True) -> decode_soft equals the hard
                path on the clean bank, and the CPU's soft decode
  6 wideband    channelized_demodulate, K=64, SF7: channelizer output
                within 1e-3 relative of the CPU, payloads exact
  7 streams     StreamDemodulator over a multi-frame stream and a mixed-SF
                ChannelDispatcher, payload-exact
  8 memory      memory_analysis() and peak bytes of the SF10 step, one warm
                step time

Tolerances against the CPU: integer decisions (found, t_sync, freq_error,
symbols) must be identical; power and snr may differ by 0.05 dB, because
cuFFT sums in another order than the CPU's FFT.  The last line of stdout
is the JSON device record.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

import jax
import jax.numpy as jnp

from lora_tpu import api
from lora_tpu import benchmarks as bm
from lora_tpu.ops import channelizer as chz
from lora_tpu.ops import cplx
from lora_tpu.utils.compile_cache import enable_compile_cache

N_CPU = 64  # channels compared against the CPU in each bank
DB_TOL = 0.05  # dB: cuFFT vs the CPU FFT summation order
SIZES = {"sf10": 4096, "sf7": 4096, "sf12": 1024, "ref": 64,
         "wide_streams": 16, "multichip_per_card": 4096}


def log(*a) -> None:
    print(*a, flush=True)


def cpu_device():
    return jax.devices("cpu")[0]


def on_cpu(fn, *args):
    """Run fn on the CPU with every array argument copied there."""
    cpu = cpu_device()
    args = jax.tree.map(lambda a: jax.device_put(np.asarray(a), cpu), args)
    with jax.default_device(cpu):
        return jax.block_until_ready(fn(*args))


def compare_decisions(gpu, cpu, label: str, n: int) -> None:
    """Integer decisions identical, dB outputs within DB_TOL, first n."""
    for k in ("found", "t_sync", "freq_error", "symbols"):
        a = np.asarray(getattr(gpu, k))[:n]
        b = np.asarray(getattr(cpu, k))[:n]
        if not np.array_equal(a, b):
            rows = (a != b).reshape(n, -1).any(axis=1)
            raise AssertionError(f"{label}: {k} differs on {int(rows.sum())} "
                                 f"of {n} channels, first {np.flatnonzero(rows)[:8]}")
    worst = 0.0
    for k in ("power", "snr"):
        d = np.asarray(getattr(gpu, k))[:n] - np.asarray(getattr(cpu, k))[:n]
        worst = max(worst, float(np.abs(d).max()))
    if worst > DB_TOL:
        raise AssertionError(f"{label}: power/snr differ by {worst} dB")
    log(f"  {label}: found/t_sync/freq_error/symbols identical on {n} "
        f"channels; power/snr max |diff| {worst:.2e} dB (tol {DB_TOL})")


def phase_device():
    dev = bm.require_gpu()
    log(f"[1 device] {dev.device_kind}, {len(jax.devices())} device(s)")
    log(bm.card_info())
    return dev


def loopback_bank(sf: int, B: int, seed: int):
    cfg = bm.flagship_cfg(sf)
    iq, payload = bm.build_bank(cfg, B, sigma=0.1, seed=seed)
    step = jax.jit(lambda x: api.demodulate(x, cfg))
    dem = jax.block_until_ready(step(iq))
    bm.check_payloads(dem, cfg, payload)
    log(f"  SF{sf} B={B}: {B} frames found, {B} payloads byte-exact")
    ref = on_cpu(lambda x: api.demodulate(x, cfg), iq[:N_CPU])
    compare_decisions(dem, ref, f"SF{sf} GPU vs CPU", N_CPU)
    return cfg, iq, payload, step


def phase_reference_point() -> None:
    """SF10, sigma 4.0, phase pi/1.2345, 64 frames of 20 bytes: the
    `cli loopback` operating point (TestLoopback.cpp:93-101)."""
    from lora_tpu.sim import channel as ch
    from lora_tpu.utils import TestGen

    P = SIZES["ref"]
    payload = TestGen().batch(P, pad_to=20)
    cfg = api.LoRaConfig(sf=10, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(payload.shape[1]) + 4)
    iq = api.modulate(api.encode(jnp.asarray(payload), cfg), cfg)
    need = -(-api.required_samples(cfg) // 4096) * 4096
    iq = cplx.pad(iq, ((0, 0), (0, need - iq.shape[-1])))
    iq = ch.rotate(iq, np.pi / 1.2345)
    iq = ch.awgn(jax.random.PRNGKey(0), iq, 4.0)

    def rx(x):
        dem = api.demodulate(x, cfg)
        return dem, api.decode(dem.symbols.astype(jnp.int32), cfg)

    dem_g, dec_g = jax.block_until_ready(jax.jit(rx)(iq))
    dem_c, dec_c = on_cpu(rx, iq)
    want = [bytes(p.tolist()) for p in payload]
    ok_g = sum(g == w for g, w in zip(api.extract_payloads(dec_g), want))
    ok_c = sum(g == w for g, w in zip(api.extract_payloads(dec_c), want))
    both = np.asarray(dem_g.found) & np.asarray(dem_c.found)
    same_t = np.asarray(dem_g.t_sync)[both] == np.asarray(dem_c.t_sync)[both]
    sym_g = np.asarray(dem_g.symbols)[both]
    sym_c = np.asarray(dem_c.symbols)[both]
    n_diff = int(np.sum(sym_g != sym_c))
    log(f"  decoded byte-exact: GPU {ok_g}/{P}, CPU {ok_c}/{P}; found on "
        f"both {int(both.sum())}; t_sync equal on {int(same_t.sum())}; "
        f"differing symbol decisions {n_diff}")
    if not same_t.all() or n_diff:
        raise AssertionError("symbol decisions differ on frames both found")


def phase_soft(cfg, iq, payload) -> None:
    def rx(x):
        dem = api.demodulate(x, cfg, spectra=True)
        hard = api.decode(dem.symbols.astype(jnp.int32), cfg)
        return hard, api.decode_soft(dem.fft_mag2, cfg)

    hard, soft = jax.block_until_ready(jax.jit(rx)(iq))
    want = [bytes(p.tolist()) for p in payload]
    got_h, got_s = api.extract_payloads(hard), api.extract_payloads(soft)
    if got_s != got_h or got_s != want:
        raise AssertionError("soft payloads differ from the hard path")
    _, soft_c = on_cpu(rx, iq[:N_CPU])
    if api.extract_payloads(soft_c) != got_s[:N_CPU]:
        raise AssertionError("soft payloads differ from the CPU's")
    log(f"  soft == hard == sent on {len(want)} frames; soft == CPU soft on "
        f"{N_CPU}")


def phase_wideband() -> None:
    """K=64 channels of SF7 (BASELINE config 3): every channel of S
    wideband streams carries a frame, merged by the synthesis bank."""
    K, S = 64, SIZES["wide_streams"]
    cfg = bm.flagship_cfg(7)
    need = api.required_samples(cfg)
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 256, (S * K, 32), dtype=np.uint8)
    frames = api.modulate(api.encode(jnp.asarray(payload), cfg), cfg)
    lead = jnp.asarray(16 * (np.arange(S * K) % 8))
    u = jax.vmap(lambda re, im, d: cplx.IQ(
        jnp.roll(jnp.pad(re, (0, need - re.shape[-1])), d),
        jnp.roll(jnp.pad(im, (0, need - im.shape[-1])), d),
    ))(frames.re, frames.im, lead).reshape(S, K, need)
    wide, _ = chz.synthesize(u)
    jax.block_until_ready(wide)

    dem, _ = api.channelized_demodulate(wide, K, cfg)
    dec = api.decode(dem.symbols.reshape(S * K, -1).astype(jnp.int32), cfg)
    got = api.extract_payloads(dec)
    want = [bytes(p.tolist()) for p in payload]
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if bad:
        raise AssertionError(f"wideband: {len(bad)} payloads differ, "
                             f"first {bad[:8]}")
    log(f"  K={K} SF7, {S} streams: {S * K} payloads byte-exact")
    chan = jax.jit(lambda x: chz.channelize(x, K)[0])
    y_g = np.asarray(cplx.to_complex(chan(wide[:1])))
    y_c = np.asarray(cplx.to_complex(on_cpu(chan, wide[:1])))
    rel = float(np.abs(y_g - y_c).max() / np.abs(y_c).max())
    log(f"  channelizer GPU vs CPU: max |diff| / max |y| = {rel:.2e} "
        f"(tol 1e-3)")
    if rel > 1e-3:
        raise AssertionError("channelizer output differs from the CPU's")


def phase_streams() -> None:
    from lora_tpu.config import LoRaConfig
    from lora_tpu.parallel import ChannelDispatcher
    from lora_tpu.runtime import StreamDemodulator, decode_frames

    rng = np.random.default_rng(11)
    cfg = LoRaConfig(sf=8, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(16) + 2)
    payloads = [rng.integers(0, 256, 16).astype(np.uint8) for _ in range(6)]
    chunks = []
    for i, p in enumerate(payloads):
        iq = api.modulate(api.encode(jnp.asarray(p[None]), cfg), cfg)[0]
        chunks += [np.zeros(300 + 517 * i, np.complex64), cplx.to_complex(iq)]
    chunks.append(np.zeros(8 * cfg.N, np.complex64))
    x = np.concatenate(chunks)
    x = x + 0.05 * (rng.standard_normal(x.size)
                    + 1j * rng.standard_normal(x.size)).astype(np.complex64)
    sd = StreamDemodulator(cfg, channels=1, max_frames=2)
    frames = []
    for i in range(0, x.size, 20000):
        sd.feed(x[None, i : i + 20000])
        frames.extend(sd.run())
    frames.extend(sd.flush())
    decode_frames(frames, cfg)
    got = [f.payload for f in frames]
    if got != [bytes(p.tolist()) for p in payloads]:
        raise AssertionError(f"stream: {len(got)} frames, payloads differ")
    log(f"  StreamDemodulator: {len(frames)} frames, payloads byte-exact")

    plan = [(7, "4/8", 0), (9, "4/5", 133), (7, "4/8", 57), (8, "4/7", 301),
            (12, "4/8", 12), (10, "4/6", 999)]
    cfgs, streams, pays = [], [], []
    for sf, cr, lead in plan:
        c = LoRaConfig(sf=sf, cr=cr, ampl=1.0)
        c = c.replace(mtu=c.num_symbols(8) + 2)
        p = rng.integers(0, 256, 8).astype(np.uint8)
        iq = api.modulate(api.encode(jnp.asarray(p[None]), c), c)[0]
        streams.append(np.concatenate([
            np.zeros(lead, np.complex64), cplx.to_complex(iq),
            np.zeros(256, np.complex64)]))
        cfgs.append(c)
        pays.append(bytes(p.tolist()))
    res = ChannelDispatcher(cfgs).run(streams)
    if [r.payload for r in res] != pays:
        raise AssertionError("dispatcher payloads differ")
    log(f"  ChannelDispatcher: {len(res)} channels over "
        f"{len(set(cfgs))} configs, payloads byte-exact")


def phase_memory(cfg, iq, step) -> None:
    ma = step.lower(iq).compile().memory_analysis()
    log(f"  memory_analysis: argument {ma.argument_size_in_bytes} B, "
        f"output {ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes} B")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    times = bm.time_steps(step, iq, 3)
    B, T = iq.shape
    log(f"  warm SF10 B={B} step {min(times) * 1e3:.3f} ms "
        f"({B * T / min(times) / 1e6:.1f} Msamples/s) on {bm.card_info()}")


def phase_multichip() -> None:
    """Four cards: the sharded dry run, then shard_demodulate of an SF10
    bank (4096 channels per card) against a one-card demodulate of each
    shard."""
    import __graft_entry__
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lora_tpu.parallel import make_mesh, shard_demodulate

    devs = jax.devices()
    if len(devs) != 4:
        raise RuntimeError(f"--multichip needs 4 GPUs, found {len(devs)}")
    __graft_entry__.dryrun_multichip(4)
    log("  dryrun_multichip(4): ok")

    cfg = bm.flagship_cfg(10)
    Bc = SIZES["multichip_per_card"]
    shards, payloads = [], []
    for i, d in enumerate(devs):
        with jax.default_device(d):
            iq, p = bm.build_bank(cfg, Bc, sigma=0.1, seed=100 + i)
        shards.append(iq)
        payloads.append(p)
    mesh = make_mesh(devices=devs)
    sh = NamedSharding(mesh, P(("time", "channel")))
    T = shards[0].shape[-1]
    bank = cplx.IQ(*(
        jax.make_array_from_single_device_arrays(
            (4 * Bc, T), sh, [getattr(s, f) for s in shards])
        for f in ("re", "im")
    ))
    sharded = jax.block_until_ready(
        jax.jit(lambda x: shard_demodulate(x, cfg, mesh))(bank))
    one = jax.jit(lambda x: api.demodulate(x, cfg))
    for i, s in enumerate(shards):
        ref = jax.block_until_ready(one(s))
        sl = slice(i * Bc, (i + 1) * Bc)
        for k in ("found", "t_sync", "freq_error", "symbols", "count"):
            a = np.asarray(getattr(sharded, k))[sl]
            if not np.array_equal(a, np.asarray(getattr(ref, k))):
                raise AssertionError(f"card {i}: sharded {k} differs")
        bm.check_payloads(ref, cfg, payloads[i])
    log(f"  shard_demodulate SF10 B={4 * Bc} over 4 cards: decisions "
        f"identical to one-card demodulate of each shard, payloads exact")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)
    phase_device()
    enable_compile_cache()
    t0 = time.perf_counter()
    if args.multichip:
        log("[multichip]")
        phase_multichip()
    else:
        log("[2 SF10 loopback]")
        cfg10, iq10, pay10, step10 = loopback_bank(10, SIZES["sf10"], 0)
        log("[3 SF7 / SF12 loopback]")
        loopback_bank(7, SIZES["sf7"], 1)
        loopback_bank(12, SIZES["sf12"], 2)
        log("[4 reference operating point]")
        phase_reference_point()
        log("[5 soft decode]")
        phase_soft(cfg10, iq10, pay10)
        log("[6 wideband]")
        phase_wideband()
        log("[7 streams]")
        phase_streams()
        log("[8 memory and timing]")
        phase_memory(cfg10, iq10, step10)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": bm.device_record()}))


if __name__ == "__main__":
    main()
