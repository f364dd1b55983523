"""Soft-decision decoding (models/softdec): ML codeword selection from the
demod spectra.  A beyond-reference capability — the reference decoder is
hard-decision only (LoRaDecoder.cpp:196-222) — so the contract here is
(a) byte-exact agreement with the hard path on clean frames across rates,
whitening, headers and reduced symbol sets, and (b) a strict, pinned
sensitivity win over hard decoding in the FEC-limited noise regime."""

import numpy as np
import jax.numpy as jnp
import pytest

import lora_tpu
from lora_tpu import api
from lora_tpu.ops import cplx


@pytest.mark.parametrize(
    "sf,cr,ppm_red",
    # SF pinned at 7 (cheapest compiles); the CR axis is the coverage that
    # matters — each rate exercises a different code's ML candidate LUT
    # (4/8 hamming84, 4/7 hamming74, 4/6 parity64, 4/5 parity54, 4/4 none)
    [(7, "4/8", False), (7, "4/7", False), (7, "4/5", False),
     (7, "4/6", False), (7, "4/4", False), (7, "4/8", True)],
)
def test_soft_matches_hard_on_clean_frames(sf, cr, ppm_red):
    cfg = lora_tpu.LoRaConfig(sf=sf, cr=cr, ampl=1.0)
    if ppm_red:
        cfg = cfg.replace(ppm=sf - 2)
    cfg = cfg.replace(mtu=cfg.num_symbols(16) + 4)
    msg = np.frombuffer(b"soft decode test", np.uint8)
    iq = api.modulate(api.encode(jnp.asarray(msg[None]), cfg), cfg)
    dem = api.demodulate(iq, cfg, debug=True)
    hard = api.decode(dem.symbols.astype(jnp.int32), cfg)
    soft = api.decode_soft(dem.fft_mag2, cfg)
    assert api.extract_payloads(hard)[0] == bytes(msg.tolist())
    assert api.extract_payloads(soft)[0] == bytes(msg.tolist())
    np.testing.assert_array_equal(
        np.asarray(soft.status), np.asarray(hard.status)
    )


def test_spectra_mode_is_lean_debug():
    """demodulate(spectra=True) carries fft_mag2 identical to the debug
    path but without the raw/dec tap arrays — the production soft-RX
    route."""
    cfg = lora_tpu.LoRaConfig(sf=7, cr="4/7", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(16) + 4)
    msg = np.frombuffer(b"spectra mode ok!", np.uint8)
    iq = api.modulate(api.encode(jnp.asarray(msg[None]), cfg), cfg)
    lean = api.demodulate(iq, cfg, spectra=True)
    dbg = api.demodulate(iq, cfg, debug=True)
    assert lean.raw is None and lean.dec is None
    np.testing.assert_array_equal(
        np.asarray(lean.fft_mag2), np.asarray(dbg.fft_mag2)
    )
    np.testing.assert_array_equal(
        np.asarray(lean.symbols), np.asarray(dbg.symbols)
    )
    soft = api.decode_soft(lean.fft_mag2, cfg)
    assert api.extract_payloads(soft)[0] == bytes(msg.tolist())


def test_soft_beats_hard_in_fec_limited_noise():
    """Pinned paired comparison (identical noisy bank, fixed seed): in the
    regime where sync holds but payload symbol errors exceed the 1-bit
    LUT correction, ML soft decoding must recover strictly more frames.
    (Measured at this seed: hard 37/48, soft 48/48 at noise 2.6; the
    assertion leaves slack for cross-platform float drift.)"""
    sf, P, noise = 8, 48, 2.6
    cfg = lora_tpu.LoRaConfig(sf=sf, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(16) + 4)
    T = lora_tpu.required_samples(cfg)
    N = cfg.N
    rng = np.random.default_rng((99, sf, 26))
    payloads = rng.integers(0, 256, (P, 16), np.uint8)
    payloads[:, 0] = np.arange(P)
    delays = rng.integers(0, 2 * N, P)
    clean = api.modulate(api.encode(jnp.asarray(payloads), cfg), cfg)
    cre, cim = np.asarray(clean.re), np.asarray(clean.im)
    L = cre.shape[-1]
    br = np.zeros((P, T), np.float32)
    bi = np.zeros((P, T), np.float32)
    for p in range(P):
        d = int(delays[p])
        k = min(L, T - d)
        br[p, d : d + k] = cre[p, :k]
        bi[p, d : d + k] = cim[p, :k]
    br += noise * rng.standard_normal((P, T)).astype(np.float32)
    bi += noise * rng.standard_normal((P, T)).astype(np.float32)
    dem = api.demodulate(cplx.IQ(jnp.asarray(br), jnp.asarray(bi)), cfg,
                         debug=True)
    hard = api.decode(dem.symbols.astype(jnp.int32), cfg)
    soft = api.decode_soft(dem.fft_mag2, cfg)
    fnd = np.asarray(dem.found)
    hg = api.extract_payloads(hard)
    sg = api.extract_payloads(soft)
    h_ok = sum(1 for i in range(P)
               if fnd[i] and hg[i] == bytes(payloads[i].tolist()))
    s_ok = sum(1 for i in range(P)
               if fnd[i] and sg[i] == bytes(payloads[i].tolist()))
    assert s_ok > h_ok, (s_ok, h_ok)
    assert s_ok >= int(fnd.sum()) - 2, (s_ok, int(fnd.sum()))


def test_stream_soft_recovers_weak_frame():
    """Streaming runtime soft mode: a weak frame that the hard path syncs
    but fails to decode is recovered byte-exactly through
    StreamDemodulator(soft=True), with an ML confidence attached (the
    cli `replay --soft` path)."""
    from lora_tpu.runtime.stream import StreamDemodulator, decode_frames

    cfg = lora_tpu.LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(16) + 4)
    msg = np.frombuffer(b"weak soft frame!", np.uint8)
    iq = api.modulate(api.encode(jnp.asarray(msg[None]), cfg), cfg)
    T = 3 * lora_tpu.required_samples(cfg)
    L = iq.shape[-1]
    # seed retuned when required_samples gained the direct-kernel row-grid
    # padding (longer buffers shift the noise draw off the old cliff)
    rng_seed, noise, d = 0, 2.2, 500

    def run(soft):
        rng = np.random.default_rng(rng_seed)
        re = np.zeros((1, T), np.float32)
        im = np.zeros((1, T), np.float32)
        re[0, d : d + L] = np.asarray(iq.re)[0]
        im[0, d : d + L] = np.asarray(iq.im)[0]
        re += noise * rng.standard_normal((1, T)).astype(np.float32)
        im += noise * rng.standard_normal((1, T)).astype(np.float32)
        sd = StreamDemodulator(cfg, channels=1, soft=soft)
        sd.feed(cplx.IQ(re, im))
        frames = list(sd.run()) + sd.flush()
        decode_frames(frames, cfg)
        return frames

    hard = run(False)
    soft = run(True)
    assert len(hard) == 1 and hard[0].payload is None  # synced, decode fails
    assert hard[0].confidence is None
    assert len(soft) == 1 and soft[0].payload == bytes(msg.tolist())
    assert soft[0].confidence is not None and soft[0].confidence > 0
    assert soft[0].t_start == hard[0].t_start  # same sync, better decode


def test_soft_guard_rejects_crcless_garbage_payload():
    """The soft path's false-positive guard (models/softdec
    .guard_soft_status): ML selection always emits valid codewords, so a
    CRC-less frame whose payload is pure noise soft-decodes "cleanly" —
    the hard path catches it via FEC detection (DROP_FEC) but the soft
    path cannot.  Default policy in ChannelDispatcher(soft=True) /
    decode_frames: such frames are reported SOFT_UNVERIFIED, never OK.
    A clean CRC-less frame (hard path agrees) must stay OK."""
    from lora_tpu.models.decoder import DROP_FEC, OK, SOFT_UNVERIFIED
    from lora_tpu.parallel.dispatch import ChannelDispatcher

    cfg = lora_tpu.LoRaConfig(sf=7, cr="4/8", ampl=1.0, crc=False)
    cfg = cfg.replace(mtu=cfg.num_symbols(16) + 4)
    msg = np.frombuffer(b"guard rails test", np.uint8)
    iq = api.modulate(api.encode(jnp.asarray(msg[None]), cfg), cfg)
    re, im = np.asarray(iq.re)[0].copy(), np.asarray(iq.im)[0].copy()
    N = cfg.N
    data_start = (cfg.preamble_symbols + 2 + 2) * N + N // 4
    cut = data_start + 8 * N  # keep the header interleaver block intact
    rng = np.random.default_rng(0)
    reg, img = re.copy(), im.copy()
    reg[cut:] = 0.35 * rng.standard_normal(re.size - cut).astype(np.float32)
    img[cut:] = 0.35 * rng.standard_normal(re.size - cut).astype(np.float32)

    ds = ChannelDispatcher([cfg, cfg], soft=True)
    dh = ChannelDispatcher([cfg, cfg])
    streams = [
        cplx.IQ(jnp.asarray(reg), jnp.asarray(img)),  # garbage payload
        cplx.IQ(jnp.asarray(re), jnp.asarray(im)),    # clean control
    ]
    soft = ds.run(streams)
    hard = dh.run(streams)
    # hard path: FEC detection fires on the garbage payload
    assert hard[0].found and hard[0].status == DROP_FEC
    # soft path would decode garbage "cleanly"; the guard rejects it
    assert soft[0].found and soft[0].status == SOFT_UNVERIFIED
    assert soft[0].payload is None
    # clean CRC-less frame passes the guard (hard path agrees); the
    # reference truncates explicit no-hdr output by 5 even without CRC
    # (LoRaDecoder.cpp:396-398 quirk), so expect the first 14 bytes
    assert soft[1].status == OK and soft[1].payload == bytes(msg[:14].tolist())

    # the streaming runtime applies the same policy via decode_frames
    from lora_tpu.runtime.stream import StreamDemodulator, decode_frames

    T = lora_tpu.required_samples(cfg)
    sd = StreamDemodulator(cfg, channels=1, soft=True)
    pad = np.zeros(max(0, T - reg.size), np.float32)
    sd.feed(cplx.IQ(np.concatenate([reg, pad])[None],
                    np.concatenate([img, pad])[None]))
    frames = list(sd.run()) + sd.flush()
    decode_frames(frames, cfg)
    assert len(frames) == 1
    assert frames[0].status == SOFT_UNVERIFIED and frames[0].payload is None
