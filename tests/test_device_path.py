"""The one device path: row gather + sub-window shift, dechirp + FFT
detection, the demodulator's geometry and debug taps, and the channelizer,
each against a plain numpy reference."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import lora_tpu
from lora_tpu import api
from lora_tpu.models.demodulator import (
    TRACK_ROWS,
    demodulate,
    payload_rows,
    required_samples,
)
from lora_tpu.ops import channelizer as chz
from lora_tpu.ops import chirp, cplx, detect as det_ops
from lora_tpu.ops import shift as shift_ops
from lora_tpu.sim import channel as ch


def _cplx_rows(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64
    )


# ---------------------------------------------------------------------------
# gather_rows + shift_windows == numpy slicing x[t0 : t0 + mtu*N]
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "N,mtu,k",
    [(16, 3, 0), (16, 9, 2), (128, 20, 0), (128, 5, 3), (256, 17, 0)],
)
def test_gather_shift_equals_slicing(rng, N, mtu, k):
    B, W = 3, mtu + 7
    x = _cplx_rows(rng, (B, W * N))
    shape = (B,) if k == 0 else (B, k)
    t0 = rng.integers(0, (W - mtu - 1) * N + 1, shape).astype(np.int32)
    t0.flat[0] = 0  # the first row, zero shift
    t0.flat[-1] = (W - mtu - 1) * N + N - 1  # the last legal row, r = N-1
    out = shift_ops.shift_windows(
        shift_ops.gather_rows(cplx.from_complex(x), jnp.asarray(t0 // N),
                              mtu + 1, N),
        jnp.asarray(t0 % N),
        mtu,
    )
    got = cplx.to_complex(out)
    assert got.shape == (*shape, mtu, N)
    for idx in np.ndindex(*shape):
        s = int(t0[idx])
        want = x[idx[0], s : s + mtu * N].reshape(mtu, N)
        np.testing.assert_array_equal(got[idx], want)


def test_gather_rows_clamps_to_the_last_rows(rng):
    N, n_rows, W = 16, 4, 10
    x = _cplx_rows(rng, (2, W * N))
    q = jnp.asarray([-3, W + 5], jnp.int32)  # both out of range
    got = cplx.to_complex(
        shift_ops.gather_rows(cplx.from_complex(x), q, n_rows, N)
    )
    np.testing.assert_array_equal(got[0], x[0, : n_rows * N].reshape(n_rows, N))
    np.testing.assert_array_equal(
        got[1], x[1, (W - n_rows) * N :].reshape(n_rows, N)
    )


# ---------------------------------------------------------------------------
# dechirp_detect vs an np.fft reference
# ---------------------------------------------------------------------------


def _np_detect(x, down=False, ferr=0.0):
    """Plain numpy detector: dechirp, FFT, argmax, dB powers."""
    N = x.shape[-1]
    tbl = cplx.to_complex(chirp.dechirp_table(N, down))
    n = np.arange(N)
    rot = np.exp(-2j * np.pi * ferr * n / N)
    spec = np.fft.fft(x.astype(np.complex128) * tbl * rot, axis=-1)
    mag2 = np.abs(spec) ** 2
    value = mag2.argmax(-1)
    peak = mag2.max(-1)
    power = 10 * np.log10(peak) - 20 * np.log10(N)
    noise = 10 * np.log10(mag2.sum(-1) - peak) - 20 * np.log10(N)
    return value, power, noise, mag2


@pytest.mark.parametrize("N", [128, 256, 1024])
@pytest.mark.parametrize("mode", ["plain", "ferr", "down"])
def test_dechirp_detect_matches_numpy(rng, N, mode):
    down = mode == "down"
    ferr = 1.5 if mode == "ferr" else 0.0
    syms = rng.integers(0, N, 6)
    iq = np.stack([
        cplx.to_complex(chirp.gen_chirp(int(s), N, ampl=1.0, down=down)[0])
        for s in syms
    ])
    n = np.arange(N)
    x = iq * np.exp(2j * np.pi * ferr * n / N) + 0.3 * _cplx_rows(rng, iq.shape)
    d = det_ops.dechirp_detect(
        cplx.from_complex(x), down=down, ferr=ferr if ferr else None,
        want_mag2=True,
    )
    value, power, noise, mag2 = _np_detect(x, down, ferr)
    np.testing.assert_array_equal(np.asarray(d.value), value)
    np.testing.assert_allclose(np.asarray(d.power), power, atol=1e-3)
    np.testing.assert_allclose(np.asarray(d.noise), noise, atol=1e-3)
    np.testing.assert_allclose(
        np.asarray(d.mag2), mag2, rtol=1e-3, atol=1e-3 * mag2.max()
    )


def test_dechirp_detect_keeps_leading_axes(rng):
    N = 128
    x = _cplx_rows(rng, (2, 3, 5, N))
    d = det_ops.dechirp_detect(cplx.from_complex(x))
    assert d.value.shape == (2, 3, 5) and d.power.shape == (2, 3, 5)
    value, power, _, _ = _np_detect(x)
    np.testing.assert_array_equal(np.asarray(d.value), value)
    np.testing.assert_allclose(np.asarray(d.power), power, atol=1e-3)


# ---------------------------------------------------------------------------
# demodulator geometry, spectra, debug taps, truncated frames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "sf,want_rp,want_T",
    # the flagship banks (bench.py / chip_smoke.py); pinned so the payload
    # clipping bound and buffer length cannot move silently
    [(7, 96, 15360), (10, 72, 98304), (12, 64, 360448)],
)
def test_flagship_geometry_pinned(sf, want_rp, want_T):
    cfg = lora_tpu.LoRaConfig(sf=sf, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(32) + 4)
    assert payload_rows(cfg.N, cfg.mtu) == want_rp
    assert payload_rows(cfg.N, cfg.mtu) > cfg.mtu
    assert required_samples(cfg) == want_T
    W = want_T // cfg.N
    assert (W - want_rp) % 8 == 0 and W > TRACK_ROWS


def _impaired_bank(cfg, rng, B, payload_bytes=6, noise=0.2, cfo_bins=2.3):
    payload = jnp.asarray(
        rng.integers(0, 256, (B, payload_bytes), dtype=np.uint8)
    )
    iq = api.modulate(api.encode(payload, cfg), cfg)
    need = required_samples(cfg)
    iq = cplx.pad(iq, ((0, 0), (0, max(0, need - iq.shape[-1]))))[:, :need]
    rows = [
        ch.time_offset(iq[i], int(rng.integers(0, 3 * cfg.N)))[..., :need]
        for i in range(B)
    ]
    bank = cplx.IQ(
        jnp.stack([r.re for r in rows]), jnp.stack([r.im for r in rows])
    )
    if cfo_bins:
        bank = ch.cfo(bank, cfo_bins, cfg.N)
    return ch.awgn(jax.random.PRNGKey(7), bank, noise)


def test_spectra_equal_the_debug_path(rng):
    cfg = lora_tpu.LoRaConfig(sf=7, cr="4/8", ampl=1.0, mtu=24)
    bank = _impaired_bank(cfg, rng, B=3)
    lean = demodulate(bank, cfg, spectra=True)
    dbg = demodulate(bank, cfg, debug=True)
    assert lean.raw is None and lean.dec is None
    assert lean.fft_mag2.shape == (3, cfg.mtu, cfg.N)
    np.testing.assert_array_equal(
        np.asarray(lean.fft_mag2), np.asarray(dbg.fft_mag2)
    )
    np.testing.assert_array_equal(
        np.asarray(lean.symbols), np.asarray(dbg.symbols)
    )


def test_debug_taps_include_raw(rng):
    cfg = lora_tpu.LoRaConfig(sf=7, cr="4/5", ampl=1.0, mtu=16)
    bank = _impaired_bank(cfg, rng, B=2, payload_bytes=4, cfo_bins=0.0)
    dem = demodulate(bank, cfg, debug=True)
    assert dem.raw is not None and dem.dec is not None
    assert dem.raw.shape == (2, cfg.mtu, cfg.N)
    # the raw tap is the pre-dechirp input copy: dechirping it must
    # reproduce the dec tap (LoRaDemod.cpp:81 raw vs :82 dec ports)
    dec2 = det_ops.dechirp(dem.raw, ferr=dem.fine_freq[..., None])
    np.testing.assert_allclose(
        np.asarray(dec2.re), np.asarray(dem.dec.re), atol=1e-6
    )


def test_payload_complete_flags_truncated_frame(rng):
    # a frame whose payload extends past the buffer: found may be True but
    # payload_complete must be False (the centralized fit check)
    cfg = lora_tpu.LoRaConfig(sf=7, cr="4/5", ampl=1.0, mtu=16)
    payload = jnp.asarray(rng.integers(0, 256, (1, 4), dtype=np.uint8))
    iq = api.modulate(api.encode(payload, cfg), cfg)
    need = required_samples(cfg)
    iq = cplx.pad(iq, ((0, 0), (0, max(0, need - iq.shape[-1]))))[:, :need]
    # shift the frame late enough that data_start + payload rows overrun
    late = ch.time_offset(iq[0], 10 * cfg.N)[..., :need].reshape(1, -1)
    dem = demodulate(late, cfg)
    ok = demodulate(iq, cfg)
    assert bool(np.asarray(ok.found)[0]) and bool(
        np.asarray(ok.payload_complete)[0]
    )
    if bool(np.asarray(dem.found)[0]):
        assert not bool(np.asarray(dem.payload_complete)[0])


@pytest.mark.parametrize("sf", [7, 8])
def test_soft_equals_hard_on_clean_bank(rng, sf):
    cfg = lora_tpu.LoRaConfig(sf=sf, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(8) + 2)
    bank = _impaired_bank(cfg, rng, B=4, payload_bytes=8, noise=0.05)
    dem = demodulate(bank, cfg, spectra=True)
    hard = api.decode(dem.symbols.astype(jnp.int32), cfg)
    soft = api.decode_soft(dem.fft_mag2, cfg)
    assert all(p is not None for p in api.extract_payloads(hard))
    assert api.extract_payloads(soft) == api.extract_payloads(hard)
    np.testing.assert_array_equal(
        np.asarray(soft.status), np.asarray(hard.status)
    )


# ---------------------------------------------------------------------------
# channelize vs a direct numpy polyphase filter + decimator
# ---------------------------------------------------------------------------


def _np_channelize(x, K, L=8):
    """y_k[m] = sum_t h[t] x[mK - t] e^{-2 pi i k (mK - t) / K}, zero
    history before sample 0 (the module docstring's definition)."""
    h = chz.prototype(K, L).astype(np.float64)
    T = x.shape[-1]
    M = T // K
    xp = np.concatenate([np.zeros(L * K - 1), x.astype(np.complex128)])
    y = np.zeros((K, M), np.complex128)
    t = np.arange(L * K)
    for m in range(M):
        # xp index of x[mK - t] is mK - t + L*K - 1 (mK: the block's last
        # commutator phase sits at (m+1)K - 1 - (K-1))
        seg = xp[m * K + L * K - 1 - t]
        for k in range(K):
            y[k, m] = np.sum(
                h * seg * np.exp(-2j * np.pi * k * (m * K - t) / K)
            )
    return y


@pytest.mark.parametrize("K", [8, 64])
def test_channelize_matches_numpy_polyphase(rng, K):
    M = 24
    x = _cplx_rows(rng, (M * K,))
    y, _ = chz.channelize(cplx.from_complex(x), K)
    got = cplx.to_complex(y)
    want = _np_channelize(x, K)
    assert got.shape == (K, M)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
