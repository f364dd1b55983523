"""Chirp synthesis + symbol detector tests.

Mirrors TestDetector.cpp:9-35 (exact argmax for every symbol at N=1024 with
an arbitrary phase offset, peak power > -10 dB) batched over all symbols and
extended to SF7-12, plus waveform-level golden comparison against the
reference genChirp oracle and FFT implementation equivalence.
"""

import json
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest

from lora_tpu.ops import chirp, cplx, detect

GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "golden" / "golden.json").read_text()
)


def golden_iq(key):
    flat = np.asarray(GOLDEN[key], np.float64)
    return (flat[0::2] + 1j * flat[1::2]).astype(np.complex64)


@pytest.mark.parametrize(
    "key,N,ovs,nn,s,down,phase0",
    [
        ("chirp_n16_s0_up", 16, 1, 16, 0, False, 0.0),
        ("chirp_n16_s5_up", 16, 1, 16, 5, False, 0.0),
        ("chirp_n16_s0_down", 16, 1, 16, 0, True, 0.0),
        ("chirp_n16_ovs4_s3_up", 16, 4, 64, 3, False, 0.0),
        ("chirp_n16_quarter_down", 16, 1, 4, 0, True, 0.5 / (2 * np.pi)),
        ("chirp_n256_s77_up", 256, 1, 256, 77, False, 0.125),
    ],
)
def test_golden_chirp_waveforms(key, N, ovs, nn, s, down, phase0):
    ref = golden_iq(key)
    iq, _end = chirp.gen_chirp(
        s, N, ovs, n_samples=nn, down=down, ampl=1.0, phase0_turns=phase0
    )
    np.testing.assert_allclose(cplx.to_complex(iq), ref, atol=2e-3)


def test_chirp_phase_continuity():
    # chaining two symbols through the carry matches the reference's running
    # phase accumulator semantics (no phase jump at the boundary)
    iq1, end1 = chirp.gen_chirp(3, 64, ampl=1.0)
    iq2, _ = chirp.gen_chirp(9, 64, ampl=1.0, phase0_turns=end1)
    seam = np.angle(cplx.to_complex(iq2)[0] / cplx.to_complex(iq1)[-1])
    # instantaneous frequency is bounded by pi (one sample step)
    assert abs(seam) <= np.pi


@pytest.mark.parametrize("sf", [7, 8, 9, 10, 11, 12])
def test_detector_full_symbol_sweep(sf):
    # all N symbols at once: modulate, dechirp, detect (TestDetector sweep)
    N = 1 << sf
    syms = jnp.arange(N, dtype=jnp.int32)
    make = jax.vmap(
        lambda s: chirp.gen_chirp(s, N, ampl=1.0, phase0_turns=0.125)[0]
    )
    windows = make(syms)
    res = detect.dechirp_detect(windows)
    np.testing.assert_array_equal(np.asarray(res.value), np.arange(N))
    assert np.all(np.asarray(res.power) > -10.0)


def test_detector_on_reference_waveform():
    # detect symbols from the *reference* oracle waveform (chirp_n256_s77_up)
    ref = golden_iq("chirp_n256_s77_up")
    res = detect.dechirp_detect(jnp.asarray(ref)[None])
    assert int(res.value[0]) == 77
    assert float(res.power[0]) > -10.0


def test_detector_snr_and_noise_floor(rng):
    N = 1024
    iq, _ = chirp.gen_chirp(100, N, ampl=1.0)
    noise = (rng.normal(size=N) + 1j * rng.normal(size=N)).astype(np.complex64)
    x = jnp.asarray(cplx.to_complex(iq) + 0.1 * noise)
    res = detect.dechirp_detect(x[None])
    assert int(res.value[0]) == 100
    snr = float(res.power[0] - res.noise[0])
    assert snr > 10.0


def test_detector_fractional_bin():
    # The 3-point interpolator (LoRaDetector.hpp:56-61) is a *biased*
    # small-signal slope estimator — the demod integrates it over preamble
    # windows rather than using it as an absolute measurement.  Check the
    # sign is right and the magnitude is in the expected band (~0.045 for a
    # quarter-bin offset with a rectangular window).
    N = 256
    n = np.arange(N)
    iq, _ = chirp.gen_chirp(40, N, ampl=1.0)
    for frac in (-0.25, 0.25):
        shifted = cplx.to_complex(iq) * np.exp(2j * np.pi * frac * n / N)
        res = detect.dechirp_detect(jnp.asarray(shifted)[None])
        assert int(res.value[0]) == 40
        fi = float(res.f_index[0])
        assert np.sign(fi) == np.sign(frac)
        assert 0.01 < abs(fi) < 0.5


def test_rotator_shifts_peak():
    N = 512
    iq, _ = chirp.gen_chirp(10, N, ampl=1.0)
    n = np.arange(N)
    # apply a +2.0 bin CFO; derotating by ferr=2.0 restores the peak
    cfo = cplx.to_complex(iq) * np.exp(2j * np.pi * 2.0 * n / N)
    res_raw = detect.dechirp_detect(jnp.asarray(cfo)[None])
    res_fix = detect.dechirp_detect(jnp.asarray(cfo)[None], ferr=2.0)
    assert int(res_raw.value[0]) == 12
    assert int(res_fix.value[0]) == 10


import jax  # noqa: E402  (used by vmap above)


@pytest.mark.parametrize(
    "case", ["det_n16_tone5", "det_n16_noisy", "det_n256_noisy",
             "det_n256_noise", "det_n1024_noisy"],
)
def test_detector_golden_vs_reference_oracle(case):
    """Detector outputs vs the REFERENCE's own compiled LoRaDetector.hpp
    (kissfft-backed, tools/gen_golden.cpp §7): identical argmax, dB powers
    and fractional-bin interpolation within f32-FFT tolerance on the exact
    same post-dechirp samples (LoRaDetector.hpp:29-64)."""
    x = golden_iq(case + "_in")
    want_value, want_power, want_noise, want_findex = GOLDEN[case + "_out"]
    d = detect.detect(cplx.from_complex(jnp.asarray(x)))
    assert int(d.value) == int(want_value)
    np.testing.assert_allclose(float(d.power), want_power, atol=2e-3)
    np.testing.assert_allclose(float(d.f_index), want_findex, atol=2e-3)
    if want_noise > -100:  # pure-tone "noise" is numerical dust in both
        np.testing.assert_allclose(float(d.noise), want_noise, atol=2e-2)
