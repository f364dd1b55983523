"""Device path on the card against the CPU, at small banks, with the
comparisons chip_smoke.py makes at full width.  Marked `gpu`: they skip
without a GPU and run on the card with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import numpy as np
import pytest
import jax

import chip_smoke
from lora_tpu import api, benchmarks as bm
from lora_tpu.ops import channelizer as chz
from lora_tpu.ops import cplx

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (first JAX device is "
                    f"{dev.platform!r})")
    return dev


@pytest.mark.parametrize("sf", [7, 10])
def test_demodulate_on_gpu_matches_cpu(gpu, sf):
    cfg = bm.flagship_cfg(sf)
    iq, payload = bm.build_bank(cfg, 64, sigma=0.1, seed=sf)
    dem = api.demodulate(iq, cfg)
    bm.check_payloads(dem, cfg, payload)
    ref = chip_smoke.on_cpu(lambda x: api.demodulate(x, cfg), iq)
    chip_smoke.compare_decisions(dem, ref, f"SF{sf} GPU vs CPU", 64)


def test_channelize_on_gpu_matches_cpu(gpu, rng):
    K = 64
    x = cplx.IQ(*(rng.standard_normal((2, 64 * K)).astype(np.float32)))
    f = jax.jit(lambda v: chz.channelize(v, K)[0])
    y = cplx.to_complex(f(jax.device_put(x, gpu)))
    y_ref = cplx.to_complex(chip_smoke.on_cpu(f, x))
    assert np.abs(y - y_ref).max() <= 1e-3 * np.abs(y_ref).max()
