"""lora_tpu — a LoRa PHY framework in JAX.

Array-first re-design of the capabilities of myriadrf/LoRa-SDR: batched
encode/modulate/demodulate/decode over channel banks sharded across a
device mesh, with the per-symbol dechirp+FFT+argmax run as one batched
XLA program and the bit-domain codecs vectorized as integer LUT ops.
"""

from .config import LoRaConfig, CODING_RATES

__version__ = "0.1.0"

__all__ = ["LoRaConfig", "CODING_RATES"]


def __getattr__(name):
    # Lazy top-level API to keep `import lora_tpu` light.
    if name in ("encode", "decode", "decode_soft", "soft_symbols",
                "modulate", "demodulate",
                "DecodeResult", "DemodResult", "IQ", "loopback",
                "required_samples", "extract_payloads"):
        from . import api

        return getattr(api, name)
    if name in ("debug_checks", "DemodCheckError"):
        from .utils import debugcheck

        return getattr(debugcheck, name)
    if name in ("parallel", "runtime", "api", "models", "ops", "sim",
                "utils", "hw"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
