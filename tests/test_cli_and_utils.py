"""CLI applications (loopback / tx / replay / ber-sweep), packet sources,
and the capture-replay path — the reference's topology + generator-block
surface, headless."""

import json
import subprocess
import sys

import numpy as np
import pytest

from lora_tpu.utils import TestGen, BlockGen


def test_testgen_counter_packets():
    g = TestGen()
    assert bytes(next(g)) == b"0"
    assert bytes(next(g)) == b"1"
    b = g.batch(3, pad_to=4)
    assert b.shape == (3, 4)
    assert bytes(b[0]).rstrip() == b"2"


def test_blockgen_word_sizes():
    g = BlockGen([0x1234, 0xBEEF], word_bits=16)
    pkt = g.next()
    assert pkt is not None and pkt.tolist() == [0x34, 0x12, 0xEF, 0xBE]
    assert g.next() is None  # disarmed after one packet
    g.trigger()
    assert g.next().tolist() == [0x34, 0x12, 0xEF, 0xBE]
    g8 = BlockGen([1, 2, 255], word_bits=8)
    assert g8.next().tolist() == [1, 2, 255]


def _run_cli(*args):
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root)
    return subprocess.run(
        [sys.executable, "-m", "lora_tpu.cli", *args],
        capture_output=True,
        text=True,
        env=env,
        cwd="/tmp",
        timeout=500,
    )


def test_cli_loopback_noisy():
    # CLI wiring under noise at SF7 (cheap fresh-process compile); the
    # reference's SF10/noise-4.0 operating point itself is covered
    # in-process by test_noisy_loopback_reference_operating_point
    r = _run_cli(
        "loopback", "--sf", "7", "--noise", "1.5", "--packets", "3",
        "--length", "16",
    )
    assert r.returncode == 0, r.stderr[-800:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["byte_exact"] == 3 and out["decoded_ok"] == 3


def test_cli_tx_then_replay(tmp_path):
    f = tmp_path / "frame.cf32"
    r = _run_cli(
        "tx", "--sf", "7", "--payload", "48656c6c6f", "--out", str(f),
        "--lead-in", "500", "--lead-out", "8000",
    )
    assert r.returncode == 0, r.stderr[-800:]
    r = _run_cli("replay", "--file", str(f), "--fmt", "cf32", "--sf", "7",
                 "--length", "5")
    assert r.returncode == 0, r.stderr[-800:]
    lines = [json.loads(l) for l in r.stdout.strip().splitlines()]
    assert lines[-1]["frames"] == 1
    assert lines[0]["payload"] == "48656c6c6f" and lines[0]["status"] == 0


def test_replay_cs16_format(tmp_path):
    """Capture replay from a 16-bit wire-format file (the native converter
    path), as an RTL/Lime capture would produce."""
    import jax.numpy as jnp
    from lora_tpu import api
    from lora_tpu.config import LoRaConfig
    from lora_tpu.hw.capture import replay_file
    from lora_tpu.ops import cplx

    cfg = LoRaConfig(sf=8, cr="4/6", ampl=0.5)
    cfg = cfg.replace(mtu=cfg.num_symbols(6) + 2)
    payload = np.frombuffer(b"replay", np.uint8)
    iq = api.modulate(api.encode(jnp.asarray(payload[None]), cfg), cfg)
    re = np.concatenate([np.zeros(777, np.float32), np.asarray(iq.re[0]),
                         np.zeros(9000, np.float32)])
    im = np.concatenate([np.zeros(777, np.float32), np.asarray(iq.im[0]),
                         np.zeros(9000, np.float32)])
    inter = np.empty(re.size * 2, np.int16)
    inter[0::2] = np.round(re * 32767 * 0.9).astype(np.int16)
    inter[1::2] = np.round(im * 32767 * 0.9).astype(np.int16)
    f = tmp_path / "cap.cs16"
    f.write_bytes(inter.tobytes())
    frames = replay_file(str(f), "cs16", cfg)
    assert len(frames) == 1 and frames[0].payload == b"replay"


def test_burst_bounds():
    from lora_tpu.hw.capture import burst_bounds

    rng = np.random.default_rng(9)
    re = 0.01 * rng.standard_normal(64 * 1024).astype(np.float32)
    im = 0.01 * rng.standard_normal(64 * 1024).astype(np.float32)
    re[20000:30000] += 1.0
    a, b = burst_bounds(re, im)
    assert a <= 20000 < 30000 <= b
    assert b - a < 15000


def test_fm_discriminator_reads_chirp_sawtooth():
    """The FM discriminator (the reference's reverse-engineering tool,
    RN2483Capture.py:80-97) must recover a LoRa chirp's linear frequency
    ramp: slope 2*pi/N^2 rad/sample^2, one full sweep per symbol."""
    import jax.numpy as jnp

    from lora_tpu.config import LoRaConfig
    from lora_tpu.hw.capture import fm_discriminate
    from lora_tpu.ops import chirp

    cfg = LoRaConfig(sf=8, ampl=1.0)
    N = cfg.N
    iq, _ = chirp.gen_chirp(jnp.zeros((), jnp.int32), N, ampl=1.0)
    freq, amp = fm_discriminate(np.asarray(iq.re).ravel(),
                                np.asarray(iq.im).ravel())
    # instantaneous frequency inside the symbol is linear with slope
    # 2*pi/N; check the discrete derivative away from the wrap point
    d = np.diff(freq[2:])
    wrap = np.abs(d) > np.pi  # the sawtooth reset
    assert wrap.sum() <= 1
    slope = np.median(d[~wrap])
    assert abs(slope - 2 * np.pi / N**2 * N) < 1e-3  # 2*pi/N per sample


def test_render_fm_plot(tmp_path):
    pytest.importorskip("matplotlib")
    from lora_tpu.utils.plots import render_fm

    rng = np.random.default_rng(3)
    re = 0.01 * rng.standard_normal(8192).astype(np.float32)
    im = 0.01 * rng.standard_normal(8192).astype(np.float32)
    t = np.arange(2048, dtype=np.float32)
    re[3000:5048] += np.cos(0.001 * t * t)
    im[3000:5048] += np.sin(0.001 * t * t)
    out = render_fm(re, im, str(tmp_path / "fm.png"))
    assert (tmp_path / "fm.png").stat().st_size > 1000


def test_rn2483_mac_pause_per_transmit():
    """`mac pause` must precede every radio tx (RN2483.py:65), not just
    config(): a long-idle MAC can reclaim the radio."""
    from lora_tpu.hw import rn2483 as rn

    class FakeSerial:
        def __init__(self):
            self.lines = []
            self.replies = []

        def write(self, b):
            cmd = b.decode().strip()
            self.lines.append(cmd)
            if cmd == "sys reset":
                self.replies.append(b"RN2483 1.0.5\r\n")
            elif cmd == "mac pause":
                self.replies.append(b"4294967245\r\n")
            elif cmd.startswith("radio tx"):
                self.replies.append(b"ok\r\n")
                self.replies.append(b"radio_tx_ok\r\n")
            else:
                self.replies.append(b"ok\r\n")

        def readline(self):
            return self.replies.pop(0) if self.replies else b""

        def close(self):
            pass

    radio = rn.RN2483.__new__(rn.RN2483)
    radio._ser = FakeSerial()
    radio.transmit(b"\x01\x02")
    radio.transmit(b"\x03")
    txs = [i for i, l in enumerate(radio._ser.lines)
           if l.startswith("radio tx")]
    assert len(txs) == 2
    for i in txs:
        assert radio._ser.lines[i - 1] == "mac pause"
