"""Real multi-process jax.distributed exercise (VERDICT round-1 item 3).

Launches N coordinator+worker CPU processes (2 virtual devices each) and
runs the full multi-host recipe from ``parallel/multihost.py`` across them:
``initialize`` -> ``global_mesh`` -> ``local_time_range`` -> ``host_array``
-> time-sharded ``demodulate_stream`` (ppermute halo rides the
cross-process transport) -> ``aggregate_metrics`` (psum over processes) ->
``process_allgather`` + decode.  This is the single-controller analogue of
the reference's remoted topology test (TestLoopback.cpp:16): same program,
every host, one global device set.

The workers only ever touch the CPU backend (one process per card: a
second JAX process on a GPU would fail for want of memory).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import json, os, sys

port, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
import jax

jax.config.update("jax_platforms", "cpu")

from lora_tpu.parallel import multihost

multihost.initialize(
    coordinator=f"localhost:{port}", num_processes=nproc, process_id=pid
)
assert jax.process_count() == nproc, jax.process_count()
assert jax.process_index() == pid

import numpy as np
import jax.numpy as jnp
from jax.experimental import multihost_utils
from jax.sharding import PartitionSpec as P

from lora_tpu import api
from lora_tpu.config import LoRaConfig
from lora_tpu.models.demodulator import required_samples
from lora_tpu.ops import cplx
from lora_tpu.ops.cplx import IQ
from lora_tpu.parallel import aggregate_metrics, demodulate_stream

cfg = LoRaConfig(sf=7, cr="4/8", ampl=1.0)
cfg = cfg.replace(mtu=cfg.num_symbols(4) + 2)
N = cfg.N
need = required_samples(cfg)

mesh = multihost.global_mesh()  # time = one shard per process
n_time = mesh.shape["time"]
assert n_time == nproc
t_local = ((max(need, (cfg.preamble_symbols + 4) * N) - 1) // N + 1) * N + N
T = t_local * n_time
B = 2 * mesh.shape["channel"]

# every process builds the same capture deterministically, then contributes
# only its local_time_range slice
rng = np.random.default_rng(7)
payload = rng.integers(0, 256, size=(B, 4)).astype(np.uint8)
frame = np.asarray(
    cplx.to_complex(api.modulate(api.encode(jnp.asarray(payload), cfg), cfg))
)
FL = frame.shape[-1]
offsets = [0, t_local - FL // 3, t_local + N, T - t_local // 2]
offsets = [min(o, T - need) for o in offsets][:B]
bank = np.zeros((B, T), np.complex64)
for b, o in enumerate(offsets):
    bank[b, o : o + FL] = frame[b]
bank += 0.05 * rng.standard_normal((B, 2 * T), dtype=np.float32).view(
    np.complex64
)

s, e = multihost.local_time_range(mesh, T)
assert e - s == t_local and s == pid * t_local
spec = P(("channel",), "time")
x = IQ(
    multihost.host_array((B, T), bank.real[:, s:e], mesh, spec),
    multihost.host_array((B, T), bank.imag[:, s:e], mesh, spec),
)

dem = demodulate_stream(x, cfg, mesh)
# psum/all-reduce over the global mesh (jit: inputs span both processes)
m = jax.jit(aggregate_metrics)(dem)
g = multihost_utils.process_allgather(
    {"found": dem.found, "t_sync": dem.t_sync, "symbols": dem.symbols,
     "count": dem.count},
    tiled=True,  # global arrays: gather the value itself
)
found = np.asarray(g["found"]).reshape(-1)
order = np.argsort(np.where(found, np.asarray(g["t_sync"]).reshape(-1), 1 << 30))
sym = np.asarray(g["symbols"]).reshape(-1, dem.symbols.shape[-1])[order][
    : int(found.sum())
]
dec = api.decode(jnp.asarray(sym, jnp.int32), cfg)
payloads = api.extract_payloads(dec)
t_pre = np.asarray(g["t_sync"]).reshape(-1) - cfg.preamble_symbols * N
print(
    "RESULT "
    + json.dumps(
        {
            "pid": pid,
            "processes": nproc,
            "devices": len(jax.devices()),
            "synced": int(m["synced"]),
            "symbols": int(m["symbols"]),
            "mean_snr_db": float(m["mean_snr_db"]),
            "t_pre": sorted(int(t) for t in t_pre[found]),
            "offsets": sorted(offsets),
            "payload_ok": payloads
            == [bytes(p.tolist()) for p in payload[np.argsort(offsets)]],
        }
    )
)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_dryrun_multiprocess_entry():
    """The driver entry's multi-process variant: 2 coordinator+worker
    processes run the full sharded dryrun step over one global device
    set (VERDICT round-1 item 3's "dryrun_multichip gains a multi-process
    variant")."""
    import __graft_entry__ as g

    g.dryrun_multiprocess(2)


@pytest.mark.slow
def test_two_process_distributed_stream(tmp_path):
    nproc = 2
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(port), str(i), str(nproc)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            cwd=_REPO,
        )
        for i in range(nproc)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(json.loads(out.splitlines()[-1].removeprefix("RESULT ")))

    r0, r1 = outs
    # the psum'd metrics are identical on every process
    assert r0["synced"] == r1["synced"] == len(r0["offsets"])
    assert r0["symbols"] == r1["symbols"] > 0
    assert abs(r0["mean_snr_db"] - r1["mean_snr_db"]) < 1e-5
    assert r0["devices"] == r1["devices"] == 2 * nproc
    # each planted frame claimed exactly once, at its planted offset
    for r in outs:
        assert r["t_pre"] == pytest.approx(r["offsets"], abs=2)
        assert r["payload_ok"] is True
