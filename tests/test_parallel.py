"""Sharded-path tests on the virtual 8-device CPU mesh (conftest forces
--xla_force_host_platform_device_count=8).

Covers SURVEY.md §2.2's first-class parallel components: channel-bank DP
sharding, time-axis SP sharding with ppermute halo exchange (frames
straddling shard boundaries recovered exactly once), and mesh-reduced
metrics — none of which exist in the single-process reference.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from lora_tpu import api
from lora_tpu.config import LoRaConfig
from lora_tpu.ops import cplx
from lora_tpu.models.demodulator import required_samples
from lora_tpu.parallel import (
    make_mesh,
    channel_sharding,
    shard_demodulate,
    aggregate_metrics,
    demodulate_stream,
)


def _frames(cfg, B, L, rng, T):
    from lora_tpu.ops import cplx

    payload = rng.integers(0, 256, size=(B, L)).astype(np.uint8)
    iq = api.modulate(api.encode(jnp.asarray(payload), cfg), cfg)
    iq = cplx.pad(iq, ((0, 0), (0, max(0, T - iq.shape[-1]))))[:, :T]
    return payload, iq


def test_channel_bank_sharded_demod(rng):
    mesh = make_mesh()  # 1 x 8
    cfg = LoRaConfig(sf=7, cr="4/7", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(8) + 2)
    T = required_samples(cfg)
    payload, iq = _frames(cfg, 16, 8, rng, T)
    iq = jax.device_put(iq, channel_sharding(mesh))
    dem = shard_demodulate(iq, cfg, mesh)
    assert np.all(np.asarray(dem.found))
    dec = api.decode(dem.symbols.astype(jnp.int32), cfg)
    assert api.extract_payloads(dec) == [bytes(p.tolist()) for p in payload]
    m = aggregate_metrics(dem, statuses=dec.status)
    assert int(m["synced"]) == 16 and int(m["decoded_ok"]) == 16


@pytest.mark.parametrize("time_ax", [2, 4])
def test_time_sharded_stream_boundary_frames(time_ax, rng):
    """Frames placed at shard boundaries must be found exactly once, by the
    owning shard, via the halo exchange."""
    mesh = make_mesh(time=time_ax)
    cfg = LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(4) + 2)
    need = required_samples(cfg)
    t_local = ((need - 1) // 128 + 1) * 128 + 512
    T = t_local * time_ax

    B = 8
    payload = rng.integers(0, 256, size=(B, 4)).astype(np.uint8)
    frame = api.modulate(api.encode(jnp.asarray(payload), cfg), cfg)
    FL = frame.shape[-1]
    # place each channel's frame at a different offset, several straddling
    # the first shard boundary
    offsets = [
        0,
        t_local - FL // 3,        # straddles boundary, owned by shard 0
        t_local - 2,              # preamble starts just before boundary
        t_local // 2,
        t_local + 5,              # owned by shard 1
        max(0, t_local - FL + 64),
        37,
        t_local - 1024,
    ]
    bank = np.zeros((B, T), np.complex64)
    fr = cplx.to_complex(frame)
    for i, o in enumerate(offsets):
        bank[i, o : o + FL] = fr[i, : max(0, min(FL, T - o))]

    iq = jax.device_put(
        jnp.asarray(bank), NamedSharding(mesh, P("channel", "time"))
    )
    dem = demodulate_stream(iq, cfg, mesh)

    found = np.asarray(dem.found)  # [time, B]
    t_sync = np.asarray(dem.t_sync)
    # each channel found exactly once across time shards
    assert np.all(found.sum(axis=0) == 1), found
    owner = found.argmax(axis=0)
    for i, o in enumerate(offsets):
        assert owner[i] == o // t_local, (i, o, owner[i])
        # preamble starts at o; sync symbol is 10 symbols in
        expect_sync = o + 10 * cfg.N
        assert abs(int(t_sync[owner[i], i]) - expect_sync) <= 1, (i, o)

    # payloads decode from the owning slot
    syms = np.asarray(dem.symbols)[owner, np.arange(B)]
    dec = api.decode(jnp.asarray(syms, jnp.int32), cfg)
    assert api.extract_payloads(dec) == [bytes(p.tolist()) for p in payload]


def test_graft_entry_and_dryrun():
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import __graft_entry__ as ge

        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        jax.block_until_ready(out)
        assert bool(np.all(np.asarray(out[2])))  # all found
        ge.dryrun_multichip(8)
    finally:
        sys.path.remove(root)


def test_time_sharded_stream_multi_frame(rng):
    """Two frames inside one shard's region, recovered by the same shard's
    candidate slots under max_frames=2."""
    mesh = make_mesh(time=2)
    cfg = LoRaConfig(sf=7, cr="4/8", ampl=1.0)
    cfg = cfg.replace(mtu=cfg.num_symbols(4) + 2)
    need = required_samples(cfg)
    t_local = ((need - 1) // 128 + 1) * 128 + 6144
    T = t_local * 2

    payload = rng.integers(0, 256, size=(2, 4)).astype(np.uint8)
    frame = api.modulate(api.encode(jnp.asarray(payload), cfg), cfg)
    FL = frame.shape[-1]
    fr = cplx.to_complex(frame)
    bank = np.zeros((8, T), np.complex64)
    offsets = [64, 64 + FL + 500]  # both in shard 0
    for i, o in enumerate(offsets):
        bank[0, o : o + FL] = fr[i]
    iq = jax.device_put(
        jnp.asarray(bank), NamedSharding(mesh, P("channel", "time"))
    )
    dem = demodulate_stream(iq, cfg, mesh, max_frames=2)
    found = np.asarray(dem.found)  # [time, B, K]
    assert found.shape == (2, 8, 2)
    assert found[0, 0].tolist() == [True, True]
    assert not found[1].any() and not found[0, 1:].any()
    t_sync = np.asarray(dem.t_sync)
    for k, o in enumerate(offsets):
        assert abs(int(t_sync[0, 0, k]) - (o + 10 * cfg.N)) <= 1
    dec = api.decode(np.asarray(dem.symbols)[0, 0].astype(np.int32), cfg)
    assert api.extract_payloads(dec) == [bytes(p.tolist()) for p in payload]
