"""Entry points that measure the card refuse to run without one; the
compile cache, the native library's staleness check, the profiler wrapper
and the stage-trace reduction behave as documented."""

import os
import sys

import pytest
import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_refuses_a_cpu_device(capsys):
    import chip_smoke

    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.phase_device()
    assert "ok" not in capsys.readouterr().out


def test_bench_refuses_to_run_without_gpu(capsys):
    from lora_tpu import benchmarks

    with pytest.raises(RuntimeError, match="no GPU"):
        benchmarks.main()
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("env", [None, "/some/where/else"])
def test_compile_cache_dir_choice(monkeypatch, env):
    from lora_tpu.utils import compile_cache

    if env is None:
        monkeypatch.delenv(compile_cache.ENV, raising=False)
        assert compile_cache.cache_dir() == os.path.join(ROOT, ".jax_cache")
    else:
        monkeypatch.setenv(compile_cache.ENV, env)
        assert compile_cache.cache_dir() == env


def test_native_library_staleness(tmp_path):
    from lora_tpu.runtime import iqio

    src, so, stamp = (tmp_path / n for n in ("a.cpp", "a.so", "a.host"))
    src.write_text("// source")
    assert iqio.is_stale(so, stamp, src)  # never built
    so.write_bytes(b"")
    stamp.write_text(iqio.host_key())
    os.utime(src, (1, 1))
    assert not iqio.is_stale(so, stamp, src)
    stamp.write_text("another-host")
    assert iqio.is_stale(so, stamp, src)
    stamp.write_text(iqio.host_key())
    os.utime(src, None)  # source edited after the build
    os.utime(so, (1, 1))
    assert iqio.is_stale(so, stamp, src)


@pytest.mark.parametrize("traced", [False, True])
def test_profile_lets_errors_through(tmp_path, traced):
    from lora_tpu.utils.trace import profile

    with pytest.raises(ValueError, match="inside"):
        with profile(str(tmp_path / "tr") if traced else None):
            raise ValueError("inside the region")


def _trace_stages():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import trace_stages

    return trace_stages


def test_stage_trace_attributes_named_scopes(tmp_path):
    trace_stages = _trace_stages()
    from lora_tpu import api, benchmarks as bm

    cfg = bm.flagship_cfg(7).replace(mtu=12)
    iq, _ = bm.build_bank(cfg, 2)

    def step(x):
        dem = api.demodulate(x, cfg)
        return api.decode(dem.symbols.astype(jnp.int32), cfg).data

    jstep = jax.jit(step)
    scopes = trace_stages.hlo_scopes(jstep.lower(iq).compile().as_text())
    assert set(scopes.values()) == set(trace_stages.STAGES)
    jax.block_until_ready(jstep(iq))
    with jax.profiler.trace(str(tmp_path)):
        jax.block_until_ready(jstep(iq))
    path = next(tmp_path.glob("**/*.xplane.pb"))
    red = trace_stages.reduce_trace(str(path), scopes, plane_prefix="/host:CPU")
    assert red["stage_ms"].get("coarse_detect", 0.0) > 0.0
    assert 0.0 < red["busy_ms"] <= red["window_ms"]


_HLO = """HloModule m

%fused_gather (param_0.1: f32[64,1024], param_1.1: s32[4,1]) -> f32[4,1024] {
  %param_0.1 = f32[64,1024]{1,0} parameter(0)
  %param_1.1 = s32[4,1]{1,0} parameter(1)
  %gather.1 = f32[4,1,1024]{2,1,0} gather(%param_0.1, %param_1.1), offset_dims={1,2}, collapsed_slice_dims={}, start_index_map={0}, index_vector_dim=1, slice_sizes={1,1024}
  ROOT %bitcast.2 = f32[4,1024]{1,0} bitcast(%gather.1)
}

%fused_negate (param_0.3: f32[4,1024]) -> f32[4,1024] {
  %param_0.3 = f32[4,1024]{1,0} parameter(0)
  ROOT %negate.1 = f32[4,1024]{1,0} negate(%param_0.3)
}

%fused_compare (param_0.4: s32[]) -> pred[] {
  %param_0.4 = s32[] parameter(0)
  %constant.1 = s32[] constant(3)
  ROOT %compare.1 = pred[] compare(%param_0.4, %constant.1), direction=LT
}

%body (arg.1: (s32[], f32[4,1024])) -> (s32[], f32[4,1024]) {
  %arg.1 = (s32[], f32[4,1024]{1,0}) parameter(0)
  %get-tuple-element.1 = s32[] get-tuple-element(%arg.1), index=0
  %get-tuple-element.2 = f32[4,1024]{1,0} get-tuple-element(%arg.1), index=1
  %loop_negate_fusion = f32[4,1024]{1,0} fusion(%get-tuple-element.2), kind=kLoop, calls=%fused_negate
  ROOT %tuple.1 = (s32[], f32[4,1024]{1,0}) tuple(%get-tuple-element.1, %loop_negate_fusion)
}

%cond (arg.2: (s32[], f32[4,1024])) -> pred[] {
  %arg.2 = (s32[], f32[4,1024]{1,0}) parameter(0)
  %get-tuple-element.3 = s32[] get-tuple-element(%arg.2), index=0
  ROOT %loop_compare_fusion = pred[] fusion(%get-tuple-element.3), kind=kLoop, calls=%fused_compare
}

ENTRY %main (x.1: f32[64,1024], i.1: s32[4,1]) -> c64[4,1024] {
  %x.1 = f32[64,1024]{1,0} parameter(0)
  %i.1 = s32[4,1]{1,0} parameter(1)
  %loop_gather_fusion = f32[4,1024]{1,0} fusion(%x.1, %i.1), kind=kLoop, calls=%fused_gather
  %constant.2 = s32[] constant(0)
  %tuple.2 = (s32[], f32[4,1024]{1,0}) tuple(%constant.2, %loop_gather_fusion)
  %while.1 = (s32[], f32[4,1024]{1,0}) while(%tuple.2), condition=%cond, body=%body, backend_config={"known_trip_count":{"n":"3"}}
  %get-tuple-element.4 = f32[4,1024]{1,0} get-tuple-element(%while.1), index=1
  %convert.1 = c64[4,1024]{1,0} convert(%get-tuple-element.4)
  ROOT %fft.1 = c64[4,1024]{1,0} fft(%convert.1), fft_type=FFT, fft_length={1024}
}
"""


def test_kernel_bytes_of_a_module():
    """Gathered rows only, loop kernels once per trip, the FFT in full."""
    nb = _trace_stages().kernel_bytes(_HLO)
    row = 1024 * 4
    assert nb["loop_gather_fusion"] == 4 * row + 16 + 4 * row
    assert nb["loop_negate_fusion"] == 3 * (8 * row)
    assert nb["loop_compare_fusion"] == 3 * (4 + 1)
    assert nb["convert.1"] == nb["convert_1"] == 4 * row + 8 * row
    assert nb["fft.1"] == 2 * 8 * 4 * 1024
    assert "while.1" not in nb and "tuple.2" not in nb


@pytest.mark.parametrize("case, fn, moved", [
    ("scale", lambda a: a * 2.0, 2 * 256 * 1024 * 4),
    ("slice", lambda a: a[:, 3:131] + 1.0, 2 * 256 * 128 * 4),
])
def test_kernel_bytes_of_a_compiled_step(case, fn, moved):
    ts = _trace_stages()
    x = jnp.ones((256, 1024), jnp.float32)
    nb = ts.kernel_bytes(jax.jit(fn).lower(x).compile().as_text())
    kernels = {k.replace(".", "_"): v for k, v in nb.items()}  # one spelling
    assert sum(kernels.values()) == moved


def test_kernel_table_shares():
    ts = _trace_stages()
    ms = {"fusion_1": 2.0, "fft.3": 1.0, "sort_2": 0.5}
    scopes = {"fusion_1": "coarse_detect", "fft.3": "coarse_detect"}
    nbytes = {"fusion_1": 3_350_000_000, "fft.3": 1_675_000_000}
    tab = ts.kernel_table(ms, scopes, nbytes, top=2)
    coarse = tab["stages"]["coarse_detect"]
    assert coarse["ms"] == 3.0 and coarse["bytes"] == 5_025_000_000
    assert coarse["hbm_share"] == pytest.approx(0.5)
    assert tab["stages"]["other"]["hbm_share"] is None  # no byte count
    assert [k["op"] for k in tab["kernels"]] == ["fusion_1", "fft.3"]
    assert tab["kernels"][0]["TBps"] == pytest.approx(1.675)
