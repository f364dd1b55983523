"""Per-stage and per-kernel device time of one warm demodulate + decode
step, from a profiler trace, with each kernel's bytes and HBM roofline
share.

The step's stages carry jax.named_scope names (models/demodulator.py,
models/decoder.py): coarse_detect, align, track, payload_detect, decode.
Each device op in the trace is attributed to a stage through the op_name
metadata of the compiled HLO, and its device durations are summed.

Bytes per kernel are computed from the compiled HLO's shapes
(`kernel_bytes`): what each top-level instruction writes (its result) and
reads (its operands).  Of a fusion's operand only the elements its result
needs count, so a row the fusion gathers counts and the rest of the bank
does not (`_demand`); where it needs more elements than it reads (two
slices of one gathered block, say), the count is high.  Kernels inside a
while loop count once per known trip.  A kernel's HBM share is its
bytes over 3.35 TB/s over its trace time.

    python tools/trace_stages.py [--sf 10] [--batch 4096] [--out DIR]

Prints one JSON object: the step's wall time (block_until_ready), device
busy time, per-stage device time, bytes and HBM share, the largest
kernels with theirs, the coarse detect's share of its one-read roofline
(the planar bank read once, over 3.35 TB/s, over the stage's time), and
the rate a plain 1 GiB copy reaches on the same card.
Runs only on a GPU.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import math
import os
import re
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGES = ("coarse_detect", "align", "track", "payload_detect", "decode")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
TOP_KERNELS = 12

_OP_RE = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+) = .*?metadata=\{[^}]*op_name="([^"]+)"'
)
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%([\w.\-]+) \(.*\{\s*$")
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%([\w.\-]+) = (.*?) ([a-z][\w\-]*)\((.*)$"
)
_ARRAY_RE = re.compile(r"\b(pred|bf16|[suf]\d+|c64|c128)\[([\d,]*)\]")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2,
                "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
                "f64": 8, "c64": 8, "c128": 16}
# bookkeeping and control flow launch no kernel of their own
_NO_KERNEL = {"parameter", "constant", "get-tuple-element", "tuple",
              "bitcast", "while", "conditional", "call", "after-all",
              "partition-id", "replica-id"}
# ops that read every element of their operands, whatever they yield
_READ_ALL = {"reduce", "reduce-window", "sort", "fft", "dot", "convolution",
             "scatter", "select-and-scatter", "custom-call", "all-reduce",
             "all-gather", "all-to-all", "collective-permute"}

Instr = collections.namedtuple(
    "Instr", "name nbytes elems op operands args attrs root"
)


def hlo_scopes(hlo_text: str) -> dict[str, str]:
    """HLO instruction name -> stage, from the op_name metadata.  Each
    name is also entered as its kernel spelling ("fusion.2" launches as
    "fusion_2")."""
    out = {}
    for line in hlo_text.splitlines():
        m = _OP_RE.match(line)
        if not m:
            continue
        parts = m.group(2).split("/")
        stage = next((s for s in STAGES if s in parts), None)
        if stage is not None:
            out[m.group(1)] = stage
            out[m.group(1).replace(".", "_")] = stage
    return out


def _arrays(shape: str) -> list[tuple[int, int]]:
    """(bytes per element, elements) of every array in an HLO shape."""
    return [
        (_DTYPE_BYTES[dt], math.prod(int(d) for d in dims.split(",") if d))
        for dt, dims in _ARRAY_RE.findall(shape)
    ]


def _split_call(rest: str) -> tuple[str, str]:
    """(operand list, attributes) of the text after `opcode(`."""
    depth = 0
    for i, c in enumerate(rest):
        if c == "(":
            depth += 1
        elif c == ")":
            if depth == 0:
                return rest[:i], rest[i + 1:]
            depth -= 1
    return rest, ""


def parse_hlo(hlo_text: str) -> tuple[dict[str, list[Instr]], str | None]:
    """{computation name: its instructions in order}, and the entry's
    name."""
    comps, entry, cur = {}, None, None
    for line in hlo_text.splitlines():
        m = _COMP_RE.match(line)
        if m:
            cur = comps.setdefault(m.group(1), [])
            if line.startswith("ENTRY"):
                entry = m.group(1)
            continue
        if line.startswith("}"):
            cur = None
            continue
        m = _INSTR_RE.match(line) if cur is not None else None
        if m:
            args, attrs = _split_call(m.group(4))
            arrays = _arrays(m.group(2))
            cur.append(Instr(
                m.group(1), sum(b * n for b, n in arrays),
                sum(n for _, n in arrays), m.group(3),
                re.findall(r"%([\w.\-]+)", args), args, attrs,
                line.lstrip().startswith("ROOT "),
            ))
    return comps, entry


def _demand(body: list[Instr], result_elems: int) -> dict[str, int]:
    """Elements of each instruction of a fused computation that its
    result needs, walking back from the root.  An op that maps output
    elements to input elements (elementwise, gather, slice, concatenate,
    broadcast, ...) needs at most as many of each operand as it yields;
    a reduction, FFT, sort or product needs all of its operands."""
    elems = {i.name: i.elems for i in body}
    need = collections.Counter()
    for ins in reversed(body):
        d = min(need[ins.name], ins.elems) if not ins.root else result_elems
        if not d:
            continue
        for o in ins.operands:
            if o in elems:
                want = (elems[o] if ins.op in _READ_ALL or ins.op == "tuple"
                        else d)
                need[o] = min(elems[o], need[o] + want)
    return need


def _operand_reads(ins: Instr, sizes: dict[str, Instr],
                   fused: list[Instr] | None) -> int:
    """Bytes a kernel reads of its operands: of a fusion's operand, the
    part its fused computation needs; of a plain op's, at most as many
    elements as it yields unless it reads all (_READ_ALL)."""
    total = 0
    if fused is not None:
        need = _demand(fused, ins.elems)
        params = {i.args.strip(): i.name for i in fused
                  if i.op == "parameter"}
    for k, o in enumerate(ins.operands):
        src = sizes.get(o)
        if src is None or not src.elems:
            continue
        if fused is not None:
            n = need[params[str(k)]] if str(k) in params else src.elems
        elif ins.op in _READ_ALL:
            n = src.elems
        else:
            n = min(src.elems, ins.elems)
        total += src.nbytes * n // src.elems
    return total


def kernel_bytes(hlo_text: str) -> dict[str, int]:
    """HLO instruction name -> bytes its kernel moves in one run of the
    module: result bytes written plus operand bytes read, times the known
    trip count of every while loop around it.  Each name is also entered
    as its kernel spelling, as in hlo_scopes."""
    comps, entry = parse_hlo(hlo_text)
    out = {}

    def walk(comp: str, mult: int) -> None:
        body = comps.get(comp, [])
        sizes = {i.name: i for i in body}
        for ins in body:
            if ins.op == "while":
                trip = _TRIP_RE.search(ins.attrs)
                n = int(trip.group(1)) if trip else 1
                for key in ("condition", "body"):
                    m = re.search(key + r"=%([\w.\-]+)", ins.attrs)
                    if m:
                        walk(m.group(1), mult * n)
                continue
            if ins.op in _NO_KERNEL:
                continue
            called = re.search(r"calls=%([\w.\-]+)", ins.attrs)
            fused = comps.get(called.group(1)) if called else None
            nbytes = mult * (ins.nbytes + _operand_reads(ins, sizes, fused))
            out[ins.name] = out[ins.name.replace(".", "_")] = nbytes

    if entry is not None:
        walk(entry, 1)
    return out


def reduce_trace(path: str, scopes: dict[str, str],
                 plane_prefix: str = "/device:GPU") -> dict:
    """Sum device-event durations per stage and per HLO op over the planes
    of one .xplane.pb whose name starts with plane_prefix; also the busy
    union and the lines seen."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    per = collections.Counter()
    ops = collections.Counter()
    spans = []
    lines_seen = {}
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        lines = list(plane.lines)
        names = [ln.name for ln in lines]
        # one event per HLO op: the "XLA Ops" line where it exists
        use = [ln for ln in lines if ln.name == "XLA Ops"] or lines
        for ln in use:
            n = 0
            for ev in ln.events:
                # kernels replayed from a command buffer carry
                # hlo_op="command_buffer" and their own name
                op = str(dict(ev.stats).get("hlo_op", ev.name))
                if op == "command_buffer":
                    op = ev.name
                per[scopes.get(op, "other")] += ev.duration_ns
                ops[op] += ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                n += 1
            lines_seen[f"{plane.name}:{ln.name}"] = n
        lines_seen[f"{plane.name}:all"] = names
    spans.sort()
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    return {
        "stage_ms": {k: v / 1e6 for k, v in sorted(per.items())},
        "op_ms": {k: v / 1e6 for k, v in ops.most_common()},
        "busy_ms": busy / 1e6,
        "window_ms": window / 1e6,
        "lines": lines_seen,
    }


def _rate(nbytes: int | None, ms: float) -> dict:
    if not nbytes or not ms:
        return {"bytes": nbytes, "TBps": None, "hbm_share": None}
    bps = nbytes / (ms / 1e3)
    return {"bytes": nbytes, "TBps": bps / 1e12,
            "hbm_share": bps / HBM_BYTES_PER_S}


def kernel_table(op_ms: dict[str, float], scopes: dict[str, str],
                 nbytes: dict[str, int], top: int = TOP_KERNELS) -> dict:
    """Per stage and for the `top` longest ops: trace ms, bytes moved,
    TB/s and HBM share.  A stage's bytes are those of its ops whose bytes
    are known; ops without a byte count (kernels the HLO does not name)
    count toward its time only."""
    stage_ms = collections.Counter()
    stage_bytes = collections.Counter()
    for op, ms in op_ms.items():
        stage = scopes.get(op, "other")
        stage_ms[stage] += ms
        stage_bytes[stage] += nbytes.get(op, 0)
    longest = sorted(op_ms.items(), key=lambda kv: -kv[1])[:top]
    return {
        "stages": {s: {"ms": stage_ms[s], **_rate(stage_bytes[s], stage_ms[s])}
                   for s in sorted(stage_ms)},
        "kernels": [{"op": op, "stage": scopes.get(op, "other"), "ms": ms,
                     **_rate(nbytes.get(op), ms)} for op, ms in longest],
    }


def copy_rate(nbytes: int = 1 << 30, reps: int = 20) -> float:
    """TB/s a plain elementwise pass over `nbytes` of f32 reaches (read
    plus write): `reps` dependent passes in one program, so that one
    dispatch and one readback are spread over them; bytes as kernel_bytes
    counts them in the compiled program, over the median of 5 runs."""
    import statistics

    import jax
    import jax.numpy as jnp

    from lora_tpu import benchmarks as bm

    x = jnp.ones(nbytes // 4, jnp.float32)
    f = jax.jit(lambda a: jax.lax.fori_loop(0, reps, lambda i, v: v * 0.5, a))
    nb = kernel_bytes(f.lower(x).compile().as_text())
    moved = sum({k.replace(".", "_"): v for k, v in nb.items()}.values())
    return moved / statistics.median(bm.time_steps(f, x, 5)) / 1e12


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--out", help="trace directory (default: a temp dir)")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from lora_tpu import api
    from lora_tpu import benchmarks as bm
    from lora_tpu.utils.compile_cache import enable_compile_cache

    bm.require_gpu()
    card = bm.card_info()
    enable_compile_cache()
    cfg = bm.flagship_cfg(args.sf)
    iq, payload = bm.build_bank(cfg, args.batch)

    def step(x):
        dem = api.demodulate(x, cfg)
        return dem, api.decode(dem.symbols.astype(jnp.int32), cfg)

    jstep = jax.jit(step)
    hlo = jstep.lower(iq).compile().as_text()
    dem, _ = jax.block_until_ready(jstep(iq))
    bm.check_payloads(dem, cfg, payload)
    wall = bm.time_steps(jstep, iq, 3)
    out = args.out or tempfile.mkdtemp(prefix="trace_stages_")
    with jax.profiler.trace(out):
        jax.block_until_ready(jstep(iq))
    path = sorted(glob.glob(f"{out}/**/*.xplane.pb", recursive=True))[-1]
    scopes = hlo_scopes(hlo)
    red = reduce_trace(path, scopes)
    table = kernel_table(red.pop("op_ms"), scopes, kernel_bytes(hlo))
    B, T = iq.shape
    coarse_ms = red["stage_ms"].get("coarse_detect", 0.0)
    print(json.dumps({
        "sf": args.sf,
        "batch": B,
        "samples_per_channel": T,
        "step_wall_ms": [t * 1e3 for t in wall],
        **red,
        **table,
        # one read of the planar f32 bank: the least the stage must move
        "coarse_detect_roofline_share": _rate(B * T * 8, coarse_ms)[
            "hbm_share"],
        "copy_TBps": copy_rate(),
        "trace": path,
        "device": bm.device_record(),
        "card": card,
    }))


if __name__ == "__main__":
    main()
