"""Round-5 paired-sensitivity campaign driver (verdict item 4).

Runs the full evidence-breadth matrix through ONE process (compiles are
shared across sub-runs):

  * SF 7/8/10/12 x CR 4/8 + 4/7, 32 frames/point, hard + soft
  * CR 4/5 at SF 7/10
  * the reference simulation topology's channel rotation (pi/1.2345,
    lora_simulation.pth) at SF 7/10
  * >= 128 frames at the threshold-adjacent headline points (SF7, SF10)

Each sub-run writes its own JSON; `--merge` combines them (plus dedup)
into docs/sensitivity_vs_reference.json.

Usage:
  python tools/run_sensitivity_campaign.py [--outdir /tmp/r5b] [--cpu]
  python tools/run_sensitivity_campaign.py --merge /tmp/r5b
"""

from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

ROT = "2.544690049407732"  # pi / 1.2345 (lora_simulation.pth channel)

RUNS = [
    ("main", ["--sf", "7", "8", "10", "12", "--cr", "4/8", "4/7",
              "--packets", "32", "--soft"]),
    ("cr45", ["--sf", "7", "10", "--cr", "4/5", "--packets", "32",
              "--soft"]),
    ("rot", ["--sf", "7", "10", "--cr", "4/8", "--rotate", ROT,
             "--packets", "32", "--soft"]),
    ("deep7", ["--sf", "7", "--cr", "4/8", "--noise", "1.7", "2.0", "2.3",
               "--packets", "128", "--soft"]),
    ("deep10", ["--sf", "10", "--cr", "4/8", "--noise", "4.8", "5.6",
                "6.4", "--packets", "128", "--soft"]),
]


def merge(outdir: pathlib.Path) -> None:
    rows = []
    for name, _ in RUNS:
        f = outdir / f"sens_{name}.json"
        if not f.exists():
            print(f"missing {f}; skipping", file=sys.stderr)
            continue
        rows.extend(json.loads(f.read_text()))
    # dedup on the full operating point, later runs win (deep n=128 rows
    # replace the 32-frame rows at the same point)
    seen = {}
    for r in rows:
        seen[(r["sf"], r["cr"], r["noise_ampl"], r.get("rotate", 0))] = r
    merged = sorted(
        seen.values(),
        key=lambda r: (r["sf"], r["cr"], r.get("rotate", 0), r["noise_ampl"]),
    )
    out = ROOT / "docs" / "sensitivity_vs_reference.json"
    out.write_text(json.dumps(merged, indent=1))
    worse = [
        r for r in merged if r["recovered_ours"] < r["recovered_ref"]
    ]
    print(f"wrote {out}: {len(merged)} points, "
          f"{sum(1 for r in merged if r['recovered_ours'] > r['recovered_ref'])}"
          f" better, {len(worse)} worse")
    for r in worse:
        print("WORSE:", json.dumps(r))


def main() -> None:
    if "--merge" in sys.argv:
        merge(pathlib.Path(sys.argv[sys.argv.index("--merge") + 1]))
        return
    outdir = pathlib.Path("/tmp/r5b")
    if "--outdir" in sys.argv:
        outdir = pathlib.Path(sys.argv[sys.argv.index("--outdir") + 1])
    outdir.mkdir(parents=True, exist_ok=True)
    extra = ["--cpu"] if "--cpu" in sys.argv else []

    import bench_sensitivity as bs

    for name, argv in RUNS:
        out = outdir / f"sens_{name}.json"
        print(f"=== campaign run {name}", flush=True)
        sys.argv = ["bench_sensitivity.py", *argv, *extra, "--out", str(out)]
        bs.main()
    merge(outdir)


if __name__ == "__main__":
    main()
