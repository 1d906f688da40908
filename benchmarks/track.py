"""Longitudinal benchmark tracking + regression gate.

Role parity with the reference's ASV setup (asv.conf.json + 15 suites
with `track_` counters): each `record` run executes the stage suite
(benchmarks.benchmarks) and appends one JSON line — git revision,
timestamp, machine fingerprint, and every (suite, name, value, unit)
row — to benchmarks/history.jsonl.  `compare` checks the newest record
against the median of the previous K records for the same machine and
fails (exit 1) on regressions beyond the threshold, which is the CI
regression gate the reference gets from `asv compare`.

    python benchmarks/track.py record [--quick] [--history PATH]
    python benchmarks/track.py compare [--threshold 1.3] [--window 5]
    python benchmarks/track.py report [--last N]

History lines are append-only and plain JSON, so the file is diffable,
mergeable, and trivially plotted.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import platform
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
DEFAULT_HISTORY = pathlib.Path(__file__).resolve().parent / "history.jsonl"

# Timing rows regress when slower (value ratio > threshold); counter
# rows (iterations, triangles, bytes) regress when they *grow* — both
# use the same ratio gate.
_TIME_UNITS = {"s", "ms", "us"}


def _git_rev() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
            capture_output=True, text=True, check=True,
        ).stdout.strip()
    except Exception:
        return "unknown"


def _machine() -> str:
    try:
        import jax

        # The backend the stage suite ran on (benchmarks.py follows
        # JAX_PLATFORMS).
        dev = jax.devices()[0]
        backend = f"{dev.platform}:{getattr(dev, 'device_kind', '?')}"
    except Exception:
        backend = "nojax"
    return f"{platform.machine()}/{backend}"


def _load_history(path: pathlib.Path) -> list[dict]:
    if not path.exists():
        return []
    out = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if line:
            out.append(json.loads(line))
    return out


def cmd_record(args) -> int:
    from benchmarks import benchmarks as suite

    res = suite.Results()
    quick = args.quick
    suite.bench_geometry(res, quick)
    suite.bench_meshing(res, quick)
    suite.bench_distance_map(res, quick)
    boards = pathlib.Path(args.boards)
    if boards.exists():
        suite.bench_loading(res, boards, quick)
        suite.bench_solver(res, boards, quick)
    suite.bench_device(res, quick)

    record = {
        "ts": time.time(),
        "rev": _git_rev(),
        "machine": _machine(),
        "quick": bool(quick),
        "rows": res.rows,
    }
    path = pathlib.Path(args.history)
    with path.open("a") as f:
        f.write(json.dumps(record) + "\n")
    print(f"recorded {len(res.rows)} rows at {record['rev']} -> {path}")
    return 0


def compare_records(newest: dict, baseline: list[dict],
                    threshold: float) -> list[dict]:
    """Regressions of `newest` vs the per-row median of `baseline`."""
    import statistics

    base_vals: dict[tuple, list[float]] = {}
    for rec in baseline:
        for row in rec["rows"]:
            base_vals.setdefault((row["suite"], row["name"]), []).append(
                float(row["value"]))
    regressions = []
    for row in newest["rows"]:
        key = (row["suite"], row["name"])
        if key not in base_vals:
            continue
        med = statistics.median(base_vals[key])
        val = float(row["value"])
        if med <= 0:
            continue
        ratio = val / med
        if ratio > threshold:
            regressions.append({
                "suite": row["suite"], "name": row["name"],
                "unit": row["unit"], "median": med, "value": val,
                "ratio": ratio,
            })
    return regressions


def cmd_compare(args) -> int:
    history = _load_history(pathlib.Path(args.history))
    if len(history) < 2:
        print("need at least 2 history records to compare")
        return 0
    newest = history[-1]
    same = [h for h in history[:-1]
            if h["machine"] == newest["machine"]
            and h.get("quick") == newest.get("quick")]
    if not same:
        print(f"no prior records for machine {newest['machine']}")
        return 0
    baseline = same[-args.window:]
    regs = compare_records(newest, baseline, args.threshold)
    if not regs:
        print(f"{newest['rev']}: no regressions beyond {args.threshold}x "
              f"vs median of {len(baseline)} prior run(s)")
        return 0
    print(f"{newest['rev']}: {len(regs)} regression(s) "
          f"(> {args.threshold}x the {len(baseline)}-run median):")
    for r in sorted(regs, key=lambda r: -r["ratio"]):
        print(f"  {r['suite']}/{r['name']}: {r['median']:.4g} -> "
              f"{r['value']:.4g} {r['unit']} ({r['ratio']:.2f}x)")
    return 1


def cmd_report(args) -> int:
    history = _load_history(pathlib.Path(args.history))
    if not history:
        print("no history")
        return 0
    recent = history[-args.last:]
    names = []
    for rec in recent:
        for row in rec["rows"]:
            key = (row["suite"], row["name"], row["unit"])
            if key not in names:
                names.append(key)
    width = max(len(f"{s}/{n}") for s, n, _ in names)
    header = " ".join(f"{rec['rev']:>10}" for rec in recent)
    print(f"{'benchmark':<{width}} {header}")
    for suite_name, name, unit in names:
        cells = []
        for rec in recent:
            val = next((r["value"] for r in rec["rows"]
                        if r["suite"] == suite_name and r["name"] == name),
                       None)
            cells.append(f"{val:>10.4g}" if val is not None else f"{'-':>10}")
        print(f"{suite_name + '/' + name:<{width}} {' '.join(cells)} {unit}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="padne-tpu-bench-track")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rec = sub.add_parser("record", help="run the suite and append a record")
    rec.add_argument("--quick", action="store_true")
    rec.add_argument("--history", default=str(DEFAULT_HISTORY))
    rec.add_argument("--boards", default="/root/reference/tests/kicad")

    cmp_ = sub.add_parser("compare", help="gate newest record vs history")
    cmp_.add_argument("--history", default=str(DEFAULT_HISTORY))
    cmp_.add_argument("--threshold", type=float, default=1.3)
    cmp_.add_argument("--window", type=int, default=5)

    rep = sub.add_parser("report", help="tabulate recent records")
    rep.add_argument("--history", default=str(DEFAULT_HISTORY))
    rep.add_argument("--last", type=int, default=8)

    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    return {"record": cmd_record, "compare": cmd_compare,
            "report": cmd_report}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
