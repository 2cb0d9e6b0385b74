"""Readings behind the benchmark's fixed numbers; not part of a benchmark
run. Runs a cell's whole check once per seed in one process and prints one
JSON line per seed: the checks, each checked image's gap, the run's
end-to-end metrics and, for a served cell, its latency over the window.

    python3 perfbench/probe.py --workload CELL --seeds 11,12,13 --seconds 5
        [--control] [--set KEY=JSON ...]

``--control`` runs the control in place of the program as the cell states
it: the program's W8A8 path (``--quantize int8``), for the limits of the
correctness check. ``--set`` overrides a key of the traffic mix (the
serving cell's knee sweep: ``--set 'arrivals={"process": "poisson",
"rate": 4.0, "order_seed": 0}'``).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.core import harness  # noqa: E402


def serving(rec: dict) -> dict:
    """Latency over the window: completed requests a second from the first
    due time, and the median latency of the last fifth of requests against
    the first fifth (a backlog that grows through the window shows there)."""
    lat = [x for x in rec["latencies"] if x is not None]
    if not lat:
        return {}
    fifth = max(len(lat) // 5, 1)
    return {"requests": len(rec["latencies"]), "answered": len(lat),
            "p50_s": float(np.percentile(lat, 50)), "p90_s": float(np.percentile(lat, 90)),
            "first_fifth_p50_s": float(np.median(lat[:fifth])),
            "last_fifth_p50_s": float(np.median(lat[-fifth:])), "server": rec["server"]}


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=JSON")
    args = ap.parse_args(argv)
    import torch

    files = harness.cell_files(harness.read_json(harness.ROOT / "BENCHMARK.json"),
                               args.workload)
    for item in args.set:
        key, _, value = item.partition("=")
        files["traffic"][key] = json.loads(value)
    for seed in (int(s) for s in args.seeds.split(",")):
        with tempfile.TemporaryDirectory(prefix="perfbench-") as workdir:
            out = harness.run_cell(files, seed, args.seconds, False, torch.device("cuda"),
                                   workdir, time.perf_counter(), control=args.control)
        rec = out["record"]
        print(json.dumps({"workload": args.workload, "control": args.control, "seed": seed,
                          "set": args.set, "correct": out["correct"], "gaps": out["gaps"],
                          "checks": out["checks"], "metrics": out["metrics"],
                          "serving": serving(rec) if "latencies" in rec else None,
                          "reference_s": out["reference_s"],
                          "memory_peak_bytes": out["memory_peak_bytes"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
