"""One run of one cell: build the system, warm it, measure, check, report.

Everything particular to a configuration, a traffic mix or a metric is a
file of its own that this module finds by name:

* ``BENCHMARK.json`` names the cell's configuration and traffic mix;
* ``configs/<name>.json`` holds the configuration; its ``family`` names
  ``families/<family>.py``, which builds the system under test from the
  benchmark's inputs and computes the reference's answers;
* ``traffic/<name>.json`` holds the traffic mix; its ``driver`` names
  ``drivers/<driver>.py``, which warms the system and runs the window;
* ``limits/<cell>.json`` holds the limits of the correctness check;
* ``metrics/<metric>.py`` reads one metric from what the run recorded.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "uce_tpu")
PROGRAM = "uce_tpu_torch"


def load(kind: str, name: str):
    """The module ``perfbench/<kind>/<name>.py``."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def cell_files(manifest: dict, cell: str) -> dict:
    """The cell's entry, configuration, traffic mix, limits and metrics."""
    work = {w["name"]: w for w in manifest["workloads"]}
    if cell not in work:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    entry = work[cell]
    config = next(c for c in manifest["configs"] if c["name"] == entry["config"])

    def takes(metric):
        return cell in metric.get("workloads", [cell])

    return {"entry": entry,
            "config": read_json(ROOT / config["file"]),
            "traffic": read_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
            "limits": read_json(BENCH / "limits" / f"{cell}.json"),
            "end_to_end": [m for m in manifest["end_to_end"] if takes(m)],
            "per_layer": [m for m in manifest["per_layer"] if takes(m)]}


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(files: dict, seed: int, seconds: float, trace: bool, device, workdir: str,
             t0: float, control: bool = False) -> dict:
    """The result line's fields (without ``device``) and the checks.
    ``control`` switches on the program's lower-precision path (the
    correctness check's control; ``perfbench/probe.py``)."""
    import torch

    cfg, traffic, limits = files["config"], files["traffic"], files["limits"]
    family = load("families", cfg["family"])
    driver = load("drivers", traffic["driver"])
    phases = {"to_build": time.perf_counter() - t0}
    system = family.build(cfg, seed, device, workdir, phases)
    if control:
        family.control(system)
    mark = time.perf_counter()
    driver.warm(family, system, traffic)
    phases["warm"] = time.perf_counter() - mark
    setup_s = time.perf_counter() - t0
    tracer = None
    if trace:
        from perfbench.core.trace import Tracer
        tracer = Tracer(os.path.join(workdir, "trace.json"))
    rec = driver.run(family, system, traffic, seed, seconds, tracer)
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    family.free(system)
    del system
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    # the checked answers: a sample drawn from the seed
    answers = rec["answers"]
    rng = np.random.default_rng([int(seed), 4])
    pick = sorted(rng.choice(len(answers), size=min(limits["checked"], len(answers)),
                             replace=False).tolist()) if answers else []
    jobs = [answers[i][0] for i in pick]
    ref_start = time.perf_counter()
    want = family.reference(cfg, traffic, seed, jobs, device, workdir) if jobs else None
    from perfbench.core.compare import checks, image_gaps
    gaps = image_gaps([answers[i][1] for i in pick], want) if jobs else []
    result_checks = checks(gaps, rec["failed"], len(answers), limits)
    ctx = {"config": cfg, "traffic": traffic, "setup_s": setup_s, "record": rec,
           "trace": tracer.summary if tracer else None,
           "work": family.work(cfg, traffic) if trace else None}  # read by per-layer metrics
    metrics = {}
    for m in files["per_layer"] if trace else files["end_to_end"]:
        value = load("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": all(c["ok"] for c in result_checks.values()),
           "attempted": rec["attempted"], "failed": rec["failed"], "metrics": metrics,
           "memory_peak_bytes": int(peak), "reference_s": time.perf_counter() - ref_start,
           "lateness": rec.get("lateness"), "gaps": gaps, "record": rec,
           "setup_phases": phases,
           "checks": {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in result_checks.items()}}
    if tracer is not None and tracer.summary:
        s = tracer.summary
        out["busy_s"], out["window_s"] = s["busy_s"], s["window_s"]
        out["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    return out


def main(argv, t0: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "BENCHMARK.json").exists():
        print("BENCHMARK.json is missing", file=sys.stderr)
        return 2
    files = cell_files(read_json(ROOT / "BENCHMARK.json"), args.workload)
    spec = importlib.util.find_spec(PROGRAM) if (ROOT / PROGRAM).is_dir() else None
    if spec is None or not Path(spec.origin).resolve().is_relative_to(ROOT / PROGRAM):
        print(f"the system under test ({PROGRAM}) is not in this checkout", file=sys.stderr)
        return 4
    import torch

    chips = files["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    workdir = tempfile.mkdtemp(prefix="perfbench-")  # under TMPDIR
    try:
        out = run_cell(files, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda"), workdir, t0)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    found = loaded_forbidden()
    if found:
        print(f"modules that the run may not load are loaded: {found}", file=sys.stderr)
        return 5
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                       "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}}
    if args.trace:
        line["device"].update(busy_s=out.get("busy_s", 0.0), window_s=out.get("window_s", 0.0))
        if "breakdown" in out:
            line["breakdown"] = out["breakdown"]
    line["reference_s"] = out["reference_s"]
    if out["lateness"] is not None:
        print("generator lateness: " + json.dumps(out["lateness"]), flush=True)
    print("setup phases (s): " + json.dumps(out["setup_phases"]), file=sys.stderr, flush=True)
    line["checks"] = out["checks"]
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
