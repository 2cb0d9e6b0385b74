"""BENCHMARK.json against the benchmark's contract, every file it names,
and the import rule: nothing in perfbench/ imports jax, jaxlib, flax or
uce_tpu (top-level names compared whole: uce_tpu_torch is the port), and
the reference imports nothing of the port."""

import ast
import json
import re

import pytest

from perfbench.core import harness

MANIFEST = harness.read_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer", "moves", "workloads"}


def test_manifest_shape():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]
    assert MANIFEST["paths"] == ["perfbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in MANIFEST[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_configs_and_cells():
    cells = MANIFEST["workloads"]
    used = {c["config"] for c in cells}
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and LINE.match(c["why"]) and LINE.match(c["source"])
        assert c["file"].startswith("perfbench/") and harness.read_json(
            harness.ROOT / c["file"])["name"] == c["name"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)
    assert sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)
    for c in cells:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert c["chips"] in (1, 4) and LINE.match(c["why"]) and NAME.match(c["traffic"])
        files = harness.cell_files(MANIFEST, c["name"])
        e2e = {m["name"] for m in files["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and files["per_layer"]
        assert {"checked", "image_gap"} <= set(files["limits"])
        assert (harness.BENCH / "drivers" / f"{files['traffic']['driver']}.py").exists()
        assert (harness.BENCH / "families" / f"{files['config']['family']}.py").exists()
        assert (harness.ROOT / files["traffic"]["corpus"]).exists()


def test_metrics():
    cells = {c["name"] for c in MANIFEST["workloads"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= METRIC_KEYS - {"layer", "moves"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= METRIC_KEYS - {"bound"} and "bound" not in m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and LINE.match(m["layer"])
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()


def _imports(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(harness.BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_import_rule(path):
    found = set(_imports(path))
    assert not found & {"jax", "jaxlib", "flax", "uce_tpu"}, found
    if "reference" in path.relative_to(harness.BENCH).parts:
        assert "uce_tpu_torch" not in found


def test_the_run_refuses_forbidden_modules():
    assert "uce_tpu" in harness.FORBIDDEN and "uce_tpu_torch" not in harness.FORBIDDEN
    assert json.dumps(harness.loaded_forbidden()) == "[]"
