"""The hand-written kernels' registry (uce_tpu_torch/ops/kernels/__init__.py):
``build_all`` builds a library for every source under csrc/, ``launches``
names every counter that the wrappers bump (and nothing else), ``route``
switches kernels off by name and back, and a mesh on the card prebuilds
every library through ``build_all`` before its workers start."""

import ast
import re
import types
from pathlib import Path

import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu_torch.ops import kernels
from uce_tpu_torch.ops.kernels import _build, sd_attention
from uce_tpu_torch.parallel import workers

WRAPPERS = sorted(p for p in Path(kernels.__file__).parent.glob("*.py")
                  if not p.name.startswith("_"))


def test_build_all_builds_a_library_for_every_source(monkeypatch):
    built = []
    monkeypatch.setattr(_build, "load_library",
                        lambda name, sources: built.append((name, sources)))
    kernels.build_all()
    sources = {p.name for p in _build.CSRC.glob("*.cu")}
    assert sorted(built) == sorted((n, (f"{n}.cu",)) for n in kernels.LIBRARIES)
    assert {s for _, (s,) in built} == sources and len(built) == len(sources)


def _counted_names():
    """The counter names of every ``count(...)`` call in the wrappers: a
    literal, or an f-string as a regex."""
    names, patterns = set(), []
    for path in WRAPPERS:
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "count"):
                continue
            for arg in node.args:
                if isinstance(arg, ast.Constant):
                    names.add(arg.value)
                else:
                    assert isinstance(arg, ast.JoinedStr), ast.dump(arg)
                    patterns.append("".join(
                        re.escape(v.value) if isinstance(v, ast.Constant) else r"\d+"
                        for v in arg.values))
    return names, patterns


def test_launches_names_every_counter_the_wrappers_bump():
    names, patterns = _counted_names()
    counters = set(kernels.launches())
    assert names and patterns == [r"sd_attention_d\d+"]
    assert names <= counters
    # the bf16 attention counts each head dim it takes
    assert {f"sd_attention_d{d}" for d in sd_attention.HEAD_DIMS} <= counters
    # and no counter is left that no wrapper bumps
    assert all(n in names or any(re.fullmatch(p, n) for p in patterns) for n in counters)
    assert set(kernels.KERNELS) <= names


def test_count_and_reset():
    kernels.reset_launches()
    kernels.count("conv3x3", "conv3x3_wgmma")
    kernels.count("group_norm_act", n=3)
    got = kernels.launches()
    assert got["conv3x3"] == got["conv3x3_wgmma"] == 1 and got["group_norm_act"] == 3
    got["conv3x3"] = 99  # a snapshot, not the counters
    assert kernels.launches()["conv3x3"] == 1
    kernels.reset_launches()
    assert not any(kernels.launches().values())
    with pytest.raises(KeyError):
        kernels.count("no_such_kernel")


def test_route_switches_kernels_off_and_back():
    assert kernels.on(*kernels.KERNELS)
    with kernels.route(("sd_attention",)):
        assert not kernels.on("sd_attention") and kernels.on("conv3x3", "qk_norm_rope")
        with kernels.route(("conv3x3",)):
            assert not kernels.on("conv3x3") and not kernels.on("sd_attention")
        assert kernels.on("conv3x3")
    with kernels.route():
        assert not any(kernels.on(k) for k in kernels.KERNELS)
    with kernels.route(()):
        assert kernels.on(*kernels.KERNELS)
    with pytest.raises(ValueError, match="unknown"):
        with kernels.route(("uce_solve",)):
            pass
    assert kernels.on(*kernels.KERNELS)


def test_layers_route_follows_the_switch():
    from uce_tpu_torch.models import layers

    x = torch.zeros(1, 8, 4, 4, dtype=torch.bfloat16)
    assert layers.kernel_route(x) and layers.kernel_route(x, "conv3x3")
    assert not layers.kernel_route(x.float())
    with kernels.route(("group_norm_act",)):
        assert layers.kernel_route(x, "conv3x3")
        assert not layers.kernel_route(x, "group_norm_act") and not layers.kernel_route(x)


@pytest.mark.parametrize("device,builds", [("cuda", 1), ("cpu", 0)])
def test_prebuild_builds_every_library_on_the_card(monkeypatch, device, builds):
    calls = []
    monkeypatch.setattr(kernels, "build_all", lambda: calls.append("build_all"))
    workers._prebuild(types.SimpleNamespace(devices=[torch.device(device, 0)]))
    assert calls == ["build_all"] * builds
