"""The device trace of a ``--trace 1`` run: torch.profiler over a part of
the window, read back from its Chrome trace.

Device time is every kernel, memcpy and memset event; busy seconds are
the union of their intervals, the window runs from the first to the last
event of the trace, and the idle gaps are the holes in the union, each
labelled with the innermost host operation running at its middle.
"""

from __future__ import annotations

import collections
import json
import os
import re
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
TOP = 10
NAME_CHARS = 120  # a kernel's demangled name can run to thousands


class Tracer:
    """Start and stop a profiler around part of the window; ``summary``
    holds what ``read`` found once it has stopped."""

    def __init__(self, path: str):
        self.path, self.prof, self.summary = path, None, None
        self.started = self.stopped = False

    @property
    def running(self) -> bool:
        return self.started and not self.stopped

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.started = True

    def stop(self) -> None:
        if not self.running:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.stopped = True

    def read(self) -> None:
        """Export and read the trace (after the window: it takes seconds)."""
        if not self.stopped or self.summary is not None:
            return
        start = time.perf_counter()
        self.prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(self.path)
        self.summary = read(events)
        self.summary["read_s"] = time.perf_counter() - start


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(events: list[dict]) -> dict:
    """Device ops [(name, start_us, dur_us)], busy and window seconds, the
    top device ops and the longest idle gaps by host activity."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [(e["name"], float(e["ts"]), float(e["dur"])) for e in spans
           if e.get("cat") in DEVICE_CATS]
    host = [(e["name"], float(e["ts"]), float(e["dur"])) for e in spans
            if e.get("cat") in HOST_CATS]
    if not spans:
        return {"device": [], "busy_s": 0.0, "window_s": 0.0, "device_ops": [], "idle_gaps": []}
    lo = min(float(e["ts"]) for e in spans)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    busy = _union([(s, s + d) for _, s, d in dev])
    holes = [(a, b) for a, b in zip([lo] + [b for _, b in busy],
                                    [a for a, _ in busy] + [hi]) if b > a]
    holes.sort(key=lambda h: h[0] - h[1])
    by_name = collections.Counter()
    for name, _, d in dev:
        by_name[name] += d / 1e6

    def host_at(t):
        inside = [(d, n) for n, s, d in host if s <= t <= s + d]
        return "host: " + (min(inside)[1] if inside else "no recorded host op")

    return {"device": dev,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "window_s": (hi - lo) / 1e6,
            "device_ops": [[n[:NAME_CHARS], s] for n, s in by_name.most_common(TOP)],
            "idle_gaps": [[host_at((a + b) / 2), (b - a) / 1e6] for a, b in holes[:TOP]]}


def device_seconds(summary: dict, patterns) -> float:
    """Device seconds of the ops whose names match any of ``patterns``."""
    rx = re.compile("|".join(patterns))
    return sum(d for n, _, d in summary["device"] if rx.search(n)) / 1e6


def idle_pct(summary: dict | None) -> float | None:
    if not summary or summary["window_s"] <= 0 or not summary["device"]:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
