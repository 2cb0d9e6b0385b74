"""The program's own spans (``uce_tpu_torch.utils.observability``) as the
per-layer metrics read them after a ``--trace 1`` run.

The measured spans are those of the window that the profiler did not see:
a span whose ``profiled`` is true ran slower under the profiler, and one
that started before the first profiled span belongs to set-up (the
drivers start the profiler first thing in the window), as does a span
marked ``warmup`` and everything under it. A program without the
recorder gives no spans, and every reader then gives None.
"""

from __future__ import annotations

import statistics

MIN_SAMPLES = 10


def program_spans() -> list[dict]:
    from uce_tpu_torch.utils import observability

    read = getattr(observability, "spans", None)
    return read() if read is not None else []


def measured(spans: list[dict]) -> list[dict]:
    by_id = {s["id"]: s for s in spans}
    starts = [s["start_ns"] for s in spans if s["profiled"]]
    since = min(starts) if starts else None

    def warm(s):
        while s is not None:
            if s.get("warmup"):
                return True
            s = by_id.get(s["parent"])
        return False

    return [s for s in spans if not s["profiled"] and not warm(s)
            and (since is None or s["start_ns"] >= since)]


def median_ms(spans: list[dict], name: str, field: str,
              least: int = MIN_SAMPLES) -> float | None:
    """The median ``field`` (``host_s`` or ``stream_s``) of the measured
    spans called ``name``, in ms; None with fewer than ``least``."""
    values = [s[field] for s in measured(spans) if s["name"] == name and s[field] is not None]
    return 1e3 * statistics.median(values) if len(values) >= least else None
