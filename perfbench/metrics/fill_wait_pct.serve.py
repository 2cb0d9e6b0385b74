"""fill_wait_pct.serve: the share of the batcher's time spent waiting out
``max_wait_ms`` with a batch begun (the program's ``serve.fill`` spans), in
%, over the wall time from the first to the last of the batcher's spans
(``serve.idle``, ``serve.fill``, ``serve.batch``) that the profiler did not
see, warm-up left out."""

from perfbench.core.spans import MIN_SAMPLES, measured, program_spans

BATCHER = ("serve.idle", "serve.fill", "serve.batch")


def value(spans):
    mine = [s for s in measured(spans) if s["name"] in BATCHER]
    fills = [s["host_s"] for s in mine if s["name"] == "serve.fill"]
    if len(fills) < MIN_SAMPLES:
        return None
    wall = (max(s["end_ns"] for s in mine) - min(s["start_ns"] for s in mine)) / 1e9
    return 100.0 * sum(fills) / wall


def read(ctx):
    return value(program_spans())
