"""queue_wait_p90_s.serve: the 90th percentile (linear interpolation) of a
request's queue wait, from its submit() to the start of its batch (the
program's ``serve.queue`` span), in s, over the requests whose batch (the
``serve.batch`` span it lies in) the profiler did not see."""

import numpy as np

from perfbench.core.spans import MIN_SAMPLES, measured, program_spans


def value(spans):
    batches = {s["id"] for s in measured(spans) if s["name"] == "serve.batch"}
    waits = [s["host_s"] for s in spans if s["name"] == "serve.queue" and s["parent"] in batches]
    return float(np.percentile(waits, 90)) if len(waits) >= MIN_SAMPLES else None


def read(ctx):
    return value(program_spans())
