"""latency_p50_s: the median latency of every request due in the window,
timed from its due time; a request never answered counts as slower than
all. Host clock."""

import numpy as np


def read(ctx):
    lat = [np.inf if x is None else x for x in ctx["record"]["latencies"]]
    with np.errstate(invalid="ignore"):  # inf - inf where the unanswered reach it
        value = float(np.percentile(lat, 50)) if lat else None
    return value if value is not None and np.isfinite(value) else None
