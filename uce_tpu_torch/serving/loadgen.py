"""Synthetic-load generator for GenerationServer (a copy of
uce_tpu/serving/loadgen.py): the repeatable way to measure serving steady
state (img/s, batch occupancy, request latency percentiles) at controlled
arrival rates.

Arrivals are an open-loop Poisson process (exponential inter-arrival
times from a seeded RNG, so runs are repeatable): requests keep arriving
at the offered rate regardless of completions, which is what exposes
queueing collapse when the offered rate exceeds the chip's ceiling.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np


@dataclasses.dataclass
class LoadReport:
    offered_rps: float
    n_requests: int
    duration_s: float          # first submit -> last completion
    throughput_rps: float      # completed / duration
    latency_p50_s: float
    latency_p95_s: float
    latency_mean_s: float
    occupancy: float           # real requests / batch slots run
    batches: int
    batch_seconds_mean: float  # steady-state device time per batch

    def json(self) -> dict:
        return {k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in dataclasses.asdict(self).items()}


def run_load(server, rate_rps: float, n_requests: int, seed: int = 0,
             prompt: str = "a photograph of an astronaut riding a horse",
             ) -> LoadReport:
    """Drive ``server`` (a started GenerationServer) with ``n_requests``
    Poisson arrivals at ``rate_rps`` and collect the latency distribution.

    Server stats are snapshotted around the run, so occupancy/batch
    numbers cover exactly this load (run one load at a time per server).
    """
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n_requests)
    done_at = [None] * n_requests
    submitted_at = [None] * n_requests
    lock = threading.Lock()

    stats0 = dataclasses.replace(server.stats)

    def _mark_done(i):
        def cb(_future):
            with lock:
                done_at[i] = time.monotonic()
                _check_complete()
        return cb

    all_marked = threading.Event()

    def _check_complete():
        if all(d is not None for d in done_at):
            all_marked.set()

    futures = []
    t_start = time.monotonic()
    next_at = t_start
    for i in range(n_requests):
        next_at += gaps[i]
        delay = next_at - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        submitted_at[i] = time.monotonic()
        fut = server.submit(prompt, seed=i)
        fut.add_done_callback(_mark_done(i))
        futures.append(fut)
    for fut in futures:
        fut.result()  # propagate any server-side failure
    # Future.set_result wakes result() waiters BEFORE running done
    # callbacks, so the last _mark_done may not have stored its timestamp
    # yet — wait for every callback, not just every result
    with lock:
        _check_complete()
    if not all_marked.wait(timeout=30.0):
        raise RuntimeError("done-callbacks did not all fire")

    with lock:
        lat = np.asarray([d - s for d, s in zip(done_at, submitted_at)])
        t_end = max(done_at)
    s = server.stats
    batches = s.batches - stats0.batches
    requests = s.requests - stats0.requests
    padded = s.padded_slots - stats0.padded_slots
    batch_secs = s.total_batch_seconds - stats0.total_batch_seconds
    duration = t_end - submitted_at[0]
    return LoadReport(
        offered_rps=rate_rps,
        n_requests=n_requests,
        duration_s=duration,
        throughput_rps=n_requests / duration if duration > 0 else 0.0,
        latency_p50_s=float(np.percentile(lat, 50)),
        latency_p95_s=float(np.percentile(lat, 95)),
        latency_mean_s=float(lat.mean()),
        occupancy=requests / (requests + padded) if requests + padded else 0.0,
        batches=batches,
        batch_seconds_mean=batch_secs / batches if batches else 0.0,
    )
