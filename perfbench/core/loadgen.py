"""Load generation: the jobs a traffic mix asks for, and the two loops that
offer them (a copy of the port's ``serving/loadgen.py``, changed so that
the window is filled with arrivals, latency is timed from when a request
was due, prompts and seeds come from a corpus, and the generator's own
lateness is reported).

Every seed gets the same work: the same arrivals (the exponential's
quantiles for a Poisson stream, in an order drawn once from the traffic
mix's own ``order_seed``), with prompts and image seeds drawn from the
run's seed. The order is the mix's and not the seed's because in a queue
the order is part of the work: under one batcher, the same gaps in two
orders give different batches and latencies.
"""

from __future__ import annotations

import csv
import threading
import time

import numpy as np


def read_corpus(path: str) -> list[dict]:
    with open(path, newline="", encoding="utf-8") as f:
        return [{"prompt": r["prompt"], "evaluation_seed": int(r["evaluation_seed"])}
                for r in csv.DictReader(f)]


def image_seed(seed: int, row_seed: int) -> int:
    """The latent seed of a corpus row under a run's seed."""
    return int(np.random.default_rng([int(seed), int(row_seed)]).integers(2 ** 31))


def eval_jobs(corpus, rows_per_call: int, samples: int, seed: int):
    """Endless calls: each ``rows_per_call`` rows, the corpus walked in
    orders drawn from the seed; yields [(prompt, latent seed)] per call."""
    rng = np.random.default_rng([int(seed), 1])
    order: list[int] = []
    while True:
        while len(order) < rows_per_call:
            order += list(rng.permutation(len(corpus)))
        rows, order = order[:rows_per_call], order[rows_per_call:]
        yield [(corpus[r]["prompt"], image_seed(seed, corpus[r]["evaluation_seed"]))
               for r in rows]


def gaps(spec: dict, seconds: float) -> np.ndarray:
    """Inter-arrival gaps of a Poisson stream that sum to ``seconds``, in
    ascending order: rate r gives n = round(r * seconds) arrivals whose gaps
    are the exponential's quantiles at (i + 1/2) / n, scaled to the window."""
    if spec["process"] != "poisson":
        raise ValueError(f"unknown arrival process {spec['process']!r}")
    n = max(int(round(spec["rate"] * seconds)), 1)
    g = -np.log(1.0 - (np.arange(n) + 0.5) / n)
    return g * (seconds / g.sum())


def due_times(spec: dict, seconds: float) -> np.ndarray:
    """Arrival offsets in [0, seconds): the gaps in the order that the mix's
    ``order_seed`` draws."""
    g = np.random.default_rng([int(spec["order_seed"]), 2]).permutation(gaps(spec, seconds))
    return np.concatenate([[0.0], np.cumsum(g)[:-1]])


def serve_jobs(corpus, n: int, seed: int) -> list[tuple[str, int]]:
    rng = np.random.default_rng([int(seed), 3])
    rows = rng.integers(len(corpus), size=n)
    return [(corpus[r]["prompt"], int(s)) for r, s in zip(rows, rng.integers(2 ** 31, size=n))]


def closed_loop(call, jobs, seconds: float, on_done=None, clock=time.perf_counter) -> dict:
    """Calls back to back until ``seconds`` have passed; the window ends when
    the last call returns. ``on_done(k, job, out)`` sees each result."""
    t0 = clock()
    k, done = 0, []
    while clock() - t0 < seconds:
        job = next(jobs)
        out = call(job)
        done.append(clock() - t0)
        if on_done is not None:
            on_done(k, job, out)
        k += 1
    return {"calls": k, "window_s": done[-1] if done else 0.0, "done_s": done}


def open_loop(submit, due, jobs, drain_s: float, tick=None, clock=time.perf_counter) -> dict:
    """Submit job i at ``due[i]`` after the start whatever has completed, and
    wait for every request until ``drain_s`` past the last due time. Latency
    is timed from the due time; a request not done by then, or failed,
    has no latency. ``tick(elapsed)`` runs between submissions."""
    n = len(due)
    done = [None] * n
    lock = threading.Lock()
    all_done = threading.Event()
    futures, late = [], np.zeros(n)

    def finished(i):
        def cb(fut):
            with lock:
                if fut.exception() is None:
                    done[i] = clock()
                finished.count += 1
                if finished.count == n:
                    all_done.set()
        return cb

    finished.count = 0
    t0 = clock()
    for i in range(n):
        while (delay := t0 + due[i] - clock()) > 0:
            if tick is not None:
                tick(clock() - t0)
            time.sleep(min(delay, 0.05))
        late[i] = clock() - (t0 + due[i])
        fut = submit(jobs[i])
        fut.add_done_callback(finished(i))
        futures.append(fut)
    deadline = t0 + (due[-1] if n else 0.0) + drain_s
    while not all_done.wait(timeout=0.05):
        if tick is not None:
            tick(clock() - t0)
        if clock() > deadline:
            break
    with lock:
        lat = [None if d is None else d - (t0 + due[i]) for i, d in enumerate(done)]
    results = [f.result() if f.done() and f.exception() is None else None for f in futures]
    return {"latencies": lat, "results": results, "lateness_s": late,
            "window_s": float(due[-1]) if n else 0.0}
