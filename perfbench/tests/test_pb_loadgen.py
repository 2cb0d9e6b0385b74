"""The load generator: the same work for every seed, latency from the
due time, and a stall that shows in the requests after it."""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from perfbench.core import loadgen


def test_arrivals_are_the_poisson_quantile_gaps_in_the_mix_order():
    spec = {"process": "poisson", "rate": 3.0, "order_seed": 0}
    a = loadgen.due_times(spec, 45)
    assert len(a) == 135 and a[0] == 0 and a[-1] < 45
    # the gaps, the last one running to the window's end
    assert np.allclose(np.sort(np.append(np.diff(a), 45 - a[-1])), loadgen.gaps(spec, 45))
    assert np.array_equal(a, loadgen.due_times(spec, 45))
    assert not np.allclose(a, loadgen.due_times(dict(spec, order_seed=1), 45))
    g = loadgen.gaps(spec, 45)  # an exponential's: mean 1/rate, median ln 2 / rate
    assert g.mean() == pytest.approx(1 / 3) and np.median(g) == pytest.approx(np.log(2) / 3, 0.02)


def test_serve_jobs_come_from_the_seed():
    corpus = [{"prompt": f"p{i}", "evaluation_seed": i} for i in range(50)]
    assert loadgen.serve_jobs(corpus, 20, 3) == loadgen.serve_jobs(corpus, 20, 3)
    assert loadgen.serve_jobs(corpus, 20, 3) != loadgen.serve_jobs(corpus, 20, 4)


def test_eval_jobs_walk_the_corpus_by_the_seed():
    corpus = [{"prompt": f"p{i}", "evaluation_seed": i} for i in range(10)]
    jobs = loadgen.eval_jobs(corpus, 4, 2, 7)
    calls = [next(jobs) for _ in range(5)]
    assert all(len(c) == 4 for c in calls)
    assert sorted(p for c in calls[:2] for p, _ in c) != sorted(f"p{i}" for i in range(8))
    again = loadgen.eval_jobs(corpus, 4, 2, 7)
    assert [next(again) for _ in range(5)] == calls


class _Server:
    """A one-thread server taking ``service`` seconds a request; a stall
    holds the thread once."""

    def __init__(self, service, stall_at=None, stall=0.0):
        self.service, self.stall_at, self.stall = service, stall_at, stall
        self.n, self.lock, self.busy = 0, threading.Lock(), threading.Lock()

    def submit(self, job):
        fut = Future()
        with self.lock:
            i, self.n = self.n, self.n + 1

        def work():
            with self.busy:  # serial service
                time.sleep(self.service + (self.stall if i == self.stall_at else 0.0))
                fut.set_result(job)
        threading.Thread(target=work).start()
        return fut


def test_a_stall_raises_the_latency_of_the_requests_after_it():
    due = np.arange(12) * 0.05
    calm = loadgen.open_loop(_Server(0.01).submit, due, list(range(12)), 5.0)
    stalled = loadgen.open_loop(_Server(0.01, stall_at=3, stall=0.4).submit, due,
                                list(range(12)), 5.0)
    assert max(calm["latencies"]) < 0.1
    assert min(stalled["latencies"][4:8]) > 0.15  # waited behind the stall, from due time
    assert stalled["lateness_s"].max() < 0.05  # the generator itself stayed on time
    assert stalled["results"] == list(range(12))


def test_a_request_never_answered_has_no_latency():
    def submit(job):
        fut = Future()
        if job != 1:
            fut.set_result(job)
        return fut

    rec = loadgen.open_loop(submit, np.array([0.0, 0.01, 0.02]), [0, 1, 2], 0.2)
    assert rec["latencies"][1] is None and rec["results"] == [0, None, 2]


def test_closed_loop_fills_the_window():
    rec = loadgen.closed_loop(lambda job: time.sleep(0.02), iter(range(1000)), 0.2)
    assert rec["calls"] >= 5 and rec["window_s"] >= 0.2
