"""Serving as an open loop: the port's ``GenerationServer`` (its batch
ladder, ``max_wait_ms`` batching, warm-up of every rung) over the family's
pipeline, offered the traffic's arrivals whatever has completed. Every
request due in the window is waited for up to ``drain_s`` past the last
due time; one not answered by then has failed. With a tracer, the profiler
covers the first ``trace_s`` seconds of the window."""

from __future__ import annotations

import dataclasses

import numpy as np

from perfbench.core import loadgen
from perfbench.core.harness import ROOT


def warm(family, system, traffic) -> None:
    from uce_tpu_torch.serving.server import GenerationServer, ServerConfig

    size = traffic["size"]
    cfg = ServerConfig(batch_sizes=tuple(traffic["ladder"]),
                       num_inference_steps=traffic["steps"],
                       guidance_scale=traffic["guidance"], height=size, width=size,
                       scheduler=traffic.get("scheduler"),
                       max_wait_ms=traffic["max_wait_ms"], warmup=True)
    system["server"] = GenerationServer(family.pipeline(system), cfg).start()


def run(family, system, traffic, seed, seconds, tracer) -> dict:
    server = system.pop("server")
    corpus = loadgen.read_corpus(ROOT / traffic["corpus"])
    due = loadgen.due_times(traffic["arrivals"], seconds)
    jobs = loadgen.serve_jobs(corpus, len(due), seed)
    before = dataclasses.replace(server.stats)

    def tick(elapsed):
        if tracer is None:
            return
        if not tracer.started:
            tracer.start()
        elif tracer.running and elapsed >= traffic["trace_s"]:
            tracer.stop()

    try:
        tick(0.0)
        rec = loadgen.open_loop(lambda job: server.submit(job[0], seed=job[1]), due, jobs,
                                traffic["drain_s"], tick)
    finally:
        server.close()
    if tracer is not None:
        tracer.stop()
        tracer.read()
    s = server.stats
    late = rec["lateness_s"]
    return {"attempted": len(jobs),
            "failed": sum(lat is None for lat in rec["latencies"]),
            "answers": [((p, sd, 0, 1), img) for (p, sd), img in zip(jobs, rec["results"])
                        if img is not None],
            "latencies": rec["latencies"], "window_s": float(seconds),
            "server": {"batches": s.batches - before.batches,
                       "requests": s.requests - before.requests,
                       "padded_slots": s.padded_slots - before.padded_slots,
                       "batch_seconds": s.total_batch_seconds - before.total_batch_seconds},
            "lateness": {"requests": len(jobs), "late_p50_ms": float(np.median(late) * 1e3),
                         "late_max_ms": float(late.max() * 1e3)} if len(jobs) else None}
