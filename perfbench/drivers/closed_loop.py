"""Eval generation as a closed loop: calls of the family's eval protocol
(``rows_per_call`` corpus rows, ``samples`` images each) back to back
through the window. With a tracer, the profiler covers the first whole
calls of the window that add up to ``trace_s`` seconds."""

from __future__ import annotations

import time

import torch

from perfbench.core import loadgen
from perfbench.core.harness import ROOT


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def warm(family, system, traffic) -> None:
    corpus = loadgen.read_corpus(ROOT / traffic["corpus"])
    family.generate(system, [(r["prompt"], 0) for r in corpus[:traffic["rows_per_call"]]],
                    traffic)
    _sync()


def run(family, system, traffic, seed, seconds, tracer) -> dict:
    corpus = loadgen.read_corpus(ROOT / traffic["corpus"])
    jobs = loadgen.eval_jobs(corpus, traffic["rows_per_call"], traffic["samples"], seed)
    samples = traffic["samples"]
    answers, traced = [], {"images": 0, "since": None}

    def call(rows):
        if tracer is not None and not tracer.started:
            tracer.start()
            traced["since"] = time.perf_counter()
        images = family.generate(system, rows, traffic)
        if tracer is not None and tracer.running:
            traced["images"] += len(images)
            if time.perf_counter() - traced["since"] >= traffic["trace_s"]:
                tracer.stop()
        return images

    def done(k, rows, images):
        for r, (prompt, s) in enumerate(rows):
            for j in range(samples):
                answers.append(((prompt, s, j, samples), images[r * samples + j]))

    rec = loadgen.closed_loop(call, jobs, seconds, done)
    if tracer is not None:
        tracer.stop()
        tracer.read()
    return {"attempted": len(answers), "failed": 0, "answers": answers,
            "images": len(answers), "window_s": rec["window_s"],
            "traced_images": traced["images"]}
