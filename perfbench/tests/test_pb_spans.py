"""The readers of the program's spans on synthetic span lists: each gives
the right value, leaves out profiled and warm-up spans, and gives None
with fewer than 10 samples or a program that records no spans."""

import itertools

import numpy as np
import pytest

from perfbench.core import harness, spans as spans_mod

EVAL = ("unet_ms.eval", "unet_dispatch_ms.eval", "step_ms.eval", "decode_ms.eval")


def metric(name):
    return harness.load("metrics", name)


class Spans:
    """A span list in the program's form, built in the order spans start."""

    def __init__(self):
        self.out, self.ids = [], itertools.count(1)

    def add(self, name, start_s, host_s, stream_s=None, parent=None, profiled=False, **attrs):
        s = {"name": name, "id": next(self.ids), "parent": parent,
             "start_ns": int(start_s * 1e9), "end_ns": int((start_s + host_s) * 1e9),
             "host_s": host_s, "stream_s": stream_s, "profiled": profiled, **attrs}
        self.out.append(s)
        return s["id"]


def eval_calls(n_calls, warm=True, profiled_calls=1, t=0.0):
    """A warm-up call, ``profiled_calls`` profiled calls, then the rest:
    call c's denoiser calls read (host, stream) = (10 + c, 60 + c) ms, its
    steps 1 + c ms of stream, its decode 80 + c ms."""
    sp = Spans()
    for c in range(n_calls):
        prof = warm <= c < warm + profiled_calls
        slow = 1000.0 if (c < warm or prof) else 1.0  # warm-up and profiled calls read apart
        call = sp.add("pipe.call", t, 1.0, 1.0, profiled=prof)
        sp.add("pipe.encode", t, 0.01, 0.01, call, prof)
        for i in range(3):
            sp.add("pipe.model", t, slow * (0.010 + c / 1e3), slow * (0.060 + c / 1e3), call,
                   prof, call=i)
            sp.add("pipe.step", t, 0.001, slow * (0.001 + c / 1e3), call, prof, call=i)
        sp.add("pipe.decode", t, 0.01, slow * (0.080 + c / 1e3), call, prof)
        sp.add("pipe.readback", t, 0.01, 0.01, call, prof)
        t += 1.0
    return sp.out


@pytest.mark.parametrize("name,per_call", [("unet_ms.eval", 60), ("unet_dispatch_ms.eval", 10),
                                           ("step_ms.eval", 1), ("decode_ms.eval", 80)])
def test_eval_readers(name, per_call):
    read = metric(name).value
    # 12 measured calls (c = 2..13): the median of c is 7.5
    assert read(eval_calls(14)) == pytest.approx(per_call + 7.5)
    # without the warm-up and profiled calls left out, the median moves
    kept = [dict(s, profiled=False) for s in eval_calls(14)]
    assert read(kept) != pytest.approx(per_call + 7.5)
    assert read(eval_calls(11)) == pytest.approx(per_call + 6.0)  # 9 measured calls
    # 4 measured calls: 12 denoiser calls and steps, but too few decodes (5 needed)
    four = read(eval_calls(6))
    if name == "decode_ms.eval":
        assert four is None
    else:
        assert four == pytest.approx(per_call + 3.5)
    assert read(eval_calls(5)) is None  # 3 calls: 9 denoiser calls and steps
    assert read([]) is None


def test_profiler_start_marks_the_window():
    """Spans that started before the first profiled span are set-up; a run
    never profiled (no window to tell) keeps them all."""
    traced = eval_calls(14)
    first = min(s["start_ns"] for s in traced if s["profiled"])
    kept = spans_mod.measured(traced)
    assert len(kept) == 12 * 10 and all(s["start_ns"] >= first for s in kept)
    # 13 decodes of 81..93 ms and the warm-up's 80 s: the median is 87.5
    assert metric("decode_ms.eval").value(eval_calls(14, profiled_calls=0)) == pytest.approx(87.5)


def serve_run(n_batches, requests_per_batch=3, profiled_batches=2, fill_s=0.05):
    """A warm-up batch, then batches each after an idle and a fill wait; the
    first ``profiled_batches`` profiled. Batch b's requests waited 1 + b / 10,
    1 + b / 10 + 0.5 and 1 + b / 10 + 1 s."""
    sp, t = Spans(), 0.0
    warm = sp.add("serve.batch", t, 1.0, 1.0, warmup=True, batch=0, n_real=4, n_pad=0)
    sp.add("pipe.call", t, 1.0, 1.0, warm)
    t += 1.0
    for b in range(1, n_batches + 1):
        prof = b <= profiled_batches
        sp.add("serve.idle", t, 0.2, profiled=prof)
        t += 0.2
        sp.add("serve.fill", t, fill_s * (10 if prof else 1), profiled=prof)
        t += fill_s * (10 if prof else 1)
        bid = sp.add("serve.batch", t, 1.55, 1.55, profiled=prof, batch=b, warmup=False,
                     n_real=requests_per_batch, n_pad=0)
        for r in range(requests_per_batch):
            wait = 1 + b / 10 + 0.5 * r
            sp.add("serve.queue", t - wait, wait, parent=bid, profiled=prof, batch=b, request=r)
        t += 1.55
    return sp.out


def test_queue_wait_p90():
    read = metric("queue_wait_p90_s.serve").value
    spans = serve_run(6)  # batches 3..6 measured: 12 requests
    want = np.percentile([1 + b / 10 + 0.5 * r for b in range(3, 7) for r in range(3)], 90)
    assert read(spans) == pytest.approx(want)
    assert read(serve_run(5)) is None  # 9 requests
    assert read(serve_run(6, profiled_batches=0)) == pytest.approx(
        np.percentile([1 + b / 10 + 0.5 * r for b in range(1, 7) for r in range(3)], 90))


def test_fill_wait_pct():
    read = metric("fill_wait_pct.serve").value
    spans = serve_run(14)  # batches 3..14 measured: 12 fills of 0.05 s, each batch 1.8 s
    assert read(spans) == pytest.approx(100 * 12 * 0.05 / (12 * 1.8))
    assert read(serve_run(11)) is None  # 9 fills
    # a profiled stretch after the window's start is left out, warm-up too
    loud = [dict(s, host_s=50.0) if s["profiled"] and s["name"] == "serve.fill" else s
            for s in spans]
    assert read(loud) == pytest.approx(read(spans))


def test_read_without_the_recorder(monkeypatch):
    """The parent program has no ``spans``: every reader gives None."""
    from uce_tpu_torch.utils import observability

    monkeypatch.delattr(observability, "spans")
    for name in EVAL + ("queue_wait_p90_s.serve", "fill_wait_pct.serve"):
        assert metric(name).read({}) is None


def test_read_takes_the_programs_spans(monkeypatch):
    from uce_tpu_torch.utils import observability

    monkeypatch.setattr(observability, "spans", lambda: eval_calls(14))
    assert metric("unet_ms.eval").read({}) == pytest.approx(67.5)
    monkeypatch.setattr(observability, "spans", lambda: serve_run(14))
    assert metric("fill_wait_pct.serve").read({}) == pytest.approx(100 * 0.05 / 1.8)
