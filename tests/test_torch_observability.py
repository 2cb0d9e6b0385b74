"""The port's span recorder (uce_tpu_torch/utils/observability.py) on the
CPU: parents per thread, the bounded ring, no stream time without CUDA
events, the profiler's trace and flag, and which boundaries share an
event (with stand-in events)."""

import json
import threading

import pytest
import torch

from uce_tpu_torch.utils import observability as obs


def since(mark):
    return [s for s in obs.spans() if s["id"] > mark]


def last_id():
    done = obs.spans()
    return done[-1]["id"] if done else 0


def test_parents_nest_per_thread():
    mark = last_id()
    entered, go = threading.Event(), threading.Event()

    def other():
        with obs.span("t.other"):
            entered.set()
            go.wait(10)
            with obs.span("t.other.child", k=2):
                pass

    th = threading.Thread(target=other)
    with obs.span("t.outer", k=1):
        th.start()
        assert entered.wait(10)
        with obs.span("t.inner"):
            go.set()
            th.join(10)
    assert not th.is_alive()
    got = {s["name"]: s for s in since(mark)}
    assert got["t.outer"]["parent"] is None and got["t.other"]["parent"] is None
    assert got["t.inner"]["parent"] == got["t.outer"]["id"]
    assert got["t.other.child"]["parent"] == got["t.other"]["id"]
    assert got["t.outer"]["k"] == 1 and got["t.other.child"]["k"] == 2
    outer, inner = got["t.outer"], got["t.inner"]
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= outer["end_ns"]
    assert outer["host_s"] == pytest.approx((outer["end_ns"] - outer["start_ns"]) / 1e9)


def test_record_takes_the_open_span_as_parent():
    mark = last_id()
    with obs.span("t.batch"):
        obs.record("t.wait", 5, 2_000_000_005, request=3)
    got = {s["name"]: s for s in since(mark)}
    assert got["t.wait"]["parent"] == got["t.batch"]["id"]
    assert got["t.wait"]["host_s"] == pytest.approx(2.0) and got["t.wait"]["request"] == 3
    assert got["t.wait"]["stream_s"] is None and got["t.wait"]["profiled"] is False


def test_ring_stays_bounded():
    for i in range(obs.RING + 5):
        obs.record("t.ring", i, i + 1)
    done = obs.spans()
    assert len(done) == obs.RING
    assert done[-1]["name"] == "t.ring" and done[-1]["start_ns"] == obs.RING + 4
    assert done == sorted(done, key=lambda s: s["id"])


@pytest.mark.parametrize("device", [None, torch.device("cpu"), "cpu"])
def test_no_stream_time_on_the_cpu(device):
    mark = last_id()
    with obs.span("t.cpu", device):
        torch.ones(4).sum()
    (s,) = since(mark)
    assert s["stream_s"] is None and s["host_s"] > 0


def test_span_lands_in_its_own_threads_trace(tmp_path):
    """Run on a thread of its own: the profiler records only the thread
    that started it."""
    out = {}

    def traced():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with obs.span("t.traced"):
                torch.ones(8).add_(1)
        prof.export_chrome_trace(str(tmp_path / "trace.json"))
        out["ok"] = True

    th = threading.Thread(target=traced)
    th.start()
    th.join(60)
    assert out.get("ok")
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert "t.traced" in names


def test_no_record_function_without_this_threads_profiler(monkeypatch):
    """No record_function is entered on a thread whose profiler is off,
    even while another thread profiles; the span still says profiled."""
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        calls.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    mark = last_id()
    with obs.span("t.quiet"):
        pass
    assert calls == []
    started, done = threading.Event(), threading.Event()

    def profiling():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with obs.span("t.profiling"):
                started.set()
                done.wait(30)

    th = threading.Thread(target=profiling)
    th.start()
    try:
        assert started.wait(30)
        with obs.span("t.beside"):
            pass
    finally:
        done.set()
        th.join(60)
    assert calls == ["t.profiling"]
    got = {s["name"]: s for s in since(mark)}
    assert got["t.quiet"]["profiled"] is False
    assert got["t.beside"]["profiled"] is True and got["t.profiling"]["profiled"] is True


class _Event:
    """A stand-in for a CUDA timing event: its time is its serial number."""

    def __init__(self, n):
        self.n = n

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1e3 * (end.n - self.n)  # ms


@pytest.fixture
def events(monkeypatch):
    made = []

    def event(device):
        assert device == torch.device("cuda")
        made.append(_Event(len(made)))
        return made[-1]

    monkeypatch.setattr(obs, "_cuda_event", event)
    return made


def test_boundaries_that_meet_share_an_event(events):
    """A child starts on its parent's event, a sibling on the end of the one
    before, a parent ends on its last child's; a thread's outermost span and
    any boundary after another span's boundary take an event of their own."""
    mark = last_id()
    with obs.span("t.call", "cuda"):
        with obs.span("t.a", "cuda"):
            pass
        with obs.span("t.b", "cuda"):
            pass
        with obs.span("t.host"):
            pass
        with obs.span("t.c", "cuda"):
            pass
    with obs.span("t.next", "cuda"):
        pass
    got = {s["name"]: s for s in since(mark)}
    # events: 0 call/a start, 1 a end = b start, 2 b end, 3 c start, 4 c end = call end,
    # 5 next start, 6 next end
    assert len(events) == 7
    assert [got[n]["stream_s"] for n in ("t.call", "t.a", "t.b", "t.c", "t.next")] == [
        4.0, 1.0, 1.0, 1.0, 1.0]
    assert got["t.host"]["stream_s"] is None


def test_no_event_while_capturing(monkeypatch):
    monkeypatch.setattr(obs, "_capturing", lambda: True)
    mark = last_id()
    with obs.span("t.captured", "cuda"):
        pass
    (s,) = since(mark)
    assert s["stream_s"] is None
