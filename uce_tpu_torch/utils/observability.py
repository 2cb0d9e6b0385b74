"""The port's observability: the debias loop's CSV telemetry, and the span
recorder of the pipelines and the server.

Spans (``span``, ``record``, ``spans``) name where the time of a call goes:
the server's idle and fill waits, each batch and each request's queue wait,
the pipeline's encode, every denoiser call and scheduler step, the decode
and the read-back. The recorder is always on and keeps the newest
``RING`` spans of the process in memory; each thread keeps its own stack,
so a span's parent is the span open on its own thread. A device span also
times its stream with CUDA events, resolved only when ``spans()`` is read.
On a thread whose ``torch.profiler`` runs, each span is also a
``record_function``, so it lands in the profiler's trace on the trace's own
clock.
"""

from __future__ import annotations

import collections
import csv
import itertools
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

RING = 65536  # spans kept: the oldest go first
_thread_profiling = torch._C._autograd._profiler_enabled  # this thread's profiler only
_now_ns = time.perf_counter_ns
_timed = {}  # a span's device -> the CUDA device its events go on, or None


class DebiasTelemetry:
    """Per-iteration CSV telemetry for the debias loop: one row per
    (iteration, edit concept) with the observed attribute ratios and the
    controller's ratio update (the reference only showed a tqdm postfix).
    A copy of uce_tpu's ``DebiasTelemetry``."""

    def __init__(self, path: str, edit_concepts, debias_concepts):
        self.path = path
        self.edit_concepts = list(edit_concepts)
        self.debias_concepts = list(debias_concepts)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["iteration", "concept"]
                       + [f"observed_{a}" for a in self.debias_concepts]
                       + [f"ratio_{a}" for a in self.debias_concepts])

    def record(self, iteration: int, observed, ratios) -> None:
        with open(self.path, "a", newline="") as f:
            w = csv.writer(f)
            for ci, concept in enumerate(self.edit_concepts):
                w.writerow([iteration, concept]
                           + [f"{v:.4f}" for v in observed[ci]]
                           + [f"{v:.4f}" for v in ratios[ci]])


_Event = torch.Event
_capturing = torch._C._cuda_isCurrentStreamCapturing


def _cuda_event(device):
    """A timing event recorded on ``device``'s current stream, or None while
    the current stream is being captured into a CUDA graph (an event would
    break it). ``torch.Event`` finds the stream in C++:
    ``torch.cuda.Event.record`` looks it up in Python at twice the host
    cost."""
    if _capturing():
        return None
    ev = _Event(device, enable_timing=True)
    ev.record()
    return ev


class _Thread(threading.local):
    def __init__(self):
        self.stack = []  # ids of the spans open on this thread
        # (event, at an exit) when this thread's last boundary was a device
        # span's and had an event, else None
        self.last = None


class _Span:
    """One span: entered and left by ``with``; its record joins the ring
    when it is left.

    The events at device spans' boundaries: two boundaries that meet, with
    no other boundary of the thread between them, share one event: a
    child's start and its parent's, a span's start and the end of the
    sibling before it, a parent's end and its last child's. A thread's
    outermost span starts on an event of its own (the host may have waited
    since the last one), and a span never ends on its own start's. Device
    work enqueued between two boundaries that meet counts to the later
    one's span."""

    __slots__ = ("rec", "name", "device", "attrs", "id", "parent", "t0", "t1",
                 "profiled", "ev0", "ev1", "stream", "annotation")

    def __init__(self, rec, name, device, attrs):
        # device: the CUDA device of the span's events, None for a host span
        self.rec, self.name, self.device, self.attrs = rec, name, device, attrs
        self.ev0 = self.ev1 = self.stream = self.annotation = None

    def __enter__(self):
        rec = self.rec
        th = rec._thread
        stack = th.stack
        self.parent = stack[-1] if stack else None
        self.id = next(rec._ids)
        self.profiled = _autograd_profiler._is_profiler_enabled
        if self.device is not None:
            last = th.last
            ev = last[0] if last is not None and stack else _cuda_event(self.device)
            self.ev0 = ev
            th.last = (ev, False) if ev is not None else None
        else:
            th.last = None
        stack.append(self.id)
        if _thread_profiling():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.t0 = _now_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = _now_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        rec = self.rec
        th = rec._thread
        th.stack.pop()
        if self.device is not None:
            last = th.last
            ev = last[0] if last is not None and last[1] else _cuda_event(self.device)
            self.ev1 = ev
            th.last = (ev, True) if ev is not None else None
        else:
            th.last = None
        rec._ring.append(self)
        return False


class SpanRecorder:
    """The spans of one process (``span``, ``record`` and ``spans`` below
    are those of its one recorder)."""

    def __init__(self):
        self._ring = collections.deque(maxlen=RING)
        self._ids = itertools.count(1)
        self._thread = _Thread()

    def span(self, name: str, device=None, **attrs) -> _Span:
        """A context manager recording ``name`` with ``attrs``: its id, its
        parent's (the span open on this thread), the host start and end
        (``time.perf_counter_ns``) and whether any thread's profiler was
        running at its start. ``device``: the torch.device its work runs
        on; on a CUDA device the span also times its stream (the current
        one) with events. ``with span(...) as s``: ``s.t0`` and ``s.t1``
        are its host stamps once entered and left."""
        if device not in _timed:
            dev = None if device is None else torch.device(device)
            _timed[device] = dev if dev is not None and dev.type == "cuda" else None
        return _Span(self, name, _timed[device], attrs)

    def record(self, name: str, t0_ns: int, t1_ns: int, **attrs) -> None:
        """An explicit span that started earlier, perhaps on another thread
        (``perf_counter_ns`` stamps); its parent is the span open on this
        thread."""
        th = self._thread
        s = _Span(self, name, None, attrs)
        s.parent = th.stack[-1] if th.stack else None
        s.id = next(self._ids)
        s.profiled = _autograd_profiler._is_profiler_enabled
        s.t0, s.t1 = t0_ns, t1_ns
        self._ring.append(s)

    def spans(self) -> list[dict]:
        """The recorded spans in the order they were entered (an explicit
        span: recorded): ``name``, ``id``, ``parent``, ``start_ns``,
        ``end_ns``, ``host_s``, ``stream_s`` (the stream's seconds between
        the span's events, None without them), ``profiled`` and the attrs.
        Waits for the events still pending."""
        out = []
        for s in sorted(tuple(self._ring), key=lambda s: s.id):
            if s.stream is None and s.ev0 is not None and s.ev1 is not None:
                s.ev1.synchronize()
                s.stream = s.ev0.elapsed_time(s.ev1) / 1e3
            out.append({"name": s.name, "id": s.id, "parent": s.parent, "start_ns": s.t0,
                        "end_ns": s.t1, "host_s": (s.t1 - s.t0) / 1e9, "stream_s": s.stream,
                        "profiled": s.profiled, **s.attrs})
        return out


_RECORDER = SpanRecorder()
span = _RECORDER.span
record = _RECORDER.record
spans = _RECORDER.spans
