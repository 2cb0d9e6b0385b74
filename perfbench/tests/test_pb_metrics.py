"""Each metric reader on a canned profiler trace and canned records."""

import pytest
import torch

from perfbench.core import harness, trace as trace_mod, work
from perfbench.reference import sd as sd_ref

EVENTS = [
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 100.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 78.0, "dur": 4.0},
    {"ph": "X", "cat": "kernel", "name": "void sd_attention_kernel<40>(Params)", "ts": 10.0,
     "dur": 30.0},
    {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_bf16", "ts": 50.0, "dur": 20.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 80.0,
     "dur": 10.0},
    {"ph": "i", "cat": "marker", "name": "ignored", "ts": 120.0},
]


def metric(name):
    return harness.load("metrics", name).read


def _attention_work():
    q = torch.empty(1, 2, 1024, 64, device="meta")
    kv = torch.empty(1, 2, 77, 64, device="meta")
    return [("m", lambda: (sd_ref.attention(q, q, q, 0.125), sd_ref.attention(q, kv, kv, 0.125),
                           torch.mm(torch.empty(64, 32, device="meta"),
                                    torch.empty(32, 16, device="meta"))), 3)]


def test_trace_reading():
    s = trace_mod.read(EVENTS)
    assert s["window_s"] == pytest.approx(100e-6) and s["busy_s"] == pytest.approx(60e-6)
    assert s["device_ops"][0] == ["void sd_attention_kernel<40>(Params)", pytest.approx(30e-6)]
    assert [g[0] for g in s["idle_gaps"]] == ["host: aten::mm"] * 4
    assert sorted(g[1] for g in s["idle_gaps"]) == pytest.approx([10e-6] * 4)
    assert trace_mod.device_seconds(s, ["sd_attention"]) == pytest.approx(30e-6)
    assert trace_mod.read([])["busy_s"] == 0


@pytest.mark.parametrize("name", ["device_idle_pct.eval", "device_idle_pct.serve"])
def test_idle(name):
    assert metric(name)({"trace": trace_mod.read(EVENTS)}) == pytest.approx(40.0)
    assert metric(name)({"trace": trace_mod.read(EVENTS[:2])}) is None  # no device op
    assert metric(name)({"trace": None}) is None


def test_mfu():
    ctx = {"trace": trace_mod.read(EVENTS), "record": {"traced_images": 2},
           "work": _attention_work()}
    flops = 3 * (4 * 2 * 1024 * 1024 * 64 + 4 * 2 * 1024 * 77 * 64 + 2 * 64 * 32 * 16)
    assert work.flops_per_image(ctx["work"]) == flops
    want = 100 * 2 * flops / 100e-6 / work.PEAK_FLOPS
    assert metric("mfu_pct.eval")(ctx) == pytest.approx(want)
    assert metric("mfu_pct.eval")(dict(ctx, record={"traced_images": 0})) is None


def test_attention_roofline():
    ctx = {"trace": trace_mod.read(EVENTS), "record": {"traced_images": 1},
           "work": _attention_work()}
    flops, nbytes = 4 * 2 * 1024 * 1024 * 64, 2 * 2 * 64 * 4 * 1024
    least = 3 * max(flops / work.PEAK_FLOPS, nbytes / work.PEAK_BYTES)  # the 1024-key call
    assert metric("attn_roofline_pct.eval")(ctx) == pytest.approx(100 * least / 30e-6)
    no_kernel = [e for e in EVENTS if "sd_attention" not in e["name"]]
    assert metric("attn_roofline_pct.eval")(dict(ctx, trace=trace_mod.read(no_kernel))) is None


def test_serving_counters():
    rec = {"server": {"batches": 4, "requests": 10, "padded_slots": 2, "batch_seconds": 6.0}}
    assert metric("batch_occupancy.serve")({"record": rec}) == pytest.approx(100 * 10 / 12)
    assert metric("batch_s_mean.serve")({"record": rec}) == pytest.approx(1.5)
    empty = {"server": {"batches": 0, "requests": 0, "padded_slots": 0, "batch_seconds": 0}}
    assert metric("batch_occupancy.serve")({"record": empty}) is None
    assert metric("batch_s_mean.serve")({"record": empty}) is None


def test_end_to_end():
    lat = [float(i) for i in range(1, 11)]
    assert metric("latency_p50_s")({"record": {"latencies": lat}}) == pytest.approx(5.5)
    assert metric("latency_p90_s")({"record": {"latencies": lat}}) == pytest.approx(9.1)
    # a request never answered is slower than all
    assert metric("latency_p50_s")({"record": {"latencies": lat[:9] + [None]}}) == 5.5
    assert metric("latency_p90_s")({"record": {"latencies": lat[:8] + [None, None]}}) is None
    assert metric("img_per_s")({"record": {"images": 80, "window_s": 40.0}}) == 2.0
    assert metric("setup_s")({"setup_s": 12.5}) == 12.5
