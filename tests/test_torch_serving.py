"""The port's serving layer (uce_tpu_torch/serving, ``serve`` CLI): the cases
of tests/test_serving.py that need no FLUX or mesh, on the port's SD
pipeline (fp32, 2 steps, 32x32), and a W8A8 (``--quantize int8``) server's
image against uce_tpu's, also on SDXL; fast specs served, int8 among them;
FLUX and HiDream servers (their DiTs quantized as they load) against
uce_tpu's pipelines."""

import base64
import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from tests.snapshot import make_sd_snapshot
from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu_torch.diffusion.pipeline import SDPipeline
from uce_tpu_torch.serving import socket_api
from uce_tpu_torch.serving.loadgen import run_load
from uce_tpu_torch.serving.server import GenerationServer, ServerConfig
from uce_tpu_torch.utils import observability
from uce_tpu_torch.utils.imaging import decode_png

CFG = dict(num_inference_steps=2, height=32, width=32)


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    return make_sd_snapshot(tmp_path_factory.mktemp("torch_serving_snap"))


@pytest.fixture(scope="module")
def pipe(snap):
    return SDPipeline.from_pretrained(snap, dtype=torch.float32, device="cpu")


def test_serial_requests_and_padding(pipe):
    with GenerationServer(pipe, ServerConfig(batch_size=3, max_wait_ms=1,
                                             **CFG)) as srv:
        img = srv.generate("a cat", seed=7)
        assert img.shape == (32, 32, 3) and img.dtype == np.uint8
        # single request into a batch of 3 -> 2 padded slots
        assert srv.stats.batches == 1
        assert srv.stats.padded_slots == 2
        assert srv.stats.occupancy == pytest.approx(1 / 3)


def test_batch_ladder_picks_smallest_fitting_rung(pipe):
    cfg = ServerConfig(batch_size=4, batch_sizes=(1, 2, 4),
                       max_wait_ms=500, **CFG)
    with GenerationServer(pipe, cfg) as srv:
        assert srv.batch_sizes == (1, 2, 4)
        img = srv.generate("a cat", seed=7)
        assert img.shape == (32, 32, 3)
        assert srv.stats.batches == 1 and srv.stats.padded_slots == 0
        futures = [srv.submit(p, seed=s)
                   for p, s in [("a cat", 1), ("a dog", 2), ("a bird", 3)]]
        imgs = [f.result(timeout=120) for f in futures]
    assert srv.stats.batches == 2
    assert srv.stats.padded_slots == 1  # 3 requests -> rung 4
    assert not np.array_equal(imgs[0], imgs[1])


def test_batch_ladder_image_matches_single_signature(pipe):
    """Which rung a request lands on changes its image by at most one
    uint8 level (batch sizes may pick other library algorithms)."""
    cfg = dict(max_wait_ms=1, **CFG)
    with GenerationServer(pipe, ServerConfig(batch_size=3, **cfg)) as srv:
        via_pad = srv.generate("a cat", seed=7)
    with GenerationServer(pipe, ServerConfig(batch_size=3, batch_sizes=(1, 3),
                                             **cfg)) as srv:
        via_rung1 = srv.generate("a cat", seed=7)
    diff = np.abs(via_pad.astype(np.int16) - via_rung1.astype(np.int16))
    assert diff.max() <= 1, f"rung changed the image (max diff {diff.max()})"


def test_results_match_direct_pipeline_call(pipe):
    direct = pipe(["a cat", "", ""], seed=[7, 0, 0], num_images_per_prompt=1,
                  guidance_scale=7.5, **CFG)[0]
    with GenerationServer(pipe, ServerConfig(batch_size=3, max_wait_ms=1,
                                             **CFG)) as srv:
        served = srv.generate("a cat", seed=7)
    np.testing.assert_array_equal(served, direct)


def test_concurrent_requests_batch_together(pipe):
    cfg = ServerConfig(batch_size=4, max_wait_ms=500, **CFG)
    with GenerationServer(pipe, cfg) as srv:
        futures = [srv.submit(p, seed=s)
                   for p, s in [("a cat", 1), ("a dog", 2), ("a bird", 3)]]
        imgs = [f.result(timeout=120) for f in futures]
    assert srv.stats.requests == 3
    assert srv.stats.batches == 1, "concurrent requests must share a batch"
    assert not np.array_equal(imgs[0], imgs[1])
    assert not np.array_equal(imgs[1], imgs[2])


def test_distinct_seeds_distinct_images(pipe):
    with GenerationServer(pipe, ServerConfig(batch_size=2, max_wait_ms=1,
                                             **CFG)) as srv:
        a = srv.generate("a cat", seed=1)
        b = srv.generate("a cat", seed=2)
        c = srv.generate("a cat", seed=1)
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(a, c)


def test_negative_prompt_reaches_the_pipeline(pipe):
    with GenerationServer(pipe, ServerConfig(batch_size=2, max_wait_ms=1,
                                             **CFG)) as srv:
        served = srv.generate("a cat", seed=1, negative_prompt="blurry")
        plain = srv.generate("a cat", seed=1)
    direct = pipe(["a cat", ""], seed=[1, 0], negative_prompt=["blurry", ""], **CFG)
    np.testing.assert_array_equal(served, direct[0])
    assert not np.array_equal(served, plain)


def test_failed_batch_keeps_serving(pipe):
    calls = {"n": 0}
    real = pipe.__call__

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected device error")
        return real(*a, **kw)

    srv = GenerationServer(flaky, ServerConfig(batch_size=2, max_wait_ms=1,
                                               warmup=False, **CFG))
    srv.start()
    try:
        with pytest.raises(RuntimeError, match="injected"):
            srv.generate("a cat", seed=1)
        img = srv.generate("a cat", seed=1)  # server must still be alive
        assert img.shape == (32, 32, 3)
    finally:
        srv.close()


def test_socket_roundtrip(pipe, tmp_path):
    sock = str(tmp_path / "uce.sock")
    srv = GenerationServer(pipe, ServerConfig(batch_size=2, max_wait_ms=1,
                                              **CFG)).start()
    frontend = socket_api.SocketFrontend(srv, sock).start_background()
    try:
        out = str(tmp_path / "cat.png")
        reply = socket_api.request(sock, {"prompt": "a cat", "seed": 7,
                                          "save_path": out})
        assert reply["status"] == "ok" and reply["path"] == out
        with open(out, "rb") as f:
            saved = decode_png(f.read())
        assert saved.shape == (32, 32, 3)

        reply = socket_api.request(sock, {"prompt": "a cat", "seed": 7})
        assert reply["status"] == "ok"
        np.testing.assert_array_equal(
            decode_png(base64.b64decode(reply["png_base64"])), saved)

        stats = socket_api.request(sock, {"cmd": "stats"})
        assert stats["status"] == "ok" and stats["requests"] == 2

        bad = socket_api.request(sock, {"seed": 1})
        assert bad["status"] == "error" and "prompt" in bad["error"]
    finally:
        frontend.close()
        srv.close()


class _NoSchedulerPipe:
    """A pipeline family whose call signature takes no scheduler override
    or negative prompt."""

    def __call__(self, prompt, num_inference_steps, guidance_scale,
                 num_images_per_prompt, seed, height, width):
        return np.zeros((len(prompt), height, width, 3), np.uint8)


def test_family_without_scheduler_or_negatives():
    """Static config the family can't honour fails start(); a request it
    can't honour is rejected at submit(), not dropped."""
    cfg = dict(batch_size=2, warmup=False, max_wait_ms=1, **CFG)
    with pytest.raises(ValueError, match="scheduler"):
        GenerationServer(_NoSchedulerPipe(),
                         ServerConfig(scheduler="ddim", **cfg)).start()
    with GenerationServer(_NoSchedulerPipe(), ServerConfig(**cfg)) as srv:
        assert srv.generate("a cat", seed=5).shape == (32, 32, 3)
        with pytest.raises(ValueError, match="negative"):
            srv.submit("a cat", seed=1, negative_prompt="blurry")


def _spans_since(mark):
    return [s for s in observability.spans() if s["id"] > mark]


def _last_span_id():
    done = observability.spans()
    return done[-1]["id"] if done else 0


def test_spans_cover_each_request_and_batch():
    """Each submitted request has one ``serve.queue`` span inside the
    ``serve.batch`` it ran in (same batch id); warm-up batches say so and
    hold no request's span; ``ServerStats`` sums the same waits."""
    mark = _last_span_id()
    cfg = ServerConfig(batch_size=4, max_wait_ms=200, warmup=True, **CFG)
    with GenerationServer(_NoSchedulerPipe(), cfg) as srv:
        futures = [srv.submit(f"p{i}", seed=i) for i in range(6)]
        for f in futures:
            f.result(timeout=60)
        stats = dataclasses.replace(srv.stats)
    got = _spans_since(mark)
    batches = {s["id"]: s for s in got if s["name"] == "serve.batch"}
    queued = [s for s in got if s["name"] == "serve.queue"]
    assert sorted(s["request"] for s in queued) == sorted(set(s["request"] for s in queued))
    assert len(queued) == 6
    for q in queued:
        b = batches[q["parent"]]
        assert b["batch"] == q["batch"] and not b["warmup"]
        assert q["end_ns"] == b["start_ns"] and q["host_s"] >= 0
    warm = [b for b in batches.values() if b["warmup"]]
    assert len(warm) == 1 and warm[0]["n_real"] == 4
    served = [b for b in batches.values() if not b["warmup"]]
    assert sum(b["n_real"] for b in served) == 6 == stats.requests
    assert stats.queue_wait_seconds == pytest.approx(sum(q["host_s"] for q in queued))
    fills = [s for s in got if s["name"] == "serve.fill"]
    assert stats.fill_wait_seconds == pytest.approx(sum(f["host_s"] for f in fills))


def test_part_full_batch_waits_in_fill():
    """A batch that does not fill waits out max_wait_ms in ``serve.fill``,
    after the batcher's ``serve.idle`` and before its ``serve.batch``."""
    mark = _last_span_id()
    cfg = ServerConfig(batch_size=4, max_wait_ms=30, warmup=False, **CFG)
    with GenerationServer(_NoSchedulerPipe(), cfg) as srv:
        srv.generate("a cat", seed=1)
        fill_s = srv.stats.fill_wait_seconds
    got = _spans_since(mark)
    names = [s["name"] for s in got]
    i = names.index("serve.batch")
    assert names[i - 2:i] == ["serve.idle", "serve.fill"]
    fill, batch = got[i - 1], got[i]
    assert batch["n_real"] == 1 and batch["n_pad"] == 3
    assert 0.03 <= fill["host_s"] and fill["end_ns"] <= batch["start_ns"]
    assert fill_s == pytest.approx(fill["host_s"])


def test_socket_stats_report_the_waits(tmp_path):
    sock = str(tmp_path / "uce.sock")
    srv = GenerationServer(_NoSchedulerPipe(), ServerConfig(
        batch_size=2, max_wait_ms=20, warmup=False, **CFG)).start()
    frontend = socket_api.SocketFrontend(srv, sock).start_background()
    try:
        assert socket_api.request(sock, {"prompt": "a cat", "seed": 7})["status"] == "ok"
        stats = socket_api.request(sock, {"cmd": "stats"})
    finally:
        frontend.close()
        srv.close()
    assert stats["requests"] == 1
    assert stats["queue_wait_seconds"] == srv.stats.queue_wait_seconds > 0
    assert stats["fill_wait_seconds"] == srv.stats.fill_wait_seconds >= 0.02


def test_fast_spec_served(pipe):
    """A fast spec reaches the pipeline: the served image is a direct
    pipe(..., fast=FastConfig) call's and differs from the exact one."""
    from uce_tpu_torch.diffusion.sampler import FastConfig

    spec = "cfg_interval=1:3,cache=2"
    cfg = ServerConfig(batch_size=1, max_wait_ms=1, fast=spec, warmup=False,
                       num_inference_steps=3, height=32, width=32)
    with GenerationServer(pipe, cfg) as srv:
        served = srv.generate("a cat", seed=7)
    kw = dict(num_inference_steps=3, seed=[7], height=32, width=32,
              negative_prompt=[""])
    direct = pipe(["a cat"], fast=FastConfig.from_spec(spec), **kw)
    np.testing.assert_array_equal(served, direct[0])
    assert (served != pipe(["a cat"], **kw)[0]).any()


def test_noop_fast_spec_serves_the_exact_image(pipe):
    cfg = ServerConfig(batch_size=1, max_wait_ms=1, fast="cache=1", **CFG)
    with GenerationServer(pipe, cfg) as srv:
        served = srv.generate("a cat", seed=3)
    exact = pipe(["a cat"], seed=[3], negative_prompt=[""], **CFG)
    np.testing.assert_array_equal(served, exact[0])


def test_fast_spec_rejected_for_family_without_fast():
    """start() fails when the pipeline family takes no fast config, and a
    bad spec fails construction."""
    srv = GenerationServer(_NoSchedulerPipe(), ServerConfig(
        batch_size=1, warmup=False, fast="cache=2", **CFG))
    with pytest.raises(ValueError, match="fast"):
        srv.start()
    with pytest.raises(ValueError, match="unknown --fast key"):
        GenerationServer(_NoSchedulerPipe(), ServerConfig(fast="bogus=1", **CFG))


def test_int8_fast_server(snap):
    """A W8A8 server takes a fast spec, as uce_tpu's does: it serves the
    port's int8 pipe(fast=) image bit for bit, not the exact one."""
    from uce_tpu_torch.diffusion.sampler import FastConfig

    spec = "cfg_interval=1:3,cache=2"
    tpipe = SDPipeline.from_pretrained(snap, dtype=torch.float32, device="cpu")
    tpipe.quantize_weights("int8")
    with GenerationServer(tpipe, ServerConfig(batch_size=1, max_wait_ms=1,
                                              fast=spec, **CFG)) as srv:
        served = srv.generate("a cat", seed=4)
    kw = dict(seed=[4], negative_prompt=[""], **CFG)
    np.testing.assert_array_equal(
        served, tpipe(["a cat"], fast=FastConfig.from_spec(spec), **kw)[0])
    assert (served != tpipe(["a cat"], **kw)[0]).any()


def test_submit_after_close_raises(pipe):
    srv = GenerationServer(pipe, ServerConfig(batch_size=2, warmup=False,
                                              **CFG)).start()
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit("a cat")


def test_cancelled_future_does_not_poison_batch(pipe):
    cfg = ServerConfig(batch_size=4, max_wait_ms=500, **CFG)
    with GenerationServer(pipe, cfg) as srv:
        doomed = srv.submit("a cat", seed=1)
        keeper = srv.submit("a dog", seed=2)
        assert doomed.cancel()
        img = keeper.result(timeout=120)
    assert img.shape == (32, 32, 3)


def test_close_fails_orphaned_requests(pipe):
    srv = GenerationServer(pipe, ServerConfig(batch_size=2, warmup=False,
                                              **CFG))
    # not started: nothing consumes the queue, emulating the submit/close
    # race where a request lands behind the shutdown sentinel
    fut = srv.submit("a cat", seed=1)
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=10)


def test_socket_path_not_stolen(pipe, tmp_path):
    sock = str(tmp_path / "uce.sock")
    srv = GenerationServer(pipe, ServerConfig(batch_size=2, warmup=False,
                                              **CFG)).start()
    frontend = socket_api.SocketFrontend(srv, sock).start_background()
    try:
        with pytest.raises(RuntimeError, match="already listening"):
            socket_api.SocketFrontend(srv, sock)
    finally:
        frontend.close()
        srv.close()


def test_frontend_close_before_serve_does_not_hang(pipe, tmp_path):
    sock = str(tmp_path / "uce.sock")
    srv = GenerationServer(pipe, ServerConfig(batch_size=2, warmup=False,
                                              **CFG))
    frontend = socket_api.SocketFrontend(srv, sock)
    t0 = time.monotonic()
    frontend.close()  # loop never entered
    assert time.monotonic() - t0 < 5.0
    assert not os.path.exists(sock)


def test_serve_cli_bench_mode_with_ladder(snap, capsys):
    """``serve --bench`` through the port's CLI on the CPU: builds the
    pipeline, parses the ladder, runs the Poisson load and prints one JSON
    report line per offered rate."""
    from uce_tpu_torch.cli.main import main as cli_main

    rc = cli_main(["serve", "--model_id", snap, "--bench", "5",
                   "--bench_requests", "3", "--batch_size", "2",
                   "--batch_sizes", "1,2", "--image_size", "32",
                   "--num_inference_steps", "2", "--max_wait_ms", "30",
                   "--quantize", "int8", "--device", "cpu"])
    assert rc == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert len(lines) == 1
    rep = lines[0]
    assert rep["n_requests"] == 3 and rep["offered_rps"] == 5.0
    assert rep["batches"] >= 2  # rung 2 can't swallow 3 requests at once


@pytest.mark.parametrize("argv,shape", [
    (["--quantize", "int8", "--mesh", "data=2"], "2x1"),
    (["--mesh", "model=2"], "1x2"),
], ids=["int8-data2", "model2"])
def test_serve_cli_rejects_what_is_not_ported(snap, argv, shape, capsys):
    """``serve --mesh`` (ported: two spawned CPU ranks, W8A8 at data=2, the
    tensor-parallel UNet at model=2) through the CLI's --bench mode: one
    JSON report, all requests served, the mesh stopped at the end."""
    from uce_tpu_torch.cli.main import main as cli_main
    from uce_tpu_torch.parallel import workers

    rc = cli_main(["serve", "--model_id", snap, "--bench", "5", "--bench_requests", "3",
                   "--batch_sizes", "1,2", "--image_size", "32", "--num_inference_steps",
                   "2", "--max_wait_ms", "30", "--device", "cpu", *argv])
    assert rc == 0 and workers.session() is None
    out = capsys.readouterr().out
    reports = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert len(reports) == 1 and reports[0]["n_requests"] == 3
    assert f"mesh: {shape} (data x model)" in out


def test_serve_cli_bench_mode_fast(snap, capsys):
    """``serve --fast`` through the CLI (with --quantize int8, as the card's
    run drives it): one JSON report line."""
    from uce_tpu_torch.cli.main import main as cli_main

    rc = cli_main(["serve", "--model_id", snap, "--bench", "5", "--bench_requests",
                   "2", "--batch_sizes", "1,2", "--image_size", "32",
                   "--num_inference_steps", "3", "--max_wait_ms", "30",
                   "--quantize", "int8", "--fast", "cfg_interval=1:3,cache=2",
                   "--device", "cpu"])
    assert rc == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert len(lines) == 1 and lines[0]["n_requests"] == 2


def test_serve_cuda_without_cuda_fails(snap, monkeypatch):
    from uce_tpu_torch.cli.main import main as cli_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["serve", "--model_id", snap, "--quantize", "int8",
                  "--device", "cuda", "--bench", "1"])


def test_loadgen_report(pipe):
    cfg = ServerConfig(batch_size=2, max_wait_ms=30, **CFG)
    with GenerationServer(pipe, cfg) as srv:
        rep = run_load(srv, rate_rps=50.0, n_requests=6, seed=0)
    assert rep.n_requests == 6
    assert rep.batches >= 3  # 6 requests into batch_size=2
    assert rep.throughput_rps > 0
    assert 0 < rep.latency_p50_s <= rep.latency_p95_s
    assert 0.5 <= rep.occupancy <= 1.0
    assert rep.batch_seconds_mean > 0
    js = rep.json()
    assert js["offered_rps"] == 50.0 and isinstance(js["batches"], int)


def test_pin_rung_restores_bit_determinism(pipe):
    cfg = ServerConfig(batch_size=4, batch_sizes=(1, 2, 4), pin_rung=True,
                       max_wait_ms=300, **CFG)
    with GenerationServer(pipe, cfg) as srv:
        solo = srv.generate("a cat", seed=7)
        assert srv.stats.batches == 1
        assert srv.stats.padded_slots == 3  # lone request still rung 4
        futures = [srv.submit(p, seed=s)
                   for p, s in [("a cat", 7), ("a dog", 2), ("a bird", 3)]]
        crowded = futures[0].result(timeout=120)
    np.testing.assert_array_equal(solo, crowded)


def test_pin_rung_warmup_runs_only_top_rung(pipe):
    cfg = ServerConfig(batch_size=4, batch_sizes=(1, 2, 4), pin_rung=True,
                       max_wait_ms=1, **CFG)
    srv = GenerationServer(pipe, cfg)
    sizes = []
    orig = srv._run_batch

    def counting(batch):
        sizes.append(len(batch))
        return orig(batch)

    srv._run_batch = counting
    with srv:
        srv.generate("a cat", seed=1)
    # one warmup batch at the top rung (not three), then the real request
    assert sizes == [4, 1]


def test_int8_server_matches_uce_tpu(snap, tmp_path):
    """``serve --quantize int8`` with an edit overlay: the port's W8A8 server
    and uce_tpu's serve the same (prompt, seed, negative prompt) within one
    uint8 level."""
    import jax.numpy as jnp

    from uce_tpu.diffusion.pipeline import SDPipeline as JaxPipeline
    from uce_tpu.serving.server import (GenerationServer as JaxServer,
                                        ServerConfig as JaxConfig)
    from uce_tpu_torch.models.hf_loader import save_safetensors
    from uce_tpu_torch.ops.quant import is_quantized

    key = "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight"
    port = SDPipeline.from_pretrained(snap, dtype=torch.float32, device="cpu")
    edit = port.unet_params[key] * 0.5
    edit_path = str(tmp_path / "edit.safetensors")
    save_safetensors({key: edit}, edit_path)
    port.quantize_weights("int8")
    port.load_uce_edits(edit_path)
    assert port.unet_params[key].dtype == torch.float32
    assert is_quantized(port.unet_params[key.replace("to_k", "to_q")])
    jpipe = JaxPipeline.from_pretrained(snap, dtype=jnp.float32)
    jpipe.quantize_weights("int8")
    jpipe.load_uce_edits(edit_path)
    images = []
    for server_cls, config_cls, p in ((GenerationServer, ServerConfig, port),
                                      (JaxServer, JaxConfig, jpipe)):
        with server_cls(p, config_cls(batch_size=2, max_wait_ms=1, **CFG)) as srv:
            images.append(srv.generate("a cat", seed=7, negative_prompt="a dog"))
    diff = np.abs(images[0].astype(np.int16) - images[1].astype(np.int16))
    assert diff.max() <= 1, f"max uint8 diff {diff.max()}"


# ---------------------------------------------------------------------------
# FLUX (``serve --family flux``) on tests/snapshot.py's tiny FLUX snapshot
# ---------------------------------------------------------------------------

FLUX_CFG = dict(num_inference_steps=2, guidance_scale=0.0, height=16, width=16)


@pytest.fixture(scope="module")
def flux_snap(tmp_path_factory):
    from tests.snapshot import make_flux_snapshot

    return make_flux_snapshot(tmp_path_factory.mktemp("torch_serving_flux_snap"))


def test_flux_server_matches_uce_tpu(flux_snap):
    """A FluxPipeline served through the batch ladder (it takes no scheduler,
    negative prompt or fast config: the server adapts by signature): each
    served image within 1 uint8 level of uce_tpu's pipeline on the same
    snapshot (fp32); a negative prompt is refused at submit, a scheduler
    override or a fast spec at start."""
    import jax.numpy as jnp

    from uce_tpu.diffusion.pipeline_flux import FluxPipeline as JaxFlux
    from uce_tpu_torch.diffusion.pipeline_flux import FluxPipeline

    pipe = FluxPipeline.from_pretrained(flux_snap, dtype=torch.float32, device="cpu")
    cfg = ServerConfig(batch_sizes=(1, 2), max_wait_ms=500, **FLUX_CFG)
    with GenerationServer(pipe, cfg) as srv:
        futures = [srv.submit(p, seed=s) for p, s in [("a cat", 3), ("a dog", 4)]]
        served = [f.result(timeout=600) for f in futures]
        with pytest.raises(ValueError, match="no negative prompts"):
            srv.submit("a cat", seed=1, negative_prompt="blurry")
    jpipe = JaxFlux.from_pretrained(flux_snap, dtype=jnp.float32)
    want = np.asarray(jpipe(["a cat", "a dog"], seed=[3, 4], **FLUX_CFG))
    for img, ref in zip(served, want):
        assert img.shape == (16, 16, 3) and img.dtype == np.uint8
        assert np.abs(img.astype(int) - ref.astype(int)).max() <= 1
    for bad in (dict(scheduler="ddim"), dict(fast="cache=2")):
        with pytest.raises(ValueError, match="takes no"):
            GenerationServer(pipe, ServerConfig(warmup=False, **bad, **FLUX_CFG)).start()


def test_serve_cli_flux_bench(flux_snap, capsys):
    """``serve --family flux --quantize w8`` through the CLI: one JSON load
    report (the DiT quantized as it loads)."""
    from uce_tpu_torch.cli.main import main as cli_main

    base = ["serve", "--model_id", flux_snap, "--family", "flux", "--device", "cpu"]
    rc = cli_main(base + ["--bench", "5", "--bench_requests", "2", "--batch_sizes", "1,2",
                          "--image_size", "16", "--num_inference_steps", "2",
                          "--guidance_scale", "0", "--max_wait_ms", "30",
                          "--quantize", "w8"])
    assert rc == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert len(lines) == 1 and lines[0]["n_requests"] == 2
    assert lines[0]["throughput_rps"] > 0


# ---------------------------------------------------------------------------
# HiDream (``serve --family hidream``) on tests/snapshot.py's tiny snapshot
# ---------------------------------------------------------------------------

HD_CFG = dict(num_inference_steps=2, guidance_scale=5.0, height=16, width=16)


@pytest.fixture(scope="module")
def hd_snap(tmp_path_factory):
    from tests.snapshot import make_hidream_snapshot

    return make_hidream_snapshot(tmp_path_factory.mktemp("torch_serving_hd_snap"))


def test_hidream_server_matches_uce_tpu(hd_snap):
    """A HiDreamPipeline loaded whole with its DiT quantized w8 as it loads,
    served through the batch ladder with CFG and a negative prompt: each
    served image within 1 uint8 level of uce_tpu's w8 pipeline on the same
    snapshot (fp32). It takes no scheduler override (refused at start), and
    a fast spec with a cache interval fails the warm-up, as in uce_tpu."""
    import jax.numpy as jnp

    from uce_tpu.diffusion.pipeline_hidream import HiDreamPipeline as JaxHiDream
    from uce_tpu_torch.diffusion.pipeline_hidream import HiDreamPipeline

    pipe = HiDreamPipeline.from_pretrained(hd_snap, dtype=torch.float32,
                                           max_sequence_length=16, quantize="w8",
                                           device="cpu")
    cfg = ServerConfig(batch_sizes=(1, 2), max_wait_ms=500, **HD_CFG)
    with GenerationServer(pipe, cfg) as srv:
        futures = [srv.submit("a cat", seed=3, negative_prompt="blurry"),
                   srv.submit("a dog", seed=4)]
        served = [f.result(timeout=600) for f in futures]
        assert srv.stats.batches == 1
    jpipe = JaxHiDream.from_pretrained(hd_snap, dtype=jnp.float32, max_sequence_length=16,
                                       quantize="w8")
    want = np.asarray(jpipe(["a cat", "a dog"], seed=[3, 4],
                            negative_prompt=["blurry", ""], **HD_CFG))
    for img, ref in zip(served, want):
        assert img.shape == (16, 16, 3) and img.dtype == np.uint8
        assert np.abs(img.astype(int) - ref.astype(int)).max() <= 1
    with pytest.raises(ValueError, match="takes no scheduler"):
        GenerationServer(pipe, ServerConfig(warmup=False, scheduler="ddim",
                                            **HD_CFG)).start()
    with pytest.raises(ValueError, match="cfg_interval only"):
        GenerationServer(pipe, ServerConfig(batch_size=1, fast="cache=2",
                                            **HD_CFG)).start()


def test_serve_cli_hidream_bench(hd_snap, capsys):
    """``serve --family hidream --quantize int8`` through the CLI, its Llama
    read from the snapshot's text_encoder_4: one JSON load report."""
    from uce_tpu_torch.cli.main import main as cli_main

    rc = cli_main(["serve", "--model_id", hd_snap, "--family", "hidream", "--quantize",
                   "int8", "--bench", "5", "--bench_requests", "2", "--batch_sizes", "1,2",
                   "--image_size", "16", "--num_inference_steps", "2",
                   "--guidance_scale", "5", "--max_wait_ms", "30", "--device", "cpu"])
    assert rc == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert len(lines) == 1 and lines[0]["n_requests"] == 2
    assert lines[0]["throughput_rps"] > 0


def test_sdxl_int8_server_matches_uce_tpu(tmp_path_factory):
    """``serve --quantize int8`` of an SDXL pipeline (its two encoders and
    text_time conditioning through the server): the port's W8A8 server and
    uce_tpu's serve the same (prompt, seed, negative prompt) within one
    uint8 level (tests/test_sdxl_pipeline.py's tiny snapshot, fp32)."""
    import jax.numpy as jnp

    from tests.test_sdxl_pipeline import make_sdxl_snapshot
    from uce_tpu.diffusion.pipeline import SDPipeline as JaxPipeline
    from uce_tpu.serving.server import (GenerationServer as JaxServer,
                                        ServerConfig as JaxConfig)

    snap = make_sdxl_snapshot(tmp_path_factory.mktemp("torch_serving_sdxl"))
    port = SDPipeline.from_pretrained(snap, dtype=torch.float32, device="cpu")
    jpipe = JaxPipeline.from_pretrained(snap, dtype=jnp.float32)
    assert port.is_sdxl and jpipe.is_sdxl
    port.quantize_weights("int8")
    jpipe.quantize_weights("int8")
    images = []
    for server_cls, config_cls, p in ((GenerationServer, ServerConfig, port),
                                      (JaxServer, JaxConfig, jpipe)):
        with server_cls(p, config_cls(batch_size=2, max_wait_ms=1, scheduler="euler",
                                      **CFG)) as srv:
            images.append(srv.generate("a cat", seed=7, negative_prompt="a dog"))
    diff = np.abs(images[0].astype(np.int16) - images[1].astype(np.int16))
    assert images[0].shape == (32, 32, 3) and diff.max() <= 1, diff.max()
