"""The port's SD pipeline against uce_tpu's on the tiny snapshot, in fp32,
with a UCE edit overlay: images within 1 uint8 level (the bar of
tests/test_pipeline_parity.py). And the generate CLI's file contract."""

import csv
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.snapshot import make_sd_snapshot
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def sd_snap(tmp_path_factory):
    return make_sd_snapshot(tmp_path_factory.mktemp("torch_pipe_snap"))


@pytest.fixture(scope="module")
def edit_path(sd_snap, tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_pipe_edit")
    proc = subprocess.run(
        [sys.executable, "-m", "uce_tpu_torch", "edit-sd", "--model_id", sd_snap,
         "--edit_concepts", "cat", "--concept_type", "object",
         "--erase_scale", "10", "--preserve_concepts", "dog",
         "--save_dir", str(out), "--exp_name", "cat", "--device", "cpu"],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return str(out / "cat.safetensors")


@pytest.mark.parametrize("seed,per_prompt", [(42, 1), ([3, 9], 2)])
def test_pipeline_matches_uce_tpu(sd_snap, edit_path, seed, per_prompt):
    import jax.numpy as jnp

    from uce_tpu.diffusion.pipeline import SDPipeline as JaxPipeline
    from uce_tpu_torch.diffusion.pipeline import SDPipeline

    prompts = ["a cat riding a bicycle"] if isinstance(seed, int) else [
        "a cat riding a bicycle", "a photo of a dog"]
    kw = dict(num_inference_steps=6, guidance_scale=7.5, seed=seed,
              num_images_per_prompt=per_prompt, height=32, width=32)
    jpipe = JaxPipeline.from_pretrained(sd_snap, dtype=jnp.float32)
    jpipe.load_uce_edits(edit_path)
    want = np.asarray(jpipe(prompts, **kw))
    pipe = SDPipeline.from_pretrained(sd_snap, dtype=torch.float32, device="cpu")
    pipe.load_uce_edits(edit_path)
    got = pipe(prompts, **kw)
    assert got.shape == want.shape == (len(prompts) * per_prompt, 32, 32, 3)
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"max uint8 diff {diff.max()}"

    unedited = SDPipeline.from_pretrained(sd_snap, dtype=torch.float32,
                                          device="cpu")(prompts, **kw)
    assert (unedited != got).any()  # the overlay changed the images


def test_generate_cli_writes_case_pngs(sd_snap, edit_path, tmp_path):
    from uce_tpu_torch.utils.imaging import decode_png

    csv_path = tmp_path / "prompts.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["case_number", "prompt", "evaluation_seed"])
        w.writerows([[0, "a cat", 1], [3, "a dog, painted", 2], [9, "skip", 3]])
    proc = subprocess.run(
        [sys.executable, "-m", "uce_tpu_torch", "generate", "--model_id", sd_snap,
         "--prompts_path", str(csv_path), "--save_path", str(tmp_path / "out"),
         "--uce_model_path", edit_path, "--image_size", "32",
         "--num_inference_steps", "3", "--num_samples", "2", "--till_case", "5",
         "--device", "cpu"], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    folder = tmp_path / "out" / "cat"
    assert sorted(p.name for p in folder.iterdir()) == [
        "0_0.png", "0_1.png", "3_0.png", "3_1.png"]
    img = decode_png((folder / "3_1.png").read_bytes())
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8


@pytest.mark.parametrize("fast", [None, "cfg_interval=1:3,cache=2"])
def test_pipeline_spans(sd_snap, fast):
    """One call records ``pipe.call`` holding, in order, ``pipe.encode``, a
    ``pipe.model`` and a ``pipe.step`` span for each of the plan's calls,
    ``pipe.decode`` and ``pipe.readback``: under ``denoise``, with and
    without a FastConfig."""
    from uce_tpu_torch.diffusion import schedulers
    from uce_tpu_torch.diffusion.pipeline import SDPipeline
    from uce_tpu_torch.diffusion.sampler import FastConfig
    from uce_tpu_torch.utils import observability

    pipe = SDPipeline.from_pretrained(sd_snap, dtype=torch.float32, device="cpu")
    done = observability.spans()
    mark = done[-1]["id"] if done else 0
    pipe(["a cat", "a dog"], num_inference_steps=4, seed=[1, 2], height=32, width=32,
         fast=FastConfig.from_spec(fast) if fast else None)
    got = [s for s in observability.spans() if s["id"] > mark]
    (call,) = [s for s in got if s["name"] == "pipe.call"]
    assert call["batch"] == 2 and call["steps"] == 4 and call["parent"] is None
    inside = [s for s in got if s["parent"] == call["id"]]
    n = schedulers.plan_from_hf(pipe.scheduler_config, 4).num_calls
    assert [s["name"] for s in inside] == (["pipe.encode"] + ["pipe.model", "pipe.step"] * n
                                          + ["pipe.decode", "pipe.readback"])
    assert [s["call"] for s in inside if s["name"] == "pipe.model"] == list(range(n))
    assert [s["call"] for s in inside if s["name"] == "pipe.step"] == list(range(n))
    starts = [s["start_ns"] for s in inside]
    assert starts == sorted(starts) and all(s["end_ns"] <= call["end_ns"] for s in inside)
    assert all(s["stream_s"] is None for s in got)


@pytest.fixture
def counted_launches(monkeypatch):
    """The conv3x3 and group_norm_act plain versions count a launch each, as
    the CUDA kernels do (a CPU tensor's plain version leaves the counters
    alone)."""
    from uce_tpu_torch.ops import kernels
    from uce_tpu_torch.ops.kernels import conv3x3 as ck, group_norm as gk

    for module, name, kernel in ((ck, "conv3x3_reference", "conv3x3"),
                                 (gk, "group_norm_act_reference", "group_norm_act")):
        plain = getattr(module, name)

        def wrapped(*args, _kernel=kernel, _plain=plain, **kwargs):
            kernels.count(_kernel)
            return _plain(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)
    return lambda: tuple(kernels.launches()[k] for k in ("conv3x3", "group_norm_act"))


def _model_spans_of(pipe, steps):
    """The spans one call of ``pipe`` records."""
    from uce_tpu_torch.utils import observability

    done = observability.spans()
    mark = done[-1]["id"] if done else 0
    pipe(["a cat"], num_inference_steps=steps, seed=[1], height=32, width=32)
    return [s for s in observability.spans() if s["id"] > mark]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_model_spans_count_kernel_launches(sd_snap, monkeypatch, counted_launches, dtype):
    """Each ``pipe.model`` span carries the conv3x3 and group_norm_act
    launches of its call: one UNet forward's, every 3x3 conv and GroupNorm
    in bf16, none in fp32."""
    from uce_tpu_torch.diffusion.pipeline import SDPipeline
    from uce_tpu_torch.models import unet as unet_mod

    forwards = []
    apply = unet_mod.apply

    def counted(*args, **kwargs):
        before = counted_launches()
        out = apply(*args, **kwargs)
        forwards.append(tuple(n - b for n, b in zip(counted_launches(), before)))
        return out
    monkeypatch.setattr(unet_mod, "apply", counted)
    pipe = SDPipeline.from_pretrained(sd_snap, dtype=dtype, device="cpu")
    got = [(s["conv3x3"], s["group_norm_act"]) for s in _model_spans_of(pipe, 3)
           if s["name"] == "pipe.model"]
    assert len(got) >= 3 and got == forwards
    assert all(n > 0 for n in got[0]) if dtype == torch.bfloat16 else got[0] == (0, 0)


def test_conv_gn_kernels_metric_reads_the_model_spans(sd_snap, counted_launches):
    """``perfbench``'s ``conv_gn_kernels_per_call.eval`` reads the median
    conv3x3 + group_norm_act launches of the ``pipe.model`` spans, and None
    from spans without the attrs (a program that does not count them)."""
    from perfbench.core import harness
    from uce_tpu_torch.diffusion.pipeline import SDPipeline

    metric = harness.load("metrics", "conv_gn_kernels_per_call.eval")
    pipe = SDPipeline.from_pretrained(sd_snap, dtype=torch.bfloat16, device="cpu")
    spans = _model_spans_of(pipe, 10)
    calls = [s["conv3x3"] + s["group_norm_act"] for s in spans if s["name"] == "pipe.model"]
    assert len(calls) >= 10 and len(set(calls)) == 1 and calls[0] > 0
    assert metric.value(spans) == calls[0]
    bare = [{k: v for k, v in s.items() if k not in ("conv3x3", "group_norm_act")}
            for s in spans]
    assert metric.value(bare) is None
    assert metric.value(spans[:3]) is None  # fewer than 10 calls
