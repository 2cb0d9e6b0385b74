#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card at SD 1.4's
full width, and check it.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is non-zero unless all pass):
  1. the card: CUDA must be available; print its name and power limit;
  2. the sd_attention kernel: build it from csrc/, compare it with its plain
     PyTorch version at the UNet's shapes and on the kernel tests' cases,
     and time both with CUDA events;
  3. a seeded random-weight SD 1.4 snapshot (UNet, CLIP text, VAE, PNDM
     scheduler, a character-vocabulary tokenizer) written under build/;
  4. ``edit-sd`` through the CLI: 32 finite cross-attention K/V targets;
  5. one full-width UNet forward with impl="auto" (kernel) against
     impl="plain";
  6. ``generate`` through the CLI at 512px, PNDM, 50 steps, CFG 7.5, with
     the edit overlay: PNG checks, the kernel's launch count, img/s.
The last two lines are the kernels' JSON record and the device record.
"""

from __future__ import annotations

import csv
import json
import os
import shutil
import string
import subprocess
import sys
import time

import numpy as np
import torch

from uce_tpu_torch.cli.main import main as cli_main
from uce_tpu_torch.diffusion.pipeline import SDPipeline
from uce_tpu_torch.diffusion.schedulers import pndm_plan
from uce_tpu_torch.models import clip_text, unet, vae
from uce_tpu_torch.models.hf_loader import read_safetensors, save_safetensors
from uce_tpu_torch.models.sd_targets import is_sd_cross_attn_kv
from uce_tpu_torch.ops import attention
from uce_tpu_torch.ops.kernels import _build, sd_attention as sdk
from uce_tpu_torch.utils.imaging import decode_png
from uce_tpu_torch.utils.torch_rng import draw_prompt_latents

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
SEED = 0

# Kernel against plain version, bf16 outputs: |got - ref| <= ATOL + RTOL*|ref|
# (the tolerance of tests/test_sd_attention.py).
ATOL, RTOL = 0.02, 0.05
# Full-width UNet forward, kernel against plain attention: relative L2 bound.
UNET_REL_L2_MAX = 5e-2
SLICE_SHAPES = [(16, 8, 4096, 4096, 40), (16, 8, 1024, 1024, 80)]
TEST_CASES = [(2, 2, 256, 256, 40), (1, 4, 512, 512, 80), (2, 2, 64, 64, 160),
              (2, 2, 256, 77, 40), (1, 2, 512, 77, 160)]
ART = "Kelly McKernan; Thomas Kinkade; Tyler Edlin; Kilian Eng; Ajin Demi Human"
PRESERVE = "Van Gogh; Rembrandt; Pablo Picasso"


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_kernel():
    start = time.perf_counter()
    sdk.build()
    print(f"[kernel] sd_attention built in {time.perf_counter() - start:.1f} s "
          f"(nvcc {_build.build_seconds.get('sd_attention', 0.0):.1f} s)")
    gen = torch.Generator("cuda").manual_seed(SEED)
    worst, timings = 0.0, {}
    for b, h, sq, skv, d in SLICE_SHAPES + TEST_CASES:
        q = torch.randn(b, h, sq, d, device="cuda", generator=gen).bfloat16()
        k = torch.randn(b, h, skv, d, device="cuda", generator=gen).bfloat16()
        v = torch.randn(b, h, skv, d, device="cuda", generator=gen).bfloat16()
        scale = d ** -0.5
        got = sdk.sd_attention(q, k, v, scale)
        torch.cuda.synchronize()
        ref = sdk.sd_attention_reference(q, k, v, scale)
        err = (got.float() - ref.float()).abs()
        bound = ATOL + RTOL * ref.float().abs()
        max_err = float(err.max())
        if not bool((err <= bound).all()):
            raise AssertionError(f"sd_attention {(b, h, sq, skv, d)}: max abs err "
                                 f"{max_err} outside atol={ATOL}, rtol={RTOL}")
        worst = max(worst, max_err)
        line = f"[kernel] {(b, h, sq, skv, d)} max_abs_err {max_err:.6f}"
        if (b, h, sq, skv, d) in SLICE_SHAPES:
            ms = median_ms(lambda: sdk.sd_attention(q, k, v, scale))
            ref_ms = median_ms(lambda: sdk.sd_attention_reference(q, k, v, scale))
            plain_ms = median_ms(lambda: attention.plain_attention(
                q, k, v, None, False, scale))
            timings[(sq, d)] = (ms, ref_ms)
            line += (f" kernel {ms:.4f} ms, plain version {ref_ms:.4f} ms, "
                     f"plain attention path {plain_ms:.4f} ms (median of 10)")
        print(line, flush=True)
    return worst, timings


def write_tokenizer(path: str) -> None:
    """A character vocabulary with CLIP's special tokens (no merges)."""
    os.makedirs(path, exist_ok=True)
    chars = list(string.ascii_lowercase + string.digits + "'-")
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": len(chars) + i for i, c in enumerate(chars)})
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    with open(os.path.join(path, "special_tokens_map.json"), "w") as f:
        json.dump({"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
                   "pad_token": "<|endoftext|>", "unk_token": "<|endoftext|>"}, f)


def write_snapshot(root: str) -> None:
    """SD 1.4 at full width with seeded random weights, stored in fp16."""
    rng = np.random.default_rng(SEED)
    parts = [("unet", unet.SD14_UNET_CONFIG, unet.init_state_dict,
              "diffusion_pytorch_model.safetensors"),
             ("vae", vae.SD_VAE_CONFIG, vae.init_state_dict,
              "diffusion_pytorch_model.safetensors"),
             ("text_encoder", clip_text.SD14_TEXT_CONFIG, clip_text.init_state_dict,
              "model.safetensors")]
    for sub, cfg, init, fname in parts:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(cfg.to_hf(), f)
        sd = {k: v.astype(np.float16) for k, v in init(cfg, rng).items()}
        save_safetensors(sd, os.path.join(root, sub, fname))
    write_tokenizer(os.path.join(root, "tokenizer"))
    os.makedirs(os.path.join(root, "scheduler"), exist_ok=True)
    with open(os.path.join(root, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump({"_class_name": "PNDMScheduler", "beta_start": 0.00085,
                   "beta_end": 0.012, "beta_schedule": "scaled_linear",
                   "num_train_timesteps": 1000, "set_alpha_to_one": False,
                   "steps_offset": 1, "skip_prk_steps": True}, f)


def phase_edit(snap: str) -> tuple[str, float]:
    out = os.path.join(WORK, "edits")
    start = time.perf_counter()
    rc = cli_main(["edit-sd", "--model_id", snap, "--edit_concepts", ART,
                   "--concept_type", "art", "--preserve_concepts", PRESERVE,
                   "--save_dir", out, "--exp_name", "erase_art", "--device", "cuda"])
    seconds = time.perf_counter() - start
    path = os.path.join(out, "erase_art.safetensors")
    edits = read_safetensors(path)
    if rc != 0 or len(edits) != 32:
        raise AssertionError(f"edit-sd: rc {rc}, {len(edits)} targets (want 32)")
    for k, v in edits.items():
        if not (k.endswith(".weight") and is_sd_cross_attn_kv(k)):
            raise AssertionError(f"edit-sd wrote an unexpected key {k}")
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"edit-sd: non-finite values in {k}")
    print(f"[edit] 32 finite targets in {seconds:.2f} s (CLI wall, load included)")
    return path, seconds


def phase_unet(pipe) -> tuple[float, float, float]:
    prompts = ["a painting by kelly mckernan", "a photo of a dog"]
    with torch.inference_mode():
        context = torch.cat([pipe.encode_prompts(["", ""]),
                             pipe.encode_prompts(prompts)])
        latents = draw_prompt_latents((64, 64, 4), SEED, 2, 1).to("cuda", pipe.dtype)
        x = torch.cat([latents, latents])
        outs, times = {}, {}
        for impl in ("auto", "plain"):
            fwd = lambda: unet.apply(pipe.unet_params, x, 981.0, context,
                                     pipe.unet_config, attn_impl=impl)
            sdk.launches = 0
            outs[impl] = fwd().float()
            torch.cuda.synchronize()
            if sdk.launches != (10 if impl == "auto" else 0):
                raise AssertionError(f"UNet impl={impl}: {sdk.launches} launches")
            times[impl] = median_ms(fwd, reps=5)
    a, p = outs["auto"], outs["plain"]
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("UNet forward: non-finite output")
    rel = float((a - p).norm() / p.norm())
    if rel > UNET_REL_L2_MAX:
        raise AssertionError(f"UNet forward: rel L2 {rel} > {UNET_REL_L2_MAX}")
    print(f"[unet] batch 4 (2 prompts x CFG) at 64x64 latents: rel L2 "
          f"auto vs plain {rel:.3e} (bound {UNET_REL_L2_MAX}); forward "
          f"{times['auto']:.2f} ms with the kernel, {times['plain']:.2f} ms plain "
          "(median of 5)")
    return rel, times["auto"], times["plain"]


def phase_generate(snap: str, edit_path: str) -> int:
    csv_path = os.path.join(WORK, "prompts.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["case_number", "prompt", "evaluation_seed"])
        w.writerows([[0, "a painting by kelly mckernan", 1],
                     [1, "a house in the style of rembrandt", 2]])
    out = os.path.join(WORK, "images")
    sdk.launches = 0
    start = time.perf_counter()
    rc = cli_main(["generate", "--model_id", snap, "--prompts_path", csv_path,
                   "--save_path", out, "--uce_model_path", edit_path,
                   "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = sdk.launches
    expected = 10 * 2 * pndm_plan(50).num_calls
    if rc != 0 or launches != expected:
        raise AssertionError(f"generate: rc {rc}, sd_attention launches "
                             f"{launches} (want 10 x 2 rows x 51 UNet calls = "
                             f"{expected})")
    for case in (0, 1):
        with open(os.path.join(out, "erase_art", f"{case}_0.png"), "rb") as f:
            img = decode_png(f.read())
        if img.shape != (512, 512, 3) or img.dtype != np.uint8 or img.std() == 0:
            raise AssertionError(f"generate: image {case} is {img.shape} "
                                 f"{img.dtype}, std {img.std()}")
    print(f"[generate] 2 PNGs 512x512x3 uint8 in {seconds:.2f} s (CLI wall, "
          f"load included); sd_attention launches {launches} = {expected}")
    return launches


def phase_throughput(pipe) -> float:
    prompts = ["a painting by kelly mckernan", "a house in the style of rembrandt"]
    torch.cuda.synchronize()
    start = time.perf_counter()
    imgs = pipe(prompts, num_inference_steps=50, guidance_scale=7.5, seed=[1, 2])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    if imgs.shape != (2, 512, 512, 3):
        raise AssertionError(f"pipeline returned {imgs.shape}")
    rate = 2 / seconds
    print(f"[generate] 2 prompts in one batch (UNet batch 4), 50 PNDM steps: "
          f"{seconds:.3f} s, {rate:.4f} img/s")
    return rate


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    print(f"[card] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    worst, timings = phase_kernel()

    shutil.rmtree(WORK, ignore_errors=True)
    snap = os.path.join(WORK, "sd14_random")
    try:
        start = time.perf_counter()
        write_snapshot(snap)
        print(f"[snapshot] SD 1.4 random weights written in "
              f"{time.perf_counter() - start:.1f} s", flush=True)
        edit_path, _ = phase_edit(snap)
        pipe = SDPipeline.from_pretrained(snap, dtype=torch.bfloat16, device="cuda")
        phase_unet(pipe)
        launches = phase_generate(snap, edit_path)
        phase_throughput(pipe)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    ms, plain_ms = timings[(4096, 40)]
    print(f"[card] {name}")
    print(json.dumps({"kernels": [{
        "name": "sd_attention", "route": "cuda",
        "source": "uce_tpu_torch/csrc/sd_attention.cu",
        "replaces": "uce_tpu/ops/pallas/sd_attention.py:86",
        "launches": launches, "max_abs_err": worst,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
