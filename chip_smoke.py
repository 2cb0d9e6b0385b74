#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card at SD 1.4's
full width, and check them.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is non-zero unless all pass):
  1. the card: CUDA must be available; print its name and power limit;
  2. the kernels: build the four libraries from csrc/ (one nvcc each, all at
     once), compare each kernel with its plain PyTorch version at the main
     paths' shapes and on the Pallas tests' cases (elementwise and relative
     L2 bounds), and time the kernel, the plain version and one library call
     for the same function (CUDA events);
  3. a seeded random-weight SD 1.4 snapshot (UNet, CLIP text, VAE, PNDM
     scheduler, a character-vocabulary tokenizer) written under build/;
  4. ``edit-sd`` through the CLI with ``--method collapsed``, ``pallas`` (the
     uce_solve kernel) and ``general``: 32 finite cross-attention K/V targets
     each, held to a float64 solve of the same embeddings within a bound set
     from cond(mat2), and pallas to collapsed;
  5. full-width UNet forwards at batch 4: impl="auto" (attention kernel)
     against impl="plain", and with UCE_CONV_IMPL=UCE_GN_IMPL=pallas (all
     kernels) against the library path, with the launches per forward;
  6. one VAE decode at 512x512 on both paths, with its launches;
  7. ``generate`` through the CLI at 512px, PNDM, 50 steps, CFG 7.5, with the
     edit overlay, on the default path and on the kernel path: PNG checks and
     every kernel's launch count; then img/s on both paths.
The last two lines are the kernels' JSON record and the device record.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import shutil
import string
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from uce_tpu_torch.cli.main import main as cli_main
from uce_tpu_torch.diffusion.pipeline import SDPipeline
from uce_tpu_torch.diffusion.schedulers import pndm_plan
from uce_tpu_torch.edit import sd as edit_sd
from uce_tpu_torch.models import clip_text, unet, vae
from uce_tpu_torch.models.hf_loader import read_safetensors, save_safetensors
from uce_tpu_torch.models.layers import KERNEL_IMPL, KERNEL_VARS
from uce_tpu_torch.models.sd_targets import is_sd_cross_attn_kv
from uce_tpu_torch.ops import attention
from uce_tpu_torch.ops.kernels import _build, conv3x3 as convk, group_norm as gnk
from uce_tpu_torch.ops.kernels import sd_attention as sdk, uce_solve as solvek
from uce_tpu_torch.utils.imaging import decode_png
from uce_tpu_torch.utils.prompts import resolve_edit_request
from uce_tpu_torch.utils.torch_rng import draw_prompt_latents

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
SEED = 0

# Kernel against plain version, bf16 outputs, for attention, GroupNorm and
# the conv, at every shape: |got - ref| <= ATOL + RTOL*|ref| elementwise (the
# tolerance of tests/test_sd_attention.py) and a relative L2 error of at most
# KERNEL_REL_L2[kernel]. The elementwise bound alone is about as large as a
# typical attention output at s=4096 (mean |ref| ~0.02), so it catches only
# gross faults; the relative L2 bound scales with the output at each shape.
# Attention rounds its probabilities and output to bf16 (about 2^-9/sqrt(3)
# ~ 1.1e-3 each; 2.9e-3 to 3.1e-3 measured at every shape on an H100).
# GroupNorm and the conv do their plain versions' fp32 arithmetic in
# another order and differ only where a bf16 rounding flips (measured at
# most 2.2e-5 and 3.2e-4).
ATOL, RTOL = 0.02, 0.05
KERNEL_REL_L2 = {"sd_attention": 1e-2, "group_norm_act": 1e-3, "conv3x3": 2e-3}
# uce_solve: max |X_kernel - X_plain| / max |X_plain| (both fp32).
SOLVE_REL_MAX = 1e-3
# edit-sd: max abs diff / max abs over the 32 targets. Each method is held
# to a float64 solve of the same fp32 embeddings: an fp32 solve is accurate
# to about cond(mat2) * eps32 relative, so the bound is EDIT_COND_FACTOR times
# that (capped at EDIT_REL_CAP, beyond which the check would not tell a
# wrong solve from round-off). --method pallas is also held to collapsed
# within the bar of tests/test_pallas_solve.py.
EPS32 = float(torch.finfo(torch.float32).eps)
EDIT_COND_FACTOR = 4.0
EDIT_REL_CAP = 1e-2
PALLAS_VS_COLLAPSED_MAX = 5e-3
# Full-width bf16 forwards, one path against another: relative L2 bound.
REL_L2_MAX = 5e-2
# Per forward at SD 1.4 (UNet) and per decode (VAE): kernel launches on the
# kernel path (UCE_CONV_IMPL=UCE_GN_IMPL=pallas), attention on "auto".
# The library path launches only the attention kernel.
UNET_LAUNCHES = {"conv3x3": 49, "group_norm_act": 61, "sd_attention": 10}
VAE_LAUNCHES = {"conv3x3": 33, "group_norm_act": 28, "sd_attention": 1}
UNET_LAUNCHES_LIBRARY = {"conv3x3": 0, "group_norm_act": 0, "sd_attention": 10}
VAE_LAUNCHES_LIBRARY = {"conv3x3": 0, "group_norm_act": 0, "sd_attention": 1}
# NVIDIA H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 CUDA
# cores, HBM3.
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12

ATTN_SLICE = [(16, 8, 4096, 4096, 40), (16, 8, 1024, 1024, 80),
              (1, 1, 4096, 4096, 512)]
ATTN_CASES = [(2, 2, 256, 256, 40), (1, 4, 512, 512, 80), (2, 2, 64, 64, 160),
              (2, 2, 256, 77, 40), (1, 2, 512, 77, 160), (2, 1, 200, 200, 512)]
# (shape NHWC, groups, eps, act)
GN_SLICE = [((4, 64, 64, 320), 32, 1e-5, "silu"), ((1, 512, 512, 128), 32, 1e-6, "silu")]
GN_CASES = [((4, 32, 32, 1920), 32, 1e-5, "silu"), ((4, 8, 8, 2560), 32, 1e-5, "silu"),
            ((4, 64, 64, 320), 32, 1e-6, "none"), ((1, 512, 512, 256), 32, 1e-6, "silu"),
            ((2, 8, 8, 64), 8, 1e-5, "none"), ((3, 4, 4, 320), 32, 1e-5, "silu"),
            ((1, 16, 16, 128), 32, 1e-5, "none"), ((1, 24, 24, 64), 8, 1e-5, "none")]
# (shape NHWC, cout)
CONV_SLICE = [((4, 64, 64, 320), 320), ((1, 512, 512, 128), 128)]
CONV_CASES = [((4, 64, 64, 4), 320), ((4, 64, 64, 320), 4), ((4, 32, 32, 1920), 640),
              ((4, 8, 8, 2560), 1280), ((1, 64, 64, 4), 512), ((1, 128, 128, 512), 512),
              ((1, 512, 512, 128), 3), ((2, 8, 8, 12), 20), ((1, 6, 6, 4), 20)]
# (edit concepts, preserve concepts, d): the main path's art erase, then the
# Pallas tests' cases and a 100-concept list.
SOLVE_SLICE = [(5, 3, 768)]
SOLVE_CASES = [(4, 3, 256), (16, 0, 256), (100, 0, 768)]

ART = "Kelly McKernan; Thomas Kinkade; Tyler Edlin; Kilian Eng; Ajin Demi Human"
PRESERVE = "Van Gogh; Rembrandt; Pablo Picasso"
KERNEL_MODULES = {"sd_attention": sdk, "group_norm_act": gnk, "conv3x3": convk,
                  "uce_solve": solvek}


@contextlib.contextmanager
def kernel_env(on: bool = True):
    """Set (on) or clear both kernel variables for the enclosed calls."""
    saved = {k: os.environ.get(k) for k in KERNEL_VARS}
    for k in KERNEL_VARS:
        if on:
            os.environ[k] = KERNEL_IMPL
        else:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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


def reset_launches() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0
    sdk.launches_by_dim.clear()


def read_launches() -> dict[str, int]:
    torch.cuda.synchronize()
    counts = {name: mod.launches for name, mod in KERNEL_MODULES.items()}
    counts["sd_attention_d512"] = sdk.launches_by_dim.get(512, 0)
    return counts


def bound(flops: float, peak_flops: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of operations over
    the peak rate and bytes over the memory rate."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_bf16(kernel: str, what: str, got, ref) -> tuple[float, str]:
    """Hold a bf16 kernel output to its plain version; return the max abs
    error and a note of the readings."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    max_err = float(err.max())
    rel = rel_l2(got, ref)
    if not bool((err <= ATOL + RTOL * ref.abs()).all()):
        raise AssertionError(f"{what}: max abs err {max_err} outside atol={ATOL}, "
                             f"rtol={RTOL}")
    if not rel <= KERNEL_REL_L2[kernel]:
        raise AssertionError(f"{what}: rel L2 {rel} > {KERNEL_REL_L2[kernel]}")
    return max_err, (f"max_abs_err {max_err:.6f}, rel L2 {rel:.3e}, mean |ref| "
                     f"{float(ref.abs().mean()):.4f}")


def phase_build() -> None:
    """One nvcc per library, all started together."""
    start = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNEL_MODULES)) as pool:
        for future in [pool.submit(mod.build) for mod in KERNEL_MODULES.values()]:
            future.result()
    print(f"[kernel] 4 libraries built in {time.perf_counter() - start:.1f} s",
          flush=True)
    for name in ("sd_attention", "group_norm", "conv3x3", "uce_solve"):
        print(f"[kernel]   {name}: nvcc {_build.build_seconds.get(name, 0.0):.1f} s")


def phase_attention(gen, rows: dict) -> None:
    for b, h, sq, skv, d in ATTN_SLICE + ATTN_CASES:
        q = torch.randn(b, h, sq, d, device="cuda", generator=gen).bfloat16()
        k = torch.randn(b, h, skv, d, device="cuda", generator=gen).bfloat16()
        v = torch.randn(b, h, skv, d, device="cuda", generator=gen).bfloat16()
        scale = d ** -0.5
        name = "sd_attention_d512" if d == 512 else "sd_attention"
        got = sdk.sd_attention(q, k, v, scale)
        torch.cuda.synchronize()
        max_err, note = check_bf16("sd_attention",
                                   f"sd_attention {(b, h, sq, skv, d)}", got,
                                   sdk.sd_attention_reference(q, k, v, scale))
        row = rows[name]
        row["max_abs_err"] = max(row["max_abs_err"], max_err)
        line = f"[kernel] sd_attention {(b, h, sq, skv, d)} {note}"
        if (b, h, sq, skv, d) in ATTN_SLICE:
            ms = median_ms(lambda: sdk.sd_attention(q, k, v, scale))
            plain_ms = median_ms(lambda: sdk.sd_attention_reference(q, k, v, scale))
            lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale))
            path_ms = median_ms(lambda: attention.plain_attention(
                q, k, v, None, False, scale))
            bound_ms, by = bound(4.0 * b * h * sq * skv * d, PEAK_BF16,
                                 2.0 * (2 * b * h * sq * d + 2 * b * h * skv * d))
            if (sq, d) in ((4096, 40), (4096, 512)):
                row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=by)
            line += (f" kernel {ms:.4f} ms, plain version {plain_ms:.4f} ms, "
                     f"library {lib_ms:.4f} ms, plain attention path "
                     f"{path_ms:.4f} ms (median of 10), bound {bound_ms:.4f} ms "
                     f"({by})")
        print(line, flush=True)


def phase_group_norm(gen, rows: dict) -> None:
    row = rows["group_norm_act"]
    for shape, groups, eps, act in GN_SLICE + GN_CASES:
        c = shape[-1]
        x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5).bfloat16()
        scale = torch.randn(c, device="cuda", generator=gen)
        bias = torch.randn(c, device="cuda", generator=gen)
        got = gnk.group_norm_act(x, scale, bias, groups, eps, act)
        torch.cuda.synchronize()
        max_err, note = check_bf16("group_norm_act", f"group_norm_act {shape}", got,
                                   gnk.group_norm_act_reference(x, scale, bias,
                                                                groups, eps, act))
        again = gnk.group_norm_act(x, scale, bias, groups, eps, act)
        if not torch.equal(got, again):
            raise AssertionError(f"group_norm_act {shape}: results differ run to run")
        row["max_abs_err"] = max(row["max_abs_err"], max_err)
        line = f"[kernel] group_norm_act {shape} {act} {note}"
        if (shape, groups, eps, act) in GN_SLICE:
            x_nchw = x.permute(0, 3, 1, 2)  # channels_last memory, as the models
            scale16, bias16 = scale.bfloat16(), bias.bfloat16()
            ms = median_ms(lambda: gnk.group_norm_act(x, scale, bias, groups, eps, act))
            plain_ms = median_ms(lambda: gnk.group_norm_act_reference(
                x, scale, bias, groups, eps, act))
            lib_ms = median_ms(lambda: F.silu(F.group_norm(
                x_nchw, groups, scale16, bias16, eps)))
            bound_ms, by = bound(10.0 * x.numel(), PEAK_FP32,
                                 2.0 * 2 * x.numel() + 2 * 4 * c)
            if shape == GN_SLICE[0][0]:
                row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=by)
            line += (f" kernel {ms:.4f} ms, plain version {plain_ms:.4f} ms, "
                     f"library {lib_ms:.4f} ms (median of 10), bound "
                     f"{bound_ms:.4f} ms ({by})")
        print(line, flush=True)


def phase_conv(gen, rows: dict) -> None:
    row = rows["conv3x3"]
    for shape, cout in CONV_SLICE + CONV_CASES:
        cin = shape[-1]
        x = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(cout, cin, 3, 3, device="cuda", generator=gen)
             / (9 * cin) ** 0.5).bfloat16()
        bias = (torch.randn(cout, device="cuda", generator=gen) * 0.1).bfloat16()
        w_packed = convk.pack_weight(w)
        got = convk.conv3x3(x, w_packed, bias)
        torch.cuda.synchronize()
        max_err, note = check_bf16("conv3x3", f"conv3x3 {shape}->{cout}", got,
                                   convk.conv3x3_reference(x, w_packed, bias))
        row["max_abs_err"] = max(row["max_abs_err"], max_err)
        line = f"[kernel] conv3x3 {shape}->{cout} {note}"
        if (shape, cout) in CONV_SLICE:
            x_nchw = x.permute(0, 3, 1, 2)
            w_cl = w.contiguous(memory_format=torch.channels_last)
            ms = median_ms(lambda: convk.conv3x3(x, w_packed, bias))
            plain_ms = median_ms(lambda: convk.conv3x3_reference(x, w_packed, bias))
            lib_ms = median_ms(lambda: F.conv2d(x_nchw, w_cl, bias, padding=1))
            m = x.numel() // cin
            bound_ms, by = bound(2.0 * m * cout * 9 * cin, PEAK_BF16,
                                 2.0 * (x.numel() + w.numel() + cout + m * cout))
            if shape == CONV_SLICE[0][0]:
                row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=by)
            line += (f" kernel {ms:.4f} ms, plain version {plain_ms:.4f} ms, "
                     f"library {lib_ms:.4f} ms (median of 10), bound "
                     f"{bound_ms:.4f} ms ({by})")
        print(line, flush=True)


def phase_solve(gen, rows: dict) -> None:
    row = rows["uce_solve"]
    for ke, kp, d in SOLVE_SLICE + SOLVE_CASES:
        c_edit = torch.randn(ke, d, device="cuda", generator=gen)
        c_pres = torch.randn(kp, d, device="cuda", generator=gen)
        args = (c_edit, c_pres, 1.3, 0.7, 0.5)
        got = solvek.newton_schulz_inverse(*args)
        torch.cuda.synchronize()
        ref = solvek.newton_schulz_reference(*args)
        rel = float((got - ref).abs().max() / ref.abs().max())
        if not rel <= SOLVE_REL_MAX:
            raise AssertionError(f"uce_solve {(ke, kp, d)}: relative max err {rel} "
                                 f"> {SOLVE_REL_MAX}")
        row["max_abs_err"] = max(row["max_abs_err"], float((got - ref).abs().max()))
        line = f"[kernel] uce_solve {(ke, kp, d)} relative max err {rel:.3e}"
        if (ke, kp, d) in SOLVE_SLICE:
            eye = torch.eye(d, device="cuda")
            b_mat = 1.3 * c_edit.T @ c_edit + 0.7 * c_pres.T @ c_pres + 0.5 * eye
            ms = median_ms(lambda: solvek.newton_schulz_inverse(*args))
            plain_ms = median_ms(lambda: solvek.newton_schulz_reference(*args))
            lib_ms = median_ms(lambda: torch.linalg.inv(b_mat))
            flops = 2.0 * d * d * (ke + kp) + solvek.NEWTON_ITERS * 2 * 2.0 * d ** 3
            bound_ms, by = bound(flops, PEAK_FP32, 4.0 * (ke + kp) * d + 4.0 * d * d)
            row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=by)
            line += (f" kernel {ms:.4f} ms, plain version {plain_ms:.4f} ms, "
                     f"library (torch.linalg.inv) {lib_ms:.4f} ms (median of 10), "
                     f"bound {bound_ms:.4f} ms ({by})")
        print(line, flush=True)


def phase_kernels(rows: dict) -> None:
    gen = torch.Generator("cuda").manual_seed(SEED)
    phase_attention(gen, rows)
    phase_group_norm(gen, rows)
    phase_conv(gen, rows)
    phase_solve(gen, rows)


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


def run_edit(snap: str, name: str, extra: list[str]) -> tuple[dict, float]:
    out = os.path.join(WORK, "edits")
    start = time.perf_counter()
    rc = cli_main(["edit-sd", "--model_id", snap, "--edit_concepts", ART,
                   "--concept_type", "art", "--preserve_concepts", PRESERVE,
                   "--save_dir", out, "--exp_name", name, "--device", "cuda", *extra])
    seconds = time.perf_counter() - start
    edits = read_safetensors(os.path.join(out, name + ".safetensors"))
    if rc != 0 or len(edits) != 32:
        raise AssertionError(f"edit-sd {extra}: rc {rc}, {len(edits)} targets "
                             "(want 32)")
    for k, v in edits.items():
        if not (k.endswith(".weight") and is_sd_cross_attn_kv(k)):
            raise AssertionError(f"edit-sd wrote an unexpected key {k}")
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"edit-sd {extra}: non-finite values in {k}")
    return edits, seconds


def edit_float64(snap: str) -> tuple[dict, float]:
    """The art erase solved in float64 from the same fp32 concept
    embeddings, and cond(mat2)."""
    edits, guides, preserves = resolve_edit_request(ART, None, PRESERVE, "art")
    res = edit_sd.load_resources(snap, device="cuda")
    emb = res.encode_concepts(edits + guides + preserves)
    stack = lambda names: torch.stack([emb[n].double() for n in names])
    c_edit, c_guide, c_pres = stack(edits), stack(guides), stack(preserves)
    lam = 0.5 * torch.eye(c_edit.shape[1], dtype=torch.float64, device="cuda")
    mat2 = lam + c_edit.T @ c_edit + c_pres.T @ c_pres
    mat_a = lam + c_guide.T @ c_edit + c_pres.T @ c_pres
    e = torch.linalg.solve(mat2, mat_a.T).T
    return ({k: (w.double().cuda() @ e).float().cpu() for k, w in res.targets.items()},
            float(torch.linalg.cond(mat2)))


def rel_max(got: dict, want: dict) -> float:
    scale = max(float(v.abs().max()) for v in want.values())
    return max(float((got[k] - want[k]).abs().max()) for k in want) / scale


def phase_edit(snap: str) -> tuple[str, int]:
    exact, cond = edit_float64(snap)
    bound = min(EDIT_COND_FACTOR * cond * EPS32, EDIT_REL_CAP)
    print(f"[edit] cond(mat2) {cond:.4e}; bound on the distance from a float64 "
          f"solve {bound:.3e} ({EDIT_COND_FACTOR} x cond x eps32, cap {EDIT_REL_CAP})")
    results, solve_launches = {}, 0
    for method in ("collapsed", "pallas", "general"):
        reset_launches()
        name = "erase_art" if method == "collapsed" else f"erase_art_{method}"
        edits, seconds = run_edit(snap, name, ["--method", method])
        launches = read_launches()["uce_solve"]
        want = 1 if method == "pallas" else 0
        if launches != want:
            raise AssertionError(f"edit-sd --method {method}: uce_solve launched "
                                 f"{launches} times (want {want})")
        rel = rel_max(edits, exact)
        if not rel <= bound:
            raise AssertionError(f"edit-sd --method {method}: relative max diff "
                                 f"{rel} from a float64 solve > {bound}")
        line = (f"[edit] --method {method}: 32 finite targets in {seconds:.2f} s "
                f"(CLI wall, load included), relative max diff from a float64 "
                f"solve {rel:.3e} (bound {bound:.3e})")
        if method != "collapsed":
            rel_c = rel_max(edits, results["collapsed"])
            if method == "pallas" and not rel_c <= PALLAS_VS_COLLAPSED_MAX:
                raise AssertionError(f"edit-sd --method pallas: relative max diff "
                                     f"{rel_c} from collapsed > "
                                     f"{PALLAS_VS_COLLAPSED_MAX}")
            line += f", from collapsed {rel_c:.3e}"
        print(f"{line}, uce_solve launches {launches}", flush=True)
        results[method] = edits
        solve_launches += launches
    return os.path.join(WORK, "edits", "erase_art.safetensors"), solve_launches


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def expect_launches(what: str, got: dict, want: dict) -> None:
    wrong = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if wrong:
        raise AssertionError(f"{what}: launches (got, want) {wrong}")


def phase_unet(pipe) -> None:
    prompts = ["a painting by kelly mckernan", "a photo of a dog"]
    with torch.inference_mode():
        context = torch.cat([pipe.encode_prompts(["", ""]),
                             pipe.encode_prompts(prompts)])
        latents = draw_prompt_latents((64, 64, 4), SEED, 2, 1).to("cuda", pipe.dtype)
        x = torch.cat([latents, latents])
        runs = {"plain": ("plain", False), "library": ("auto", False),
                "kernels": ("auto", True)}
        want = {"plain": {**UNET_LAUNCHES_LIBRARY, "sd_attention": 0},
                "library": UNET_LAUNCHES_LIBRARY, "kernels": UNET_LAUNCHES}
        outs, times = {}, {}
        for name, (impl, kernels) in runs.items():
            fwd = lambda: unet.apply(pipe.unet_params, x, 981.0, context,
                                     pipe.unet_config, attn_impl=impl)
            with kernel_env(kernels):
                reset_launches()
                outs[name] = fwd().float()
                expect_launches(f"UNet forward ({name})", read_launches(), want[name])
                times[name] = median_ms(fwd, reps=5)
    if not all(bool(torch.isfinite(o).all()) for o in outs.values()):
        raise AssertionError("UNet forward: non-finite output")
    for a, b in (("library", "plain"), ("kernels", "library")):
        rel = rel_l2(outs[a], outs[b])
        if rel > REL_L2_MAX:
            raise AssertionError(f"UNet forward {a} vs {b}: rel L2 {rel} > {REL_L2_MAX}")
        print(f"[unet] batch 4 (2 prompts x CFG) at 64x64 latents: rel L2 {a} vs "
              f"{b} {rel:.3e} (bound {REL_L2_MAX})")
    print(f"[unet] forward, median of 5: {times['kernels']:.2f} ms on all kernels "
          f"(launches per forward {UNET_LAUNCHES}), {times['library']:.2f} ms on "
          f"the library path with the attention kernel, {times['plain']:.2f} ms "
          "plain", flush=True)


def phase_vae(pipe) -> None:
    lat = draw_prompt_latents((64, 64, 4), SEED + 1, 1, 1).to("cuda", pipe.dtype)
    lat = lat / pipe.vae_config.scaling_factor
    outs, times = {}, {}
    with torch.inference_mode():
        for name in ("library", "kernels"):
            dec = lambda: vae.decode(pipe.vae_params, lat, pipe.vae_config)
            with kernel_env(name == "kernels"):
                reset_launches()
                outs[name] = dec().float()
                got = read_launches()
                want = VAE_LAUNCHES if name == "kernels" else VAE_LAUNCHES_LIBRARY
                expect_launches(f"VAE decode ({name})", got, want)
                if got["sd_attention_d512"] != 1:
                    raise AssertionError(f"VAE decode ({name}): {got}")
                times[name] = median_ms(dec, reps=3, warmup=1)
    if outs["kernels"].shape != (1, 3, 512, 512) or not bool(
            torch.isfinite(outs["kernels"]).all()):
        raise AssertionError(f"VAE decode: {tuple(outs['kernels'].shape)}")
    rel = rel_l2(outs["kernels"], outs["library"])
    if rel > REL_L2_MAX:
        raise AssertionError(f"VAE decode kernels vs library: rel L2 {rel}")
    print(f"[vae] decode batch 1 at 512x512: rel L2 kernels vs library {rel:.3e} "
          f"(bound {REL_L2_MAX}); {times['kernels']:.2f} ms on all kernels "
          f"(launches {VAE_LAUNCHES}, sd_attention at d=512), "
          f"{times['library']:.2f} ms on the library path with sd_attention at "
          "d=512 (median of 3)", flush=True)


def phase_generate(snap: str, edit_path: str, path: str) -> dict:
    csv_path = os.path.join(WORK, "prompts.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["case_number", "prompt", "evaluation_seed"])
        w.writerows([[0, "a painting by kelly mckernan", 1],
                     [1, "a house in the style of rembrandt", 2]])
    out = os.path.join(WORK, f"images_{path}")
    calls = pndm_plan(50).num_calls
    per_call = UNET_LAUNCHES if path == "kernels" else UNET_LAUNCHES_LIBRARY
    per_decode = VAE_LAUNCHES if path == "kernels" else VAE_LAUNCHES_LIBRARY
    want = {k: 2 * (calls * per_call[k] + per_decode[k]) for k in per_call}
    with kernel_env(path == "kernels"):
        reset_launches()
        start = time.perf_counter()
        rc = cli_main(["generate", "--model_id", snap, "--prompts_path", csv_path,
                       "--save_path", out, "--uce_model_path", edit_path,
                       "--device", "cuda"])
        launches = read_launches()
        seconds = time.perf_counter() - start
    if rc != 0:
        raise AssertionError(f"generate ({path}): rc {rc}")
    expect_launches(f"generate ({path}), 2 rows x ({calls} UNet calls + 1 decode)",
                    launches, want)
    for case in (0, 1):
        with open(os.path.join(out, "erase_art", f"{case}_0.png"), "rb") as f:
            img = decode_png(f.read())
        if img.shape != (512, 512, 3) or img.dtype != np.uint8 or img.std() == 0:
            raise AssertionError(f"generate ({path}): image {case} is {img.shape} "
                                 f"{img.dtype}, std {img.std()}")
    print(f"[generate] {path} path: 2 PNGs 512x512x3 uint8 in {seconds:.2f} s "
          f"(CLI wall, load included); launches {launches} = 2 rows x "
          f"({calls} UNet calls x {per_call} + {per_decode})", flush=True)
    return launches


def phase_throughput(pipe, path: str) -> float:
    prompts = ["a painting by kelly mckernan", "a house in the style of rembrandt"]
    with kernel_env(path == "kernels"):
        torch.cuda.synchronize()
        start = time.perf_counter()
        imgs = pipe(prompts, num_inference_steps=50, guidance_scale=7.5, seed=[1, 2])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    if imgs.shape != (2, 512, 512, 3):
        raise AssertionError(f"pipeline returned {imgs.shape}")
    rate = 2 / seconds
    print(f"[generate] {path} path, 2 prompts in one batch (UNet batch 4), 50 PNDM "
          f"steps: {seconds:.3f} s, {rate:.4f} img/s", flush=True)
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

    src = "uce_tpu_torch/csrc/"
    rows = {k: {"name": k, "route": "cuda", "source": src + f, "replaces": r,
                "launches": 0, "max_abs_err": 0.0}
            for k, f, r in (
                ("sd_attention", "sd_attention.cu", "uce_tpu/ops/pallas/sd_attention.py:86"),
                ("sd_attention_d512", "sd_attention.cu", "uce_tpu/ops/attention.py:96"),
                ("group_norm_act", "group_norm.cu", "uce_tpu/ops/pallas/group_norm.py:112"),
                ("conv3x3", "conv3x3.cu", "uce_tpu/ops/pallas/conv3x3.py:91"),
                ("uce_solve", "uce_solve.cu", "uce_tpu/ops/pallas/uce_solve.py:151"))}
    phase_build()
    phase_kernels(rows)

    shutil.rmtree(WORK, ignore_errors=True)
    snap = os.path.join(WORK, "sd14_random")
    try:
        start = time.perf_counter()
        write_snapshot(snap)
        print(f"[snapshot] SD 1.4 random weights written in "
              f"{time.perf_counter() - start:.1f} s", flush=True)
        edit_path, rows["uce_solve"]["launches"] = phase_edit(snap)
        pipe = SDPipeline.from_pretrained(snap, dtype=torch.bfloat16, device="cuda")
        phase_unet(pipe)
        phase_vae(pipe)
        phase_generate(snap, edit_path, "library")
        launches = phase_generate(snap, edit_path, "kernels")
        for k in ("conv3x3", "group_norm_act", "sd_attention_d512"):
            rows[k]["launches"] = launches[k]
        rows["sd_attention"]["launches"] = (launches["sd_attention"]
                                            - launches["sd_attention_d512"])
        for path in ("library", "kernels"):
            phase_throughput(pipe, path)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    missing = [r for r in rows.values() if "ms" not in r or r["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels not timed or not launched: {missing}")
    print(f"[card] {name}")
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
