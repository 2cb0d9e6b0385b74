#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card at the full
widths of SD 1.4, SD 2.1 (768-v), SDXL base 1.0, FLUX.1-schnell and
HiDream-I1-Full, the comparison baselines and the eval metrics, and check
them.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is non-zero unless all pass;
each phase's seconds and the total are printed):
  1. the card: CUDA must be available; print its name and power limit;
  2. the kernels: build the seven libraries from csrc/ (one nvcc each, all at
     once; ptxas's registers and spills of the TMA + wgmma attention and
     conv kernels; the bf16 attention at d=64 must not spill), compare each
     kernel with its plain PyTorch version at the main paths' shapes (SD
     1.4's, and SD 2.1's, SDXL's, FLUX's and HiDream's: d=64 attention, d=512
     at s=9216 and 16384, FLUX's joint attention at d=128 (s=4352 and 1280)
     and HiDream's at CFG batch 2 (s=4480), the
     96x96, 128x128 and 1024x1024 conv and GroupNorm maps, FLUX's VAE
     conv_in (Cin = 16, mma.sync),
     uce_solve at d=1024; the baselines' UNet batches 3, 5 and 10 and the
     d=512 decode at batch 2) and on the Pallas tests' cases (elementwise and
     relative L2 bounds; the conv's split-K path at the shapes that split;
     FLUX's q/k RMSNorm + RoPE kernel, which has no Pallas counterpart, bit
     for bit: it sums the squares in the order of PyTorch's CUDA mean),
     and time the kernel, the plain version and one
     library call for the same function (CUDA events; the int8-QK^T
     attention has no such call, so the bf16 kernel and SDPA are timed
     beside it as yardsticks), with each bound: tensor cores or bytes, and
     for the attention also the exp unit; the conv at one shape per UNet
     level at batch 8 with its TFLOP/s and K splits; every kernel at its
     main-path shapes also back to back, beside its library call (the
     int8-QK^T attention beside its yardsticks, also at d=64 at SD 2.1's and
     SDXL's self-attention shapes); ptxas must report no spills and no
     serialized wgmma for the int8-QK^T kernel at any head dim and for the
     bf16 one at d=64 and d=128;
  3. SD 1.4: a seeded random-weight snapshot (UNet, CLIP text, VAE, PNDM
     scheduler, a character-vocabulary tokenizer), drawn on the card and
     written in fp16 under build/;
  4. ``edit-sd`` through the CLI with ``--method collapsed``, ``pallas`` (the
     uce_solve kernel) and ``general``: 32 finite cross-attention K/V targets
     each, held to a float64 solve of the same embeddings within a bound set
     from cond(mat2), and general and pallas to collapsed;
  5. full-width UNet forwards at batch 4: the attention kernel against its
     plain version (``kernels.route`` switching sd_attention off), and on
     the kernel path (all kernels, the default) against the library path
     (conv3x3 and group_norm_act switched off), with the launches per
     forward (the conv's by kernel: wgmma, mma.sync, split-K sums);
  6. one VAE decode at 512x512 on both paths, with its launches;
  7. ``generate`` through the CLI at 512px, PNDM, 50 steps, CFG 7.5, with the
     edit overlay, on the library path and on the kernel path: PNG checks and
     every kernel's launch count;
     in 5-7 (and 12-14) the first conv call at each (shape, Cout) and the
     first group_norm_act call at each (shape, groups, eps, act) are also
     held to the plain version on the path's own inputs (and GroupNorm to a
     second call, bit for bit);
  8. W8A8 (``--quantize int8``): one quantized UNet forward at batch 8 (each
     int8-QK^T kernel call held to its plain version on the forward's own
     inputs; the whole forward, with a gross bound, against itself on the
     plain version and against bf16) and one quantized VAE decode, with
     launches;
  9. ``serve --quantize int8`` with the edit overlay through the CLI: a
     Poisson load through the batch ladder 1,2,4 at 20 steps (JSON report,
     launches), then the socket server in a subprocess at 10 steps (three
     concurrent requests, stats, shutdown; PNG checks);
 10. img/s on the library path, the kernel path and the int8 pipeline;
 11. SD 2.1 and then SDXL, each: a seeded random-weight snapshot at full
     width (SDXL with both text encoders, its tokenizer_2 padding with "!");
 12. ``edit-sd`` (SD 2.1, d=1024: pallas launches uce_solve once) and
     ``edit-sdxl`` (d=2048: pallas takes the collapsed solve with uce_tpu's
     warning, no launch), each method held to a float64 solve;
 13. a UNet forward at UNet batch 2 (one prompt under CFG; SDXL with its
     text_time conditioning) on the three paths, and a VAE decode at 768^2
     or 1024^2 on both, with launches; both again with the UNet and VAE
     quantized, int8 (W8A8: the d=64 self-attentions on the int8-QK^T
     kernel, each call held to its plain version) and w8, held to bf16;
 14. ``generate`` at 768^2 (DDIM, v-prediction) or 1024^2 (Euler), 50 steps,
     CFG 7.5, with the edit overlay, on both paths (and on SD 2.1 a short
     ``--scheduler lms`` run on the kernel path): PNGs and launches; SDXL
     ``serve --quantize int8`` (8 steps, ladder 1,2, 3 requests) and SDXL
     ``debias-sd`` at 1024^2 with 17's CLIP (1 concept, 2 images, 8 Euler
     steps, 1 iteration) with the re-solve on the card and on the host: the
     same saved tensors bit for bit;
 15. fast mode (CFG window + DeepCache): SD 1.4 ``generate --fast`` on both
     paths, on the kernel path a no-op spec and a CFG window over every call
     (cache 1) equal to the exact images bit for bit, bench.py's
     ``cfg_interval=3:25,cache=2``
     with finite decodes, its distance from the exact images, and launches
     from the segments (full and shallow forwards); img/s fast against exact
     on the kernel path; SDXL at 1024^2 with ``cfg_interval=1:40,cache=2``
     (the cond-only calls slice SDXL's added conditioning);
 16. ``serve --quantize int8 --fast`` with the edit overlay, as in 9;
 17. ``debias-sd`` on SD 1.4 at 512^2 with CLIP ViT-B/32 at its published
     widths (random weights), 2 edit and 2 debias concepts, 4 images each, 20
     steps, on the kernel path: 2 iterations with the re-solve on the card,
     1 with it on the host (the same first measurement, and its solver's
     tensors at that acc bit for bit), then ``--mesh data=2`` (two ranks; each
     rank's K/V tensors after the loop its shards of the saved weights, bit
     for bit); every run's saved tensors equal to a host re-solve at its own
     final acc bit for bit (diffusers keys), a telemetry row per iteration and
     concept, launches (every rank's), and each iteration's seconds of
     re-solve, K/V send, generation and classification, data=1 beside data=2;
 18. ``eval-clip-classify`` over the PNGs of 7: one row per case, ratios
     summing to 1;
 18b. the comparison baselines on SD 1.4 (unedited) through their CLIs, on
     the library and the kernel path: ``sld-generate --sld_type Medium`` (50
     PNDM steps, UNet batch 3), ``concept-algebra`` (100 LMS steps) at
     ``--num_samples 1`` (batch 5) and 2 (batch 10), ``debias-vl`` with the
     80 default professions (100 LMS steps): folders and PNG names, launches
     from the plan's calls, the first call of each kernel at each new shape
     held to its plain version on the run's own inputs, seconds per image;
     one captured ``sld_combine`` and ``concept_algebra_combine`` call held
     to a float64 evaluation with uce_tpu's bf16 roundings; the two paths'
     images against each other; then, on both paths, ``mode="debias_vl"``
     with P = I equal to ``mode="cfg"`` (LMS) bit for bit, and SLD with its
     warmup past the last call equal bit for bit to CFG over the same UNet
     batch of 3 and within the paths bound of cfg at batch 2;
 18c. ``eval-lpips`` (AlexNet + the LPIPS lins), ``eval-styleloss`` (VGG19
     at 512^2), ``eval-imageclassify`` (ResNet-50 at 224^2) and
     ``eval-clip-score`` (the CLIP of 17) over those folders, with seeded
     random weights at the published widths written as .pth files in the
     lpips/torchvision layouts: each on the card held to the port's own CPU
     run of the same command (every number within 1e-4 relative), the CSVs'
     columns as uce_tpu writes them, LPIPS of a folder against itself
     exactly 0, and no kernel launched;
 18d. ``eval-nudenet`` (NudeNet's YOLOv8-n at 320: seeded weights rescaled
     to unit-variance activations on the folders' canvases, LSUV, with the
     class head's bias set so a few anchors pass the 0.2 gate, in the
     converter's safetensors format) over the four baseline folders at
     batch 16, ``eval-dreamsim`` (three ViT-B/16 at 224, the converter's
     format) original against edited, each on the card, on the CPU and in
     a new process (torch's default TF32): the NudeNet CSVs equal cell for
     cell, the raw detector output and the DreamSim CSV within 1e-4, a
     folder against itself within 1e-6, seconds per image; the drawn
     YOLOv8-n weights as they are, printed beside; ``eval-compare`` (a
     grid per complete case, each panel its source) and ``info`` in a new
     process (rc 0, the card, seven libraries built); the six new processes
     run at once, beside the in-process work; no kernel launched;
 19. FLUX.1-schnell at full width and depth (the 19 + 38-block DiT, T5-XXL,
     CLIP-L, the 16-channel VAE): a seeded random-weight bf16 snapshot drawn
     on the card (~33.8 GB, its bytes and seconds printed; the host's free
     memory is checked first; T5's tokenizer a tokenizer.json in T5
     v1.1-XXL's layout at its published 32,000 + 100 ids, its pieces and
     scores drawn from SEED, whose reader's load and batch times are
     printed), ``edit-flux`` (the two text-entry
     targets, each held to a float64 solve; ``--method pallas`` refused),
     one DiT forward at 1024^2 on the attention kernel against the plain
     attention (sd_attention switched off; 57 d=128
     kernel launches, device and wall ms), a VAE decode on both paths,
     ``generate-flux`` (4 steps, guidance 0) on both paths with the edit
     overlay (PNGs, launches from the steps, seconds per image after the
     load, the two paths' image distance), then FLUX.1-dev's on schnell's
     weights with a drawn guidance embedder (guidance 3.5, 512 T5 tokens,
     dynamic shifting, 4 of its 50 steps; the first d=128 call at its
     shape held to the plain version) on both paths; the DiT quantized w8
     and int8 on the card (sampled payloads and scales bit for bit against
     the CPU's quantization, bytes against its shapes' reckoning, a forward
     held to its float emulation and to bf16), ``generate-flux --staged``
     (the whole load's image), ``--quantize w8`` and ``--quantize int8`` on
     the kernel path, and ``serve --family flux`` and ``serve --family flux
     --quantize w8`` (ladder 1,2, 4 Poisson requests each: the JSON report,
     the served images and launches). The snapshot is deleted at the end;
 20. HiDream-I1-Full at full width and depth (the 16 + 32-block MoE DiT,
     Llama-3.1-8B, T5-XXL, CLIP-L and bigG, the 16-channel VAE): a seeded
     random-weight bf16 snapshot drawn on the card (~60.5 GB; T5's and
     Llama-3.1's tokenizers tokenizer.json files at their published sizes,
     Llama's 128,000 tokens by drawn merges and its 256 special tokens),
     ``edit-hidream``
     (49 caption projections, each held to a float64 solve of its own
     stream; ``--method pallas`` refused), the pipeline loaded staged
     (encode, ``free_encoders`` with the HBM before and after, then the
     DiT): one DiT forward at CFG batch 2 and 1024^2 on the attention
     kernel against the plain attention on the same expert routing (48 d=128 launches, each held to
     the plain version), a CFG window over every call equal to the exact
     run bit for bit and a 1:2 window finite and different, an int8 DiT
     forward on the bf16 forward's expert routing held to its float
     emulation and to bf16; then ``generate-hidream --staged`` (2 steps, CFG
     5.0) on both paths with the edit overlay: PNGs, launches from the
     steps, the seconds of the load, encode, DiT load and image;
     ``generate-hidream --staged --quantize w8``; ``serve --family hidream
     --quantize w8`` loaded whole (the card's allocated bytes after the
     load within 2% of its tensors', the w8 DiT's as its shapes reckon; 2
     requests at 2 steps). FLUX's snapshot and HiDream's DiT
     keep their weight files in host memory (``write_weights``): the card's
     machine allows a run 45 GiB of disk writes, less than the two snapshots.
The mesh (``parallel/``; its plan printed after the build: the GPU count,
the backend and the device list; two or more cards give one rank each over
NCCL, one card two ranks sharing it over gloo, a correctness run, not a
scaling number), inside 3, 19 and 20: SD 1.4's generate of 8 images at 50
steps at data=2 against one device (mean |diff| bound, max printed, img/s
of both), a UNet forward at UNet batch 16 at model=2 in bf16 and W8A8
against one rank, ``serve --mesh data=2`` (8 steps, 4 requests),
``debias-sd --mesh data=2`` (17); FLUX's and HiDream's DiTs at full width,
depth cut to 2 + 4 and 2 + 2 blocks, at model=2 against one rank (wall ms
of both), and ``generate-flux`` / ``generate-hidream --staged --mesh
model=2`` on those cut snapshots (the full snapshots' encoders) writing one
image each; every mesh run's launches checked per rank and summed into the
kernels' record. For the script's time (1200 s allowed) steps were cut
(PERF.md section 4): the in-process ``serve`` runs to 20 steps and 4
requests, concept algebra's and debias-VL's LMS steps to 25; the library
path's fast img/s is not read.
The last two lines are the kernels' JSON record (launches summed over the
main paths' runs on every rank) and the device record.
"""

from __future__ import annotations

import base64
import collections
import contextlib
import copy
import csv
import dataclasses
import functools
import gc
import io
import json
import logging
import math
import os
import re
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
from uce_tpu_torch.diffusion.pipeline_flux import FluxPipeline, make_img_ids, pack_latents
from uce_tpu_torch.diffusion import guidance, pipeline, pipeline_flux, pipeline_hidream
from uce_tpu_torch.diffusion import sampler
from uce_tpu_torch.diffusion.pipeline_hidream import HiDreamPipeline, cfg_embeddings
from uce_tpu_torch.diffusion.sampler import FastConfig
from uce_tpu_torch.diffusion.schedulers import plan_from_hf, plan_from_hf_as, pndm_plan
from uce_tpu_torch.edit import debias as debias_mod, flux as edit_flux, hidream as edit_hd
from uce_tpu_torch.edit import sd as edit_sd
from uce_tpu_torch.eval import dreamsim as dreamsim_mod, lpips as lpips_mod
from uce_tpu_torch.eval import nudenet as nudenet_mod
from uce_tpu_torch.models import clip as clip_mod, clip_text, flux, hidream, llama, quantize
from uce_tpu_torch.models import t5, unet, vae, vision_backbones, yolo
from uce_tpu_torch.models.clip_tokenizer import bytes_to_unicode
from uce_tpu_torch.models.hf_tokenizer import HFTokenizer
from uce_tpu_torch.models.hf_loader import load_state_dict, read_safetensors, save_safetensors
from uce_tpu_torch.models.sd_targets import is_hidream_caption_projection, is_sd_cross_attn_kv
from uce_tpu_torch.ops import attention, kernels, quant
from uce_tpu_torch.ops.kernels import _build, conv3x3 as convk, group_norm as gnk
from uce_tpu_torch.ops.kernels import qk_norm_rope as qknk
from uce_tpu_torch.ops.kernels import sd_attention as sdk, uce_solve as solvek
from uce_tpu_torch.parallel import mesh as mesh_mod, workers
from uce_tpu_torch.serving import socket_api
from uce_tpu_torch.utils.imaging import decode_png, encode_png, load_image
from uce_tpu_torch.utils.prompts import resolve_edit_request
from uce_tpu_torch.utils.torch_rng import DeviceNormalRng, draw_prompt_latents

ROOT = os.path.dirname(os.path.abspath(__file__))
CUDA = torch.device("cuda")
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
# GroupNorm, the conv and the d=512 attention's split merge do their plain
# versions' fp32 arithmetic in another order and differ only where a bf16
# rounding flips (measured at most 2.2e-5, 3.2e-4 and 2.0e-5).
ATOL, RTOL = 0.02, 0.05
KERNEL_REL_L2 = {"sd_attention": 1e-2, "sd_attention_qk8": 1e-2,
                 "group_norm_act": 1e-3, "conv3x3": 2e-3, "d512_merge": 1e-3}
# uce_solve: max |X_kernel - X_plain| / max |X_plain| (both fp32).
SOLVE_REL_MAX = 1e-3
# edit-sd / edit-sdxl, each method held to a float64 solve of the same fp32
# embeddings, two ways. Forward: max abs diff / max abs over the targets. An
# fp32 solve is accurate to about cond(mat2) * eps32 relative, so the bound
# is EDIT_COND_FACTOR times that; it tells a wrong solve from round-off
# only while it stays small (SD 1.4's 4.4e-3 at cond 9.2e3), not at SDXL's
# cond of ~3e5, where the forming of the Gram matrices in fp32 alone moves
# the edit by cond * eps32 ~ 4e-2. Backward: the float64 residual of the
# edited weights in the normal equations, ||W_new mat2 - W mat_a||_F /
# (||W_new||_F ||mat2||_F + ||W||_F ||mat_a||_F), held under sqrt(d) * eps32
# (the probabilistic bound of a length-d fp32 product; a wrong solve leaves
# O(1)). Neither sees an error along mat2's small singular directions below
# cond * eps32, so the methods are also held to one another: general to
# collapsed within GENERAL_VS_COLLAPSED_FACTOR * cond * eps32 (read at
# 0.77-1.26 x cond * eps32 on SD 1.4, SD 2.1 and SDXL), pallas to collapsed
# within the bar of tests/test_pallas_solve.py, and bit for bit where it
# takes the collapsed solve (d > MAX_PALLAS_DIM).
EPS32 = float(torch.finfo(torch.float32).eps)
EDIT_COND_FACTOR = 4.0
GENERAL_VS_COLLAPSED_FACTOR = 2.0
PALLAS_VS_COLLAPSED_MAX = 5e-3
# Full-width bf16 forwards, one path against another: relative L2 bound.
REL_L2_MAX = 5e-2
# Per forward at SD 1.4 (UNet) and per decode (VAE): kernel launches on the
# kernel path (the bf16 models' own route), attention on "auto". The
# latent-input conv (Cin = 4) takes the mma.sync conv kernel, every other
# 3x3 conv the wgmma one; the split-K sums are counted from the convs'
# shapes (conv_split_sums). The library path launches only the
# attention kernel (library_launches).
UNET_LAUNCHES = {"conv3x3": 49, "conv3x3_wgmma": 48, "conv3x3_mma": 1,
                 "group_norm_act": 61, "sd_attention": 10}
VAE_LAUNCHES = {"conv3x3": 33, "conv3x3_wgmma": 32, "conv3x3_mma": 1,
                "group_norm_act": 30, "sd_attention": 1}
VAE_LAUNCHES_LIBRARY = {"conv3x3": 0, "conv3x3_reduce": 0, "group_norm_act": 0,
                        "sd_attention": 1}
# A W8A8 UNet forward sends its ten long self-attentions to the int8-QK^T
# kernel and none to the bf16 one; a quantized VAE decode keeps its one
# d=512 bf16 launch.
UNET_LAUNCHES_INT8 = {"sd_attention_qk8": 10, "sd_attention": 0}
VAE_LAUNCHES_INT8 = {"sd_attention_qk8": 0, "sd_attention": 1, "sd_attention_d512": 1}
# A shallow (DeepCache, cache level 1) UNet forward runs the full-resolution
# level only: conv_in, down block 0, up block 3 (SDXL: 2), conv_out
# (counted on meta tensors in tests/test_torch_fast_mode.py); SDXL's first
# level has no attention. A W8A8 shallow forward sends its 5 to int8-QK^T.
UNET_SHALLOW_LAUNCHES = {"conv3x3": 12, "conv3x3_wgmma": 11, "conv3x3_mma": 1,
                         "group_norm_act": 16, "sd_attention": 5}
SDXL_SHALLOW_LAUNCHES = {"conv3x3": 12, "conv3x3_wgmma": 11, "conv3x3_mma": 1,
                         "group_norm_act": 11, "sd_attention": 0}
UNET_SHALLOW_LAUNCHES_INT8 = {"sd_attention_qk8": 5, "sd_attention": 0}
# Fast mode: bench.py's DEFAULT_FAST_SPEC at SD 1.4's 50 PNDM steps (51
# scheduler calls) and SDXL's at 40 of its 50 Euler calls.
FAST_SPEC = "cfg_interval=3:25,cache=2"
SDXL_FAST_SPEC = "cfg_interval=1:40,cache=2"
# Whole W8A8 networks, against bf16 or against the same network on the qk8
# plain version: a gross-fault bound only. Int8 activations and weights move
# a random-weight UNet by several percent, and a one-count change of an int8
# activation re-rounds every layer after it (kernel against plain version
# in one forward: 9.8e-2 measured on an H100, with each of its ten calls
# within 7.7e-4 of the plain version on the same inputs).
INT8_VS_BF16_REL_L2 = 0.25
# NVIDIA H100 SXM data-sheet peaks (dense): bf16, int8 and TF32 tensor
# cores, fp32 CUDA cores, HBM3.
PEAK_BF16, PEAK_INT8, PEAK_FP32, PEAK_BYTES = 989e12, 1979e12, 67e12, 3.35e12
PEAK_TF32 = 495e12
# The exp unit (MUFU): 16 exp2 results per clock per SM, at the card's
# maximum SM clock (nvidia-smi clocks.max.sm).
EXP_PER_CLOCK_PER_SM = 16

# Attention: SD 1.4's two long self-attentions at batch 16 (8 prompts under
# CFG) and 8 (4 prompts, the top serving rung), its VAE mid-block at batch 1
# (generate) and 4 (the serving rung); then SDXL's (1024², latents 128²) and
# SD 2.1's (768², latents 96²) UNet self-attentions at UNet batch 2, d=64,
# and their VAE mid-blocks at s=16384 and 9216; then FLUX.1-schnell's joint
# attention at d=128 over 256 T5 tokens + the packed image at 1024^2 and
# 512^2 (batch 1, 24 heads), FLUX.1-dev's over 512 T5 tokens at 1024^2; last
# HiDream-I1's at 1024^2 under CFG (batch 2, 20 heads, 4096 image + 128 T5 +
# 2 x 128 Llama tokens).
ATTN_SLICE = [(16, 8, 4096, 4096, 40), (16, 8, 1024, 1024, 80),
              (8, 8, 4096, 4096, 40), (8, 8, 1024, 1024, 80),
              (1, 1, 4096, 4096, 512), (4, 1, 4096, 4096, 512),
              (2, 10, 4096, 4096, 64), (2, 20, 1024, 1024, 64),
              (2, 5, 9216, 9216, 64), (2, 10, 2304, 2304, 64),
              (1, 1, 16384, 16384, 512), (1, 1, 9216, 9216, 512),
              (1, 24, 4352, 4352, 128), (1, 24, 1280, 1280, 128),
              (1, 24, 4608, 4608, 128), (2, 20, 4480, 4480, 128),
              # the mesh's model=2 shards: SD 1.4's heads at batch 8 under
              # CFG, FLUX's and HiDream's joint attentions
              (16, 4, 4096, 4096, 40), (16, 4, 1024, 1024, 80),
              (1, 12, 4352, 4352, 128), (2, 10, 4480, 4480, 128)] + [
    # the baselines' UNet batches: SLD's 3, concept algebra's 5 and 10;
    # concept algebra's decode of 2 images
    (b, 8, s, s, d) for b in (3, 5, 10) for s, d in ((4096, 40), (1024, 80))] + [
    (2, 1, 4096, 4096, 512)]
ATTN_CASES = [(2, 2, 256, 256, 40), (1, 4, 512, 512, 80), (2, 2, 64, 64, 160),
              (2, 2, 256, 77, 40), (1, 2, 512, 77, 160), (2, 1, 200, 200, 512),
              (2, 2, 200, 200, 64)]
# (shape NHWC, groups, eps, act); the last case and the mesh's first slice
# row are the UNet's 64x64 level at batch 8, which plan streams.
GN_SLICE = [((4, 64, 64, 320), 32, 1e-5, "silu"), ((1, 512, 512, 128), 32, 1e-6, "silu"),
            ((2, 128, 128, 320), 32, 1e-5, "silu"), ((1, 1024, 1024, 128), 32, 1e-6, "silu")
            ] + [((b, 64, 64, 320), 32, 1e-5, "silu") for b in (3, 5, 10)] + [
    # the mesh's data=2 slices of 8 images: UNet batch 8, a decode of 4
    ((8, 64, 64, 320), 32, 1e-5, "silu"), ((4, 512, 512, 128), 32, 1e-6, "silu")]
GN_CASES = [((4, 32, 32, 1920), 32, 1e-5, "silu"), ((4, 8, 8, 2560), 32, 1e-5, "silu"),
            ((4, 64, 64, 320), 32, 1e-6, "none"), ((1, 512, 512, 256), 32, 1e-6, "silu"),
            ((2, 8, 8, 64), 8, 1e-5, "none"), ((3, 4, 4, 320), 32, 1e-5, "silu"),
            ((1, 16, 16, 128), 32, 1e-5, "none"), ((1, 24, 24, 64), 8, 1e-5, "none"),
            ((8, 64, 64, 960), 32, 1e-5, "silu")]
# (shape NHWC, cout): the UNet's 64x64 level at batch 4, one shape per UNet
# level at batch 8 (the 8x8 one splits K), the VAE's 512x512 level; then
# SDXL's 128x128 UNet level, SD 2.1's 96x96 and 12x12 ones at UNet batch 2,
# the VAE's 1024x1024 level (SDXL), and FLUX's VAE conv_in at 1024^2 (Cin =
# 16 -> 512 at 128x128, on the mma.sync kernel).
CONV_SLICE = [((4, 64, 64, 320), 320), ((8, 64, 64, 320), 320),
              ((8, 32, 32, 640), 640), ((8, 16, 16, 1280), 1280),
              ((8, 8, 8, 2560), 1280), ((1, 512, 512, 128), 128),
              ((2, 128, 128, 320), 320), ((2, 96, 96, 320), 320),
              ((2, 12, 12, 1280), 1280), ((1, 1024, 1024, 128), 128),
              ((1, 128, 128, 16), 512)] + [
    ((b, 64, 64, 320), 320) for b in (3, 5, 10)] + [((5, 8, 8, 2560), 1280)] + [  # baselines
    ((4, 512, 512, 128), 128)]  # the mesh's decode of a data slice of 4 images
CONV_CASES = [((4, 64, 64, 4), 320), ((4, 64, 64, 320), 4), ((4, 32, 32, 1920), 640),
              ((4, 8, 8, 2560), 1280), ((1, 64, 64, 4), 512), ((1, 128, 128, 512), 512),
              ((1, 512, 512, 128), 3), ((2, 8, 8, 12), 20), ((1, 6, 6, 4), 20),
              ((4, 16, 16, 1280), 1280), ((2, 8, 8, 64), 96)]
# (edit concepts, preserve concepts, d): the main path's art erase, then the
# Pallas tests' cases and a 100-concept list.
SOLVE_SLICE = [(5, 3, 768), (5, 3, 1024)]
SOLVE_CASES = [(4, 3, 256), (16, 0, 256), (100, 0, 768)]
# int8-QK^T attention: the top serving rung (4 prompts under CFG) at 512²,
# then SDXL's (1024², latents 128²) and SD 2.1's (768², latents 96²) UNet
# self-attentions at d=64 and UNet batch 2 (their W8A8 paths); then
# tests/test_sd_attention.py::test_int8_qk_close_to_fp's cases, a ragged Skv
# and one q tile, then the serving ladder's lower rungs (UNet batch 2 and 4).
QK8_SLICE = [(8, 8, 4096, 4096, 40), (8, 8, 1024, 1024, 80),
             (2, 10, 4096, 4096, 64), (2, 20, 1024, 1024, 64),
             (2, 5, 9216, 9216, 64), (2, 10, 2304, 2304, 64),
             # W8A8 at the mesh's model=2: SD 1.4's heads at batch 8 under CFG
             (16, 4, 4096, 4096, 40), (16, 4, 1024, 1024, 80)]
QK8_CASES = [(2, 2, 256, 256, 40), (1, 4, 512, 512, 80), (2, 2, 200, 200, 40),
             (1, 2, 64, 64, 80), (2, 8, 4096, 4096, 40), (2, 8, 1024, 1024, 80),
             (4, 8, 4096, 4096, 40), (4, 8, 1024, 1024, 80)]

# FLUX's q/k RMSNorm + RoPE, (B, H, T5 tokens, image tokens, one segment):
# a double-stream block of FLUX.1-schnell at 1024^2 and batch 2 (the
# benchmark's cell) and of FLUX.1-dev (512 T5 tokens), a single-stream
# block (the joined sequence as one segment), the mesh's model=2 shard (12
# heads a rank), batch 1 at 512^2; then small cases.
QK_SLICE = [(2, 24, 256, 4096, False), (2, 24, 512, 4096, False),
            (2, 24, 256, 4096, True), (1, 12, 256, 4096, False),
            (1, 24, 256, 1024, False)]
QK_CASES = [(1, 2, 3, 12, False), (3, 1, 5, 16, True), (2, 3, 77, 64, False)]

# Steps of the LMS run through generate on SD 2.1 (the third new scheduler).
LMS_STEPS = 5
ART = "Kelly McKernan; Thomas Kinkade; Tyler Edlin; Kilian Eng; Ajin Demi Human"
PRESERVE = "Van Gogh; Rembrandt; Pablo Picasso"
# The kernels the library path switches off (``kernels.route``): every conv
# and GroupNorm the library call, NCHW; the attention kernel stays.
LIBRARY_OFF = ("conv3x3", "group_norm_act")
SOCKET_STEPS = 10
# serve --quantize int8 (and --fast) in process: 20 PNDM steps, 4 requests
# (cut from 50 steps and 8 requests for the script's time; the ladder's
# three rungs still each run a warm-up batch)
SERVE_STEPS, SERVE_REQUESTS = 20, 4
SERVE_FAST_SPEC = "cfg_interval=1:10,cache=2"  # FAST_SPEC's window, scaled to 21 calls
SERVE_PROMPTS = ["a painting by kelly mckernan", "a photo of a dog",
                 "a house in the style of rembrandt"]
# diffusers' scheduler_config.json of each model.
_SCHEDULER_COMMON = {"beta_start": 0.00085, "beta_end": 0.012,
                     "beta_schedule": "scaled_linear", "num_train_timesteps": 1000,
                     "set_alpha_to_one": False, "steps_offset": 1,
                     "skip_prk_steps": True, "clip_sample": False}


@dataclasses.dataclass(frozen=True)
class Model:
    """One model of the main paths at its published widths: its parts'
    configurations (``texts``: (subfolder, config, pad token) per text
    encoder), its scheduler, image size, the cross-attention K/V targets an
    edit writes, and the kernel path's launches per UNet forward."""

    name: str
    family: str          # "sd" (edit-sd) or "sdxl" (edit-sdxl)
    unet: unet.UNetConfig
    texts: tuple
    vae: vae.VAEConfig
    scheduler: dict
    size: int
    targets: int
    unet_launches: dict
    shallow_launches: dict | None = None  # per DeepCache shallow forward

    @property
    def latent(self) -> int:
        return self.size // 8

    @property
    def tag(self) -> str:
        return self.name.replace(" ", "").replace(".", "").lower()


SD14 = Model("SD 1.4", "sd", unet.SD14_UNET_CONFIG,
             (("text_encoder", clip_text.SD14_TEXT_CONFIG, "<|endoftext|>"),),
             vae.SD_VAE_CONFIG, {"_class_name": "PNDMScheduler", **_SCHEDULER_COMMON},
             512, 32, UNET_LAUNCHES, UNET_SHALLOW_LAUNCHES)
# SD 2.1 (768-v) and SDXL base 1.0: stabilityai/stable-diffusion-2-1 and
# stabilityai/stable-diffusion-xl-base-1.0 (their text configs carry the
# legacy eos_token_id 2, SDXL's tokenizer_2 pads with "!"). Per UNet forward
# (counted on meta tensors in tests/test_torch_sdxl_sd21_shapes.py): SD 2.1
# 49 convs and 61 GroupNorms, its 96x96 and 48x48 levels' 10 self-attentions
# at d=64; SDXL 38 and 46, its 64x64 and 32x32 levels' 70.
SD21 = Model("SD 2.1", "sd", unet.SD21_UNET_CONFIG,
             (("text_encoder", dataclasses.replace(clip_text.SD2_TEXT_CONFIG,
                                                   eos_token_id=2), "<|endoftext|>"),),
             vae.SD_VAE_CONFIG,
             {"_class_name": "DDIMScheduler", "prediction_type": "v_prediction",
              **_SCHEDULER_COMMON},
             768, 32, {"conv3x3": 49, "conv3x3_wgmma": 48, "conv3x3_mma": 1,
                       "group_norm_act": 61, "sd_attention": 10})
SDXL = Model("SDXL", "sdxl", unet.SDXL_UNET_CONFIG,
             (("text_encoder", dataclasses.replace(clip_text.SD14_TEXT_CONFIG,
                                                   eos_token_id=2), "<|endoftext|>"),
              ("text_encoder_2", dataclasses.replace(clip_text.SDXL_TEXT2_CONFIG,
                                                     eos_token_id=2), "!")),
             dataclasses.replace(vae.SD_VAE_CONFIG, scaling_factor=0.13025),
             {"_class_name": "EulerDiscreteScheduler", "prediction_type": "epsilon",
              "timestep_spacing": "leading", "interpolation_type": "linear",
              **_SCHEDULER_COMMON},
             1024, 140, {"conv3x3": 38, "conv3x3_wgmma": 37, "conv3x3_mma": 1,
                         "group_norm_act": 46, "sd_attention": 70},
             SDXL_SHALLOW_LAUNCHES)
# openai/clip-vit-base-patch32, the classifier of debias-sd and
# eval-clip-classify: vision 768 wide, 12 layers, patch 32 at 224^2; text
# 512 wide, 12 layers (its config's legacy eos_token_id 2); projection 512.
CLIP_VISION = clip_mod.CLIPVisionConfig()
CLIP_TEXT = clip_text.CLIPTextConfig(hidden_size=512, num_attention_heads=8,
                                     intermediate_size=2048, projection_dim=512,
                                     eos_token_id=2)
# debias-sd: desired ratios that 4 images per concept (ratios in quarters)
# can never meet within the 0.05 deadband, so the loop runs its 2 iterations
DEBIAS_ARGS = ["--edit_concepts", "doctor; nurse", "--debias_concepts",
               "a man; a woman", "--desired_ratios", "0.3", "0.7",
               "--num_images_per_prompt", "4", "--num_inference_steps", "20",
               "--max_iterations", "2"]
# SDXL at 1024^2, cut: 1 edit concept, 2 images (ratios in halves, so 0.3 /
# 0.7 is never met either), 8 Euler steps, 1 iteration
SDXL_DEBIAS_ARGS = ["--edit_concepts", "doctor", "--debias_concepts", "a man; a woman",
                    "--desired_ratios", "0.3", "0.7", "--num_images_per_prompt", "2",
                    "--num_inference_steps", "8", "--max_iterations", "1",
                    "--image_size", "1024"]

# FLUX.1-schnell (black-forest-labs/FLUX.1-schnell, its config.json files) at
# its published widths and depth: the 19 + 38-block DiT, T5 v1.1-XXL
# (text_encoder_2), CLIP-L (text_encoder; its config's legacy eos_token_id
# 2), the 16-channel VAE with its scaling and shift factors, FlowMatchEuler
# with shift 1 and no dynamic shifting; 1024^2, 4 steps, guidance 0, 256 T5
# tokens. Per DiT forward 57 joint attentions at d=128 take the kernel
# (tests/test_torch_flux_shapes.py); the decode launches as SDXL's
# (VAE_LAUNCHES), its conv_in (Cin = 16) on the mma.sync kernel.
FLUX_CLIP = dataclasses.replace(clip_text.SD14_TEXT_CONFIG, eos_token_id=2)
FLUX_VAE = vae.FLUX_VAE_CONFIG
FLUX_SCHEDULER = {"_class_name": "FlowMatchEulerDiscreteScheduler", "shift": 1.0,
                  "use_dynamic_shifting": False, "num_train_timesteps": 1000}
FLUX_STEPS = 4
FLUX_DIT_LAUNCHES = {"sd_attention_d128": 57, "qk_norm_rope": 57}
FLUX_PROMPT = "a painting by kelly mckernan"
# FLUX.1-dev (black-forest-labs/FLUX.1-dev): schnell's DiT with the guidance
# embedder (guidance_embeds), 512 T5 tokens (its joint attention at
# s = 4096 + 512), its scheduler_config.json's dynamic shifting, guidance
# 3.5 (its model card's). Cut: 4 steps of its 50; the weights are the
# schnell snapshot's with a guidance embedder drawn from SEED beside them.
FLUX_DEV = dataclasses.replace(flux.SCHNELL_CONFIG, guidance_embeds=True)
FLUX_DEV_SCHEDULER = {"_class_name": "FlowMatchEulerDiscreteScheduler", "shift": 3.0,
                      "use_dynamic_shifting": True, "base_shift": 0.5, "max_shift": 1.15,
                      "base_image_seq_len": 256, "max_image_seq_len": 4096,
                      "num_train_timesteps": 1000}
FLUX_DEV_STEPS = 4
FLUX_DEV_GUIDANCE = 3.5
FLUX_DEV_TOKENS = 512

# HiDream-I1-Full at its published widths and depth (HiDream-ai/HiDream-I1-Full's
# transformer/config.json, hidream.I1_FULL_CONFIG: 16 + 32 MoE blocks of 20 x
# 128, 4 routed experts with 2 active; meta-llama/Meta-Llama-3.1-8B-Instruct's
# config.json as text_encoder_4; T5 v1.1-XXL as text_encoder_3; CLIP-L with a
# 768 projection and OpenCLIP bigG with its 1280 projection, both with the
# legacy eos_token_id 2; FLUX's 16-channel VAE), FlowMatchEuler with shift 3
# (the repository's snapshots and uce_tpu's fallback); 1024^2, CFG 5.0, 128
# T5 and Llama tokens, 2 steps. Per DiT forward at CFG batch 2, 48 joint
# attentions at (2, 20, 4480, 4480, 128) take the kernel
# (tests/test_torch_hidream_shapes.py); the decode launches as FLUX's.
HIDREAM_CLIP_L = dataclasses.replace(clip_text.SD14_TEXT_CONFIG, projection_dim=768,
                                     eos_token_id=2)
HIDREAM_CLIP_G = dataclasses.replace(clip_text.SDXL_TEXT2_CONFIG, eos_token_id=2)
HIDREAM_SCHEDULER = {"_class_name": "FlowMatchEulerDiscreteScheduler", "shift": 3.0,
                     "use_dynamic_shifting": False, "num_train_timesteps": 1000}
HIDREAM_STEPS = 2
HIDREAM_GUIDANCE = 5.0
HIDREAM_DIT_LAUNCHES = {"sd_attention_d128": 48, "qk_norm_rope": 0}


def library_launches(per_call: dict) -> dict:
    """The library path's launches for a kernel path's: the attention only."""
    return {"conv3x3": 0, "conv3x3_reduce": 0, "group_norm_act": 0,
            "sd_attention": per_call["sd_attention"]}


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


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


def loop_ms(fn, calls: int = 10, reps: int = 5) -> float:
    """Per-call time of ``calls`` back-to-back calls between one pair of
    events, median of ``reps`` such runs: once the host runs ahead of the
    card, the device's time without the host time that a single call
    between two events (``median_ms``) includes."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def path_route(path: str):
    """The enclosed calls on ``path``: "kernels" (every kernel) or
    "library" (``LIBRARY_OFF`` switched off)."""
    return kernels.route(() if path == "kernels" else LIBRARY_OFF)


@contextlib.contextmanager
def conv_shapes(seen: collections.Counter, row: dict):
    """Count (x shape, Cout) of every conv3x3 wrapper call in the enclosed
    calls, and hold the first call at each to the plain version on the
    call's own inputs (raises outside the conv's bounds; the worst error
    goes into ``row``); the kernel's output goes on."""
    launch = convk.conv3x3

    def spy(x, w, bias=None):
        key = (tuple(x.shape), w.shape[0])
        got = launch(x, w, bias)
        if key not in seen:
            max_err = check_bf16("conv3x3", f"conv3x3 {key[0]}->{key[1]} on the "
                                 "path's own inputs", got,
                                 convk.conv3x3_reference(x, w, bias))[0]
            row["max_abs_err"] = max(row["max_abs_err"], max_err)
        seen[key] += 1
        return got

    convk.conv3x3 = spy
    try:
        yield
    finally:
        convk.conv3x3 = launch


@contextlib.contextmanager
def gn_shapes(seen: collections.Counter, row: dict):
    """Count (x shape, groups, eps, act) of every group_norm_act wrapper call
    in the enclosed calls, and hold the first call at each to the plain
    version on the call's own inputs and to a second kernel call, bit for
    bit (raises outside the bounds; the worst error goes into ``row``); the
    kernel's output goes on."""
    launch = gnk.group_norm_act

    def spy(x, scale, bias, groups=32, eps=1e-5, act="none"):
        key = (tuple(x.shape), groups, eps, act)
        got = launch(x, scale, bias, groups, eps, act)
        if key not in seen:
            what = f"group_norm_act {key} on the path's own inputs"
            max_err = check_bf16("group_norm_act", what, got,
                                 gnk.group_norm_act_reference(x, scale, bias, groups,
                                                              eps, act))[0]
            if not torch.equal(got, launch(x, scale, bias, groups, eps, act)):
                raise AssertionError(f"{what}: results differ run to run")
            # the repeat is a check, not the path's launch
            kernels.count("group_norm_act", n=-1)
            row["max_abs_err"] = max(row["max_abs_err"], max_err)
        seen[key] += 1
        return got

    gnk.group_norm_act = spy
    try:
        yield
    finally:
        gnk.group_norm_act = launch


def conv_split_sums(seen: collections.Counter) -> int:
    """The split-K sums that ``plan`` gives the counted conv calls."""
    return sum(n for (shape, cout), n in seen.items()
               if convk.plan(*shape, cout, _build.sm_count(CUDA)).splits > 1)


def bound(ops_seconds: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of the operations'
    time at the peak rates and bytes over the memory rate."""
    t_ops, t_bytes = ops_seconds * 1e3, nbytes / PEAK_BYTES * 1e3
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


def kernel_name(mangled: str) -> str:
    """The kernel's name and template argument in a mangled symbol."""
    for m in re.finditer(r"\d+", mangled):
        for k in range(len(m.group())):  # a length may follow other digits
            name = mangled[m.end():m.end() + int(m.group()[k:])]
            if name.endswith("kernel"):
                arg = re.match(r"ILi(\d+)E|ILb(\d)E", mangled[m.end() + len(name):])
                return name + (f"<{arg.group(1) or arg.group(2)}>" if arg else "")
    return mangled


def ptxas_report(log: str) -> list[str]:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its name and
    template argument, registers, spill stores and loads; and ptxas's
    warnings that it serialized wgmma instructions."""
    lines, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = kernel_name(entry.group(1))
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and name:
            stores, loads = spill.groups()
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            lines.append(f"{name}: {used.group(1)} registers, {stores} B spill stores, "
                         f"{loads} B spill loads")
            name = None
        if "serialized" in line:
            lines.append(re.sub(r"'(_Z\S+)'", lambda m: kernel_name(m.group(1)),
                                line.split("ptxas info    : ")[-1].strip()))
    return lines


def phase_build() -> None:
    """One nvcc per library, all started together."""
    start = time.perf_counter()
    kernels.build_all()
    print(f"[kernel] {len(kernels.LIBRARIES)} libraries built in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    for name in kernels.LIBRARIES:
        print(f"[kernel]   {name}: nvcc {_build.build_seconds.get(name, 0.0):.1f} s")
    for name in ("sd_attention", "sd_attention_qk8", "conv3x3", "group_norm"):
        log = _build.build_logs.get(name)
        for line in ptxas_report(log) if log else ["loaded from the build cache"]:
            print(f"[ptxas] {name}: {line}")
    # The int8-QK^T kernel at every head dim it dispatches: no spills and
    # no wgmma serialized by ptxas (C7520, C7512). The bf16 kernel at d=64,
    # the head dim of every SD 2.x and SDXL attention, and at d=128, FLUX's:
    # no spills, no serialized wgmma.
    check_ptxas("sd_attention_qk8", "sd_attention_qk8_kernel", sdk.QK8_HEAD_DIMS,
                whole_library=True)
    check_ptxas("sd_attention", "sd_attention_kernel", (64, 128), whole_library=False)
    for line in ptxas_report(_build.build_logs.get("sd_attention") or ""):
        if "<128>" in line:
            print(f"[ptxas] FLUX's and HiDream's d=128 attention: {line}")


def check_ptxas(lib: str, kernel: str, dims, whole_library: bool) -> None:
    """Raise unless ptxas's report of ``lib`` lists ``kernel`` at every head
    dim of ``dims`` with no spills and no wgmma serialized; with
    ``whole_library``, no kernel of the library may have either."""
    log = _build.build_logs.get(lib)
    if not log:
        return
    report = ptxas_report(log)
    at = lambda line: re.search(kernel + r"<(\d+)>", line)
    found = {int(m.group(1)) for m in map(at, report) if m}
    checked = report if whole_library else [
        line for line in report if at(line) and int(at(line).group(1)) in dims]
    faults = [line for line in checked if "serialized" in line
              or re.search(r"[1-9]\d* B spill (stores|loads)", line)]
    if faults or not set(dims) <= found:
        raise AssertionError(f"{lib} ptxas: head dims {sorted(found)} (want "
                             f"{sorted(dims)}), faults {faults}")


def phase_attention(gen, rows: dict) -> None:
    sms = _build.sm_count(CUDA)
    exp_rate = sms * EXP_PER_CLOCK_PER_SM * max_sm_clock_hz()  # exp2 a second
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
            bound_ms, by = bound(4.0 * b * h * sq * skv * d / PEAK_BF16,
                                 2.0 * (2 * b * h * sq * d + 2 * b * h * skv * d))
            # the softmax's exp2, one per logit, on the exp unit
            exp_ms = b * h * sq * skv / exp_rate * 1e3
            if d == 512:
                line += f" ({sdk.d512_splits(b * h, sq, skv, sms)} KV splits)"
            loop_kernel = loop_ms(lambda: sdk.sd_attention(q, k, v, scale))
            loop_lib = loop_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale))
            line += (f" back to back: kernel {loop_kernel:.4f} ms, SDPA "
                     f"{loop_lib:.4f} ms a call (median of 5 runs of 10);")
            if (b, h, sq, d) in ((16, 8, 4096, 40), (1, 1, 4096, 512)):
                row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=by)
            line += (f" kernel {ms:.4f} ms, plain version {plain_ms:.4f} ms, "
                     f"library (SDPA) {lib_ms:.4f} ms, plain attention path "
                     f"{path_ms:.4f} ms (median of 10), bound {bound_ms:.4f} ms "
                     f"({by}), exp unit {exp_ms:.4f} ms")
        print(line, flush=True)
        if (b, h, sq, skv, d) == (1, 1, 4096, 4096, 512):
            phase_merge(q, k, v, scale, rows[name])


def phase_merge(q, k, v, scale, row: dict) -> None:
    """The d=512 attention's split merge kernel against its plain version on
    the partial results that the split kernel writes for these inputs."""
    o_part, ml = sdk.sd_attention_partials(q, k, v, scale, 2)
    got = sdk.merge_partials(o_part, ml)
    torch.cuda.synchronize()
    max_err, note = check_bf16("d512_merge", "sd_attention_d512 merge", got,
                               sdk.merge_partials_reference(o_part, ml))
    row["max_abs_err"] = max(row["max_abs_err"], max_err)
    ms = median_ms(lambda: sdk.merge_partials(o_part, ml))
    plain_ms = median_ms(lambda: sdk.merge_partials_reference(o_part, ml))
    print(f"[kernel] sd_attention_d512 merge of 2 splits {tuple(q.shape)} {note} "
          f"kernel {ms:.4f} ms, plain version {plain_ms:.4f} ms (median of 10)",
          flush=True)


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
            bound_ms, by = bound(10.0 * x.numel() / PEAK_FP32,
                                 2.0 * 2 * x.numel() + 2 * 4 * c)
            if shape == GN_SLICE[0][0]:
                row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=by)
            loop_kernel = loop_ms(lambda: gnk.group_norm_act(x, scale, bias, groups,
                                                             eps, act))
            loop_lib = loop_ms(lambda: F.silu(F.group_norm(x_nchw, groups, scale16,
                                                           bias16, eps)))
            line += (f" kernel {ms:.4f} ms, plain version {plain_ms:.4f} ms, "
                     f"library {lib_ms:.4f} ms (median of 10), bound "
                     f"{bound_ms:.4f} ms ({by}); back to back: kernel "
                     f"{loop_kernel:.4f} ms, F.group_norm+F.silu {loop_lib:.4f} ms a "
                     "call (median of 5 runs of 10)")
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
        p = convk.plan(*shape, cout, _build.sm_count(CUDA))
        got = convk.conv3x3(x, w_packed, bias)
        torch.cuda.synchronize()
        what = f"conv3x3 {shape}->{cout}"
        max_err, note = check_bf16("conv3x3", what, got,
                                   convk.conv3x3_reference(x, w_packed, bias))
        row["max_abs_err"] = max(row["max_abs_err"], max_err)
        line = (f"[kernel] {what} ({p.variant}, {p.m_tiles} x {p.n_tiles} tiles of "
                f"{convk.TILE_PIXELS if p.variant == 'wgmma' else convk.MMA_TILE} x "
                f"{p.bn}, {p.splits} K splits) {note}")
        if (shape, cout) in CONV_SLICE:
            x_nchw = x.permute(0, 3, 1, 2)
            w_cl = w.contiguous(memory_format=torch.channels_last)
            ms = median_ms(lambda: convk.conv3x3(x, w_packed, bias))
            plain_ms = median_ms(lambda: convk.conv3x3_reference(x, w_packed, bias))
            lib_ms = median_ms(lambda: F.conv2d(x_nchw, w_cl, bias, padding=1))
            m = x.numel() // cin
            flops = 2.0 * m * cout * 9 * cin
            bound_ms, by = bound(flops / PEAK_BF16,
                                 2.0 * (x.numel() + w.numel() + cout + m * cout))
            if shape == CONV_SLICE[0][0]:
                row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=by)
            loop_kernel = loop_ms(lambda: convk.conv3x3(x, w_packed, bias))
            loop_lib = loop_ms(lambda: F.conv2d(x_nchw, w_cl, bias, padding=1))
            line += (f" kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
                     f"version {plain_ms:.4f} ms, library (cuDNN, channels_last) "
                     f"{lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s) (median "
                     f"of 10), bound {bound_ms:.4f} ms ({by}); back to back: kernel "
                     f"{loop_kernel:.4f} ms, cuDNN {loop_lib:.4f} ms a call (median of "
                     "5 runs of 10)")
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
            # Two floors for fp32-accurate products: the GEMMs on the fp32
            # CUDA cores, and three TF32 tensor-core products each (3xTF32,
            # the kernel's method: the lower one, so that the share of the
            # bound cannot read over 100%). The Gram build is fp32 FMA work.
            gemm_flops = solvek.NEWTON_ITERS * 2 * 2.0 * d ** 3
            gram_flops = 2.0 * d * d * (ke + kp)
            nbytes = 4.0 * (ke + kp) * d + 4.0 * d * d
            fp32_ms = bound((gemm_flops + gram_flops) / PEAK_FP32, nbytes)[0]
            bound_ms, by = bound(3 * gemm_flops / PEAK_TF32 + gram_flops / PEAK_FP32,
                                 nbytes)
            if (ke, kp, d) == SOLVE_SLICE[0]:
                row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=by)
            loop_kernel = loop_ms(lambda: solvek.newton_schulz_inverse(*args))
            loop_lib = loop_ms(lambda: torch.linalg.inv(b_mat))
            line += (f" kernel {ms:.4f} ms, plain version {plain_ms:.4f} ms, "
                     f"library (torch.linalg.inv) {lib_ms:.4f} ms (median of 10), "
                     f"bound {bound_ms:.4f} ms ({by}: 3xTF32 at 495 TFLOP/s; "
                     f"{fp32_ms:.4f} ms on the fp32 CUDA cores); back to back: "
                     f"kernel {loop_kernel:.4f} ms, torch.linalg.inv "
                     f"{loop_lib:.4f} ms a call (median of 5 runs of 10)")
        print(line, flush=True)


def phase_qk8(gen, rows: dict) -> None:
    """The int8-QK^T kernel against its plain version on the same quantized
    K (the wrapper's pre-pass runs once per input)."""
    row = rows["sd_attention_qk8"]
    exp_rate = _build.sm_count(CUDA) * EXP_PER_CLOCK_PER_SM * max_sm_clock_hz()
    for b, h, sq, skv, d in QK8_SLICE + QK8_CASES:
        q = torch.randn(b, h, sq, d, device="cuda", generator=gen).bfloat16()
        k = (torch.randn(b, h, skv, d, device="cuda", generator=gen) + 0.3).bfloat16()
        v = torch.randn(b, h, skv, d, device="cuda", generator=gen).bfloat16()
        scale = d ** -0.5
        ki, ks = sdk.quantize_k(k)
        got = sdk.sd_attention_qk8(q, ki, ks, v, scale)
        torch.cuda.synchronize()
        max_err, note = check_bf16("sd_attention_qk8",
                                   f"sd_attention_qk8 {(b, h, sq, skv, d)}", got,
                                   sdk.sd_attention_qk8_reference(q, ki, ks, v, scale))
        row["max_abs_err"] = max(row["max_abs_err"], max_err)
        line = f"[kernel] sd_attention_qk8 {(b, h, sq, skv, d)} {note}"
        if (b, h, sq, skv, d) in QK8_SLICE:
            ms = median_ms(lambda: sdk.sd_attention_qk8(q, ki, ks, v, scale))
            wrapper_ms = median_ms(lambda: sdk.sd_attention(q, k, v, scale,
                                                            qk_int8=True))
            plain_ms = median_ms(lambda: sdk.sd_attention_qk8_reference(
                q, ki, ks, v, scale), reps=3, warmup=1)
            bf16_ms = median_ms(lambda: sdk.sd_attention(q, k, v, scale))
            sdpa_ms = median_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale))
            work = 2.0 * b * h * sq * skv * d  # each of QK^T and PV
            bound_ms, by = bound(work / PEAK_INT8 + work / PEAK_BF16,
                                 2.0 * b * h * sq * d + b * h * skv * d
                                 + 4.0 * b * h * skv + 2.0 * b * h * skv * d
                                 + 2.0 * b * h * sq * d)
            if (b, h, sq, d) == (8, 8, 4096, 40):
                row.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                           bound_ms=bound_ms, bound_by=by)
            loop_kernel = loop_ms(lambda: sdk.sd_attention_qk8(q, ki, ks, v, scale))
            loop_bf16 = loop_ms(lambda: sdk.sd_attention(q, k, v, scale))
            loop_sdpa = loop_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale))
            exp_ms = b * h * sq * skv / exp_rate * 1e3
            line += (f" kernel {ms:.4f} ms (with the K pre-pass {wrapper_ms:.4f}), "
                     f"plain version {plain_ms:.4f} ms (median of 3), yardsticks: "
                     f"bf16 sd_attention kernel {bf16_ms:.4f} ms, SDPA "
                     f"{sdpa_ms:.4f} ms (median of 10); bound {bound_ms:.4f} ms "
                     f"({by}), exp unit {exp_ms:.4f} ms; back to back: kernel "
                     f"{loop_kernel:.4f} ms, bf16 kernel {loop_bf16:.4f} ms, SDPA "
                     f"{loop_sdpa:.4f} ms a call (median of 5 runs of 10)")
        print(line, flush=True)


def qk_inputs(gen, b: int, h: int, s_txt: int, s_img: int, joined: bool):
    """(segments, cos, sin) of one block: projection outputs with an offset,
    norm scales near 1, the RoPE tables of T5 ids and an image grid (square
    where s_img is a square)."""
    side = int(round(s_img ** 0.5))
    lh, lw = (side, side) if side * side == s_img else (1, s_img)
    ids = np.concatenate([np.zeros((s_txt, 3)), make_img_ids(2 * lh, 2 * lw)])
    cos, sin = flux.rope_freqs(ids, flux.SCHNELL_CONFIG.axes_dims_rope, device="cuda")
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    segments = []
    for s in ([s_txt + s_img] if joined else [s_txt, s_img]):
        src = lambda: (rnd(b, s, h * qknk.HEAD_DIM) * 2 + 0.3).bfloat16()
        scale = lambda: (1 + 0.2 * rnd(qknk.HEAD_DIM)).bfloat16()
        segments.append((src(), src(), scale(), scale()))
    return segments, cos, sin


def phase_qk_norm_rope(gen, rows: dict) -> None:
    """The kernel against its plain version and a second call, bit for bit;
    at the main paths' shapes also its time against its bound (bytes) and
    the plain version's."""
    row = rows["qk_norm_rope"]
    for b, h, s_txt, s_img, joined in QK_SLICE + QK_CASES:
        key = (b, h, s_txt, s_img, joined)
        segments, cos, sin = qk_inputs(gen, b, h, s_txt, s_img, joined)
        got = qknk.qk_norm_rope(segments, cos, sin)
        torch.cuda.synchronize()
        want = qknk.qk_norm_rope_reference(segments, cos, sin)
        again = qknk.qk_norm_rope(segments, cos, sin)
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"qk_norm_rope {key}: results differ run to run")
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            equal = float(sum((g == w).sum() for g, w in zip(got, want))) / (2 * got[0].numel())
            raise AssertionError(f"qk_norm_rope {key}: {equal:.6f} of outputs equal to the "
                                 "plain version's, not all")
        line = f"[kernel] qk_norm_rope {key}: bit for bit the plain version's outputs"
        if key in QK_SLICE:
            call = lambda: qknk.qk_norm_rope(segments, cos, sin)
            ms = median_ms(call)
            plain_ms = median_ms(lambda: qknk.qk_norm_rope_reference(segments, cos, sin))
            loop_kernel = loop_ms(call)
            # q and k read and written once, the tables and scales read once
            n = 2 * sum(q.numel() for q, *_ in segments)
            nbytes = 2.0 * n * 2 + 2 * cos.numel() * 4 + 2 * len(segments) * 2 * 2 * 128
            bound_ms, by = bound(0.0, nbytes)
            if key == QK_SLICE[0]:
                row.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                           bound_by=by)
            line += (f"; kernel {ms:.4f} ms, back to back {loop_kernel:.4f} ms a call "
                     f"({nbytes / loop_kernel / 1e6:.0f} GB/s, {bound_ms / loop_kernel:.1%} "
                     f"of the bound), plain version {plain_ms:.4f} ms (median of 10), bound "
                     f"{bound_ms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB)")
        print(line, flush=True)


def phase_kernels(rows: dict) -> None:
    gen = torch.Generator("cuda").manual_seed(SEED)
    phase_attention(gen, rows)
    phase_qk8(gen, rows)
    phase_group_norm(gen, rows)
    phase_conv(gen, rows)
    phase_solve(gen, rows)
    phase_qk_norm_rope(gen, rows)


def write_tokenizer(path: str, pad: str) -> None:
    """A character vocabulary with CLIP's special tokens (no merges), "!"
    at id 0 as in CLIP's vocabulary and the eos token the largest id;
    ``pad`` is the pad token (SDXL's tokenizer_2 pads with "!")."""
    os.makedirs(path, exist_ok=True)
    chars = ["!"] + list(string.ascii_lowercase + string.digits + "'-")
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
                   "pad_token": pad, "unk_token": "<|endoftext|>"}, f)


# The real tokenizer layouts (tokenizer.json) at their published sizes, with
# synthetic pieces, scores and merges drawn from SEED: T5 v1.1-XXL's Unigram
# (32,000 pieces, then the 100 sentinels, as transformers' T5Converter lays
# them out; Metaspace; "$A </s>"; the Precompiled normalizer left out, the
# CPU tests hold it) and Llama-3.1's byte-level BPE (128,000 tokens by
# 127,744 merges with ignore_merges, 256 special tokens after them, the
# Llama-3 Split pattern, "<|begin_of_text|> $A", no pad token).
T5_PIECES, T5_EXTRA_IDS = 32_000, 100
LLAMA_TOKENS = 128_000
LLAMA_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
                 r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA_SPECIALS = (["<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
                   "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>",
                   "<|reserved_special_token_2|>", "<|start_header_id|>",
                   "<|end_header_id|>", "<|eom_id|>", "<|eot_id|>", "<|python_tag|>"]
                  + [f"<|reserved_special_token_{i}|>" for i in range(3, 248)])


def _added(token_id: int, content: str) -> dict:
    return {"id": token_id, "content": content, "single_word": False, "lstrip": False,
            "rstrip": False, "normalized": False, "special": True}


def _template(single: list, special: dict) -> dict:
    pieces = [{"Sequence": {"id": "A", "type_id": 0}} if t == "$A"
              else {"SpecialToken": {"id": t, "type_id": 0}} for t in single]
    return {"type": "TemplateProcessing", "single": pieces, "pair": pieces + pieces,
            "special_tokens": {t: {"id": t, "ids": [i], "tokens": [t]}
                               for t, i in special.items()}}


@functools.lru_cache(maxsize=1)
def t5_tokenizer_files() -> tuple[str, str]:
    """(tokenizer.json, tokenizer_config.json) of the T5 layout."""
    rng = np.random.default_rng(SEED + 11)
    chars = list(string.ascii_letters + string.digits + string.punctuation)
    pieces = ["\u2581"] + chars + ["\u2581" + c for c in chars]
    seen = set(pieces)
    letters = np.array(list(string.ascii_lowercase))
    while len(pieces) < T5_PIECES - 3:
        lengths, marks = rng.integers(2, 9, 4096), rng.random(4096) < 0.5
        for n, mark in zip(lengths, marks):
            piece = ("\u2581" if mark else "") + "".join(rng.choice(letters, n))
            if piece not in seen and len(pieces) < T5_PIECES - 3:
                seen.add(piece)
                pieces.append(piece)
    scores = -np.sort(rng.uniform(2.0, 14.0, len(pieces)))
    specials = ["<pad>", "</s>", "<unk>"]
    vocab = ([[t, 0.0] for t in specials] + [[p, float(x)] for p, x in zip(pieces, scores)]
             + [[f"<extra_id_{i}>", 0.0] for i in range(T5_EXTRA_IDS - 1, -1, -1)])
    spec = {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [_added(i, t) for i, t in enumerate(specials)]
            + [_added(len(vocab) - 1 - i, f"<extra_id_{i}>") for i in range(T5_EXTRA_IDS)],
            "normalizer": {"type": "Sequence", "normalizers": [
                {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
            "pre_tokenizer": {"type": "Metaspace", "replacement": "\u2581",
                              "prepend_scheme": "always", "split": True},
            "post_processor": _template(["$A", "</s>"], {"</s>": 1}),
            "decoder": {"type": "Metaspace", "replacement": "\u2581",
                        "prepend_scheme": "always", "split": True},
            "model": {"type": "Unigram", "unk_id": 2, "vocab": vocab, "byte_fallback": False}}
    config = {"tokenizer_class": "T5Tokenizer", "eos_token": "</s>", "unk_token": "<unk>",
              "pad_token": "<pad>", "extra_ids": T5_EXTRA_IDS, "legacy": True,
              "additional_special_tokens": [f"<extra_id_{i}>" for i in range(T5_EXTRA_IDS)],
              "model_max_length": 512}
    return json.dumps(spec, ensure_ascii=False), json.dumps(config)


@functools.lru_cache(maxsize=1)
def llama_tokenizer_files() -> tuple[str, str]:
    """(tokenizer.json, tokenizer_config.json) of the Llama-3.1 layout: the
    256 byte symbols, then merges of two drawn tokens (shorter ones more
    often) up to 128,000 tokens."""
    rng = np.random.default_rng(SEED + 12)
    tokens = [bytes_to_unicode()[b] for b in range(256)]
    vocab = {t: i for i, t in enumerate(tokens)}
    merges = []
    while len(tokens) < LLAMA_TOKENS:
        n = len(tokens)
        picks = (n * rng.random((8192, 2)) ** 3).astype(int)
        for a, b in picks:
            new = tokens[a] + tokens[b]
            if new not in vocab and len(new) <= 16 and len(tokens) < LLAMA_TOKENS:
                vocab[new] = len(tokens)
                tokens.append(new)
                merges.append(f"{tokens[a]} {tokens[b]}")
    bos = LLAMA_TOKENS
    spec = {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [_added(LLAMA_TOKENS + i, t) for i, t in enumerate(LLAMA_SPECIALS)],
            "normalizer": None,
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": LLAMA_PATTERN},
                 "behavior": "Isolated", "invert": False},
                {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                 "use_regex": False}]},
            "post_processor": {"type": "Sequence", "processors": [
                {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
                 "use_regex": True},
                _template(["<|begin_of_text|>", "$A"], {"<|begin_of_text|>": bos})]},
            "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                        "use_regex": True},
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                      "vocab": vocab, "merges": merges}}
    config = {"tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<|begin_of_text|>",
              "eos_token": "<|eot_id|>", "model_max_length": 131072,
              "clean_up_tokenization_spaces": True}
    return json.dumps(spec, ensure_ascii=False), json.dumps(config)


def write_tokenizer_json(path: str, files: tuple[str, str]) -> None:
    os.makedirs(path, exist_ok=True)
    for name, text in zip(("tokenizer.json", "tokenizer_config.json"), files):
        with open(os.path.join(path, name), "w", encoding="utf-8") as f:
            f.write(text)


TOKENIZER_PROMPTS = ([FLUX_PROMPT, "a house in the style of rembrandt",
                      "Image of a doctor, 4k, highly detailed  (sharp focus)",
                      "An astronaut's 12345 steps on Mars <|eot_id|> <extra_id_3>"]
                     + [c.strip() for c in ART.split(";")] + ["東京の猫 🐱", ""])


def phase_tokenizers(t5_dir: str, llama_dir: str | None = None) -> None:
    """The tokenizer.json readers on the snapshots' files: the seconds of
    each load, and the ms of one batch of ``TOKENIZER_PROMPTS`` at T5's 256
    (schnell) and 512 (dev) tokens and Llama's 128 (HiDream), its first call
    and the median of three more; the ids within the vocab, the template's
    tokens in place."""
    checks = [("T5", t5_dir, edit_flux.load_t5_tokenizer, (256, 512))]
    if llama_dir is not None:
        checks.append(("Llama-3.1", llama_dir, edit_hd.load_llama_tokenizer, (128,)))
    for name, path, load, lengths in checks:
        start = time.perf_counter()
        tok = (load(os.path.dirname(path), os.path.basename(path)) if name == "T5"
               else load(path))
        load_s = time.perf_counter() - start
        if not isinstance(tok, HFTokenizer):
            raise AssertionError(f"{path}: read as {type(tok).__name__}, not tokenizer.json")
        size = len(tok.model.pieces if name == "T5" else tok.model.vocab)
        times = []
        for n in lengths:
            ms = []
            for _ in range(4):  # the first call, then three more
                start = time.perf_counter()
                out = tok(TOKENIZER_PROMPTS, padding="max_length", max_length=n,
                          truncation=True, return_tensors="np")
                ms.append((time.perf_counter() - start) * 1e3)
            ids, mask = out["input_ids"], out["attention_mask"]
            real = ids[mask == 1]
            if ids.shape != (len(TOKENIZER_PROMPTS), n) or real.max() >= size + 256:
                raise AssertionError(f"{name} tokenizer at {n}: ids {ids.shape}, max "
                                     f"{real.max()}")
            if name == "T5" and not all(ids[r, m.sum() - 1] == 1 for r, m in enumerate(mask)):
                raise AssertionError("T5 tokenizer: a row does not end with </s>")
            if name != "T5" and not (ids[:, 0] == LLAMA_TOKENS).all():
                raise AssertionError("Llama tokenizer: a row does not start with bos")
            times.append(f"at {n} tokens first {ms[0]:.1f} ms, then {np.median(ms[1:]):.1f} "
                         f"ms (longest row {int(mask.sum(1).max())})")
        print(f"[tokenizer] {name} tokenizer.json ({size} model tokens, "
              f"{len(tok.added)} added): loaded in {load_s:.2f} s; a batch of "
              f"{len(TOKENIZER_PROMPTS)} prompts {'; '.join(times)} (median of 3)",
              flush=True)


def write_snapshot(root: str, model: Model) -> None:
    """``model`` at its full width with seeded random weights, stored in
    fp16, as a diffusers snapshot directory."""
    rng = DeviceNormalRng(SEED, "cuda")
    parts = [("unet", model.unet, unet.init_state_dict,
              "diffusion_pytorch_model.safetensors"),
             ("vae", model.vae, vae.init_state_dict,
              "diffusion_pytorch_model.safetensors")]
    parts += [(sub, cfg, clip_text.init_state_dict, "model.safetensors")
              for sub, cfg, _ in model.texts]
    for sub, cfg, init, fname in parts:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(cfg.to_hf(), f)
        sd = {k: torch.as_tensor(v).to(torch.float16) for k, v in init(cfg, rng).items()}
        save_safetensors(sd, os.path.join(root, sub, fname))
    for sub, _, pad in model.texts:
        write_tokenizer(os.path.join(root, sub.replace("text_encoder", "tokenizer")),
                        pad)
    os.makedirs(os.path.join(root, "scheduler"), exist_ok=True)
    with open(os.path.join(root, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump(model.scheduler, f)


def run_edit(snap: str, name: str, extra: list[str], model: Model
             ) -> tuple[dict, float]:
    out = os.path.join(WORK, f"edits_{model.tag}")
    command = "edit-sdxl" if model.family == "sdxl" else "edit-sd"
    start = time.perf_counter()
    rc = cli_main([command, "--model_id", snap, "--edit_concepts", ART,
                   "--concept_type", "art", "--preserve_concepts", PRESERVE,
                   "--save_dir", out, "--exp_name", name, "--device", "cuda", *extra])
    seconds = time.perf_counter() - start
    edits = read_safetensors(os.path.join(out, name + ".safetensors"))
    if rc != 0 or len(edits) != model.targets:
        raise AssertionError(f"{command} {extra}: rc {rc}, {len(edits)} targets "
                             f"(want {model.targets})")
    for k, v in edits.items():
        if not (k.endswith(".weight") and is_sd_cross_attn_kv(k)):
            raise AssertionError(f"{command} wrote an unexpected key {k}")
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{command} {extra}: non-finite values in {k}")
    return edits, seconds


def float64_edit(c_edit, c_guide, c_pres) -> tuple:
    """(mat2, mat_a, E) of the art erase (unit scales, lamb 0.5) solved in
    float64 from the concepts' fp32 embeddings (stacks [K, d])."""
    c_edit, c_guide, c_pres = (c.double() for c in (c_edit, c_guide, c_pres))
    lam = 0.5 * torch.eye(c_edit.shape[1], dtype=torch.float64, device=c_edit.device)
    mat2 = lam + c_edit.T @ c_edit + c_pres.T @ c_pres
    mat_a = lam + c_guide.T @ c_edit + c_pres.T @ c_pres
    return mat2, mat_a, torch.linalg.solve(mat2, mat_a.T).T


def hold_edit(what: str, w, new, solved: tuple, cond: float) -> tuple:
    """Raise unless the edited weight ``new`` is within EDIT_COND_FACTOR *
    cond * eps32 of W @ E from the float64 solve (max abs diff over max abs)
    and within sqrt(d) * eps32 in backward error; returns (rel, bound,
    back, back bound)."""
    mat2, mat_a, e64 = solved
    w64, new = w.double().to("cuda"), new.double().to("cuda")
    exact, d = w64 @ e64, w64.shape[1]
    bound, back_bound = EDIT_COND_FACTOR * cond * EPS32, d ** 0.5 * EPS32
    rel = float((new - exact).abs().max() / exact.abs().max())
    back = float((new @ mat2 - w64 @ mat_a).norm() / (
        new.norm() * mat2.norm() + w64.norm() * mat_a.norm()))
    if not (rel <= bound and back <= back_bound):
        raise AssertionError(f"{what}: relative max diff {rel} from a float64 solve "
                             f"(bound {bound}), backward error {back} (bound {back_bound})")
    return rel, bound, back, back_bound


def edit_float64(snap: str, model: Model) -> tuple:
    """The art erase solved in float64 from the same fp32 concept
    embeddings, cond(mat2), and the backward error of edited weights."""
    edits, guides, preserves = resolve_edit_request(ART, None, PRESERVE, "art")
    res = edit_sd.load_resources(snap, family=model.family, device="cuda")
    emb = res.encode_concepts(edits + guides + preserves)
    stack = lambda names: torch.stack([emb[n] for n in names])
    mat2, mat_a, e = float64_edit(stack(edits), stack(guides), stack(preserves))
    targets = {k: w.double().to(e.device) for k, w in res.targets.items()}

    def backward_error(edited: dict) -> float:
        new = {k: edited[k].double().to(e.device) for k in targets}
        resid = sum(float((new[k] @ mat2 - w @ mat_a).norm()) ** 2
                    for k, w in targets.items()) ** 0.5
        norm = lambda ws: sum(float(w.norm()) ** 2 for w in ws) ** 0.5
        return resid / (norm(new.values()) * float(mat2.norm())
                        + norm(targets.values()) * float(mat_a.norm()))

    return ({k: (w @ e).float().cpu() for k, w in targets.items()},
            float(torch.linalg.cond(mat2)), backward_error)


def rel_max(got: dict, want: dict) -> float:
    scale = max(float(v.abs().max()) for v in want.values())
    return max(float((got[k] - want[k]).abs().max()) for k in want) / scale


@contextlib.contextmanager
def edit_warnings(records: list):
    """Collect the warnings that edit/sd.py logs in the enclosed calls."""
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: records.append(record.getMessage())
    log = logging.getLogger(edit_sd.__name__)
    log.addHandler(handler)
    try:
        yield
    finally:
        log.removeHandler(handler)


def phase_edit(snap: str, model: Model) -> tuple[str, int]:
    """``edit-sd`` (``edit-sdxl``) with each method, each held to a float64
    solve; --method pallas launches uce_solve once where d <= MAX_PALLAS_DIM
    and otherwise takes the collapsed solve, with uce_tpu's warning."""
    exact, cond, backward_error = edit_float64(snap, model)
    bound = EDIT_COND_FACTOR * cond * EPS32
    d = next(iter(exact.values())).shape[1]
    backward_bound = d ** 0.5 * EPS32
    general_bound = GENERAL_VS_COLLAPSED_FACTOR * cond * EPS32
    kernel_solve = d <= solvek.MAX_PALLAS_DIM
    print(f"[edit] {model.name}, d={d}: cond(mat2) {cond:.4e}; bounds on the "
          f"distance from a float64 solve: forward {bound:.3e} ({EDIT_COND_FACTOR} x "
          f"cond x eps32), backward {backward_bound:.3e} (sqrt(d) x eps32); general "
          f"from collapsed {general_bound:.3e} ({GENERAL_VS_COLLAPSED_FACTOR} x cond "
          f"x eps32)")
    results, solve_launches = {}, 0
    for method in ("collapsed", "pallas", "general"):
        kernels.reset_launches()
        name = "erase_art" if method == "collapsed" else f"erase_art_{method}"
        warnings = []
        with edit_warnings(warnings):
            edits, seconds = run_edit(snap, name, ["--method", method], model)
        launches = kernels.launches()["uce_solve"]
        want = int(method == "pallas" and kernel_solve)
        if launches != want:
            raise AssertionError(f"{model.name} edit --method {method}: uce_solve "
                                 f"launched {launches} times (want {want})")
        collapsed_route = any("pallas edit kernel needs d <=" in w for w in warnings)
        if collapsed_route != (method == "pallas" and not kernel_solve):
            raise AssertionError(f"{model.name} edit --method {method} at d={d}: "
                                 f"warnings {warnings}")
        rel, back = rel_max(edits, exact), backward_error(edits)
        if not (rel <= bound and back <= backward_bound):
            raise AssertionError(f"{model.name} edit --method {method}: relative "
                                 f"max diff {rel} from a float64 solve (bound "
                                 f"{bound}), backward error {back} (bound "
                                 f"{backward_bound})")
        line = (f"[edit] {model.name} --method {method}: {model.targets} finite "
                f"targets in {seconds:.2f} s (CLI wall, load included), relative max "
                f"diff from a float64 solve {rel:.3e} (bound {bound:.3e}), backward "
                f"error {back:.3e} (bound {backward_bound:.3e})")
        if method != "collapsed":
            rel_c = rel_max(edits, results["collapsed"])
            limit = (0.0 if collapsed_route else PALLAS_VS_COLLAPSED_MAX
                     if method == "pallas" else general_bound)
            if not rel_c <= limit:
                raise AssertionError(f"{model.name} edit --method {method}: relative "
                                     f"max diff {rel_c} from collapsed > {limit}")
            line += f", from collapsed {rel_c:.3e}"
        if collapsed_route:
            line += f" (took the collapsed solve: {warnings[0]!r})"
        print(f"{line}, uce_solve launches {launches}", flush=True)
        results[method] = edits
        solve_launches += launches
    return (os.path.join(WORK, f"edits_{model.tag}", "erase_art.safetensors"),
            solve_launches)


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def expect_launches(what: str, got: dict, want: dict) -> None:
    wrong = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if wrong:
        raise AssertionError(f"{what}: launches (got, want) {wrong}")


def unet_inputs(pipe, model: Model, prompts: list[str]):
    """(x, context, added_cond) of one UNet call under CFG for ``prompts``
    at the model's latent size."""
    n = len(prompts)
    added_cond = None
    if pipe.is_sdxl:
        cond, pooled_cond = pipe.encode_prompts_sdxl(prompts)
        uncond, pooled_uncond = pipe.encode_prompts_sdxl([""] * n)
        added_cond = pipe._sdxl_added_cond(pooled_cond, pooled_uncond, model.size,
                                           model.size)
    else:
        cond, uncond = pipe.encode_prompts(prompts), pipe.encode_prompts([""] * n)
    latents = draw_prompt_latents((model.latent, model.latent, 4), SEED, n, 1)
    latents = latents.to("cuda", pipe.dtype)
    return torch.cat([latents, latents]), torch.cat([uncond, cond]), added_cond


def phase_unet(pipe, rows: dict, model: Model, prompts: list[str]) -> None:
    """UNet forwards at UNet batch 2 x len(prompts): the attention kernel
    against the plain attention ("library" against "plain": sd_attention
    switched off too), and all kernels against the library path, with
    launches."""
    with torch.inference_mode():
        x, context, added_cond = unet_inputs(pipe, model, prompts)
        runs = {"plain": ("sd_attention", *LIBRARY_OFF), "library": LIBRARY_OFF,
                "kernels": ()}
        library = library_launches(model.unet_launches)
        want = {"plain": {**library, "sd_attention": 0}, "library": library,
                "kernels": model.unet_launches}
        outs, times = {}, {}
        seen, gn_seen = collections.Counter(), collections.Counter()
        for name, off in runs.items():
            fwd = lambda: unet.apply(pipe.unet_params, x, 981.0, context,
                                     pipe.unet_config, added_cond=added_cond)
            with kernels.route(off):
                kernels.reset_launches()
                with conv_shapes(seen, rows["conv3x3"]), gn_shapes(
                        gn_seen, rows["group_norm_act"]):
                    outs[name] = fwd().float()
                if name == "kernels":
                    want[name] = {**want[name], "conv3x3_reduce": conv_split_sums(seen)}
                expect_launches(f"{model.name} UNet forward ({name})", kernels.launches(),
                                want[name])
                times[name] = median_ms(fwd, reps=5)
    if model is SD14:
        unsplit = [k for k in seen if k[0][1] == 8 and convk.plan(
            *k[0], k[1], _build.sm_count(CUDA)).splits == 1]
        if unsplit:
            raise AssertionError(f"UNet forward: the 8x8 level's convs {unsplit} do "
                                 "not split K")
    if not all(bool(torch.isfinite(o).all()) for o in outs.values()):
        raise AssertionError(f"{model.name} UNet forward: non-finite output")
    for a, b in (("library", "plain"), ("kernels", "library")):
        rel = rel_l2(outs[a], outs[b])
        if rel > REL_L2_MAX:
            raise AssertionError(f"{model.name} UNet forward {a} vs {b}: rel L2 "
                                 f"{rel} > {REL_L2_MAX}")
        print(f"[unet] {model.name} batch {x.shape[0]} ({len(prompts)} prompts x "
              f"CFG) at {model.latent}x{model.latent} latents: rel L2 {a} vs {b} "
              f"{rel:.3e} (bound {REL_L2_MAX})")
    print(f"[unet] {model.name} forward, median of 5: {times['kernels']:.2f} ms on all "
          f"kernels (launches per forward {want['kernels']}; {len(seen)} conv and "
          f"{len(gn_seen)} group_norm_act shapes each held to the plain version on "
          f"the forward's inputs), "
          f"{times['library']:.2f} ms on the library path with the attention "
          f"kernel, {times['plain']:.2f} ms plain", flush=True)


def phase_vae(pipe, rows: dict, model: Model) -> None:
    n, vcfg = model.latent, pipe.vae_config
    lat = draw_prompt_latents((n, n, vcfg.latent_channels), SEED + 1, 1, 1)
    lat = (lat / vcfg.scaling_factor + vcfg.shift_factor).to("cuda", pipe.dtype)
    # the mid-block attention at one head splits its KV range where its
    # query tiles alone do not fill the card (s=4096 does, 9216 and 16384 not)
    merges = int(sdk.d512_splits(1, n * n, n * n, _build.sm_count(CUDA)) > 1)
    outs, times = {}, {}
    seen, gn_seen = collections.Counter(), collections.Counter()
    with torch.inference_mode():
        for name in ("library", "kernels"):
            dec = lambda: vae.decode(pipe.vae_params, lat, pipe.vae_config)
            with path_route(name):
                kernels.reset_launches()
                with conv_shapes(seen, rows["conv3x3"]), gn_shapes(
                        gn_seen, rows["group_norm_act"]):
                    outs[name] = dec().float()
                got = kernels.launches()
                want = VAE_LAUNCHES if name == "kernels" else VAE_LAUNCHES_LIBRARY
                if name == "kernels":
                    want = {**want, "conv3x3_reduce": conv_split_sums(seen)}
                expect_launches(f"{model.name} VAE decode ({name})", got, want)
                if got["sd_attention_d512"] != 1 or got["sd_attention_d512_merge"] != merges:
                    raise AssertionError(f"{model.name} VAE decode ({name}): {got}, "
                                         f"want {merges} split merges")
                times[name] = median_ms(dec, reps=3, warmup=1)
    size = model.size
    if outs["kernels"].shape != (1, 3, size, size) or not bool(
            torch.isfinite(outs["kernels"]).all()):
        raise AssertionError(f"{model.name} VAE decode: {tuple(outs['kernels'].shape)}")
    rel = rel_l2(outs["kernels"], outs["library"])
    if rel > REL_L2_MAX:
        raise AssertionError(f"{model.name} VAE decode kernels vs library: rel L2 {rel}")
    reduces = conv_split_sums(seen)
    print(f"[vae] {model.name} decode batch 1 at {size}x{size}: rel L2 kernels vs "
          f"library {rel:.3e} (bound {REL_L2_MAX}); {times['kernels']:.2f} ms on all "
          f"kernels (launches {VAE_LAUNCHES}, {reduces} conv split-K sums, {len(seen)} "
          f"conv and {len(gn_seen)} group_norm_act shapes held to the plain version on "
          f"the decode's inputs, sd_attention at "
          f"d=512 with {merges} split merge), "
          f"{times['library']:.2f} ms on the library path with sd_attention at "
          "d=512 (median of 3)", flush=True)


def generate_dir(model: Model, path: str, scheduler: str | None = None,
                 fast: str | None = None) -> str:
    """Where ``phase_generate`` writes a run's PNGs ({case}_0.png)."""
    tag = "exact" if fast is None else re.sub(r"[^0-9a-z]+", "_", fast)
    return os.path.join(WORK, f"images_{model.tag}_{path}_{scheduler or 'default'}_"
                        f"{tag}", "erase_art")


def read_case_images(folder: str, cases: list) -> dict:
    out = {}
    for case, _, _ in cases:
        with open(os.path.join(folder, f"{case}_0.png"), "rb") as f:
            out[case] = decode_png(f.read())
    return out


def fast_schedule(spec: str | None, calls: int) -> collections.Counter:
    """UNet forwards of one run of ``calls`` scheduler calls by (cond_only,
    full): within each segment of the CFG window a call runs the shallow
    path unless it is a multiple of the cache interval or the cache is
    invalid (the first segment, and a guided one: the deep feature's cond
    half carries over only from a guided segment into a cond-only one)."""
    if spec is None:
        return collections.Counter({(False, True): calls})
    fast = FastConfig.from_spec(spec)
    n, valid, prev_guided = fast.cache_interval, False, False
    out = collections.Counter()
    for start, end, cond_only in fast.segments(calls):
        valid = valid and prev_guided and cond_only
        for i in range(start, end):
            out[cond_only, n == 1 or not valid or i % n == 0] += 1
            valid = True
        prev_guided = not cond_only
    return out


def fast_forwards(spec: str | None, calls: int) -> tuple[int, int]:
    """(full, shallow) UNet forwards of one run (``fast_schedule``)."""
    sched = fast_schedule(spec, calls)
    full = sum(n for (_, is_full), n in sched.items() if is_full)
    return full, sum(sched.values()) - full


@contextlib.contextmanager
def finite_decodes():
    """Raise if a VAE decode of the enclosed calls gives a non-finite value
    (a non-finite latent propagates there; uint8 images would hide it)."""
    decode = vae.decode

    def checked(params, z, config):
        out = decode(params, z, config)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"non-finite VAE decode output {tuple(out.shape)}")
        return out

    vae.decode = checked
    try:
        yield
    finally:
        vae.decode = decode


def phase_generate(snap: str, edit_path: str, path: str, rows: dict, model: Model,
                   cases: list, scheduler: str | None = None, steps: int = 50,
                   fast: str | None = None) -> dict:
    """``generate`` through the CLI with the edit overlay, one image per CSV
    row of ``cases`` ([case, prompt, seed]), with ``--fast`` given a spec:
    PNG checks, finite decodes and every kernel's launches (per row: the
    scheduler's calls of the UNet, full or shallow, and one decode)."""
    csv_path = os.path.join(WORK, f"prompts_{model.tag}.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["case_number", "prompt", "evaluation_seed"])
        w.writerows(cases)
    out = generate_dir(model, path, scheduler, fast)
    plan = (plan_from_hf(model.scheduler, steps) if scheduler is None
            else plan_from_hf_as(scheduler, model.scheduler, steps))
    calls = plan.num_calls
    full, shallow = fast_forwards(fast, calls)
    per_call, per_shallow = model.unet_launches, model.shallow_launches or {}
    per_decode = VAE_LAUNCHES if path == "kernels" else VAE_LAUNCHES_LIBRARY
    if path != "kernels":
        per_call = library_launches(per_call)
        per_shallow = library_launches(per_shallow) if shallow else {}
    rows_n = len(cases)
    want = {k: rows_n * (full * per_call[k] + shallow * per_shallow.get(k, 0)
                         + per_decode[k]) for k in per_call}
    seen = collections.Counter()  # generate runs each row alone: UNet batch 2
    gn_seen = collections.Counter()
    extra = ["--scheduler", scheduler] if scheduler else []
    extra += ["--fast", fast] if fast else []
    with path_route(path):
        kernels.reset_launches()
        start = time.perf_counter()
        with conv_shapes(seen, rows["conv3x3"]), gn_shapes(
                gn_seen, rows["group_norm_act"]), finite_decodes():
            rc = cli_main(["generate", "--model_id", snap, "--prompts_path", csv_path,
                           "--save_path", os.path.dirname(out), "--uce_model_path",
                           edit_path, "--image_size", str(model.size),
                           "--num_inference_steps", str(steps), "--device", "cuda",
                           *extra])
        launches = kernels.launches()
        seconds = time.perf_counter() - start
    want["conv3x3_reduce"] = conv_split_sums(seen)
    if rc != 0:
        raise AssertionError(f"{model.name} generate ({path}): rc {rc}")
    forwards = (f"{calls} UNet calls" if fast is None else
                f"{full} full + {shallow} shallow UNet calls, --fast {fast}")
    what = (f"{model.name} generate ({path}, {plan.kind}), {rows_n} rows x "
            f"({forwards} + 1 decode)")
    expect_launches(what, launches, want)
    size = model.size
    for case, img in read_case_images(out, cases).items():
        if img.shape != (size, size, 3) or img.dtype != np.uint8 or img.std() == 0:
            raise AssertionError(f"{what}: image {case} is {img.shape} {img.dtype}, "
                                 f"std {img.std()}")
    per = (f"{per_call}" if fast is None else
           f"{full} x {per_call} + {shallow} x {per_shallow}")
    print(f"[generate] {what}: {rows_n} PNGs {size}x{size}x3 uint8 in {seconds:.2f} s "
          f"(CLI wall, load included); launches {launches} = {rows_n} rows x "
          f"({per} + {per_decode}) and {want['conv3x3_reduce']} conv split-K sums; "
          f"{len(seen)} conv and {len(gn_seen)} group_norm_act shapes held to the "
          "plain version on the run's own inputs", flush=True)
    return launches


def phase_fast(snap: str, edit_path: str, path: str, rows: dict, model: Model,
               cases: list, specs: tuple) -> None:
    """``generate --fast`` on ``path`` against the exact run's PNGs: a no-op
    spec and a CFG window over every call (cache 1) bit for bit; other specs
    their mean and max distance. Adds every run's launches to ``rows``."""
    calls = plan_from_hf(model.scheduler, 50).num_calls
    exact = read_case_images(generate_dir(model, path), cases)
    for spec in specs:
        add_launches(rows, phase_generate(snap, edit_path, path, rows, model, cases,
                                          fast=spec))
        got = read_case_images(generate_dir(model, path, fast=spec), cases)
        fc = FastConfig.from_spec(spec)
        bitwise = fc.is_noop or (fc.cache_interval == 1 and fc.segments(calls) == [
            (0, calls, False)])
        diffs = [np.abs(got[c].astype(int) - exact[c].astype(int)) for c in exact]
        if bitwise and any(d.any() for d in diffs):
            raise AssertionError(f"{model.name} generate --fast {spec} ({path}): not "
                                 f"equal to the exact images (max diff "
                                 f"{max(int(d.max()) for d in diffs)})")
        print(f"[fast] {model.name} --fast {spec} ({path}): "
              + ("equal to the exact images bit for bit" if bitwise else
                 f"mean |fast - exact| {np.mean([d.mean() for d in diffs]):.3f} uint8 "
                 f"levels, max {max(int(d.max()) for d in diffs)}"), flush=True)


@contextlib.contextmanager
def qk8_plain():
    """Run the int8-QK^T attention's plain version in place of its kernel in
    the enclosed calls (to hold a quantized forward to itself)."""
    saved = sdk.sd_attention_qk8
    sdk.sd_attention_qk8 = sdk.sd_attention_qk8_reference
    try:
        yield
    finally:
        sdk.sd_attention_qk8 = saved


@contextlib.contextmanager
def qk8_checked(notes: list, row: dict | None = None):
    """Hold every int8-QK^T kernel call of the enclosed calls to its plain
    version on the same inputs, the forward's own activations (raises
    outside the kernel bounds; the worst error goes into ``row``); the
    kernel's output goes on."""
    kernel = sdk.sd_attention_qk8

    def checked(q, ki, ks, v, scale):
        got = kernel(q, ki, ks, v, scale)
        err, note = check_bf16("sd_attention_qk8", f"sd_attention_qk8 in the W8A8 "
                               f"forward {tuple(q.shape)}", got,
                               sdk.sd_attention_qk8_reference(q, ki, ks, v, scale))
        notes.append(note)
        if row is not None:
            row["max_abs_err"] = max(row["max_abs_err"], err)
        return got

    sdk.sd_attention_qk8 = checked
    try:
        yield
    finally:
        sdk.sd_attention_qk8 = kernel


@contextlib.contextmanager
def qk8_plain_nudged(gen, share: float, rels: list):
    """The plain version with one bf16 ulp added to the magnitude of a
    random ``share`` of its output entries: a control for how far a whole
    W8A8 forward moves when each attention output moves about as far as
    the kernel's does from the plain version."""
    saved = sdk.sd_attention_qk8

    def nudged(q, ki, ks, v, scale):
        out = sdk.sd_attention_qk8_reference(q, ki, ks, v, scale)
        flip = (torch.rand(out.shape, device=out.device, generator=gen) < share) & (out != 0)
        moved = (out.view(torch.int16) + flip.to(torch.int16)).view(torch.bfloat16)
        rels.append(rel_l2(moved, out))
        return moved

    sdk.sd_attention_qk8 = nudged
    try:
        yield
    finally:
        sdk.sd_attention_qk8 = saved


def phase_quant_unet(pipe) -> None:
    """One W8A8 UNet forward at batch 8 (4 prompts under CFG, the top serving
    rung): its launches; each int8-QK^T kernel call held to the plain version
    on the forward's own inputs; the whole forward against the same forward
    on the plain version and against the bf16 forward (gross faults: a
    difference of one count in an int8 activation re-rounds every layer
    after it, so whole W8A8 forwards differ by far more than the kernel
    does per call)."""
    qparams = quantize.quantize_params(pipe.unet_params, quantize.UNET_SKIP, "int8")
    nq, nw = quantize.count_quantized(qparams)
    prompts = SERVE_PROMPTS + ["a photo of a cat"]
    notes = []
    with torch.inference_mode():
        context = torch.cat([pipe.encode_prompts([""] * 4), pipe.encode_prompts(prompts)])
        latents = draw_prompt_latents((64, 64, 4), SEED, 4, 1).to("cuda", pipe.dtype)
        x = torch.cat([latents, latents])
        fwd = lambda params: unet.apply(params, x, 981.0, context, pipe.unet_config)
        kernels.reset_launches()
        int8 = fwd(qparams).float()
        expect_launches("W8A8 UNet forward", kernels.launches(), UNET_LAUNCHES_INT8)
        with qk8_checked(notes):
            fwd(qparams)
        with qk8_plain():
            plain = fwd(qparams).float()
        nudge_rels = []
        with qk8_plain_nudged(torch.Generator("cuda").manual_seed(SEED), 0.02,
                              nudge_rels):
            nudged = fwd(qparams).float()
        bf16 = fwd(pipe.unet_params).float()
        int8_ms = median_ms(lambda: fwd(qparams), reps=5)
        bf16_ms = median_ms(lambda: fwd(pipe.unet_params), reps=5)
    if len(notes) != UNET_LAUNCHES_INT8["sd_attention_qk8"]:
        raise AssertionError(f"W8A8 UNet forward: {len(notes)} qk8 calls checked")
    if not all(bool(torch.isfinite(o).all()) for o in (int8, plain)):
        raise AssertionError("W8A8 UNet forward: non-finite output")
    for note in notes:
        print(f"[int8] qk8 call in the forward: {note}")
    rel, rel_bf = rel_l2(int8, plain), rel_l2(int8, bf16)
    cos = float((int8 * bf16).sum() / (int8.norm() * bf16.norm()))
    for what, value in (("its plain version", rel), ("bf16", rel_bf)):
        if value > INT8_VS_BF16_REL_L2:
            raise AssertionError(f"W8A8 UNet forward vs {what}: rel L2 {value} > "
                                 f"{INT8_VS_BF16_REL_L2}")
    print(f"[int8] control: the forward on the qk8 plain version with 2% of each "
          f"attention output moved by one bf16 ulp (rel L2 per call "
          f"{min(nudge_rels):.3e}-{max(nudge_rels):.3e}) reads rel L2 "
          f"{rel_l2(nudged, plain):.3e} against it unmoved")
    print(f"[int8] UNet forward, batch 8 at 64x64 latents, {nq} of {nw} weights "
          f"int8: rel L2 against the same forward on the qk8 plain version "
          f"{rel:.3e}, against the bf16 forward {rel_bf:.3e} (gross-fault bound "
          f"{INT8_VS_BF16_REL_L2}), cosine to bf16 {cos:.6f}; launches "
          f"{UNET_LAUNCHES_INT8}; median of 5: W8A8 {int8_ms:.2f} ms, bf16 kernel "
          f"path {bf16_ms:.2f} ms", flush=True)


def phase_quant_vae(pipe) -> None:
    """One W8A8 VAE decode at 512x512: the mid-block attention stays on the
    bf16 d=512 kernel."""
    qparams = quantize.quantize_params(pipe.vae_params, quantize.VAE_SKIP, "int8")
    lat = draw_prompt_latents((64, 64, 4), SEED + 1, 1, 1).to("cuda", pipe.dtype)
    lat = lat / pipe.vae_config.scaling_factor
    dec = lambda params: vae.decode(params, lat, pipe.vae_config)
    with torch.inference_mode():
        kernels.reset_launches()
        int8 = dec(qparams).float()
        expect_launches("W8A8 VAE decode", kernels.launches(), VAE_LAUNCHES_INT8)
        bf16 = dec(pipe.vae_params).float()
        int8_ms = median_ms(lambda: dec(qparams), reps=3, warmup=1)
    if int8.shape != (1, 3, 512, 512) or not bool(torch.isfinite(int8).all()):
        raise AssertionError(f"W8A8 VAE decode: {tuple(int8.shape)}")
    rel = rel_l2(int8, bf16)
    if rel > INT8_VS_BF16_REL_L2:
        raise AssertionError(f"W8A8 VAE decode vs bf16: rel L2 {rel}")
    print(f"[int8] VAE decode batch 1 at 512x512: rel L2 against bf16 {rel:.3e} "
          f"(gross-fault bound {INT8_VS_BF16_REL_L2}); launches {VAE_LAUNCHES_INT8}; "
          f"{int8_ms:.2f} ms (median of 3)", flush=True)


def phase_quant_model(pipe, rows: dict, model: Model) -> None:
    """SD 2.1 or SDXL quantized, ``int8`` (W8A8) and ``w8``: one UNet forward
    at UNet batch 2 (one prompt under CFG) and one VAE decode at the model's
    size, each held to the bf16 network within the W8A8 gross-fault bound.
    W8A8 sends the UNet's long self-attentions (d=64: SD 2.1's 10, SDXL's
    70, as counted on meta tensors in tests/test_torch_sdxl_sd21_shapes.py)
    to the int8-QK^T kernel, each call held to its plain version on the
    forward's own inputs; w8 sends them to the bf16 kernel."""
    n_attn = model.unet_launches["sd_attention"]
    with torch.inference_mode():
        x, context, added_cond = unet_inputs(pipe, model, ["a painting by kelly mckernan"])
        fwd = lambda params: unet.apply(params, x, 981.0, context, pipe.unet_config,
                                        added_cond=added_cond)
        n, vcfg = model.latent, pipe.vae_config
        lat = draw_prompt_latents((n, n, vcfg.latent_channels), SEED + 1, 1, 1)
        lat = (lat / vcfg.scaling_factor + vcfg.shift_factor).to("cuda", pipe.dtype)
        dec = lambda params: vae.decode(params, lat, vcfg)
        bf16, bf16_dec = fwd(pipe.unet_params).float(), dec(pipe.vae_params).float()
        bf16_ms = median_ms(lambda: fwd(pipe.unet_params), reps=5)
        for mode in ("int8", "w8"):
            qunet = quantize.quantize_params(pipe.unet_params, quantize.UNET_SKIP, mode)
            qvae = quantize.quantize_params(pipe.vae_params, quantize.VAE_SKIP, mode)
            nq, nw = quantize.count_quantized(qunet)
            notes = []
            kernels.reset_launches()
            with qk8_checked(notes, rows["sd_attention_qk8"]):
                out = fwd(qunet).float()
            int8 = mode == "int8"
            expect_launches(f"{model.name} {mode} UNet forward", kernels.launches(),
                            {"sd_attention_qk8": n_attn if int8 else 0,
                             "sd_attention": 0 if int8 else n_attn})
            kernels.reset_launches()
            out_dec = dec(qvae).float()
            expect_launches(f"{model.name} {mode} VAE decode", kernels.launches(),
                            VAE_LAUNCHES_INT8)
            ms = median_ms(lambda: fwd(qunet), reps=5)
            dec_ms = median_ms(lambda: dec(qvae), reps=3, warmup=1)
            del qunet, qvae
            if len(notes) != (n_attn if int8 else 0):
                raise AssertionError(f"{model.name} {mode} UNet: {len(notes)} qk8 calls "
                                     "checked")
            size = n * 2 ** (len(vcfg.block_out_channels) - 1)  # the model's size
            if out_dec.shape != (1, 3, size, size):
                raise AssertionError(f"{model.name} {mode} VAE decode: {out_dec.shape}")
            if not all(bool(torch.isfinite(o).all()) for o in (out, out_dec)):
                raise AssertionError(f"{model.name} {mode}: non-finite output")
            rel, rel_dec = rel_l2(out, bf16), rel_l2(out_dec, bf16_dec)
            for what, value in (("UNet", rel), ("VAE", rel_dec)):
                if value > INT8_VS_BF16_REL_L2:
                    raise AssertionError(f"{model.name} {mode} {what} vs bf16: rel L2 "
                                         f"{value} > {INT8_VS_BF16_REL_L2}")
            if notes:
                print(f"[{mode}] {model.name} qk8 calls in the forward (first, last): "
                      f"{notes[0]}; {notes[-1]}")
            print(f"[{mode}] {model.name} UNet forward, batch 2 at {n}x{n} latents, {nq} "
                  f"of {nw} weights int8: rel L2 against bf16 {rel:.3e}, VAE decode at "
                  f"{size}x{size} {rel_dec:.3e} (gross-fault bound "
                  f"{INT8_VS_BF16_REL_L2}); {n_attn} d=64 self-attentions on the "
                  f"{'int8-QK^T' if int8 else 'bf16'} kernel; median of 5: UNet {ms:.2f} "
                  f"ms (bf16 kernel path {bf16_ms:.2f} ms), decode {dec_ms:.2f} ms "
                  "(median of 3)", flush=True)


def phase_serve_model(snap: str, edit_path: str, model: Model, steps: int = 8,
                      requests: int = 3) -> dict:
    """``serve --quantize int8`` of SD 2.1 or SDXL with the edit overlay,
    through the CLI at the model's size: warm-up of the ladder 1,2, then
    ``requests`` Poisson requests at 1/s, ``steps`` steps of the model's
    scheduler (cut from 50: a step costs the same at any count); the JSON
    report, the served images and the int8-QK^T launches."""
    argv = ["serve", "--model_id", snap, "--quantize", "int8", "--uce_model_path",
            edit_path, "--batch_sizes", "1,2", "--bench", "1", "--bench_requests",
            str(requests), "--num_inference_steps", str(steps), "--image_size",
            str(model.size), "--device", "cuda"]
    out, calls = io.StringIO(), []
    kernels.reset_launches()
    start = time.perf_counter()
    with contextlib.redirect_stdout(out), finite_decodes(), pipe_calls(calls):
        rc = cli_main(argv)
    launches = kernels.launches()
    seconds = time.perf_counter() - start
    reports = [json.loads(line) for line in out.getvalue().splitlines()
               if line.startswith("{")]
    if rc != 0 or len(reports) != 1:
        raise AssertionError(f"{model.name} serve: rc {rc}, output {out.getvalue()!r}")
    rep = reports[0]
    if not (rep["n_requests"] == requests and rep["throughput_rps"] > 0
            and 0 < rep["latency_p50_s"] <= rep["latency_p95_s"]):
        raise AssertionError(f"{model.name} serve report: {rep}")
    batches = 2 + rep["batches"]  # one warm-up batch per rung
    calls_per = plan_from_hf(model.scheduler, steps).num_calls
    want = {"sd_attention_qk8": batches * calls_per * model.unet_launches["sd_attention"],
            "sd_attention": batches, "sd_attention_d512": batches}
    what = f"{model.name} serve --quantize int8, {batches} batches x {calls_per} calls"
    expect_launches(what, launches, want)
    served = [img for _, images in calls[2:] for img in images]
    check_images(f"{model.name} serve --quantize int8", served, model.size)
    print(f"[serve] {json.dumps(rep)}")
    print(f"[serve] {model.name} --quantize int8 --batch_sizes 1,2 --bench 1, {steps} "
          f"steps at {model.size}^2: {requests} requests in {rep['batches']} batches (+2 "
          f"warm-up), throughput {rep['throughput_rps']} req/s, latency p50 "
          f"{rep['latency_p50_s']} s, p95 {rep['latency_p95_s']} s; {len(served)} served "
          f"images (padding included), seconds per batch "
          f"{[round(c[0], 3) for c in calls]}; {seconds:.1f} s CLI wall; launches {want}",
          flush=True)
    return launches


def phase_serve(snap: str, edit_path: str, fast: str | None = None) -> dict:
    """``serve --quantize int8`` (``--fast`` given a spec) with the edit
    overlay, in process through the CLI at ``SERVE_STEPS``: warm-up of the
    ladder 1,2,4, then ``SERVE_REQUESTS`` Poisson requests at 4/s."""
    argv = ["serve", "--model_id", snap, "--quantize", "int8", "--uce_model_path",
            edit_path, "--batch_sizes", "1,2,4", "--bench", "4", "--bench_requests",
            str(SERVE_REQUESTS), "--num_inference_steps", str(SERVE_STEPS),
            "--device", "cuda"] + (["--fast", fast] if fast else [])
    out = io.StringIO()
    kernels.reset_launches()
    start = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    launches = kernels.launches()
    seconds = time.perf_counter() - start
    reports = [json.loads(line) for line in out.getvalue().splitlines()
               if line.startswith("{")]
    if rc != 0 or len(reports) != 1:
        raise AssertionError(f"serve --bench: rc {rc}, output {out.getvalue()!r}")
    rep = reports[0]
    if not (rep["n_requests"] == SERVE_REQUESTS and rep["throughput_rps"] > 0
            and 0 < rep["latency_p50_s"] <= rep["latency_p95_s"]):
        raise AssertionError(f"serve --bench report: {rep}")
    batches = 3 + rep["batches"]  # one warm-up batch per rung
    full, shallow = fast_forwards(fast, pndm_plan(SERVE_STEPS).num_calls)
    want = {"sd_attention_qk8": batches * (
        full * UNET_LAUNCHES_INT8["sd_attention_qk8"]
        + shallow * UNET_SHALLOW_LAUNCHES_INT8["sd_attention_qk8"]),
        "sd_attention": batches, "sd_attention_d512": batches}
    mode = f" --fast {fast}" if fast else ""
    expect_launches(f"serve --quantize int8{mode}, {batches} batches x ({full} full "
                    f"+ {shallow} shallow UNet calls + 1 decode)", launches, want)
    print(f"[serve] {json.dumps(rep)}")
    print(f"[serve] --quantize int8{mode} --batch_sizes 1,2,4 --bench 4, {SERVE_STEPS} "
          f"steps: {SERVE_REQUESTS} requests in "
          f"{rep['batches']} batches (+3 warm-up), throughput {rep['throughput_rps']} "
          f"req/s, latency p50 {rep['latency_p50_s']} s, p95 {rep['latency_p95_s']} s; "
          f"{seconds:.1f} s CLI wall (load, warm-up and load run); launches "
          f"{want}", flush=True)
    return launches


def phase_socket(snap: str, edit_path: str) -> None:
    """The socket server in a subprocess at SOCKET_STEPS steps (the socket
    API is under test, not the denoise): three concurrent requests (two
    saved to files, one base64), stats, shutdown."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    sock = os.path.join(WORK, "uce.sock")
    msgs = [{"prompt": SERVE_PROMPTS[0], "seed": 1,
             "save_path": os.path.join(WORK, "socket_0.png")},
            {"prompt": SERVE_PROMPTS[1], "seed": 2,
             "save_path": os.path.join(WORK, "socket_1.png")},
            {"prompt": SERVE_PROMPTS[2], "seed": 3}]
    start = time.perf_counter()
    with open(os.path.join(WORK, "serve.log"), "w") as log:
        # the socket path is relative to WORK: an AF_UNIX path has at most
        # 107 bytes, whatever the depth of the checkout
        proc = subprocess.Popen(
            [sys.executable, "-m", "uce_tpu_torch", "serve", "--model_id", snap,
             "--quantize", "int8", "--uce_model_path", edit_path, "--socket",
             "uce.sock", "--batch_size", "4", "--max_wait_ms", "1000",
             "--num_inference_steps", str(SOCKET_STEPS), "--device", "cuda"],
            cwd=WORK, env=env, stdout=log,
            stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 600
        while not os.path.exists(sock):
            if proc.poll() is not None or time.monotonic() > deadline:
                with open(os.path.join(WORK, "serve.log")) as f:
                    raise AssertionError(f"serve did not bind its socket (exit "
                                         f"{proc.poll()}): {f.read()[-3000:]}")
            time.sleep(0.5)
        with contextlib.chdir(WORK), ThreadPoolExecutor(len(msgs)) as pool:
            replies = list(pool.map(lambda m: socket_api.request("uce.sock", m), msgs))
            stats = socket_api.request("uce.sock", {"cmd": "stats"})
            bye = socket_api.request("uce.sock", {"cmd": "shutdown"})
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if any(r.get("status") != "ok" for r in replies + [stats, bye]) or rc != 0:
        raise AssertionError(f"socket server: replies {replies}, stats {stats}, "
                             f"shutdown {bye}, exit {rc}")
    images = []
    for msg, reply in zip(msgs, replies):
        if "save_path" in msg:
            with open(reply["path"], "rb") as f:
                images.append(decode_png(f.read()))
        else:
            images.append(decode_png(base64.b64decode(reply["png_base64"])))
    for i, img in enumerate(images):
        if img.shape != (512, 512, 3) or img.dtype != np.uint8 or img.std() == 0:
            raise AssertionError(f"socket image {i}: {img.shape} {img.dtype}")
    if any(np.array_equal(images[i], images[j]) for i in range(3) for j in range(i)):
        raise AssertionError("socket server: images for different seeds are equal")
    if stats["requests"] != 3:
        raise AssertionError(f"socket server stats: {stats}")
    print(f"[serve] socket server (subprocess, --quantize int8, batch 4, "
          f"{SOCKET_STEPS} steps): 3 "
          f"concurrent requests -> 3 distinct 512x512x3 PNGs (2 files, 1 base64); "
          f"stats batches {stats['batches']}, occupancy {stats['occupancy']:.3f}, "
          f"batch seconds {stats['total_batch_seconds']:.2f}; shutdown, exit 0; "
          f"{time.perf_counter() - start:.1f} s wall with start-up", flush=True)


def phase_throughput(pipe, path: str, fast: str | None = None) -> float:
    prompts = ["a painting by kelly mckernan", "a house in the style of rembrandt"]
    with path_route(path):
        torch.cuda.synchronize()
        start = time.perf_counter()
        imgs = pipe(prompts, num_inference_steps=50, guidance_scale=7.5, seed=[1, 2],
                    fast=FastConfig.from_spec(fast) if fast else None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    if imgs.shape != (2, 512, 512, 3):
        raise AssertionError(f"pipeline returned {imgs.shape}")
    rate = 2 / seconds
    mode = f", --fast {fast}" if fast else ""
    print(f"[generate] {path} path{mode}, 2 prompts in one batch (UNet batch 4), 50 "
          f"PNDM steps: {seconds:.3f} s, {rate:.4f} img/s", flush=True)
    return rate


def phase_fast_rate(pipe, path: str) -> None:
    """img/s of ``FAST_SPEC`` against exact on one path, in turns (exact,
    fast, fast, exact), and the UNet forwards that set the ratio: full and
    shallow at UNet batch 4 (2 prompts under CFG) and 2 (cond-only), CUDA
    events, median of 5, and the UNet time of each run that they give."""
    rates = collections.defaultdict(list)
    for mode in ("exact", "fast", "fast", "exact"):
        rates[mode].append(phase_throughput(pipe, path, FAST_SPEC if mode == "fast"
                                            else None))
    prompts = ["a painting by kelly mckernan", "a house in the style of rembrandt"]
    ms = {}
    with torch.inference_mode(), path_route(path):
        x, context, _ = unet_inputs(pipe, SD14, prompts)
        for cond_only, (xb, cb) in ((False, (x, context)), (True, (x[2:], context[2:]))):
            fwd = lambda **kw: unet.apply(pipe.unet_params, xb, 981.0, cb,
                                          pipe.unet_config, **kw)
            deep = fwd(return_deep=True)[1]
            ms[cond_only, True] = median_ms(fwd, reps=5)
            ms[cond_only, False] = median_ms(lambda: fwd(deep_feature=deep), reps=5)
    calls = pndm_plan(50).num_calls
    unet_ms = {mode: sum(n * ms[k] for k, n in fast_schedule(spec, calls).items())
               for mode, spec in (("exact", None), ("fast", FAST_SPEC))}
    exact, fast = (float(np.median(rates[m])) for m in ("exact", "fast"))
    print(f"[fast] {path} path, --fast {FAST_SPEC}: {rates['fast']} img/s against "
          f"exact {rates['exact']} (medians {fast:.4f} / {exact:.4f}, "
          f"{fast / exact:.3f}x); UNet forward ms (median of 5): full {ms[False, True]:.2f}"
          f" / shallow {ms[False, False]:.2f} at UNet batch 4, full {ms[True, True]:.2f}"
          f" / shallow {ms[True, False]:.2f} at batch 2; UNet ms per run from these: "
          f"exact {unet_ms['exact']:.1f}, fast {unet_ms['fast']:.1f} "
          f"({unet_ms['exact'] / unet_ms['fast']:.3f}x)", flush=True)


def write_clip_snapshot(root: str) -> None:
    """CLIP ViT-B/32 at its published widths with seeded random weights
    (fp16 on disk), as a composite HF snapshot: config.json, safetensors and
    a character-vocabulary tokenizer at the root."""
    rng = DeviceNormalRng(SEED + 7, "cuda")
    os.makedirs(root, exist_ok=True)
    text = {k: v for k, v in CLIP_TEXT.to_hf().items() if k != "architectures"}
    vision = CLIP_VISION.to_hf()
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump({"architectures": ["CLIPModel"], "model_type": "clip",
                   "projection_dim": 512, "logit_scale_init_value": 2.6592,
                   "text_config": text, "vision_config": vision}, f)
    sd = {**clip_text.init_state_dict(CLIP_TEXT, rng),
          **clip_mod.init_state_dict(CLIP_VISION, rng)}
    sd = {k: torch.as_tensor(v).to(torch.float16) for k, v in sd.items()}
    sd["logit_scale"] = torch.tensor(float(np.log(100.0)), dtype=torch.float16)
    save_safetensors(sd, os.path.join(root, "model.safetensors"))
    write_tokenizer(root, "<|endoftext|>")


@contextlib.contextmanager
def captured(module, name: str, results: list):
    """Keep the return value of every ``module.name`` call of the enclosed
    calls in ``results``."""
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        results.append(fn(*args, **kwargs))
        return results[-1]

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def debias_spy(store: dict):
    """Keep in ``store``, for the enclosed ``debias-sd`` run: run_debias's
    result, a host re-solve at its final acc (``make_collapsed_solver`` on
    the run's own targets and concept embeddings, as a function of acc)
    and, on a mesh, every rank's K/V tensors after the last iteration (read
    before the CLI stops the ranks)."""
    run, resources = debias_mod.run_debias, debias_mod.resources_from_pipe

    def resources_spy(*args, **kwargs):
        store["resources"] = resources(*args, **kwargs)
        return store["resources"]

    def run_spy(pipe, clip_model, edit, attrs, preserve=(), settings=None, **kwargs):
        out = run(pipe, clip_model, edit, attrs, preserve, settings=settings, **kwargs)
        res = store.pop("resources")
        embeds = res.encode_concepts(list(edit) + list(attrs) + list(preserve))
        store["solve"] = debias_mod.make_collapsed_solver(res.targets, embeds, edit, attrs,
                                                          preserve, settings)
        if pipe.mesh is not None:
            store["ranks"] = workers.held_values("unet", list(out[0]), pipe.unet_params)
            store["layout"] = mesh_mod.layout_fn("unet", pipe.unet_config,
                                                 pipe.mesh.n_model)
            store["coords"] = [pipe.mesh.coords(r) for r in range(pipe.mesh.size)]
        store["result"] = out
        return out

    debias_mod.run_debias, debias_mod.resources_from_pipe = run_spy, resources_spy
    try:
        yield
    finally:
        debias_mod.run_debias, debias_mod.resources_from_pipe = run, resources


def arg_of(args: list, flag: str) -> str:
    return args[args.index(flag) + 1]


def debias_cli(snap: str, clip_snap: str, rows: dict, model: Model, args: list, tag: str,
               resident: str = "true", mesh: str | None = None) -> dict:
    """``debias-sd`` through the CLI on the kernel path (``mesh``: with
    ``--mesh``, two ranks of ``cli_mesh_devices``): launches of every rank
    (per iteration and rank: the scheduler's UNet calls and one decode),
    telemetry, diffusers keys; the saved tensors equal bit for bit to a host
    re-solve at the run's own final acc, and on a mesh every rank's K/V
    tensors equal to its shards of them (in the UNet's dtype, as the swap
    casts them). Returns the run's record."""
    steps, n_img = int(arg_of(args, "--num_inference_steps")), int(
        arg_of(args, "--num_images_per_prompt"))
    calls = plan_from_hf(model.scheduler, steps).num_calls
    out = os.path.join(WORK, "debias")
    telemetry = os.path.join(out, f"telemetry_{tag}.csv")
    seen, gn_seen, spied, workers_store = (collections.Counter(), collections.Counter(),
                                           {}, {})
    argv = ["debias-sd", "--model_id", snap, "--clip_model_id", clip_snap, *args,
            "--save_dir", out, "--exp_name", f"debias_{tag}", "--telemetry_path",
            telemetry, "--device_resident", resident, "--device", "cuda"] + (
                ["--mesh", mesh] if mesh else [])
    with cli_mesh_devices(), launches_at_stop(workers_store):
        kernels.reset_launches()
        start = time.perf_counter()
        with conv_shapes(seen, rows["conv3x3"]), gn_shapes(
                gn_seen, rows["group_norm_act"]), finite_decodes(), debias_spy(spied):
            rc = cli_main(argv)
        launches = kernels.launches()
        seconds = time.perf_counter() - start
    weights, acc, history = spied["result"]
    iterations, ranks = len(history), 1 + workers_store.pop("workers", 0)
    concepts = len(arg_of(args, "--edit_concepts").split(";"))
    what = (f"{model.name} debias-sd --device_resident {resident}"
            f"{' --mesh ' + mesh if mesh else ''}, {iterations} iteration(s) x ({calls} "
            f"UNet calls at batch {2 * concepts * n_img // ranks} + 1 decode of "
            f"{concepts * n_img // ranks}) a rank")
    if rc != 0 or iterations != int(arg_of(args, "--max_iterations")):
        raise AssertionError(f"{what}: rc {rc}, {iterations} iterations")
    want = {k: iterations * (calls * model.unet_launches[k] + VAE_LAUNCHES[k])
            for k in model.unet_launches}
    if mesh:
        per_rank(what, launches, workers_store, want, rows, ranks - 1)
    else:
        want["conv3x3_reduce"] = conv_split_sums(seen)
        expect_launches(what, launches, want)
        add_launches(rows, launches)
    with open(telemetry) as f:
        tel = list(csv.reader(f))
    saved = read_safetensors(os.path.join(out, f"debias_{tag}.safetensors"))
    if len(tel) != 1 + concepts * iterations:
        raise AssertionError(f"{what}: telemetry has {len(tel)} lines")
    if len(saved) != model.targets or not all(
            is_sd_cross_attn_kv(k) and k.endswith(".weight")
            and bool(torch.isfinite(v).all()) for k, v in saved.items()):
        raise AssertionError(f"{what}: saved {sorted(saved)[:3]}...")
    host = spied["solve"](acc)
    differ = [k for k in saved if not torch.equal(saved[k], host[k])]
    if saved.keys() != host.keys() or differ:
        raise AssertionError(f"{what}: the saved tensors differ from a host re-solve at "
                             f"the run's final acc at {differ[:3]}")
    note = "equal bit for bit to a host re-solve at the run's final acc"
    if mesh:
        for rank, (got, (_, m)) in enumerate(zip(spied["ranks"], spied["coords"])):
            for k, v in saved.items():
                cast = v.to(torch.bfloat16)
                want_t = mesh_mod.shard_value(cast, spied["layout"](k, cast), m)
                if k not in got or not torch.equal(got[k], want_t.cpu()):
                    raise AssertionError(f"{what}: rank {rank}'s {k} is not its shard of "
                                         "the saved weights")
        note += f"; each of the {ranks} ranks' {len(saved)} K/V tensors its shard of them"
    for h in history:
        sec = h["seconds"]
        print(f"[debias] {what}: iteration {h['iteration']} observed "
              f"{h['observed'].tolist()}; seconds: re-solve {sec['solve']:.4f}, K/V send "
              f"{sec['send']:.4f}, generate {sec['generate']:.4f}, classify "
              f"{sec['classify']:.4f}, total {sum(sec.values()):.4f}")
    print(f"[debias] {what}: {seconds:.2f} s CLI wall (loads included); telemetry "
          f"{len(tel) - 1} rows; {len(saved)} saved tensors {note}; launches {want} a "
          f"rank; {len(seen)} conv and {len(gn_seen)} group_norm_act shapes held to the "
          "plain version on the run's own inputs", flush=True)
    return {"saved": saved, "acc": acc, "history": history, "solve": spied["solve"],
            "seconds": seconds}


def phase_debias(snap: str, clip_snap: str, rows: dict) -> None:
    """SD 1.4 ``debias-sd`` (``debias_cli``): 2 iterations with the re-solve
    on the card; the host path at 1 iteration, whose first measurement and
    saved tensors equal the device run's first and its solver's at that acc;
    then ``--mesh data=2``, 2 iterations, its seconds per phase beside the
    one-rank run's."""
    one = debias_cli(snap, clip_snap, rows, SD14, DEBIAS_ARGS, "true")
    args = DEBIAS_ARGS[:DEBIAS_ARGS.index("--max_iterations")] + ["--max_iterations", "1"]
    host = debias_cli(snap, clip_snap, rows, SD14, args, "false", resident="false")
    first, hfirst = one["history"][0], host["history"][0]
    if not np.array_equal(first["observed"], hfirst["observed"]):
        raise AssertionError("debias-sd: the host path's first measurement "
                             f"{hfirst['observed']} differs from {first['observed']}")
    want = one["solve"](host["acc"])
    differ = [k for k in want if not torch.equal(host["saved"][k], want[k])]
    if differ:
        raise AssertionError(f"debias-sd: the device and host paths differ at {differ[:3]}")
    print(f"[debias] SD 1.4: the host path at 1 iteration measured as the device path's "
          f"first and saved its solver's {SD14.targets} tensors at that acc bit for bit",
          flush=True)
    meshed = debias_cli(snap, clip_snap, rows, SD14, DEBIAS_ARGS, "mesh", mesh="data=2")
    last = lambda run, key: run["history"][-1]["seconds"][key]
    print("[debias] SD 1.4 s of the last (warm) iteration, data=1 vs data=2 ("
          + pipe_mesh_note(2, 1) + "): "
          + "; ".join(f"{k} {last(one, k):.4f} vs {last(meshed, k):.4f}"
                      for k in ("solve", "send", "generate", "classify"))
          + f"; observed alike at every iteration: "
          f"{all(np.array_equal(a['observed'], b['observed']) for a, b in zip(one['history'], meshed['history']))}",
          flush=True)


def phase_debias_sdxl(snap: str, clip_snap: str, rows: dict) -> None:
    """SDXL ``debias-sd`` at 1024^2 with the SD 1.4 run's CLIP classifier
    (``debias_cli``), 1 iteration with the re-solve on the card and on the
    host: the same saved tensors bit for bit."""
    runs = {r: debias_cli(snap, clip_snap, rows, SDXL, SDXL_DEBIAS_ARGS, f"sdxl_{r}",
                          resident=r) for r in ("true", "false")}
    a, b = runs["true"]["saved"], runs["false"]["saved"]
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if a.keys() != b.keys() or differ:
        raise AssertionError(f"SDXL debias-sd: the device and host paths differ at {differ[:3]}")
    print(f"[debias] SDXL: the device-resident and host paths saved the same "
          f"{SDXL.targets} tensors bit for bit", flush=True)


def phase_clip_classify(clip_snap: str, folder: str, cases: list) -> None:
    """``eval-clip-classify`` over a folder of generate's PNGs."""
    out = os.path.join(WORK, "classify.csv")
    start = time.perf_counter()
    rc = cli_main(["eval-clip-classify", "--image_folder", folder, "--attributes",
                   "a man, a woman", "--clip_model_id", clip_snap, "--save_path", out,
                   "--device", "cuda"])
    with open(out) as f:
        table = list(csv.reader(f))
    if rc != 0 or table[0] != ["case_number", "a_man_bias", "a_woman_bias"] or [
            int(r[0]) for r in table[1:]] != sorted(c for c, _, _ in cases) or not all(
            float(r[1]) + float(r[2]) == 1.0 for r in table[1:]):
        raise AssertionError(f"eval-clip-classify: rc {rc}, {table}")
    print(f"[classify] eval-clip-classify over {len(cases)} PNGs: {table} in "
          f"{time.perf_counter() - start:.2f} s (CLI wall, load included)", flush=True)


# The comparison baselines on SD 1.4 (unedited, random weights at full
# width) through their CLIs, each row one pipeline call: SLD (Medium, 50
# PNDM steps, UNet batch 3), concept algebra (LMS, UNet batch 5 at
# --num_samples 1 and 10 at 2) and debias-VL (the 80 default professions,
# LMS, UNet batch 2), the two LMS ones cut from their 100 steps to 25 for
# the script's time. Per row: the plan's calls x the UNet's
# launches + one decode at batch num_samples (counted on meta tensors at
# these batches in tests/test_torch_baselines.py: the same per forward as
# at batch 2).
SLD_STEPS = 50
BASELINE_STEPS = 25
# (CLI command, extra flags, scheduler of the plan, steps, images per row,
# rows run, save folder under the run's directory)
BASELINE_RUNS = [
    ("sld-generate", ["--sld_type", "Medium"], None, SLD_STEPS, 1, 2, "SLD_Medium_None"),
    ("concept-algebra", ["--num_samples", "1"], "lms", BASELINE_STEPS, 1, 2, "sd14_random"),
    ("concept-algebra", ["--num_samples", "2", "--till_case", "0"], "lms", BASELINE_STEPS,
     2, 1, "sd14_random"),
    ("debias-vl", [], "lms", BASELINE_STEPS, 1, 2, "sd14_random"),
]
# SLD past its warmup is held bit for bit to CFG over the same UNet batch of
# 3, and to cfg at UNet batch 2 only within the paths bound (REL_L2_MAX): on
# this random-weight model a last-bit change of each step's eps moves a
# 50-step image by uint8 levels, not fractions of one (the control printed
# beside it: cfg with its branches' difference rounded to bf16, as uce_tpu's
# cfg_combine rounds it; PERF.md §6, PR 12).
# A guidance combine on the card against a float64 evaluation of the same
# formula with uce_tpu's bf16 roundings: each bf16 step of the combine is a
# correctly rounded operation of bf16 inputs, so only the fp32 steps differ
# (~1e-7 relative); concept algebra's fp32 whole-tensor sums may also flip
# the bf16 rounding of the projected text, one bf16 ulp (2^-7 relative at
# most) times the guidance scale, on a few elements.
COMBINE_REL = 1e-5
COMBINE_FLIPS_MAX = 0.01
# The calls captured for that check: SLD's 21st (active past Medium's
# warmup of 10, momentum carried), concept algebra's 13th (mid-run of its
# BASELINE_STEPS calls).
SLD_CAPTURE_CALL, CA_CAPTURE_CALL = 20, 12
# Eval metrics: the card's fp32 run (TF32 off) against the port's CPU run of
# the same command, relative difference of every number in the CSV.
EVAL_REL = 1e-4
EVAL_DEVICES = (("card", "cuda"), ("host", "cpu"))
EVAL_IMAGENET_LABELS = [207, 497]


def baseline_dir(path: str, i: int) -> str:
    """Where the ``i``-th run of ``BASELINE_RUNS`` on ``path`` writes."""
    command, _, _, _, _, _, folder = BASELINE_RUNS[i]
    return os.path.join(WORK, f"baselines_{path}", f"{i}_{command}", folder)


@contextlib.contextmanager
def pipe_calls(records: list, cls=SDPipeline, name: str = "__call__"):
    """Record (seconds, images) of every call of a pipeline class's method
    (SDPipeline's ``__call__`` by default) in the enclosed calls (the CLIs'
    and the server's: seconds after the load)."""
    call = getattr(cls, name)

    @functools.wraps(call)  # the server adapts to the call's signature
    def spy(self, *args, **kwargs):
        start = time.perf_counter()
        images = call(self, *args, **kwargs)
        records.append((time.perf_counter() - start, images))
        return images

    setattr(cls, name, spy)
    try:
        yield
    finally:
        setattr(cls, name, call)


@contextlib.contextmanager
def nth_call(module, name: str, n: int, store: dict):
    """Keep the arguments (cloned) and the result of the ``n``-th call of
    ``module.name`` in the enclosed calls."""
    fn, count = getattr(module, name), [0]

    def spy(*args):
        out = fn(*args)
        if count[0] == n:
            store["args"] = [a.clone() if torch.is_tensor(a) else a for a in args]
            store["out"] = out
        count[0] += 1
        return out

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, fn)


def bf16_round(x) -> np.ndarray:
    return torch.as_tensor(np.asarray(x, np.float64)).to(torch.bfloat16).double().numpy()


def f64(t: torch.Tensor) -> np.ndarray:
    return t.double().cpu().numpy()


def check_sld_combine(store: dict) -> str:
    """The captured sld_combine call against float64 with uce_tpu's bf16
    roundings (the branches, the guidance, diff, scale and the safety
    guidance in bf16; the momentum and the combine in fp32)."""
    eps, gs, i, mom, cfg = store["args"]
    got_eps, got_mom = (f64(t) for t in store["out"])
    u, t, s = np.split(f64(eps), 3)
    m = f64(mom)
    guidance = bf16_round(t - u)
    diff = bf16_round(t - s)
    scale = np.minimum(bf16_round(np.abs(diff) * bf16_round(cfg.sld_guidance_scale)), 1.0)
    safety_scale = np.where(diff >= bf16_round(cfg.sld_threshold), 0.0, scale)
    g_safe = bf16_round(bf16_round(s - u) * safety_scale) + cfg.sld_momentum_scale * m
    want_mom = cfg.sld_mom_beta * m + (1.0 - cfg.sld_mom_beta) * g_safe
    if i >= cfg.sld_warmup_steps:
        guidance = guidance - g_safe
    want_eps = u + gs * guidance
    errs = []
    for what, got, want in (("eps", got_eps, want_eps), ("momentum", got_mom, want_mom)):
        err = float(np.abs(got - want).max() / np.abs(want).max())
        if not err <= COMBINE_REL:
            raise AssertionError(f"sld_combine call {i}: {what} rel max err {err} > "
                                 f"{COMBINE_REL}")
        errs.append(f"{what} {err:.2e}")
    active = int((safety_scale != 0).sum())
    return (f"sld_combine at call {i} (warmup {cfg.sld_warmup_steps}): rel max err "
            f"{', '.join(errs)} (bound {COMBINE_REL}); safety scale non-zero on "
            f"{active} of {safety_scale.size} elements")


def check_concept_algebra_combine(store: dict) -> str:
    """The captured concept_algebra_combine call against float64 with
    uce_tpu's bf16 roundings: the whole-tensor norm and projection, the
    projected text and (text - uncond) rounded to bf16."""
    eps, gs = store["args"]
    got = f64(store["out"])
    u, t, p0, p1, p2 = np.split(f64(eps), 5)
    noise = bf16_round(t - p2)
    direction = bf16_round(p1 - p0)
    direction = direction / np.sqrt((direction ** 2).sum())
    proj = (noise * direction).sum()
    text = bf16_round(t - proj * direction)
    want = u + gs * bf16_round(text - u)
    err = np.abs(got - want)
    tol = COMBINE_REL * np.abs(want).max()
    flips = err > tol
    flip_bound = gs * 2.0 ** -7 * (2 * np.abs(text) + np.abs(u)) + tol
    if (err > flip_bound).any() or flips.mean() > COMBINE_FLIPS_MAX:
        raise AssertionError(f"concept_algebra_combine: max err {err.max()}, "
                             f"{int(flips.sum())} elements beyond {tol}")
    return (f"concept_algebra_combine (batch {u.shape[0]}, projection {proj:.6f}): max "
            f"abs err {err.max():.3e}; {int(flips.sum())} of {err.size} elements beyond "
            f"{COMBINE_REL} x max |ref| (one bf16 rounding of the projected text flipped "
            "by the fp32 sums), each within its flip bound")


def phase_baseline(snap: str, csv_path: str, path: str, i: int, rows: dict,
                   captures: dict | None = None) -> tuple[dict, float]:
    """The ``i``-th run of ``BASELINE_RUNS`` through the CLI on ``path``: its
    folder and PNG names, finite decodes, every kernel's launches, the first
    call of each kernel at each new shape held to its plain version on the
    run's own inputs; with ``captures``, one sld_combine or
    concept_algebra_combine call kept for ``check_*_combine``."""
    command, extra, scheduler, steps, images, rows_n, _ = BASELINE_RUNS[i]
    out = baseline_dir(path, i)
    plan = (plan_from_hf(SD14.scheduler, steps) if scheduler is None
            else plan_from_hf_as(scheduler, SD14.scheduler, steps))
    per_call, per_decode = SD14.unet_launches, VAE_LAUNCHES
    if path != "kernels":
        per_call, per_decode = library_launches(per_call), VAE_LAUNCHES_LIBRARY
    want = {k: rows_n * (plan.num_calls * per_call[k] + per_decode[k]) for k in per_call}
    want["sd_attention_d512"] = rows_n
    seen, gn_seen, attn_seen, records = (collections.Counter(), collections.Counter(),
                                         collections.Counter(), [])
    with contextlib.ExitStack() as stack:
        stack.enter_context(path_route(path))
        for ctx in (conv_shapes(seen, rows["conv3x3"]),
                    gn_shapes(gn_seen, rows["group_norm_act"]),
                    attention_calls(attn_seen, rows), finite_decodes(), pipe_calls(records)):
            stack.enter_context(ctx)
        if captures is not None and command == "sld-generate":
            stack.enter_context(nth_call(guidance, "sld_combine", SLD_CAPTURE_CALL,
                                         captures))
        if captures is not None and command == "concept-algebra":
            stack.enter_context(nth_call(guidance, "concept_algebra_combine",
                                         CA_CAPTURE_CALL, captures))
        kernels.reset_launches()
        start = time.perf_counter()
        rc = cli_main([command, "--model_name", snap, "--prompts_path", csv_path,
                       "--save_path", os.path.dirname(out), "--ddim_steps", str(steps),
                       "--image_size", str(SD14.size), "--device", "cuda", *extra])
        launches = kernels.launches()
        seconds = time.perf_counter() - start
    if path == "kernels":
        want["conv3x3_reduce"] = conv_split_sums(seen)
    what = (f"{' '.join([command, *extra])} ({path}, {plan.kind}): {rows_n} rows x "
            f"({plan.num_calls} UNet calls + 1 decode of {images})")
    if rc != 0 or (captures is not None and "out" not in captures):
        raise AssertionError(f"{what}: rc {rc}, combine captured "
                             f"{captures is None or 'out' in captures}")
    expect_launches(what, launches, want)
    names = sorted(os.listdir(out))
    want_names = sorted(f"{c}_{n}.png" for c in range(rows_n) for n in range(images))
    if names != want_names or len(records) != rows_n:
        raise AssertionError(f"{what}: {out} holds {names}, {len(records)} calls")
    for name in names:
        img = load_image(os.path.join(out, name))
        if img.shape != (SD14.size, SD14.size, 3) or img.std() == 0:
            raise AssertionError(f"{what}: {name} is {img.shape}, std {img.std()}")
    # the last call's seconds: with two rows, after the first has held every
    # new shape to its plain version; with one, those checks included
    per_image = records[-1][0] / images
    print(f"[baseline] {what}: {rows_n * images} PNGs in {os.path.relpath(out, WORK)}; "
          f"{seconds:.2f} s CLI wall (load included), {per_image:.3f} s per image in the "
          f"last of {rows_n} calls; launches {want}; {len(seen)} conv, {len(gn_seen)} "
          f"group_norm_act and {len(attn_seen)} attention shapes held to the plain "
          f"version ({sorted(attn_seen)})", flush=True)
    return launches, per_image


def image_distance(a: np.ndarray, b: np.ndarray) -> tuple[float, int]:
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    return float(d.mean()), int(d.max())


@contextlib.contextmanager
def swapped(module, name: str, fn):
    """``module.name`` replaced by ``fn`` in the enclosed calls."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def cfg_of_three(eps_branches, guidance_scale, step_index, momentum, cfg):
    """uce_tpu's cfg_combine (the difference in the model dtype) on the
    first two of SLD's three branches, in place of ``sld_combine``."""
    uncond, text, _ = eps_branches.chunk(3)
    return uncond.float() + guidance_scale * (text - uncond).float(), momentum


def cfg_bf16_difference(eps_branches, guidance_scale):
    """uce_tpu's cfg_combine on the port's fp32 view of bf16 branches: the
    difference rounded to bf16 (the control of the identities)."""
    uncond, cond = eps_branches.chunk(2)
    return uncond + guidance_scale * (cond - uncond).to(torch.bfloat16).float()


def phase_baseline_identities(pipe, path: str) -> dict:
    """On ``path``: debias_vl with P = I equal to cfg (LMS) bit for bit; SLD
    with its warmup past the last call equal, bit for bit, to CFG over the
    same three-branch UNet batch (uce_tpu's cfg_combine on its first two
    branches), and within the paths bound of cfg at UNet batch 2; the
    seconds of the cfg and SLD calls."""
    kw = dict(height=SD14.size, width=SD14.size, seed=[1], guidance_scale=7.5)
    prompt = ["a painting by kelly mckernan"]
    out = {}
    with path_route(path):
        cfg_lms = pipe(prompt, num_inference_steps=20, scheduler="lms", **kw)
        dvl = pipe(prompt, num_inference_steps=20, scheduler="lms", mode="debias_vl",
                   debias_projection=np.eye(pipe.text_config.hidden_size), **kw)
        if not np.array_equal(cfg_lms, dvl):
            raise AssertionError(f"debias_vl with P = I ({path}): not cfg bit for bit "
                                 f"(mean, max |diff| {image_distance(cfg_lms, dvl)})")
        calls = plan_from_hf(SD14.scheduler, SLD_STEPS).num_calls
        sld = {"mode": "sld", "sld_config": dataclasses.replace(
            guidance.SLDConfig.preset("Medium"), sld_warmup_steps=calls)}
        times = {}
        for mode in ("cfg", "sld"):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out[mode] = pipe(prompt, num_inference_steps=SLD_STEPS, **kw,
                             **(sld if mode == "sld" else {}))
            times[mode] = time.perf_counter() - start
        with swapped(guidance, "sld_combine", cfg_of_three):
            out["cfg3"] = pipe(prompt, num_inference_steps=SLD_STEPS, **kw, **sld)
        with swapped(sampler, "cfg_combine", cfg_bf16_difference):
            out["control"] = pipe(prompt, num_inference_steps=SLD_STEPS, **kw)
    if not np.array_equal(out["sld"], out["cfg3"]):
        raise AssertionError(f"SLD past its warmup ({path}): not CFG over the same batch "
                             f"bit for bit ({image_distance(out['sld'], out['cfg3'])})")
    rel = rel_l2(torch.from_numpy(out["sld"]).float(), torch.from_numpy(out["cfg"]).float())
    mean, worst = image_distance(out["sld"], out["cfg"])
    if rel > REL_L2_MAX:
        raise AssertionError(f"SLD past its warmup ({path}) vs cfg: rel L2 {rel} > "
                             f"{REL_L2_MAX}")
    c_mean, c_worst = image_distance(out["control"], out["cfg"])
    print(f"[baseline] identities ({path}): debias_vl with P = I equals cfg (LMS, 20 "
          f"steps) bit for bit; SLD with warmup {calls} (past the last of {calls} PNDM "
          f"calls) equals CFG over the same UNet batch of 3 bit for bit, and is rel L2 "
          f"{rel:.3e} (bound {REL_L2_MAX}), mean |diff| {mean:.4f} uint8 levels, max "
          f"{worst} from cfg at batch 2; control, cfg with its difference rounded to "
          f"bf16: mean |diff| {c_mean:.4f}, max {c_worst}; one image, {SLD_STEPS} PNDM "
          f"steps: cfg {times['cfg']:.3f} s (UNet batch 2), SLD {times['sld']:.3f} s "
          "(batch 3)", flush=True)
    return times


def write_eval_weights(root: str) -> dict:
    """LPIPS (AlexNet + lins), VGG19 and ResNet-50 at their published widths,
    seeded random weights, as .pth files in the lpips/torchvision key
    layouts."""
    rng = np.random.default_rng(SEED + 12)
    os.makedirs(root, exist_ok=True)
    paths = {}
    for name, sd in (("lpips", lpips_mod.init_lpips_state_dict(rng)),
                     ("vgg19", vision_backbones.init_vgg19_state_dict(rng)),
                     ("resnet50", vision_backbones.init_resnet50_state_dict(rng))):
        paths[name] = os.path.join(root, f"{name}.pth")
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, paths[name])
    return paths


def read_table(path: str) -> list[list[str]]:
    with open(path, newline="") as f:
        return list(csv.reader(f))


def hold_card_to_cpu(what: str, card_rows: list, cpu_rows: list, header: list) -> float:
    """Every number of the card's CSV within EVAL_REL of the CPU's, every
    other cell equal; returns the largest relative difference."""
    worst = 0.0
    if len(card_rows) != len(cpu_rows):
        raise AssertionError(f"{what}: {len(card_rows)} rows on the card, "
                             f"{len(cpu_rows)} on the CPU")
    for a_row, b_row in zip(card_rows, cpu_rows):
        for name, a, b in zip(header, a_row, b_row):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                fa = fb = None
            if fa is None or name in ("case_number", "num", "evaluation_seed") or (
                    name.startswith("index_top")):
                if a != b:
                    raise AssertionError(f"{what}: {name} {a!r} on the card, {b!r} on "
                                         "the CPU")
                continue
            rel = abs(fa - fb) / max(abs(fb), 1e-30)
            worst = max(worst, rel)
            if not rel <= EVAL_REL:
                raise AssertionError(f"{what}: {name} {fa} on the card, {fb} on the CPU "
                                     f"(rel {rel} > {EVAL_REL})")
    return worst


def eval_cli(command: str, args: list, device: str) -> tuple[str, float]:
    """One eval command through the CLI; (its standard output, seconds)."""
    buf = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([command, *args, "--device", device])
    seconds = time.perf_counter() - start
    if rc != 0:
        raise AssertionError(f"{command} --device {device}: rc {rc}")
    return buf.getvalue(), seconds


def phase_eval(original: str, folders: dict, csv_path: str, clip_snap: str) -> None:
    """The four eval commands over the baselines' folders on the card, each
    held to the port's own CPU run of the same command; LPIPS of a folder
    against itself exactly 0; the CSVs' columns as uce_tpu writes them; no
    kernel launch (the eval convs are fp32 ``F.conv2d``)."""
    weights = write_eval_weights(os.path.join(WORK, "eval_weights"))
    out = os.path.join(WORK, "eval")
    os.makedirs(out, exist_ok=True)
    prompt_header = read_table(csv_path)[0]
    top5 = [f"{c}_top{i}" for i in range(1, 6) for c in ("category", "index", "scores")]
    runs = [
        ("eval-lpips", ["--original_path", original, "--edited_path", folders["sld"],
                        "--weights", weights["lpips"], "--prompts_path", csv_path],
         prompt_header + ["lpips_loss"]),
        ("eval-styleloss", ["--original_path", original, "--edited_path", folders["ca"],
                            "--weights", weights["vgg19"], "--prompts_path", csv_path],
         prompt_header + ["style_loss", "content_loss", "total_loss"]),
        ("eval-imageclassify", ["--image_folder", folders["ca2"], "--weights",
                                weights["resnet50"], "--prompts_path", csv_path],
         prompt_header + ["num"] + top5 + ["correct"]),
    ]
    with kernels.route(LIBRARY_OFF):
        kernels.reset_launches()
        for command, args, header in runs:
            tables, secs = {}, {}
            for key, device in EVAL_DEVICES:
                save = os.path.join(out, f"{command}_{key}.csv")
                _, secs[key] = eval_cli(command, [*args, "--save_path", save], device)
                tables[key] = read_table(save)
            if tables["card"][0] != header:
                raise AssertionError(f"{command}: columns {tables['card'][0]}, want {header}")
            worst = hold_card_to_cpu(command, tables["card"][1:], tables["host"][1:], header)
            print(f"[eval] {command}: {len(tables['card']) - 1} rows, columns as uce_tpu's; "
                  f"card {secs['card']:.2f} s, CPU {secs['host']:.2f} s (CLI wall, load "
                  f"included); card vs CPU rel max {worst:.3e} (bound {EVAL_REL}); "
                  f"{tables['card'][1:]}", flush=True)
        save = os.path.join(out, "lpips_self.csv")
        eval_cli("eval-lpips", ["--original_path", original, "--edited_path", original,
                                "--weights", weights["lpips"], "--save_path", save], "cuda")
        self_rows = read_table(save)[1:]
        if not self_rows or any(float(r[1]) != 0.0 for r in self_rows):
            raise AssertionError(f"eval-lpips of a folder against itself: {self_rows}")
        scores, secs = {}, {}
        for key, device in EVAL_DEVICES:
            text, secs[key] = eval_cli(
                "eval-clip-score", ["--image_folder", folders["dvl"], "--prompts_path",
                                    csv_path, "--clip_model_id", clip_snap], device)
            scores[key] = float(text.split("mean CLIP score:")[-1])
        rel = abs(scores["card"] - scores["host"]) / abs(scores["host"])
        if not rel <= EVAL_REL:
            raise AssertionError(f"eval-clip-score: {scores} (rel {rel} > {EVAL_REL})")
        launches = kernels.launches()
    if any(launches.values()):
        raise AssertionError(f"the eval commands launched kernels: {launches}")
    print(f"[eval] eval-lpips of a folder against itself: {len(self_rows)} cases, all 0.0; "
          f"eval-clip-score: card {scores['card']!r}, CPU {scores['host']!r} (rel "
          f"{rel:.3e}, bound {EVAL_REL}; card {secs['card']:.2f} s, CPU {secs['host']:.2f} "
          "s); no kernel launched", flush=True)


# NudeNet's detector: YOLOv8-n at 320 (nudenet 3.x's 320n.onnx), 18 classes
NUDENET_SIZE = 320
NUDENET_BATCH = 16
# DreamSim's ensemble: three ViT-B/16 at 224, with tools/convert_dreamsim.py's
# per-family normalizations
VIT_B16 = dict(depth=12, dim=768, heads=12, patch=16, image=224, mlp_ratio=4)
_IMAGENET_NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
_CLIP_NORM = ((0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711))
DREAMSIM_MODELS = {"dino_vitb16": _IMAGENET_NORM, "clip_vitb16": _CLIP_NORM,
                   "open_clip_vitb16": _CLIP_NORM}
# DreamSim of a folder against itself (1 - cos of an embedding with itself)
DREAMSIM_SELF_MAX = 1e-6


# Class logits above the score gate per image: a trained detector passes a
# few anchors of the 2100 x 18 (the random head's bias is set to this share)
NUDENET_GATED_PER_IMAGE = 8


def unit_variance_detector(sd: dict, canvases: np.ndarray) -> dict:
    """YOLOv8-n weights with each conv rescaled, in forward order on
    ``canvases``, to outputs of unit variance (LSUV, Mishkin and Matas
    2015), and the class head's bias set so that about
    NUDENET_GATED_PER_IMAGE class logits per canvas pass the score gate.
    ``init_yolo_state``'s draws as they are give a degenerate detector:
    its activations fade with depth, every anchor scores 0.51 +- 0.01 and
    NMS orders some 2000 boxes by their last bits (``phase_nudenet`` prints
    it beside)."""
    params = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    key_of = {id(v): k.rsplit(".", 1)[0] for k, v in params.items()
              if k.endswith("weight") and not k.startswith("model.22.dfl")}
    done = set()

    def conv2d(x, w, b=None, stride=1, padding=1):
        y = F.conv2d(x, w, b, stride=stride, padding=padding)
        name = key_of[id(w)]
        if name not in done:
            done.add(name)
            scale = 1.0 / float(y.std())
            w.mul_(scale)
            b.mul_(scale)
            y = y * scale
        return y

    with swapped(yolo, "conv2d", conv2d), torch.no_grad():
        outs = yolo.yolo_raw(params, torch.from_numpy(canvases).permute(0, 3, 1, 2))
    nc = len(yolo.NUDENET_LABELS)
    logits = torch.cat([o[:, 4 * yolo.REG_MAX:].flatten(2) for o in outs], dim=2)
    # the gate midway between two neighbouring logits, so no anchor of
    # these canvases sits at it
    ranked = logits.flatten().double().sort(descending=True).values
    k = NUDENET_GATED_PER_IMAGE * logits.shape[0]
    cut = float(ranked[k - 1] + ranked[k]) / 2
    gate_logit = math.log(0.2 / 0.8)
    for i in range(len(yolo.STRIDES)):
        params[f"model.22.cv3.{i}.2.bias"] += gate_logit - cut
    if len(done) != len(key_of) or params["model.22.cv3.0.2.bias"].numel() != nc:
        raise AssertionError(f"{len(key_of) - len(done)} convs not calibrated")
    return {k: v.numpy() for k, v in params.items()}


def write_nudenet_weights(path: str, sd: dict) -> None:
    """YOLOv8-n weights as tools/convert_nudenet.py writes them."""
    save_safetensors(sd, path, metadata={
        "labels": ",".join(yolo.NUDENET_LABELS), "source": "random",
        "input_size": str(NUDENET_SIZE)})


def write_dreamsim_weights(path: str) -> None:
    """Seeded random ViT-B/16 ensemble as tools/convert_dreamsim.py writes it."""
    rng = np.random.default_rng(SEED + 14)
    tensors, meta = {}, {"models": ",".join(DREAMSIM_MODELS)}
    for name, (mean, std) in DREAMSIM_MODELS.items():
        sd = vision_backbones.init_vit_timm(rng, **VIT_B16)
        tensors.update({f"{name}/{k}": v for k, v in sd.items()})
        meta[f"{name}.num_heads"] = str(VIT_B16["heads"])
        meta[f"{name}.mean"] = ",".join(map(str, mean))
        meta[f"{name}.std"] = ",".join(map(str, std))
    save_safetensors(tensors, path, metadata=meta)


def start_fresh(args: list, log: str) -> tuple:
    """Start one command on the card in a new process (torch's default
    precision settings, not this script's), its output to ``log``; the new
    processes of the eval suite run at once, beside its in-process work."""
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "uce_tpu_torch", *args], cwd=ROOT,
                                stdout=f, stderr=subprocess.STDOUT, text=True)
    return args, log, proc, time.perf_counter()


def finish_fresh(started: tuple) -> tuple[float, str]:
    """Wait for a ``start_fresh`` command: (its seconds, its output)."""
    args, log, proc, start = started
    rc = proc.wait(timeout=600)
    seconds = time.perf_counter() - start
    with open(log) as f:
        out = f.read()
    if rc != 0:
        raise AssertionError(f"{args[0]} in a new process: rc {rc}\n{out[-3000:]}")
    return seconds, out


def host_seconds(fn, reps: int = 3) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        fn()
        times.append(time.perf_counter() - start)
    return float(np.median(times))


def gate_stats(scores: np.ndarray, gate: float) -> tuple[int, float, int]:
    """Per canvas [A] max class scores -> (most anchors of a canvas past the
    gate, the smallest nonzero gap between a canvas's gated scores, exact
    ties). NMS visits the boxes by score, so its result holds while two
    sides' scores differ by less than that gap."""
    gated = [np.sort(s[s >= gate]) for s in scores]
    gaps = np.concatenate([np.diff(g) for g in gated])
    gap = float(gaps[gaps > 0].min()) if (gaps > 0).any() else float("inf")
    return max(len(g) for g in gated), gap, int((gaps == 0).sum())


def label_lists(raw: np.ndarray) -> list[list[str]]:
    """The classes NMS keeps on each canvas of a decoded output."""
    return [[d["class"] for d in yolo.postprocess(r, 1.0, 0, 0)] for r in raw]


def phase_nudenet(folders: dict, csv_path: str, root: str) -> None:
    """eval-nudenet over the baselines' folders on the card, on the CPU and
    in a new process on the card: the CSVs equal cell for cell; the raw
    detector output on the same canvases within EVAL_REL; seconds per image
    at batch 16; how near the gate and each other the scores come. Then the
    same for ``init_yolo_state``'s draws as they are, printed only."""
    paths = sorted(os.path.join(folders[k], n) for k in ("sld", "ca", "ca2", "dvl")
                   for n in os.listdir(folders[k]) if n.endswith(".png"))
    canvases = np.stack([yolo.letterbox(load_image(p), NUDENET_SIZE)[0] for p in paths])
    drawn = yolo.init_yolo_state(seed=SEED + 13)
    weights = os.path.join(root, "nudenet_320n.safetensors")
    write_nudenet_weights(weights, unit_variance_detector(drawn, canvases))
    dets = {k: nudenet_mod.NudeDetector(weights, device=d) for k, d in EVAL_DEVICES}
    raw = {k: det.raw(canvases) for k, det in dets.items()}
    want_shape = (len(paths), sum((NUDENET_SIZE // s) ** 2 for s in yolo.STRIDES),
                  4 + len(yolo.NUDENET_LABELS))
    if raw["card"].shape != want_shape or not np.isfinite(raw["card"]).all():
        raise AssertionError(f"NudeNet raw output {raw['card'].shape}, want {want_shape}")
    # the boxes' error as a share of the canvas, the scores' absolute (both
    # in [0, 1]); beside it, each number's error relative to max(|x|, 1)
    diff = np.abs(raw["card"] - raw["host"])
    box_err = float(diff[..., :4].max()) / NUDENET_SIZE
    score_diff = float(diff[..., 4:].max())
    err = max(box_err, score_diff)
    elementwise = float((diff / np.maximum(np.abs(raw["host"]), 1)).max())
    gate = dets["card"].score_threshold
    scores = raw["card"][..., 4:].max(-1)
    gated, gap, ties = gate_stats(scores, gate)
    near = float(np.abs(scores - gate).min())
    batch = canvases[np.arange(NUDENET_BATCH) % len(canvases)]
    card_s = median_ms(lambda: dets["card"].raw(batch), reps=5) / 1e3
    cpu_s = host_seconds(lambda: dets["host"].raw(batch))
    print(f"[eval] NudeNet YOLOv8-n raw output {raw['card'].shape} on {len(paths)} canvases: "
          f"card vs CPU boxes {box_err:.3e} of the canvas, scores {score_diff:.3e} (bound "
          f"{EVAL_REL}; each number relative to max(|x|, 1) {elementwise:.3e}); up to {gated} anchors a canvas past the {gate} gate, the "
          f"nearest {near:.3e} from it, the smallest gap between a canvas's gated scores "
          f"{gap:.3e} ({ties} exact ties); batch {NUDENET_BATCH}: card "
          f"{card_s / NUDENET_BATCH * 1e3:.3f} ms per image ({card_s * 1e3:.2f} ms a batch, "
          f"host copies included), CPU {cpu_s / NUDENET_BATCH * 1e3:.2f} ms per image "
          f"({cpu_s:.3f} s a batch)", flush=True)
    if not err <= EVAL_REL:
        raise AssertionError(f"NudeNet raw output card vs CPU: {err} > {EVAL_REL}")

    drawn_path = os.path.join(root, "nudenet_drawn.safetensors")
    write_nudenet_weights(drawn_path, drawn)
    drawn_dets = {k: nudenet_mod.NudeDetector(drawn_path, device=d) for k, d in EVAL_DEVICES}
    drawn_raw = {k: det.raw(canvases) for k, det in drawn_dets.items()}
    d_scores = drawn_raw["card"][..., 4:].max(-1)
    d_gated, d_gap, d_ties = gate_stats(d_scores, gate)
    d_labels = {k: label_lists(r) for k, r in drawn_raw.items()}
    print(f"[eval] NudeNet with init_yolo_state's draws as they are (printed, not held): "
          f"scores {d_scores.min():.5f}-{d_scores.max():.5f}, up to {d_gated} anchors a canvas "
          f"past the gate, the smallest gap {d_gap:.3e} ({d_ties} exact ties), card vs CPU "
          f"scores {np.abs(drawn_raw['card'][..., 4:] - drawn_raw['host'][..., 4:]).max():.3e}; "
          f"kept boxes per canvas {[len(v) for v in d_labels['card']]}; the label lists differ "
          f"card vs CPU on {sum(a != b for a, b in zip(d_labels['card'], d_labels['host']))} "
          f"of {len(paths)} canvases", flush=True)

    header = read_table(csv_path)[0] + ["NudeNet_label"]
    mismatches = []
    runs = {key: ["--image_folder", folders[key], "--prompts_path", csv_path, "--weights",
                  weights, "--num_samples", str(samples)]
            for key, samples in (("sld", 1), ("ca", 1), ("ca2", 2), ("dvl", 1))}
    fresh = {key: start_fresh(["eval-nudenet", *args, "--save_path",
                               os.path.join(root, f"nudenet_{key}_fresh.csv")],
                              os.path.join(root, f"nudenet_{key}_fresh.log"))
             for key, args in runs.items()}
    for key, args in runs.items():
        tables, secs = {}, {}
        for dev_key, device in EVAL_DEVICES:
            save = os.path.join(root, f"nudenet_{key}_{dev_key}.csv")
            _, secs[dev_key] = eval_cli("eval-nudenet", [*args, "--save_path", save], device)
            tables[dev_key] = read_table(save)
        secs["fresh"] = finish_fresh(fresh[key])[0]
        tables["fresh"] = read_table(os.path.join(root, f"nudenet_{key}_fresh.csv"))
        if tables["card"][0] != header:
            raise AssertionError(f"eval-nudenet: columns {tables['card'][0]}, want {header}")
        mismatches += [(key, other) for other in ("host", "fresh")
                       if tables["card"] != tables[other]]
        found = [r[-1].split("-") if r[-1] else [] for r in tables["card"][1:]]
        print(f"[eval] eval-nudenet {key}: {len(found)} rows, the card's CSV "
              f"{'equal' if not mismatches else 'UNEQUAL'} to the CPU's and the new "
              f"process's; card {secs['card']:.2f} s, CPU {secs['host']:.2f} s, new process "
              f"{secs['fresh']:.2f} s (CLI wall, the new processes at once); labels "
              f"{[r[-1] for r in tables['card'][1:]]}",
              flush=True)
    if mismatches:
        raise AssertionError(f"eval-nudenet: the card's CSV differs from {mismatches}")


def dreamsim_args(original: str, edited: str, csv_path: str, root: str) -> list:
    return ["--original_path", original, "--edited_path", edited, "--weights",
            os.path.join(root, "dreamsim_ensemble.safetensors"), "--prompts_path", csv_path]


def phase_dreamsim(original: str, edited: str, csv_path: str, root: str,
                   started: tuple) -> None:
    """eval-dreamsim, original against edited, on the card, on the CPU and in
    a new process on the card (``started`` by the suite), within
    EVAL_REL; a folder against itself at most DREAMSIM_SELF_MAX; seconds per
    image pair, card against CPU."""
    args = dreamsim_args(original, edited, csv_path, root)
    weights = args[args.index("--weights") + 1]
    header = read_table(csv_path)[0] + ["dream_loss"]
    tables, secs = {}, {}
    for key, device in EVAL_DEVICES:
        save = os.path.join(root, f"dreamsim_{key}.csv")
        _, secs[key] = eval_cli("eval-dreamsim", [*args, "--save_path", save], device)
        tables[key] = read_table(save)
    secs["fresh"] = finish_fresh(started)[0]
    tables["fresh"] = read_table(os.path.join(root, "dreamsim_fresh.csv"))
    if tables["card"][0] != header:
        raise AssertionError(f"eval-dreamsim: columns {tables['card'][0]}, want {header}")
    worst = hold_card_to_cpu("eval-dreamsim", tables["card"][1:], tables["host"][1:], header)
    fresh = hold_card_to_cpu("eval-dreamsim (new process)", tables["fresh"][1:],
                             tables["host"][1:], header)
    save = os.path.join(root, "dreamsim_self.csv")
    eval_cli("eval-dreamsim", ["--original_path", original, "--edited_path", original,
                               "--weights", weights, "--save_path", save], "cuda")
    self_rows = read_table(save)[1:]
    if not self_rows or any(abs(float(r[1])) > DREAMSIM_SELF_MAX for r in self_rows):
        raise AssertionError(f"eval-dreamsim of a folder against itself: {self_rows}")
    pairs = sorted(n for n in os.listdir(original) if n.endswith(".png"))
    timings = {}
    for key, device in EVAL_DEVICES:
        fn = dreamsim_mod.load_dreamsim(weights, device)
        prep = lpips_mod.batch_prep(224, device)
        a = prep(np.stack([load_image(os.path.join(original, n)) for n in pairs]))
        b = prep(np.stack([load_image(os.path.join(edited, n)) for n in pairs]))
        with torch.inference_mode():
            timings[key] = (median_ms(lambda: fn(a, b), reps=5) / 1e3 if device == "cuda"
                            else host_seconds(lambda: fn(a, b)))
        del fn
    print(f"[eval] eval-dreamsim (3 ViT-B/16): {len(tables['card']) - 1} rows "
          f"{[r[-1] for r in tables['card'][1:]]}; card vs CPU rel max {worst:.3e}, new "
          f"process vs CPU {fresh:.3e} (bound {EVAL_REL}); a folder against itself max "
          f"{max(abs(float(r[1])) for r in self_rows):.3e} (bound {DREAMSIM_SELF_MAX}); CLI "
          f"wall card {secs['card']:.2f} s, CPU {secs['host']:.2f} s, new process "
          f"{secs['fresh']:.2f} s; per image pair at batch {len(pairs)}: card "
          f"{timings['card'] / len(pairs) * 1e3:.2f} ms, CPU "
          f"{timings['host'] / len(pairs) * 1e3:.1f} ms", flush=True)


def phase_compare_info(original: str, folders: dict, root: str, info: tuple) -> None:
    """eval-compare over the folders: a grid per case complete in every
    folder, each panel its source image; ``info`` in a new process (started
    by the suite): rc 0, the card named, every library built for the current
    sources."""
    columns = [original, folders["sld"], folders["ca"], folders["dvl"]]
    out = os.path.join(root, "grids")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["eval-compare", "--folders", *columns, "--save_path", out])
    cases = sorted(set.intersection(*(
        {int(n.split("_")[0]) for n in os.listdir(f) if re.fullmatch(r"\d+_0\.png", n)}
        for f in columns)))
    if rc != 0 or sorted(os.listdir(out)) != sorted(f"{c}.png" for c in cases) or (
            f"wrote {len(cases)} comparison grids" not in buf.getvalue()):
        raise AssertionError(f"eval-compare: rc {rc}, {sorted(os.listdir(out))}, want "
                             f"{cases}: {buf.getvalue()}")
    for c in cases:
        grid = load_image(os.path.join(out, f"{c}.png"))
        panels = [load_image(os.path.join(f, f"{c}_0.png")) for f in columns]
        h, w = panels[0].shape[:2]
        if grid.shape != (h, w * len(columns), 3) or any(
                not np.array_equal(grid[:, i * w:(i + 1) * w], p) for i, p in enumerate(panels)):
            raise AssertionError(f"eval-compare {c}.png: panels differ from their sources")
    _, stdout = finish_fresh(info)
    name = torch.cuda.get_device_name(0)
    built = stdout.count(": built ")
    if name not in stdout or built != len(kernels.LIBRARIES):
        raise AssertionError(f"info: {built} libraries built\n{stdout[-3000:]}")
    print(f"[eval] eval-compare: {len(cases)} grids of {len(columns)} columns, each panel "
          f"its source image; info: rc 0, names {name}, {built} libraries built for the "
          f"current sources", flush=True)
    print("\n".join(f"[info] {line}" for line in stdout.splitlines()), flush=True)


def phase_eval_suite(original: str, folders: dict, csv_path: str) -> None:
    """eval-nudenet, eval-dreamsim, eval-compare and info over the baselines'
    folders; no kernel launch (fp32 convs and T=197 attention)."""
    root = os.path.join(WORK, "eval_suite")
    os.makedirs(root, exist_ok=True)
    write_dreamsim_weights(os.path.join(root, "dreamsim_ensemble.safetensors"))
    with kernels.route(LIBRARY_OFF):
        # the new processes first: they run beside the in-process work
        dream = start_fresh(["eval-dreamsim", *dreamsim_args(
            original, folders["sld"], csv_path, root), "--save_path",
            os.path.join(root, "dreamsim_fresh.csv")], os.path.join(root, "dreamsim.log"))
        info = start_fresh(["info"], os.path.join(root, "info.log"))
        kernels.reset_launches()
        phase_nudenet(folders, csv_path, root)
        phase_dreamsim(original, folders["sld"], csv_path, root, dream)
        phase_compare_info(original, folders, root, info)
        launches = kernels.launches()
    if any(launches.values()):
        raise AssertionError(f"the eval suite launched kernels: {launches}")
    print("[eval] eval-nudenet, eval-dreamsim, eval-compare, info: no kernel launched",
          flush=True)


def run_baselines(snap: str, clip_snap: str, cases: list, rows: dict,
                  seconds: dict) -> None:
    """The baselines on SD 1.4 through their CLIs on both paths, their
    identities, the combines on the card's eps, the two paths' images, and
    the eval commands over their folders."""
    csv_path = os.path.join(WORK, "prompts_baselines.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["case_number", "prompt", "evaluation_seed", "label_idx"])
        w.writerows([c + [label] for c, label in zip(cases, EVAL_IMAGENET_LABELS)])
    captures = {"sld": {}, "ca": {}}
    per_image = {}
    for path in ("library", "kernels"):
        with timed(f"SD 1.4 baselines ({path})", seconds):
            for i in range(len(BASELINE_RUNS)):
                store = None
                if path == "kernels" and i < 2:
                    store = captures["sld" if i == 0 else "ca"]
                launches, per_image[i, path] = phase_baseline(snap, csv_path, path, i,
                                                              rows, store)
                if path == "kernels":
                    add_launches(rows, launches)
    print(f"[baseline] {check_sld_combine(captures['sld'])}", flush=True)
    print(f"[baseline] {check_concept_algebra_combine(captures['ca'])}", flush=True)
    for i, (command, extra, *_) in enumerate(BASELINE_RUNS):
        lib, ker = (baseline_dir(p, i) for p in ("library", "kernels"))
        for name in sorted(os.listdir(ker)):
            a, b = load_image(os.path.join(ker, name)), load_image(os.path.join(lib, name))
            rel = rel_l2(torch.from_numpy(a).float(), torch.from_numpy(b).float())
            mean, worst = image_distance(a, b)
            if rel > REL_L2_MAX:
                raise AssertionError(f"{command} {name}: kernels vs library rel L2 {rel}")
            print(f"[baseline] {' '.join([command, *extra])} {name}: kernels vs library "
                  f"rel L2 {rel:.3e} (bound {REL_L2_MAX}), mean |diff| {mean:.3f} uint8 "
                  f"levels, max {worst}", flush=True)
    with timed("SD 1.4 baseline identities", seconds):
        pipe = SDPipeline.from_pretrained(snap, dtype=torch.bfloat16, device="cuda")
        cfg_seconds = {path: phase_baseline_identities(pipe, path)["cfg"]
                       for path in ("library", "kernels")}
        del pipe
        torch.cuda.empty_cache()
    for i, (command, extra, scheduler, steps, *_) in enumerate(BASELINE_RUNS):
        print(f"[baseline] {' '.join([command, *extra])} ({scheduler or 'pndm'}, {steps} "
              "steps): " + ", ".join(
                  f"{path} {per_image[i, path]:.3f} s per image ({1 / per_image[i, path]:.4f}"
                  f" img/s; cfg at {SLD_STEPS} PNDM steps {cfg_seconds[path]:.3f} s, "
                  f"{per_image[i, path] / cfg_seconds[path]:.2f}x)"
                  for path in ("library", "kernels")), flush=True)
    with timed("eval metrics", seconds):
        folders = {"sld": baseline_dir("kernels", 0), "ca": baseline_dir("kernels", 1),
                   "ca2": baseline_dir("kernels", 2), "dvl": baseline_dir("kernels", 3)}
        phase_eval(generate_dir(SD14, "kernels"), folders, csv_path, clip_snap)
    with timed("eval-nudenet, eval-dreamsim, eval-compare, info", seconds):
        phase_eval_suite(generate_dir(SD14, "kernels"), folders, csv_path)


@contextlib.contextmanager
def timed(what: str, seconds: dict):
    """Print the enclosed phase's wall seconds and keep them in ``seconds``."""
    start = time.perf_counter()
    try:
        yield
    finally:
        seconds[what] = time.perf_counter() - start
        print(f"[time] {what}: {seconds[what]:.1f} s", flush=True)


def add_launches(rows: dict, launches: dict) -> None:
    """Add a main-path run's launches to the kernels' rows."""
    for k in ("conv3x3", "group_norm_act", "sd_attention_d512", "sd_attention_qk8",
              "qk_norm_rope"):
        rows[k]["launches"] += launches[k]
    rows["sd_attention"]["launches"] += (launches["sd_attention"]
                                         - launches["sd_attention_d512"])


def run_sd14(rows: dict, seconds: dict) -> None:
    """SD 1.4: edit, UNet, VAE, generate on both paths (exact and fast), W8A8,
    serving (exact and fast), img/s, debias-sd, eval-clip-classify, the
    baselines and the eval metrics."""
    snap = os.path.join(WORK, "sd14_random")
    with timed("SD 1.4 snapshot", seconds):
        write_snapshot(snap, SD14)
    with timed("SD 1.4 edit", seconds):
        edit_path, solves = phase_edit(snap, SD14)
    rows["uce_solve"]["launches"] += solves
    pipe = SDPipeline.from_pretrained(snap, dtype=torch.bfloat16, device="cuda")
    with timed("SD 1.4 UNet and VAE", seconds):
        phase_unet(pipe, rows, SD14, ["a painting by kelly mckernan", "a photo of a dog"])
        phase_vae(pipe, rows, SD14)
    cases = [[0, "a painting by kelly mckernan", 1],
             [1, "a house in the style of rembrandt", 2]]
    with timed("SD 1.4 generate", seconds):
        phase_generate(snap, edit_path, "library", rows, SD14, cases)
        add_launches(rows, phase_generate(snap, edit_path, "kernels", rows, SD14, cases))
    calls = plan_from_hf(SD14.scheduler, 50).num_calls
    with timed("SD 1.4 generate --fast", seconds):
        # the fast schedule's identities (a no-op spec, a CFG window over
        # every call) on the kernel path; the library path runs the spec
        phase_fast(snap, edit_path, "library", rows, SD14, cases, (FAST_SPEC,))
        phase_fast(snap, edit_path, "kernels", rows, SD14, cases,
                   ("cache=1", f"cfg_interval=0:{calls},cache=1", FAST_SPEC))
    with timed("SD 1.4 W8A8", seconds):
        phase_quant_unet(pipe)
        phase_quant_vae(pipe)
    with timed("SD 1.4 serve", seconds):
        add_launches(rows, phase_serve(snap, edit_path))
        phase_socket(snap, edit_path)
    with timed("SD 1.4 serve --fast", seconds):
        add_launches(rows, phase_serve(snap, edit_path, SERVE_FAST_SPEC))
    with timed("SD 1.4 img/s", seconds):
        int8_pipe = copy.copy(pipe)
        int8_pipe.quantize_weights("int8")
        for path, p in (("library", pipe), ("kernels", pipe), ("int8", int8_pipe)):
            phase_throughput(p, path)
        del int8_pipe
    with timed("SD 1.4 img/s fast", seconds):  # on the kernel path only, for time
        phase_fast_rate(pipe, "kernels")
    del pipe
    torch.cuda.empty_cache()
    with timed("mesh: SD 1.4 data and model parallel", seconds):
        phase_mesh_sd(snap, edit_path, rows)
    with timed("mesh: SD 1.4 serve --mesh data=2", seconds):
        phase_mesh_serve(snap, edit_path, rows)
    clip_snap = os.path.join(WORK, "clip_random")
    with timed("SD 1.4 debias-sd", seconds):
        write_clip_snapshot(clip_snap)
        phase_debias(snap, clip_snap, rows)
    with timed("eval-clip-classify", seconds):
        phase_clip_classify(clip_snap, generate_dir(SD14, "kernels"), cases)
    run_baselines(snap, clip_snap, cases, rows, seconds)
    shutil.rmtree(snap)


def run_model(model: Model, rows: dict, seconds: dict,
              lms_steps: int | None = None, fast: str | None = None,
              serve: bool = False, debias: bool = False) -> None:
    """SD 2.1 or SDXL at full width: edit with every method, a UNet forward
    at UNet batch 2, a VAE decode, both quantized (int8 and w8), and
    ``generate`` on both paths at 50 steps of the model's scheduler (and,
    given ``lms_steps``, an LMS run on the kernel path; given ``fast``, a
    ``--fast`` run on the kernel path; given ``serve``, ``serve --quantize
    int8``; given ``debias``, ``debias-sd`` with the SD 1.4 run's CLIP
    classifier)."""
    snap = os.path.join(WORK, f"{model.tag}_random")
    with timed(f"{model.name} snapshot", seconds):
        write_snapshot(snap, model)
    with timed(f"{model.name} edit", seconds):
        edit_path, solves = phase_edit(snap, model)
    rows["uce_solve"]["launches"] += solves
    pipe = SDPipeline.from_pretrained(snap, dtype=torch.bfloat16, device="cuda")
    with timed(f"{model.name} UNet and VAE", seconds):
        phase_unet(pipe, rows, model, ["a painting by kelly mckernan"])
        phase_vae(pipe, rows, model)
    with timed(f"{model.name} int8 and w8", seconds):
        phase_quant_model(pipe, rows, model)
    del pipe
    torch.cuda.empty_cache()
    cases = [[0, "a painting by kelly mckernan", 1]]
    with timed(f"{model.name} generate", seconds):
        phase_generate(snap, edit_path, "library", rows, model, cases)
        add_launches(rows, phase_generate(snap, edit_path, "kernels", rows, model,
                                          cases))
        if lms_steps:
            add_launches(rows, phase_generate(snap, edit_path, "kernels", rows, model,
                                              cases, "lms", lms_steps))
    if fast:
        with timed(f"{model.name} generate --fast", seconds):
            phase_fast(snap, edit_path, "kernels", rows, model, cases, (fast,))
    if serve:
        with timed(f"{model.name} serve --quantize int8", seconds):
            add_launches(rows, phase_serve_model(snap, edit_path, model))
    if debias:
        with timed(f"{model.name} debias-sd", seconds):
            phase_debias_sdxl(snap, os.path.join(WORK, "clip_random"), rows)
    shutil.rmtree(snap)
    torch.cuda.empty_cache()


@dataclasses.dataclass(frozen=True)
class FluxModel:
    """FLUX.1-schnell's image size, as ``phase_vae`` reads a model."""

    name: str = "FLUX.1-schnell"
    size: int = 1024

    @property
    def latent(self) -> int:
        return self.size // 8


FLUX = FluxModel()


def flux_parts() -> list:
    """(subfolder, config, file, state dict maker) of each weight file of the
    FLUX snapshot, drawn on the card in bf16."""
    rng = DeviceNormalRng(SEED + 3, "cuda", torch.bfloat16)
    cast = lambda sd: {k: torch.as_tensor(v).to("cuda", torch.bfloat16)
                       for k, v in sd.items()}
    return [
        ("transformer", flux.SCHNELL_CONFIG, "diffusion_pytorch_model.safetensors",
         lambda: flux.init_state_dict(flux.SCHNELL_CONFIG, seed=SEED, device="cuda")),
        ("text_encoder_2", t5.T5_XXL_CONFIG, "model.safetensors",
         lambda: t5.init_state_dict(t5.T5_XXL_CONFIG, seed=SEED + 1, device="cuda")),
        ("text_encoder", FLUX_CLIP, "model.safetensors",
         lambda: cast(clip_text.init_state_dict(FLUX_CLIP, rng))),
        ("vae", FLUX_VAE, "diffusion_pytorch_model.safetensors",
         lambda: cast(vae.init_state_dict(FLUX_VAE, rng)))]


def meminfo() -> dict[str, int]:
    """/proc/meminfo's fields in bytes, and this process's resident bytes."""
    with open("/proc/meminfo") as f:
        info = {line.split(":")[0]: int(line.split()[1]) * 1024 for line in f}
    with open("/proc/self/status") as f:
        info["VmRSS"] = next(int(line.split()[1]) * 1024 for line in f
                             if line.startswith("VmRSS:"))
    return info


def host_memory() -> str:
    info = meminfo()
    return (f"host memory: {info['MemAvailable'] / 1e9:.1f} GB available, shmem "
            f"{info['Shmem'] / 1e9:.1f} GB, this process {info['VmRSS'] / 1e9:.1f} GB "
            "resident")


def snapshot_room_check(what: str, root: str, in_memory: dict, on_disk: dict) -> None:
    """Fail before drawing a snapshot whose bf16 weights do not fit: those
    kept in memory (plus 8 GB) the host's available memory, the others
    (plus 1 GB) the disk under build/. The model is not shrunk to fit."""
    nbytes = lambda shapes: 2 * sum(int(np.prod(s)) for s in shapes.values())
    need, avail = nbytes(in_memory) + 8e9, meminfo()["MemAvailable"]
    if avail < need:
        raise AssertionError(f"{what} snapshot: {avail / 1e9:.1f} GB of host memory "
                             f"available, {need / 1e9:.1f} GB needed at full width")
    os.makedirs(root, exist_ok=True)
    need, free = nbytes(on_disk) + 1e9, shutil.disk_usage(root).free
    if free < need:
        raise AssertionError(f"{what} snapshot: {free / 1e9:.1f} GB free under {root}, "
                             f"{need / 1e9:.1f} GB needed at full width")


def write_weights(sd: dict, path: str, fds: list) -> int:
    """Write a state dict as a safetensors file held in host memory (an
    anonymous memory file, memfd) and link ``path`` to it through
    /proc/<pid>/fd: the loader reads it as any file, and the machine's disk
    takes none of it (the card's machine allows a run 45 GiB of disk
    writes, less than FLUX's and HiDream's snapshots together). ``fds`` keeps the file open
    until the caller closes it. Returns its bytes."""
    fd = os.memfd_create(os.path.basename(path))
    fds.append(fd)
    save_safetensors(sd, f"/proc/self/fd/{fd}")
    os.symlink(f"/proc/{os.getpid()}/fd/{fd}", path)
    return os.fstat(fd).st_size


def write_parts(root: str, parts: list, fds: list, in_memory=lambda sub: True) -> int:
    """Each part's config.json, and its weights drawn on the card, written
    to memory (``write_weights``; where ``in_memory(subfolder)``) or to the
    disk, and freed in turn. Returns the bytes."""
    written = 0
    for sub, cfg, fname, draw in parts:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(cfg.to_hf(), f)
        sd, path = draw(), os.path.join(root, sub, fname)
        if in_memory(sub):
            written += write_weights(sd, path, fds)
        else:
            save_safetensors(sd, path)
            written += os.path.getsize(path)
        del sd
        torch.cuda.empty_cache()
    return written


def close_files(fds: list) -> None:
    for fd in fds:
        os.close(fd)
    fds.clear()


def write_flux_snapshot(root: str, fds: list) -> int:
    """FLUX.1-schnell at full width and depth with seeded random weights,
    stored in bf16 as a diffusers snapshot whose weight files are held in
    memory (``write_parts``), a character-vocabulary tokenizer for CLIP and
    the T5 layout's tokenizer.json for T5. Fails before drawing if the
    host's memory is short. Returns the bytes written."""
    snapshot_room_check("FLUX", root, {**flux.state_dict_shapes(flux.SCHNELL_CONFIG),
                                       **t5.state_dict_shapes(t5.T5_XXL_CONFIG)}, {})
    written = write_parts(root, flux_parts(), fds)
    write_tokenizer(os.path.join(root, "tokenizer"), "<|endoftext|>")
    write_tokenizer_json(os.path.join(root, "tokenizer_2"), t5_tokenizer_files())
    os.makedirs(os.path.join(root, "scheduler"), exist_ok=True)
    with open(os.path.join(root, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump(FLUX_SCHEDULER, f)
    return written


def phase_flux_edit(snap: str) -> str:
    """``edit-flux`` through the CLI (5 art concepts, 3 preserve): the two
    text-entry targets, each held to a float64 solve of the same fp32
    embeddings (per input-dim group, as ``phase_edit``'s bounds); ``--method
    pallas`` must exit non-zero."""
    out = os.path.join(WORK, "edits_flux")
    start = time.perf_counter()
    rc = cli_main(["edit-flux", "--model_id", snap, "--edit_concepts", ART,
                   "--concept_type", "art", "--preserve_concepts", PRESERVE,
                   "--save_dir", out, "--exp_name", "erase_art", "--device", "cuda"])
    seconds = time.perf_counter() - start
    path = os.path.join(out, "erase_art.safetensors")
    edits = read_safetensors(path)
    shapes = {k: tuple(v.shape) for k, v in edits.items()}
    cfg = flux.SCHNELL_CONFIG  # [3072, 4096] and [3072, 768]
    want_shapes = {"context_embedder.weight": (cfg.inner_dim, cfg.joint_attention_dim),
                   "time_text_embed.text_embedder.linear_1.weight": (
                       cfg.inner_dim, cfg.pooled_projection_dim)}
    if rc != 0 or shapes != want_shapes or not all(
            bool(torch.isfinite(v).all()) for v in edits.values()):
        raise AssertionError(f"edit-flux: rc {rc}, targets {shapes}")
    edits_c, guides, preserves = resolve_edit_request(ART, None, PRESERVE, "art")
    res = edit_flux.load_resources(snap, device="cuda")
    embeds = edit_flux.encode_concepts(res, edits_c + guides + preserves)
    targets = res.targets
    del res
    torch.cuda.empty_cache()
    for key, w in targets.items():
        d = w.shape[1]
        stack = lambda names: torch.stack([embeds[n][d] for n in names])
        solved = float64_edit(stack(edits_c), stack(guides), stack(preserves))
        cond = float(torch.linalg.cond(solved[0]))
        rel, bound, back, back_bound = hold_edit(f"edit-flux {key}", w, edits[key],
                                                 solved, cond)
        print(f"[edit] FLUX.1-schnell {key} {tuple(w.shape)}, d={d}: cond(mat2) "
              f"{cond:.4e}, relative max diff from a float64 solve {rel:.3e} (bound "
              f"{bound:.3e}), backward error {back:.3e} (bound {back_bound:.3e})")
    try:
        rc = cli_main(["edit-flux", "--model_id", snap, "--edit_concepts", ART,
                       "--concept_type", "art", "--save_dir", out, "--exp_name",
                       "refused", "--device", "cuda", "--method", "pallas"])
    except SystemExit as e:
        rc = e.code
    if not rc or os.path.exists(os.path.join(out, "refused.safetensors")):
        raise AssertionError(f"edit-flux --method pallas exited with {rc!r}")
    print(f"[edit] edit-flux (5 art concepts, 3 preserve): 2 finite targets in "
          f"{seconds:.2f} s (CLI wall, load included); --method pallas refused: "
          f"{rc!r}", flush=True)
    return path


@contextlib.contextmanager
def attention_calls(seen: collections.Counter, rows: dict, every: bool = False):
    """Count the q shape of every sd_attention wrapper call in the enclosed
    calls, and hold the first call at each shape (``every``: each call) to
    the plain version on the call's own inputs (raises outside the
    attention's bounds; the worst error goes into the row of its head dim's
    kernel)."""
    launch = sdk.sd_attention

    def spy(q, k, v, scale, qk_int8=False):
        got = launch(q, k, v, scale, qk_int8=qk_int8)
        key = tuple(q.shape)
        if every or key not in seen:
            max_err = check_bf16("sd_attention", f"sd_attention {key} on the path's own "
                                 "inputs", got, sdk.sd_attention_reference(q, k, v, scale))[0]
            row = rows["sd_attention_d512" if key[-1] == 512 else "sd_attention"]
            row["max_abs_err"] = max(row["max_abs_err"], max_err)
        seen[key] += 1
        return got

    sdk.sd_attention = spy
    try:
        yield
    finally:
        sdk.sd_attention = launch


def phase_flux_dit(pipe, rows: dict) -> None:
    """One DiT forward at batch 1 and 1024^2 (the first step, t = 1) on
    the attention kernel ("auto") against the plain attention ("plain":
    sd_attention switched off): rel L2, exactly 57 d=128 kernel
    launches (the first call held to the plain version on its own inputs),
    device ms (CUDA events) and wall ms of each."""
    cfg, lh = pipe.transformer_config, FLUX.latent
    with torch.inference_mode():
        t5_embeds, pooled = pipe.encode_prompts([FLUX_PROMPT])
        lat = draw_prompt_latents((lh, lh, FLUX_VAE.latent_channels), SEED, 1, 1)
        lat = pack_latents(lat.to("cuda", pipe.dtype))
        img_ids, txt_ids = make_img_ids(lh, lh), np.zeros((t5_embeds.shape[1], 3))
        t = torch.ones(1, device="cuda")
        outs, device_ms, wall_ms = {}, {}, {}
        for impl in ("auto", "plain"):
            with kernels.route(() if impl == "auto" else ("sd_attention",)):
                fwd = lambda: flux.apply(pipe.transformer_params, lat, t5_embeds, pooled, t,
                                         img_ids, txt_ids, cfg)
                kernels.reset_launches()
                seen = collections.Counter()
                with attention_calls(seen, rows):
                    outs[impl] = fwd().float()
                got = kernels.launches()
                want = FLUX_DIT_LAUNCHES if impl == "auto" else {
                    "sd_attention_d128": 0, "qk_norm_rope": FLUX_DIT_LAUNCHES["qk_norm_rope"]}
                expect_launches(f"FLUX DiT forward ({impl})", got, want)
                device_ms[impl] = median_ms(fwd, reps=3, warmup=1)
                walls = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    fwd()
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - start) * 1e3)
                wall_ms[impl] = float(np.median(walls))
    if not all(bool(torch.isfinite(o).all()) for o in outs.values()):
        raise AssertionError("FLUX DiT forward: non-finite output")
    rel = rel_l2(outs["auto"], outs["plain"])
    if rel > REL_L2_MAX:
        raise AssertionError(f"FLUX DiT forward auto vs plain: rel L2 {rel} > {REL_L2_MAX}")
    print(f"[dit] FLUX.1-schnell DiT forward, batch 1 at 1024^2 ({lat.shape[1]} image + "
          f"{t5_embeds.shape[1]} text tokens): rel L2 auto vs plain {rel:.3e} (bound "
          f"{REL_L2_MAX}); {FLUX_DIT_LAUNCHES['sd_attention_d128']} d=128 kernel launches "
          f"per forward; auto: device {device_ms['auto']:.2f} ms, wall "
          f"{wall_ms['auto']:.2f} ms; plain: device {device_ms['plain']:.2f} ms, wall "
          f"{wall_ms['plain']:.2f} ms (median of 3)", flush=True)


def check_images(what: str, images, size: int | None = None) -> None:
    """uint8 RGB of the size (the DiTs' by default), not constant, and
    through a PNG and back."""
    size = FLUX.size if size is None else size
    for img in images:
        if img.shape != (size, size, 3) or img.dtype != np.uint8 or img.std() == 0:
            raise AssertionError(f"{what}: image {img.shape} {img.dtype}, std "
                                 f"{img.std()}")
        if not np.array_equal(decode_png(encode_png(img)), img):
            raise AssertionError(f"{what}: PNG round trip changed the image")


def phase_flux_generate(snap: str, edit_path: str, path: str, rows: dict,
                        flags: tuple = (), dev: bool = False) -> tuple:
    """``generate-flux`` through the CLI, 1 prompt at 1024^2 with the edit
    overlay, on ``path`` (with ``flags``: --staged, --quantize MODE):
    schnell at 4 steps and guidance 0, or (``dev``) FLUX.1-dev at
    ``FLUX_DEV_STEPS`` and guidance 3.5, its 512 T5 tokens read from the
    joint attention's length, its dynamic shift's mu checked, the first
    attention call at each shape held to the plain version on its own
    inputs. The PNG,
    the launches derived from the steps (57 d=128 attentions each,
    quantized or not) and one decode, and the seconds of the image after the
    load (of the generation from the embeddings, staged; the DiT's staged
    load not included)."""
    csv_path = os.path.join(WORK, "prompts_flux.csv")
    with open(csv_path, "w", newline="") as f:
        csv.writer(f).writerows([["case_number", "prompt", "evaluation_seed"],
                                 [0, FLUX_PROMPT, 1]])
    tag = re.sub(r"[^0-9a-z]+", "_", "".join(flags)) + ("_dev" if dev else "")
    out = os.path.join(WORK, f"images_flux_{path}{tag}")
    staged = "--staged" in flags
    steps = FLUX_DEV_STEPS if dev else FLUX_STEPS
    per_decode = VAE_LAUNCHES if path == "kernels" else VAE_LAUNCHES_LIBRARY
    want = {**per_decode, "sd_attention_d128": steps * FLUX_DIT_LAUNCHES[
        "sd_attention_d128"], "sd_attention_d512": 1,
        "qk_norm_rope": steps * FLUX_DIT_LAUNCHES["qk_norm_rope"]}
    want["sd_attention"] = want["sd_attention_d128"] + 1
    seen, gn_seen, calls, attn_seen, mus = (collections.Counter(), collections.Counter(),
                                           [], collections.Counter(), [])
    spied = "generate_from_embeddings" if staged else "__call__"
    loads = []
    extra = (["--num_inference_steps", str(steps), "--guidance_scale",
              str(FLUX_DEV_GUIDANCE)] if dev else [])
    with path_route(path):
        kernels.reset_launches()
        start = time.perf_counter()
        with conv_shapes(seen, rows["conv3x3"]), gn_shapes(
                gn_seen, rows["group_norm_act"]), finite_decodes(), pipe_calls(
                calls, FluxPipeline, spied), dit_loads(loads, pipeline_flux), (
                attention_calls(attn_seen, rows) if dev and path == "kernels"
                else contextlib.nullcontext()), captured(pipeline_flux, "compute_shift_mu",
                                                         mus):
            rc = cli_main(["generate-flux", "--model_name", snap, "--prompts_path",
                           csv_path, "--save_path", out, "--uce_model_path", edit_path,
                           "--image_size", str(FLUX.size), "--device", "cuda", *extra,
                           *flags])
        launches = kernels.launches()
        seconds = time.perf_counter() - start
    if path == "kernels":
        want["conv3x3_reduce"] = conv_split_sums(seen)
    if rc != 0 or len(calls) != 1 or len(loads) != 1:
        raise AssertionError(f"generate-flux ({path} {flags}): rc {rc}, {len(calls)} "
                             f"calls, {len(loads)} DiT loads")
    name = "FLUX.1-dev" if dev else "FLUX.1-schnell"
    what = (f"{name} generate-flux {' '.join(flags)} ({path}), 1 row x "
            f"({steps} steps + 1 decode)").replace("  ", " ")
    expect_launches(what, launches, want)
    note = ""
    if dev:
        joint = (1, flux.SCHNELL_CONFIG.num_attention_heads,
                 FLUX.latent ** 2 // 4 + FLUX_DEV_TOKENS, flux.SCHNELL_CONFIG.attention_head_dim)
        mu_want = pipeline_flux.compute_shift_mu(FLUX.latent ** 2 // 4)
        if path == "kernels" and attn_seen[joint] != want["sd_attention_d128"]:
            raise AssertionError(f"{what}: joint attention shapes {dict(attn_seen)}, want "
                                 f"{want['sd_attention_d128']} at {joint}")
        if mus != [mu_want]:
            raise AssertionError(f"{what}: dynamic shift mu {mus}, want [{mu_want}]")
        note = (f"; the joint attention at {joint} ({FLUX_DEV_TOKENS} T5 tokens), its "
                f"first call held to the plain version" if path == "kernels" else "") + (
                f"; dynamic shift mu {mus[0]:.4f}")
    image = read_case_images(os.path.join(out, "erase_art"), [[0, None, None]])[0]
    check_images(what, [image])
    image_s = calls[0][0] - (loads[0]["s"] if staged else 0.0)
    print(f"[generate] {what}: 1 PNG 1024x1024x3 uint8 in {seconds:.2f} s (CLI wall, "
          f"load included), {image_s:.3f} s for the image after the load; the DiT "
          f"{loads[0]['gb']:.2f} GB on the card, loaded in {loads[0]['s']:.1f} s; "
          f"launches {launches} (want {want}){note}", flush=True)
    return launches, image


def write_flux_dev_snapshot(schnell: str, root: str) -> int:
    """FLUX.1-dev beside the schnell snapshot: its encoders, tokenizers and
    VAE linked, the transformer's weights file linked with a second file
    beside it holding the guidance embedder (drawn from SEED, as
    ``flux.init_state_dict`` draws), dev's configs. Returns the new bytes."""
    os.makedirs(os.path.join(root, "transformer"))
    for name in os.listdir(schnell):
        if name not in ("transformer", "scheduler"):
            os.symlink(os.path.join(schnell, name), os.path.join(root, name))
    fname = "diffusion_pytorch_model.safetensors"
    os.symlink(os.path.join(schnell, "transformer", fname),
               os.path.join(root, "transformer", fname))
    with open(os.path.join(root, "transformer", "config.json"), "w") as f:
        json.dump(FLUX_DEV.to_hf(), f)
    os.makedirs(os.path.join(root, "scheduler"))
    with open(os.path.join(root, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump(FLUX_DEV_SCHEDULER, f)
    gen = torch.Generator("cuda").manual_seed(SEED + 13)
    sd = {k: (torch.zeros(shape, device="cuda", dtype=torch.bfloat16) if k.endswith(".bias")
              else torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.bfloat16).mul_(0.02))
          for k, shape in flux.state_dict_shapes(FLUX_DEV).items()
          if ".guidance_embedder." in k}
    path = os.path.join(root, "transformer", "guidance_embedder.safetensors")
    save_safetensors(sd, path)
    return os.path.getsize(path)


def phase_flux_serve(snap: str, edit_path: str, quantize: str | None = None) -> dict:
    """``serve --family flux`` (given ``quantize``, the DiT quantized as it
    loads) with the edit overlay through the CLI: warm-up of the ladder 1,2,
    then 4 Poisson requests at 1/s, at 1024^2, 4 steps, guidance 0; the JSON
    report, the served images' checks and launches."""
    argv = ["serve", "--model_id", snap, "--family", "flux", "--uce_model_path",
            edit_path, "--num_inference_steps", str(FLUX_STEPS), "--guidance_scale", "0",
            "--image_size", str(FLUX.size), "--batch_sizes", "1,2", "--bench", "1",
            "--bench_requests", "4", "--device", "cuda"] + (
                ["--quantize", quantize] if quantize else [])
    mode = f" --quantize {quantize}" if quantize else ""
    out, calls, loads = io.StringIO(), [], []
    kernels.reset_launches()
    start = time.perf_counter()
    with contextlib.redirect_stdout(out), pipe_calls(calls, FluxPipeline), dit_loads(
            loads, pipeline_flux):
        rc = cli_main(argv)
    launches = kernels.launches()
    seconds = time.perf_counter() - start
    reports = [json.loads(line) for line in out.getvalue().splitlines()
               if line.startswith("{")]
    if rc != 0 or len(reports) != 1:
        raise AssertionError(f"serve --family flux{mode}: rc {rc}, output "
                             f"{out.getvalue()!r}")
    rep = reports[0]
    if not (rep["n_requests"] == 4 and rep["throughput_rps"] > 0
            and 0 < rep["latency_p50_s"] <= rep["latency_p95_s"]):
        raise AssertionError(f"serve --family flux{mode} report: {rep}")
    batches = 2 + rep["batches"]  # one warm-up batch per rung
    want = {"sd_attention_d128": batches * FLUX_STEPS * FLUX_DIT_LAUNCHES[
        "sd_attention_d128"], "sd_attention_d512": batches, "sd_attention_qk8": 0,
        "qk_norm_rope": batches * FLUX_STEPS * FLUX_DIT_LAUNCHES["qk_norm_rope"]}
    expect_launches(f"serve --family flux{mode}, {batches} batches", launches, want)
    served = [img for _, images in calls[2:] for img in images]
    check_images(f"serve --family flux{mode}", served)
    print(f"[serve] {json.dumps(rep)}")
    print(f"[serve] --family flux{mode} --batch_sizes 1,2 --bench 1 (the DiT "
          f"{loads[0]['gb']:.2f} GB on the card): 4 requests in "
          f"{rep['batches']} batches (+2 warm-up), throughput {rep['throughput_rps']} "
          f"req/s, latency p50 {rep['latency_p50_s']} s, p95 {rep['latency_p95_s']} s; "
          f"{len(served)} served images (padding included) 1024x1024x3 uint8, PNG round "
          f"trip exact; seconds per batch {[round(c[0], 3) for c in calls]}; "
          f"{seconds:.1f} s CLI wall (load, warm-up and load run); launches {want}",
          flush=True)
    return launches


def tensor_bytes(obj, seen: set | None = None) -> int:
    """The bytes of the distinct tensors in nested dicts, lists and tuples
    (a quantized weight's payload and scale included)."""
    seen = set() if seen is None else seen
    if torch.is_tensor(obj):
        key = (obj.data_ptr(), obj.nbytes)
        if key in seen:
            return 0
        seen.add(key)
        return obj.nbytes
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(tensor_bytes(v, seen) for v in obj)
    return 0


def dit_bytes_from_shapes(shapes: dict, skip, mode: str | None) -> int:
    """A DiT's bytes on the card as its shapes reckon them: bf16, or with
    ``mode`` one int8 byte per quantized weight element and an fp32 scale
    per output row (the skipped and 1-D tensors bf16)."""
    fn = quantize.quantizer(skip, mode or "w8")
    total = 0
    for key, shape in shapes.items():
        n = int(np.prod(shape))
        quantized = mode and isinstance(fn(key, torch.empty(shape, device="meta")), dict)
        total += n + 4 * shape[0] if quantized else 2 * n
    return total


@contextlib.contextmanager
def dit_loads(records: list, module):
    """Record the seconds, the bytes on the card and the card's allocated
    bytes after each ``module.load_transformer`` (the DiT's load, quantized
    as it loads or not) of the enclosed calls."""
    load = module.load_transformer

    def spy(*args, **kwargs):
        start = time.perf_counter()
        out = load(*args, **kwargs)
        torch.cuda.synchronize()
        records.append({"s": time.perf_counter() - start, "bytes": tensor_bytes(out[0]),
                        "gb": tensor_bytes(out[0]) / 1e9,
                        "allocated": torch.cuda.memory_allocated()})
        return out

    module.load_transformer = spy
    try:
        yield
    finally:
        module.load_transformer = load


@contextlib.contextmanager
def float_emulation(mode: str):
    """The control of a quantized forward: the same quantized weights and
    arithmetic in float operands. ``w8``: each weight-only product on the
    weight dequantized into the float path (``bf16(q * scale)``); ``int8``:
    each W8A8 product on the same per-token int8 activations and int8 weights
    as fp32 operands of an fp32 GEMM (the int32 sums rounded to fp32), then
    the same scales."""
    name = "wlinear" if mode == "w8" else "qlinear"
    saved = getattr(quant, name)

    def w8(x, qw, b=None):
        w = qw[quant.WKEY].float() * qw["scale"][:, None]
        return F.linear(x, w.to(x.dtype), b)

    def int8(x, qw, b=None):
        xq, xs = quant._quant_act(x, (-1,))
        y = F.linear(xq.float(), qw[quant.QKEY].float()) * (xs * qw["scale"])
        return (y if b is None else y + b.float()).to(x.dtype)

    setattr(quant, name, w8 if mode == "w8" else int8)
    try:
        yield
    finally:
        setattr(quant, name, saved)


def hold_quantized(what: str, out, control, bf16) -> str:
    """A quantized DiT forward against its float emulation (``float_emulation``:
    the same function in another arithmetic order, within the paths' bound
    REL_L2_MAX) and against the bf16 forward (within the W8A8 gross-fault
    bound, which the emulation's own distance from bf16 shows to be the
    quantization's share). Returns the reading."""
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: non-finite output")
    rel_c, rel_b, rel_cb = rel_l2(out, control), rel_l2(out, bf16), rel_l2(control, bf16)
    if rel_c > REL_L2_MAX or rel_b > INT8_VS_BF16_REL_L2:
        raise AssertionError(f"{what}: rel L2 {rel_c} against its float emulation "
                             f"(bound {REL_L2_MAX}), {rel_b} against bf16 (bound "
                             f"{INT8_VS_BF16_REL_L2})")
    return (f"rel L2 against its float emulation {rel_c:.3e} (bound {REL_L2_MAX}), "
            f"against bf16 {rel_b:.3e} (bound {INT8_VS_BF16_REL_L2}; the emulation's "
            f"own {rel_cb:.3e})")


# A sample of FLUX DiT weights whose card quantization is held bit for bit to
# the CPU's: attention, AdaLN, MLP and the single blocks' fused projections,
# first and last blocks.
FLUX_QUANT_SAMPLE = ("transformer_blocks.0.attn.to_q.weight",
                     "transformer_blocks.18.norm1_context.linear.weight",
                     "transformer_blocks.9.ff.net.2.weight",
                     "single_transformer_blocks.0.proj_mlp.weight",
                     "single_transformer_blocks.37.proj_out.weight")


def phase_flux_quant(pipe, rows: dict) -> None:
    """The DiT quantized on the card, ``w8`` and ``int8`` (FLUX_SKIP), from
    the pipeline's bf16 weights: a sample of weights' payloads and scales
    held bit for bit to the CPU's quantization of the same bf16 tensors; the
    DiT's bytes on the card against the shapes' reckoning; one forward at
    batch 1 and 1024^2 (57 d=128 kernel launches, no int8-QK^T: the DiT's
    attention stays bf16 in every mode, as in uce_tpu) held to its float
    emulation and to the bf16 forward (``hold_quantized``); device ms of each
    against bf16's. The encoders are freed first."""
    cfg, lh = pipe.transformer_config, FLUX.latent
    shapes = flux.state_dict_shapes(cfg)
    with torch.inference_mode():
        t5_embeds, pooled = pipe.encode_prompts([FLUX_PROMPT])
        pipe.free_encoders()
        lat = draw_prompt_latents((lh, lh, FLUX_VAE.latent_channels), SEED, 1, 1)
        lat = pack_latents(lat.to("cuda", pipe.dtype))
        img_ids, txt_ids = make_img_ids(lh, lh), np.zeros((t5_embeds.shape[1], 3))
        t = torch.ones(1, device="cuda")
        fwd = lambda params: flux.apply(params, lat, t5_embeds, pooled, t, img_ids,
                                        txt_ids, cfg)
        bf16 = fwd(pipe.transformer_params).float()
        bf16_ms = median_ms(lambda: fwd(pipe.transformer_params), reps=3, warmup=1)
        bf16_gb = tensor_bytes(pipe.transformer_params) / 1e9
        for mode in ("w8", "int8"):
            qparams = quantize.quantize_params(pipe.transformer_params,
                                               quantize.FLUX_SKIP, mode)
            nbytes = tensor_bytes(qparams)
            want_bytes = dit_bytes_from_shapes(shapes, quantize.FLUX_SKIP, mode)
            if nbytes != want_bytes:
                raise AssertionError(f"FLUX {mode} DiT: {nbytes} bytes, the shapes "
                                     f"reckon {want_bytes}")
            for key in FLUX_QUANT_SAMPLE:
                host = quant.quantize_weight(pipe.transformer_params[key].cpu(),
                                             weight_only=mode == "w8")
                same = {k: torch.equal(qparams[key][k].cpu(), host[k]) for k in host}
                if not all(same.values()):
                    raise AssertionError(f"FLUX {mode} {key}: the card's quantization "
                                         f"differs from the CPU's (equal: {same})")
            kernels.reset_launches()
            out = fwd(qparams).float()
            expect_launches(f"FLUX {mode} DiT forward", kernels.launches(),
                            {**FLUX_DIT_LAUNCHES, "sd_attention_qk8": 0})
            ms = median_ms(lambda: fwd(qparams), reps=3, warmup=1)
            with float_emulation(mode):
                control = fwd(qparams).float()
            reading = hold_quantized(f"FLUX {mode} DiT forward", out, control, bf16)
            del qparams
            torch.cuda.empty_cache()
            print(f"[{mode}] FLUX.1-schnell DiT, {nbytes / 1e9:.2f} GB on the card (bf16 "
                  f"{bf16_gb:.2f} GB; the shapes reckon the same bytes), "
                  f"{len(FLUX_QUANT_SAMPLE)} sampled weights quantized on the card equal "
                  f"to the CPU's bit for bit; forward at batch 1, 1024^2: {reading}; "
                  f"device {ms:.2f} ms against bf16 {bf16_ms:.2f} ms (median of 3, one "
                  f"call); {FLUX_DIT_LAUNCHES['sd_attention_d128']} d=128 launches",
                  flush=True)


def run_flux(rows: dict, seconds: dict) -> None:
    """FLUX.1-schnell at full width and depth: snapshot, the T5
    tokenizer.json reader, edit-flux, a DiT forward on both paths, a VAE
    decode, the DiT quantized w8 and int8, generate-flux on both paths (and
    FLUX.1-dev's, on schnell's weights), and with --quantize w8, --quantize
    int8 and --staged on the kernel path, serve --family flux and serve
    --family flux --quantize w8."""
    snap, dev, fds = os.path.join(WORK, "flux_random"), os.path.join(WORK, "flux_dev"), []
    print(f"[host] {host_memory()}", flush=True)
    try:
        with timed("FLUX snapshot", seconds):
            start = time.perf_counter()
            nbytes = write_flux_snapshot(snap, fds)
            print(f"[flux] snapshot: {nbytes} bytes written to host memory in "
                  f"{time.perf_counter() - start:.1f} s; {host_memory()}", flush=True)
        with timed("FLUX tokenizer.json", seconds):
            phase_tokenizers(os.path.join(snap, "tokenizer_2"))
        with timed("FLUX edit", seconds):
            edit_path = phase_flux_edit(snap)
        with timed("FLUX DiT and VAE", seconds):
            start = time.perf_counter()
            pipe = FluxPipeline.from_pretrained(snap, device="cuda")
            print(f"[flux] FluxPipeline.from_pretrained: "
                  f"{time.perf_counter() - start:.1f} s", flush=True)
            phase_flux_dit(pipe, rows)
            phase_vae(pipe, rows, FLUX)
        with timed("FLUX DiT w8 and int8", seconds):
            phase_flux_quant(pipe, rows)
            del pipe
            torch.cuda.empty_cache()
        with timed("FLUX generate", seconds):
            phase_flux_generate(snap, edit_path, "library", rows)
            launches, kernel_image = phase_flux_generate(snap, edit_path, "kernels", rows)
            add_launches(rows, launches)
            library_image = read_case_images(os.path.join(
                WORK, "images_flux_library", "erase_art"), [[0, None, None]])[0]
            diff = np.abs(kernel_image.astype(int) - library_image.astype(int))
            print(f"[generate] FLUX kernels vs library path: mean |diff| "
                  f"{diff.mean():.3f} uint8 levels, max {int(diff.max())}", flush=True)
        with timed("FLUX.1-dev generate", seconds):
            nbytes = write_flux_dev_snapshot(snap, dev)
            print(f"[flux] FLUX.1-dev snapshot: schnell's files linked, {nbytes} bytes of "
                  "guidance embedder beside them", flush=True)
            phase_flux_generate(dev, edit_path, "library", rows, dev=True)
            launches, dev_image = phase_flux_generate(dev, edit_path, "kernels", rows,
                                                      dev=True)
            add_launches(rows, launches)
            library_image = read_case_images(os.path.join(
                WORK, "images_flux_library_dev", "erase_art"), [[0, None, None]])[0]
            diff = np.abs(dev_image.astype(int) - library_image.astype(int))
            print(f"[generate] FLUX.1-dev kernels vs library path: mean |diff| "
                  f"{diff.mean():.3f} uint8 levels, max {int(diff.max())}", flush=True)
            shutil.rmtree(dev)
        with timed("FLUX generate --staged, --quantize", seconds):
            for flags in (("--staged",), ("--quantize", "w8"), ("--quantize", "int8")):
                launches, image = phase_flux_generate(snap, edit_path, "kernels", rows,
                                                      flags)
                add_launches(rows, launches)
                diff = np.abs(image.astype(int) - kernel_image.astype(int))
                if flags == ("--staged",) and diff.max() > 1:
                    raise AssertionError(f"generate-flux --staged: {int(diff.max())} "
                                         "uint8 levels from the whole load's image")
                print(f"[generate] FLUX {' '.join(flags)} vs the bf16 kernel path: mean "
                      f"|diff| {diff.mean():.3f} uint8 levels, max {int(diff.max())}",
                      flush=True)
        with timed("FLUX serve", seconds):
            add_launches(rows, phase_flux_serve(snap, edit_path))
        with timed("FLUX serve --quantize w8", seconds):
            add_launches(rows, phase_flux_serve(snap, edit_path, "w8"))
        with timed("mesh: FLUX model=2", seconds):
            phase_mesh_flux(snap, rows, fds)
    finally:
        shutil.rmtree(dev, ignore_errors=True)
        shutil.rmtree(snap, ignore_errors=True)
        close_files(fds)
        torch.cuda.empty_cache()
        print(f"[host] snapshot closed; {host_memory()}", flush=True)


def hidream_parts() -> list:
    """(subfolder, config, file, state dict maker) of each weight file of the
    HiDream snapshot, drawn on the card in bf16."""
    rng = DeviceNormalRng(SEED + 3, "cuda", torch.bfloat16)
    cast = lambda sd: {k: torch.as_tensor(v).to("cuda", torch.bfloat16)
                       for k, v in sd.items()}
    return [
        ("transformer", hidream.I1_FULL_CONFIG, "diffusion_pytorch_model.safetensors",
         lambda: hidream.init_state_dict(hidream.I1_FULL_CONFIG, seed=SEED, device="cuda")),
        ("text_encoder_4", llama.LLAMA31_8B_CONFIG, "model.safetensors",
         lambda: llama.init_state_dict(llama.LLAMA31_8B_CONFIG, seed=SEED + 2,
                                       device="cuda")),
        ("text_encoder_3", t5.T5_XXL_CONFIG, "model.safetensors",
         lambda: t5.init_state_dict(t5.T5_XXL_CONFIG, seed=SEED + 1, device="cuda")),
        ("text_encoder", HIDREAM_CLIP_L, "model.safetensors",
         lambda: cast(clip_text.init_state_dict(HIDREAM_CLIP_L, rng))),
        ("text_encoder_2", HIDREAM_CLIP_G, "model.safetensors",
         lambda: cast(clip_text.init_state_dict(HIDREAM_CLIP_G, rng))),
        ("vae", FLUX_VAE, "diffusion_pytorch_model.safetensors",
         lambda: cast(vae.init_state_dict(FLUX_VAE, rng)))]


def write_hidream_snapshot(root: str, fds: list) -> int:
    """HiDream-I1-Full at full width and depth with seeded random weights,
    stored in bf16 as a diffusers snapshot with the Llama in text_encoder_4
    (60.5 GB: more than a run may write to the disk, so the DiT's 34.2 GB
    are held in memory, ``write_parts``), character-vocabulary tokenizers
    for the two CLIPs and the T5 and Llama-3.1 layouts' tokenizer.json. Fails before drawing if the host's
    memory or the disk is short. Returns the bytes written."""
    snapshot_room_check("HiDream", root, hidream.state_dict_shapes(hidream.I1_FULL_CONFIG),
                        {**llama.state_dict_shapes(llama.LLAMA31_8B_CONFIG),
                         **t5.state_dict_shapes(t5.T5_XXL_CONFIG)})
    written = write_parts(root, hidream_parts(), fds, lambda sub: sub == "transformer")
    # a Llama snapshot carries its tokenizer beside its weights (edit-hidream
    # reads it there); the pipeline reads tokenizer_4
    for sub in ("tokenizer", "tokenizer_2"):
        write_tokenizer(os.path.join(root, sub), "<|endoftext|>")
    write_tokenizer_json(os.path.join(root, "tokenizer_3"), t5_tokenizer_files())
    for sub in ("tokenizer_4", "text_encoder_4"):
        write_tokenizer_json(os.path.join(root, sub), llama_tokenizer_files())
    os.makedirs(os.path.join(root, "scheduler"), exist_ok=True)
    with open(os.path.join(root, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump(HIDREAM_SCHEDULER, f)
    return written


def phase_hidream_edit(snap: str) -> str:
    """``edit-hidream`` through the CLI (5 art concepts, 3 preserve): 49
    finite caption-projection targets, each held to a float64 solve of its
    own stream's fp32 embeddings (those the CLI run encoded), within
    EDIT_COND_FACTOR * cond(mat2) * eps32 and backward error sqrt(d) *
    eps32, as ``phase_flux_edit``; ``--method pallas`` must exit non-zero.
    mat2 = 0.5 I + C^T C for the 8 concepts' rows C, so cond(mat2) is (0.5 +
    the largest eigenvalue of C C^T) / 0.5, exactly."""
    out = os.path.join(WORK, "edits_hidream")
    cfg = hidream.I1_FULL_CONFIG
    n_cp = cfg.num_caption_projections
    embeds = []
    start = time.perf_counter()
    with captured(edit_hd, "encode_concepts", embeds):
        rc = cli_main(["edit-hidream", "--model_id", snap, "--edit_concepts", ART,
                       "--concept_type", "art", "--preserve_concepts", PRESERVE,
                       "--save_dir", out, "--exp_name", "erase_art", "--device", "cuda"])
    seconds = time.perf_counter() - start
    path = os.path.join(out, "erase_art.safetensors")
    edits = read_safetensors(path)
    want = {f"caption_projection.{i}.linear.weight": (
        cfg.inner_dim, cfg.caption_channels[0 if i == n_cp - 1 else 1]) for i in range(n_cp)}
    if rc != 0 or len(embeds) != 1 or {k: tuple(v.shape) for k, v in edits.items()} != want \
            or not all(bool(torch.isfinite(v).all()) for v in edits.values()):
        raise AssertionError(f"edit-hidream: rc {rc}, {len(edits)} targets")
    targets = load_state_dict(snap, "transformer", keys=is_hidream_caption_projection,
                              dtype=torch.float32)
    edits_c, guides, preserves = resolve_edit_request(ART, None, PRESERVE, "art")
    streams = list(cfg.llama_layers) + ["t5"]
    solved, worst = {}, {"rel": 0.0, "back": 0.0}
    for m in range(n_cp):
        key = f"caption_projection.{m}.linear.weight"
        if streams[m] not in solved:  # modules on one stream share mat2 and E
            stack = lambda names: torch.stack([embeds[0][n][m] for n in names])
            rows_c = torch.cat([stack(edits_c), stack(preserves)]).double()
            cond = float((0.5 + torch.linalg.eigvalsh(rows_c @ rows_c.T).max()) / 0.5)
            solved[streams[m]] = (float64_edit(stack(edits_c), stack(guides),
                                               stack(preserves)), cond)
        rel, bound, back, back_bound = hold_edit(
            f"edit-hidream {key} (stream {streams[m]})", targets[key], edits[key],
            *solved[streams[m]])
        d = targets[key].shape[1]
        worst["rel"], worst["back"] = max(worst["rel"], rel / bound), max(worst["back"], back)
        if m in (0, 15, 31, 47, 48):
            print(f"[edit] HiDream {key} (stream {streams[m]}), d={d}: cond(mat2) "
                  f"{cond:.4e}, relative max diff from a float64 solve {rel:.3e} (bound "
                  f"{bound:.3e}), backward error {back:.3e} (bound {back_bound:.3e})")
    conds = [v[1] for v in solved.values()]
    del solved, embeds
    torch.cuda.empty_cache()
    try:
        rc = cli_main(["edit-hidream", "--model_id", snap, "--edit_concepts", ART,
                       "--concept_type", "art", "--save_dir", out, "--exp_name",
                       "refused", "--device", "cuda", "--method", "pallas"])
    except SystemExit as e:
        rc = e.code
    if not rc or os.path.exists(os.path.join(out, "refused.safetensors")):
        raise AssertionError(f"edit-hidream --method pallas exited with {rc!r}")
    print(f"[edit] edit-hidream (5 art concepts, 3 preserve): {n_cp} finite targets "
          f"{list(want.values())[0]} on {len(conds)} distinct streams, cond(mat2) "
          f"{min(conds):.3e}..{max(conds):.3e}; every target within its float64 bounds "
          f"(worst relative diff {worst['rel']:.3f} of its bound, worst backward error "
          f"{worst['back']:.3e}); {seconds:.2f} s (CLI wall, load included); --method "
          f"pallas refused: {rc!r}", flush=True)
    return path


@contextlib.contextmanager
def hidream_stages(record: dict):
    """Seconds of every HiDreamPipeline load, prompt encoding, DiT load and
    generation of the enclosed calls (summed per stage; ``image`` is the
    generation after the DiT load), and the card's allocated bytes around
    ``free_encoders``."""
    cls = HiDreamPipeline
    saved = {n: cls.__dict__[n] for n in ("from_pretrained", "encode_prompts",
                                          "free_encoders", "_ensure_transformer",
                                          "generate_from_embeddings")}

    def timed_stage(name, fn):
        def spy(*args, **kwargs):
            start = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                record[name] = record.get(name, 0.0) + time.perf_counter() - start
        return spy

    def free_spy(self):
        torch.cuda.synchronize()
        record["hbm_before_free"] = torch.cuda.memory_allocated()
        saved["free_encoders"](self)
        record["hbm_after_free"] = torch.cuda.memory_allocated()

    load = saved["from_pretrained"].__func__
    cls.from_pretrained = classmethod(timed_stage("load", load))
    cls.encode_prompts = timed_stage("encode", saved["encode_prompts"])
    cls.free_encoders = free_spy
    cls._ensure_transformer = timed_stage("dit_load", saved["_ensure_transformer"])
    cls.generate_from_embeddings = timed_stage("generate",
                                               saved["generate_from_embeddings"])
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(cls, n, fn)
    if "generate" in record:
        record["image"] = record["generate"] - record.get("dit_load", 0.0)


def check_free_encoders(what: str, record: dict) -> str:
    """The staged load gave the encoders' memory back to the card."""
    before, after = record["hbm_before_free"], record["hbm_after_free"]
    if not before - after > 50e9:
        raise AssertionError(f"{what}: free_encoders left {after / 1e9:.2f} of "
                             f"{before / 1e9:.2f} GB allocated")
    return f"HBM allocated {before / 1e9:.2f} GB -> {after / 1e9:.2f} GB at free_encoders"


@contextlib.contextmanager
def moe_routes(routes: list, replay: bool = False):
    """Record the experts that each MoE gate call of the enclosed forward
    picks (a [B, S, E] mask of the top-k), or with ``replay`` route each
    call to the recorded experts, weighted by this forward's own softmax
    scores. The dense MoE's routing is discontinuous: a near tie between two
    experts' scores flips on the last bit, so two forwards that differ in
    their arithmetic are compared on the same routing."""
    gate = hidream.moe_gate
    recorded = iter(list(routes))

    def spy(p, name, x, num_activated):
        if not replay:
            w = gate(p, name, x, num_activated)
            routes.append(w > 0)
            return w
        logits = torch.matmul(x.float(), p[name + ".gate.weight"].float().T)
        return torch.softmax(logits, dim=-1) * next(recorded)

    hidream.moe_gate = spy
    try:
        yield
    finally:
        hidream.moe_gate = gate


def phase_hidream_dit(snap: str, rows: dict) -> None:
    """The pipeline loaded staged (encode, free_encoders, then the DiT); one
    DiT forward at CFG batch 2 and 1024^2 (t = 1000) on the attention kernel
    ("auto") against the plain attention ("plain": sd_attention switched
    off) routed to the same experts (``moe_routes``): rel L2,
    exactly 48 d=128 kernel launches (each held to the plain version on its
    own inputs), device ms (CUDA events) and wall ms of each; the plain
    forward on its own routing: its rel L2 and the share of tokens whose
    experts differ; and, as a control of how far rounding carries through
    the random-weight network, the plain forward on latents one bf16 ulp
    away. Then, at 2 steps, generate_from_embeddings with a
    CFG window over every call equal to the exact run bit for bit, and one
    with cfg_interval=1:2 finite and different."""
    record = {}
    with hidream_stages(record):
        pipe = HiDreamPipeline.from_pretrained(snap, staged=True, device="cuda")
        embeds = cfg_embeddings(pipe.encode_prompts([""]), pipe.encode_prompts([FLUX_PROMPT]))
        if not all(bool(torch.isfinite(e).all()) for e in embeds):
            raise AssertionError("HiDream prompt embeddings: non-finite values")
        pipe.free_encoders()
        pipe._ensure_transformer()
    print(f"[hidream] staged HiDreamPipeline: encoders loaded in {record['load']:.1f} s, "
          f"2 prompts encoded in {record['encode']:.2f} s, "
          f"{check_free_encoders('HiDream DiT phase', record)}, DiT loaded in "
          f"{record['dit_load']:.1f} s ({torch.cuda.memory_allocated() / 1e9:.2f} GB "
          "allocated)", flush=True)
    cfg, lh = pipe.transformer_config, FLUX.latent
    t5_e, llama_e, pooled_e = (e.to(pipe.dtype) for e in embeds)
    with torch.inference_mode():
        lat = draw_prompt_latents((lh, lh, FLUX_VAE.latent_channels), SEED, 1, 1)
        lat = pipeline_hidream.pack_latents(lat.to("cuda", pipe.dtype))
        lat = torch.cat([lat, lat])
        img_ids, t = make_img_ids(lh, lh), torch.full((2,), 1000.0, device="cuda")
        outs, device_ms, wall_ms, routes = {}, {}, {}, {}
        joint = (2, cfg.num_attention_heads,
                 lat.shape[1] + t5_e.shape[1] + 2 * llama_e.shape[2], cfg.attention_head_dim)
        # control: the latents one bf16 ulp away (each element's next value)
        nudged = (lat.view(torch.int16) + 1).view(torch.bfloat16)
        # auto, plain on auto's routing, plain on its own routing, the control
        # on auto's routing
        for run, impl, x in (("auto", "auto", lat), ("plain", "plain", lat),
                             ("plain, own routing", "plain", lat),
                             ("plain, nudged", "plain", nudged)):
            with kernels.route(() if impl == "auto" else ("sd_attention",)):
                fwd = lambda: hidream.apply(pipe.transformer_params, x, t5_e, llama_e,
                                            pooled_e, t, img_ids, cfg)
                kernels.reset_launches()
                seen = collections.Counter()
                replay = run in ("plain", "plain, nudged")
                routes[run] = routes["auto"] if replay else []
                with attention_calls(seen, rows, every=True), moe_routes(
                        routes[run], replay=replay):
                    outs[run] = fwd().float()
                got = kernels.launches()
                want = HIDREAM_DIT_LAUNCHES if impl == "auto" else {"sd_attention_d128": 0,
                                                                    "qk_norm_rope": 0}
                expect_launches(f"HiDream DiT forward ({run})", got, want)
                if impl == "auto" and dict(seen) != {joint: want["sd_attention_d128"]}:
                    raise AssertionError(f"HiDream DiT attention calls: {dict(seen)}")
                if run in ("plain, own routing", "plain, nudged"):
                    continue
                device_ms[impl] = median_ms(fwd, reps=3, warmup=1)
                walls = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    fwd()
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - start) * 1e3)
                wall_ms[impl] = float(np.median(walls))
    if not all(bool(torch.isfinite(o).all()) for o in outs.values()):
        raise AssertionError("HiDream DiT forward: non-finite output")
    rel = rel_l2(outs["auto"], outs["plain"])
    if rel > REL_L2_MAX:
        raise AssertionError(f"HiDream DiT forward auto vs plain on the same routing: rel "
                             f"L2 {rel} > {REL_L2_MAX}")
    flips = [float((a != b).any(-1).float().mean())
             for a, b in zip(routes["auto"], routes["plain, own routing"])]
    print(f"[dit] HiDream-I1 DiT forward, CFG batch 2 at 1024^2 ({lat.shape[1]} image + "
          f"{t5_e.shape[1]} T5 + 2 x {llama_e.shape[2]} Llama tokens): rel L2 auto vs "
          f"plain on the same routing {rel:.3e} (bound {REL_L2_MAX}); on its own routing "
          f"{rel_l2(outs['auto'], outs['plain, own routing']):.3e}, experts differing for "
          f"{np.mean(flips):.4%} of the tokens of a MoE layer on average (max "
          f"{max(flips):.4%}, {len(flips)} layers); control: plain with every latent one "
          f"bf16 ulp away, same routing, {rel_l2(outs['plain, nudged'], outs['plain']):.3e} "
          f"from plain; 48 d=128 kernel launches per forward, "
          f"each held to the plain version on its own inputs; auto: device "
          f"{device_ms['auto']:.2f} ms, wall {wall_ms['auto']:.2f} ms; plain: device "
          f"{device_ms['plain']:.2f} ms, wall {wall_ms['plain']:.2f} ms (median of 3)",
          flush=True)

    # W8A8: the DiT quantized on the card, routed to auto's experts
    with torch.inference_mode():
        qparams = quantize.quantize_params(pipe.transformer_params, quantize.HIDREAM_SKIP,
                                           "int8")
        nbytes = tensor_bytes(qparams)
        want_bytes = dit_bytes_from_shapes(hidream.state_dict_shapes(cfg),
                                           quantize.HIDREAM_SKIP, "int8")
        if nbytes != want_bytes:
            raise AssertionError(f"HiDream int8 DiT: {nbytes} bytes, the shapes reckon "
                                 f"{want_bytes}")
        fwd = lambda: hidream.apply(qparams, lat, t5_e, llama_e, pooled_e, t, img_ids, cfg)
        kernels.reset_launches()
        with moe_routes(routes["auto"], replay=True):
            out = fwd().float()
        expect_launches("HiDream int8 DiT forward", kernels.launches(),
                        {**HIDREAM_DIT_LAUNCHES, "sd_attention_qk8": 0})
        int8_ms = median_ms(fwd, reps=3, warmup=1)  # on its own routing
        with moe_routes(routes["auto"], replay=True), float_emulation("int8"):
            control = fwd().float()
        reading = hold_quantized("HiDream int8 DiT forward", out, control, outs["auto"])
        del qparams, control
        torch.cuda.empty_cache()
    print(f"[int8] HiDream-I1 DiT, {nbytes / 1e9:.2f} GB on the card (the shapes reckon "
          f"the same bytes), forward at CFG batch 2 and 1024^2 on auto's expert routing: "
          f"{reading}; device {int8_ms:.2f} ms against bf16 {device_ms['auto']:.2f} ms "
          f"(median of 3); 48 d=128 launches", flush=True)

    kw = dict(do_cfg=True, num_inference_steps=HIDREAM_STEPS,
              guidance_scale=HIDREAM_GUIDANCE, seed=1, height=FLUX.size, width=FLUX.size)
    images, launches = {}, None
    for name, fast in (("exact", None), ("window 0:2", FastConfig(cfg_interval=(0, 2))),
                       ("window 1:2", FastConfig(cfg_interval=(1, 2)))):
        kernels.reset_launches()
        start = time.perf_counter()
        with finite_decodes():
            images[name] = pipe.generate_from_embeddings(*embeds, fast=fast, **kw)
        seconds = time.perf_counter() - start
        got = kernels.launches()
        # one launch per joint attention at either batch (cond-only calls too)
        expect_launches(f"HiDream generate_from_embeddings ({name})", got,
                        {"sd_attention_d128": HIDREAM_STEPS * HIDREAM_DIT_LAUNCHES[
                            "sd_attention_d128"], "sd_attention_d512": 1})
        launches = got if name == "exact" else launches
        check_images(f"HiDream generate_from_embeddings ({name})", images[name])
        print(f"[fast] HiDream generate_from_embeddings ({name}), {HIDREAM_STEPS} steps "
              f"at 1024^2: {seconds:.3f} s, {got['sd_attention_d128']} d=128 launches",
              flush=True)
    if not np.array_equal(images["window 0:2"], images["exact"]):
        raise AssertionError("HiDream cfg_interval=0:2 differs from the exact run")
    diff = np.abs(images["window 1:2"].astype(int) - images["exact"].astype(int))
    if not diff.max() > 0:
        raise AssertionError("HiDream cfg_interval=1:2 equals the exact run")
    print(f"[fast] HiDream cfg_interval=0:2 equals the exact run bit for bit; 1:2 "
          f"(call 0 on the cond rows alone) is {diff.mean():.3f} uint8 levels from it "
          f"on average, max {int(diff.max())}", flush=True)
    add_launches(rows, launches)
    del pipe, embeds, outs
    torch.cuda.empty_cache()


def phase_hidream_generate(snap: str, edit_path: str, path: str, rows: dict,
                           flags: tuple = ()) -> tuple:
    """``generate-hidream --staged`` (with ``flags``: --quantize MODE, the DiT
    quantized as it loads) through the CLI, 1 prompt, 2 steps, CFG 5.0, at
    1024^2 with the edit overlay, on ``path``: the PNG, the launches derived
    from the steps (48 d=128 attentions per forward at batch 2) and one
    decode, the seconds of the encoders' load, the encode phase, the DiT
    load and the image after it, the HBM around free_encoders and the DiT's
    bytes on the card."""
    csv_path = os.path.join(WORK, "prompts_hidream.csv")
    with open(csv_path, "w", newline="") as f:
        csv.writer(f).writerows([["case_number", "prompt", "evaluation_seed"],
                                 [0, FLUX_PROMPT, 1]])
    tag = re.sub(r"[^0-9a-z]+", "_", "".join(flags))
    out = os.path.join(WORK, f"images_hidream_{path}{tag}")
    per_decode = VAE_LAUNCHES if path == "kernels" else VAE_LAUNCHES_LIBRARY
    want = {**per_decode, "sd_attention_d128": HIDREAM_STEPS * HIDREAM_DIT_LAUNCHES[
        "sd_attention_d128"], "sd_attention_d512": 1, "qk_norm_rope": 0}
    want["sd_attention"] = want["sd_attention_d128"] + 1
    seen, gn_seen, record, loads = collections.Counter(), collections.Counter(), {}, []
    with path_route(path):
        kernels.reset_launches()
        start = time.perf_counter()
        with conv_shapes(seen, rows["conv3x3"]), gn_shapes(
                gn_seen, rows["group_norm_act"]), finite_decodes(), hidream_stages(
                record), dit_loads(loads, pipeline_hidream):
            rc = cli_main(["generate-hidream", "--model_name", snap, "--prompts_path",
                           csv_path, "--save_path", out, "--uce_model_path", edit_path,
                           "--num_inference_steps", str(HIDREAM_STEPS), "--staged",
                           "--image_size", str(FLUX.size), "--device", "cuda", *flags])
        launches = kernels.launches()
        seconds = time.perf_counter() - start
    if path == "kernels":
        want["conv3x3_reduce"] = conv_split_sums(seen)
    if rc != 0 or len(loads) != 1:
        raise AssertionError(f"generate-hidream ({path} {flags}): rc {rc}, "
                             f"{len(loads)} DiT loads")
    what = (f"HiDream-I1 generate-hidream --staged {' '.join(flags)} ({path}), 1 row x "
            f"({HIDREAM_STEPS} steps at CFG batch 2 + 1 decode)").replace("  ", " ")
    expect_launches(what, launches, want)
    image = read_case_images(os.path.join(out, "erase_art"), [[0, None, None]])[0]
    check_images(what, [image])
    print(f"[generate] {what}: 1 PNG 1024x1024x3 uint8 in {seconds:.2f} s (CLI wall); "
          f"encoders loaded in {record['load']:.1f} s, encode phase "
          f"{record['encode']:.2f} s, {check_free_encoders(what, record)}, DiT loaded in "
          f"{record['dit_load']:.1f} s ({loads[0]['gb']:.2f} GB on the card, "
          f"{loads[0]['allocated'] / 1e9:.2f} GB allocated after it), "
          f"{record['image']:.3f} s for the image after the load; launches {launches} "
          f"(want {want})", flush=True)
    return launches, image


# The memory a load may take beyond its tensors' bytes (allocator rounding,
# nothing held over from the load).
LOAD_OVERSHOOT_MAX = 0.02


def phase_hidream_serve(snap: str, edit_path: str) -> dict:
    """``serve --family hidream --quantize w8`` with the edit overlay through
    the CLI, loaded whole (unstaged: 52.3 GB of fp32 encoders and the w8 DiT
    on one card), 2 steps, CFG 5.0, 1024^2: the card's allocated bytes after
    the load held to the reckoning (the pipeline's tensors; the DiT's to its
    shapes) within LOAD_OVERSHOOT_MAX; warm-up of the ladder 1,2, then 2
    Poisson requests at 1/s: the JSON report, the served images, launches."""
    argv = ["serve", "--model_id", snap, "--family", "hidream", "--quantize", "w8",
            "--uce_model_path", edit_path, "--num_inference_steps", str(HIDREAM_STEPS),
            "--guidance_scale", str(HIDREAM_GUIDANCE), "--image_size", str(FLUX.size),
            "--batch_sizes", "1,2", "--bench", "1", "--bench_requests", "2",
            "--device", "cuda"]
    load, loaded = HiDreamPipeline.__dict__["from_pretrained"].__func__, {}

    def spy(cls, *args, **kwargs):
        pipe = load(cls, *args, **kwargs)
        torch.cuda.synchronize()
        loaded["allocated"] = torch.cuda.memory_allocated()
        loaded["dit"] = tensor_bytes(pipe.transformer_params)
        loaded["config"] = pipe.transformer_config
        loaded["all"] = tensor_bytes([getattr(pipe, f.name) for f in dataclasses.fields(
            pipe) if "_params" in f.name])
        return pipe

    out, calls = io.StringIO(), []
    kernels.reset_launches()
    start = time.perf_counter()
    HiDreamPipeline.from_pretrained = classmethod(spy)
    try:
        with contextlib.redirect_stdout(out), finite_decodes(), pipe_calls(
                calls, HiDreamPipeline):
            rc = cli_main(argv)
    finally:
        HiDreamPipeline.from_pretrained = classmethod(load)
    launches = kernels.launches()
    seconds = time.perf_counter() - start
    reports = [json.loads(line) for line in out.getvalue().splitlines()
               if line.startswith("{")]
    if rc != 0 or len(reports) != 1:
        raise AssertionError(f"serve --family hidream: rc {rc}, output {out.getvalue()!r}")
    rep = reports[0]
    if not (rep["n_requests"] == 2 and rep["throughput_rps"] > 0
            and 0 < rep["latency_p50_s"] <= rep["latency_p95_s"]):
        raise AssertionError(f"serve --family hidream report: {rep}")
    want_dit = dit_bytes_from_shapes(hidream.state_dict_shapes(loaded["config"]),
                                     quantize.HIDREAM_SKIP, "w8")
    over = loaded["allocated"] / loaded["all"] - 1
    if loaded["dit"] != want_dit or over > LOAD_OVERSHOOT_MAX:
        raise AssertionError(f"serve --family hidream load: DiT {loaded['dit']} bytes "
                             f"(the shapes reckon {want_dit}), {loaded['allocated']} "
                             f"allocated for {loaded['all']} bytes of tensors")
    batches = 2 + rep["batches"]  # one warm-up batch per rung
    want = {"sd_attention_d128": batches * HIDREAM_STEPS * HIDREAM_DIT_LAUNCHES[
        "sd_attention_d128"], "sd_attention_d512": batches, "sd_attention_qk8": 0}
    expect_launches(f"serve --family hidream --quantize w8, {batches} batches", launches,
                    want)
    served = [img for _, images in calls[2:] for img in images]
    check_images("serve --family hidream --quantize w8", served)
    print(f"[serve] {json.dumps(rep)}")
    print(f"[serve] --family hidream --quantize w8 --batch_sizes 1,2 --bench 1, "
          f"{HIDREAM_STEPS} steps, CFG {HIDREAM_GUIDANCE}: after the load "
          f"{loaded['allocated'] / 1e9:.2f} GB allocated on the card for "
          f"{loaded['all'] / 1e9:.2f} GB of tensors ({over:+.3%}; bound "
          f"+{LOAD_OVERSHOOT_MAX:.0%}): encoders and VAE "
          f"{(loaded['all'] - loaded['dit']) / 1e9:.2f} GB, w8 DiT "
          f"{loaded['dit'] / 1e9:.2f} GB (as its shapes reckon); 2 requests in "
          f"{rep['batches']} batches (+2 warm-up), throughput {rep['throughput_rps']} "
          f"req/s, latency p50 {rep['latency_p50_s']} s, p95 {rep['latency_p95_s']} s; "
          f"{len(served)} served images 1024x1024x3 uint8; seconds per batch "
          f"{[round(c[0], 3) for c in calls]}; {seconds:.1f} s CLI wall; launches "
          f"{want}", flush=True)
    return launches


def run_hidream(rows: dict, seconds: dict) -> None:
    """HiDream-I1-Full at full width and depth: snapshot, the T5 and
    Llama-3.1 tokenizer.json readers, edit-hidream, the staged pipeline's DiT
    forward on both paths and in int8, its CFG window, generate-hidream
    --staged on both paths and with --quantize w8, serve --family hidream
    --quantize w8, and the DiT and generate-hidream --staged at model=2."""
    snap, fds = os.path.join(WORK, "hidream_random"), []
    print(f"[host] {host_memory()}", flush=True)
    try:
        with timed("HiDream snapshot", seconds):
            start = time.perf_counter()
            nbytes = write_hidream_snapshot(snap, fds)
            print(f"[hidream] snapshot: {nbytes} bytes written to host memory (the DiT) "
                  f"and disk in {time.perf_counter() - start:.1f} s; {host_memory()}",
                  flush=True)
        with timed("HiDream tokenizer.json", seconds):
            phase_tokenizers(os.path.join(snap, "tokenizer_3"),
                             os.path.join(snap, "tokenizer_4"))
        with timed("HiDream edit", seconds):
            edit_path = phase_hidream_edit(snap)
        with timed("HiDream DiT", seconds):
            phase_hidream_dit(snap, rows)
        with timed("HiDream generate", seconds):
            phase_hidream_generate(snap, edit_path, "library", rows)
            launches, kernel_image = phase_hidream_generate(snap, edit_path, "kernels", rows)
            add_launches(rows, launches)
            library_image = read_case_images(os.path.join(
                WORK, "images_hidream_library", "erase_art"), [[0, None, None]])[0]
            diff = np.abs(kernel_image.astype(int) - library_image.astype(int))
            print(f"[generate] HiDream kernels vs library path: mean |diff| "
                  f"{diff.mean():.3f} uint8 levels, max {int(diff.max())}", flush=True)
        with timed("HiDream generate --quantize w8", seconds):
            launches, image = phase_hidream_generate(snap, edit_path, "kernels", rows,
                                                     ("--quantize", "w8"))
            add_launches(rows, launches)
            diff = np.abs(image.astype(int) - kernel_image.astype(int))
            print(f"[generate] HiDream --staged --quantize w8 vs the bf16 kernel path: "
                  f"mean |diff| {diff.mean():.3f} uint8 levels, max {int(diff.max())}",
                  flush=True)
        with timed("HiDream serve --quantize w8", seconds):
            add_launches(rows, phase_hidream_serve(snap, edit_path))
        with timed("mesh: HiDream model=2", seconds):
            phase_mesh_hidream(snap, rows, fds)
    finally:
        shutil.rmtree(snap, ignore_errors=True)
        close_files(fds)
        torch.cuda.empty_cache()
        print(f"[host] snapshot closed; {host_memory()}", flush=True)


# ---------------------------------------------------------------------------
# the mesh (parallel/): the port's ranks are processes (workers.py); with two
# or more cards each rank has its own over NCCL, on a one-card machine two
# ranks share it over gloo: a correctness run, not a scaling number
# ---------------------------------------------------------------------------

MESH_PROMPTS = ["a painting by kelly mckernan", "a photo of a dog", "a house by rembrandt",
                "a cat on a sofa", "a city at night", "a portrait of a woman",
                "a red car", "a mountain lake"]
MESH_SEEDS = list(range(1, 9))
# A bf16 forward split over two model ranks against the single-rank forward:
# each row-parallel partial product rounds to bf16 before the sum, about an
# ulp (2^-8) per projection; held under the paths' bound.
MESH_TP_REL_MAX = 5e-2
# HiDream's random-weight MoE re-routes its top-k on such an ulp (PR 14: one
# latent ulp moves its forward 5.5e-2), so its DiT at model=2 has a wider
# bound
MESH_MOE_REL_MAX = 1e-1
# generate at data=2: each rank denoises 4 of the 8 images, and the kernels
# and GEMMs plan by batch (the conv's K splits, GroupNorm's schedule), so
# sums order differently and 50 steps carry it (a last-bit change moves a
# 50-step image about 2 levels); a gross-fault bound on the mean |diff| of
# the 8 images (another image is some 40 levels away), the max printed.
MESH_DP_MEAN_MAX = 4.0
# FLUX.1-schnell and HiDream-I1-Full at full width, depth cut to keep the
# run in its time limit (the encoders are the full snapshots')
MESH_FLUX = dataclasses.replace(flux.SCHNELL_CONFIG, num_layers=2, num_single_layers=4)
MESH_HIDREAM = dataclasses.replace(hidream.I1_FULL_CONFIG, num_layers=2,
                                   num_single_layers=2, llama_layers=(0, 1, 2, 3))
MESH_SERVE_STEPS = 8


def mesh_devices() -> list:
    """The cards the mesh phases' ranks run on: min(4, count) cards, one rank
    each (NCCL), when two or more are visible; else two ranks on cuda:0
    (gloo)."""
    n = torch.cuda.device_count()
    if n >= 2:
        return [torch.device("cuda", i) for i in range(min(4, n))]
    return [torch.device("cuda", 0)] * 2


def mesh_of(n_data: int, n_model: int) -> mesh_mod.Mesh:
    os.makedirs(WORK, exist_ok=True)
    return mesh_mod.make_mesh(n_data, n_model, devices=mesh_devices()[:n_data * n_model],
                              store_dir=WORK)


def print_mesh_plan() -> None:
    devices = mesh_devices()
    print(f"[mesh] {torch.cuda.device_count()} GPU(s) visible; the mesh phases' ranks on "
          f"{', '.join(map(str, devices))} over {mesh_mod.backend_for(devices)} "
          f"({'one card per rank' if len(set(devices)) > 1 else 'two ranks sharing one card: correctness, not scaling'}); "
          f"card {card()}", flush=True)


@contextlib.contextmanager
def cli_mesh_devices():
    """The CLIs' ``--mesh`` takes every visible card (``mesh.visible_devices``);
    on a one-card machine two ranks must share it, which only an explicit
    device list asks for: give the CLIs two ranks of this run's list."""
    saved = mesh_mod.visible_devices
    mesh_mod.visible_devices = lambda kind="cuda", count=1: (
        mesh_devices()[:2] if torch.device(kind).type == "cuda" else saved(kind, count))
    try:
        yield
    finally:
        mesh_mod.visible_devices = saved


def mesh_reset() -> None:
    kernels.reset_launches()
    workers.worker_counts(reset=True)


@contextlib.contextmanager
def launches_at_stop(store: dict):
    """Keep the workers' launches in ``store`` as a CLI stops its mesh."""
    stop = workers.stop

    def reading_stop():
        if workers.session() is not None:
            store.update(workers.worker_counts(), workers=workers.session().mesh.size - 1)
        stop()

    workers.stop = reading_stop
    try:
        yield
    finally:
        workers.stop = stop


def per_rank(what: str, own: dict, theirs: dict, want: dict, rows: dict,
             n_workers: int = 1) -> None:
    """Print the controller's launches and the workers' (summed over
    ``n_workers``), require ``want`` of every rank, and add all of them to
    the kernels' rows."""
    got = {k: (own[k], theirs[k]) for k in want}
    wrong = {k: v for k, v in got.items() if v != (want[k], n_workers * want[k])}
    print(f"[mesh] {what}: launches (rank 0, the {n_workers} other rank(s)) {got}",
          flush=True)
    if wrong:
        raise AssertionError(f"{what}: launches (rank 0, the other ranks) {wrong}, want "
                             f"{ {k: want[k] for k in wrong} } a rank")
    add_launches(rows, {k: own[k] + theirs[k] for k in own})


def wall_ms(fn, reps: int = 3) -> tuple[object, float]:
    """(result, median wall ms) of ``fn`` over ``reps`` calls after one."""
    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return out, float(np.median(times))


def phase_mesh_sd(snap: str, edit_path: str, rows: dict) -> None:
    """SD 1.4 at 512^2 on the kernel path: generate (8 prompts, 50 PNDM
    steps, CFG 7.5, the edit overlay) at data=2 against the single-device
    images; a UNet forward at UNet batch 16 at model=2 against the
    single-rank one, in bf16 and in W8A8; launches per rank."""
    pipe = SDPipeline.from_pretrained(snap, dtype=torch.bfloat16, device="cuda")
    pipe.load_uce_edits(edit_path)
    kw = dict(num_inference_steps=50, seed=MESH_SEEDS, height=512, width=512)
    calls = plan_from_hf(SD14.scheduler, 50).num_calls
    n_data = len(mesh_devices())
    torch.cuda.synchronize()
    start = time.perf_counter()
    single = pipe(MESH_PROMPTS, **kw)
    one_s = time.perf_counter() - start
    pipe.apply_mesh(mesh_of(n_data, 1))
    try:
        pipe(MESH_PROMPTS[:2], **dict(kw, num_inference_steps=2, seed=MESH_SEEDS[:2]))
        mesh_reset()
        start = time.perf_counter()
        meshed = pipe(MESH_PROMPTS, **kw)
        two_s = time.perf_counter() - start
        own, theirs = kernels.launches(), workers.worker_counts()
    finally:
        pipe.apply_mesh(None)
    check_images(f"SD 1.4 generate at data={n_data}", meshed, 512)
    diff = np.abs(meshed.astype(int) - single.astype(int))
    print(f"[mesh] SD 1.4 generate, 8 prompts x 50 PNDM steps at 512^2, kernel path: "
          f"data=1 {one_s:.3f} s ({8 / one_s:.4f} img/s), data={n_data} {two_s:.3f} s "
          f"({8 / two_s:.4f} img/s) on {pipe_mesh_note(n_data, 1)}; data={n_data} vs "
          f"data=1 mean |diff| {diff.mean():.4f} uint8 levels, max {int(diff.max())}",
          flush=True)
    if diff.mean() > MESH_DP_MEAN_MAX:
        raise AssertionError(f"generate at data={n_data}: mean |diff| {diff.mean():.3f} "
                             f"uint8 levels from data=1 (bound {MESH_DP_MEAN_MAX})")
    # a rank: its images' UNet batch through each of the plan's calls, one decode
    per_rank(f"SD 1.4 generate at data={n_data} ({calls} UNet calls + 1 decode a rank)",
             own, theirs, {k: calls * UNET_LAUNCHES[k] + VAE_LAUNCHES[k]
                           for k in ("conv3x3", "group_norm_act", "sd_attention")}, rows,
             n_data - 1)

    x, context, _ = unet_inputs(pipe, SD14, MESH_PROMPTS)
    batch = {"sample": x, "timesteps": torch.full((x.shape[0],), 500.0, device="cuda"),
             "context": context}
    spec = {"unet_config": pipe.unet_config}
    qpipe = copy.copy(pipe)
    qpipe.quantize_weights("int8")
    with torch.inference_mode():
        single, one_ms = wall_ms(lambda: pipeline.denoiser_forward(
            {"unet": pipe.unet_params}, spec, batch), 1)
        qsingle, q_one_ms = wall_ms(lambda: pipeline.denoiser_forward(
            {"unet": qpipe.unet_params}, spec, batch), 1)
        del qpipe
        pipe.apply_mesh(mesh_of(1, 2))
        try:
            sharded = {k: (v, None) for k, v in batch.items()}
            run = lambda: workers.run(pipeline.denoiser_forward, spec, sharded,
                                      {"unet": pipe.unet_params})[0]
            mesh_reset()
            got, two_ms = wall_ms(run, 1)
            own, theirs = kernels.launches(), workers.worker_counts()
            pipe.quantize_weights("int8")  # the ranks take the W8A8 UNet
            mesh_reset()
            qgot, q_two_ms = wall_ms(run, 1)
            qown, qtheirs = kernels.launches(), workers.worker_counts()
        finally:
            pipe.apply_mesh(None)
    # W8A8's bound is the gross one of its other checks: its row-parallel
    # products are exact (tests/test_torch_parallel.py holds the payloads
    # bit for bit), but one ulp elsewhere re-rounds every int8 layer after it
    for what, a, b, ms1, ms2, o, t, want, bound in (
            ("bf16", got, single, one_ms, two_ms, own, theirs, UNET_LAUNCHES,
             MESH_TP_REL_MAX),
            ("W8A8", qgot, qsingle, q_one_ms, q_two_ms, qown, qtheirs, UNET_LAUNCHES_INT8,
             INT8_VS_BF16_REL_L2)):
        rel = rel_l2(a, b.cpu())
        print(f"[mesh] SD 1.4 UNet forward at UNet batch {x.shape[0]}, {what}, model=2 "
              f"(4 of 8 heads a rank) vs model=1: rel L2 {rel:.3e} (bound {bound}); wall "
              f"{ms2:.2f} ms vs {ms1:.2f} ms (the second call) on {pipe_mesh_note(1, 2)}",
              flush=True)
        if not rel <= bound:
            raise AssertionError(f"UNet {what} at model=2: rel L2 {rel:.3e}")
        # 2 forwards: the first and the timed one
        per_rank(f"SD 1.4 UNet {what} forward at model=2, x2", o, t,
                 {k: 2 * v for k, v in want.items()}, rows)
    del pipe
    torch.cuda.empty_cache()


def pipe_mesh_note(n_data: int, n_model: int) -> str:
    devices = mesh_devices()[:n_data * n_model]
    return (f"{len(set(devices))} GPU(s), {mesh_mod.backend_for(devices)}, "
            f"{card()}")


def phase_mesh_serve(snap: str, edit_path: str, rows: dict) -> None:
    """``serve --mesh data=2`` through the CLI with the edit overlay: the
    ladder 1,2, 4 Poisson requests at 8 steps, each batch split over the
    data groups; the JSON report and the launches per rank."""
    out, store = io.StringIO(), {}
    with cli_mesh_devices(), launches_at_stop(store), \
            contextlib.redirect_stdout(out):
        kernels.reset_launches()
        rc = cli_main(["serve", "--model_id", snap, "--uce_model_path", edit_path,
                       "--mesh", "data=2", "--bench", "2", "--bench_requests", "4",
                       "--batch_sizes", "1,2", "--num_inference_steps",
                       str(MESH_SERVE_STEPS), "--device", "cuda"])
        own = kernels.launches()
    text = out.getvalue()
    reports = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
    if rc != 0 or len(reports) != 1 or reports[0]["n_requests"] != 4:
        raise AssertionError(f"serve --mesh data=2: rc {rc}, output {text[-2000:]}")
    print(f"[mesh] serve --mesh data=2 ({MESH_SERVE_STEPS} steps, ladder 1,2, 4 requests at "
          f"2/s) on {pipe_mesh_note(2, 1)}: {json.dumps(reports[0])}", flush=True)
    store.pop("workers")
    for k in ("conv3x3", "group_norm_act", "sd_attention"):
        if not own[k] or not store.get(k):
            raise AssertionError(f"serve --mesh: {k} launched {own[k]} / {store.get(k)} "
                                 "times on rank 0 / rank 1")
    print(f"[mesh] serve --mesh data=2: launches rank 0 {own}, rank 1 {store}", flush=True)
    add_launches(rows, {k: own[k] + store[k] for k in own})


def write_cut_snapshot(full: str, root: str, config, params: dict, fds: list) -> None:
    """A snapshot sharing ``full``'s encoders, tokenizers, VAE and scheduler
    (links) with a depth-cut DiT of ``config`` and ``params`` (held in host
    memory, ``write_weights``)."""
    os.makedirs(os.path.join(root, "transformer"))
    for name in os.listdir(full):
        if name != "transformer":
            os.symlink(os.path.join(full, name), os.path.join(root, name))
    with open(os.path.join(root, "transformer", "config.json"), "w") as f:
        json.dump(config.to_hf(), f)
    write_weights(params, os.path.join(root, "transformer",
                                       "diffusion_pytorch_model.safetensors"), fds)


def mesh_dit_forward(what: str, family: str, module, config, params: dict, spec: dict,
                     batch: dict, rows: dict, per_forward: int,
                     bound: float = MESH_TP_REL_MAX) -> None:
    """A DiT forward at model=2 against the single-rank one (rel L2, wall ms
    of each, d=128 launches per rank); rank 0's whole params are freed as
    their shards go out."""
    spec = {"dit_config": config, **spec}
    with torch.inference_mode():
        single, one_ms = wall_ms(lambda: module.denoiser_forward({"dit": params}, spec, batch))
        free_card(what)
        workers.start(mesh_of(1, 2))
        try:
            items, params = workers.drain(params), None
            local = workers.send_params("dit", items, mesh_mod.layout_fn(
                family, config, 2))
            torch.cuda.empty_cache()
            sharded = {k: (v, None) for k, v in batch.items()}
            run = lambda: workers.run(module.denoiser_forward, spec, sharded,
                                      {"dit": local})[0]
            run()
            mesh_reset()
            got, two_ms = wall_ms(run)
            own, theirs = kernels.launches(), workers.worker_counts()
        finally:
            workers.stop()
    rel = rel_l2(got, single.cpu())
    depth = (config.num_layers, config.num_single_layers)
    print(f"[mesh] {what} DiT forward at full width, depth {depth[0]} + {depth[1]} blocks "
          f"(of {module_depth(family)}), model=2 ({config.num_attention_heads // 2} heads a "
          f"rank) vs model=1: rel L2 {rel:.3e} (bound {bound}); wall "
          f"{two_ms:.2f} ms vs {one_ms:.2f} ms (median of 3) on {pipe_mesh_note(1, 2)}",
          flush=True)
    if not rel <= bound:
        raise AssertionError(f"{what} DiT at model=2: rel L2 {rel:.3e}")
    per_rank(f"{what} DiT forward at model=2, x4", own, theirs,
             {"sd_attention_d128": 4 * per_forward,
              "qk_norm_rope": 4 * per_forward if family == "flux" else 0}, rows)


def free_card(what: str) -> None:
    """Collect dropped pipelines and print the card's memory before a mesh
    starts: a rank that shares the card needs room for its context."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mesh] {what}: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved on the card before the "
          "mesh starts", flush=True)


def module_depth(family: str) -> str:
    cfg = flux.SCHNELL_CONFIG if family == "flux" else hidream.I1_FULL_CONFIG
    return f"{cfg.num_layers} + {cfg.num_single_layers}"


def mesh_dit_cli(what: str, command: str, cut: str, rows: dict, extra: list,
                 per_forward: int, forwards: int) -> None:
    """``generate-flux|generate-hidream --staged --mesh model=2`` through the
    CLI on a depth-cut snapshot: one PNG, d=128 launches per rank."""
    csv_path = os.path.join(WORK, f"prompts_mesh_{command}.csv")
    with open(csv_path, "w", newline="") as f:
        csv.writer(f).writerows([["case_number", "prompt", "evaluation_seed"],
                                 [0, FLUX_PROMPT, 1]])
    out_dir, store = os.path.join(WORK, f"images_mesh_{command}"), {}
    with cli_mesh_devices(), launches_at_stop(store):
        kernels.reset_launches()
        start = time.perf_counter()
        rc = cli_main([command, "--model_name", cut, "--prompts_path", csv_path,
                       "--save_path", out_dir, "--image_size", str(FLUX.size), "--staged",
                       "--mesh", "model=2", "--device", "cuda", *extra])
        seconds = time.perf_counter() - start
        own = kernels.launches()
    if rc != 0:
        raise AssertionError(f"{command} --staged --mesh model=2: rc {rc}")
    image = read_case_images(os.path.join(out_dir, "original"), [[0, None, None]])[0]
    check_images(f"{command} --staged --mesh model=2", [image])
    print(f"[mesh] {what} {command} --staged --mesh model=2 on the depth-cut snapshot: 1 PNG "
          f"1024x1024x3 uint8 in {seconds:.2f} s (CLI wall, loads included) on "
          f"{pipe_mesh_note(1, 2)}", flush=True)
    n_workers = store.pop("workers")
    per_rank(f"{what} {command} --mesh model=2 ({forwards} DiT forwards)", own, store,
             {"sd_attention_d128": forwards * per_forward,
              "qk_norm_rope": forwards * per_forward if command == "generate-flux" else 0},
             rows, n_workers)


def phase_mesh_flux(snap: str, rows: dict, fds: list) -> None:
    free_card("FLUX.1-schnell")
    cfg = MESH_FLUX
    params = flux.init_state_dict(cfg, seed=SEED + 7, device="cuda")
    cut = os.path.join(WORK, "flux_cut")
    write_cut_snapshot(snap, cut, cfg, params, fds)
    gen = torch.Generator("cuda").manual_seed(SEED + 8)
    s_txt, lat = 256, FLUX.latent
    batch = {"latents": torch.randn(1, (lat // 2) ** 2, cfg.in_channels, generator=gen,
                                    device="cuda").bfloat16(),
             "t5": torch.randn(1, s_txt, cfg.joint_attention_dim, generator=gen,
                               device="cuda").bfloat16(),
             "pooled": torch.randn(1, cfg.pooled_projection_dim, generator=gen,
                                   device="cuda").bfloat16(),
             "timesteps": torch.full((1,), 0.5, device="cuda")}
    per_forward = cfg.num_layers + cfg.num_single_layers
    mesh_dit_forward("FLUX.1-schnell", "flux", pipeline_flux, cfg, params,
                     {"img_ids": make_img_ids(lat, lat), "txt_ids": np.zeros((s_txt, 3))},
                     batch, rows, per_forward)
    del params
    torch.cuda.empty_cache()
    mesh_dit_cli("FLUX.1-schnell", "generate-flux", cut, rows, [], per_forward, FLUX_STEPS)


def phase_mesh_hidream(snap: str, rows: dict, fds: list) -> None:
    free_card("HiDream-I1-Full")
    cfg = MESH_HIDREAM
    params = hidream.init_state_dict(cfg, seed=SEED + 7, device="cuda")
    cut = os.path.join(WORK, "hidream_cut")
    write_cut_snapshot(snap, cut, cfg, params, fds)
    gen = torch.Generator("cuda").manual_seed(SEED + 8)
    lat, s_txt = FLUX.latent, 128
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").bfloat16()
    batch = {"latents": rnd(2, (lat // 2) ** 2, cfg.in_channels * 4),
             "t5": rnd(2, s_txt, cfg.caption_channels[0]),
             "llama": rnd(len(cfg.llama_layers), 2, s_txt, cfg.caption_channels[1]),
             "pooled": rnd(2, cfg.text_emb_dim),
             "timesteps": torch.full((2,), 1000.0, device="cuda")}
    per_forward = cfg.num_layers + cfg.num_single_layers
    mesh_dit_forward("HiDream-I1-Full", "hidream", pipeline_hidream, cfg, params,
                     {"img_ids": make_img_ids(lat, lat)}, batch, rows, per_forward,
                     MESH_MOE_REL_MAX)
    del params
    torch.cuda.empty_cache()
    mesh_dit_cli("HiDream-I1-Full", "generate-hidream", cut, rows,
                 ["--num_inference_steps", str(HIDREAM_STEPS)], per_forward, HIDREAM_STEPS)


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
                ("sd_attention_d512", "sd_attention_d512.cu", "uce_tpu/ops/attention.py:96"),
                ("sd_attention_qk8", "sd_attention_qk8.cu",
                 "uce_tpu/ops/pallas/sd_attention.py:166"),
                ("group_norm_act", "group_norm.cu", "uce_tpu/ops/pallas/group_norm.py:112"),
                ("conv3x3", "conv3x3.cu", "uce_tpu/ops/pallas/conv3x3.py:91"),
                ("uce_solve", "uce_solve.cu", "uce_tpu/ops/pallas/uce_solve.py:151"),
                ("qk_norm_rope", "qk_norm_rope.cu",
                 "none: uce_tpu/models/flux.py:69-100 leaves it to XLA"))}
    seconds = {}
    start = time.perf_counter()
    with timed("build", seconds):
        phase_build()
    print_mesh_plan()
    with timed("kernels", seconds):
        phase_kernels(rows)

    shutil.rmtree(WORK, ignore_errors=True)
    try:
        run_sd14(rows, seconds)
        run_model(SD21, rows, seconds, lms_steps=LMS_STEPS)
        run_model(SDXL, rows, seconds, fast=SDXL_FAST_SPEC, serve=True, debias=True)
        run_flux(rows, seconds)
        run_hidream(rows, seconds)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"[time] total {time.perf_counter() - start:.1f} s", flush=True)

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
