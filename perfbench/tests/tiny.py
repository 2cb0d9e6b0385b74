"""Tiny configurations and cells of the benchmark's own layout, for runs
of the whole harness on the CPU (the kernels' plain versions, float32)."""

from __future__ import annotations

import copy
import time

import torch

from perfbench.core import harness

SD_UNET = {"in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64],
           "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
           "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"], "layers_per_block": 1,
           "cross_attention_dim": 32, "attention_head_dim": 2, "norm_num_groups": 32,
           "flip_sin_to_cos": True, "freq_shift": 0}
VAE = {"block_out_channels": [32, 64], "in_channels": 3, "out_channels": 3,
       "latent_channels": 4, "layers_per_block": 1, "norm_num_groups": 32,
       "scaling_factor": 0.18215}
CLIP = {"hidden_size": 32, "intermediate_size": 64, "num_attention_heads": 2,
        "num_hidden_layers": 2, "max_position_embeddings": 77, "vocab_size": 49408,
        "hidden_act": "quick_gelu", "layer_norm_eps": 1e-5, "eos_token_id": 2}
EDIT = {"erase": ["Pablo Picasso", "Van Gogh"], "guide": ["art", "art"],
        "preserve": ["Paul Cezanne"], "lamb": 0.5}


def config(name: str) -> dict:
    """The named configuration at tiny widths, float32."""
    cfg = harness.read_json(harness.BENCH / "configs" / f"{name}.json")
    cfg = copy.deepcopy(cfg)
    cfg["dtype"] = "float32"
    cfg["edit"] = dict(EDIT)
    cfg.update(unet=dict(SD_UNET), vae=dict(VAE), text_encoder=dict(CLIP))
    return cfg


CELLS = {"sd14-eval-b8": ("sd14", "eval-artists-b8"),
         "sd14-serve-poisson": ("sd14", "serve-coco-poisson")}


def cell_files(cell: str, **traffic) -> dict:
    """The cell's files (as ``harness.cell_files`` reads them) with a tiny
    configuration and traffic overrides."""
    name, mix = CELLS[cell]
    e2e = [{"name": "setup_s", "unit": "s"}] + (
        [{"name": "latency_p90_s", "unit": "s"}, {"name": "latency_p50_s", "unit": "s"}]
        if "serve" in cell else [{"name": "img_per_s", "unit": "images/s"}])
    per_layer = [{"name": n, "unit": "%"} for n in (
        ("device_idle_pct.serve", "batch_occupancy.serve") if "serve" in cell
        else ("mfu_pct.eval", "attn_roofline_pct.eval", "device_idle_pct.eval"))]
    read = harness.read_json
    return {"entry": {"name": cell, "config": name, "traffic": mix, "chips": 1},
            "config": config(name),
            "traffic": dict(read(harness.BENCH / "traffic" / f"{mix}.json"), size=64,
                            **traffic),
            "limits": read(harness.BENCH / "limits" / f"{cell}.json"),
            "end_to_end": e2e, "per_layer": per_layer}


def run(cell: str, seed: int = 5, seconds: float = 0.1, trace: bool = False,
        workdir: str = "", **traffic) -> dict:
    return harness.run_cell(cell_files(cell, **traffic), seed, seconds, trace,
                            torch.device("cpu"), workdir, time.perf_counter())


