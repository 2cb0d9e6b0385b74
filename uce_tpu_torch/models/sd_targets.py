"""Edit-target selection for each model family.

Replicates the exact module-name filters of the reference, applied directly
to HF state-dict keys (key = module_name + '.weight'), so exported
safetensors keys are byte-identical to the reference artifacts:

  * SD / SDXL UNet cross-attention K/V:   'attn2' in name, endswith
    to_k / to_v                      (uce_sd_erase.py:17-20)
  * FLUX joint transformer text entry:    'context_embedder' or
    'text_embedder.linear_1' in name (uce_flux_edit.py:25-28)
  * HiDream caption projections:          'caption_projection' and
    'linear' in name                 (uce_hidream_edit.py:32-35)
"""

from __future__ import annotations

from typing import Mapping

import numpy as np


def is_sd_cross_attn_kv(key: str) -> bool:
    return "attn2" in key and (
        key.endswith("to_k.weight") or key.endswith("to_v.weight")
    )


def is_flux_text_entry(key: str) -> bool:
    return ("context_embedder" in key or "text_embedder.linear_1" in key) and (
        key.endswith(".weight") and ".bias" not in key
    )


def is_hidream_caption_projection(key: str) -> bool:
    return (
        "caption_projection" in key
        and "linear" in key
        and key.endswith(".weight")
    )


def select_targets(
    state_dict: Mapping[str, np.ndarray], family: str
) -> dict[str, np.ndarray]:
    """Filter a model state dict down to the UCE edit targets.

    Returns an ordered dict of {module_name_with_.weight: [out, in] array}.
    """
    pred = {
        "sd": is_sd_cross_attn_kv,
        "sdxl": is_sd_cross_attn_kv,
        "flux": is_flux_text_entry,
        "hidream": is_hidream_caption_projection,
    }[family]
    out = {k: v for k, v in state_dict.items() if pred(k)}
    if not out:
        raise ValueError(f"no UCE edit targets found for family '{family}'")
    return out


def group_by_input_dim(
    targets: Mapping[str, np.ndarray]
) -> dict[int, dict[str, np.ndarray]]:
    """Group target weights by trailing (input) dimension.

    FLUX edits two disjoint input spaces (T5 4096 and pooled-CLIP 768); the
    collapsed edit matrix is computed once per group.
    """
    groups: dict[int, dict[str, np.ndarray]] = {}
    for k, v in targets.items():
        groups.setdefault(int(v.shape[-1]), {})[k] = v
    return groups
