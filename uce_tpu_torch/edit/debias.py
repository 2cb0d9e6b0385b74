"""Iterative debiasing: generate -> CLIP-classify -> ratio update -> re-solve
(reference: ``trainscripts/uce_sd_debias.py``; uce_tpu's edit/debias.py).

The gradient-free controller is the reference's in-place accumulation of
attribute directions into the guide outputs (``:126``): each iteration adds
``ratio_a * v_attr_a`` to every edit concept's v*. Since v* = W_old @ c is
linear in the embedding, a cumulative coefficient matrix ``acc [K, A]``
gives effective guide embeddings ``g_k = c_edit_k + acc_k @ c_attrs``, and
every re-solve stays on the collapsed single-edit-matrix path.

``debias_loop`` is the pure controller (testable with a fake generator and
classifier); ``run_debias`` wires SDPipeline generation and CLIP zero-shot
classification on the card.
"""

from __future__ import annotations

import dataclasses
import os
import time
import zlib
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from uce_tpu_torch.edit import embeddings as emb
from uce_tpu_torch.edit.sd import SDEditResources
from uce_tpu_torch.models import sd_targets, unet as unet_mod
from uce_tpu_torch.models.hf_loader import save_safetensors
from uce_tpu_torch.ops.quant import is_quantized, is_weight_only
from uce_tpu_torch.ops.solver import apply_edit_matrix, full_fp32, uce_edit_matrix
from uce_tpu_torch.parallel import mesh as mesh_mod, workers
from uce_tpu_torch.utils.observability import DebiasTelemetry

# HF zero-shot-image-classification's default template, which the
# reference's clip(images, candidate_labels=...) call uses.
DEFAULT_HYPOTHESIS_TEMPLATE = "This is a photo of {}."


@dataclasses.dataclass
class DebiasSettings:
    desired_ratios: Sequence[float] = (0.5, 0.5)
    max_iterations: int = 30
    max_diff: float = 0.05
    num_images_per_prompt: int = 10
    num_inference_steps: int = 20
    guidance_scale: float = 7.5
    edit_scale: float = 1.0
    preserve_scale: float = 1.0
    lamb: float = 0.5


def apply_deadband(ratios: np.ndarray, max_diff: float) -> np.ndarray:
    """Per-concept deadband (uce_sd_debias.py:31-32): zero the whole ratio
    row when every attribute is within tolerance."""
    out = ratios.copy()
    for i in range(out.shape[0]):
        r = out[i]
        if r.max() < max_diff and abs(r.min()) < max_diff:
            out[i] = 0.0
    return out


def debias_loop(
    solve_fn: Callable[[np.ndarray], object],
    measure_fn: Callable[[object], np.ndarray],
    n_concepts: int,
    n_attrs: int,
    desired_ratios: np.ndarray,
    max_iterations: int,
    max_diff: float,
    on_iteration: Callable | None = None,
):
    """Pure controller.

    solve_fn(acc [K, A]) -> edited weights for the cumulative coefficients.
    measure_fn(weights) -> observed ratios [K, A] (the fraction of each edit
    concept's images classified as each attribute).
    Returns (weights, acc, history).
    """
    acc = np.zeros((n_concepts, n_attrs), np.float64)
    history = []
    weights = solve_fn(acc)
    for iteration in range(max_iterations):
        observed = measure_fn(weights)
        ratios = apply_deadband(desired_ratios[None, :] - observed, max_diff)
        history.append({"iteration": iteration, "observed": observed,
                        "ratios": ratios})
        if on_iteration is not None:
            on_iteration(iteration, observed, ratios)
        if np.abs(ratios).max() == 0:
            break
        acc = acc + ratios  # the reference's in-place v* accumulation (:126)
        weights = solve_fn(acc)
    return weights, acc, history


class _GuideStacks:
    """The concept stacks of the collapsed re-solve on the embeddings'
    device, and its edit matrix E for ``acc``: the one arithmetic that the
    host and the device paths share, so their weights agree bit for bit."""

    def __init__(self, concept_embeds, edit_concepts, debias_concepts,
                 preserve_concepts, settings: DebiasSettings):
        self.device = next(iter(concept_embeds.values())).device
        self.settings = settings
        self.c_edit = emb.stack_embeds(concept_embeds, edit_concepts, self.device)
        self.c_attr = emb.stack_embeds(concept_embeds, debias_concepts, self.device)
        self.c_pres = emb.stack_embeds(concept_embeds, preserve_concepts, self.device)

    def edit_matrix(self, acc: np.ndarray) -> torch.Tensor:
        """E for guides g_k = c_edit_k + acc_k @ c_attrs (only ``acc``, a
        few floats, crosses the host link)."""
        acc32 = torch.as_tensor(np.asarray(acc, np.float32), device=self.device)
        with full_fp32():
            c_guide = self.c_edit + acc32 @ self.c_attr
        s = self.settings
        return uce_edit_matrix(self.c_edit, c_guide, self.c_pres, s.edit_scale,
                               s.preserve_scale, s.lamb)


def _split(cat: torch.Tensor, names, rows) -> dict[str, torch.Tensor]:
    out, off = {}, 0
    for n, r in zip(names, rows):
        out[n] = cat[off:off + r]
        off += r
    return out


def make_collapsed_solver(
    targets: Mapping[str, torch.Tensor],
    concept_embeds: Mapping[str, torch.Tensor],
    edit_concepts: Sequence[str],
    debias_concepts: Sequence[str],
    preserve_concepts: Sequence[str],
    settings: DebiasSettings,
):
    """solve_fn factory of the host path: the stacked fp32 targets stay on
    the host and go to the embeddings' device for every solve; the edited
    weights come back as CPU tensors."""
    stacks = _GuideStacks(concept_embeds, edit_concepts, debias_concepts,
                          preserve_concepts, settings)
    names = list(targets)
    rows = [targets[n].shape[0] for n in names]
    w_cat = torch.cat([targets[n].float().cpu() for n in names])

    def solve_fn(acc: np.ndarray) -> dict[str, torch.Tensor]:
        e_mat = stacks.edit_matrix(acc)
        new_cat = apply_edit_matrix(w_cat.to(stacks.device), e_mat).cpu()
        return _split(new_cat, names, rows)

    return solve_fn


class DeviceDebiasApplier:
    """Device-resident re-solve and weight swap for the debias loop.

    The stacked fp32 edit targets are uploaded once; each iteration ships
    only ``acc`` and runs E = uce_edit_matrix(...), W_new = W @ E and the
    cast to each target's dtype on the card, swapping the new tensors into
    the UNet params (the port's params keep the [out, in] layout of the
    targets, so no transpose). The arithmetic is the host path's
    (``make_collapsed_solver`` + ``overlay_edits``) on the same device, so
    the weights are bit-identical.

    Reference anchors: ``uce_sd_debias.py:19`` (the load_state_dict weight
    swap) and ``:114-140`` (the per-iteration re-solve). A target missing
    from ``params`` is skipped, as load_state_dict(strict=False) skips it;
    a quantized target raises: its float edit would leave the quantized
    weight in place.
    """

    def __init__(self, targets, concept_embeds, edit_concepts, debias_concepts,
                 preserve_concepts, settings, params):
        self.stacks = _GuideStacks(concept_embeds, edit_concepts, debias_concepts,
                                   preserve_concepts, settings)
        self.names = list(targets)
        self.rows = [targets[n].shape[0] for n in self.names]
        self.w_cat = torch.cat([targets[n].float() for n in self.names]).to(
            self.stacks.device)
        offs = np.cumsum([0] + self.rows)
        self._swaps, skipped = [], []
        for i, name in enumerate(self.names):
            leaf = params.get(name)
            if leaf is None:
                skipped.append(name)
                continue
            if is_quantized(leaf) or is_weight_only(leaf):
                raise ValueError(
                    f"DeviceDebiasApplier: target {name} is quantized; run debias "
                    "on an unquantized pipeline (the solve edits float weights)")
            self._swaps.append((name, int(offs[i]), int(offs[i + 1]), leaf.dtype,
                                leaf.device))
        if skipped:
            print(f"DeviceDebiasApplier: {len(skipped)} target(s) not in the "
                  f"model params, skipped (e.g. {skipped[0]})")
        self._cat = None  # the last solve's stacked result, on the device

    def solve(self, acc: np.ndarray) -> torch.Tensor:
        """Edited target stack for ``acc`` (device tensor, fp32, [out, d])."""
        self._cat = apply_edit_matrix(self.w_cat, self.stacks.edit_matrix(acc))
        return self._cat

    def edited(self, acc: np.ndarray) -> dict:
        """Re-solve for ``acc``: the edited targets of ``params``, each in
        its leaf's dtype on its device."""
        cat = self.solve(acc)
        return {name: cat[a:b].to(device=device, dtype=dtype)
                for name, a, b, dtype, device in self._swaps}

    def overlay(self, params: dict, acc: np.ndarray) -> dict:
        """Re-solve for ``acc`` and swap the edited targets into a shallow
        copy of ``params``, all on the device."""
        return {**params, **self.edited(acc)}

    def export(self, acc: np.ndarray | None = None) -> dict[str, torch.Tensor]:
        """Safetensors-ready CPU dict (fp32), one download; the last
        solve's unless ``acc`` is given."""
        cat = self.solve(acc) if acc is not None else self._cat
        if cat is None:
            raise RuntimeError("export() before any solve()/overlay()")
        return _split(cat.cpu(), self.names, self.rows)


def whole_targets(pipe, keys=None) -> dict:
    """The ``keys`` leaves (by default the cross-attention to_k/to_v) of a
    live SDPipeline's UNet, whole: on a mesh with a model axis rank 0 holds
    a shard of each, so just these keys are gathered, once (every rank
    keeps its shards)."""
    if keys is None:
        keys = [k for k in pipe.unet_params if sd_targets.is_sd_cross_attn_kv(k)]
    if pipe.mesh is not None and pipe.mesh.n_model > 1:
        return workers.gather_params("unet", pipe.unet_params, keys)
    return {k: pipe.unet_params[k] for k in keys}


def resources_from_pipe(pipe, targets: Mapping | None = None) -> SDEditResources:
    """SDEditResources of a live SDPipeline: the edit targets (fp32 copies
    of ``targets``, by default ``whole_targets(pipe)``), the encoders from
    the pipeline."""
    flat = whole_targets(pipe) if targets is None else targets
    if not flat or any(isinstance(v, dict) for v in flat.values()):
        raise ValueError(
            "no float cross-attn to_k/to_v edit targets in the UNet params; if "
            "the pipeline was quantized (quantize_weights), run debias on an "
            "unquantized pipeline: the solver edits float weights (overlays "
            "onto a quantized pipeline for generation are fine)")
    return SDEditResources(
        targets={k: v.float() for k, v in flat.items()},
        text_params=pipe.text_params, text_config=pipe.text_config,
        tokenizer=pipe.tokenizer, device=pipe.device,
        # SDXL: concept embeddings from the dual-encoder concat the UNet is
        # conditioned on
        text_params_2=pipe.text_params_2, text_config_2=pipe.text_config_2,
        tokenizer_2=pipe.tokenizer_2)


def debias_measure_seeds(edit_concepts: Sequence[str]) -> list:
    """Stable per-concept generation seeds for the measurement pass
    (builtin hash() is salted per process, so crc32)."""
    return [zlib.crc32(f"{ci}:{c}".encode()) % (2 ** 31)
            for ci, c in enumerate(edit_concepts)]


def _clock(device: torch.device) -> float:
    """Wall seconds after the device's queued work has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def run_debias(
    pipe,
    clip_model,
    edit_concepts: Sequence[str],
    debias_concepts: Sequence[str],
    preserve_concepts: Sequence[str] = (),
    settings: DebiasSettings | None = None,
    save_dir: str | None = None,
    exp_name: str = "uce_test",
    resources=None,
    hypothesis_template: str = DEFAULT_HYPOTHESIS_TEMPLATE,
    image_size: int = 512,
    snapshot_every: int | None = None,
    verbose: bool = True,
    telemetry_path: str | None = None,
    fast=None,
    device_resident: bool = True,
):
    """The closed loop on an SD pipeline.

    pipe: ``diffusion.pipeline.SDPipeline`` (its UNet params are swapped
    each iteration, the reference's ``pipe.unet.load_state_dict``). On a
    mesh (``pipe.apply_mesh``) rank 0 re-solves from the whole targets and
    sends only the changed K/V tensors, each rank keeping its shard of each
    (``workers.update_params``); the measurement images run on the data
    ranks, the classifier on rank 0.
    clip_model: ``models.clip.CLIPModel`` (or anything with ``classify``).
    resources: optional ``SDEditResources`` (default: the pipeline's own
    encoders and the targets of its UNet).
    fast: optional ``sampler.FastConfig`` for the measurement generations,
    opt-in beyond the reference protocol.
    device_resident: re-solve and swap on the card (``DeviceDebiasApplier``);
    False takes the host path (weights to the host and back each
    iteration), bit-identical.

    Returns (weights, acc, history); each history entry also holds the
    iteration's wall ``seconds`` of its re-solve, K/V send (the swap into
    the UNet, on a mesh to every rank), generation and classification.
    """
    settings = settings or DebiasSettings()
    if len(settings.desired_ratios) != len(debias_concepts):
        # fail before the first generate + classify pass, not at the ratio
        # broadcast after it
        raise ValueError(
            f"desired_ratios has {len(settings.desired_ratios)} entries for "
            f"{len(debias_concepts)} debias concepts: they must match")
    start = time.time()
    if resources is None:
        kv = whole_targets(pipe)
        resources = resources_from_pipe(pipe, kv)
    else:
        kv = whole_targets(pipe, [k for k in resources.targets if k in pipe.unet_params])
    device = pipe.device
    concepts = list(edit_concepts) + list(debias_concepts) + list(preserve_concepts)
    concept_embeds = resources.encode_concepts(concepts)
    base_params = pipe.unet_params
    timings = [{}]  # per measurement: the seconds of its solve, send, generate, classify
    layout = (mesh_mod.layout_fn("unet", pipe.unet_config, pipe.mesh.n_model)
              if pipe.mesh is not None else None)

    def swap(edited: dict) -> None:
        """The whole edited K/V into the UNet: on a mesh each rank takes
        its shard of each, and rank 0 keeps its own."""
        if pipe.mesh is not None:
            edited = workers.update_params("unet", edited.items(), layout)
        pipe.unet_params = {**base_params, **edited}

    if device_resident:
        applier = DeviceDebiasApplier(resources.targets, concept_embeds,
                                      edit_concepts, debias_concepts,
                                      preserve_concepts, settings, kv)

        def solve(acc):
            # a token for the controller: the weights stay on the card
            return acc, applier.edited(acc)

        snapshot_weights = applier.export
    else:
        host_solve = make_collapsed_solver(resources.targets, concept_embeds,
                                           edit_concepts, debias_concepts,
                                           preserve_concepts, settings)
        host_weights = [None]

        def solve(acc):
            host_weights[0] = host_solve(acc)
            return host_weights[0], unet_mod.overlay_edits(kv, host_weights[0],
                                                           dtype=pipe.dtype)

        def snapshot_weights():
            return host_weights[0]

    def solve_and_swap(acc):
        t0 = _clock(device)
        out, edited = solve(acc)
        t1 = _clock(device)
        swap(edited)
        timings[-1].update(solve=t1 - t0, send=_clock(device) - t1)
        return out

    labels = [hypothesis_template.format(c) for c in debias_concepts]

    def measure_fn(weights) -> np.ndarray:
        """One batched denoise for all concepts x samples and one batched
        zero-shot classify (the reference loops concepts with 10-image
        pipeline calls, uce_sd_debias.py:21-28). The swap already happened
        in solve_and_swap."""
        del weights
        n_img = settings.num_images_per_prompt
        t0 = _clock(device)
        images = pipe(list(edit_concepts),
                      num_inference_steps=settings.num_inference_steps,
                      guidance_scale=settings.guidance_scale,
                      num_images_per_prompt=n_img,
                      seed=debias_measure_seeds(edit_concepts),
                      height=image_size, width=image_size, fast=fast)
        t1 = _clock(device)
        pred = np.asarray(clip_model.classify(images, labels))
        t2 = _clock(device)
        timings[-1].update(generate=t1 - t0, classify=t2 - t1)
        timings.append({})
        observed = np.zeros((len(edit_concepts), len(debias_concepts)))
        for ci in range(len(edit_concepts)):
            block = pred[ci * n_img:(ci + 1) * n_img]
            for ai in range(len(debias_concepts)):
                observed[ci, ai] = float((block == ai).mean())
        return observed

    telemetry = (DebiasTelemetry(telemetry_path, edit_concepts, debias_concepts)
                 if telemetry_path else None)

    def on_iteration(iteration, observed, ratios):
        if verbose:
            print(f"debias iter {iteration}: observed={observed.tolist()} "
                  f"ratio_diff={ratios.tolist()}")
        if telemetry is not None:
            telemetry.record(iteration, observed, ratios)
        if snapshot_every and save_dir and (iteration + 1) % snapshot_every == 0:
            save_safetensors(snapshot_weights(), os.path.join(
                save_dir, f"{exp_name}_iter{iteration}.safetensors"))

    weights, acc, history = debias_loop(
        solve_and_swap, measure_fn, len(edit_concepts), len(debias_concepts),
        np.asarray(settings.desired_ratios, np.float64), settings.max_iterations,
        settings.max_diff, on_iteration=on_iteration)
    for entry, seconds in zip(history, timings):
        entry["seconds"] = seconds
    if device_resident:
        weights = applier.export()  # the run's one download of the weights
    if history and np.abs(history[-1]["ratios"]).max() == 0 and verbose:
        print("All concepts are debiased")
    if save_dir is not None:
        save_safetensors(weights, os.path.join(save_dir, exp_name + ".safetensors"))
    if verbose:
        print(f"\n\nDebiased concepts using UCE\n"
              f"Model edited in {time.time() - start} seconds\n")
    return weights, acc, history
