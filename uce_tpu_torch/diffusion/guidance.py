"""Guidance modes beyond CFG: the reference's three comparison baselines
(uce_tpu/diffusion/guidance.py), as combine functions over stacked eps
branches.

  * Concept algebra  [uncond; text; p0; p1; p2]: project the (text - p2)
    score difference off the normalized (p1 - p0) direction before CFG
    (evalscripts/concept_algebra.py:99-123).
  * SLD              [uncond; text; safety]: Safe Latent Diffusion
    (Schramowski et al. 2023) with its Weak/Medium/Max presets
    (evalscripts/sld-generate-images.py:48-66).
  * Debias-VL        a projection P = (lam*M + I)^-1 applied to the text
    embeddings (evalscripts/debiasing_vl.py:12-23,76-79,110-112); plain CFG
    at the eps level.

The combines keep uce_tpu's dtypes: the branches arrive in the model dtype,
Python constants are rounded to it (JAX's weak typing), the guidance scale
is an fp32 scalar (so the combined eps is fp32), and SLD's momentum is fp32.
The numpy helpers of the calibration are copies of uce_tpu's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    """A Python constant as JAX combines it with ``x``: rounded to x's dtype."""
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def concept_algebra_combine(eps_branches: torch.Tensor,
                            guidance_scale: float) -> torch.Tensor:
    """5-way combine. The norm of (p1 - p0) and the projection are
    whole-tensor sums across the sample batch, in fp32, as the reference
    computes them (concept_algebra.py:113-118): an image depends on the
    other samples of its batch."""
    uncond, text, p0, p1, p2 = eps_branches.chunk(5, dim=0)
    noise_tmp = (text - p2).float()
    u32 = (p1 - p0).float()
    u32 = u32 / torch.sqrt((u32 ** 2).sum())
    proj = (noise_tmp * u32).sum()
    text = (text.float() - proj * u32).to(text.dtype)
    return uncond.float() + guidance_scale * (text - uncond).float()


@dataclasses.dataclass(frozen=True)
class SLDConfig:
    sld_guidance_scale: float = 1000.0
    sld_warmup_steps: int = 10
    sld_threshold: float = 0.01
    sld_momentum_scale: float = 0.3
    sld_mom_beta: float = 0.4

    @classmethod
    def preset(cls, name: str) -> "SLDConfig":
        """Weak/Medium/Max presets (sld-generate-images.py:48-66)."""
        return {
            "Medium": cls(1000.0, 10, 0.01, 0.3, 0.4),
            "Max": cls(5000.0, 0, 1.0, 0.5, 0.7),
            "Weak": cls(200.0, 15, 0.0, 0.0, 0.0),
        }[name]


DEFAULT_SAFETY_CONCEPT = (
    "an image showing hate, harassment, violence, suffering, humiliation, "
    "harm, suicide, sexual, nudity, bodily fluids, blood, obscene gestures, "
    "illegal activity, drug use, theft, vandalism, weapons, child abuse, "
    "brutality, cruelty"
)


def sld_combine(eps_branches: torch.Tensor, guidance_scale: float, step_index: int,
                momentum: torch.Tensor, cfg: SLDConfig):
    """3-way combine with the safety momentum carried across calls; returns
    (eps, new_momentum). The SLDPipeline update: elementwise safety scale
    clamp, threshold gate, momentum accumulation (also during warmup), and
    the warmup gate on ``step_index``, the index of the scheduler call."""
    uncond, text, safety = eps_branches.chunk(3, dim=0)
    guidance = text - uncond

    diff = text - safety
    scale = torch.clamp(diff.abs() * _const(diff, cfg.sld_guidance_scale), max=1.0)
    safety_scale = torch.where(diff >= _const(diff, cfg.sld_threshold),
                               _const(scale, 0.0), scale)
    guidance_safety = (safety - uncond) * safety_scale
    guidance_safety = guidance_safety + cfg.sld_momentum_scale * momentum
    new_momentum = (cfg.sld_mom_beta * momentum
                    + (1.0 - cfg.sld_mom_beta) * guidance_safety)

    if step_index >= cfg.sld_warmup_steps:
        guidance = guidance - guidance_safety
    eps = uncond.float() + guidance_scale * guidance.float()
    return eps, new_momentum


def debias_vl_pair_matrix(z_i: np.ndarray, z_j: np.ndarray) -> np.ndarray:
    """A = z_i z_i^T + z_j z_j^T - z_i z_j^T - z_j z_i^T
    (debiasing_vl.py:12-15) == (z_i - z_j)(z_i - z_j)^T."""
    zi, zj = z_i[:, None], z_j[:, None]
    return zi @ zi.T + zj @ zj.T - zi @ zj.T - zj @ zi.T


def debias_vl_calibration(embeddings: np.ndarray, pairs,
                          lam: float = 500.0) -> np.ndarray:
    """P = (lam * mean_pairs A + I)^-1 in float64 (debiasing_vl.py:18-23,76-79)."""
    if not len(pairs):
        raise ValueError(
            "debias_vl_calibration needs at least one concept pair "
            "(empty --concepts?); dividing by zero pairs would produce "
            "a NaN projection that silently corrupts every embedding")
    d = embeddings.shape[1]
    m = np.zeros((d, d))
    for i, j in pairs:
        m += debias_vl_pair_matrix(embeddings[i], embeddings[j])
    m /= len(pairs)
    return np.linalg.inv(lam * m + np.eye(d))


def build_gender_pairs(debias_concepts) -> tuple[list[str], list[list[int]]]:
    """Male/female prompt pairs (debiasing_vl.py:59-67)."""
    prompts, pairs, counter = [], [], 0
    for cls_name in debias_concepts:
        cls_name = cls_name.lower()
        prompts += [f"A photo of a male {cls_name}.",
                    f"A photo of a female {cls_name}."]
        pairs.append([counter, counter + 1])
        counter += 2
    return prompts, pairs


DEBIAS_VL_DEFAULT_PROFESSIONS = [
    "Actor", "Architect", "Audiologist", "Author", "Baker", "Barber",
    "Blacksmith", "Bricklayer", "Bus Driver", "Butcher", "Chef", "Chemist",
    "Cleaner", "Coach", "Comedian", "Computer Programmer",
    "Construction Worker", "Consultant", "Counselor", "Dancer", "Dentist",
    "Designer", "Dietitian", "DJ", "Doctor", "Driver", "Economist",
    "Electrician", "Engineer", "Entrepreneur", "Farmer", "Florist",
    "Graphic Designer", "Hairdresser", "Historian", "Journalist", "Judge",
    "Lawyer", "Librarian", "Magician", "Makeup Artist", "Mathematician",
    "Marine Biologist", "Mechanic", "Model", "Musician", "Nanny", "Nurse",
    "Optician", "Painter", "Pastry Chef", "Pediatrician", "Photographer",
    "Plumber", "Police Officer", "Politician", "Professor", "Psychologist",
    "Real Estate Agent", "Receptionist", "Recruiter", "Researcher", "Sailor",
    "Salesperson", "Surveyor", "Singer", "Social Worker",
    "Software Developer", "Statistician", "Surgeon", "Teacher", "Technician",
    "Therapist", "Tour Guide", "Translator", "Vet", "Videographer", "Waiter",
    "Writer", "Zoologist",
]
