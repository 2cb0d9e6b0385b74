"""The closed-form UCE erase (arXiv:2308.14761, Eq. 7) solved in float64.

With guide outputs taken from the edited layer (v* = W g), every target
weight becomes W @ E with E = A mat2^-1,
    mat2 = lam I + sum_e c_e c_e^T + sum_p c_p c_p^T,
    A    = lam I + sum_e g_e c_e^T + sum_p c_p c_p^T
for edit embeddings c_e, guide embeddings g_e and preserved c_p (unit
erase and preserve scales).
"""

from __future__ import annotations

import torch


def edit_matrix(c_edit, c_guide, c_pres, lamb: float = 0.5) -> torch.Tensor:
    c_edit, c_guide, c_pres = (c.double() for c in (c_edit, c_guide, c_pres))
    eye = lamb * torch.eye(c_edit.shape[1], dtype=torch.float64, device=c_edit.device)
    mat2 = eye + c_edit.T @ c_edit + c_pres.T @ c_pres
    mat_a = eye + c_guide.T @ c_edit + c_pres.T @ c_pres
    return torch.linalg.solve(mat2, mat_a.T).T


def erase(weights: dict, c_edit, c_guide, c_pres) -> dict:
    """{name: W} -> {name: W @ E}, float32."""
    e = edit_matrix(c_edit, c_guide, c_pres)
    return {k: (w.double() @ e).float() for k, w in weights.items()}
