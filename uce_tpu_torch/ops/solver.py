"""Closed-form UCE solve (Eq. 7 of arXiv:2308.14761), collapsed to one
edit matrix.

    W_new = (lam W + sum_i s_i v_i* c_i^T + sum_p p_p v_p c_p^T)
            @ (lam I + sum_i s_i c_i c_i^T + sum_p p_p c_p c_p^T)^-1

with edit concepts c_i, guide outputs v_i*, preserve pairs (c_p, v_p).
When guide outputs come from the edited layer (v_i* = W g_i, true for every
reference script) the edit collapses to one d x d matrix E with
W_new = W @ E for every layer, E = A @ mat2^-1, which one Cholesky solve
gives. Everything runs in fp32 with TF32 off, like the reference's
forced-fp32 inverse.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _full_fp32():
    """TF32 off for the enclosed fp32 matmuls (restored afterwards)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _scale_vector(scale, n: int, device) -> torch.Tensor:
    s = torch.as_tensor(scale, dtype=torch.float32, device=device)
    if s.ndim == 0:
        s = s.expand(n)
    if tuple(s.shape) != (n,):
        raise ValueError(f"scale must be scalar or shape ({n},), got {tuple(s.shape)}")
    return s


def _weighted_cross_gram(a, b, s):
    """sum_i s_i a_i b_i^T for stacks a [K, da], b [K, db] -> [da, db]."""
    return (a * s[:, None]).T @ b


def uce_gram_matrices(c_edit, c_pres, erase_scale, preserve_scale, lamb, *,
                      c_guide=None):
    """(mat2, A): mat2 = lam I + sum s c c^T + sum p c_p c_p^T and, when
    ``c_guide`` is given, A = lam I + sum s g c^T + sum p c_p c_p^T."""
    c_edit = c_edit.float()
    k, d = c_edit.shape
    dev = c_edit.device
    c_pres = (torch.zeros((0, d), device=dev) if c_pres is None
              else c_pres.float().to(dev))
    s_e = _scale_vector(erase_scale, k, dev)
    s_p = _scale_vector(preserve_scale, c_pres.shape[0], dev)
    eye = float(lamb) * torch.eye(d, dtype=torch.float32, device=dev)
    pres = _weighted_cross_gram(c_pres, c_pres, s_p)
    mat2 = eye + _weighted_cross_gram(c_edit, c_edit, s_e) + pres
    mat_a = None
    if c_guide is not None:
        c_guide = c_guide.float().to(dev)
        if c_guide.shape != c_edit.shape:
            raise ValueError(f"c_guide shape {tuple(c_guide.shape)} must match "
                             f"c_edit {tuple(c_edit.shape)}")
        mat_a = eye + _weighted_cross_gram(c_guide, c_edit, s_e) + pres
    return mat2, mat_a


def uce_edit_matrix(c_edit, c_guide, c_pres=None, erase_scale=1.0,
                    preserve_scale=1.0, lamb=0.5) -> torch.Tensor:
    """Collapsed UCE edit E [d, d] (W_new = W_old @ E), E^T = mat2^-1 A^T.

    Cholesky of the SPD mat2; at extreme conditioning (erase_scale ~1e6)
    the factor or the solve goes non-finite and an LU solve is used."""
    with _full_fp32():
        mat2, mat_a = uce_gram_matrices(c_edit, c_pres, erase_scale,
                                        preserve_scale, lamb, c_guide=c_guide)
        rhs = mat_a.T.contiguous()
        factor, info = torch.linalg.cholesky_ex(mat2)
        x = None
        if int(info) == 0 and bool(torch.isfinite(factor).all()):
            x = torch.cholesky_solve(rhs, factor)
            if not bool(torch.isfinite(x).all()):
                x = None
        if x is None:
            x = torch.linalg.solve(mat2, rhs)
        return x.T.contiguous()


def apply_edit_matrix(w_old: torch.Tensor, edit_matrix: torch.Tensor) -> torch.Tensor:
    """W_new = W_old @ E in fp32; the output keeps W_old's dtype."""
    with _full_fp32():
        return (w_old.float() @ edit_matrix.float()).to(w_old.dtype)
