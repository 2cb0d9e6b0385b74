"""Closed-form UCE solve (Eq. 7 of arXiv:2308.14761), collapsed to one
edit matrix.

    W_new = (lam W + sum_i s_i v_i* c_i^T + sum_p p_p v_p c_p^T)
            @ (lam I + sum_i s_i c_i c_i^T + sum_p p_p c_p c_p^T)^-1

with edit concepts c_i, guide outputs v_i*, preserve pairs (c_p, v_p).
When guide outputs come from the edited layer (v_i* = W g_i, true for every
reference script) the edit collapses to one d x d matrix E with
W_new = W @ E for every layer, E = A @ mat2^-1, which one Cholesky solve
gives; ``uce_edit_matrix_batch`` gives one such E per module where each
module sees its own embeddings (HiDream). ``uce_solve_layer`` and
``uce_solve_stacked`` are the general Eq.-7
solves with explicit guide outputs (``edit-sd --method general``): one
factorization of the shared right Gram, batched right-hand sides.
Everything runs in fp32 with TF32 off, like the reference's forced-fp32
inverse.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
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


def _solve_right(mat2, mat1):
    """mat1 @ mat2^-1 for the symmetric [d, d] mat2 and mat1 [..., out, d],
    with one factorization for every row of mat1: Cholesky of the SPD mat2;
    at extreme conditioning (erase_scale ~1e6) the factor or the solve goes
    non-finite and an LU solve is used."""
    d = mat2.shape[0]
    rhs = mat1.reshape(-1, d).T.contiguous()  # [d, N]
    factor, info = torch.linalg.cholesky_ex(mat2)
    x = None
    if int(info) == 0 and bool(torch.isfinite(factor).all()):
        x = torch.cholesky_solve(rhs, factor)
        if not bool(torch.isfinite(x).all()):
            x = None
    if x is None:
        x = torch.linalg.solve(mat2, rhs)
    return x.T.reshape(mat1.shape)


def uce_edit_matrix(c_edit, c_guide, c_pres=None, erase_scale=1.0,
                    preserve_scale=1.0, lamb=0.5) -> torch.Tensor:
    """Collapsed UCE edit E [d, d] (W_new = W_old @ E), E = A mat2^-1."""
    with full_fp32():
        mat2, mat_a = uce_gram_matrices(c_edit, c_pres, erase_scale,
                                        preserve_scale, lamb, c_guide=c_guide)
        return _solve_right(mat2, mat_a).contiguous()


def uce_edit_matrix_batch(c_edit, c_guide, c_pres=None, erase_scale=1.0,
                          preserve_scale=1.0, lamb=0.5) -> torch.Tensor:
    """Per-module collapsed edits E [M, d, d] (W_new[m] = W_old[m] @ E[m])
    from per-module stacks c_edit / c_guide [M, K, d] and c_pres [M, P, d]
    or None: HiDream's caption projections, each fed by its own encoder
    layer. One batched Cholesky factorization and solve for all M; a module
    whose factor or solution is not finite takes an LU solve, as
    ``uce_edit_matrix`` does. At most three [M, d, d] fp32 tensors are
    alive at once (3.3 GB each at M=49, d=4096): A^T, the factor and the
    solution, returned as the transposed view E."""
    with full_fp32():
        c_edit = c_edit.float()
        m, k, d = c_edit.shape
        dev = c_edit.device
        c_guide = c_guide.float().to(dev)
        if c_guide.shape != c_edit.shape:
            raise ValueError(f"c_guide shape {tuple(c_guide.shape)} must match "
                             f"c_edit {tuple(c_edit.shape)}")
        c_pres = (torch.zeros((m, 0, d), device=dev) if c_pres is None
                  else c_pres.float().to(dev))
        s_e = _scale_vector(erase_scale, k, dev)
        s_p = _scale_vector(preserve_scale, c_pres.shape[1], dev)
        # A^T = lam I + sum s c g^T + sum p c_p c_p^T, mat2 = lam I + sum s c c^T
        # + sum p c_p c_p^T, both built in place from the same start
        mat_at = torch.diag_embed(torch.full((m, d), float(lamb), device=dev))
        mat_at.baddbmm_((c_pres * s_p[:, None]).transpose(1, 2), c_pres)
        mat2 = mat_at.clone()
        edit_t = (c_edit * s_e[:, None]).transpose(1, 2)
        mat2.baddbmm_(edit_t, c_edit)
        mat_at.baddbmm_(edit_t, c_guide)
        factor, info = torch.linalg.cholesky_ex(mat2)
        del mat2
        x = torch.cholesky_solve(mat_at, factor)  # E^T = mat2^-1 A^T
        bad = (info != 0) | ~torch.isfinite(factor).flatten(1).all(1) \
            | ~torch.isfinite(x).flatten(1).all(1)
        del factor
        for i in torch.nonzero(bad).flatten().tolist():
            mat2_i, _ = uce_gram_matrices(c_edit[i], c_pres[i], s_e, s_p, lamb)
            x[i] = torch.linalg.solve(mat2_i, mat_at[i])
        return x.transpose(1, 2)


def uce_solve_layer(w_old, c_edit, v_guide, c_pres=None, v_pres=None,
                    erase_scale=1.0, preserve_scale=1.0, lamb=0.5) -> torch.Tensor:
    """General Eq.-7 solve for one layer with explicit guide outputs.

    w_old [out, d], c_edit [K, d], v_guide [K, out] (need not equal
    W_old @ g), c_pres [P, d] or None, v_pres [P, out] or None (then the
    original outputs W_old @ c_p). Returns [out, d] in w_old's dtype."""
    return uce_solve_stacked(w_old[None], c_edit, v_guide[None], c_pres,
                             None if v_pres is None else v_pres[None],
                             erase_scale, preserve_scale, lamb)[0]


def uce_solve_stacked(w_stack, c_edit, v_guide, c_pres=None, v_pres=None,
                      erase_scale=1.0, preserve_scale=1.0, lamb=0.5) -> torch.Tensor:
    """Batched Eq.-7 solve over a stack of layers sharing the input dim.

    w_stack [L, out, d], c_edit [K, d], v_guide [L, K, out], c_pres [P, d]
    or None, v_pres [L, P, out] or None (then W_old @ c_p per layer). The
    right Gram is layer-independent: built and factored once, with the
    layers' rows as batched right-hand sides. Returns [L, out, d] in
    w_stack's dtype."""
    with full_fp32():
        w32 = w_stack.float()
        c_edit = c_edit.float().to(w32.device)
        d = c_edit.shape[1]
        c_pres = (torch.zeros((0, d), device=w32.device) if c_pres is None
                  else c_pres.float().to(w32.device))
        if v_pres is None:
            v_pres = torch.einsum("pd,lod->lpo", c_pres, w32)
        s_e = _scale_vector(erase_scale, c_edit.shape[0], w32.device)
        s_p = _scale_vector(preserve_scale, c_pres.shape[0], w32.device)
        mat1 = (float(lamb) * w32
                + torch.einsum("k,lko,kd->lod", s_e, v_guide.float().to(w32.device),
                               c_edit)
                + torch.einsum("p,lpo,pd->lod", s_p, v_pres.float(), c_pres))
        mat2, _ = uce_gram_matrices(c_edit, c_pres, s_e, s_p, lamb)
        return _solve_right(mat2, mat1).to(w_stack.dtype)


def apply_edit_matrix(w_old: torch.Tensor, edit_matrix: torch.Tensor) -> torch.Tensor:
    """W_new = W_old @ E in fp32; the output keeps W_old's dtype."""
    with full_fp32():
        return (w_old.float() @ edit_matrix.float()).to(w_old.dtype)
