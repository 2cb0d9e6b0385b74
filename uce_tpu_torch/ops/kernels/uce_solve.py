"""Fused UCE edit matrix through a Newton-Schulz inverse: the hand-written
Hopper kernel chain and its plain PyTorch version.

The counterpart of ``uce_tpu/ops/pallas/uce_solve.py::uce_edit_matrix_pallas``.
``newton_schulz_inverse`` computes ``X ~= B^-1`` for
``B = lam*I + s*Ce^T Ce + p*Cp^T Cp`` by ``NEWTON_ITERS`` steps of
``X <- X(2I - BX)`` from ``X_0 = I/||B||_inf``, all in fp32: a CPU tensor
takes the plain version, a CUDA tensor launches ``csrc/uce_solve.cu`` (d a
multiple of 4, as CLIP's 768 and 1024 are) or raises.
``uce_edit_matrix_pallas`` then forms ``E = A X`` and one step of iterative
refinement ``E += (A - E B) X`` with fp32 matmuls, TF32 off.
"""

from __future__ import annotations

import ctypes

import torch

from uce_tpu_torch.ops.kernels import count
from uce_tpu_torch.ops.solver import full_fp32, uce_gram_matrices

SOURCE = "uce_solve.cu"
NEWTON_ITERS = 40
MAX_PALLAS_DIM = 1024


def newton_schulz_reference(c_edit, c_pres, erase_scale: float,
                            preserve_scale: float, lamb: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel chain: X ~= B^-1 [d, d] fp32."""
    d = c_edit.shape[1]
    eye = torch.eye(d, dtype=torch.float32, device=c_edit.device)
    with full_fp32():
        b = (erase_scale * (c_edit.T @ c_edit)
             + preserve_scale * (c_pres.T @ c_pres) + lamb * eye)
        x = eye / b.abs().sum(dim=1).max()
        for _ in range(NEWTON_ITERS):
            x = x @ (2.0 * eye - b @ x)
    return x


def _lib():
    from uce_tpu_torch.ops.kernels._build import load_library

    lib = load_library("uce_solve", (SOURCE,))
    fn = lib.uce_newton_schulz
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                   ctypes.c_int] + [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    return fn


def newton_schulz_inverse(c_edit: torch.Tensor, c_pres: torch.Tensor,
                          erase_scale: float, preserve_scale: float,
                          lamb: float) -> torch.Tensor:
    """c_edit [K, d], c_pres [P, d] (P may be 0) fp32 -> X ~= B^-1 [d, d]."""
    c_edit = c_edit.float().contiguous()
    c_pres = c_pres.float().to(c_edit.device).contiguous()
    d = c_edit.shape[1]
    if c_pres.ndim != 2 or c_pres.shape[1] != d:
        raise ValueError(f"newton_schulz_inverse: c_pres {tuple(c_pres.shape)} "
                         f"must be [P, {d}]")
    if c_edit.device.type == "cpu":
        return newton_schulz_reference(c_edit, c_pres, erase_scale,
                                       preserve_scale, lamb)
    if c_edit.device.type != "cuda":
        raise ValueError(f"newton_schulz_inverse: unsupported device {c_edit.device}")
    if d % 4:
        raise ValueError(f"newton_schulz_inverse: d={d} must be a multiple of 4 "
                         "(the kernel's tensor maps need 16-byte rows)")
    x = torch.empty((d, d), device=c_edit.device, dtype=torch.float32)
    scratch = torch.empty(3 * d * d + 1, device=c_edit.device, dtype=torch.float32)
    bm, t, xn = (scratch[i * d * d:(i + 1) * d * d] for i in range(3))
    stream = torch.cuda.current_stream(c_edit.device).cuda_stream
    with torch.cuda.device(c_edit.device):
        err = _lib()(c_edit.data_ptr(), c_edit.shape[0], c_pres.data_ptr(),
                     c_pres.shape[0], d, float(lamb), float(erase_scale),
                     float(preserve_scale), NEWTON_ITERS, x.data_ptr(),
                     bm.data_ptr(), t.data_ptr(), xn.data_ptr(),
                     scratch[3 * d * d:].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"uce_solve kernel launch failed (cudaError {err})")
    count("uce_solve")
    return x


def uce_edit_matrix_pallas(c_edit, c_guide, c_pres, erase_scale: float,
                           preserve_scale: float, lamb: float) -> torch.Tensor:
    """E [d, d] with W_new = W_old @ E, uniform scalar scales only (the
    per-concept-scale path is ops.solver). d above MAX_PALLAS_DIM raises,
    as in uce_tpu."""
    d = c_edit.shape[-1]
    if d > MAX_PALLAS_DIM:
        raise ValueError(f"pallas edit kernel supports d <= {MAX_PALLAS_DIM}, "
                         f"got {d}")
    c_edit = c_edit.float()
    c_pres = (torch.zeros((0, d), device=c_edit.device) if c_pres is None
              else c_pres.float().to(c_edit.device))
    x_inv = newton_schulz_inverse(c_edit, c_pres, erase_scale, preserve_scale,
                                  lamb)
    with full_fp32():
        b_mat, a_mat = uce_gram_matrices(c_edit, c_pres, erase_scale,
                                         preserve_scale, lamb, c_guide=c_guide)
        e = a_mat @ x_inv
        return e + (a_mat - e @ b_mat) @ x_inv
