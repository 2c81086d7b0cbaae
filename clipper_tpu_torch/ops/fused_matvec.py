"""Fused pattern dual matvec: (M u, C u) from one read of M.

Counterpart of ``clipper_tpu/ops/fused_matvec.py``. In the batched engine
C is exactly the 0/1 nonzero pattern of M (reference:
src/clipper.cpp:63-64), so Cu_i = sum_j [M_ij > 0] u_j comes from the same
read of M as Mu: half the traffic of a stacked [M; C] product.

:func:`pattern_dual_matvec` wraps the hand-written CUDA kernel
csrc/pattern_matvec.cu for tensors on the card and takes the plain
version, :func:`pattern_dual_matvec_plain`, only for CPU tensors; a failed
build or launch raises. The JAX function's ``row_tile`` was a VMEM tiling
knob and has no counterpart here.
"""

from __future__ import annotations

import torch

from clipper_tpu_torch import _kernels


def pattern_dual_matvec_plain(M: torch.Tensor, u: torch.Tensor):
    """Plain PyTorch version: M (B, m, m) f32/bf16/f64 converted to f32,
    u (B, m) -> (Mu, Cu), each (B, m) f32."""
    Mf = M.float()
    uf = u.float()[:, None, :]
    return ((Mf * uf).sum(-1),
            torch.where(Mf > 0, uf, 0.0).sum(-1))


def pattern_dual_matvec_cuda(M: torch.Tensor, u: torch.Tensor):
    """Launch csrc/pattern_matvec.cu on M (B, m, m) f32/bf16 and u (B, m)
    on the card -> (Mu, Cu), each (B, m) f32."""
    if M.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"pattern matvec kernel takes f32/bf16 M, not {M.dtype} (the "
            "TPU kernel computes in f32 as well)")
    if not (M.is_cuda and u.is_cuda):
        raise ValueError("pattern matvec kernel: M and u must lie on the "
                         "card")
    B, m, m2 = M.shape
    if m != m2 or tuple(u.shape) != (B, m):
        raise ValueError(f"pattern matvec: M {tuple(M.shape)} and u "
                         f"{tuple(u.shape)} do not match")
    Mc = M.contiguous()
    uc = u.to(torch.float32).contiguous()
    Mu = torch.empty(B, m, dtype=torch.float32, device=M.device)
    Cu = torch.empty_like(Mu)
    lib = _kernels.lib("pattern_matvec")
    fn = (lib.pattern_matvec_f32 if M.dtype == torch.float32
          else lib.pattern_matvec_bf16)
    code = fn(Mc.data_ptr(), uc.data_ptr(), Mu.data_ptr(), Cu.data_ptr(),
              B, m, int(Mc.data_ptr() % 16 == 0),
              _kernels.stream_ptr(M.device))
    _kernels.check(code, "pattern_matvec")
    _kernels.LAUNCHES["pattern_matvec"] += 1
    return Mu, Cu


def pattern_dual_matvec(M: torch.Tensor, u: torch.Tensor):
    """(Mu, Cu) with C = pattern(M). M: (B, m, m); u: (B, m). f32 outputs.
    CUDA tensors launch the kernel, CPU tensors take the plain version."""
    fn = pattern_dual_matvec_cuda if M.is_cuda else pattern_dual_matvec_plain
    return fn(M, u)


def make_pattern_dual_matvec(M_row: torch.Tensor):
    """Single-problem closure u -> (M u, C u) for M_row (m, m) and u (m,),
    outputs in u's dtype."""

    def mv(u):
        Mu, Cu = pattern_dual_matvec(M_row[None], u[None])
        return Mu[0].to(u.dtype), Cu[0].to(u.dtype)

    return mv


__all__ = ["pattern_dual_matvec", "pattern_dual_matvec_plain",
           "pattern_dual_matvec_cuda", "make_pattern_dual_matvec"]
