"""Sign/log-determinant ops for complex orbital matrices.

Mirrors deepsolid_tpu/ops/slogdet.py. The log-sum-exp over determinants
stays in the log domain. `slogdet_op` goes through `GaussJordanAll`, the
Gauss-Jordan kernel's three outputs with autograd rules in closed form in
those outputs (reverse, forward and vmap), so log psi differentiates to
any order in either mode through that kernel and never through
torch.linalg.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from deepsolid_tpu_torch.ops.cuda.det_kernels import gj_inverse_slogdet


class GaussJordanAll(torch.autograd.Function):
    """(A^-1, sign, log|det|) of (..., n, n) complex matrices through the
    Gauss-Jordan kernel, differentiable to any order.

    With t = tr(A^-1 dA): d(A^-1) = -A^-1 dA A^-1, d log|det| = Re t and
    d sign = i sign Im t (the JAX package's rule). In PyTorch's
    convention for complex tensors (a gradient g of a real loss L means
    dL = Re(conj(g) dz)), with g_inv, g_s and g_l the incoming gradients
    of A^-1, sign and log|det|,
        grad A = coef A^-H - A^-H g_inv A^-H,
        coef = g_l + i Im(g_s conj(sign)).
    Both rules are torch ops on the saved outputs A^-1 and sign, which
    carry this Function's own graph: a second derivative flows back
    through the same rule and never launches the kernel again. The vmap
    rule folds the mapped axis into the kernel's leading batch axes, so
    the kernel only ever sees plain tensors.
    """

    @staticmethod
    def forward(a):
        return gj_inverse_slogdet(a)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a_inv, sign, _ = output
        ctx.save_for_backward(a_inv, sign)
        ctx.save_for_forward(a_inv, sign)
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, g_inv, g_sign, g_logabs):
        a_inv, sign = ctx.saved_tensors
        a_inv_h = torch.conj(a_inv).transpose(-1, -2)
        coef = None
        if g_logabs is not None:
            coef = torch.complex(g_logabs, torch.zeros_like(g_logabs))
        if g_sign is not None:
            rot = 1j * (g_sign * torch.conj(sign)).imag
            coef = rot if coef is None else coef + rot
        grad = None if coef is None else coef[..., None, None] * a_inv_h
        if g_inv is not None:
            term = -(a_inv_h @ g_inv @ a_inv_h)
            grad = term if grad is None else grad + term
        return grad

    @staticmethod
    def jvp(ctx, da):
        a_inv, sign = ctx.saved_tensors
        t = torch.sum(a_inv.transpose(-1, -2) * da, dim=(-1, -2))
        return -(a_inv @ da @ a_inv), 1j * sign * t.imag, t.real

    @staticmethod
    def vmap(info, in_dims, a):
        (dim,) = in_dims
        if dim is None:
            return GaussJordanAll.apply(a), (None, None, None)
        return GaussJordanAll.apply(a.movedim(dim, 0)), (0, 0, 0)


def slogdet_op(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(phase, log|det|) of batched square complex matrices (..., n, n).

    1x1 matrices take a closed form; every other size goes through the
    Gauss-Jordan kernel (its plain version for CPU tensors), in value and
    in every derivative.
    """
    if x.shape[-1] == 1:
        elem = x[..., 0, 0]
        mag = torch.abs(elem)
        return elem / mag, torch.log(mag)
    _, sign, logabs = GaussJordanAll.apply(x)
    return sign, logabs


def logdet_matmul(
    xs: Sequence[torch.Tensor], w: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted sum of determinant products in the log domain.

    xs: orbital matrices per spin channel, each (B, ndet, n_s, n_s).
    w: optional (ndet,) weights (uniform if None).
    Returns (phase (B,), log|sum_d w_d prod_s det_d^s| (B,)).
    """
    sign, logdet = None, None
    for x in xs:
        s, l = slogdet_op(x)
        sign, logdet = (s, l) if sign is None else (sign * s, logdet + l)
    logmax = torch.amax(logdet, dim=-1, keepdim=True).detach()
    det = sign * torch.exp(logdet - logmax)
    result = torch.sum(det, dim=-1) if w is None else det @ w.to(det.dtype)
    mag = torch.abs(result)
    return result / mag, torch.log(mag) + logmax[..., 0]
