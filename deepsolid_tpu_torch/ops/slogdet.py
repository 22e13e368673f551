"""Sign/log-determinant ops for complex orbital matrices.

Mirrors deepsolid_tpu/ops/slogdet.py. The log-sum-exp over determinants
stays in the log domain. `slogdet_op` is differentiable to first order
through `GaussJordanSlogdet`, whose backward is closed-form in the
Gauss-Jordan kernel's own A^-1 output, so the gradient of log psi runs
through that kernel and never through torch.linalg.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from deepsolid_tpu_torch.ops.cuda.det_kernels import gj_inverse_slogdet


class GaussJordanSlogdet(torch.autograd.Function):
    """(sign, log|det|) of (..., n, n) complex matrices through the
    Gauss-Jordan kernel, with a first-order backward rule.

    With t = tr(A^-1 dA): d log|det| = Re t and d sign = i sign Im t
    (the JAX package's rule). In PyTorch's convention for complex
    tensors (a gradient g of a real loss L means dL = Re(conj(g) dz)),
    with g_l and g_s the incoming gradients of log|det| and sign,
        grad A = (g_l + i Im(g_s conj(sign))) * A^-H.
    The JAX rule is written recursively and differentiates to any order
    in both modes; this one is first order only (the backward is not
    itself differentiable), which is all the forward-Laplacian path and
    the energy gradient need.
    """

    @staticmethod
    def forward(ctx, a):
        a_inv, sign, logabs = gj_inverse_slogdet(a)
        ctx.save_for_backward(a_inv, sign)
        return sign, logabs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_sign, g_logabs):
        a_inv, sign = ctx.saved_tensors
        coef = torch.complex(g_logabs, (g_sign * torch.conj(sign)).imag)
        return coef[..., None, None] * torch.conj(a_inv).transpose(-1, -2)


def slogdet_op(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(phase, log|det|) of batched square complex matrices (..., n, n).

    1x1 matrices take a closed form; every other size goes through the
    Gauss-Jordan kernel (its plain version for CPU tensors), forward and
    backward.
    """
    if x.shape[-1] == 1:
        elem = x[..., 0, 0]
        mag = torch.abs(elem)
        return elem / mag, torch.log(mag)
    return GaussJordanSlogdet.apply(x)


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
