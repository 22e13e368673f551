"""Sign/log-determinant ops for complex orbital matrices.

Mirrors deepsolid_tpu/ops/slogdet.py (value path only; the twice-
differentiable custom rule belongs to the training slice). The log-sum-
exp over determinants stays in the log domain.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from deepsolid_tpu_torch.ops.cuda.det_kernels import gj_inverse_slogdet


def slogdet_op(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(phase, log|det|) of batched square complex matrices (..., n, n).

    1x1 matrices take a closed form; every other size goes through the
    Gauss-Jordan kernel (its plain version for CPU tensors).
    """
    if x.shape[-1] == 1:
        elem = x[..., 0, 0]
        mag = torch.abs(elem)
        return elem / mag, torch.log(mag)
    _, sign, logabs = gj_inverse_slogdet(x)
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
