"""Kinetic-energy engines: the Laplacian of complex log psi by second
derivatives.

Mirrors deepsolid_tpu/ops/laplacian.py. The local kinetic energy is
  K = -1/2 [ Delta log psi + (grad log psi)^2 ]
with log psi = u + i v, so
  Re K = -1/2 [ Delta u + |grad u|^2 - |grad v|^2 ]
  Im K = -1/2 [ Delta v + 2 grad u . grad v ].

`f(params, x)` is complex log psi of a walker batch x (B, 3N), (B,), with
no walker coupled to another, as the port's network is (its determinant
log-max is detached). Every engine is reverse-over-reverse with the
tangents folded into the walker axis: a walker is repeated once per
(tangent, part) pair, row (b, p, j) carries the gradient of Re log psi
(p = 0) or Im log psi (p = 1) of walker b, and a second backward pass
over the sum of each row's own tangent entry gives, row by row, that
tangent's row of the Hessian. So every pass is one batched network call:
the Gauss-Jordan kernel sees one launch of (B 2 k ndet) matrices a spin,
and the second derivative runs its closed-form rule (ops/slogdet.py),
never the kernel again. Memory grows with the tangents folded at once:
  'for'       - one tangent at a time (3N passes, lowest memory);
  'vmap'      - all 3N tangents at once;
  'partition' - 3N / partition_number tangents a pass. The default;
  'hessian'   - all 3N tangents at once, keeping the full 3N x 3N
                Hessian of u and v per walker, then its trace.
'forward' (models/fwdlap_forward.py) needs the Network object: see
hamiltonian.make_local_energy.
"""

from __future__ import annotations

from typing import Callable

import torch

from deepsolid_tpu_torch.utils.tree import tree_map


def _combine(pu, pv, lap_u, lap_v):
    re = lap_u + torch.sum(pu**2, dim=-1) - torch.sum(pv**2, dim=-1)
    im = lap_v + 2.0 * torch.sum(pu * pv, dim=-1)
    return -0.5 * torch.complex(re, im)


def _hessian_rows(f, params, x, tangents: torch.Tensor, full: bool = False):
    """Second derivatives of u = Re log psi and v = Im log psi along
    `tangents` (k coordinate indices), in one folded pass.

    Returns (pu, pv) the gradients (B, 3N), and the second derivatives
    (B, 2, k) d^2/dx_j^2 of (u, v) for j in tangents, or with `full` the
    Hessian rows (B, 2, k, 3N).
    """
    batch, dim = x.shape
    k = tangents.shape[0]
    params = tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor) else t,
                      params)
    with torch.enable_grad():
        rows = (x.detach()[:, None, None, :].expand(batch, 2, k, dim)
                .reshape(batch * 2 * k, dim).requires_grad_())
        logpsi = f(params, rows).reshape(batch, 2, k)
        parts = torch.stack([logpsi[:, 0].real, logpsi[:, 1].imag], dim=1)
        (grad,) = torch.autograd.grad(parts.sum(), rows, create_graph=True)
        grad = grad.reshape(batch, 2, k, dim)
        own = grad[:, :, torch.arange(k, device=x.device), tangents]  # (B, 2, k)
        (hess,) = torch.autograd.grad(own.sum(), rows)
    hess = hess.reshape(batch, 2, k, dim)
    grad = grad.detach()
    second = hess if full else hess[:, :, torch.arange(k, device=x.device), tangents]
    return grad[:, 0, 0], grad[:, 1, 0], second


def kinetic_for(f) -> Callable:
    """One tangent at a time (hamiltonian.py:45-70 semantics)."""

    def _kinetic(params, x):
        lap = 0.0
        for j in range(x.shape[-1]):
            pu, pv, second = _hessian_rows(
                f, params, x, torch.tensor([j], device=x.device))
            lap = lap + second[..., 0]
        return _combine(pu, pv, lap[:, 0], lap[:, 1])

    return _kinetic


def kinetic_vmap(f) -> Callable:
    """All 3N tangents in one pass (hamiltonian.py:73-101 semantics)."""

    def _kinetic(params, x):
        tangents = torch.arange(x.shape[-1], device=x.device)
        pu, pv, second = _hessian_rows(f, params, x, tangents)
        lap = second.sum(-1)
        return _combine(pu, pv, lap[:, 0], lap[:, 1])

    return _kinetic


def kinetic_partition(f, partition_number: int = 3) -> Callable:
    """`partition_number` passes of 3N / partition_number tangents each
    (hamiltonian.py:127-159 semantics). partition_number must divide 3N."""

    def _kinetic(params, x):
        n = x.shape[-1]
        if n % partition_number != 0:
            raise ValueError(
                f"partition_number={partition_number} must divide 3N={n}")
        lap = 0.0
        for chunk in torch.arange(n, device=x.device).chunk(partition_number):
            pu, pv, second = _hessian_rows(f, params, x, chunk)
            lap = lap + second.sum(-1)
        return _combine(pu, pv, lap[:, 0], lap[:, 1])

    return _kinetic


def kinetic_hessian(f) -> Callable:
    """The trace of the full Hessian of u and v (hamiltonian.py:104-124
    semantics): (B, 3N, 3N) each, then their traces."""

    def _kinetic(params, x):
        tangents = torch.arange(x.shape[-1], device=x.device)
        pu, pv, hess = _hessian_rows(f, params, x, tangents, full=True)
        lap = torch.diagonal(hess, dim1=-2, dim2=-1).sum(-1)
        return _combine(pu, pv, lap[:, 0], lap[:, 1])

    return _kinetic


def make_kinetic(f, mode: str = "partition", partition_number: int = 3) -> Callable:
    """Kinetic-energy function (params, x) -> complex local kinetic energy
    (B,) of a walker batch x (B, 3N).

    `f(params, x)` must return complex log psi (B,) of the walkers.
    """
    if mode == "for":
        return kinetic_for(f)
    if mode in ("vmap", "dim_batch"):
        return kinetic_vmap(f)
    if mode == "partition":
        return kinetic_partition(f, partition_number)
    if mode == "hessian":
        return kinetic_hessian(f)
    if mode == "forward":
        raise ValueError(
            "mode='forward' needs the Network object; use "
            "hamiltonian.make_local_energy(network, supercell, mode='forward') "
            "or models.fwdlap_forward.make_kinetic_forward(network) directly")
    raise ValueError(f"Unknown laplacian mode: {mode}")
