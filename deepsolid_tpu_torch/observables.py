"""Observables: complex polarization and structure factor.

Mirrors deepsolid_tpu/observables.py on tensors. `all_mean` averages over
the data ranks (parallel.Mesh.all_mean), as the JAX versions take pmean
over the data axis; None means one process.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from deepsolid_tpu_torch.system.cell import Cell, reciprocal_vectors


def _identity(t):
    return t


def make_complex_polarization(sc: Cell, direction: int = 0,
                              all_mean: Optional[Callable] = None):
    """data (B, 3N) -> <exp(i b . sum_i r_i)>, b the `direction`-th
    reciprocal vector of the simulation cell (complex scalar)."""
    pmean = all_mean or _identity
    rec_vec = reciprocal_vectors(sc.lattice)[direction]

    def complex_polarization(data):
        pos = data.reshape(*data.shape[:-1], -1, 3)
        dots = torch.sum(pos @ torch.as_tensor(rec_vec, dtype=pos.dtype,
                                               device=pos.device), dim=-1)
        return pmean(torch.mean(torch.exp(1j * dots), dim=-1))

    return complex_polarization


def make_structure_factor(sc: Cell, nq: int = 4,
                          all_mean: Optional[Callable] = None):
    """data (B, 3N) -> S(k) (nq^3,) on the reciprocal mesh of the
    simulation cell, (<|rho_k|^2> - |<rho_k>|^2) / N (finite-size
    corrections, PRB 94, 035126)."""
    pmean = all_mean or _identity
    mesh = np.meshgrid(*[np.arange(nq)] * 3, indexing="ij")
    points = np.stack([m.ravel() for m in mesh], axis=0).T
    qvecs = points @ reciprocal_vectors(sc.lattice)
    nelec = sc.nelectron

    def structure_factor(data):
        pos = data.reshape(*data.shape[:-1], -1, 3)
        q = torch.as_tensor(qvecs, dtype=pos.dtype, device=pos.device)
        rho_k = torch.sum(torch.exp(1j * (pos @ q.T)), dim=-2)  # over electrons
        rho_one = pmean(torch.mean(rho_k, dim=0))
        rho_two = pmean(torch.mean(torch.abs(rho_k) ** 2, dim=0))
        return (rho_two - torch.abs(rho_one) ** 2) / nelec

    return structure_factor
