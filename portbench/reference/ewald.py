"""The Coulomb energy of electrons and ions in the periodic simulation
cell, by Ewald summation:
  E = 1/2 sum_{i != j, images} q_i q_j erfc(alpha r) / r
    + (2 pi / V) sum_{G != 0} exp(-G^2 / 4 alpha^2) / G^2 |sum_i q_i e^{iG.r_i}|^2
    - alpha / sqrt(pi) sum_i q_i^2
(the cell is neutral, so no background term). alpha = 5 / (the smallest
distance between lattice planes); images run over a 5 x 5 x 5 block of
cells around the minimal image, reciprocal vectors over a box that holds
every weight above 1e-16. Both sums are converged far below the
precision of the comparison.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from portbench.reference.network import tensor
from portbench.reference.system import System, reciprocal


class Ewald:
    def __init__(self, system: System):
        lattice = system.sim_lattice
        self.lattice = lattice
        self.volume = abs(np.linalg.det(lattice))
        heights = 1.0 / np.linalg.norm(np.linalg.inv(lattice).T, axis=1)
        self.alpha = 5.0 / heights.min()
        self.ions = system.sim_atoms
        self.charges = system.sim_charges
        self.nelec = system.nelectron
        self.images = np.asarray(list(itertools.product(range(-2, 3), repeat=3)),
                                 np.float64) @ lattice
        rec = reciprocal(lattice)
        g_max = 2.0 * self.alpha * math.sqrt(-math.log(1e-17))
        reach = np.ceil(g_max * np.linalg.norm(lattice, axis=1) / (2 * np.pi)).astype(int)
        ns = np.asarray(list(itertools.product(*[range(-r, r + 1) for r in reach])),
                        np.float64)
        g = ns @ rec
        g2 = np.sum(g * g, axis=1)
        keep = (g2 > 0) & (g2 < g_max**2)
        g, g2 = g[keep], g2[keep]
        weight = 2.0 * np.pi / self.volume * np.exp(-g2 / (4 * self.alpha**2)) / g2
        keep = weight > 1e-16 * weight.max()
        self.g, self.g_weight = g[keep], weight[keep]
        self.constant = self._ion_real() - self.alpha / math.sqrt(math.pi) * (
            float(np.sum(self.charges**2)) + self.nelec)

    def _minimal(self, d: torch.Tensor) -> torch.Tensor:
        inv = tensor(np.linalg.inv(self.lattice), d)
        frac = d @ inv
        return (frac - torch.round(frac)) @ tensor(self.lattice, d)

    def _real(self, d: torch.Tensor) -> torch.Tensor:
        """sum over images of erfc(alpha r) / r for displacements (..., 3)."""
        r = torch.linalg.norm(self._minimal(d)[..., None, :] + tensor(self.images, d),
                              dim=-1)
        return torch.sum(torch.special.erfc(self.alpha * r) / r, dim=-1)

    def _ion_real(self) -> float:
        ions = torch.as_tensor(self.ions, dtype=torch.float64)
        q = torch.as_tensor(self.charges, dtype=torch.float64)
        i, j = np.triu_indices(len(q), 1)
        return float(torch.sum(q[i] * q[j] * self._real(ions[i] - ions[j])))

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        """Total Coulomb energy (B,) of walkers x (B, 3n): the real-space
        sums of the electrons, the reciprocal sum of all charges and the
        constant ion-ion real-space and self terms."""
        batch, n = x.shape[0], self.nelec
        pos = x.reshape(batch, n, 3)
        ions = tensor(self.ions, x)
        q = tensor(self.charges, x)
        i, j = np.triu_indices(n, 1)
        ee = torch.sum(self._real(pos[:, i] - pos[:, j]), dim=-1)
        ei = -torch.sum(q * self._real(pos[:, :, None, :] - ions), dim=(-1, -2))
        g = tensor(self.g, x)
        pe, pi = pos @ g.T, ions @ g.T
        s_re = q @ torch.cos(pi) - torch.cos(pe).sum(dim=1)
        s_im = q @ torch.sin(pi) - torch.sin(pe).sum(dim=1)
        recip = (s_re**2 + s_im**2) @ tensor(self.g_weight, x)
        return ee + ei + recip + self.constant
