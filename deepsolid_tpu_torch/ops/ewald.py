"""Ewald summation for the periodic Coulomb Hamiltonian.

Mirrors deepsolid_tpu/ops/ewald.py: the same host-side setup in float64
numpy (G-vectors inside the exact weight cutoff, 27 real-space images,
the ion-ion constant), and a batched tensor energy. Energies split into
(ee, ei, ii) parts.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Tuple

import numpy as np
import torch

from deepsolid_tpu_torch.device import constant
from deepsolid_tpu_torch.ops.distance import MinimalImage


_erfc = np.vectorize(math.erfc, otypes=[np.float64])


def _gpoints_in_cutoff(recvec2pi: np.ndarray, alpha: float, volume: float,
                       tol: float = 1e-12) -> Tuple[np.ndarray, np.ndarray]:
    """Half-space reciprocal points with weight 4 pi exp(-g^2/4a^2)/(V g^2) > tol."""
    g = 1.0
    for _ in range(200):
        rhs = tol * volume * g * g / (4 * np.pi)
        if rhs <= 0 or rhs >= 1:
            g *= 1.5
            continue
        g_new = 2.0 * alpha * np.sqrt(-np.log(rhs))
        if abs(g_new - g) < 1e-10:
            break
        g = g_new
    g_cut = g * 1.0001

    inv = np.linalg.inv(recvec2pi)
    bounds = np.ceil(g_cut * np.linalg.norm(inv, axis=0)).astype(int)
    ns = np.array(
        list(itertools.product(*[range(-b, b + 1) for b in bounds])),
        dtype=np.float64,
    )
    # strict half space: (x>0) or (x=0,y>0) or (x=0,y=0,z>0)
    x, y, z = ns.T
    half = (x > 0) | ((x == 0) & (y > 0)) | ((x == 0) & (y == 0) & (z > 0))
    gpoints = ns[half] @ recvec2pi
    g2 = np.sum(gpoints**2, axis=-1)
    gweight = 4 * np.pi * np.exp(-g2 / (4 * alpha**2)) / (volume * g2)
    keep = gweight > tol
    return gpoints[keep], gweight[keep]


@dataclasses.dataclass(frozen=True)
class EwaldSum:
    """Precomputed Ewald state for a fixed simulation cell."""

    latvec: np.ndarray
    atom_coords: np.ndarray
    atom_charges: np.ndarray
    nelec: Tuple[int, int]
    alpha: float
    gpoints: np.ndarray  # (ng, 3)
    gweight: np.ndarray  # (ng,)
    lattice_displacements: np.ndarray  # (27, 3)
    ion_exp: np.ndarray  # (ng,) complex structure factor of the ions
    ion_ion: float  # bare ion-ion Ewald energy (real + reciprocal)
    ijconst: float
    squareconst: float
    ii_const: float
    i_sum: float

    @classmethod
    def build(cls, cell, ewald_gmax_tol: float = 1e-12, nlatvec: int = 1,
              alpha: float = None) -> "EwaldSum":
        """Host-side setup from a `Supercell` (or any `Cell` with nelec)."""
        latvec = np.asarray(cell.lattice, np.float64)
        coords = np.asarray(cell.atom_coords, np.float64)
        charges = np.asarray(cell.atom_charges, np.float64)
        volume = abs(np.linalg.det(latvec))
        recvec = np.linalg.inv(latvec).T

        if alpha is None:
            smallest_height = np.amin(1.0 / np.linalg.norm(recvec, axis=1))
            alpha = 5.0 / smallest_height

        gpoints, gweight = _gpoints_in_cutoff(
            2 * np.pi * recvec, alpha, volume, ewald_gmax_tol
        )
        pts = np.array(
            list(itertools.product(range(-nlatvec, nlatvec + 1), repeat=3)),
            np.float64,
        )
        lattice_displacements = pts @ latvec

        i_sum = float(np.sum(charges))
        ii_sum2 = float(np.sum(charges**2))
        ii_sum = (i_sum**2 - ii_sum2) / 2
        ijconst = -np.pi / (volume * alpha**2)
        squareconst = -alpha / np.sqrt(np.pi) + ijconst / 2
        ii_const = ii_sum * ijconst + ii_sum2 * squareconst

        gdotr = gpoints @ coords.T
        ion_exp = np.exp(1j * gdotr) @ charges
        ion_ion_rec = float(gweight @ np.abs(ion_exp) ** 2)
        if len(charges) > 1:
            # float64 minimal image over the same 27-image box
            diff = coords[:, None, :] - coords[None, :, :]
            cand = diff[:, :, None, :] + lattice_displacements[None, None]
            best = np.argmin(np.sum(cand * cand, axis=-1), axis=-1)
            d = np.take_along_axis(cand, best[:, :, None, None], axis=2)[:, :, 0]
            rvec = d[None] + lattice_displacements[:, None, None, :]
            r = np.linalg.norm(rvec, axis=-1)
            r = np.where(r < 1e-300, 1.0, r)  # self pairs are masked by triu
            qij = charges[:, None] * charges[None, :]
            ion_ion_real = float(np.sum(np.triu(qij * _erfc(alpha * r) / r, k=1)))
        else:
            ion_ion_real = 0.0

        return cls(
            latvec=latvec,
            atom_coords=coords,
            atom_charges=charges,
            nelec=tuple(cell.nelec),
            alpha=float(alpha),
            gpoints=gpoints,
            gweight=gweight,
            lattice_displacements=lattice_displacements,
            ion_exp=ion_exp,
            ion_ion=ion_ion_real + ion_ion_rec,
            ijconst=float(ijconst),
            squareconst=float(squareconst),
            ii_const=float(ii_const),
            i_sum=i_sum,
        )

    def ee_const(self, ne: int) -> float:
        return ne * (ne - 1) / 2 * self.ijconst + ne * self.squareconst

    def ei_const(self, ne: int) -> float:
        return -ne * self.i_sum * self.ijconst

    def energy(self, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(ee, ei, ii) Ewald energies of walkers x (B, nelec*3), each (B,)."""
        ne = sum(self.nelec)
        pos = x.reshape(x.shape[0], ne, 3)

        disp = constant(self.lattice_displacements, x)
        charges = constant(self.atom_charges, x)
        gweight = constant(self.gweight, x)
        mi = MinimalImage(self.latvec)

        # real-space e-i: (B, ne, natom, 27)
        ei_d = mi.dist_i(constant(self.atom_coords, x), pos)
        r_ei = torch.linalg.norm(ei_d[..., None, :] + disp, dim=-1)
        cij = torch.sum(torch.special.erfc(self.alpha * r_ei) / r_ei, dim=-1)
        ei_real = torch.sum(-charges * cij, dim=(-1, -2))

        # real-space e-e over the upper triangle: (27, B, ne, ne)
        if ne > 1:
            ee_d = mi.dist_matrix(pos)
            r_ee = torch.linalg.norm(ee_d + disp[:, None, None, None, :], dim=-1)
            tri = torch.triu(torch.ones((ne, ne), dtype=x.dtype, device=x.device), 1)
            # the masked zero-displacement diagonal must stay finite
            r_safe = torch.where(r_ee < 1e-30, torch.ones_like(r_ee), r_ee)
            ee_real = torch.sum(tri * torch.special.erfc(self.alpha * r_safe) / r_safe,
                                dim=(0, -1, -2))
        else:
            ee_real = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

        # reciprocal space
        gdotr = pos @ constant(self.gpoints, x).T  # (B, ne, ng)
        sum_sin = torch.sum(torch.sin(gdotr), dim=1)
        sum_cos = torch.sum(torch.cos(gdotr), dim=1)
        ee_recip = (sum_sin**2 + sum_cos**2) @ gweight
        ion_re = constant(self.ion_exp.real, x)
        ion_im = constant(self.ion_exp.imag, x)
        ei_recip = 2.0 * ((-ion_re * sum_cos - ion_im * sum_sin) @ gweight)

        ee = ee_real + ee_recip + self.ee_const(ne)
        ei = ei_real + ei_recip + self.ei_const(ne)
        ii = torch.full_like(ee, self.ion_ion + self.ii_const)
        return ee, ei, ii

    def total_energy(self, x: torch.Tensor) -> torch.Tensor:
        ee, ei, ii = self.energy(x)
        return ee + ei + ii

    @property
    def madelung(self) -> float:
        """Ion-ion energy including the neutralizing-background constants."""
        return float(self.ion_ion + self.ii_const)
