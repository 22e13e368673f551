"""Periodic Gaussian-type-orbital evaluation in PyTorch.

Mirrors deepsolid_tpu/scf/gto.py. Bloch AOs
    phi_{mu k}(r) = sum_T chi_mu(r - R_mu - T) e^{i k . T}
with the lattice sum truncated where exp(-alpha_min R^2) < eps. The
image set is chosen on the host (numpy); `eval_aos` runs on the walkers'
device and dtype, so pretraining targets evaluate next to the network.

Shells are CARTESIAN with any angular momentum the basis tables provide
(s, p, and 6-component d as of cc-pVDZ); cartesian p == spherical p.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np
import torch

from deepsolid_tpu_torch.device import constant
from deepsolid_tpu_torch.ops.distance import enforce_pbc
from deepsolid_tpu_torch.scf.basis import Shell, num_ao, primitive_norm
from deepsolid_tpu_torch.scf.integrals import CART


def _lattice_images(lattice: np.ndarray, rcut: float) -> np.ndarray:
    """Integer-combination translations T with any point of the cell within
    rcut of the home cell (conservative bounding box)."""
    inv = np.linalg.inv(lattice)
    bounds = np.ceil(rcut * np.linalg.norm(inv, axis=0)).astype(int) + 1
    pts = np.array(
        list(itertools.product(*[range(-b, b + 1) for b in bounds])),
        np.float64,
    )
    ts = pts @ lattice
    keep = np.linalg.norm(ts, axis=1) <= rcut + np.linalg.norm(lattice, axis=1).max()
    return ts[keep]


def _bloch_sum(values: torch.Tensor, cos_t: torch.Tensor, sin_t: torch.Tensor
               ) -> torch.Tensor:
    """sum_T values[n, T, c] e^{i k.T} -> (nk, n, c) complex, as two real
    products (cos_t, sin_t: (nT, nk))."""
    v = values.transpose(1, 2)  # (n, c, nT)
    return torch.complex(v @ cos_t, v @ sin_t).permute(2, 0, 1)


@dataclasses.dataclass(frozen=True)
class PeriodicAOEvaluator:
    """Shell data for evaluating Bloch AOs at given k-points."""

    shells: Sequence[Shell]
    lattice: np.ndarray
    kpts: np.ndarray  # (nk, 3)
    images: np.ndarray  # (nT, 3)

    @classmethod
    def build(cls, cell, shells: Sequence[Shell], kpts, eps: float = 1e-10):
        alpha_min = min(float(s.exponents.min()) for s in shells)
        rcut = float(np.sqrt(-np.log(eps) / alpha_min))
        images = _lattice_images(np.asarray(cell.lattice), rcut)
        return cls(
            shells=tuple(shells),
            lattice=np.asarray(cell.lattice),
            kpts=np.asarray(kpts, np.float64).reshape(-1, 3),
            images=images,
        )

    @property
    def nao(self) -> int:
        return num_ao(self.shells)

    def eval_aos(self, pos: torch.Tensor) -> torch.Tensor:
        """AO values. pos: (n, 3) -> (nk, n, nao) complex.

        Positions are wrapped into the home cell; the wrap phase
        e^{i k.L m} is equivalent to extending the lattice sum (the
        reference's convention, hf.py:118-120).
        """
        n = pos.shape[0]
        wrapped, wrap = enforce_pbc(self.lattice, pos.reshape(n, 3))
        # chi at r - m L is the Bloch AO at r times e^{-i k.(m L)}: multiply
        # by e^{+i k.(m L)} to undo the wrap
        kdot_wrap = (wrap @ constant(self.lattice, pos)) @ constant(self.kpts.T, pos)
        wrap_phase = torch.polar(torch.ones_like(kdot_wrap), kdot_wrap)  # (n, nk)

        kdot_t = self.images @ self.kpts.T  # (nT, nk), on the host in float64
        cos_t, sin_t = constant(np.cos(kdot_t), pos), constant(np.sin(kdot_t), pos)
        images = constant(self.images, pos)

        cols = []
        for shell in self.shells:
            coef = shell.coefficients * primitive_norm(shell.exponents, shell.l)
            d = wrapped[:, None, :] - constant(shell.center, pos) - images  # (n, nT, 3)
            r2 = torch.sum(d * d, dim=-1)
            radial = torch.exp(-constant(shell.exponents, pos) * r2[..., None]) @ \
                constant(coef, pos)  # (n, nT)
            if shell.l == 0:
                cols.append(_bloch_sum(radial[..., None], cos_t, sin_t))
            elif shell.l == 1:
                cols.append(_bloch_sum(d * radial[..., None], cos_t, sin_t))
            else:
                polys = torch.stack(
                    [d[..., 0] ** lx * d[..., 1] ** ly * d[..., 2] ** lz
                     for (lx, ly, lz) in CART[shell.l]], dim=-1)  # (n, nT, ncart)
                cols.append(_bloch_sum(polys * radial[..., None], cos_t, sin_t))
        aos = torch.cat(cols, dim=-1)  # (nk, n, nao)
        return aos * wrap_phase.T[:, :, None]
