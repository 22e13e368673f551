"""Minimal-image displacements and periodic wrapping.

Mirrors deepsolid_tpu/ops/distance.py. Lattice classification and the
lattice inverse are computed once on the host in float64; the tensor
methods run on whatever device and dtype their input has.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np
import torch

from deepsolid_tpu_torch.device import constant


def _needs_image_search(lattice: np.ndarray) -> bool:
    """Whether the nearest image can differ from the fractional-wrap image.

    For orthogonal lattices the fractional wrap is exact; for skewed ones
    (diamond's fcc lattice among them) it can miss the minimal image, so
    a 27-image search follows the wrap.
    """
    lattice = np.asarray(lattice)
    off = lattice @ lattice.T - np.diag(np.diag(lattice @ lattice.T))
    return bool(np.any(np.abs(off) > 1e-10))


def min_image_frac(dx: torch.Tensor, lattice, inv_lattice) -> torch.Tensor:
    """Wrap displacement(s) into the [-1/2, 1/2) fractional box."""
    frac = dx @ inv_lattice
    frac = torch.remainder(frac + 0.5, 1.0) - 0.5
    return frac @ lattice


def min_image_search(dx: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """True minimal image via search over the 27 neighbour-cell shifts."""
    cand = dx[None] + shifts.reshape((-1,) + (1,) * (dx.ndim - 1) + (3,))
    d2 = torch.sum(cand * cand, dim=-1)
    idx = torch.argmin(d2, dim=0)
    return torch.take_along_dim(cand, idx[None, ..., None], dim=0)[0]


class MinimalImage:
    """Minimal-image helper for a fixed lattice (host-side construction)."""

    def __init__(self, lattice):
        lattice = np.asarray(lattice, np.float64)
        self.lattice = lattice
        self.inv_lattice = np.linalg.inv(lattice)
        self.general = _needs_image_search(lattice)
        pts = np.array(list(itertools.product((-1, 0, 1), repeat=3)), np.float64)
        self.shifts = pts @ lattice

    def displacement(self, dx: torch.Tensor) -> torch.Tensor:
        """Minimal-image displacement for raw displacement(s) dx (..., 3)."""
        wrapped = min_image_frac(dx, constant(self.lattice, dx),
                                 constant(self.inv_lattice, dx))
        if self.general:
            wrapped = min_image_search(wrapped, constant(self.shifts, dx))
        return wrapped

    def dist_i(self, targets: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Minimal-image displacements x_i - target_j.

        targets (m, 3); x (..., n, 3) -> (..., n, m, 3).
        """
        return self.displacement(x[..., :, None, :] - targets)

    def dist_matrix(self, x: torch.Tensor) -> torch.Tensor:
        """Electron-electron minimal-image displacements, diagonal zeroed.

        x (..., n, 3) -> (..., n, n, 3).
        """
        v = self.displacement(x[..., :, None, :] - x[..., None, :, :])
        n = v.shape[-2]
        eye = torch.eye(n, dtype=v.dtype, device=v.device)
        return v * (1.0 - eye)[..., None]


def enforce_pbc(lattice, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wrap electron positions into the cell spanned by `lattice` rows.

    x: positions, (..., n*3) flat or (..., n, 3). Returns (wrapped x of
    the same shape, integer image counts (..., n, 3)).
    """
    lattice = np.asarray(lattice, np.float64)
    shape = x.shape
    pos = x.reshape(shape[:-1] + (-1, 3)) if shape[-1] != 3 else x
    frac = pos @ constant(np.linalg.inv(lattice), pos)
    wrap = torch.floor(frac)
    wrapped = (frac - wrap) @ constant(lattice, pos)
    return wrapped.reshape(shape), wrap
