"""Orbital sources for pretraining targets and occupied k-lists.

Mirrors deepsolid_tpu/scf/interface.py. An orbital source is any object
with
  * `klist`           - (k_up, k_dn) occupied k per orbital (numpy);
  * `orbital_mats(x)` - batched orbital matrices, torch on x's device;
  * `slogdet(x)`      - log|det| of its determinant (for sampling).

Sources:
  * PlaneWaveOrbitals - occupied free-electron states (exact in the
    uniform-gas limit; a good nodal-structure initializer generally);
  * scf.hf.ScfOrbitals - periodic Hartree-Fock in a GTO basis.
"""

from __future__ import annotations

from typing import List

import torch

from deepsolid_tpu_torch.device import constant
from deepsolid_tpu_torch.scf.free_electron import plane_wave_states
from deepsolid_tpu_torch.system.cell import Supercell


def slogdet_sum(mats: List[torch.Tensor]) -> torch.Tensor:
    """sum over spin channels of log|det| (B,) of (B, n, n) matrices."""
    return sum(torch.linalg.slogdet(m)[1] for m in mats)


class PlaneWaveOrbitals:
    """Slater determinant of occupied plane waves e^{i q . r}, q = k + G."""

    def __init__(self, sc: Supercell, twist=(0.0, 0.0, 0.0), policy="auto"):
        states = plane_wave_states(sc, twist=twist, policy=policy)
        self.klist = tuple(s[0] for s in states)
        self.qlist = tuple(s[1] for s in states)
        self.spins = sc.nelec

    def orbital_mats(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (batch, ne*3) -> [(batch, n_s, n_s) complex] per active spin."""
        pos = x.reshape(x.shape[0], -1, 3)
        out = []
        start = 0
        for s, n in enumerate(self.spins):
            if n == 0:
                continue
            r = pos[:, start:start + n]
            phase = torch.einsum("bid,jd->bij", r, constant(self.qlist[s], pos))
            out.append(torch.polar(torch.ones_like(phase), phase))
            start += n
        return out

    def slogdet(self, x: torch.Tensor) -> torch.Tensor:
        """Batched log|det| of the plane-wave determinant (for sampling)."""
        return slogdet_sum(self.orbital_mats(x))
