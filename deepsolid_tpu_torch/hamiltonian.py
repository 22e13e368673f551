"""Local energy: kinetic (Laplacian of log psi) + Ewald Coulomb.

Mirrors deepsolid_tpu/hamiltonian.py, 'forward' mode only.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from deepsolid_tpu_torch.models.fwdlap_forward import make_kinetic_forward
from deepsolid_tpu_torch.ops.ewald import EwaldSum


def make_local_energy(network, supercell, mode: str = "forward",
                      shard=None) -> Callable:
    """E_L(params, x) -> (kinetic (B,) complex, ewald (B,) real) for walkers
    x (B, 3N), through the forward-Laplacian engine. `shard`
    (parallel.TangentShard or None) splits the tangent columns over the
    deriv ranks; only the forward engine can be sharded."""
    if shard is not None and mode != "forward":
        raise ValueError(
            f"a sharded tangent axis requires mode='forward', got {mode!r}")
    if mode != "forward":
        raise NotImplementedError(
            f"laplacian mode {mode!r} is not ported; the port has 'forward'")
    kinetic = make_kinetic_forward(network, shard=shard)
    ewald = EwaldSum.build(supercell)

    def local_energy(params, x) -> Tuple[torch.Tensor, torch.Tensor]:
        ke = kinetic(params, x)
        ee, ei, ii = ewald.energy(x)
        return ke, ee + ei + ii

    return local_energy
