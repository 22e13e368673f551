"""Local energy: kinetic (Laplacian of log psi) + Ewald Coulomb.

Mirrors deepsolid_tpu/hamiltonian.py.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from deepsolid_tpu_torch.models.fwdlap_forward import make_kinetic_forward
from deepsolid_tpu_torch.ops.ewald import EwaldSum
from deepsolid_tpu_torch.ops.laplacian import make_kinetic
from deepsolid_tpu_torch.utils import profiling


def make_local_energy(network, supercell, mode: str = "forward",
                      partition_number: int = 3, shard=None) -> Callable:
    """E_L(params, x) -> (kinetic (B,) complex, ewald (B,) real) for walkers
    x (B, 3N). `mode` is the kinetic engine: 'forward' (the forward
    Laplacian) or one of ops/laplacian.py's 'partition', 'vmap', 'for' and
    'hessian' on network.logdet. `shard` (parallel.TangentShard or None)
    splits the tangent columns over the deriv ranks; only the forward
    engine can be sharded."""
    if mode == "forward":
        kinetic = make_kinetic_forward(network, shard=shard)
    elif shard is not None:
        raise ValueError(
            f"a sharded tangent axis requires mode='forward', got {mode!r}")
    else:
        kinetic = make_kinetic(network.logdet, mode=mode,
                               partition_number=partition_number)
    ewald = EwaldSum.build(supercell)

    def local_energy(params, x) -> Tuple[torch.Tensor, torch.Tensor]:
        with profiling.annotate("el.kinetic"):
            ke = kinetic(params, x)
        with profiling.annotate("el.ewald"):
            ee, ei, ii = ewald.energy(x)
            return ke, ee + ei + ii

    return local_energy
