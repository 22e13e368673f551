"""Initial electron placement around nuclei.

Mirrors deepsolid_tpu/sampling/init.py: electrons are assigned to atoms by
per-element ground-state spin configurations, rebalanced to the
requested (nalpha, nbeta), jittered with a Gaussian and wrapped into the
simulation cell.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from deepsolid_tpu_torch.ops.distance import enforce_pbc
from deepsolid_tpu_torch.system import elements
from deepsolid_tpu_torch.system.cell import Cell


def init_electrons(
    gen: torch.Generator,
    cell: Cell,
    electrons: Tuple[int, int],
    batch_size: int,
    init_width: float = 0.8,
    dtype=torch.float32,
    device="cpu",
) -> torch.Tensor:
    """Walker positions, shape (batch_size, nelectron * 3)."""
    charges = cell.atom_charges
    if int(round(float(np.sum(charges)))) != sum(electrons):
        if cell.natom == 1:
            spin_configs = [tuple(electrons)]
        else:
            raise NotImplementedError(
                "No initialization policy for charged multi-atom cells."
            )
    else:
        spin_configs = []
        for sym, q in zip(cell.atom_symbols, charges):
            el = elements.from_symbol(sym)
            core = int((el.atomic_number - q) // 2)  # ECP-screened core pairs
            spin_configs.append((el.nalpha - core, el.nbeta - core))
        if sum(sum(c) for c in spin_configs) != sum(electrons):
            raise ValueError("atomic spin configurations do not sum to nelectron")
        rng = np.random.RandomState(0)
        # flip alpha->beta on random atoms until channel totals match
        while tuple(sum(c) for c in zip(*spin_configs)) != tuple(electrons):
            i = rng.randint(len(spin_configs))
            na, nb = spin_configs[i]
            if tuple(sum(c) for c in zip(*spin_configs))[0] > electrons[0]:
                if na > 0:
                    spin_configs[i] = (na - 1, nb + 1)
            else:
                if nb > 0:
                    spin_configs[i] = (na + 1, nb - 1)

    positions = []
    for s in range(2):
        for j in range(cell.natom):
            positions.append(np.tile(cell.atom_coords[j], spin_configs[j][s]))
    centers = torch.as_tensor(np.concatenate(positions), dtype=dtype, device=device)
    noise = torch.randn((batch_size, centers.numel()), generator=gen,
                        dtype=dtype, device=device)
    wrapped, _ = enforce_pbc(cell.lattice, centers + init_width * noise)
    return wrapped
