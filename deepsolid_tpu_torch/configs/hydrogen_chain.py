"""Hydrogen chain supercell (mirrors deepsolid_tpu/configs/hydrogen_chain.py;
reference: config/hydrogen_chain.py).

input_str: "symbol,Sx,Sy,Sz,L,spin,basis" e.g. "H,10,1,1,3.6,0,ccpvdz".
"""

import numpy as np

from deepsolid_tpu_torch import config as base_config
from deepsolid_tpu_torch.system import Atom, Cell, make_supercell


def get_config(input_str):
    symbol, sx, sy, sz, L, spin, basis = input_str.split(",")
    S = np.diag([int(sx), int(sy), int(sz)])
    L = float(L)
    scale = int(sx) * int(sy) * int(sz)
    # a 1-electron primitive cell must carry spin 1; the requested `spin`
    # applies to the SIMULATION cell (e.g. 0 for an even H chain)
    ne_prim = 1  # one H per primitive cell
    prim_spin = ne_prim % 2
    cell = Cell.from_atoms(
        [Atom(symbol, (L / 2, 0.0, 0.0))],
        np.diag([L, 100.0, 100.0]),
        spin=prim_spin,
    )
    cfg = base_config.default()
    cfg.system.cell = make_supercell(cell, S, spin=int(spin))
    cfg.system.basis = basis
    return cfg
