"""H2 in a periodic box (mirrors deepsolid_tpu/configs/two_hydrogen_cell.py).

input_str: "symbol,Sx,Sy,Sz,L,spin,basis" e.g. "H,5,1,1,2.0,0,ccpvdz".
"""

import numpy as np

from deepsolid_tpu_torch import config as base_config
from deepsolid_tpu_torch.system import Atom, Cell, make_supercell


def get_config(input_str):
    symbol, sx, sy, sz, L, spin, basis = input_str.split(",")
    S = np.diag([int(sx), int(sy), int(sz)])
    L = float(L)
    cell = Cell.from_atoms(
        [Atom(symbol, (L, 0.0, 0.0)), Atom(symbol, (0.0, 0.0, 0.0))],
        np.diag([2 * L, 100.0, 100.0]),
        spin=int(spin),
    )
    cfg = base_config.default()
    cfg.system.cell = make_supercell(cell, S)
    cfg.system.basis = basis
    return cfg
