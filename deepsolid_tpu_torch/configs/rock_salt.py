"""Rock-salt structure cell (mirrors deepsolid_tpu/configs/rock_salt.py;
reference: config/rock_salt.py).

input_str: "X,Y,L_Ang,S,basis" e.g. "Li,H,4.02,2,ccpvdz".
"""

import numpy as np

from deepsolid_tpu_torch import config as base_config
from deepsolid_tpu_torch.system import Atom, Cell, make_supercell, units


def get_config(input_str):
    x_sym, y_sym, L_ang, S, basis = input_str.split(",")
    S = np.eye(3) * int(S)
    L = units.angstrom2bohr(float(L_ang))
    lattice = (np.ones((3, 3)) - np.eye(3)) * L / 2
    cell = Cell.from_atoms(
        [
            Atom(x_sym, (0.0, 0.0, 0.0)),
            Atom(y_sym, (0.5 * L, 0.5 * L, 0.5 * L)),
        ],
        lattice,
    )
    cfg = base_config.default()
    cfg.system.cell = make_supercell(cell, S)
    cfg.system.basis = basis
    return cfg
