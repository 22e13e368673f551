"""Graphene sheet (mirrors deepsolid_tpu/configs/graphene.py;
reference: config/graphene.py).

input_str: "X,Y,L_Ang,S,z,basis" e.g. "C,C,2.46,2,20,ccpvdz".
"""

import numpy as np

from deepsolid_tpu_torch import config as base_config
from deepsolid_tpu_torch.system import Atom, Cell, make_supercell, units


def get_config(input_str):
    x_sym, y_sym, L_ang, S, z, basis = input_str.split(",")
    S = np.diag([int(S), int(S), 1])
    L = units.angstrom2bohr(float(L_ang))
    z = float(z)
    lattice = np.array(
        [
            [L * np.cos(np.pi / 6), -L * 0.5, 0.0],
            [L * np.cos(np.pi / 6), L * 0.5, 0.0],
            [0.0, 0.0, z],
        ]
    )
    cell = Cell.from_atoms(
        [
            Atom(x_sym, (3 ** (-0.5) * L, 0.0, 0.0)),
            Atom(y_sym, (2 * 3 ** (-0.5) * L, 0.0, 0.0)),
        ],
        lattice,
        sym_type="hexagonal",
    )
    cfg = base_config.default()
    cfg.system.cell = make_supercell(cell, S)
    cfg.system.basis = basis
    return cfg
