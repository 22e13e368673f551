"""Body-centred-cubic metal, one atom per primitive cell (mirrors
deepsolid_tpu/configs/bcc.py).

No reference counterpart config (the reference reaches bcc metals via
config/read_poscar.py and a hand-written POSCAR); this gives the same
system as a one-liner for any element the native basis tables cover
(sto-3g Z<=18, et-dz Z<=30 — e.g. Li, Na, V, Fe).

input_str: "symbol,a_Ang,S,spin,basis" e.g. "Li,3.43,3,1,sto-3g".
  a_Ang: conventional-cube lattice constant in Angstrom.
  S: the supercell tiles S x S x S primitive (1-atom) cells.
  spin: total supercell spin (nalpha - nbeta); must match electron
  parity (S^3 * Z + spin even).
"""

import numpy as np

from deepsolid_tpu_torch import config as base_config
from deepsolid_tpu_torch.system import Atom, Cell, elements, make_supercell, units


def get_config(input_str):
    symbol, a_ang, S, spin, basis = input_str.split(",")
    S = np.eye(3) * int(S)
    a = units.angstrom2bohr(float(a_ang))
    # bcc primitive vectors: a/2 (-1,1,1), (1,-1,1), (1,1,-1)
    lattice = (np.ones((3, 3)) - 2.0 * np.eye(3)) * a / 2
    z = elements.from_symbol(symbol).atomic_number
    prim = Cell.from_atoms([Atom(symbol, (0.0, 0.0, 0.0))], lattice,
                           spin=z % 2)
    cfg = base_config.default()
    cfg.system.cell = make_supercell(prim, S, spin=int(spin))
    cfg.system.basis = basis
    return cfg
