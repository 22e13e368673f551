"""VASP POSCAR reader producing the port's `Cell` (no PySCF).

A copy of deepsolid_tpu/system/poscar.py on this package's units, Atom and
Cell.

Parity: reference DeepSolid/utils/poscar_to_cell.py:31-110 returns a pyscf
Cell; we return the Cell of system/cell.py directly (Bohr units).
"""

from __future__ import annotations

import numpy as np

from deepsolid_tpu_torch.system import units
from deepsolid_tpu_torch.system.atom import Atom
from deepsolid_tpu_torch.system.cell import Cell


def read_poscar(fname: str, spin: int = 0, sym_type: str = "minimal") -> Cell:
    with open(fname, "r") as f:
        lines = f.readlines()

    factor = float(lines[1].split()[0])
    lattice_ang = (
        np.array([np.fromstring(lines[i], dtype=np.float64, sep=" ")[:3]
                  for i in range(2, 5)]) * factor
    )
    lattice = units.angstrom2bohr(lattice_ang)

    names = lines[5].split()
    if all(n.isdigit() for n in names):
        counts = np.fromstring(lines[5], dtype=int, sep=" ")
        names = ["X"] * len(counts)
        line_no = 6
    else:
        counts = np.fromstring(lines[6], dtype=int, sep=" ")
        line_no = 7

    # Optional "Selective dynamics" line.
    if lines[line_no].strip() and lines[line_no].strip()[0] in "Ss":
        line_no += 1
    use_cart = lines[line_no].split()[0][0] in "CcKk"
    line_no += 1

    atoms = []
    for name, count in zip(names, counts):
        for _ in range(count):
            xyz = np.array([float(v) for v in lines[line_no].split()[:3]])
            if use_cart:
                xyz = units.angstrom2bohr(xyz * factor)
            else:
                xyz = xyz @ lattice
            atoms.append(Atom(name, tuple(xyz)))
            line_no += 1

    return Cell.from_atoms(atoms, lattice, spin=spin, sym_type=sym_type)
