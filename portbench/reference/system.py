"""The simulated solid, from a configuration file of portbench/configs.

Lattice vectors are rows, everything in Bohr. The simulation cell is the
primitive cell tiled by the integer matrix S; its atoms are the primitive
atoms shifted by every lattice translation inside it. The feature lattice
vectors are DeepSolid's 'minimal' ones: BV the reciprocal vectors, AV =
pinv(BV)^T = lattice / (2 pi).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Tuple

import numpy as np


def reciprocal(lattice: np.ndarray) -> np.ndarray:
    """Rows b_j with a_i . b_j = 2 pi delta_ij."""
    return 2.0 * np.pi * np.linalg.inv(lattice).T


def translations(S: np.ndarray, prim: np.ndarray) -> np.ndarray:
    """The det(S) primitive translations R = m @ prim that lie in the
    simulation cell S @ prim (m integer, m @ S^-1 in [0, 1)^3)."""
    inv = np.linalg.inv(S.astype(np.float64))
    reach = int(np.abs(S).sum())
    found = []
    for m in itertools.product(range(-reach, reach + 1), repeat=3):
        frac = np.asarray(m, np.float64) @ inv
        if np.all(frac > -1e-9) and np.all(frac < 1.0 - 1e-9):
            found.append(m)
    out = np.asarray(found, np.float64) @ prim
    if len(out) != round(abs(np.linalg.det(S))):
        raise ValueError(f"found {len(out)} translations for S = {S.tolist()}")
    return out


@dataclasses.dataclass(frozen=True)
class System:
    prim_lattice: np.ndarray      # (3, 3)
    prim_atoms: np.ndarray        # (a, 3)
    prim_charges: np.ndarray      # (a,)
    S: np.ndarray                 # (3, 3) integers
    spins: Tuple[int, int]
    klist: Tuple[np.ndarray, ...]  # per spin channel, (n_s, 3)

    @classmethod
    def from_config(cls, conf: dict) -> "System":
        prim = np.asarray(conf["lattice_bohr"], np.float64)
        atoms = np.asarray([a["coords_bohr"] for a in conf["atoms"]], np.float64)
        charges = np.asarray([a["charge"] for a in conf["atoms"]], np.float64)
        S = np.asarray(conf["supercell"], np.int64)
        scale = round(abs(np.linalg.det(S)))
        nelec = int(round(charges.sum())) * scale
        spins = (nelec // 2, nelec - nelec // 2)
        klist = tuple(np.asarray(k, np.float64) for k in conf["klist"])
        if tuple(len(k) for k in klist) != spins:
            raise ValueError(f"k-list lengths {[len(k) for k in klist]} "
                             f"do not match the spins {spins}")
        return cls(prim, atoms, charges, S, spins, klist)

    @property
    def scale(self) -> int:
        return round(abs(np.linalg.det(self.S)))

    @property
    def nelectron(self) -> int:
        return sum(self.spins)

    @property
    def channels(self) -> List[Tuple[int, int]]:
        """(first, end) electron of each occupied spin channel."""
        up, dn = self.spins
        return [(s, e) for s, e in ((0, up), (up, up + dn)) if e > s]

    @property
    def sim_lattice(self) -> np.ndarray:
        return self.S.astype(np.float64) @ self.prim_lattice

    @property
    def sim_atoms(self) -> np.ndarray:
        shifts = translations(self.S, self.prim_lattice)
        return (self.prim_atoms[:, None] + shifts[None]).reshape(-1, 3)

    @property
    def sim_charges(self) -> np.ndarray:
        return np.repeat(self.prim_charges, self.scale)

    @staticmethod
    def feature_vectors(lattice):
        """(AV, BV) of the 'minimal' periodic features of a lattice."""
        bv = reciprocal(lattice)
        return np.linalg.pinv(bv).T, bv
