"""Primitive cells and QMC simulation supercells.

Pure-numpy, serializable replacements for the reference's live PySCF Cell
objects (reference: DeepSolid/supercell.py:32-148, base_config.py:101
`cfg.system.pyscf_cell`). All geometry is in Bohr; lattice matrices store
lattice vectors as ROWS (same convention as pyscf `cell.a`).

Key behaviors reproduced (new implementation):
  * supercell k-point folding  (supercell.py:32-48)
  * primitive-cell copies inside the supercell  (supercell.py:51-61)
  * symmetry feature lattice vectors AV/BV  (supercell.py:98-140)
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence, Tuple

import numpy as np

from deepsolid_tpu_torch.system.atom import Atom


def reciprocal_vectors(lattice: np.ndarray) -> np.ndarray:
    """Rows are reciprocal vectors b_i with a_i . b_j = 2 pi delta_ij."""
    return 2.0 * np.pi * np.linalg.inv(np.asarray(lattice)).T


_SYM_MATS = {
    "minimal": np.eye(3),
    "fcc": np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]], dtype=np.float64),
    "bcc": np.array(
        [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, -1, 0], [1, 0, -1], [0, 1, -1]],
        dtype=np.float64,
    ),
    "hexagonal": np.array(
        [[1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, -1, 0]], dtype=np.float64
    ),
}


def symmetry_feature_vectors(lattice: np.ndarray, sym_type: str = "minimal"):
    """(AV, BV) pairs used by the periodic distance features.

    BV rows span the reciprocal lattice (possibly redundantly for
    high-symmetry types); AV = pinv(BV)^T so that for 'minimal'
    AV == lattice / (2 pi). Reference: supercell.py:98-140.
    """
    mat = _SYM_MATS.get(sym_type)
    if mat is None:
        mat = np.eye(3)
    bv = mat @ reciprocal_vectors(lattice)
    av = np.linalg.pinv(bv).T
    return av, bv


def _integer_points_in_box(transform: np.ndarray) -> np.ndarray:
    """Integer vectors m with m @ transform in [0, 1)^3.

    `transform` maps integer lattice coordinates into the fractional
    coordinates of the target cell; we enumerate a bounding box of the
    preimage of the unit cube and filter.
    """
    inv = np.linalg.inv(transform)
    corners = np.array(list(itertools.product([0, 1], repeat=3)), dtype=np.float64)
    pre = corners @ inv  # preimage of unit-cube corners
    lo = np.floor(pre.min(axis=0)).astype(int) - 1
    hi = np.ceil(pre.max(axis=0)).astype(int) + 1
    grids = np.meshgrid(*[np.arange(l, h + 1) for l, h in zip(lo, hi)], indexing="ij")
    m = np.stack([g.ravel() for g in grids], axis=-1).astype(np.float64)
    frac = m @ transform
    inside = np.all((frac >= -1e-12) & (frac < 1.0 - 1e-9), axis=1)
    return m[inside].astype(np.int64)


def supercell_kpts(S: np.ndarray, prim_lattice: np.ndarray) -> np.ndarray:
    """The det(S) supercell reciprocal points folded into the primitive BZ.

    These are k = frac @ B_prim with frac = m @ S^-T in [0,1)^3 for integer m.
    Reference semantics: supercell.py:32-48.
    """
    S = np.asarray(S, dtype=np.float64)
    frac = _integer_points_in_box(np.linalg.inv(S).T) @ np.linalg.inv(S).T
    # Stable ordering: sort lexicographically by fractional coordinate.
    order = np.lexsort(frac.T[::-1])
    frac = frac[order]
    return frac @ reciprocal_vectors(prim_lattice)


def supercell_copies(S: np.ndarray, prim_lattice: np.ndarray) -> np.ndarray:
    """Primitive-cell origin shifts R tiling the supercell (det(S) of them).

    R = m @ prim_lattice for integer m with m @ S^-1 in [0,1)^3.
    Reference semantics: supercell.py:51-61.
    """
    S = np.asarray(S, dtype=np.float64)
    m = _integer_points_in_box(np.linalg.inv(S))
    order = np.lexsort(m.T[::-1])
    return m[order].astype(np.float64) @ np.asarray(prim_lattice)


@dataclasses.dataclass(frozen=True)
class Cell:
    """An immutable periodic cell (primitive or simulation)."""

    lattice: np.ndarray  # (3, 3) rows = lattice vectors, Bohr
    atom_coords: np.ndarray  # (natom, 3) Cartesian Bohr
    atom_charges: np.ndarray  # (natom,) effective nuclear charges
    atom_symbols: Tuple[str, ...]
    spin: int = 0  # nalpha - nbeta
    charge: int = 0
    sym_type: str = "minimal"

    def __post_init__(self):
        object.__setattr__(self, "lattice", np.asarray(self.lattice, np.float64))
        object.__setattr__(self, "atom_coords", np.asarray(self.atom_coords, np.float64))
        object.__setattr__(self, "atom_charges", np.asarray(self.atom_charges, np.float64))
        object.__setattr__(self, "atom_symbols", tuple(self.atom_symbols))
        ne = self.nelectron
        if (ne + self.spin) % 2 != 0:
            raise ValueError(
                f"nelectron={ne} and spin={self.spin} have incompatible parity"
            )

    # -- construction helpers ------------------------------------------------
    @classmethod
    def from_atoms(cls, atoms: Sequence[Atom], lattice, spin: int = 0,
                   charge: int = 0, sym_type: str = "minimal") -> "Cell":
        return cls(
            lattice=np.asarray(lattice, np.float64),
            atom_coords=np.stack([a.coords_array for a in atoms]),
            atom_charges=np.array([a.charge for a in atoms], np.float64),
            atom_symbols=tuple(a.symbol for a in atoms),
            spin=spin,
            charge=charge,
            sym_type=sym_type,
        )

    # -- geometry ------------------------------------------------------------
    @property
    def recip(self) -> np.ndarray:
        return reciprocal_vectors(self.lattice)

    @property
    def volume(self) -> float:
        return float(abs(np.linalg.det(self.lattice)))

    @property
    def AV(self) -> np.ndarray:
        return symmetry_feature_vectors(self.lattice, self.sym_type)[0]

    @property
    def BV(self) -> np.ndarray:
        return symmetry_feature_vectors(self.lattice, self.sym_type)[1]

    # -- electrons -----------------------------------------------------------
    @property
    def natom(self) -> int:
        return len(self.atom_symbols)

    @property
    def nelectron(self) -> int:
        return int(round(float(np.sum(self.atom_charges)))) - self.charge

    @property
    def nelec(self) -> Tuple[int, int]:
        ne = self.nelectron
        na = (ne + self.spin) // 2
        return (na, ne - na)

    def atoms(self) -> Tuple[Atom, ...]:
        return tuple(
            Atom(sym, tuple(xyz), charge=float(q))
            for sym, xyz, q in zip(self.atom_symbols, self.atom_coords, self.atom_charges)
        )

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "lattice": self.lattice.tolist(),
            "atom_coords": self.atom_coords.tolist(),
            "atom_charges": self.atom_charges.tolist(),
            "atom_symbols": list(self.atom_symbols),
            "spin": self.spin,
            "charge": self.charge,
            "sym_type": self.sym_type,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Cell":
        return cls(**{**d, "atom_symbols": tuple(d["atom_symbols"])})


@dataclasses.dataclass(frozen=True)
class Supercell(Cell):
    """A simulation cell: a primitive `Cell` tiled by an integer matrix S.

    Reference semantics: supercell.get_supercell (supercell.py:64-95).
    """

    prim: Optional[Cell] = None
    S: Optional[np.ndarray] = None  # (3, 3) integer tiling matrix

    def __post_init__(self):
        super().__post_init__()
        if self.prim is None or self.S is None:
            raise ValueError("Supercell requires prim cell and S matrix")
        object.__setattr__(self, "S", np.asarray(self.S, np.int64))

    @property
    def scale(self) -> int:
        """Number of primitive cells in the simulation cell (= |det S|)."""
        return int(round(abs(np.linalg.det(self.S.astype(np.float64)))))

    @property
    def kpts(self) -> np.ndarray:
        """Supercell k-points folded into the primitive BZ, (scale, 3)."""
        return supercell_kpts(self.S, self.prim.lattice)

    @property
    def copies(self) -> np.ndarray:
        return supercell_copies(self.S, self.prim.lattice)

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["prim"] = self.prim.to_dict()
        d["S"] = self.S.tolist()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Supercell":
        d = dict(d)
        d["prim"] = Cell.from_dict(d["prim"])
        return cls(**d)


def make_supercell(prim: Cell, S, sym_type: Optional[str] = None,
                   spin: Optional[int] = None) -> Supercell:
    """Tile `prim` by integer matrix S into a simulation `Supercell`.

    `spin` overrides the supercell spin (default: prim.spin * scale, the
    reference's rule, supercell.py:86 — wrong for e.g. antiferromagnetic
    chains of odd-electron cells, where the simulation cell should pair
    up).
    """
    S = np.asarray(S)
    if not np.allclose(S, np.round(S)):
        raise ValueError("S must be an integer matrix")
    S = np.round(S).astype(np.int64)
    scale = int(round(abs(np.linalg.det(S.astype(np.float64)))))
    if scale == 0:
        raise ValueError("S must be non-singular")
    sym_type = sym_type if sym_type is not None else prim.sym_type
    copies = supercell_copies(S, prim.lattice)
    if copies.shape[0] != scale:
        raise AssertionError(
            f"Found {copies.shape[0]} copies, expected det(S)={scale}"
        )
    # Atoms ordered atom-major (each primitive atom with all its copies
    # contiguous), matching the reference's ordering (supercell.py:76-78).
    coords = (prim.atom_coords[:, None, :] + copies[None, :, :]).reshape(-1, 3)
    charges = np.repeat(prim.atom_charges, scale)
    symbols = tuple(s for s in prim.atom_symbols for _ in range(scale))
    return Supercell(
        lattice=S.astype(np.float64) @ prim.lattice,
        atom_coords=coords,
        atom_charges=charges,
        atom_symbols=symbols,
        spin=prim.spin * scale if spin is None else spin,
        charge=prim.charge * scale,
        sym_type=sym_type,
        prim=prim,
        S=S,
    )
