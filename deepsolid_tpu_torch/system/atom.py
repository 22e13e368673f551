"""Atom description used to build cells.

Parity: reference DeepSolid/utils/system.py:28-87 (attrs-based `Atom`).
Plain dataclass here; coordinates in Bohr.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from deepsolid_tpu_torch.system import elements, units


@dataclasses.dataclass
class Atom:
    symbol: str
    coords: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    charge: Optional[float] = None  # effective charge (ECP-screened); default Z
    atomic_number: Optional[int] = None
    unit: str = "bohr"

    def __post_init__(self):
        if self.atomic_number is None:
            self.atomic_number = elements.symbol_to_number(self.symbol)
        if self.charge is None:
            self.charge = float(self.atomic_number)
        coords = np.asarray(self.coords, dtype=np.float64)
        if self.unit.lower() in ("angstrom", "a", "ang"):
            coords = units.angstrom2bohr(coords)
        elif self.unit.lower() not in ("bohr", "b", "au"):
            raise ValueError(f"Unknown unit: {self.unit}")
        self.coords = tuple(coords.tolist())
        self.unit = "bohr"

    @property
    def element(self) -> elements.Element:
        return elements.from_symbol(self.symbol)

    @property
    def coords_array(self) -> np.ndarray:
        return np.asarray(self.coords, dtype=np.float64)
