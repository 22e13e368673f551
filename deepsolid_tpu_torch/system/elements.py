"""Periodic table with ground-state spin configurations.

Parity: reference DeepSolid/utils/elements.py:25-250 hard-codes a table of
(symbol, Z, nalpha, nbeta). We instead *derive* the ground-state spin from
Madelung-rule subshell filling with Hund's rule, plus the experimentally
known exceptions, which yields the same (nalpha, nbeta) pairs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

_SYMBOLS = (
    "X",
    "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn",
)

# Madelung (n+l, n) ordering of subshells: (n, l, capacity).
_MADELUNG_ORDER = sorted(
    [(n, l) for n in range(1, 8) for l in range(0, n)],
    key=lambda nl: (nl[0] + nl[1], nl[0]),
)

# Ground-state configuration exceptions: Z -> {(n, l): electron count delta}.
# e.g. Cr: 4s1 3d5 instead of 4s2 3d4.
_EXCEPTIONS = {
    24: {(4, 0): -1, (3, 2): +1},   # Cr
    29: {(4, 0): -1, (3, 2): +1},   # Cu
    41: {(5, 0): -1, (4, 2): +1},   # Nb
    42: {(5, 0): -1, (4, 2): +1},   # Mo
    44: {(5, 0): -1, (4, 2): +1},   # Ru
    45: {(5, 0): -1, (4, 2): +1},   # Rh
    46: {(5, 0): -2, (4, 2): +2},   # Pd
    47: {(5, 0): -1, (4, 2): +1},   # Ag
    57: {(4, 3): -1, (5, 2): +1},   # La
    58: {(4, 3): -1, (5, 2): +1},   # Ce
    64: {(4, 3): -1, (5, 2): +1},   # Gd
    78: {(6, 0): -1, (5, 2): +1},   # Pt
    79: {(6, 0): -1, (5, 2): +1},   # Au
}


def subshell_counts(z: int) -> Dict[tuple, int]:
    """Ground-state electron count per (n, l) subshell: Madelung filling
    with the known configuration exceptions (Cr, Cu, ...)."""
    counts: Dict[tuple, int] = {}
    remaining = z
    for (n, l) in _MADELUNG_ORDER:
        if remaining <= 0:
            break
        cap = 2 * (2 * l + 1)
        take = min(cap, remaining)
        counts[(n, l)] = take
        remaining -= take
    for nl, delta in _EXCEPTIONS.get(z, {}).items():
        counts[nl] = counts.get(nl, 0) + delta
    return counts


def _ground_state_unpaired(z: int) -> int:
    """Number of unpaired electrons in the atomic ground state (Hund)."""
    counts = subshell_counts(z)
    unpaired = 0
    for (n, l), c in counts.items():
        orbitals = 2 * l + 1
        if c <= orbitals:
            unpaired += c
        else:
            unpaired += 2 * orbitals - c
    return unpaired


@dataclasses.dataclass(frozen=True)
class Element:
    symbol: str
    atomic_number: int

    @property
    def nalpha(self) -> int:
        u = _ground_state_unpaired(self.atomic_number)
        return (self.atomic_number + u) // 2

    @property
    def nbeta(self) -> int:
        return self.atomic_number - self.nalpha

    @property
    def spin_config(self):
        return (self.nalpha, self.nbeta)


@functools.lru_cache(maxsize=None)
def _tables():
    by_symbol = {}
    by_number = {}
    for z, sym in enumerate(_SYMBOLS):
        if z == 0:
            continue
        e = Element(sym, z)
        by_symbol[sym] = e
        by_number[z] = e
    return by_symbol, by_number


def from_symbol(symbol: str) -> Element:
    return _tables()[0][symbol]


def from_number(z: int) -> Element:
    return _tables()[1][z]


def symbol_to_number(symbol: str) -> int:
    return from_symbol(symbol).atomic_number


def number_to_symbol(z: int) -> str:
    return from_number(z).symbol
