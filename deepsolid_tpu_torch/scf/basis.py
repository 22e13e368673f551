"""Built-in Gaussian basis sets (no Basis Set Exchange dependency).

Host numpy, a copy of deepsolid_tpu/scf/basis.py except for 'et-dz',
which the port does not generate yet (see below).

STO-3G is generated from the universal STO-3G expansion of Slater
orbitals: exponents at zeta=1 scale as zeta^2 per shell, contraction
coefficients are shell-universal (Hehre, Stewart & Pople, JCP 51, 2657
(1969); third row: JCP 52, 2769 (1970)). Supported elements: Z = 1..18.

'et-dz' (deepsolid_tpu/scf/etdz.py generates it from each atom's own
even-tempered-bath UHF) is not ported: requesting it raises
NotImplementedError.

cc-pVDZ carries explicit Dunning correlation-consistent tables
(JCP 90, 1007 (1989); Li from Prascher et al., Theor Chem Acc 128, 69
(2011)) for the elements the reference benchmark systems use: H, Li, C
(BASELINE.md: H2/H10, LiH rock salt, bcc-Li, C diamond/graphene).
Contraction coefficients are over unit-normalized primitives (the Basis
Set Exchange convention). d shells are CARTESIAN (6 components); the
extra x^2+y^2+z^2 combination slightly enlarges the variational space
versus the published spherical-harmonic convention.

Requesting an element/basis combination outside these tables raises
NotImplementedError — never a silent fallback (round-1 advisory:
pretraining quality must not degrade quietly).

Replaces the role of PySCF's basis machinery for the native SCF
(reference couples to PySCF via hf.py:26 and cell.basis).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from deepsolid_tpu_torch.system import elements

# Universal STO-3G expansions at zeta = 1: (exponents, coefficients)
_STO3G_1S = (
    np.array([2.227660584, 0.405771156, 0.109818036]),
    np.array([0.154328967, 0.535328142, 0.444634542]),
)
_STO3G_2SP_EXP = np.array([0.994203966, 0.231030314, 0.075138623])
_STO3G_2S_COEF = np.array([-0.099967229, 0.399512826, 0.700115469])
_STO3G_2P_COEF = np.array([0.155916275, 0.607683719, 0.391957393])
# Universal n=3 SP expansion at zeta=1 (Stewart, JCP 52, 431 (1970));
# 3s and 3p share exponents like the 2sp set. Cross-checked against the
# standard published element tables: exponents for Na/Mg/Si/P/S/Cl all
# reproduce to 5 significant digits under the zeta^2 scaling below.
_STO3G_3SP_EXP = np.array([0.4828540806, 0.1347150629, 0.0527279624])
_STO3G_3S_COEF = np.array([-0.2196203690, 0.2255954336, 0.9003984260])
_STO3G_3P_COEF = np.array([0.0105876043, 0.5951670053, 0.4620010120])

# Standard (molecular-environment) STO-3G Slater exponents per element:
# {Z: (zeta_1s, zeta_2sp, zeta_3sp)} — Hehre, Ditchfield, Stewart &
# Pople, JCP 52, 2769 (1970) for the third row.
_STO3G_ZETA = {
    1: (1.24, None, None),
    2: (1.69, None, None),
    3: (2.69, 0.80, None),
    4: (3.68, 1.15, None),
    5: (4.68, 1.50, None),
    6: (5.67, 1.72, None),
    7: (6.67, 1.95, None),
    8: (7.66, 2.25, None),
    9: (8.65, 2.55, None),
    10: (9.64, 2.88, None),
    11: (10.61, 3.48, 1.75),
    12: (11.59, 3.90, 1.70),
    13: (12.56, 4.36, 1.70),
    14: (13.53, 4.83, 1.75),
    15: (14.50, 5.31, 1.90),
    16: (15.47, 5.79, 2.05),
    17: (16.43, 6.26, 2.10),
    18: (17.40, 6.74, 2.33),
}


# cc-pVDZ tables: {Z: [(l, exponents, coefficients), ...]}, coefficients
# over normalized primitives. H: (4s,1p)->[2s,1p]; Li/C: (9s,4p,1d)->[3s,2p,1d].
_CCPVDZ = {
    1: [  # H
        (0,
         np.array([13.0100, 1.9620, 0.4446, 0.1220]),
         np.array([0.0196850, 0.1379770, 0.4781480, 0.5012400])),
        (0, np.array([0.1220]), np.array([1.0])),
        (1, np.array([0.7270]), np.array([1.0])),
    ],
    3: [  # Li
        (0,
         np.array([1469.0, 220.5, 50.26, 14.24, 4.581, 1.580, 0.5640,
                   0.07345, 0.02805]),
         np.array([0.0007660, 0.0058920, 0.0296710, 0.1091800, 0.2827890,
                   0.4531230, 0.2747740, 0.0097510, -0.0031800])),
        (0,
         np.array([1469.0, 220.5, 50.26, 14.24, 4.581, 1.580, 0.5640,
                   0.07345, 0.02805]),
         np.array([-0.0001200, -0.0009230, -0.0046890, -0.0176820,
                   -0.0489020, -0.0960090, -0.1363800, 0.5751020,
                   0.5176610])),
        (0, np.array([0.02805]), np.array([1.0])),
        (1,
         np.array([1.5340, 0.2749, 0.07362]),
         np.array([0.0227840, 0.1391070, 0.5003750])),
        (1, np.array([0.02403]), np.array([1.0])),
        (2, np.array([0.1239]), np.array([1.0])),
    ],
    7: [  # N
        (0,
         np.array([9046.0, 1357.0, 309.3, 87.73, 28.56, 10.21, 3.838,
                   0.7466, 0.2248]),
         np.array([0.000700, 0.005389, 0.027406, 0.103207, 0.278723,
                   0.448540, 0.278238, 0.015440, -0.002864])),
        (0,
         np.array([9046.0, 1357.0, 309.3, 87.73, 28.56, 10.21, 3.838,
                   0.7466, 0.2248]),
         np.array([-0.000153, -0.001208, -0.005992, -0.024544, -0.067459,
                   -0.158078, -0.121831, 0.549003, 0.578815])),
        (0, np.array([0.2248]), np.array([1.0])),
        (1,
         np.array([13.55, 2.917, 0.7973, 0.2185]),
         np.array([0.039919, 0.217169, 0.510319, 0.462214])),
        (1, np.array([0.2185]), np.array([1.0])),
        (2, np.array([0.8170]), np.array([1.0])),
    ],
    8: [  # O
        (0,
         np.array([11720.0, 1759.0, 400.8, 113.7, 37.03, 13.27, 5.025,
                   1.013, 0.3023]),
         np.array([0.000710, 0.005470, 0.027837, 0.104800, 0.283062,
                   0.448719, 0.270952, 0.015458, -0.002585])),
        (0,
         np.array([11720.0, 1759.0, 400.8, 113.7, 37.03, 13.27, 5.025,
                   1.013, 0.3023]),
         np.array([-0.000160, -0.001263, -0.006267, -0.025716, -0.070924,
                   -0.165411, -0.116955, 0.557368, 0.572759])),
        (0, np.array([0.3023]), np.array([1.0])),
        (1,
         np.array([17.70, 3.854, 1.046, 0.2753]),
         np.array([0.043018, 0.228913, 0.508728, 0.460531])),
        (1, np.array([0.2753]), np.array([1.0])),
        (2, np.array([1.185]), np.array([1.0])),
    ],
    6: [  # C
        (0,
         np.array([6665.0, 1000.0, 228.0, 64.71, 21.06, 7.495, 2.797,
                   0.5215, 0.1596]),
         np.array([0.000692, 0.005329, 0.027077, 0.101718, 0.274740,
                   0.448564, 0.285074, 0.015204, -0.003191])),
        (0,
         np.array([6665.0, 1000.0, 228.0, 64.71, 21.06, 7.495, 2.797,
                   0.5215, 0.1596]),
         np.array([-0.000146, -0.001154, -0.005725, -0.023312, -0.063955,
                   -0.149981, -0.127262, 0.544529, 0.580496])),
        (0, np.array([0.1596]), np.array([1.0])),
        (1,
         np.array([9.439, 2.002, 0.5456, 0.1517]),
         np.array([0.038109, 0.209480, 0.508557, 0.468842])),
        (1, np.array([0.1517]), np.array([1.0])),
        (2, np.array([0.5500]), np.array([1.0])),
    ],
}


def ccpvdz_shells_for_atom(z: int) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """[(l, exponents, coefficients)] for element Z, cc-pVDZ."""
    if z not in _CCPVDZ:
        raise NotImplementedError(
            f"cc-pvdz built-in table covers H/Li/C/N/O (Z=1,3,6,7,8); got "
            f"Z={z}. Extend _CCPVDZ in scf/basis.py with the published "
            "exponents."
        )
    return [(l, e.copy(), c.copy()) for l, e, c in _CCPVDZ[z]]


@dataclasses.dataclass(frozen=True)
class Shell:
    """One contracted CARTESIAN shell; primitives normalized to the
    axis-aligned component (x^l): off-axis cartesians (xy, ...) then
    carry their natural relative weights — absorbed by the overlap
    metric in the generalized eigenproblem, so only conditioning (not
    correctness) depends on this choice."""

    l: int
    exponents: np.ndarray
    coefficients: np.ndarray  # contraction over NORMALIZED primitives
    atom_index: int
    center: np.ndarray

    @property
    def nfunc(self) -> int:
        return (self.l + 1) * (self.l + 2) // 2  # cartesian: s 1, p 3, d 6


def primitive_norm(alpha: np.ndarray, l: int) -> np.ndarray:
    """Unit-overlap norm of the axis-aligned cartesian Gaussian
    x^l exp(-a r^2), any l: (2a/pi)^{3/4} (4a)^{l/2} / sqrt((2l-1)!!)."""
    dfact = 1.0
    for m in range(2 * l - 1, 0, -2):
        dfact *= m
    return (2.0 * alpha / np.pi) ** 0.75 * (4.0 * alpha) ** (l / 2.0) / np.sqrt(dfact)


def sto3g_shells_for_atom(z: int) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """[(l, exponents, coefficients)] for element Z (coeffs over normalized
    primitives)."""
    if z not in _STO3G_ZETA:
        raise NotImplementedError(
            f"sto-3g built-in table covers Z=1..18; got Z={z}"
        )
    zeta1, zeta2, zeta3 = _STO3G_ZETA[z]
    shells = [(0, _STO3G_1S[0] * zeta1**2, _STO3G_1S[1].copy())]
    if zeta2 is not None:
        exp2 = _STO3G_2SP_EXP * zeta2**2
        shells.append((0, exp2, _STO3G_2S_COEF.copy()))
        shells.append((1, exp2.copy(), _STO3G_2P_COEF.copy()))
    if zeta3 is not None:
        exp3 = _STO3G_3SP_EXP * zeta3**2
        shells.append((0, exp3, _STO3G_3S_COEF.copy()))
        shells.append((1, exp3.copy(), _STO3G_3P_COEF.copy()))
    return shells


def build_shells(cell, basis: str = "sto-3g",
                 exp_to_discard: float = 0.1) -> List[Shell]:
    """Contracted shells for every atom of a cell.

    `exp_to_discard` drops primitives more diffuse than the cutoff — the
    standard practice for periodic GTO bases (every reference config sets
    cell.exp_to_discard = 0.1, e.g. config/diamond.py:31); diffuse
    primitives are near-linearly-dependent across cells and blow up the
    lattice sums.
    """
    name = basis.lower().replace("_", "-").replace(" ", "")
    if name in ("sto-3g", "sto3g", "minimal", ""):
        shells_for_atom = sto3g_shells_for_atom
    elif name in ("cc-pvdz", "ccpvdz"):
        shells_for_atom = ccpvdz_shells_for_atom
    elif name in ("et-dz", "etdz", "dz"):
        raise NotImplementedError(
            "the generated et-dz basis is not ported yet (its generator "
            "needs the atomic UHF of scf/etdz.py and scf/molecular.py)")
    else:
        raise NotImplementedError(
            f"built-in bases: sto-3g, cc-pvdz, et-dz (got {basis!r}); pass "
            "explicit shells or extend scf/basis.py"
        )
    shells = []
    for ia, (sym, xyz) in enumerate(zip(cell.atom_symbols, cell.atom_coords)):
        z = elements.symbol_to_number(sym)
        for l, exps, coefs in shells_for_atom(z):
            keep = np.asarray(exps) >= (exp_to_discard or 0.0)
            if not np.any(keep):
                continue
            shells.append(
                Shell(
                    l=l,
                    exponents=np.asarray(exps, np.float64)[keep],
                    coefficients=np.asarray(coefs, np.float64)[keep],
                    atom_index=ia,
                    center=np.asarray(xyz, np.float64),
                )
            )
    return shells


def num_ao(shells: List[Shell]) -> int:
    return sum(s.nfunc for s in shells)
