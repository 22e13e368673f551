"""Unit conversions (Hartree atomic units internally).

Parity: reference DeepSolid/utils/units.py:25-49.
"""

# CODATA 2014, matching PySCF's BOHR constant so geometries agree with the
# reference configs to full precision.
BOHR_ANGSTROM = 0.52917721092
HARTREE_KCAL = 627.509474


def angstrom2bohr(x):
    return x / BOHR_ANGSTROM


def bohr2angstrom(x):
    return x * BOHR_ANGSTROM


def hartree2kcal(x):
    return x * HARTREE_KCAL


def kcal2hartree(x):
    return x / HARTREE_KCAL


def ev2hartree(x):
    return x / 27.211386245988


def hartree2ev(x):
    return x * 27.211386245988
