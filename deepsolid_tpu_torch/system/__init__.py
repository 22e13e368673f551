from deepsolid_tpu_torch.system.atom import Atom
from deepsolid_tpu_torch.system.cell import (
    Cell,
    Supercell,
    make_supercell,
    reciprocal_vectors,
    supercell_copies,
    supercell_kpts,
    symmetry_feature_vectors,
)

__all__ = [
    "Atom",
    "Cell",
    "Supercell",
    "make_supercell",
    "reciprocal_vectors",
    "supercell_copies",
    "supercell_kpts",
    "symmetry_feature_vectors",
]
