"""Build a system from a VASP POSCAR file (mirrors deepsolid_tpu/configs/read_poscar.py;
reference: config/read_poscar.py).

input_str: "poscar_path,S,basis" e.g. "bcc_li.vasp,3,ccpvdz".
"""

import numpy as np

from deepsolid_tpu_torch import config as base_config
from deepsolid_tpu_torch.system import make_supercell, read_poscar


def get_config(input_str):
    poscar_path, S, basis = input_str.split(",")
    S = np.diag([int(S)] * 3)
    cell = read_poscar(poscar_path)
    cfg = base_config.default()
    cfg.system.cell = make_supercell(cell, S)
    cfg.system.basis = basis
    return cfg
