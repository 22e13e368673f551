"""Shared builders for the PyTorch-port parity tests.

Each builder makes the same small system in both packages: the JAX
reference (deepsolid_tpu) and the port (deepsolid_tpu_torch). Inputs are
numpy arrays made from fixed seeds; both sides compute in float64.
"""

import os

import jax
import numpy as np
import torch

from deepsolid_tpu.models import network as jnet_lib
from deepsolid_tpu.scf.free_electron import free_electron_klist
from deepsolid_tpu.system import Atom as JAtom, Cell as JCell, make_supercell as jmake_sc
from deepsolid_tpu_torch.models import network as tnet_lib
from deepsolid_tpu_torch.system import Atom, Cell, make_supercell

F64 = torch.float64
# the committed UHF solutions (runs/scf_cache), shared by both packages
REPO_SCF_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "runs", "scf_cache")
SMALL_NET = dict(hidden_dims=((16, 8), (16, 8)), determinants=2)


def lih_cells(S=None):
    """LiH on an fcc lattice (a skewed lattice: exercises the image search)."""
    L = 2 / 0.529177
    lattice = (1 - np.eye(3)) * L / 2
    S = np.eye(3) if S is None else S
    j = jmake_sc(JCell.from_atoms([JAtom("Li", (0, 0, 0)),
                                   JAtom("H", (L / 2,) * 3)], lattice), S)
    t = make_supercell(Cell.from_atoms([Atom("Li", (0, 0, 0)),
                                        Atom("H", (L / 2,) * 3)], lattice), S)
    return j, t


def h2_cells(L=2.0):
    """Two H atoms in an orthogonal box (configs/two_hydrogen_cell.py)."""
    lattice = np.diag([2 * L, 10.0, 10.0])
    j = jmake_sc(JCell.from_atoms([JAtom("H", (L, 0, 0)), JAtom("H", (0, 0, 0))],
                                  lattice), np.eye(3))
    t = make_supercell(Cell.from_atoms([Atom("H", (L, 0, 0)), Atom("H", (0, 0, 0))],
                                       lattice), np.eye(3))
    return j, t


def networks(cells=None, seed=1, **cfg):
    """(jax network, torch network, numpy params, torch params, jax supercell)."""
    jsc, tsc = cells or lih_cells()
    cfg = {**SMALL_NET, **cfg}
    klist = free_electron_klist(jsc)
    jnet = jnet_lib.make_network(jsc, klist, jnet_lib.NetworkConfig(**cfg))
    tnet = tnet_lib.make_network(tsc, klist, tnet_lib.NetworkConfig(**cfg))
    params = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(seed)))
    return jnet, tnet, params, tnet_lib.params_from_jax(params, dtype=F64), jsc


def walkers(n_walkers, nelec, seed=0, spread=2.0):
    return np.random.RandomState(seed).randn(n_walkers, 3 * nelec) * spread


def t64(a):
    return torch.tensor(np.asarray(a), dtype=F64)
