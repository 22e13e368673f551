"""Port parity: complex polarization and structure factor against the JAX
package in float64, and over two gloo data ranks against one process.
Module level imports no JAX (the rank workers import this module)."""

import numpy as np
import pytest
import torch

from deepsolid_tpu_torch import observables as tobs
from deepsolid_tpu_torch import parallel
from deepsolid_tpu_torch.system import Atom, Cell, make_supercell

RANK_TIMEOUT = 300.0  # seconds: run_ranks ends the ranks and fails after it


def torch_cell(name):
    if name == "h2":
        lattice = np.diag([4.0, 10.0, 10.0])
        atoms = [Atom("H", (2.0, 0, 0)), Atom("H", (0, 0, 0))]
    else:  # LiH on the skewed fcc lattice
        L = 2 / 0.529177
        lattice = (1 - np.eye(3)) * L / 2
        atoms = [Atom("Li", (0, 0, 0)), Atom("H", (L / 2,) * 3)]
    return make_supercell(Cell.from_atoms(atoms, lattice), np.eye(3))


def walkers(sc, n=16, seed=0):
    return np.random.RandomState(seed).rand(n, 3 * sc.nelectron) * 4.0


@pytest.mark.parametrize("name,direction", [("h2", 0), ("lih", 1)])
def test_observables_match_jax(name, direction):
    import jax

    from deepsolid_tpu import observables as jobs
    from torch_helpers import h2_cells, lih_cells

    jsc, _ = (h2_cells if name == "h2" else lih_cells)()
    sc = torch_cell(name)
    data = walkers(sc)
    jpol = complex(jax.jit(jobs.make_complex_polarization(jsc, direction=direction))(data))
    tpol = complex(tobs.make_complex_polarization(sc, direction=direction)(
        torch.tensor(data)))
    assert abs(tpol - jpol) <= 1e-12 and abs(jpol) > 1e-3
    jsk = np.asarray(jax.jit(jobs.make_structure_factor(jsc, nq=3))(data))
    tsk = tobs.make_structure_factor(sc, nq=3)(torch.tensor(data)).numpy()
    assert tsk.shape == (27,) and abs(tsk[0]) <= 1e-12  # S(0) = 0
    np.testing.assert_allclose(tsk, jsk.real, rtol=1e-12, atol=1e-12)


def observables_rank(rank, world_size, data):
    mesh = parallel.make_mesh()
    local = torch.tensor(data).chunk(world_size)[mesh.data_index]
    sc = torch_cell("lih")
    pol = tobs.make_complex_polarization(sc, all_mean=mesh.all_mean)(local)
    sk = tobs.make_structure_factor(sc, nq=2, all_mean=mesh.all_mean)(local)
    return complex(pol), sk.numpy()


def test_observables_on_two_data_ranks_equal_one_process():
    """The complex means reduce over gloo as (Re, Im) pairs."""
    sc = torch_cell("lih")
    data = walkers(sc, n=12, seed=3)
    pol = complex(tobs.make_complex_polarization(sc)(torch.tensor(data)))
    sk = tobs.make_structure_factor(sc, nq=2)(torch.tensor(data)).numpy()
    ranks = parallel.run_ranks(observables_rank, 2, args=(data,), timeout=RANK_TIMEOUT)
    for rank_pol, rank_sk in ranks:
        assert abs(rank_pol - pol) <= 1e-12
        np.testing.assert_allclose(rank_sk, sk, rtol=1e-12, atol=1e-12)
