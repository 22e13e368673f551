"""Port parity: Ewald sums, the local energy and its batch statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsolid_tpu.hamiltonian import make_local_energy as jmake_le
from deepsolid_tpu.ops.ewald import EwaldSum as JEwald
from deepsolid_tpu.train import loss as jloss
from deepsolid_tpu_torch.hamiltonian import make_local_energy as tmake_le
from deepsolid_tpu_torch.ops.ewald import EwaldSum as TEwald
from deepsolid_tpu_torch.system import Atom, Cell
from deepsolid_tpu_torch.train import loss as tloss

from torch_helpers import h2_cells, lih_cells, networks, t64, walkers

NACL_MADELUNG = 1.747564594633182  # per ion pair at unit nearest distance
CSCL_MADELUNG = 1.76267477307099


def nacl_cell(a=2.0):
    plus = [(0, 0, 0), (1, 1, 0), (1, 0, 1), (0, 1, 1)]
    minus = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 1)]
    return Cell(lattice=np.eye(3) * a,
                atom_coords=np.array(plus + minus, np.float64) * (a / 2),
                atom_charges=np.array([1.0] * 4 + [-1.0] * 4),
                atom_symbols=("H",) * 8, spin=0)


def test_madelung_oracles():
    a = 2.0
    np.testing.assert_allclose(TEwald.build(nacl_cell(a)).madelung,
                               -4 * NACL_MADELUNG / (a / 2), rtol=1e-9)
    a = 3.0
    cscl = Cell(lattice=np.eye(3) * a, atom_coords=np.array([[0, 0, 0], [a / 2] * 3]),
                atom_charges=np.array([1.0, -1.0]), atom_symbols=("H", "H"), spin=0)
    np.testing.assert_allclose(TEwald.build(cscl).madelung,
                               -CSCL_MADELUNG / (a * np.sqrt(3) / 2), rtol=1e-9)


@pytest.mark.parametrize("cells", [lih_cells, h2_cells])
def test_ewald_energy_matches_jax(cells):
    jsc, tsc = cells()
    jew, tew = JEwald.build(jsc), TEwald.build(tsc)
    np.testing.assert_array_equal(tew.gpoints, jew.gpoints)
    np.testing.assert_allclose(tew.madelung, jew.madelung, rtol=1e-13)
    x = walkers(3, jsc.nelectron, seed=7, spread=3.0)
    got = tew.energy(t64(x))
    for b in range(3):
        want = jew.energy(jnp.asarray(x[b]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[b].item(), float(w), rtol=1e-11, atol=1e-11)


def test_electrons_on_the_ions_reproduce_the_ion_energy():
    L = 3.1
    cell = Cell.from_atoms([Atom("H", (0, 0, 0)), Atom("H", (L / 2,) * 3)],
                           np.eye(3) * L, spin=0)
    ee, _, ii = TEwald.build(cell).energy(t64(cell.atom_coords.reshape(1, -1)))
    np.testing.assert_allclose(ee.item(), ii.item(), rtol=1e-9)


def test_local_energy_matches_jax():
    jnet, tnet, params, tp, jsc = networks()
    _, tsc = lih_cells()
    x = walkers(3, jsc.nelectron, seed=8)
    jel = jmake_le(jnet.logdet, jsc, mode="forward", network=jnet)
    jke, jew = jax.vmap(jel, in_axes=(None, 0))(params, jnp.asarray(x))
    tke, tew = tmake_le(tnet, tsc)(tp, t64(x))
    np.testing.assert_allclose(tke.numpy(), np.asarray(jke), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tew.numpy(), np.asarray(jew), rtol=1e-11, atol=1e-11)


def _stats_inputs():
    rng = np.random.RandomState(9)
    ke = rng.randn(8) * 3 + 20 + 1j * rng.randn(8)
    ew = rng.randn(8) - 40
    ke[3] = np.nan  # a walker at a node
    ew[5] = np.inf  # a coalescence
    return ke, ew


def test_energy_statistics_match_jax_total_energy(monkeypatch):
    """The reference's total_energy on a fixed batch of local energies,
    with two walkers made non-finite on purpose."""
    ke, ew = _stats_inputs()
    loss, aux = tloss.energy_statistics(torch.from_numpy(ke), torch.from_numpy(ew))
    assert aux.finite.tolist() == [1, 1, 1, 0, 1, 0, 1, 1]

    def fake_le(f, supercell, **kw):
        def el(params, x):
            i = x[0].astype(jnp.int32)
            return jnp.asarray(ke)[i], jnp.asarray(ew)[i]
        return el

    monkeypatch.setattr(jloss, "make_local_energy", fake_le)
    total = jloss.make_loss(None, None, None, mode="forward")
    jl, jaux = total(None, jnp.arange(8.0)[:, None])
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-13)
    for name in ("variance", "local_energy", "imaginary", "kinetic", "ewald", "finite"):
        np.testing.assert_allclose(np.asarray(getattr(aux, name)),
                                   np.asarray(getattr(jaux, name)), rtol=1e-13,
                                   err_msg=name)


@pytest.mark.parametrize("clip_type", ["real", "complex"])
def test_clip_local_energy_diff_matches_jax(clip_type):
    rng = np.random.RandomState(10)
    diff = rng.randn(10) * np.exp(rng.randn(10) * 2) + 1j * rng.randn(10)
    want = jloss.clip_local_energy_diff(jnp.asarray(diff), 1.5, clip_type)
    got = tloss.clip_local_energy_diff(torch.from_numpy(diff), 1.5, clip_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    assert tloss.clip_local_energy_diff(torch.from_numpy(diff), 0.0, clip_type) is not None


def test_walker_chunks_match_the_whole_batch():
    _, tnet, _, tp, jsc = networks()
    _, tsc = lih_cells()
    x = t64(walkers(4, jsc.nelectron, seed=11))
    whole = tloss.make_batch_local_energy(tnet, tsc, el_chunk=0)(tp, x)
    chunked = tloss.make_batch_local_energy(tnet, tsc, el_chunk=2)(tp, x)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="el_chunk"):
        tloss.make_batch_local_energy(tnet, tsc, el_chunk=3)(tp, x)
    loss, aux = tloss.make_loss(tnet, tsc, el_chunk=2)(tp, x)
    torch.testing.assert_close(loss, torch.mean(whole[0] + whole[1]).real)
