"""The port's SCF orbital source against the JAX package, in float64.

Host numpy pieces (basis tables, core matrices, UHF, short-range ERIs,
the cache key) must agree with deepsolid_tpu/scf to rounding; the torch
pieces (Bloch AOs, the sources' orbital matrices and log|det|) to 1e-12.
Small cells only: no cold diamond SCF and no diamond 'core' build.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsolid_tpu.scf import basis as jbasis
from deepsolid_tpu.scf import eri as jeri
from deepsolid_tpu.scf import gto as jgto
from deepsolid_tpu.scf import hf as jhf
from deepsolid_tpu.scf import interface as jinterface
from deepsolid_tpu.scf.free_electron import twisted_kpts as jtwisted_kpts
from deepsolid_tpu.system import Atom as JAtom, Cell as JCell, make_supercell as jmake_sc
from deepsolid_tpu_torch import native as tnative
from deepsolid_tpu_torch.scf import basis as tbasis
from deepsolid_tpu_torch.scf import eri as teri
from deepsolid_tpu_torch.scf import gto as tgto
from deepsolid_tpu_torch.scf import hf as thf
from deepsolid_tpu_torch.scf import interface as tinterface
from deepsolid_tpu_torch.scf.free_electron import twisted_kpts as ttwisted_kpts
from deepsolid_tpu_torch.system import Atom, Cell, make_supercell

from torch_helpers import REPO_SCF_CACHE, h2_cells, t64, walkers


def both_cells(atoms, lattice, S=None):
    """(JAX supercell, port supercell) of the same atoms and lattice."""
    S = np.eye(3) if S is None else S
    j = jmake_sc(JCell.from_atoms([JAtom(s, p) for s, p in atoms], lattice), S)
    t = make_supercell(Cell.from_atoms([Atom(s, p) for s, p in atoms], lattice), S)
    return j, t


def h2_gamma_cells(L=8.0):
    """The H2 Gamma-cell of tests/test_scf_eri.py."""
    return both_cells([("H", (0.2, 0.1, 0.0)), ("H", (1.6, 0.0, 0.3))], np.eye(3) * L)


def diamond_prim_cells():
    L = 3.567 / 0.529177210903
    return both_cells([("C", (0.0, 0.0, 0.0)), ("C", (0.25 * L,) * 3)],
                      (np.ones((3, 3)) - np.eye(3)) * L / 2)


def assert_same_shells(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.l, g.atom_index, g.nfunc) == (w.l, w.atom_index, w.nfunc)
        for attr in ("exponents", "coefficients", "center"):
            np.testing.assert_array_equal(getattr(g, attr), getattr(w, attr))


@pytest.mark.parametrize("basis", ["sto-3g", "cc-pvdz"])
def test_build_shells_match(basis):
    L = 3.0
    atoms = [("C", (0.0, 0.0, 0.0)), ("H", (1.1, 0.2, 0.0)), ("H", (-0.4, 1.0, 0.1))]
    jsc, tsc = both_cells(atoms, np.eye(3) * 2 * L)
    got, want = tbasis.build_shells(tsc.prim, basis), jbasis.build_shells(jsc.prim, basis)
    assert_same_shells(got, want)
    assert tbasis.num_ao(got) == jbasis.num_ao(want)
    if basis == "cc-pvdz":
        assert any(s.l == 2 for s in got)


def test_unported_basis_raises():
    _, tsc = h2_gamma_cells()
    with pytest.raises(NotImplementedError, match="et-dz"):
        tbasis.build_shells(tsc.prim, "et-dz")
    with pytest.raises(NotImplementedError, match="built-in bases"):
        tbasis.build_shells(tsc.prim, "6-31g")


def test_core_matrices_at_two_kpoints_match():
    jsc, tsc = h2_cells()
    S = np.diag([2, 1, 1])
    jsc2, tsc2 = jmake_sc(jsc.prim, S), make_supercell(tsc.prim, S)
    kpts = ttwisted_kpts(tsc2)
    assert kpts.shape == (2, 3)
    np.testing.assert_array_equal(kpts, jtwisted_kpts(jsc2))
    got = thf.core_matrices(tsc.prim, tbasis.build_shells(tsc.prim), kpts)
    want = jhf.core_matrices(jsc.prim, jbasis.build_shells(jsc.prim), kpts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


def test_run_uhf_on_the_h2_gamma_cell_matches():
    jsc, tsc = h2_gamma_cells()
    kpts = ttwisted_kpts(tsc)
    got = thf.run_uhf(tsc, tbasis.build_shells(tsc.prim), kpts)
    want = jhf.run_uhf(jsc, jbasis.build_shells(jsc.prim), kpts)
    assert got.converged and want.converged
    assert abs(got.e_tot - want.e_tot) <= 1e-10
    for s in range(2):
        for g, w in zip(got.eps[s], want.eps[s]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)


@pytest.mark.parametrize("engine", ["numpy", "native"])
def test_sr_eri_tensors_match(engine):
    if engine == "native" and tnative.load() is None:
        pytest.skip("native engine unavailable")
    jsc, tsc = both_cells([("H", (0.2, 0.1, 0.0)), ("H", (1.6, 0.0, 0.3))],
                          np.eye(3) * 10.0)
    kpts = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, np.pi / 10.0]])
    got = teri.sr_eri_tensors(tbasis.build_shells(tsc.prim), tsc.lattice, kpts, 0.8,
                              eps=1e-8, engine=engine)
    want = jeri.sr_eri_tensors(jbasis.build_shells(jsc.prim), jsc.lattice, kpts, 0.8,
                               eps=1e-8, engine="numpy")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12)


def test_eval_aos_with_d_shells_match():
    """cc-pVDZ carbon (s, p and cartesian d shells) at two k-points, with
    positions outside the home cell (the wrap phase)."""
    jsc, tsc = diamond_prim_cells()
    tshells = tbasis.build_shells(tsc.prim, "cc-pvdz")
    assert {s.l for s in tshells} == {0, 1, 2}
    kpts = np.array([[0.0, 0.0, 0.0], [0.1, -0.2, 0.15]])
    tev = tgto.PeriodicAOEvaluator.build(tsc.prim, tshells, kpts)
    jev = jgto.PeriodicAOEvaluator.build(jsc.prim, jbasis.build_shells(jsc.prim, "cc-pvdz"),
                                         kpts)
    np.testing.assert_array_equal(tev.images, jev.images)
    pos = walkers(6, 1, seed=3, spread=6.0).reshape(6, 3)
    got = tev.eval_aos(t64(pos))
    want = np.asarray(jev.eval_aos(jnp.asarray(pos)))
    assert got.shape == want.shape == (2, 6, tev.nao)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    f32 = tev.eval_aos(torch.tensor(pos, dtype=torch.float32))
    assert f32.dtype == torch.complex64


def test_source_orbital_mats_match():
    """ScfOrbitals (core level) and PlaneWaveOrbitals of an H2 2x1x1
    supercell on the same walkers: matrices and log|det| to 1e-12."""
    jsc, tsc = h2_cells()
    S = np.diag([2, 1, 1])
    jsc, tsc = jmake_sc(jsc.prim, S), make_supercell(tsc.prim, S)
    x = walkers(5, 4, seed=1)
    sources = (
        (thf.ScfOrbitals.build(tsc, "sto-3g"), jhf.ScfOrbitals.build(jsc, "sto-3g")),
        (tinterface.PlaneWaveOrbitals(tsc), jinterface.PlaneWaveOrbitals(jsc)),
    )
    for tsrc, jsrc in sources:
        for kt, kj in zip(tsrc.klist, jsrc.klist):
            np.testing.assert_array_equal(kt, kj)
        got, want = tsrc.orbital_mats(t64(x)), jsrc.orbital_mats(jnp.asarray(x))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.shape == (5, 2, 2)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
        np.testing.assert_allclose(tsrc.slogdet(t64(x)).numpy(),
                                   np.asarray(jsrc.slogdet(jnp.asarray(x))),
                                   rtol=0, atol=1e-12)


def test_diamond_cache_is_shared_with_the_jax_package(monkeypatch):
    """The port's cache key for C-diamond 2x2x2 at sto-3g names the
    committed UHF solution, as the JAX package's does; the 'hf' source
    built from it has the JAX package's k-list and occupied orbitals."""
    from deepsolid_tpu.configs import diamond as jdiamond
    from deepsolid_tpu_torch.configs import diamond as tdiamond

    monkeypatch.setenv("DEEPSOLID_TPU_SCF_CACHE", REPO_SCF_CACHE)
    jsc = jdiamond.get_config("C,C,3.567,2,sto-3g").system.cell
    tsc = tdiamond.get_config("C,C,3.567,2,sto-3g").system.cell
    kpts = ttwisted_kpts(tsc)
    got = thf._uhf_cache_path(tsc, "sto-3g", kpts, tbasis.build_shells(tsc.prim))
    want = jhf._uhf_cache_path(jsc, "sto-3g", jtwisted_kpts(jsc),
                               jbasis.build_shells(jsc.prim))
    assert got == want
    assert os.path.basename(got) == "uhf_306af45eadea1959436d4d22.npz"
    assert os.path.exists(got)

    tsrc = thf.ScfOrbitals.build(tsc, "sto-3g", level="hf")
    jsrc = jhf.ScfOrbitals.build(jsc, "sto-3g", level="hf")
    for kt, kj in zip(tsrc.klist, jsrc.klist):
        assert kt.shape == (48, 3)
        np.testing.assert_array_equal(kt, kj)
    for s in range(2):
        for ct, cj in zip(tsrc.c_occ[s], jsrc.c_occ[s]):
            np.testing.assert_array_equal(ct, cj)
