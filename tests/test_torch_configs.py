"""The port's configs, POSCAR reader, et-dz basis and the systems they
build (Si diamond, bcc-Li 3x3x3) against the JAX package, in float64.

Every config is built from the strings of the production run scripts
(runs/*_run.py). Si and bcc-Li take their UHF sources from the committed
cache (runs/scf_cache): no SCF runs here.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsolid_tpu.configs import bcc as jbcc
from deepsolid_tpu.configs import diamond as jdiamond
from deepsolid_tpu.configs import graphene as jgraphene
from deepsolid_tpu.configs import hydrogen_chain as jhydrogen_chain
from deepsolid_tpu.configs import read_poscar as jread_poscar
from deepsolid_tpu.configs import rock_salt as jrock_salt
from deepsolid_tpu.configs import two_hydrogen_cell as jtwo_hydrogen_cell
from deepsolid_tpu.hamiltonian import make_local_energy as jmake_le
from deepsolid_tpu.scf import basis as jbasis
from deepsolid_tpu.scf import etdz as jetdz
from deepsolid_tpu.scf import molecular as jmolecular
from deepsolid_tpu.system import read_poscar as jread_poscar_file
from deepsolid_tpu.train import pretrain as jpretrain
from deepsolid_tpu.train.process import build_network as jbuild_network
from deepsolid_tpu_torch.configs import bcc as tbcc
from deepsolid_tpu_torch.configs import diamond as tdiamond
from deepsolid_tpu_torch.configs import graphene as tgraphene
from deepsolid_tpu_torch.configs import hydrogen_chain as thydrogen_chain
from deepsolid_tpu_torch.configs import read_poscar as tread_poscar
from deepsolid_tpu_torch.configs import rock_salt as trock_salt
from deepsolid_tpu_torch.configs import two_hydrogen_cell as ttwo_hydrogen_cell
from deepsolid_tpu_torch.hamiltonian import make_local_energy as tmake_le
from deepsolid_tpu_torch.models.fwdlap_forward import make_logpsi_and_kinetic
from deepsolid_tpu_torch.models.network import param_shapes, params_from_jax
from deepsolid_tpu_torch.scf import basis as tbasis
from deepsolid_tpu_torch.scf import etdz as tetdz
from deepsolid_tpu_torch.scf import hf as thf
from deepsolid_tpu_torch.scf import molecular as tmolecular
from deepsolid_tpu_torch.system import read_poscar as tread_poscar_file
from deepsolid_tpu_torch.train import process as tprocess
from deepsolid_tpu_torch.utils.checkpoint import restore

from test_torch_scf import assert_same_shells
from torch_helpers import REPO_SCF_CACHE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_POSCAR = os.path.join(REPO, "deepsolid_tpu", "configs", "poscar", "bcc_li.vasp")
PORT_POSCAR = os.path.join(REPO, "deepsolid_tpu_torch", "configs", "poscar", "bcc_li.vasp")
BCC_LI_CKPT = os.path.join(REPO, "runs", "ckpt_bcc_li", "qmcjax_ckpt_000000.npz")
NARROW = dict(hidden_dims=((16, 4),) * 2, determinants=1)

# (port module, JAX module, input string): the run scripts' systems, and
# each config's own docstring example where no run script uses it
CONFIGS = {
    "diamond": (tdiamond, jdiamond, "C,C,3.567,2,sto-3g"),
    "si_sto3g": (tdiamond, jdiamond, "Si,Si,5.43,1,sto-3g"),
    "si_etdz": (tdiamond, jdiamond, "Si,Si,5.43,1,et-dz"),
    "bcc_li_poscar": (tread_poscar, jread_poscar, "{poscar},3,sto-3g"),
    "bcc": (tbcc, jbcc, "Li,3.43,3,1,sto-3g"),
    "graphene": (tgraphene, jgraphene, "C,C,2.46,1,20,sto-3g"),
    "lih_sto3g": (trock_salt, jrock_salt, "Li,H,4.02,2,sto-3g"),
    "lih_ccpvdz": (trock_salt, jrock_salt, "Li,H,4.02,2,ccpvdz"),
    "h10": (thydrogen_chain, jhydrogen_chain, "H,10,1,1,1.8,0,ccpvdz"),
    "two_hydrogen_cell": (ttwo_hydrogen_cell, jtwo_hydrogen_cell, "H,5,1,1,2.0,0,ccpvdz"),
}


def assert_same_cell(got, want):
    """Equal cells: lattice within 1e-12 Bohr, everything else exactly."""
    np.testing.assert_allclose(got.lattice, want.lattice, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.atom_coords, want.atom_coords)
    np.testing.assert_array_equal(got.atom_charges, want.atom_charges)
    assert got.atom_symbols == want.atom_symbols
    assert (got.spin, got.charge, got.sym_type) == (want.spin, want.charge, want.sym_type)
    assert got.nelec == want.nelec


def both_configs(name):
    tmod, jmod, spec = CONFIGS[name]
    return (tmod.get_config(spec.format(poscar=PORT_POSCAR)),
            jmod.get_config(spec.format(poscar=JAX_POSCAR)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_matches_jax(name):
    tcfg, jcfg = both_configs(name)
    tsc, jsc = tcfg.system.cell, jcfg.system.cell
    assert_same_cell(tsc, jsc)
    assert_same_cell(tsc.prim, jsc.prim)
    np.testing.assert_array_equal(tsc.S, jsc.S)
    assert tsc.scale == jsc.scale
    np.testing.assert_allclose(tsc.kpts, jsc.kpts, rtol=0, atol=1e-12)
    assert tcfg.system.basis == jcfg.system.basis


def test_config_details():
    """What each config must carry over: graphene's hexagonal features, the
    H chain's 1-electron primitive cell with spin 1 under a paired
    supercell, bcc's primitive spin by parity, bcc-Li's 162 electrons."""
    assert both_configs("graphene")[0].system.cell.sym_type == "hexagonal"
    h10 = both_configs("h10")[0].system.cell
    assert (h10.prim.spin, h10.spin, h10.nelec) == (1, 0, (5, 5))
    bcc = both_configs("bcc")[0].system.cell
    assert (bcc.prim.spin, bcc.spin, bcc.nelec) == (1, 1, (41, 40))
    li = both_configs("bcc_li_poscar")[0].system.cell
    assert (li.natom, li.scale, li.nelec) == (54, 27, (81, 81))


def test_read_poscar_matches_jax():
    """The port's copy of the POSCAR file is the JAX package's, and the two
    readers build the same cell from it (spin and sym_type passed on)."""
    with open(PORT_POSCAR, "rb") as a, open(JAX_POSCAR, "rb") as b:
        assert a.read() == b.read()
    assert_same_cell(tread_poscar_file(PORT_POSCAR), jread_poscar_file(JAX_POSCAR))
    assert_same_cell(tread_poscar_file(PORT_POSCAR, spin=2, sym_type="hexagonal"),
                     jread_poscar_file(JAX_POSCAR, spin=2, sym_type="hexagonal"))


def _sources(name, monkeypatch):
    """(port cfg, JAX cfg, port source, JAX source) from the committed UHF
    cache; a cache miss fails instead of running an SCF."""
    monkeypatch.setenv("DEEPSOLID_TPU_SCF_CACHE", REPO_SCF_CACHE)
    tcfg, jcfg = both_configs(name)
    tcfg.pretrain.scf = jcfg.pretrain.scf = "hf"

    def no_scf(*args, **kwargs):
        raise AssertionError("the UHF cache missed: an SCF would run")

    monkeypatch.setattr(thf, "run_uhf", no_scf)
    tsrc = tprocess.orbital_source(tcfg, tcfg.system.cell)
    jsrc = jpretrain.make_orbital_source(jcfg, jcfg.system.cell)
    return tcfg, jcfg, tsrc, jsrc


@pytest.mark.parametrize("name", ["si_sto3g", "si_etdz"])
def test_si_sources_match_jax(name, monkeypatch):
    """Si diamond's sto-3g and et-dz UHF sources, read from runs/scf_cache
    by both packages: the same k-list and occupied coefficients."""
    _, _, tsrc, jsrc = _sources(name, monkeypatch)
    for got, want in zip(tsrc.klist, jsrc.klist):
        np.testing.assert_array_equal(got, want)
    for got_s, want_s in zip(tsrc.c_occ, jsrc.c_occ):
        assert len(got_s) == len(want_s)
        for got, want in zip(got_s, want_s):
            np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-10)


def test_bcc_li_network_matches_the_checkpoint(monkeypatch):
    """build_network on bcc-Li's source k-list (full width) gives exactly
    the parameter shapes of the committed step-0 checkpoint."""
    tcfg, _, tsrc, jsrc = _sources("bcc_li_poscar", monkeypatch)
    for got, want in zip(tsrc.klist, jsrc.klist):
        np.testing.assert_array_equal(got, want)
    net = tprocess.build_network(tcfg, tcfg.system.cell, klist_override=tsrc.klist)
    _, data, params, _, _ = restore(BCC_LI_CKPT)
    assert data.shape == (1024, 486)
    assert param_shapes(net.init(np.random.default_rng(0))) == param_shapes(params)


def test_etdz_tables_match_jax():
    """Every committed et-dz table, and build_shells('et-dz') on Si and
    bcc-Li's primitive cells, equal the JAX package's."""
    for z in range(1, tetdz.MAX_Z + 1):
        got, want = tetdz.dz_shells_for_atom(z), jetdz.dz_shells_for_atom(z)
        assert len(got) == len(want), z
        for (lg, eg, cg), (lw, ew, cw) in zip(got, want):
            assert lg == lw
            np.testing.assert_array_equal(eg, ew)
            np.testing.assert_array_equal(cg, cw)
        assert tetdz.bath_energy(z) == jetdz.bath_energy(z)
    for name in ("si_etdz", "bcc_li_poscar"):
        tcfg, jcfg = both_configs(name)
        got = tbasis.build_shells(tcfg.system.cell.prim, "et-dz")
        assert_same_shells(got, jbasis.build_shells(jcfg.system.cell.prim, "et-dz"))
        assert {s.l for s in got} == {0, 1, 2}
    with pytest.raises(NotImplementedError):
        tetdz.dz_shells_for_atom(tetdz.MAX_Z + 1)


@pytest.mark.parametrize("syms,coords,charges,nelec,basis", [
    (["H", "H"], [[0, 0, 0], [1.4, 0, 0]], [1, 1], (1, 1), "sto-3g"),
    (["Li"], [[0, 0, 0]], [3], (2, 1), "sto-3g"),
])
def test_molecular_uhf_matches_jax(syms, coords, charges, nelec, basis):
    """The free-space UHF behind the et-dz generator: H2 (Szabo-Ostlund's
    -1.11671 Ha) and the Li atom, energy and orbital energies to 1e-10."""
    class Atoms:
        atom_symbols = syms
        atom_coords = np.asarray(coords, float)

    nuclei = [(float(z), np.asarray(c, float)) for z, c in zip(charges, coords)]
    got = tmolecular.run_uhf_molecular(tbasis.build_shells(Atoms, basis, 0.0),
                                       nuclei, nelec)
    want = jmolecular.run_uhf_molecular(jbasis.build_shells(Atoms, basis, 0.0),
                                        nuclei, nelec)
    assert abs(got[0] - want[0]) < 1e-10
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)
    if len(syms) == 2:
        assert abs(got[0] + 1.11671) < 2e-5


@pytest.mark.slow
def test_atomic_uhf_matches_jax():
    """The et-dz generator's bath UHF of the Li atom from scratch, against
    the JAX package's (both regenerate; minutes of ERI time)."""
    got = tetdz._atomic_uhf(3, tetdz.bath_exponents(3))
    want = jetdz._atomic_uhf(3, jetdz.bath_exponents(3))
    assert abs(got[0] - want[0]) < 1e-10


def _narrow_pair(name, monkeypatch):
    """(port net, JAX net, JAX params as numpy, walkers, supercells) of the
    system at a narrow width on its source's k-list; one walker from a
    numpy seed, spread over the cell."""
    tcfg, jcfg, tsrc, jsrc = _sources(name, monkeypatch)
    for cfg in (tcfg, jcfg):
        cfg.network.detnet.hidden_dims = NARROW["hidden_dims"]
        cfg.network.detnet.determinants = NARROW["determinants"]
    tsc, jsc = tcfg.system.cell, jcfg.system.cell
    tnet = tprocess.build_network(tcfg, tsc, klist_override=tsrc.klist)
    jnet = jbuild_network(jcfg, jsc, klist_override=jsrc.klist)
    params = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(3)))
    n = sum(tsc.nelec)
    x = (np.random.RandomState(6).uniform(size=(1, n, 3)) @ tsc.lattice).reshape(1, -1)
    return tnet, jnet, params, x, tsc, jsc


@pytest.mark.parametrize("name", ["si_sto3g", "bcc_li_poscar"])
def test_system_logpsi_matches_jax(name, monkeypatch):
    tnet, jnet, params, x, _, _ = _narrow_pair(name, monkeypatch)
    got = tnet.logdet(params_from_jax(params, dtype=torch.float64), torch.from_numpy(x))
    want = jax.vmap(jnet.logdet, in_axes=(None, 0))(params, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-8)


@pytest.mark.parametrize("name", [
    "si_sto3g",
    # 162 electrons: JAX traces and compiles the forward Laplacian for ~30 s
    pytest.param("bcc_li_poscar", marks=pytest.mark.slow),
])
def test_system_local_energy_matches_jax(name, monkeypatch):
    """E_L = kinetic + Ewald of one walker per primitive cell, 1e-8 Ha."""
    tnet, jnet, params, x, tsc, jsc = _narrow_pair(name, monkeypatch)
    tp, tx = params_from_jax(params, dtype=torch.float64), torch.from_numpy(x)
    _, ke = make_logpsi_and_kinetic(tnet)(tp, tx)
    _, ew = tmake_le(tnet, tsc)(tp, tx)
    jel = jmake_le(jnet.logdet, jsc, mode="forward", network=jnet)
    jke, jew = jax.vmap(jel, in_axes=(None, 0))(params, jnp.asarray(x))
    scale = tsc.scale
    np.testing.assert_allclose(ke.numpy() / scale, np.asarray(jke) / scale, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose((ke + ew).numpy() / scale, np.asarray(jke + jew) / scale,
                               rtol=0, atol=1e-8)
