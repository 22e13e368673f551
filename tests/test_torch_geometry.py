"""Port parity: host geometry, config, distances/PBC, features and envelopes.

Every check feeds the same numpy inputs to the JAX reference and to
deepsolid_tpu_torch, in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsolid_tpu import config as jconfig
from deepsolid_tpu.configs import diamond as jdiamond
from deepsolid_tpu.models import envelopes as jenv
from deepsolid_tpu.models import features as jfeat
from deepsolid_tpu.ops import distance as jdist
from deepsolid_tpu.ops import fwdlap as jfl
from deepsolid_tpu.scf.free_electron import free_electron_klist as jklist
from deepsolid_tpu_torch import config as tconfig
from deepsolid_tpu_torch.configs import diamond as tdiamond
from deepsolid_tpu_torch.models import envelopes as tenv
from deepsolid_tpu_torch.models import features as tfeat
from deepsolid_tpu_torch.ops import distance as tdist
from deepsolid_tpu_torch.ops import fwdlap as tfl
from deepsolid_tpu_torch.scf.free_electron import free_electron_klist as tklist

from torch_helpers import lih_cells, t64

# f64 on both sides; differences are rounding in reordered sums
TOL = dict(rtol=1e-12, atol=1e-12)


def test_diamond_supercell_and_klist_match():
    jsc = jdiamond.get_config("C,C,3.567,2,sto-3g").system.cell
    tsc = tdiamond.get_config("C,C,3.567,2,sto-3g").system.cell
    assert tsc.nelec == jsc.nelec == (48, 48) and tsc.scale == jsc.scale == 8
    for attr in ("lattice", "atom_coords", "atom_charges", "kpts", "AV", "BV"):
        np.testing.assert_array_equal(getattr(tsc, attr), getattr(jsc, attr))
    np.testing.assert_array_equal(tsc.prim.AV, jsc.prim.AV)
    for kt, kj in zip(tklist(tsc), jklist(jsc)):
        np.testing.assert_array_equal(kt, kj)


def test_config_keys_follow_the_reference():
    t, j = tconfig.default(), jconfig.default()

    def keys(d, prefix=""):
        out = set()
        for k, v in d.items():
            out.add(prefix + k)
            if isinstance(v, dict):
                out |= keys(v, prefix + k + ".")
        return out

    tk = keys(t)
    assert tk <= keys(j.to_dict()), tk - keys(j.to_dict())
    assert t.network.detnet.hidden_dims == j.network.detnet.hidden_dims
    t.optim.el_chunk = 64
    assert t["optim"]["el_chunk"] == 64
    with pytest.raises(AttributeError):
        t.optim.no_such_key = 1


@pytest.mark.parametrize("skewed", [True, False])
def test_minimal_image_and_enforce_pbc(skewed):
    lattice = (1 - np.eye(3)) * 3.0 if skewed else np.diag([3.0, 4.0, 5.0])
    rng = np.random.RandomState(0)
    x = rng.randn(4, 5, 3) * 6.0
    targets = rng.randn(3, 3)
    jmi, tmi = jdist.MinimalImage(lattice), tdist.MinimalImage(lattice)
    assert tmi.general == jmi.general == skewed
    np.testing.assert_allclose(
        tmi.dist_i(t64(targets), t64(x[0])).numpy(),
        np.asarray(jmi.dist_i(jnp.asarray(targets.ravel()), jnp.asarray(x[0].ravel()))),
        **TOL)
    np.testing.assert_allclose(
        tmi.dist_matrix(t64(x[0])).numpy(),
        np.asarray(jmi.dist_matrix(jnp.asarray(x[0].ravel()))), **TOL)
    xt, wt = tdist.enforce_pbc(lattice, t64(x.reshape(4, -1)))
    xj, wj = jdist.enforce_pbc(lattice, jnp.asarray(x.reshape(4, -1)))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


@pytest.mark.parametrize("kind", ["nu", "tri"])
def test_distances_and_analytic_jets(kind):
    jsc, _ = lih_cells()
    av, bv = jsc.AV, jsc.BV
    dx = np.random.RandomState(1).randn(5, 7, 3) * 3.0
    for got, want in zip(tfeat.DISTANCE_FNS[kind](t64(dx), av, bv),
                         jfeat._DISTANCE_FNS[kind](jnp.asarray(dx), av, bv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for got, want in zip(tfeat.DISTANCE_JET_FNS[kind](t64(dx), av, bv),
                         jfeat.DISTANCE_JET_FNS[kind](jnp.asarray(dx), av, bv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-11,
                                   atol=1e-11)


@pytest.mark.parametrize("kind", ["nu", "tri"])
def test_periodic_input_features(kind):
    jsc, _ = lih_cells(np.array([[1, 1, 0], [0, 1, 1], [1, 0, 1]]))  # 2 cells
    prim = jsc.prim
    x = np.random.RandomState(2).randn(3, 3 * jsc.nelectron) * 3.0
    kw = dict(prim_lattice=prim.lattice, prim_av=prim.AV, prim_bv=prim.BV,
              sim_lattice=jsc.lattice, sim_av=jsc.AV, sim_bv=jsc.BV,
              distance_type=kind)
    got = tfeat.periodic_input_features(t64(x), prim.atom_coords, **kw)
    for b in range(3):
        want = jfeat.periodic_input_features(jnp.asarray(x[b]), prim.atom_coords, **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("kind", ["isotropic", "diagonal", "full"])
def test_envelopes(kind):
    rng = np.random.RandomState(3)
    natom, nparam = 2, 5
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1.0 + 0.3 * rng.rand(*np.shape(a))),
        jenv.init_envelope_params(natom, nparam, kind, jnp.float64))
    feat = rng.rand(4, natom, 1 if kind == "isotropic" else 3)
    want = jenv.ENVELOPES[kind](jnp.asarray(feat), params)
    got = tenv.ENVELOPES[kind](t64(feat), {k: t64(v) for k, v in params.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    init = tenv.init_envelope_params(natom, nparam, kind)
    ref = jenv.init_envelope_params(natom, nparam, kind, jnp.float64)
    for k in ref:
        np.testing.assert_array_equal(init[k], np.asarray(ref[k]))


def test_jet_of_function_matches_jax():
    """Row-local jets by forward-mode AD, held against JAX's vmapped jvps."""
    jsc, _ = lih_cells()
    prim = jsc.prim
    sigma = np.abs(np.random.RandomState(4).randn(2, 6)) + 0.5
    pi = np.random.RandomState(5).randn(2, 6)

    def env_j(r):
        pr, _ = jdist.enforce_pbc(prim.lattice, r)
        sd, _ = jfeat.nu_distance(pr - prim.atom_coords, prim.AV, prim.BV)
        return jenv.isotropic_envelope(sd[None, :, None],
                                       {"sigma": sigma, "pi": pi})[0]

    def env_t(r):
        pr, _ = tdist.enforce_pbc(prim.lattice, r)
        sd, _ = tfeat.nu_distance(pr[..., None, :] - t64(prim.atom_coords),
                                  prim.AV, prim.BV)
        return tenv.isotropic_envelope(sd[..., None],
                                       {"sigma": t64(sigma), "pi": t64(pi)})

    r = np.random.RandomState(6).randn(2, 4, 3) * 3.0
    got = tfl.jet_of_function(env_t, t64(r))
    for b in range(2):
        want = jax.vmap(lambda ri: jfl.jet_of_function(env_j, ri))(jnp.asarray(r[b]))
        np.testing.assert_allclose(got.val[b].numpy(), np.asarray(want.val), **TOL)
        np.testing.assert_allclose(got.jac[:, b].numpy(),
                                   np.moveaxis(np.asarray(want.jac), 1, 0), **TOL)
        np.testing.assert_allclose(got.lap[b].numpy(), np.asarray(want.lap),
                                   rtol=1e-10, atol=1e-10)
