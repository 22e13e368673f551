"""Port parity: the network value path and the forward-Laplacian engine.

Small LiH/H2 cells with hidden_dims ((16, 8), (16, 8)) and 2
determinants; the same parameters (JAX init, carried over by
params_from_jax) and walkers go through both packages in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsolid_tpu.models import fwdlap_forward as jff
from deepsolid_tpu.models import network as jnet_lib
from deepsolid_tpu.ops import fwdlap as jfl
from deepsolid_tpu.ops import slogdet as jsd
from deepsolid_tpu_torch.models import fwdlap_forward as tff
from deepsolid_tpu_torch.models import network as tnet_lib
from deepsolid_tpu_torch.ops import fwdlap as tfl
from deepsolid_tpu_torch.ops import slogdet as tsd

from torch_helpers import F64, h2_cells, lih_cells, networks, t64, walkers

TOL = dict(rtol=1e-10, atol=1e-10)  # f64; reordered sums and GJ vs LU


def _c128(shape, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return scale * (rng.randn(*shape) + 1j * rng.randn(*shape))


@pytest.mark.parametrize("distance_type,full_det,envelope",
                         [("nu", False, "isotropic"), ("tri", False, "isotropic"),
                          ("nu", True, "isotropic"), ("nu", False, "diagonal"),
                          ("nu", False, "full")])
def test_orbitals_and_logpsi_match_jax(distance_type, full_det, envelope):
    jnet, tnet, params, tp, jsc = networks(distance_type=distance_type,
                                           full_det=full_det, envelope_type=envelope)
    x = walkers(3, jsc.nelectron)
    jmats = jax.vmap(jnet.orbitals, in_axes=(None, 0))(params, jnp.asarray(x))
    tmats = tnet.orbitals(tp, t64(x))
    for g, w in zip(tmats, jmats):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    jl = jax.vmap(jnet.logdet, in_axes=(None, 0))(params, jnp.asarray(x))
    np.testing.assert_allclose(tnet.logdet(tp, t64(x)).numpy(), np.asarray(jl), **TOL)


def test_init_params_match_the_reference_tree():
    jnet, tnet, params, _, _ = networks(cells=h2_cells())
    mine = tnet.init(np.random.default_rng(0))
    assert tnet_lib.param_shapes(mine) == tnet_lib.param_shapes(params)


def test_same_spin_exchange_flips_the_sign():
    _, tnet, _, tp, jsc = networks()
    x = walkers(2, jsc.nelectron, seed=3)
    pos = x.reshape(2, -1, 3)
    swapped = pos.copy()
    swapped[:, [0, 1]] = pos[:, [1, 0]]  # two spin-up electrons
    p1, s1 = tnet.phase_and_slogdet(tp, t64(x))
    p2, s2 = tnet.phase_and_slogdet(tp, t64(swapped.reshape(2, -1)))
    torch.testing.assert_close(s1, s2, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(p1, -p2, rtol=1e-12, atol=1e-12)


def test_logdet_matmul_matches_jax():
    xs = [_c128((2, 4, 5, 5), seed=s) for s in (1, 2)]
    for b in range(2):
        jp, jl = jsd.logdet_matmul([jnp.asarray(m[b]) for m in xs])
        tp, tl = tsd.logdet_matmul([torch.from_numpy(m) for m in xs])
        np.testing.assert_allclose(tp[b].numpy(), np.asarray(jp), **TOL)
        np.testing.assert_allclose(tl[b].numpy(), np.asarray(jl), **TOL)
    one = _c128((3, 2, 1, 1), seed=3)
    for b in range(3):
        want = jsd.slogdet_op(jnp.asarray(one[b]))
        for g, w in zip(tsd.slogdet_op(torch.from_numpy(one))[:], want):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), **TOL)


# ---- jet algebra --------------------------------------------------------------


def _jet(shape, t_dim, seed, cplx=False):
    make = (lambda s, k: _c128(s, seed + k)) if cplx else (
        lambda s, k: np.random.RandomState(seed + k).randn(*s))
    return make(shape, 0), make((t_dim,) + shape, 1), make(shape, 2)


def _tj(parts):
    return tfl.Jet(*(torch.from_numpy(np.asarray(p)) for p in parts))


def _jj(parts):
    return jfl.Jet(*(jnp.asarray(p) for p in parts))


def _assert_jet(got, want, tol=TOL):
    for name in ("val", "jac", "lap"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), err_msg=name, **tol)


def test_dense_tanh_and_mix_rules():
    t_dim, b, n, f_rv, f_rc, d_out = 7, 2, 5, 6, 4, 9
    rng = np.random.RandomState(0)
    w_rv, w_rc, bias = rng.randn(f_rv, d_out), rng.randn(f_rc, d_out), rng.randn(d_out)
    rv, rc = _jet((b, n, f_rv), t_dim, 10), _jet((b, 1, f_rc), t_dim, 20)
    got = tfl.dense_tanh_mix(_tj(rv), _tj(rc), *map(t64, (w_rv, w_rc, bias)))
    for i in range(b):
        one = [p[i] if k != 1 else p[:, i] for k, p in enumerate(rv)]
        onec = [p[i] if k != 1 else p[:, i] for k, p in enumerate(rc)]
        want = jfl.dense_tanh_mix(_jj(one), _jj(onec), w_rv, w_rc, bias)
        _assert_jet(tfl.Jet(got.val[i], got.jac[:, i], got.lap[i]), want)
    pair = _jet((b, n, n, f_rv), 6, 30)
    want = jfl.dense_tanh(_jj(pair), w_rv, bias)
    _assert_jet(tfl.dense_tanh(_tj(pair), t64(w_rv), t64(bias)), want)
    no_bias = jfl.tanh(jfl.dense(_jj(pair), w_rv))
    _assert_jet(tfl.dense_tanh(_tj(pair), t64(w_rv), None), no_bias)
    _assert_jet(tfl.tanh(tfl.dense(_tj(pair), t64(w_rv))), no_bias)


def test_sparse_to_dense_conversions():
    b, n, f = 2, 5, 3
    jac3 = np.random.RandomState(1).randn(3, b, n, f)
    jac6 = np.random.RandomState(2).randn(6, b, n, n, f)
    got3 = tfl.dense_from_electron_rows(torch.from_numpy(jac3)).numpy()
    got6 = tfl.dense_row_mean_from_pairs(torch.from_numpy(jac6), 1, 4).numpy()
    for i in range(b):
        np.testing.assert_array_equal(
            got3[:, i], np.asarray(jfl.dense_from_electron_rows(jnp.asarray(jac3[:, i]))))
        np.testing.assert_allclose(
            got6[:, i],
            np.asarray(jfl.dense_row_mean_from_pairs(jnp.asarray(jac6[:, i]), 1, 4)),
            **TOL)


def test_mul_row_matches_dense_product():
    b, d, rows, f, n_total, offset = 2, 3, 4, 5, 6, 2
    t_dim = 3 * n_total
    a = _jet((b, d, rows, f), t_dim, 40, cplx=True)
    bv, bj, bl = _c128((b, d, rows, f), 50), _c128((3, b, d, rows, f), 51), \
        _c128((b, d, rows, f), 52)
    got = tfl.mul_row(_tj(a), *map(torch.from_numpy, (bv, bj, bl)), n_total, offset)
    for i in range(b):
        ai = [p[i] if k != 1 else p[:, i] for k, p in enumerate(a)]
        want = jfl.mul_row(_jj(ai), bv[i], bj[:, i], bl[i], n_total, offset)
        _assert_jet(tfl.Jet(got.val[i], got.jac[:, i], got.lap[i]), want)


def test_slogdet_jet_and_logsumexp_match_jax():
    b, ndet, n, t_dim = 2, 3, 16, 192  # the scan takes 3 chunks of 64 tangents
    val = _c128((b, ndet, n, n), 60) + 3.0 * np.eye(n)
    _, jac, lap = _jet((b, ndet, n, n), t_dim, 61, cplx=True)
    assert tfl._pick_det_scan_chunk(t_dim, n) == jfl._pick_det_scan_chunk(t_dim, n) < t_dim
    sign, got = tfl.slogdet_jet(_tj((val, 0.1 * jac, 0.1 * lap)))
    total = tfl.logsumexp_det_jet(sign, got)
    for i in range(b):
        jsign, want = jfl.slogdet_jet(_jj((val[i], 0.1 * jac[:, i], 0.1 * lap[i])))
        np.testing.assert_allclose(sign[i].numpy(), np.asarray(jsign), **TOL)
        _assert_jet(tfl.Jet(got.val[i], got.jac[:, i], got.lap[i]), want)
        jtotal = jfl.logsumexp_det_jet(jsign, want)
        _assert_jet(tfl.Jet(total.val[i], total.jac[:, i], total.lap[i]), jtotal)


def test_det_trace_chunk_matches_jax():
    lead, n, tc = (2, 3), 4, 5
    a_inv, j2c = _c128(lead + (n, n), 70), _c128(lead + (n, tc * n), 71)
    trb, l2 = tfl.det_trace_chunk(*map(torch.from_numpy, (a_inv, j2c)), tc, n, lead)
    jtrb, jl2 = jfl.det_trace_chunk(jnp.asarray(a_inv), jnp.asarray(j2c), tc, n, lead)
    np.testing.assert_allclose(trb.numpy(), np.asarray(jtrb), **TOL)
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl2), **TOL)


# ---- the engine --------------------------------------------------------------------


@pytest.mark.parametrize("cells,kw", [
    (lih_cells, dict()),
    (lih_cells, dict(distance_type="tri")),
    (h2_cells, dict()),
    (lih_cells, dict(full_det=True, use_last_layer=True)),
    (lih_cells, dict(envelope_type="diagonal")),  # jets by forward-mode AD
])
def test_network_jets_and_kinetic_match_jax(cells, kw):
    jnet, tnet, params, tp, jsc = networks(cells=cells(), **kw)
    x = walkers(3, jsc.nelectron, seed=5)
    jx = jnp.asarray(x)
    jets = jax.vmap(lambda xi: jff.network_jets(params, xi, jnet.spec, jnet.cfg))(jx)
    got = tff.network_jets(tp, t64(x), tnet.spec, tnet.cfg)
    np.testing.assert_allclose(got.val.numpy(), np.asarray(jets.val), **TOL)
    np.testing.assert_allclose(got.jac.numpy(), np.asarray(jets.jac).T, **TOL)
    np.testing.assert_allclose(got.lap.numpy(), np.asarray(jets.lap), rtol=1e-9,
                               atol=1e-9)
    want = jax.vmap(jff.make_kinetic_forward(jnet), in_axes=(None, 0))(params, jx)
    ke = tff.make_kinetic_forward(tnet)(tp, t64(x))
    np.testing.assert_allclose(ke.numpy(), np.asarray(want), rtol=1e-9, atol=1e-9)
    logpsi, ke2 = tff.make_logpsi_and_kinetic(tnet)(tp, t64(x))
    torch.testing.assert_close(ke2, ke, rtol=0, atol=0)
    np.testing.assert_allclose(logpsi.numpy(),
                               np.asarray(jax.vmap(jnet.logdet, in_axes=(None, 0))(params, jx)),
                               **TOL)


def test_params_from_jax_keeps_the_tree():
    _, _, params, _, _ = networks()
    tp = tnet_lib.params_from_jax(params, dtype=torch.float32)
    assert set(tp) == set(params)
    assert len(tp["single"]) == len(params["single"])
    assert tp["single"][0]["w"].dtype == torch.float32
    np.testing.assert_allclose(tp["orbital"][0]["w"].numpy(),
                               params["orbital"][0]["w"], rtol=1e-7)
    assert isinstance(jnet_lib.NetworkConfig(), jnet_lib.NetworkConfig)
    assert tnet_lib.NetworkConfig() == tnet_lib.NetworkConfig(
        **{f: getattr(jnet_lib.NetworkConfig(), f)
           for f in jnet_lib.NetworkConfig.__dataclass_fields__})
    assert F64 == torch.float64
