"""The port's reference Laplacian engines (ops/laplacian.py) and the
Gauss-Jordan slogdet's rule to any order (ops/slogdet.py), on the CPU in
float64.

B1's rule runs its plain body here: gradcheck / gradgradcheck, forward
mode and vmap against a loop, and second derivatives against
torch.linalg.slogdet's (the library is the test's yardstick only). Each
engine is held against deepsolid_tpu.ops.laplacian.make_kinetic in the
same mode and against the port's forward Laplacian, on the analytic oracle
of tests/test_laplacian.py, and inside the local energy and process().
Tolerances are stated at each comparison.
"""

import numpy as np
import pytest
import torch
from torch.func import grad, hessian, jvp, vmap

from deepsolid_tpu_torch.hamiltonian import make_local_energy
from deepsolid_tpu_torch.models.fwdlap_forward import make_kinetic_forward
from deepsolid_tpu_torch.ops import laplacian as tlap
from deepsolid_tpu_torch.ops.slogdet import GaussJordanAll, slogdet_op
from deepsolid_tpu_torch.train import process as tprocess
from test_torch_training import seed_state, torch_cfg, write_start
from torch_helpers import h2_cells, lih_cells, networks, t64, walkers

MODES = ["for", "vmap", "partition", "hessian"]
SMALL = dict(hidden_dims=((8, 4), (8, 4)), determinants=2)


def _complex(shape, seed):
    rng = np.random.RandomState(seed)
    return torch.tensor(rng.randn(*shape) + 1j * rng.randn(*shape))


# ---- B1's rule ---------------------------------------------------------------------------


def test_gauss_jordan_rule_passes_gradcheck_and_gradgradcheck():
    """All three outputs (A^-1, sign, log|det|), first and second order,
    against finite differences of the plain body."""
    a = _complex((2, 4, 4), 0).requires_grad_()
    assert torch.autograd.gradcheck(GaussJordanAll.apply, (a,))
    assert torch.autograd.gradgradcheck(GaussJordanAll.apply, (a,))


def test_gauss_jordan_jvp_matches_torch_linalg():
    """dA^-1 = -A^-1 dA A^-1, d log|det| = Re tr(A^-1 dA), d sign = i sign
    Im tr(A^-1 dA). 1e-12."""
    a, da = _complex((3, 5, 5), 1), _complex((3, 5, 5), 2)
    _, (d_inv, d_sign, d_log) = jvp(GaussJordanAll.apply, (a,), (da,))
    _, want_inv = jvp(torch.linalg.inv, (a,), (da,))
    _, (want_sign, want_log) = jvp(torch.linalg.slogdet, (a,), (da,))
    for got, want in ((d_inv, want_inv), (d_sign, want_sign), (d_log, want_log)):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("in_dim", [0, 1])
def test_gauss_jordan_vmap_matches_a_loop(in_dim):
    """The vmap rule folds the mapped axis into the batch: equal to one
    call per slice (the same elimination, vectorized over more matrices:
    1e-14)."""
    a = _complex((3, 2, 4, 4), 3)
    got = vmap(GaussJordanAll.apply, in_dims=in_dim)(a)
    for i in range(a.shape[in_dim]):
        for g, w in zip(got, GaussJordanAll.apply(a.select(in_dim, i))):
            torch.testing.assert_close(g[i], w, rtol=1e-14, atol=1e-14)


def test_hessian_of_log_det_matches_torch_linalg():
    """torch.func.hessian (forward over reverse) of sum log|det| and of
    Re sign in the matrices' real and imaginary parts. 1e-10."""
    re, im = _complex((2, 3, 3), 4).real, _complex((2, 3, 3), 5).real

    def loss(fn):
        def f(r, i):
            sign, logabs = fn(torch.complex(r, i))
            return logabs.sum() + sign.real.sum()
        return f

    got = hessian(loss(slogdet_op), argnums=(0, 1))(re, im)
    want = hessian(loss(torch.linalg.slogdet), argnums=(0, 1))(re, im)
    for g_row, w_row in zip(got, want):
        for g, w in zip(g_row, w_row):
            torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


def test_jvp_of_grad_through_the_rule_matches_torch_linalg():
    x = _complex((2, 4, 4), 6)
    e = _complex((2, 4, 4), 7).real

    def logabs(fn):
        return lambda r: fn(torch.complex(r, x.imag))[1].sum()

    got = jvp(grad(logabs(slogdet_op)), (x.real,), (e,))[1]
    want = jvp(grad(logabs(torch.linalg.slogdet)), (x.real,), (e,))[1]
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


# ---- the engines ----------------------------------------------------------------------------


def analytic_case():
    """f(x) = x A x + i x B x + c sum(sin x) per walker: known gradient
    and Laplacian (tests/test_laplacian.py's oracle)."""
    n = 6
    rng = np.random.RandomState(0)
    a = rng.randn(n, n)
    a = (a + a.T) / 2
    b = rng.randn(n, n)
    b = (b + b.T) / 2
    c = 0.7

    def f(params, x):
        del params
        quad = lambda m: torch.einsum("bi,ij,bj->b", x, torch.tensor(m), x)
        return torch.complex(quad(a) + c * torch.sin(x).sum(-1), quad(b))

    def exact(x):
        gu = 2 * a @ x + c * np.cos(x)
        gv = 2 * b @ x
        re = 2 * np.trace(a) - c * np.sum(np.sin(x)) + gu @ gu - gv @ gv
        im = 2 * np.trace(b) + 2 * gu @ gv
        return -0.5 * (re + 1j * im)

    return f, exact, n


@pytest.mark.parametrize("mode", MODES)
def test_analytic_laplacian(mode):
    f, exact, n = analytic_case()
    x = np.random.RandomState(1).randn(3, n)
    got = tlap.make_kinetic(f, mode=mode, partition_number=3)(None, torch.tensor(x))
    want = np.array([exact(xi) for xi in x])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


@pytest.fixture(scope="module")
def h2_case():
    jnet, tnet, params, tparams, jsc = networks(h2_cells(), **SMALL)
    x = walkers(3, jsc.nelectron, seed=8)
    with torch.no_grad():
        forward = make_kinetic_forward(tnet)(tparams, t64(x))
    return jnet, tnet, params, tparams, x, forward


@pytest.mark.parametrize("mode", MODES)
def test_engine_matches_jax_and_the_forward_laplacian(h2_case, mode):
    """H2 (3N = 6, partition_number 3): the JAX package's engine in the
    same mode, vmapped over the walkers, to 1e-9, and the port's forward
    Laplacian to 1e-9."""
    import jax
    import jax.numpy as jnp

    from deepsolid_tpu.ops.laplacian import make_kinetic as jmake_kinetic

    jnet, tnet, params, tparams, x, forward = h2_case
    got = tlap.make_kinetic(tnet.logdet, mode=mode)(tparams, t64(x))
    want = jax.jit(jax.vmap(jmake_kinetic(jnet.logdet, mode), in_axes=(None, 0)))(
        params, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    np.testing.assert_allclose(got.numpy(), forward.numpy(), rtol=1e-9)


@pytest.mark.parametrize("mode", MODES + ["forward"])
def test_local_energy_of_each_mode(mode):
    """make_local_energy(..., mode=m) on LiH (3N = 12): every engine's E_L
    equals the forward engine's (1e-9) and the Ewald part is the same."""
    _, tnet, _, tparams, jsc = networks(**SMALL)
    _, tsc = lih_cells()
    x = t64(walkers(2, jsc.nelectron, seed=9))
    ke, ew = make_local_energy(tnet, tsc, mode=mode, partition_number=4)(tparams, x)
    with torch.no_grad():
        want_ke, want_ew = make_local_energy(tnet, tsc, mode="forward")(tparams, x)
    np.testing.assert_allclose(ke.numpy(), want_ke.numpy(), rtol=1e-9)
    np.testing.assert_allclose(ew.numpy(), want_ew.numpy(), rtol=0, atol=0)
    assert not ke.requires_grad


def test_engine_errors():
    f, _, n = analytic_case()
    with pytest.raises(ValueError, match="partition_number=4 must divide 3N=6"):
        tlap.make_kinetic(f, mode="partition", partition_number=4)(None, torch.zeros(1, n))
    with pytest.raises(ValueError, match="mode='forward' needs the Network"):
        tlap.make_kinetic(f, mode="forward")
    with pytest.raises(ValueError, match="Unknown laplacian mode"):
        tlap.make_kinetic(f, mode="jacobi")


def test_process_with_the_partition_engine_equals_forward(tmp_path):
    """One inference iteration of process() in each engine from one start
    (walkers fixed): the same energy to rtol 1e-10; 'partition' is the
    config's default engine."""
    _, _, params, x = seed_state(n_walkers=4, seed=5)
    energies = {}
    for mode in ("partition", "forward"):
        write_start(tmp_path / mode, params, x)
        cfg = torch_cfg(tmp_path / mode, optimizer="none", iterations=1, batch=4,
                        el_chunk=2)
        cfg.optim.laplacian_mode = mode
        _, _, energies[mode] = tprocess.process(cfg, device="cpu")
    np.testing.assert_allclose(energies["partition"], energies["forward"], rtol=1e-10)
