"""Port parity: Metropolis, atom-centred, one-electron and Langevin moves,
width adaptation, walker init, checkpoints."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsolid_tpu.ops.distance import enforce_pbc as jenforce_pbc
from deepsolid_tpu.sampling import mcmc as jmcmc
from deepsolid_tpu.utils import checkpoint as jckpt
from deepsolid_tpu_torch.sampling import mcmc as tmcmc
from deepsolid_tpu_torch.sampling.init import init_electrons
from deepsolid_tpu_torch.train import loss as tloss
from deepsolid_tpu_torch.utils import checkpoint as tckpt
from deepsolid_tpu_torch.utils.writers import Writer

from torch_helpers import lih_cells, networks, t64, walkers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIAMOND_CKPT = os.path.join(REPO, "runs", "ckpt_diamond")


def test_mh_update_with_the_reference_draws():
    """One all-electron move: JAX's own normals and uniforms, recomputed
    from the same key exactly as mh_update splits it, handed to the port."""
    jnet, tnet, params, tp, jsc = networks()
    lattice = jsc.lattice
    x1 = walkers(12, jsc.nelectron, seed=12)
    jf = jax.vmap(jnet.slogdet, in_axes=(None, 0))
    lp1 = 2.0 * jf(params, jnp.asarray(x1))
    key = jax.random.PRNGKey(3)
    width = 1.5
    jx, _, jlp, jacc = jmcmc.mh_update(params, jf, jnp.asarray(x1), key, lp1,
                                       jnp.zeros(()), jnp.asarray(lattice), width)
    k, sub = jax.random.split(key)
    noise = jax.random.normal(sub, x1.shape, dtype=jnp.float64)
    _, sub = jax.random.split(k)
    uniform = jax.random.uniform(sub, (12,), dtype=jnp.float64)
    tx, tlp, tacc = tmcmc.mh_update(
        lambda x: tnet.slogdet(tp, x), t64(x1), t64(lp1), torch.zeros((), dtype=torch.int64),
        lattice, width, t64(noise), t64(uniform))
    assert 0 < int(tacc) < 12 and int(tacc) == int(jacc)  # some moves rejected
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-10, atol=1e-10)


def jax_draws(key, normal_shape, n):
    """The normals and uniforms a JAX move draws from `key`, as each
    update splits it: (normals of `normal_shape`, uniforms (n,))."""
    k, sub = jax.random.split(key)
    noise = jax.random.normal(sub, normal_shape, dtype=jnp.float64)
    _, sub = jax.random.split(k)
    return t64(noise), t64(jax.random.uniform(sub, (n,), dtype=jnp.float64))


def move_setup(n=12):
    """(JAX network, port network, params, port params, lattice, wrapped
    walkers, JAX batch log|psi|, lp of the walkers) of the LiH test net."""
    jnet, tnet, params, tp, jsc = networks()
    x1 = np.asarray(jenforce_pbc(jnp.asarray(jsc.lattice),
                                 jnp.asarray(walkers(n, jsc.nelectron, seed=12)))[0])
    jf = jax.vmap(jnet.slogdet, in_axes=(None, 0))
    return jnet, tnet, params, tp, jsc.lattice, x1, jf, jf(params, jnp.asarray(x1)) * 2.0


def test_limit_drift_matches_jax():
    g = np.random.RandomState(5).randn(7, 12) * 1.5  # norms on both sides of 1
    got = tmcmc.limit_drift(t64(g)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmcmc.limit_drift(jnp.asarray(g))),
                               rtol=1e-14, atol=1e-14)
    norms = np.linalg.norm(got.reshape(-1, 3), axis=-1)
    assert norms.max() <= 1 + 1e-14 and (np.linalg.norm(g.reshape(-1, 3), axis=-1) < 1).any()


def test_atom_centred_move_with_the_reference_draws():
    """The harmonic-mean widths and both proposal densities on the
    pre-wrap displacement, with JAX's draws."""
    _, tnet, params, tp, lattice, x1, jf, lp1 = move_setup()
    L = 2 / 0.529177
    atoms = np.array([[0.0, 0.0, 0.0], [L / 2] * 3])
    key, width = jax.random.PRNGKey(4), 0.2
    jx, _, jlp, jacc = jmcmc.mh_update(params, jf, jnp.asarray(x1), key, lp1, jnp.zeros(()),
                                       jnp.asarray(lattice), width, atoms=jnp.asarray(atoms))
    noise, uniform = jax_draws(key, (12, x1.shape[1] // 3, 1, 3), 12)
    tx, tlp, tacc = tmcmc.mh_update(
        lambda x: tnet.slogdet(tp, x), t64(x1), t64(lp1), torch.zeros((), dtype=torch.int64),
        lattice, width, noise.reshape(12, -1), uniform, atoms=atoms)
    assert 0 < int(tacc) < 12 and int(tacc) == int(jacc)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("i", [1, 4 + 2])  # LiH has 4 electrons: 6 moves electron 2
def test_one_electron_move_with_the_reference_draws(i):
    _, tnet, params, tp, lattice, x1, jf, lp1 = move_setup()
    key, width = jax.random.PRNGKey(7), 1.0
    jx, _, jlp, jacc = jmcmc.mh_one_electron_update(
        params, jf, jnp.asarray(x1), key, lp1, jnp.zeros(()), jnp.asarray(lattice), width, i=i)
    noise, uniform = jax_draws(key, (12, 1, 3), 12)
    tx, tlp, tacc = tmcmc.mh_one_electron_update(
        lambda x: tnet.slogdet(tp, x), t64(x1), t64(lp1), torch.zeros((), dtype=torch.int64),
        lattice, width, noise, uniform, i=i)
    assert 0 < int(tacc) < 12 and int(tacc) == int(jacc)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-10, atol=1e-10)
    moved = np.abs(tx.numpy() - x1).reshape(12, -1, 3).max(axis=(0, 2)) > 1e-9
    assert moved.tolist() == [e == i % 4 for e in range(4)]


def test_importance_move_with_the_reference_draws():
    """Positions and accept counts equal JAX's; the carried log-probability
    is JAX's minus the proposal term on accepted walkers (ROADMAP C3)."""
    jnet, tnet, params, tp, lattice, x1, _, lp1 = move_setup()
    key, width = jax.random.PRNGKey(4), 0.5
    fvg = jax.vmap(jax.value_and_grad(jnet.slogdet, argnums=1), in_axes=(None, 0))
    jx, _, jlp, jacc = jmcmc.importance_update(params, fvg, jnp.asarray(x1), key, lp1,
                                               jnp.zeros(()), jnp.asarray(lattice), width)
    noise, uniform = jax_draws(key, x1.shape, 12)
    val_grad = tloss.walker_value_and_grad(tnet.slogdet)
    tx, tlp, tacc = tmcmc.importance_update(
        lambda x: val_grad(tp, x), t64(x1), t64(lp1), torch.zeros((), dtype=torch.int64),
        lattice, width, noise, uniform)
    assert 0 < int(tacc) < 12 and int(tacc) == int(jacc)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-12, atol=1e-12)
    # JAX's proposal term, recomputed from its own drift at x1 and x2
    _, g1 = fvg(params, jnp.asarray(x1))
    _, g2 = fvg(params, jnp.asarray(jx))
    gauss = width * noise.numpy()
    drift = np.asarray(jmcmc.limit_drift(g1) + jmcmc.limit_drift(g2))
    term = (np.sum(gauss**2, -1) - np.sum((gauss + width**2 * drift) ** 2, -1)) / (2 * width**2)
    accepted = np.any(np.asarray(jx) != x1, axis=-1)
    want = np.asarray(jlp) - np.where(accepted, term, 0.0)
    np.testing.assert_allclose(tlp.numpy(), want, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tlp.numpy(), 2 * tnet.slogdet(tp, tx).numpy(), rtol=1e-10)
    assert np.abs(term[accepted]).max() > 1e-3  # the two chains do carry different values


def test_importance_mcmc_step_matches_jax_at_one_step(monkeypatch):
    """make_mcmc_step with importance sampling at steps=1 against JAX's
    mcmc_step: both start from a fresh 2 log|psi|, so data and pmove
    agree exactly there."""
    jnet, tnet, params, tp, lattice, x1, jf, _ = move_setup()
    key, width = jax.random.PRNGKey(9), 0.5
    jstep = jmcmc.make_mcmc_step(jf, lattice, steps=1, importance_network=jnet.slogdet)
    jx, jpmove = jstep(params, jnp.asarray(x1), key, jnp.asarray(width))
    draws = jax_draws(key, x1.shape, 12)
    monkeypatch.setattr(tmcmc, "draw_move", lambda gen, x: draws)
    tstep = tmcmc.make_mcmc_step(tnet.slogdet, lattice, steps=1,
                                 importance_network=tnet.slogdet)
    tx, tpmove = tstep(tp, t64(x1), None, width)
    assert 0 < float(tpmove) < 1
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-12, atol=1e-12)
    assert float(tpmove) == float(jpmove)


def test_chunked_importance_equals_unchunked():
    """psi_chunk is a memory transform: the same draws give the same chain."""
    _, tnet, _, tp, lattice, x1, _, _ = move_setup()

    def run(psi_chunk):
        step = tmcmc.make_mcmc_step(tloss.chunk_batch_fn(tnet.slogdet, psi_chunk), lattice,
                                    steps=3, importance_network=tnet.slogdet,
                                    psi_chunk=psi_chunk)
        return step(tp, t64(x1), torch.Generator().manual_seed(11), 0.3)

    (d0, p0), (d4, p4) = run(0), run(4)
    assert 0 < float(p0) < 1
    np.testing.assert_allclose(d4.numpy(), d0.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(p4), float(p0), rtol=1e-12)


@pytest.mark.parametrize("kwargs,error", [
    (dict(importance_network=lambda p, x: x.sum(-1), one_electron_moves=True), ValueError),
    (dict(one_electron_moves=True, atoms=np.zeros((1, 3))), NotImplementedError),
])
def test_invalid_sampler_combinations_raise(kwargs, error):
    with pytest.raises(error):
        step = tmcmc.make_mcmc_step(lambda p, x: x.sum(-1), np.eye(3), steps=1, **kwargs)
        step(None, torch.zeros((2, 6), dtype=torch.float64), torch.Generator(), 0.1)


def test_mcmc_step_samples_a_gaussian():
    """Moments of a known |psi|^2 (the JAX suite's Gaussian target)."""
    L, sigma, center = 20.0, 0.6, 10.0

    def slog(params, x):
        return -torch.sum((x - center) ** 2, dim=-1) / (4 * sigma**2)

    step = tmcmc.make_mcmc_step(slog, np.eye(3) * L, steps=10)
    gen = torch.Generator().manual_seed(0)
    data = center + 0.5 * torch.randn((256, 6), generator=gen, dtype=torch.float64)
    for _ in range(60):
        data, pmove = step(None, data, gen, 0.4)
    assert 0.05 < float(pmove) <= 1.0
    samples = data.numpy() - center
    np.testing.assert_allclose(samples.mean(), 0.0, atol=0.1)
    np.testing.assert_allclose(samples.std(), sigma, rtol=0.12)


def test_update_mcmc_width_matches_jax():
    width_t, width_j = 0.02, jnp.asarray(0.02)
    pm_t, pm_j = np.zeros(5), jnp.zeros(5)
    rng = np.random.RandomState(13)
    for t in range(23):
        pmove = float(rng.choice([0.3, 0.52, 0.7]))
        width_t, pm_t = tmcmc.update_mcmc_width(t, width_t, pm_t, pmove, 5)
        width_j, pm_j = jmcmc.update_mcmc_width(t, width_j, pm_j, pmove, 5)
        np.testing.assert_allclose(width_t, float(width_j), rtol=1e-14)
        np.testing.assert_allclose(pm_t, np.asarray(pm_j), rtol=1e-14)


def test_init_electrons_wrapped_around_the_atoms():
    _, tsc = lih_cells()
    gen = torch.Generator().manual_seed(1)
    x = init_electrons(gen, tsc, tsc.nelec, 16, dtype=torch.float64)
    assert x.shape == (16, 3 * tsc.nelectron)
    frac = x.reshape(16, -1, 3).numpy() @ np.linalg.inv(tsc.lattice)
    assert np.all(frac >= 0) and np.all(frac < 1)


def test_restore_matches_jax_and_resizes():
    path = tckpt.find_last_checkpoint(DIAMOND_CKPT)
    assert path == jckpt.find_last_checkpoint(DIAMOND_CKPT)
    assert path.endswith("qmcjax_ckpt_000581.npz")
    for batch in (None, 1024, 100, 1500):
        t, data, params, opt_state, width = tckpt.restore(path, batch)
        jt, jdata, jparams, _, jwidth = jckpt.restore(path, batch)
        assert t == jt == 582 and width == jwidth
        np.testing.assert_array_equal(data, jdata)
        assert data.shape == (batch or 1024, 288)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    assert isinstance(opt_state, dict)


def test_find_last_checkpoint_skips_corrupt_files(tmp_path):
    assert tckpt.find_last_checkpoint(str(tmp_path)) is None
    np.savez(tmp_path / "qmcjax_ckpt_000001.npz", t=1)
    (tmp_path / "qmcjax_ckpt_000002.npz").write_bytes(b"not a zip")
    assert tckpt.find_last_checkpoint(str(tmp_path)).endswith("000001.npz")


def test_writer_appends_under_one_header(tmp_path):
    for t in range(2):
        with Writer("stats", ["a", "b"], str(tmp_path), iteration_key="step") as w:
            w.write(t, a=t, b=2 * t)
    lines = (tmp_path / "stats.csv").read_text().splitlines()
    assert lines == ["step,a,b", "0,0,0", "1,1,2"]
    with pytest.raises(ValueError):
        with Writer("stats", ["a"], str(tmp_path)) as w:
            w.write(0, a=1, c=2)
