"""Port parity: Metropolis moves, width adaptation, walker init, checkpoints."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsolid_tpu.sampling import mcmc as jmcmc
from deepsolid_tpu.utils import checkpoint as jckpt
from deepsolid_tpu_torch.sampling import mcmc as tmcmc
from deepsolid_tpu_torch.sampling.init import init_electrons
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
