"""The rest of the port's KFAC against deepsolid_tpu.optim.kfac, on the CPU
in float64: the Monte Carlo estimation modes ('fisher_gradients',
'fisher_curvature_prop') given JAX's own draws, and the full envelope's
per-atom Kronecker blocks (registry, state, taps and tangents, factor
sums, the update, the quadratic model, one process() iteration and its
checkpoint in both packages). Tolerances are stated at each comparison.
"""

import numpy as np
import pytest
import torch

from deepsolid_tpu_torch.models import network as tnet_lib
from deepsolid_tpu_torch.optim import kfac as tkfac
from deepsolid_tpu_torch.scf.free_electron import free_electron_klist
from deepsolid_tpu_torch.train import process as tprocess
from deepsolid_tpu_torch.utils import checkpoint as tckpt
from deepsolid_tpu_torch.utils.tree import tree_map
from test_torch_kfac import (assert_trees_close, random_like, schedule, to_numpy,
                             warm_state, with_kfac)
from test_torch_training import (  # noqa: F401  (one_device_jax is a fixture)
    NET, flat, jax_cfg, jflat, one_device_jax, same_order, torch_cfg,
    torch_lih_supercell, write_start)
from torch_helpers import F64, networks, walkers

FULL = {**NET, "envelope_type": "full"}
ENV = ["envelope_0", "envelope_1"]
LAYERS = ["single_0", "single_1", "double_0", "orbital_0", "orbital_1"]
MC_MODES = ["fisher_gradients", "fisher_curvature_prop"]


def optimizers(net=NET, **hyper):
    """(jax optimizer, torch optimizer, numpy params, torch params, walkers)."""
    from deepsolid_tpu.optim import kfac as jkfac

    jnet, tnet, params, tparams, _ = networks(**net)
    jopt = jkfac.KfacOptimizer(network=jnet, learning_rate_schedule=schedule, **hyper)
    topt = tkfac.KfacOptimizer(tnet, schedule, **hyper)
    return jopt, topt, params, tparams, walkers(6, 4, seed=3)


def jax_draws(mode, step, batch, chunk=0):
    """The z (batch, 2) the JAX package's update_curvature draws at an
    optimizer step outside a data axis: fold_in(PRNGKey(230), step), split
    once per capture chunk, in chunk order."""
    import jax
    import jax.numpy as jnp

    rng = jax.random.fold_in(jax.random.PRNGKey(230), step)
    chunk = chunk if chunk and 0 < chunk < batch else batch
    keys = jax.random.split(rng, batch // chunk) if chunk < batch else [rng]

    def draw(key):
        if mode == "fisher_curvature_prop":
            return 2.0 * jax.random.bernoulli(key, 0.5, (chunk, 2)) - 1.0
        return jax.random.normal(key, (chunk, 2), jnp.float64)

    return np.concatenate([np.asarray(draw(k), np.float64) for k in keys])


def assert_close_scaled(got, want, rtol=1e-9):
    want = np.asarray(want)
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


# ---- Monte Carlo estimation modes ------------------------------------------------------


@pytest.mark.parametrize("mode", MC_MODES)
def test_monte_carlo_capture_matches_jax_with_its_draws(mode):
    """One backward pass seeded with sqrt(2) z: the tangents of every layer
    and the diagonal gradients equal JAX's given JAX's z; the second of
    each pair is zero. 1e-9 of each array's scale."""
    import jax
    import jax.numpy as jnp

    jopt, topt, params, tparams, x = optimizers(estimation_mode=mode)
    rng = jax.random.PRNGKey(7)
    # the draws the JAX capture makes from `rng`
    if mode == "fisher_curvature_prop":
        z = np.asarray(2.0 * jax.random.bernoulli(rng, 0.5, (6, 2)) - 1.0, np.float64)
    else:
        z = np.asarray(jax.random.normal(rng, (6, 2), jnp.float64))
    jtaps, jdy, jdg = jopt._capture(params, jnp.asarray(x), rng=rng)
    ttaps, tdy, tdg = topt._capture(tparams, torch.tensor(x), torch.tensor(z))
    for name in LAYERS:
        assert_close_scaled(ttaps[name], jtaps[name])
        assert_close_scaled(tdy[name][0], jdy[name][0])
        assert float(tdy[name][1].abs().max()) == 0.0
    for key in jdg:
        assert_close_scaled(tdg[key][0], jdg[key][0])
        assert float(tdg[key][1].abs().max()) == 0.0


@pytest.mark.parametrize("chunk", [0, 2])
@pytest.mark.parametrize("mode", MC_MODES)
def test_monte_carlo_update_curvature_matches_jax(mode, chunk):
    """Two EMA updates at optimizer steps 0 and 1 (each its own draws),
    whole batch or two walkers a chunk (each chunk its own draws), against
    JAX's update, which draws its own. 1e-9."""
    import jax.numpy as jnp

    jopt, _, params, tparams, x = optimizers(estimation_mode=mode, capture_chunk=chunk)
    topt = optimizers(estimation_mode=mode, capture_chunk=chunk)[1]
    jstate = jopt.init(params, jnp.asarray(x))
    tstate = topt.init(tparams, torch.tensor(x))
    for i in range(2):
        jstate = jopt.update_curvature(jstate, params, jnp.asarray(x + 0.1 * i))
        tstate = topt.update_curvature(tstate, tparams, torch.tensor(x + 0.1 * i),
                                       draws=torch.tensor(jax_draws(mode, i, 6, chunk)))
        jstate = {**jstate, "step": jstate["step"] + 1}
        tstate = {**tstate, "step": tstate["step"] + 1}
    for name in LAYERS:
        for key in ("a_raw", "g_raw"):
            assert_close_scaled(tstate["blocks"][name][key], jstate["blocks"][name][key])
    for key in jstate["diag"]:
        assert_close_scaled(tstate["diag"][key]["raw"], jstate["diag"][key]["raw"])


@pytest.mark.parametrize("mode", MC_MODES)
def test_monte_carlo_draws_follow_the_step_and_the_rank(mode):
    """The port's own draws: reproducible for one (step, data rank), new
    for another step or rank; Rademacher entries are +-1, the normal ones
    have a plausible spread; without draws the capture takes its own."""
    _, topt, _, tparams, x = optimizers(estimation_mode=mode)
    z = topt.mc_draws(3, 4096, "cpu")
    torch.testing.assert_close(z, topt.mc_draws(3, 4096, "cpu"), rtol=0, atol=0)
    assert not torch.equal(z, topt.mc_draws(4, 4096, "cpu"))
    other = tkfac.KfacOptimizer(topt.network, schedule, estimation_mode=mode, data_index=1)
    assert not torch.equal(z, other.mc_draws(3, 4096, "cpu"))
    if mode == "fisher_curvature_prop":
        assert set(z.unique().tolist()) == {-1.0, 1.0}
    else:
        assert abs(float(z.std()) - 1.0) < 0.05
    state = topt.update_curvature(topt.init(tparams), tparams, torch.tensor(x))
    assert all(torch.isfinite(b["g_raw"]).all() for b in state["blocks"].values())


def test_unknown_estimation_mode_raises():
    _, tnet, _, _, _ = networks(**NET)
    with pytest.raises(ValueError, match="estimation_mode"):
        tkfac.KfacOptimizer(tnet, schedule, estimation_mode="fisher_empirical")


# ---- the full envelope ---------------------------------------------------------------------


def test_full_envelope_registry_and_init_state_match_jax():
    import jax.numpy as jnp

    jopt, topt, params, tparams, x = optimizers(FULL, damping=0.02)
    assert topt.network.envelope_registry(tparams) == jopt.network.envelope_registry(params)
    assert set(topt._env_registry(tparams)) == set(ENV)
    want = to_numpy(jopt.init(params, jnp.asarray(x)))
    got = topt.init(tparams, torch.tensor(x))
    assert list(got) == list(want)
    assert set(got["env_blocks"]) == set(ENV)
    assert set(got["diag"]) == {"envelope/0/pi", "envelope/1/pi"}
    assert_trees_close(got, want, rtol=0)
    assert tuple(got["env_blocks"]["envelope_0"]["g_raw"].shape) == (2, 3 * 4, 3 * 4)


@pytest.fixture(scope="module")
def full_captures():
    import jax.numpy as jnp

    jopt, topt, params, tparams, x = optimizers(FULL)
    return (jopt._capture(params, jnp.asarray(x)),
            topt._capture(tparams, torch.tensor(x)))


@pytest.mark.parametrize("name", ENV)
def test_full_envelope_taps_and_tangents_match_jax(full_captures, name):
    """The envelope's input ae and the tangents of ae . sigma under
    cotangent sqrt(2) on Re and on Im of log psi. 1e-9 of the scale."""
    (jtaps, jdy, _), (ttaps, tdy, _) = full_captures
    assert set(ttaps) == set(jtaps) == set(LAYERS + ENV)
    assert_close_scaled(ttaps[name], jtaps[name])
    for part in range(2):
        assert_close_scaled(tdy[name][part], jdy[name][part])


def test_full_envelope_factor_sums_match_jax():
    """Per-atom sums of ae ae^T and of the tangents' outer products. 1e-9."""
    import jax.numpy as jnp

    jopt, topt, params, tparams, x = optimizers(FULL)
    _, jenv, _ = jopt._factor_sums(params, jnp.asarray(x))
    _, tenv, _ = topt._factor_sums(tparams, torch.tensor(x))
    for name in ENV:
        for got, want in zip(tenv[name], jenv[name]):
            assert_close_scaled(got, want)


@pytest.mark.parametrize("chunk", [0, 3])
def test_full_envelope_update_curvature_matches_jax(chunk):
    import jax.numpy as jnp

    jopt, _, params, tparams, x = optimizers(FULL)
    topt = optimizers(FULL, capture_chunk=chunk)[1]
    jstate = jopt.init(params, jnp.asarray(x))
    tstate = topt.init(tparams, torch.tensor(x))
    for i in range(2):
        jstate = jopt.update_curvature(jstate, params, jnp.asarray(x + 0.1 * i))
        tstate = topt.update_curvature(tstate, tparams, torch.tensor(x + 0.1 * i))
    for name in ENV:
        for key in ("a_raw", "g_raw", "weight"):
            assert_close_scaled(tstate["env_blocks"][name][key],
                                jstate["env_blocks"][name][key])


def test_full_envelope_step_fn_and_quadratic_match_jax():
    """Two updates from one warm state (per-atom inverses refreshed,
    sigma preconditioned by its blocks), then v^T F v. 1e-9 / 1e-10."""
    import jax.numpy as jnp

    jopt, topt, params, tparams, x = optimizers(FULL, norm_constraint=1e-3)
    state = warm_state(jopt, params, x)
    jstate = tree_map(jnp.asarray, state)
    tstate = tkfac.state_from_numpy(state, "cpu", F64)
    jp, tp = params, tparams
    for i in range(2):
        grads = random_like(params, 12 + i)
        jp, jstate = jopt.step_fn(jp, jstate, tree_map(jnp.asarray, grads), 2e-3)
        tp, tstate = topt.step_fn(tp, tstate, tree_map(torch.tensor, grads), 2e-3)
    np.testing.assert_allclose(flat(tp), jflat(same_order(tp, jp)), rtol=1e-9, atol=1e-13)
    for name in ENV:
        for key in ("a_inv", "g_inv"):
            assert_close_scaled(tstate["env_blocks"][name][key],
                                jstate["env_blocks"][name][key])
    vec = random_like(params, 13)
    want = float(jopt.fisher_quadratic(jstate, params, tree_map(jnp.asarray, vec)))
    got = float(topt.fisher_quadratic(tstate, tparams, tree_map(torch.tensor, vec)))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-10)


def full_seed_state(n_walkers=8, seed=2):
    """(numpy params, numpy walkers) of the LiH network with the full
    envelope, made without JAX."""
    sc = torch_lih_supercell()
    net = tnet_lib.make_network(sc, free_electron_klist(sc),
                                tnet_lib.NetworkConfig(**FULL))
    params = net.init(np.random.default_rng(seed))
    x = np.random.RandomState(seed).randn(n_walkers, 3 * sum(sc.nelec)) * 2.0
    return params, x


def full_cfgs(tmp_path, iterations):
    from torch_helpers import lih_cells

    optim = dict(clip_el=2.0, el_chunk=4, psi_chunk=4)
    tcfg = with_kfac(torch_cfg(tmp_path / "torch", optimizer="kfac",
                               iterations=iterations, **optim))
    jcfg = with_kfac(jax_cfg(tmp_path / "jax", lih_cells()[0], optimizer="kfac",
                             iterations=iterations, **optim))
    for cfg in (tcfg, jcfg):
        cfg.network.detnet.envelope_type = "full"
    return tcfg, jcfg


def test_full_envelope_kfac_iteration_and_checkpoints_match_jax(tmp_path, one_device_jax):
    """One KFAC iteration of process() in both packages from one start
    (walkers fixed, chunked capture, the damping adapted at step 0): the
    parameters to rtol 1e-8 and the energy. Then each package continues
    the other's checkpoint (env_blocks included) for one more iteration,
    to the same parameters. 1e-8."""
    from deepsolid_tpu.train import process as jprocess
    from deepsolid_tpu.utils import checkpoint as jckpt

    params, x = full_seed_state()
    for side in ("jax", "torch"):
        write_start(tmp_path / side, params, x)
    tcfg, jcfg = full_cfgs(tmp_path, 1)
    jparams, _, jenergy = jprocess.process(jcfg)
    tparams, _, tenergy = tprocess.process(tcfg, device="cpu")
    np.testing.assert_allclose(tenergy, jenergy, rtol=1e-8)
    np.testing.assert_allclose(flat(tparams), jflat(same_order(tparams, jparams)),
                               rtol=1e-8, atol=1e-12)
    start = tnet_lib.params_from_jax(params, dtype=F64)
    moved = np.abs(tparams["envelope"][0]["sigma"].numpy()
                   - start["envelope"][0]["sigma"].numpy()).max()
    assert moved > 1e-6  # sigma took its Kronecker-preconditioned step

    _, _, _, jstate, _ = jckpt.restore(str(tmp_path / "torch" / "qmcjax_ckpt_000000.npz"))
    assert set(jstate["env_blocks"]) == set(ENV)
    assert np.abs(jstate["env_blocks"]["envelope_0"]["g_inv"]).max() > 0
    _, _, _, tstate, _ = tckpt.restore(str(tmp_path / "jax" / "qmcjax_ckpt_000000.npz"))
    assert set(tstate["env_blocks"]) == set(ENV)
    # swap the two runs' checkpoints: each package continues the other's
    (tmp_path / "torch" / "qmcjax_ckpt_000000.npz").rename(tmp_path / "t.npz")
    (tmp_path / "jax" / "qmcjax_ckpt_000000.npz").rename(
        tmp_path / "torch" / "qmcjax_ckpt_000000.npz")
    (tmp_path / "t.npz").rename(tmp_path / "jax" / "qmcjax_ckpt_000000.npz")
    tcfg, jcfg = full_cfgs(tmp_path, 2)
    jparams, _, _ = jprocess.process(jcfg)
    tparams, _, _ = tprocess.process(tcfg, device="cpu")
    np.testing.assert_allclose(flat(tparams), jflat(same_order(tparams, jparams)),
                               rtol=1e-8, atol=1e-12)
