"""The port's KFAC optimizer against deepsolid_tpu.optim.kfac, on the CPU
in float64.

Same parameters, walkers, gradients and states (seeded numpy) go through
both packages: the damped inverses, the per-layer curvature capture, the
factor update (whole batch and chunked), the update with and without the
norm constraint, the quadratic model and the damping adaptation, and three
KFAC iterations of process(). Tolerances are stated at each comparison.
Checkpoints and ranks are in test_torch_kfac_state.py.
"""

import numpy as np
import pytest
import torch

from deepsolid_tpu_torch.optim import kfac as tkfac
from deepsolid_tpu_torch.train import process as tprocess
from deepsolid_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_training import (  # noqa: F401  (one_device_jax is a fixture)
    NET, flat, jax_cfg, jflat, one_device_jax, same_order, seed_state,
    torch_cfg, write_start)
from torch_helpers import F64, networks, walkers

LAYERS = ["single_0", "single_1", "double_0", "orbital_0", "orbital_1"]
DIAG = ["envelope/0/pi", "envelope/0/sigma", "envelope/1/pi", "envelope/1/sigma"]


def schedule(t):
    return 0.05 * (1.0 / (1.0 + t / 100.0))


def optimizers(**hyper):
    """(jax optimizer, torch optimizer, numpy params, torch params, walkers)."""
    from deepsolid_tpu.optim import kfac as jkfac

    jnet, tnet, params, tparams, _ = networks(**NET)
    jopt = jkfac.KfacOptimizer(network=jnet, learning_rate_schedule=schedule, **hyper)
    topt = tkfac.KfacOptimizer(tnet, schedule, **hyper)
    return jopt, topt, params, tparams, walkers(6, 4, seed=3)


def to_numpy(tree):
    """A JAX or torch tree as numpy leaves in plain dicts and lists."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def assert_trees_close(got, want, rtol, atol=0.0):
    got, want = to_numpy(got), to_numpy(want)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_trees_close(got[k], want[k], rtol, atol)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_trees_close(g, w, rtol, atol)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def warm_state(jopt, params, x, steps=2):
    """A JAX KFAC state after `steps` curvature updates on shifted walkers
    and one inverse refresh, as numpy."""
    import jax.numpy as jnp

    state = jopt.init(params, jnp.asarray(x))
    for i in range(steps):
        state = jopt.update_curvature(state, params, jnp.asarray(x + 0.1 * i))
    return to_numpy(jopt.refresh_inverses(state, 1e-3))


def random_like(tree, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return tree_map(lambda a: scale * rng.randn(*np.shape(a)), to_numpy(tree))


# ---- damped inverses -----------------------------------------------------------


def _psd(n, seed):
    m = np.random.RandomState(seed).randn(n, 2 * n)
    return m @ m.T / (2 * n)


def test_psd_inv_cholesky_matches_jax():
    """1e-10: one Cholesky solve in float64 on a well-conditioned matrix."""
    import jax.numpy as jnp
    from deepsolid_tpu.optim import kfac as jkfac

    f = _psd(7, 0)
    want = np.asarray(jkfac.psd_inv_cholesky(jnp.asarray(f), 0.03))
    got = tkfac.psd_inv_cholesky(torch.tensor(f), 0.03).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got @ (f + 0.03 * np.eye(7)), np.eye(7), atol=1e-10)


@pytest.mark.parametrize("zero", [None, 0, 1], ids=["regular", "zero_a", "zero_g"])
def test_pi_adjusted_inverse_matches_jax(zero):
    """The pi-adjusted pair of inverses, and the zero-factor guard (a
    factor whose trace is 0 gives identity / sqrt(damping) for both). 1e-10."""
    import jax.numpy as jnp
    from deepsolid_tpu.optim import kfac as jkfac

    f = [_psd(5, 1), _psd(9, 2)]
    if zero is not None:
        f[zero] = np.zeros_like(f[zero])
    want = jkfac.pi_adjusted_inverse(jnp.asarray(f[0]), jnp.asarray(f[1]), 2e-3)
    got = tkfac.pi_adjusted_inverse(torch.tensor(f[0]), torch.tensor(f[1]), 2e-3)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12)
    if zero is not None:
        np.testing.assert_allclose(got[0].numpy(), np.eye(5) / np.sqrt(2e-3), rtol=1e-10)


# ---- capture ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def captures():
    import jax.numpy as jnp

    jopt, topt, params, tparams, x = optimizers()
    return (jopt._capture(params, jnp.asarray(x)),
            topt._capture(tparams, torch.tensor(x)))


@pytest.mark.parametrize("name", LAYERS)
def test_capture_taps_and_tangents_match_jax(captures, name):
    """A layer's input tap and its output tangents under cotangent sqrt(2)
    on Re and on Im of log psi (the Im pass runs through log(phase) and the
    Gauss-Jordan slogdet's backward rule). 1e-9 of each array's scale."""
    (jtaps, jdy, _), (ttaps, tdy, _) = captures
    assert set(ttaps) == set(jtaps) == set(LAYERS)
    pairs = [(ttaps[name], jtaps[name]), (tdy[name][0], jdy[name][0]),
             (tdy[name][1], jdy[name][1])]
    for got, want in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape and np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("key", DIAG)
def test_capture_diagonal_gradients_match_jax(captures, key):
    (_, _, jdg), (_, _, tdg) = captures
    assert set(tdg) == set(jdg) == set(DIAG)
    for got, want in zip(tdg[key], jdg[key]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())


def test_capture_leaves_the_parameters_without_gradients():
    _, topt, _, tparams, x = optimizers()
    topt._capture(tparams, torch.tensor(x))
    assert all(t.grad is None and not t.requires_grad for t in tree_leaves(tparams))


# ---- factor update ------------------------------------------------------------------


def test_init_state_matches_jax_key_for_key():
    import jax.numpy as jnp

    jopt, topt, params, tparams, x = optimizers(damping=0.02)
    want = to_numpy(jopt.init(params, jnp.asarray(x)))
    got = topt.init(tparams, torch.tensor(x))
    assert list(got) == ["step", "velocities", "blocks", "env_blocks", "diag",
                         "damping", "rho"]
    assert got["step"].dtype == torch.int32 and got["env_blocks"] == {}
    assert_trees_close(got, want, rtol=0)
    assert float(got["blocks"]["double_0"]["extra_scale"]) == 16.0  # 4 x 4 pairs


@pytest.mark.parametrize("chunk", [0, 2, 3])
def test_update_curvature_matches_jax(chunk):
    """Two EMA updates of every factor, whole batch or `chunk` walkers at a
    time, against the JAX package's whole-batch update. 1e-9."""
    import jax.numpy as jnp

    jopt, _, params, tparams, x = optimizers()
    topt = optimizers(capture_chunk=chunk)[1]
    jstate = jopt.init(params, jnp.asarray(x))
    tstate = topt.init(tparams, torch.tensor(x))
    for i in range(2):
        jstate = jopt.update_curvature(jstate, params, jnp.asarray(x + 0.1 * i))
        tstate = topt.update_curvature(tstate, tparams, torch.tensor(x + 0.1 * i))
    assert float(tstate["blocks"]["single_0"]["weight"]) == pytest.approx(1.95)
    for name in LAYERS:
        for key in ("a_raw", "g_raw", "weight"):
            want = np.asarray(jstate["blocks"][name][key])
            np.testing.assert_allclose(tstate["blocks"][name][key].numpy(), want,
                                       rtol=1e-9, atol=1e-9 * np.abs(want).max())
    for key in DIAG:
        want = np.asarray(jstate["diag"][key]["raw"])
        np.testing.assert_allclose(tstate["diag"][key]["raw"].numpy(), want,
                                   rtol=1e-9, atol=1e-9 * np.abs(want).max())


def test_capture_chunk_must_divide_the_batch():
    _, topt, _, tparams, x = optimizers(capture_chunk=4)
    with pytest.raises(ValueError, match="capture_chunk"):
        topt.update_curvature(topt.init(tparams), tparams, torch.tensor(x))


# ---- the update ------------------------------------------------------------------------


@pytest.mark.parametrize("hyper", [
    dict(norm_constraint=1e-3),                              # constraint active
    dict(norm_constraint=1e6),                               # inactive: coeff = 1
    dict(norm_constraint=None, momentum=0.5, l2_reg=1e-2),   # none at all
    dict(norm_constraint=1e-3, invert_every=3),              # stale inverses kept
], ids=["active", "inactive", "none_momentum_l2", "invert_every"])
def test_step_fn_matches_jax(hyper):
    """Two updates from one warm state and the same gradients: parameters,
    velocities, refreshed inverses and the step counter. 1e-9."""
    import jax.numpy as jnp

    jopt, topt, params, tparams, x = optimizers(**hyper)
    state = warm_state(jopt, params, x)
    state["step"] = np.asarray(1, np.int32)  # invert_every=3: no refresh at 1, 2
    state["velocities"] = random_like(params, 11, 1e-3)
    jstate = tree_map(jnp.asarray, state)
    tstate = tkfac.state_from_numpy(state, "cpu", F64)
    jp, tp = params, tparams
    for i in range(2):
        grads = random_like(params, 12 + i)
        jp, jstate = jopt.step_fn(jp, jstate, tree_map(jnp.asarray, grads), 2e-3)
        tp, tstate = topt.step_fn(tp, tstate, tree_map(torch.tensor, grads), 2e-3)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    np.testing.assert_allclose(flat(tp), jflat(same_order(tp, jp)), rtol=1e-9, atol=1e-13)
    assert_trees_close(tstate["velocities"], same_order(tstate["velocities"],
                                                        to_numpy(jstate["velocities"])),
                       rtol=1e-9, atol=1e-15)
    for name in LAYERS:
        for key in ("a_inv", "g_inv"):
            np.testing.assert_allclose(tstate["blocks"][name][key].numpy(),
                                       np.asarray(jstate["blocks"][name][key]),
                                       rtol=1e-9, atol=1e-12)
    assert np.abs(flat(tp) - flat(tparams)).max() > 0


def test_fisher_quadratic_matches_jax():
    """v^T F v under the block approximation. 1e-10."""
    import jax.numpy as jnp

    jopt, topt, params, tparams, x = optimizers()
    state = warm_state(jopt, params, x)
    vec = random_like(params, 13)
    want = float(jopt.fisher_quadratic(tree_map(jnp.asarray, state), params,
                                       tree_map(jnp.asarray, vec)))
    got = float(topt.fisher_quadratic(tkfac.state_from_numpy(state, "cpu", F64),
                                      tparams, tree_map(torch.tensor, vec)))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.parametrize("target,factor", [
    (0.9, 0.9**5), (0.5, 1.0), (0.1, 0.9**-5), (None, 0.9**-5)],
    ids=["shrinks", "keeps", "grows", "uphill_grows"])
def test_adapt_damping_matches_jax(target, factor):
    """The rho rule's branches: rho > 3/4 shrinks the damping by
    decay^interval, rho < 1/4 grows it, between it stays; a step whose
    quadratic model predicts no decrease counts as rho = -1. 1e-10."""
    import jax.numpy as jnp

    jopt, topt, params, tparams, x = optimizers(
        adaptive_damping=True, min_damping=1e-6, max_damping=10.0)
    state = warm_state(jopt, params, x)
    state["damping"] = np.asarray(0.05)
    grads = random_like(params, 14)
    sign = 1.0 if target is None else -1.0  # along or against the gradient
    new = tree_map(lambda p, g: p + sign * 1e-3 * g, to_numpy(params), grads)
    tstate = tkfac.state_from_numpy(state, "cpu", F64)
    tnew, tgrads = tree_map(torch.tensor, new), tree_map(torch.tensor, grads)
    # the model's prediction, to place the loss change where the case wants rho
    probe = topt.adapt_damping(tstate, tparams, tnew, tgrads, torch.tensor(0.0, dtype=F64),
                               torch.tensor(1.0, dtype=F64))
    quad = 1.0 / float(probe["rho"]) if target is not None else 1.0
    old_loss, new_loss = -1.5, -1.5 + (target or 0.5) * quad
    got = topt.adapt_damping(tstate, tparams, tnew, tgrads, torch.tensor(old_loss, dtype=F64),
                             torch.tensor(new_loss, dtype=F64))
    want = jopt.adapt_damping(tree_map(jnp.asarray, state), params,
                              tree_map(jnp.asarray, new),
                              tree_map(jnp.asarray, grads), old_loss, new_loss)
    np.testing.assert_allclose(float(got["rho"]), float(want["rho"]), rtol=1e-10)
    np.testing.assert_allclose(float(got["damping"]), float(want["damping"]), rtol=1e-10)
    np.testing.assert_allclose(float(got["rho"]), -1.0 if target is None else target,
                               rtol=1e-9)
    np.testing.assert_allclose(float(got["damping"]), 0.05 * factor, rtol=1e-10)


def test_damping_is_clipped_to_its_range():
    _, topt, _, tparams, x = optimizers(adaptive_damping=True, max_damping=0.06)
    state = topt.init(tparams)
    state["damping"] = torch.tensor(0.05, dtype=F64)
    new = tree_map(lambda p: p + 1e-3, tparams)
    grads = tree_map(torch.ones_like, tparams)  # uphill: rho = -1, damping grows
    out = topt.adapt_damping(state, tparams, new, grads,
                             torch.tensor(0.0, dtype=F64), torch.tensor(1.0, dtype=F64))
    assert float(out["rho"]) == -1.0 and float(out["damping"]) == pytest.approx(0.06)


# ---- three KFAC iterations of process() ------------------------------------------------------

KFAC = dict(adaptive_damping=True, damping_adaptation_interval=2, damping=0.05)


def with_kfac(cfg, **keys):
    for key, value in {**KFAC, **keys}.items():
        cfg.optim.kfac[key] = value
    return cfg


def test_three_kfac_steps_match_jax(tmp_path, one_device_jax):
    """process() of both packages from one starting checkpoint, walkers
    fixed (mcmc.steps = 0), chunked capture, adaptive damping adapting at
    optimizer steps 0 and 2: parameters after three KFAC iterations to rtol
    1e-8, the logged energies and the logged damping."""
    from deepsolid_tpu.train import process as jprocess
    from torch_helpers import lih_cells

    _, _, params, x = seed_state(n_walkers=8, seed=2)
    for side in ("jax", "torch"):
        write_start(tmp_path / side, params, x)
    optim = dict(clip_el=2.0, el_chunk=4, psi_chunk=4)
    jsc, _ = lih_cells()
    jparams, _, jenergy = jprocess.process(
        with_kfac(jax_cfg(tmp_path / "jax", jsc, optimizer="kfac", **optim)))
    seen = []
    tparams, tdata, tenergy = tprocess.process(
        with_kfac(torch_cfg(tmp_path / "torch", optimizer="kfac", **optim)),
        device="cpu", on_iteration=lambda t, row, s: seen.append((row, s)))
    assert [r["optimizer_step"] for r, _ in seen] == [0, 1, 2]
    assert ["adapt" in s for _, s in seen] == [True, False, True]
    assert all({"mcmc", "local_energy", "gradient", "curvature", "update", "step"}
               <= set(s) for _, s in seen)
    np.testing.assert_allclose(tenergy, jenergy, rtol=1e-8)
    np.testing.assert_allclose(flat(tparams), jflat(same_order(tparams, jparams)),
                               rtol=1e-8, atol=1e-12)
    start = flat(tree_map(lambda a: torch.tensor(np.asarray(a)), params))
    assert np.abs(flat(tparams) - start).max() > 1e-4  # the parameters moved
    np.testing.assert_array_equal(tdata.numpy(), x)  # fixed walkers

    jrows = open(tmp_path / "jax" / "train_stats.csv").read().strip().split("\n")
    trows = open(tmp_path / "torch" / "train_stats.csv").read().strip().split("\n")
    assert jrows[0] == trows[0] and jrows[0].endswith(",damping")
    assert len(jrows) == len(trows) == 4
    for jr, tr, (row, _) in zip(jrows[1:], trows[1:], seen):
        for col in (1, -1):  # energy, damping
            np.testing.assert_allclose(float(tr.split(",")[col]),
                                       float(jr.split(",")[col]), rtol=1e-8)
        assert float(tr.split(",")[-1]) == pytest.approx(row["damping"])
    assert seen[0][0]["rho"] != 0.0  # the first adaptation set it
    assert seen[2][0]["damping"] != KFAC["damping"]  # the second moved the damping
