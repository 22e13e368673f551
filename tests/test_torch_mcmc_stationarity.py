"""Stationarity of the port's four samplers (all-electron, atom-centred,
one-electron, Langevin importance) on the anisotropic periodic target of
tests/test_mcmc_stationarity.py, with its widths and 0.03 gate, and the
importance chain's variance on a unit Gaussian at a wide proposal.

Target: independent electrons with per-electron density p(r) ~ exp(g),
  g(r) = 0.6 cos(2 pi x/L) cos(4 pi y/L) + 0.3 sin(2 pi z/L)
         + 0.4 cos(2 pi (x+z)/L),
whose exact moments come from dense 3-D quadrature. An error in a
proposal's asymmetry correction biases them.
"""

import functools

import numpy as np
import pytest
import torch

from deepsolid_tpu_torch.sampling.mcmc import make_mcmc_step

L = 2.0
LATVEC = np.eye(3) * L
W = 2 * np.pi / L


def g_single(r, lib=torch):
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    return (0.6 * lib.cos(W * x) * lib.cos(2 * W * y) + 0.3 * lib.sin(W * z)
            + 0.4 * lib.cos(W * (x + z)))


def batch_slog(params, x):
    return 0.5 * torch.sum(g_single(x.reshape(x.shape[0], -1, 3)), dim=-1)


OBSERVABLES = {
    "cos_x": lambda r: np.cos(W * r[..., 0]),
    "cos_2y": lambda r: np.cos(2 * W * r[..., 1]),
    "sin_z": lambda r: np.sin(W * r[..., 2]),
    "cos_xz": lambda r: np.cos(W * (r[..., 0] + r[..., 2])),
}


@functools.lru_cache()
def exact_moments(n=64):
    ax = np.arange(n) * L / n
    r = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1)
    p = np.exp(g_single(r, np))
    p /= p.sum()
    return {k: float((f(r) * p).sum()) for k, f in OBSERVABLES.items()}


def run_sampler(width, n_collect=150, burn=60, batch=256, nelec=2, seed=0, **kwargs):
    step = make_mcmc_step(batch_slog, LATVEC, steps=10, **kwargs)
    gen = torch.Generator().manual_seed(seed)
    data = torch.rand((batch, nelec * 3), generator=gen, dtype=torch.float64) * L
    for _ in range(burn):
        data, pmove = step(None, data, gen, width)
    sums = {k: 0.0 for k in OBSERVABLES}
    for _ in range(n_collect):
        data, pmove = step(None, data, gen, width)
        r = data.numpy().reshape(-1, 3)
        for k, f in OBSERVABLES.items():
            sums[k] += f(r).mean()
    return {k: s / n_collect for k, s in sums.items()}, float(pmove)


# the widths of tests/test_mcmc_stationarity.py: the proposal densities
# are unwrapped Gaussians, exact up to image terms that bias moments at
# width ~0.5 in an L = 2 box, so the asymmetric kinds run at <= 0.2
SAMPLERS = {
    "all_electron": dict(width=0.45, n_collect=150, kwargs={}),
    "all_electron_asymmetric": dict(
        width=0.18, n_collect=400,
        kwargs=dict(atoms=np.array([[0.5, 1.0, 1.5], [1.5, 0.5, 0.7]]))),
    "one_electron": dict(width=0.7, n_collect=150, kwargs=dict(one_electron_moves=True)),
    "importance": dict(width=0.2, n_collect=400,
                       kwargs=dict(importance_network=batch_slog)),
}


@pytest.mark.parametrize("kind", sorted(SAMPLERS))
def test_stationary_distribution(kind):
    spec = SAMPLERS[kind]
    got, pmove = run_sampler(spec["width"], n_collect=spec["n_collect"], **spec["kwargs"])
    want = exact_moments()
    assert 0.15 < pmove < 0.98, pmove
    for k in want:
        # stderr ~0.005-0.01 at these lengths: 0.03 is a 3-4 sigma gate
        assert abs(got[k] - want[k]) < 0.03, (kind, k, got[k], want[k])


def test_importance_chain_keeps_a_unit_gaussian_at_width_one():
    """|psi|^2 = N(100, 1) per coordinate, 4096 walkers of 3 coordinates,
    10 moves per call, 150 calls, the variance averaged over the last 100.
    A chain that carried the proposal term in its log-probability (the
    JAX package's, ROADMAP.md C3) reads ~1.28 here."""
    def slog(params, x):
        return -torch.sum((x - 100.0) ** 2, dim=-1) / 4.0

    step = make_mcmc_step(slog, np.eye(3) * 200.0, steps=10, importance_network=slog)
    gen = torch.Generator().manual_seed(0)
    data = 100.0 + torch.randn((4096, 3), generator=gen, dtype=torch.float64)
    variances = []
    for call in range(150):
        data, pmove = step(None, data, gen, 1.0)
        if call >= 50:
            variances.append(float(data.var()))
    assert 0.5 < float(pmove) < 1.0
    assert abs(np.mean(variances) - 1.0) <= 0.02, np.mean(variances)
