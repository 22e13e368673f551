"""Metropolis-Hastings sampling of |psi|^2 over periodic walkers.

Mirrors deepsolid_tpu/sampling/mcmc.py: all-electron Gaussian moves
(optionally atom-centred, scaled by the harmonic mean of the nuclear
distances), one-electron moves, Langevin-drift importance sampling with
drift clipping, make_mcmc_step and update_mcmc_width. Random numbers
come from an explicit torch.Generator and are drawn in one place per
kind of move (`draw_move`, `draw_one_electron_move`), in the JAX
package's layout, so a caller can hand in its own proposal normals and
acceptance uniforms.

One deliberate difference: the importance move carries 2 log|psi(x2)|
as an accepted walker's log-probability, without the proposal term of
its acceptance ratio. The JAX package carries the ratio's corrected
value, which offsets the next move's ratio and widens the sampled
distribution (ROADMAP.md, C3).
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from deepsolid_tpu_torch.ops.distance import enforce_pbc
from deepsolid_tpu_torch.train.loss import walker_value_and_grad
from deepsolid_tpu_torch.utils import profiling


def draw_move(gen: torch.Generator, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(proposal normals shaped like x, acceptance uniforms (B,))."""
    noise = torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)
    uniform = torch.rand(x.shape[:1], generator=gen, dtype=x.dtype,
                         device=x.device)
    return noise, uniform


def draw_one_electron_move(gen: torch.Generator, x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(proposal normals (B, 1, 3) of the moved electron, uniforms (B,))."""
    noise = torch.randn((x.shape[0], 1, 3), generator=gen, dtype=x.dtype,
                        device=x.device)
    uniform = torch.rand(x.shape[:1], generator=gen, dtype=x.dtype,
                         device=x.device)
    return noise, uniform


def _log_prob_gaussian(x, mu, sigma):
    """Per-walker log density of an isotropic per-electron Gaussian.

    x, mu: (B, nelec, 1, 3); sigma broadcasts as (B, nelec, 1, 1). Returns
    (B,) without the x-independent constant, which cancels in a ratio.
    """
    quad = torch.sum(((x - mu) / sigma) ** 2, dim=(1, 2, 3))
    log_det = x.shape[-1] * torch.sum(torch.log(sigma), dim=(1, 2, 3))
    return -0.5 * quad - log_det


def _harmonic_mean(x, atoms):
    """Per-electron harmonic-mean distance to the nuclei, (B, nelec, 1, 1),
    of x (B, nelec, 1, 3) and atoms (natom, 3)."""
    dists = torch.linalg.vector_norm(x - atoms[None], dim=-1, keepdim=True)
    return 1.0 / torch.mean(1.0 / dists, dim=-2, keepdim=True)


def limit_drift(g: torch.Tensor, cutoff: float = 1.0) -> torch.Tensor:
    """Clip each electron's drift to norm `cutoff`, keeping its direction."""
    flat = g.reshape(-1, 3)
    norm = torch.linalg.vector_norm(flat, dim=-1)
    scale = cutoff / torch.clamp(norm, min=cutoff)
    return (flat * scale[:, None]).reshape(g.shape)


def _accept(x1, x2, lp_1, lp_2, ratio, uniform, num_accepts):
    with profiling.annotate("mcmc.accept"):
        cond = ratio > torch.log(uniform)
        x_new = torch.where(cond[:, None], x2, x1)
        lp_new = torch.where(cond, lp_2, lp_1)
        return x_new, lp_new, num_accepts + torch.sum(cond)


def mh_update(f: Callable, x1: torch.Tensor, lp_1: torch.Tensor,
              num_accepts: torch.Tensor, latvec, stddev,
              noise: torch.Tensor, uniform: torch.Tensor, atoms=None):
    """One all-electron Metropolis-Hastings move.

    f(x) -> log|psi| (B,); lp_1 = 2 f(x1). With `atoms` (natom, 3) each
    electron's proposal width is `stddev` times its harmonic-mean distance
    to the nuclei, and the ratio carries the forward and reverse proposal
    densities, both on the pre-wrap displacement (so that a move across
    the boundary keeps detailed balance). Returns (x, lp, num_accepts).
    """
    if atoms is None:
        x2, _ = enforce_pbc(latvec, x1 + stddev * noise)
        lp_2 = 2.0 * f(x2)
        return _accept(x1, x2, lp_1, lp_2, lp_2 - lp_1, uniform, num_accepts)
    n = x1.shape[0]
    atoms = torch.as_tensor(atoms, dtype=x1.dtype, device=x1.device)
    x1r = x1.reshape(n, -1, 1, 3)
    h1 = _harmonic_mean(x1r, atoms)
    x2_raw = x1r + stddev * h1 * noise.reshape(x1r.shape)
    x2, _ = enforce_pbc(latvec, x2_raw.reshape(n, -1))
    lp_2 = 2.0 * f(x2)
    h2 = _harmonic_mean(x2.reshape(n, -1, 1, 3), atoms)
    lq_1 = _log_prob_gaussian(x2_raw, x1r, stddev * h1)  # forward
    lq_2 = _log_prob_gaussian(x2_raw, x1r, stddev * h2)  # reverse
    ratio = lp_2 + lq_2 - lp_1 - lq_1
    return _accept(x1, x2, lp_1, lp_2, ratio, uniform, num_accepts)


def mh_one_electron_update(f: Callable, x1: torch.Tensor, lp_1: torch.Tensor,
                           num_accepts: torch.Tensor, latvec, stddev,
                           noise: torch.Tensor, uniform: torch.Tensor,
                           i: int = 0, atoms=None):
    """One Metropolis-Hastings move of electron i % nelec; noise (B, 1, 3)."""
    if atoms is not None:
        raise NotImplementedError(
            "Asymmetric proposals are not implemented for one-electron moves.")
    n = x1.shape[0]
    x2 = x1.clone().reshape(n, -1, 3)
    x2[:, i % x2.shape[1]] += stddev * noise[:, 0]
    x2, _ = enforce_pbc(latvec, x2.reshape(n, -1))
    lp_2 = 2.0 * f(x2)
    return _accept(x1, x2, lp_1, lp_2, lp_2 - lp_1, uniform, num_accepts)


def importance_update(f_val_grad: Callable, x1: torch.Tensor,
                      lp_1: torch.Tensor, num_accepts: torch.Tensor, latvec,
                      stddev, noise: torch.Tensor, uniform: torch.Tensor):
    """One Langevin-drift move: x2 = x1 + stddev noise + stddev^2 drift(x1).

    f_val_grad(x) -> (log|psi| (B,), its gradient in x); the drift is the
    clipped gradient. The ratio carries the forward and backward proposal
    densities; an accepted walker carries lp = 2 log|psi(x2)|, without
    them, so the next move's ratio is the exact one.
    """
    _, grad = f_val_grad(x1)
    grad = limit_drift(grad)
    gauss = stddev * noise
    x2, _ = enforce_pbc(latvec, x1 + gauss + stddev**2 * grad)
    lpsi_2, new_grad = f_val_grad(x2)
    new_grad = limit_drift(new_grad)
    lp_2 = 2.0 * lpsi_2
    forward = torch.sum(gauss**2, dim=-1)
    backward = torch.sum((gauss + stddev**2 * (grad + new_grad)) ** 2, dim=-1)
    ratio = lp_2 + (forward - backward) / (2 * stddev**2) - lp_1
    return _accept(x1, x2, lp_1, lp_2, ratio, uniform, num_accepts)


def make_mcmc_step(batch_slog_network: Callable, latvec, steps: int = 10,
                   importance_network: Optional[Callable] = None,
                   one_electron_moves: bool = False, psi_chunk: int = 0,
                   atoms=None) -> Callable:
    """mcmc_step(params, data, gen, width) -> (data, pmove).

    batch_slog_network(params, x) -> log|psi| (B,). With
    `importance_network` (the same function unchunked) every move is a
    Langevin move, whose value and gradient of log|psi| are taken
    `psi_chunk` walkers at a time; with `one_electron_moves` a step is
    nelec * steps single-electron moves; `atoms` gives all-electron moves
    atom-centred widths.
    """
    if importance_network is not None:
        if one_electron_moves:
            raise ValueError(
                "Importance sampling with one-electron moves is not supported.")
        val_grad = walker_value_and_grad(importance_network, psi_chunk)
        logging.info("MCMC: Langevin importance sampling")
    elif one_electron_moves:
        logging.info("MCMC: one-electron Metropolis")
    else:
        logging.info("MCMC: all-electron Metropolis")

    def mcmc_step(params, data, gen, width):
        # the value path (and the drift) on the walkers and the proposals
        def f(x):
            with profiling.annotate("mcmc.logpsi"):
                return batch_slog_network(params, x)

        def f_val_grad(x):
            with profiling.annotate("mcmc.logpsi"):
                return val_grad(params, x)

        nsteps = data.shape[-1] // 3 * steps if one_electron_moves else steps
        lp = 2.0 * f(data)
        num_accepts = torch.zeros((), dtype=torch.int64, device=data.device)
        for i in range(nsteps):
            with profiling.annotate("mcmc.move", i):
                if importance_network is not None:
                    noise, uniform = draw_move(gen, data)
                    data, lp, num_accepts = importance_update(
                        f_val_grad, data, lp, num_accepts,
                        latvec, width, noise, uniform)
                elif one_electron_moves:
                    noise, uniform = draw_one_electron_move(gen, data)
                    data, lp, num_accepts = mh_one_electron_update(
                        f, data, lp, num_accepts, latvec, width, noise, uniform,
                        i=i, atoms=atoms)
                else:
                    noise, uniform = draw_move(gen, data)
                    data, lp, num_accepts = mh_update(
                        f, data, lp, num_accepts, latvec, width, noise, uniform,
                        atoms=atoms)
        pmove = num_accepts.to(data.dtype) / (nsteps * data.shape[0])
        return data, pmove

    return mcmc_step


def update_mcmc_width(t: int, width: float, pmoves: np.ndarray, pmove: float,
                      adapt_frequency: int = 100):
    """Adaptive proposal width on the host.

    Every `adapt_frequency` steps the width grows by 1.1 when the mean
    acceptance of the window exceeds 0.55 and shrinks by 1.1 below 0.5.
    Returns (width, pmoves) updated; pmoves is the window buffer.
    """
    t_mod = t % adapt_frequency
    pmoves = np.array(pmoves, dtype=np.float64)
    if t > 0 and t_mod == 0:
        mean_p = float(np.mean(pmoves))
        if mean_p > 0.55:
            width = width * 1.1
        elif mean_p < 0.5:
            width = width / 1.1
        pmoves = np.zeros_like(pmoves)
    pmoves[t_mod] = pmove
    return width, pmoves
