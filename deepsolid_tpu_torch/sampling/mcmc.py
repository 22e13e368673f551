"""Metropolis-Hastings sampling of |psi|^2 over periodic walkers.

Mirrors the all-electron sampler of deepsolid_tpu/sampling/mcmc.py
(mh_update without atom-centred proposals, make_mcmc_step,
update_mcmc_width). Random numbers come from an explicit
torch.Generator and are drawn in one place, `draw_move`, so a caller can
hand in its own proposal normals and acceptance uniforms.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from deepsolid_tpu_torch.ops.distance import enforce_pbc


def draw_move(gen: torch.Generator, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(proposal normals shaped like x, acceptance uniforms (B,))."""
    noise = torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)
    uniform = torch.rand(x.shape[:1], generator=gen, dtype=x.dtype,
                         device=x.device)
    return noise, uniform


def mh_update(f: Callable, x1: torch.Tensor, lp_1: torch.Tensor,
              num_accepts: torch.Tensor, latvec, stddev,
              noise: torch.Tensor, uniform: torch.Tensor):
    """One all-electron Metropolis-Hastings move.

    f(x) -> log|psi| (B,); lp_1 = 2 f(x1). Returns (x, lp, num_accepts).
    """
    x2, _ = enforce_pbc(latvec, x1 + stddev * noise)
    lp_2 = 2.0 * f(x2)
    cond = (lp_2 - lp_1) > torch.log(uniform)
    x_new = torch.where(cond[:, None], x2, x1)
    lp_new = torch.where(cond, lp_2, lp_1)
    return x_new, lp_new, num_accepts + torch.sum(cond)


def make_mcmc_step(batch_slog_network: Callable, latvec, steps: int = 10
                   ) -> Callable:
    """mcmc_step(params, data, gen, width) -> (data, pmove).

    batch_slog_network(params, x) -> log|psi| (B,).
    """

    def mcmc_step(params, data, gen, width):
        def f(x):
            return batch_slog_network(params, x)

        lp = 2.0 * f(data)
        num_accepts = torch.zeros((), dtype=torch.int64, device=data.device)
        for _ in range(steps):
            noise, uniform = draw_move(gen, data)
            data, lp, num_accepts = mh_update(f, data, lp, num_accepts, latvec,
                                              width, noise, uniform)
        pmove = num_accepts.to(data.dtype) / (steps * data.shape[0])
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
