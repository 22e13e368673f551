"""VMC energy and its batch statistics (forward part).

Mirrors deepsolid_tpu/train/loss.py without the custom-JVP gradient
estimator (that belongs to the training slice): the walker-chunked batch
local energy, the containment of non-finite walkers and the statistics
of `total_energy`, and `clip_local_energy_diff`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from deepsolid_tpu_torch.hamiltonian import make_local_energy


@dataclasses.dataclass
class AuxiliaryLossData:
    variance: torch.Tensor
    local_energy: torch.Tensor
    imaginary: torch.Tensor
    kinetic: torch.Tensor
    ewald: torch.Tensor
    finite: torch.Tensor  # per-walker 1.0 where the local energy was finite


def clip_local_energy_diff(diff, clip_width: float, clip_type: str):
    """Clip (E_L - E) in Cartesian re/im ('real') or polar ('complex') style."""
    if clip_width <= 0.0:
        return diff
    if clip_type == "real":
        tv_re = torch.mean(torch.abs(diff.real))
        tv_im = torch.mean(torch.abs(diff.imag))
        re = torch.clamp(diff.real, -clip_width * tv_re, clip_width * tv_re)
        im = torch.clamp(diff.imag, -clip_width * tv_im, clip_width * tv_im)
        return torch.complex(re, im)
    if clip_type == "complex":
        radius, phase = torch.abs(diff), torch.angle(diff)
        radius_tv = torch.std(radius, correction=0)
        # jnp.median averages the two middle values of an even count;
        # torch.median would take the lower one, torch.quantile does not
        radius_mean = torch.quantile(radius, 0.5)
        clip_radius = torch.clamp(radius, radius_mean - radius_tv * clip_width,
                                  radius_mean + radius_tv * clip_width)
        return clip_radius * torch.exp(1j * phase)
    raise ValueError(f"Unknown clip type: {clip_type}")


def make_batch_local_energy(network, supercell, el_chunk: int = 0,
                            mode: str = "forward") -> Callable:
    """(params, data (B, 3N)) -> (kinetic (B,) complex, ewald (B,)),
    evaluated `el_chunk` walkers at a time to bound jet memory."""
    el_fun = make_local_energy(network, supercell, mode=mode)

    def batch_local_energy(params, data):
        n = data.shape[0]
        if not el_chunk or el_chunk <= 0 or n <= el_chunk:
            return el_fun(params, data)
        if n % el_chunk != 0:
            raise ValueError(
                f"optim.el_chunk={el_chunk} must divide the walker batch ({n})")
        parts = [el_fun(params, chunk) for chunk in data.split(el_chunk)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    return batch_local_energy


def energy_statistics(ke: torch.Tensor, ew: torch.Tensor):
    """(loss, AuxiliaryLossData) from per-walker kinetic and Ewald energies.

    Non-finite walkers (at a node or a coalescence point) are replaced by
    the finite-sample mean, so one bad walker costs nothing.
    """
    e_l = ke + ew
    finite = torch.isfinite(e_l.real) & torch.isfinite(e_l.imag)
    n_finite = torch.clamp(torch.mean(finite.to(ew.dtype)), min=1e-12)
    zero = torch.zeros((), dtype=e_l.dtype, device=e_l.device)
    safe_mean = torch.mean(torch.where(finite, e_l, zero)) / n_finite
    e_l = torch.where(finite, e_l, safe_mean)
    ke_mean = torch.mean(torch.where(finite, ke, zero)) / n_finite
    ew_mean = torch.mean(torch.where(finite, ew, zero.real)) / n_finite
    ke = torch.where(finite, ke, ke_mean)
    ew = torch.where(finite, ew, ew_mean)
    mean_e_l = torch.mean(e_l)
    variance = torch.mean(torch.abs(e_l) ** 2) - torch.abs(mean_e_l.real) ** 2
    return mean_e_l.real, AuxiliaryLossData(
        variance=variance,
        local_energy=e_l,
        imaginary=mean_e_l.imag,
        kinetic=ke,
        ewald=ew,
        finite=finite.to(ew.dtype),
    )


def make_loss(network, supercell, el_chunk: int = 0, mode: str = "forward"
              ) -> Callable:
    """total_energy(params, data) -> (loss, AuxiliaryLossData), no gradient."""
    batch_local_energy = make_batch_local_energy(network, supercell, el_chunk, mode)

    @torch.no_grad()
    def total_energy(params, data):
        return energy_statistics(*batch_local_energy(params, data))

    return total_energy
