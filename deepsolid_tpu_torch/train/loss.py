"""VMC energy, its batch statistics and its gradient estimator.

Mirrors deepsolid_tpu/train/loss.py: the walker-chunked batch local
energy, the containment of non-finite walkers and the statistics of
`total_energy`, `clip_local_energy_diff`, and the covariance estimator
of the energy gradient,
    dE = mean(Re((E_L - E)_clipped * conj(d log psi))),
which the JAX package writes as a custom JVP. Here it is a surrogate:
E_L is evaluated without autograd (it is never differentiated), and log
psi is differentiated chunk by chunk against the fixed clipped
differences, accumulating parameter gradients so that only one chunk's
activations are alive at a time.

Statistics are means over the data ranks when `all_mean` is given
(parallel.Mesh.all_mean), as the JAX package's pmean over the data axis.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from deepsolid_tpu_torch.hamiltonian import make_local_energy
from deepsolid_tpu_torch.utils import profiling
from deepsolid_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass
class AuxiliaryLossData:
    variance: torch.Tensor
    local_energy: torch.Tensor
    imaginary: torch.Tensor
    kinetic: torch.Tensor
    ewald: torch.Tensor
    finite: torch.Tensor  # per-walker 1.0 where the local energy was finite


def _identity(t):
    return t


def chunk_batch_fn(fn: Callable, chunk: int) -> Callable:
    """fn(params, data) evaluated `chunk` walkers at a time and
    concatenated (each element of a tuple result along the walker axis),
    bounding its activation memory; for evaluations whose parameter
    gradients are not taken (the sampler's log|psi| sweeps and drift)."""
    if not chunk or chunk <= 0:
        return fn

    def wrapped(params, data):
        n = data.shape[0]
        if n <= chunk:
            with profiling.annotate("psi.chunk", 0):
                return fn(params, data)
        if n % chunk != 0:
            raise ValueError(
                f"optim.psi_chunk={chunk} must divide the walker batch ({n})")
        parts = []
        for i, d in enumerate(data.split(chunk)):
            with profiling.annotate("psi.chunk", i):
                parts.append(fn(params, d))
        if isinstance(parts[0], tuple):
            return tuple(torch.cat(p) for p in zip(*parts))
        return torch.cat(parts)

    return wrapped


def walker_value_and_grad(fn: Callable, chunk: int = 0) -> Callable:
    """(params, x) -> (fn(params, x), d fn / dx), `chunk` walkers at a
    time: the JAX package's vmap(value_and_grad(net.slogdet)) under
    chunk_batch_fn. Walkers are independent, so the gradient of the sum
    over the batch is each walker's own gradient. Runs under autograd
    even inside torch.no_grad(); the graph lives for one chunk and
    nothing returned carries it."""

    def value_and_grad(params, x):
        with torch.enable_grad():
            x = x.detach().requires_grad_()
            value = fn(params, x)
            (grad,) = torch.autograd.grad(value.sum(), x)
        return value.detach(), grad

    return chunk_batch_fn(value_and_grad, chunk)


def clip_local_energy_diff(diff, clip_width: float, clip_type: str,
                           all_mean: Optional[Callable] = None):
    """Clip (E_L - E) in Cartesian re/im ('real') or polar ('complex') style."""
    pmean = all_mean or _identity
    if clip_width <= 0.0:
        return diff
    if clip_type == "real":
        tv_re = pmean(torch.mean(torch.abs(diff.real)))
        tv_im = pmean(torch.mean(torch.abs(diff.imag)))
        re = torch.clamp(diff.real, -clip_width * tv_re, clip_width * tv_re)
        im = torch.clamp(diff.imag, -clip_width * tv_im, clip_width * tv_im)
        return torch.complex(re, im)
    if clip_type == "complex":
        radius, phase = torch.abs(diff), torch.angle(diff)
        radius_tv = pmean(torch.std(radius, correction=0))
        # jnp.median averages the two middle values of an even count;
        # torch.median would take the lower one, torch.quantile does not
        radius_mean = pmean(torch.quantile(radius, 0.5))
        clip_radius = torch.clamp(radius, radius_mean - radius_tv * clip_width,
                                  radius_mean + radius_tv * clip_width)
        return clip_radius * torch.exp(1j * phase)
    raise ValueError(f"Unknown clip type: {clip_type}")


def make_batch_local_energy(network, supercell, el_chunk: int = 0,
                            mode: str = "forward", shard=None,
                            partition_number: int = 3) -> Callable:
    """(params, data (B, 3N)) -> (kinetic (B,) complex, ewald (B,)),
    evaluated `el_chunk` walkers at a time to bound the kinetic engine's
    memory (`mode`, `partition_number`: hamiltonian.make_local_energy)."""
    el_fun = make_local_energy(network, supercell, mode=mode,
                               partition_number=partition_number, shard=shard)

    def batch_local_energy(params, data):
        n = data.shape[0]
        if not el_chunk or el_chunk <= 0 or n <= el_chunk:
            with profiling.annotate("el.chunk", 0):
                return el_fun(params, data)
        if n % el_chunk != 0:
            raise ValueError(
                f"optim.el_chunk={el_chunk} must divide the walker batch ({n})")
        parts = []
        for i, chunk in enumerate(data.split(el_chunk)):
            with profiling.annotate("el.chunk", i):
                parts.append(el_fun(params, chunk))
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    return batch_local_energy


def energy_statistics(ke: torch.Tensor, ew: torch.Tensor,
                      all_mean: Optional[Callable] = None):
    """(loss, AuxiliaryLossData) from per-walker kinetic and Ewald energies.

    Non-finite walkers (at a node or a coalescence point) are replaced by
    the finite-sample mean, so one bad walker costs nothing. `all_mean`
    averages a statistic over the data ranks.
    """
    pmean = all_mean or _identity
    e_l = ke + ew
    finite = torch.isfinite(e_l.real) & torch.isfinite(e_l.imag)
    n_finite = torch.clamp(pmean(torch.mean(finite.to(ew.dtype))), min=1e-12)
    zero = torch.zeros((), dtype=e_l.dtype, device=e_l.device)
    safe_mean = pmean(torch.mean(torch.where(finite, e_l, zero))) / n_finite
    e_l = torch.where(finite, e_l, safe_mean)
    ke_mean = pmean(torch.mean(torch.where(finite, ke, zero))) / n_finite
    ew_mean = pmean(torch.mean(torch.where(finite, ew, zero.real))) / n_finite
    ke = torch.where(finite, ke, ke_mean)
    ew = torch.where(finite, ew, ew_mean)
    local_mean = torch.mean(e_l)
    mean_e_l = pmean(local_mean)
    variance = pmean(torch.mean(torch.abs(e_l) ** 2)
                     - torch.abs(local_mean.real) ** 2)
    return mean_e_l.real, AuxiliaryLossData(
        variance=variance,
        local_energy=e_l,
        imaginary=mean_e_l.imag,
        kinetic=ke,
        ewald=ew,
        finite=finite.to(ew.dtype),
    )


def make_loss(network, supercell, el_chunk: int = 0, mode: str = "forward",
              clip_local_energy: float = 5.0, clip_type: str = "real",
              psi_chunk: int = 0, shard=None,
              all_mean: Optional[Callable] = None,
              partition_number: int = 3) -> Callable:
    """total_energy(params, data) -> (loss, AuxiliaryLossData), evaluated
    without autograd; total_energy.value_and_grad(params, data) ->
    ((loss, aux), grads), grads a tree like params holding the clipped
    covariance estimator of dE/dparams on this rank's walkers (the mean
    over the data ranks is the training step's to take).

    `mode` and `partition_number` choose the kinetic engine
    (hamiltonian.make_local_energy). `shard` splits the forward-Laplacian's
    tangent columns over the deriv ranks (E_L only: log psi and its gradient are computed whole on every
    rank). `psi_chunk` walkers at a time go through the backward pass.
    """
    batch_local_energy = make_batch_local_energy(
        network, supercell, el_chunk, mode, shard=shard,
        partition_number=partition_number)

    @torch.no_grad()
    def total_energy(params, data):
        return energy_statistics(*batch_local_energy(params, data),
                                 all_mean=all_mean)

    def gradient(params, data, loss, aux):
        """mean(Re(clip_diff * conj(d log psi / d params))) over this
        rank's walkers, walkers with a non-finite E_L left out."""
        ok = aux.finite != 0
        diff = aux.local_energy - loss
        clip_diff = clip_local_energy_diff(diff, clip_local_energy, clip_type,
                                           all_mean)
        clip_diff = torch.where(ok, clip_diff, torch.zeros_like(clip_diff))
        n = data.shape[0]
        chunk = psi_chunk if psi_chunk and 0 < psi_chunk < n else n
        if n % chunk != 0:
            raise ValueError(
                f"optim.psi_chunk={chunk} must divide the walker batch ({n})")
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        parts = zip(data.split(chunk), clip_diff.split(chunk), ok.split(chunk))
        for i, (x, cd, okc) in enumerate(parts):
            with profiling.annotate("gradient.chunk", i):
                with torch.enable_grad():
                    logpsi = network.logdet(leaves, x)
                    logpsi = torch.where(okc, logpsi, torch.zeros_like(logpsi))
                    surrogate = torch.sum((cd * torch.conj(logpsi)).real) / n
                surrogate.backward()  # adds this chunk's part to each leaf's grad
        return tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                         else t.grad, leaves)

    def value_and_grad(params, data):
        loss, aux = total_energy(params, data)
        return (loss, aux), gradient(params, data, loss, aux)

    total_energy.value_and_grad = value_and_grad
    total_energy.gradient = gradient
    return total_energy
