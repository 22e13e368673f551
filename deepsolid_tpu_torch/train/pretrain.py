"""Pretraining the ansatz orbitals against an orbital source.

Mirrors deepsolid_tpu/train/pretrain.py (reference semantics:
DeepSolid/pretrain.py:43-302): the network's orbital matrices are fitted
to the source's target orbitals with adam, one iteration being
  1. the orbital-matching loss and its gradient on this rank's walkers,
     `psi_chunk` walkers at a time (the targets are evaluated without
     autograd; the gradient runs through the network's orbitals only),
     both averaged over the data ranks;
  2. the adam update at `pretrain.lr` (optax.adam's defaults);
  3. `pretrain.steps` Metropolis moves of width 0.02, sampling |psi|^2 of
     the network ('net', through the Gauss-Jordan kernel) or of the
     source's determinant ('hf').
The deriv ranks of one data index hold the same walkers and draw the
same moves (the caller seeds their generators alike), so they stay equal.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional

import torch

from deepsolid_tpu_torch.optim import adam as adam_lib
from deepsolid_tpu_torch.sampling.mcmc import draw_move, mh_update
from deepsolid_tpu_torch.scf.interface import PlaneWaveOrbitals
from deepsolid_tpu_torch.train.loss import chunk_batch_fn
from deepsolid_tpu_torch.utils.tree import tree_map

PRETRAIN_STDDEV = 0.02  # the Metropolis width of pretraining, as the reference's
LOG_EVERY = 100


def make_orbital_source(cfg, sc):
    """The pretraining orbital source.

    Periodic Hartree-Fock in a GTO basis (scf/hf.py) when a basis is
    configured; plane waves when the basis is empty or 'planewave'. An
    unsupported basis or element is a hard error: a requested basis never
    silently degrades the pretraining targets.
    """
    basis = cfg.system.get("basis")
    if basis and basis.lower() not in ("planewave", "plane-wave", "pw"):
        from deepsolid_tpu_torch.scf import hf as hf_lib

        try:
            return hf_lib.ScfOrbitals.build(
                sc, basis=basis, twist=tuple(cfg.network.twist),
                level=cfg.pretrain.get("scf", "core"))
        except NotImplementedError as e:
            raise NotImplementedError(
                f"Requested basis {basis!r} is not supported by the native "
                f"SCF ({e}). Set cfg.system.basis='planewave' to opt into "
                "plane-wave pretraining targets instead.") from e
    return PlaneWaveOrbitals(sc, twist=tuple(cfg.network.twist),
                             policy=cfg.system.klist_policy)


def _block_diag_targets(target: List[torch.Tensor]) -> torch.Tensor:
    """Per-spin target matrices embedded block-diagonally (the full_det
    case, reference: pretrain.py:79-89)."""
    up, dn = target
    batch, na, nb = up.shape[0], up.shape[1], dn.shape[1]
    top = torch.cat([up, up.new_zeros((batch, na, nb))], dim=-1)
    bot = torch.cat([dn.new_zeros((batch, nb, na)), dn], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _abs2(z: torch.Tensor) -> torch.Tensor:
    return z.real * z.real + z.imag * z.imag


def make_loss_per_walker(net, source, full_det: bool) -> Callable:
    """loss_per_walker(params, x) -> (B,): the mean squared difference of
    the network's orbital matrices (every determinant) from the source's,
    averaged over the spin channels."""

    def loss_per_walker(params, x):
        predict = net.orbitals(params, x)
        with torch.no_grad():
            target = source.orbital_mats(x)
        if full_det and len(target) == 2:
            target = [_block_diag_targets(target)]
        losses = [torch.mean(_abs2(t[:, None] - pr), dim=tuple(range(1, pr.ndim)))
                  for t, pr in zip(target, predict)]
        return sum(losses) / len(losses)

    return loss_per_walker


def make_value_and_grad(loss_per_walker: Callable, psi_chunk: int = 0,
                        all_mean: Optional[Callable] = None) -> Callable:
    """value_and_grad(params, data) -> (loss, grads): the batch mean of
    the per-walker loss and its gradient, both averaged over the data
    ranks when `all_mean` is given. `psi_chunk` walkers at a time go
    through the backward pass (chunk_batch_fn's contract: it must divide
    the batch), so only one chunk's activations are alive at a time."""
    pmean = all_mean or (lambda t: t)

    def value_and_grad(params, data):
        n = data.shape[0]
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)

        def chunk_loss(p, x):
            with torch.enable_grad():
                per_walker = loss_per_walker(p, x)
                (per_walker.sum() / n).backward()  # adds into each leaf's grad
            return per_walker.detach()

        per_walker = chunk_batch_fn(chunk_loss, psi_chunk)(leaves, data)
        grads = tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                         else pmean(t.grad), leaves)
        return pmean(torch.mean(per_walker)), grads

    return value_and_grad


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_pretrain_step(cfg, sc, net, source, all_mean: Optional[Callable] = None,
                       draw: Callable = draw_move) -> tuple:
    """(optimizer, step) with step(params, data, opt_state, gen) ->
    (params, data, opt_state, loss, pmove, seconds); `draw(gen, x)` gives
    each Metropolis move's proposal normals and acceptance uniforms."""
    pmean = all_mean or (lambda t: t)
    psi_chunk = int(cfg.optim.get("psi_chunk", 0))
    method = cfg.pretrain.method
    if method == "net":
        sample = chunk_batch_fn(net.slogdet, psi_chunk)
    elif method == "hf":
        sample = chunk_batch_fn(lambda p, x: source.slogdet(x), psi_chunk)
    else:
        raise ValueError(f"Unknown pretrain method: {method}")
    lr = float(cfg.pretrain.lr)
    optimizer = adam_lib.Adam(
        lambda count: torch.full_like(count, lr, dtype=torch.float64))
    value_and_grad = make_value_and_grad(
        make_loss_per_walker(net, source, cfg.network.detnet.full_det),
        psi_chunk, all_mean)
    nsteps = max(1, int(cfg.pretrain.steps))
    latvec = sc.lattice

    def step(params, data, opt_state, gen):
        seconds = {}
        t0 = time.perf_counter()
        mark = [t0]

        def lap(name):
            _sync(data.device)
            now = time.perf_counter()
            seconds[name], mark[0] = now - mark[0], now

        loss, grads = value_and_grad(params, data)
        lap("loss_grad")
        updates, opt_state = optimizer.update(grads, opt_state)
        params = adam_lib.apply_updates(params, updates)
        lap("update")
        with torch.no_grad():
            def f(x):
                return sample(params, x)

            lp = 2.0 * f(data)
            num_accepts = torch.zeros((), dtype=torch.int64, device=data.device)
            for _ in range(nsteps):
                noise, uniform = draw(gen, data)
                data, lp, num_accepts = mh_update(f, data, lp, num_accepts, latvec,
                                                  PRETRAIN_STDDEV, noise, uniform)
            pmove = pmean(num_accepts.to(data.dtype) / (nsteps * data.shape[0]))
        lap("mcmc")
        seconds["step"] = mark[0] - t0
        return params, data, opt_state, loss, pmove, seconds

    return optimizer, step


def pretrain(cfg, sc, net, params, data, gen, source=None,
             all_mean: Optional[Callable] = None,
             on_pretrain: Optional[Callable] = None):
    """Runs cfg.pretrain.iterations of orbital matching on this rank's
    walkers `data`. Returns (params, data).

    `on_pretrain(t, loss, pmove, seconds)` receives each iteration's loss
    and acceptance (floats) and its wall-clock split {'loss_grad',
    'update', 'mcmc', 'step'}.
    """
    source = source if source is not None else make_orbital_source(cfg, sc)
    optimizer, step = make_pretrain_step(cfg, sc, net, source, all_mean)
    opt_state = optimizer.init(params)
    iterations = int(cfg.pretrain.iterations)
    for t in range(iterations):
        params, data, opt_state, loss, pmove, seconds = step(
            params, data, opt_state, gen)
        if on_pretrain is not None:
            on_pretrain(t, float(loss), float(pmove), seconds)
        if t % LOG_EVERY == 0 or t == iterations - 1:
            logging.info("Pretrain iter %05d: loss=%.6f pmove=%.2f",
                         t, float(loss), float(pmove))
    return params, data
