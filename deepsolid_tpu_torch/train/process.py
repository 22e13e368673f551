"""Run driver, inference path (optim.optimizer = 'none').

Mirrors deepsolid_tpu/train/process.py for inference: restore a
checkpoint (or initialize parameters and walkers), burn in, then per
iteration run the Metropolis sampler, evaluate the batch local energy
with the forward-Laplacian engine, write the train_stats CSV row and
adapt the proposal width. Training (KFAC, adam, pretraining) is not
ported yet.
"""

from __future__ import annotations

import datetime
import logging
import time
from typing import Callable, Optional

import numpy as np
import torch

from deepsolid_tpu_torch.device import resolve_device, set_full_precision
from deepsolid_tpu_torch.models.network import (
    NetworkConfig,
    make_network,
    param_shapes,
    params_from_jax,
)
from deepsolid_tpu_torch.sampling.init import init_electrons
from deepsolid_tpu_torch.sampling.mcmc import make_mcmc_step, update_mcmc_width
from deepsolid_tpu_torch.scf.free_electron import free_electron_klist
from deepsolid_tpu_torch.system.cell import Supercell
from deepsolid_tpu_torch.train.loss import make_loss
from deepsolid_tpu_torch.utils import checkpoint as checkpoint_lib
from deepsolid_tpu_torch.utils.writers import Writer

TRAIN_SCHEMA = ["energy", "variance", "pmove", "imaginary", "kinetic", "ewald",
                "nonfinite"]
_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve_klist(cfg, sc: Supercell):
    if cfg.system.klist_policy == "explicit":
        if cfg.system.klist is None:
            raise ValueError("klist_policy='explicit' requires system.klist")
        return tuple(np.asarray(k) for k in cfg.system.klist)
    return free_electron_klist(sc, twist=tuple(cfg.network.twist),
                               policy=cfg.system.klist_policy)


def build_network(cfg, sc: Supercell):
    detnet = dict(cfg.network.detnet)
    detnet["hidden_dims"] = tuple(tuple(h) for h in detnet["hidden_dims"])
    return make_network(sc, resolve_klist(cfg, sc), NetworkConfig(**detnet))


def process(cfg, max_iterations: Optional[int] = None, device="cuda",
            on_iteration: Optional[Callable] = None):
    """Run inference per `cfg` on `device`.

    Returns (params, data, energy per primitive cell of the last
    iteration). `on_iteration(t, row, seconds)` receives each iteration's
    CSV row and its wall-clock split {'mcmc', 'local_energy', 'step'}.
    """
    if cfg.optim.optimizer != "none":
        raise NotImplementedError(
            f"optim.optimizer={cfg.optim.optimizer!r}: only inference "
            "('none') is ported; KFAC/adam training is the next slice")
    device = resolve_device(device)
    set_full_precision()
    dtype = _DTYPES[cfg.precision]
    sc = cfg.system.cell
    if not isinstance(sc, Supercell):
        raise ValueError("cfg.system.cell must be a Supercell")
    net = build_network(cfg, sc)

    save_path = checkpoint_lib.create_save_path(cfg.log.save_path)
    restore_file = (checkpoint_lib.find_last_checkpoint(save_path)
                    or checkpoint_lib.find_last_checkpoint(cfg.log.restore_path))
    if cfg.log.restore_path and not restore_file:
        logging.warning("log.restore_path=%s is set but holds no usable "
                        "checkpoint; starting from scratch.", cfg.log.restore_path)

    seed = 666 if cfg.debug.deterministic else int(1e6 * time.time()) % (2**31)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    width = cfg.mcmc.move_width
    if restore_file:
        t_init, data, params, opt_state, ckpt_width = checkpoint_lib.restore(
            restore_file, cfg.batch_size)
        want = param_shapes(net.init(np.random.default_rng(0)))
        if param_shapes(params) != want:
            raise ValueError(
                f"Checkpoint {restore_file} holds parameters for a different "
                "network architecture than this config builds.")
        data = torch.as_tensor(data, dtype=dtype, device=device)
        if ckpt_width is not None:
            width = float(ckpt_width)
        logging.info("Restored checkpoint %s", restore_file)
    else:
        t_init, opt_state = 0, None
        data = init_electrons(gen, sc, sc.nelec, cfg.batch_size,
                              cfg.mcmc.init_width, dtype=dtype, device=device)
        params = net.init(np.random.default_rng(
            888 if cfg.debug.deterministic else seed))
    params = params_from_jax(params, device=device, dtype=dtype)

    mcmc_step = make_mcmc_step(net.slogdet, sc.lattice, steps=cfg.mcmc.steps)
    total_energy = make_loss(net, sc, el_chunk=cfg.optim.el_chunk,
                             mode=cfg.optim.laplacian_mode)

    iterations = cfg.optim.iterations
    if max_iterations is not None:
        iterations = min(iterations, max_iterations)
    scale = sc.scale
    pmoves = np.zeros(cfg.mcmc.adapt_frequency)
    energy = None
    with torch.no_grad():
        if t_init == 0 and cfg.mcmc.burn_in > 0:
            logging.info("Burning in MCMC chain for %d steps", cfg.mcmc.burn_in)
            for _ in range(cfg.mcmc.burn_in):
                data, _ = mcmc_step(params, data, gen, width)
        if opt_state is not None:
            t_init = 0  # a restored inference run restarts its own clock

        with Writer(name=cfg.log.stats_file_name, schema=TRAIN_SCHEMA,
                    directory=save_path, iteration_key="step") as writer:
            for t in range(t_init, iterations):
                t0 = time.perf_counter()
                data, pmove = mcmc_step(params, data, gen, width)
                pmove = float(pmove)  # waits for the sampler
                t1 = time.perf_counter()
                loss, aux = total_energy(params, data)
                energy = float(loss) / scale
                kinetic = float(torch.mean(aux.kinetic.real)) / scale
                row = {
                    "energy": energy,
                    "variance": float(aux.variance) / scale**2,
                    "pmove": pmove,
                    "imaginary": float(aux.imaginary) / scale,
                    "kinetic": kinetic,
                    "ewald": energy - kinetic,
                    "nonfinite": 1.0 - float(torch.mean(aux.finite)),
                }
                t2 = time.perf_counter()
                if row["nonfinite"] > 0.01:
                    logging.warning(
                        "Step %d: %.1f%% of walkers had non-finite local "
                        "energies (masked out)", t, 100.0 * row["nonfinite"])
                if t % cfg.log.stats_frequency == 0:
                    logging.info(
                        "%s Step %05d: %.4f E_h, variance=%.4f, pmove=%.2f, "
                        "imag=%.4f, kinetic=%.4f, ewald=%.4f",
                        datetime.datetime.now(), t, energy, row["variance"],
                        pmove, row["imaginary"], kinetic, row["ewald"])
                    writer.write(t, **row)
                width, pmoves = update_mcmc_width(
                    t, width, pmoves, pmove, cfg.mcmc.adapt_frequency)
                if on_iteration is not None:
                    on_iteration(t, row, {"mcmc": t1 - t0,
                                          "local_energy": t2 - t1,
                                          "step": t2 - t0})
    return params, data, energy
