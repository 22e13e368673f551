"""The run loop: pretraining, then inference (optim.optimizer = 'none'),
KFAC or adam training.

Mirrors deepsolid_tpu/train/process.py: build the orbital source when
the run pretrains or takes its k-list from the SCF (a basis with
klist_policy 'auto'), build the network on that source's occupied
k-list, restore a checkpoint (or initialize parameters and walkers),
pretrain a run that starts from scratch and save it as step 0, burn in
(from scratch, or restored from that step-0 handoff), then per iteration
run the sampler (all-electron Metropolis, or per
`mcmc.importance_sampling` / `mcmc.one_electron` Langevin or one-electron
moves), evaluate the batch local energy with the kinetic engine of
`optim.laplacian_mode` and, when training, the gradient estimator and the update
('kfac': curvature update, natural-gradient step and, under adaptive
damping, the loss again on the same walkers; 'adam': the optax chain);
under `debug.check_nan` discard an iteration that leaves a non-finite
parameter or loss; write the train_stats CSV row (with the complex
polarization under `log.complex_polarization`), structure_factor.csv
and local_energies.csv when asked, adapt the proposal width and save
checkpoints. With `log.trace_path` a torch.profiler trace of iterations
[log.trace_start, + log.trace_steps) (counted from this run's first) is
written there; under any profiler each iteration and its phases (`mcmc`,
`local_energy`, `gradient`, `stats`, `checkpoint`) are named spans
(`utils/profiling.annotate`), closed before `on_iteration` is called.

Several ranks (torch.distributed initialized by the caller, see
parallel.run_ranks) run this same function, SPMD: `parallel.deriv_devices`
consecutive ranks share one slice of the walker batch and split the 3N
tangent columns of its local energy among them; the remaining factor of
the world is the data axis, which splits `batch_size` and over which
statistics and gradients are averaged. Only rank 0 writes files.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from deepsolid_tpu_torch import observables as observables_lib
from deepsolid_tpu_torch import parallel
from deepsolid_tpu_torch.device import resolve_device, set_full_precision
from deepsolid_tpu_torch.models.network import (
    NetworkConfig,
    make_network,
    param_shapes,
    params_from_jax,
    params_to_numpy,
)
from deepsolid_tpu_torch.optim import adam as adam_lib
from deepsolid_tpu_torch.optim import kfac as kfac_lib
from deepsolid_tpu_torch.sampling.init import init_electrons
from deepsolid_tpu_torch.sampling.mcmc import make_mcmc_step, update_mcmc_width
from deepsolid_tpu_torch.scf.free_electron import free_electron_klist
from deepsolid_tpu_torch.system.cell import Supercell
from deepsolid_tpu_torch.train import pretrain as pretrain_lib
from deepsolid_tpu_torch.train.loss import chunk_batch_fn, make_loss
from deepsolid_tpu_torch.utils import checkpoint as checkpoint_lib
from deepsolid_tpu_torch.utils import profiling
from deepsolid_tpu_torch.utils.tree import tree_leaves
from deepsolid_tpu_torch.utils.writers import Writer

TRAIN_SCHEMA = ["energy", "variance", "pmove", "imaginary", "kinetic", "ewald",
                "nonfinite"]
_DTYPES = {"float32": torch.float32, "float64": torch.float64}
_DATA_SEED_STRIDE = 1000003  # folds the data index into a rank's seed


def resolve_klist(cfg, sc: Supercell):
    if cfg.system.klist_policy == "explicit":
        if cfg.system.klist is None:
            raise ValueError("klist_policy='explicit' requires system.klist")
        return tuple(np.asarray(k) for k in cfg.system.klist)
    return free_electron_klist(sc, twist=tuple(cfg.network.twist),
                               policy=cfg.system.klist_policy)


def build_network(cfg, sc: Supercell, klist_override=None):
    detnet = dict(cfg.network.detnet)
    detnet["hidden_dims"] = tuple(tuple(h) for h in detnet["hidden_dims"])
    klist = klist_override if klist_override is not None else resolve_klist(cfg, sc)
    return make_network(sc, klist, NetworkConfig(**detnet))


def wants_pretrain(cfg) -> bool:
    return cfg.pretrain.iterations > 0 and cfg.pretrain.method != "none"


def orbital_source(cfg, sc: Supercell):
    """The orbital source, when the run pretrains or takes the network's
    occupied k-list from the SCF (a basis with klist_policy 'auto'): the
    network's Bloch phases must use the source's k-list (the reference
    gets both from HF, process.py:87,107-113). None otherwise."""
    if wants_pretrain(cfg) or (cfg.system.basis and cfg.system.klist_policy == "auto"):
        return pretrain_lib.make_orbital_source(cfg, sc)
    return None


def _same_structure(a, b) -> bool:
    """Whether two optimizer states have the same tree and leaf shapes."""
    if hasattr(a, "_fields") or hasattr(b, "_fields"):
        return (getattr(a, "_fields", None) == getattr(b, "_fields", None)
                and all(_same_structure(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_structure(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
                and len(a) == len(b)
                and all(_same_structure(x, y) for x, y in zip(a, b)))
    return np.shape(a) == np.shape(b)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _all_finite(tensors) -> bool:
    return bool(torch.stack([torch.isfinite(t).all() for t in tensors]).all())


def _append_row(path: str, t: int, values) -> None:
    with open(path, "a") as f:
        f.write(f"{t}," + ",".join(values) + "\n")


def process(cfg, max_iterations: Optional[int] = None, device="cuda",
            on_iteration: Optional[Callable] = None,
            on_pretrain: Optional[Callable] = None):
    """Run pretraining and inference, KFAC or adam training per `cfg` on
    `device`.

    Returns (params, data, energy per primitive cell of the last
    iteration); `data` is this rank's walkers. `on_iteration(t, row,
    seconds)` receives each iteration's CSV row, plus 'local_energy' (this
    rank's per-walker E_L, a tensor) and, when training, 'grad_norm' (and
    for KFAC 'damping', 'rho' and 'optimizer_step'), and the iteration's
    wall-clock split {'mcmc', 'local_energy', 'gradient', 'update',
    'step'}, for KFAC also 'curvature' and, on an iteration whose damping
    is adapted, 'adapt' (the loss on the same walkers again).
    `on_pretrain(t, loss, pmove, seconds)` receives each pretraining
    iteration's loss, acceptance and split {'loss_grad', 'update', 'mcmc',
    'step'} (see train/pretrain.py).
    """
    optimizer_name = cfg.optim.optimizer
    if optimizer_name not in ("kfac", "adam", "none"):
        raise ValueError(f"Unknown optimizer: {optimizer_name}")
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)  # the kernels launch on the current card
    set_full_precision()
    dtype = _DTYPES[cfg.precision]
    sc = cfg.system.cell
    if not isinstance(sc, Supercell):
        raise ValueError("cfg.system.cell must be a Supercell")
    if cfg.system.get("ndim", 3) != 3:
        raise ValueError(f"system.ndim={cfg.system.ndim}: only 3 is supported")

    deriv_devices = int(cfg.get("parallel", {}).get("deriv_devices", 1))
    if deriv_devices > 1:
        if cfg.optim.laplacian_mode != "forward":
            raise ValueError("parallel.deriv_devices > 1 requires "
                             "optim.laplacian_mode='forward'")
        n_tangents = 3 * sum(sc.nelec)
        if n_tangents % deriv_devices != 0:
            raise ValueError(
                f"parallel.deriv_devices={deriv_devices} must divide the "
                f"3N={n_tangents} Laplacian tangent columns")
    mesh = parallel.make_mesh(deriv_devices, device)
    if cfg.batch_size % mesh.num_data != 0:
        raise ValueError(f"Batch size {cfg.batch_size} not divisible by the "
                         f"{mesh.num_data}-way data axis")
    local_batch = cfg.batch_size // mesh.num_data
    writes = mesh.rank == 0
    logging.info("Starting QMC on rank %d of %d (%d data x %d deriv ranks)",
                 mesh.rank, mesh.world_size, mesh.num_data, deriv_devices)

    source = orbital_source(cfg, sc)
    net = build_network(cfg, sc, klist_override=source.klist if source else None)

    save_path = (checkpoint_lib.create_save_path(cfg.log.save_path) if writes
                 else cfg.log.save_path)
    restore_file = (checkpoint_lib.find_last_checkpoint(save_path)
                    or checkpoint_lib.find_last_checkpoint(cfg.log.restore_path))
    if cfg.log.restore_path and not restore_file:
        logging.warning("log.restore_path=%s is set but holds no usable "
                        "checkpoint; starting from scratch.", cfg.log.restore_path)

    seed = 666 if cfg.debug.deterministic else int(1e6 * time.time()) % (2**31)
    seed = mesh.broadcast_int(seed)  # every rank agrees on rank 0's seed
    # the deriv ranks of one data index draw the same walkers and moves
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + _DATA_SEED_STRIDE * mesh.data_index)

    width = cfg.mcmc.move_width
    opt_state_ckpt = None
    if restore_file:
        t_init, data, params, opt_state_ckpt, ckpt_width = checkpoint_lib.restore(
            restore_file, cfg.batch_size)
        want = param_shapes(net.init(np.random.default_rng(0)))
        if param_shapes(params) != want:
            raise ValueError(
                f"Checkpoint {restore_file} holds parameters for a different "
                "network architecture than this config builds.")
        lo = mesh.data_index * local_batch
        data = torch.as_tensor(data[lo:lo + local_batch], dtype=dtype, device=device)
        if ckpt_width is not None:
            width = float(ckpt_width)
        logging.info("Restored checkpoint %s", restore_file)
    else:
        t_init = 0
        data = init_electrons(gen, sc, sc.nelec, local_batch,
                              cfg.mcmc.init_width, dtype=dtype, device=device)
        params = net.init(np.random.default_rng(
            888 if cfg.debug.deterministic else seed))
    params = params_from_jax(params, device=device, dtype=dtype)
    # What the run does before its first iteration, decided here once. A
    # run from scratch (or from a step -1 checkpoint) pretrains and burns
    # in. A handoff checkpoint, step 0 with no optimizer state as
    # pretraining saves it below, starts a training run at iteration 0 and
    # burns in without pretraining again: the JAX package restores it at
    # t = 1 and skips the burn-in, a departure pinned in
    # tests/test_torch_handoff.py. Any other restore resumes at t + 1 and
    # does neither, and a restored inference run restarts its own clock.
    handoff = (restore_file is not None and t_init == 1 and opt_state_ckpt is None
               and optimizer_name != "none")
    pretrains = t_init == 0 and wants_pretrain(cfg)
    burns_in = (t_init == 0 or handoff) and cfg.mcmc.burn_in > 0
    if handoff or (optimizer_name == "none" and opt_state_ckpt is not None):
        t_init = 0

    psi_chunk = cfg.optim.get("psi_chunk", 0)
    mcmc_step = make_mcmc_step(
        chunk_batch_fn(net.slogdet, psi_chunk), sc.lattice, steps=cfg.mcmc.steps,
        importance_network=net.slogdet if cfg.mcmc.importance_sampling else None,
        one_electron_moves=cfg.mcmc.one_electron, psi_chunk=psi_chunk)
    total_energy = make_loss(
        net, sc, el_chunk=cfg.optim.el_chunk, mode=cfg.optim.laplacian_mode,
        clip_local_energy=cfg.optim.clip_el, clip_type=cfg.optim.clip_type,
        psi_chunk=psi_chunk, shard=mesh.shard, all_mean=mesh.all_mean,
        partition_number=cfg.optim.get("partition_number", 3))

    optimizer = opt_state = None
    state_to_numpy = adam_lib.state_to_numpy
    if optimizer_name == "adam":
        optimizer = adam_lib.Adam.from_config(cfg)
        opt_state = optimizer.init(params)
        if opt_state_ckpt is not None:
            restored = adam_lib.state_from_numpy(opt_state_ckpt, device, dtype)
            if _same_structure(restored, opt_state):
                opt_state = restored
            else:
                logging.warning(
                    "Checkpoint %s holds the state of another optimizer; "
                    "adam starts from a fresh state.", restore_file)
    elif optimizer_name == "kfac":
        optimizer = kfac_lib.KfacOptimizer.from_config(
            cfg, net, adam_lib.learning_rate_schedule(cfg), mesh)
        opt_state = optimizer.init(params, data)
        state_to_numpy = kfac_lib.state_to_numpy
        if kfac_lib.is_kfac_state(opt_state_ckpt):
            # top-level merge, so a checkpoint written before the state
            # gained a key (the adaptive damping's) still restores
            opt_state = kfac_lib.merge_restored(
                opt_state, kfac_lib.state_from_numpy(opt_state_ckpt, device, dtype))
            logging.info("Restored the KFAC state at optimizer step %d",
                         int(opt_state["step"]))
        elif opt_state_ckpt is not None:
            logging.warning(
                "Checkpoint %s holds the state of another optimizer; "
                "kfac starts from a fresh state.", restore_file)
    schema = list(TRAIN_SCHEMA)
    log_damping = (optimizer_name == "kfac"
                   and cfg.optim.kfac.get("adaptive_damping", False))
    if log_damping:
        schema.append("damping")
    polarization_fn = structure_factor_fn = None
    if cfg.log.complex_polarization:
        schema.append("complex_polarization")
        polarization_fn = observables_lib.make_complex_polarization(
            sc, all_mean=mesh.all_mean)
    if cfg.log.structure_factor:
        structure_factor_fn = observables_lib.make_structure_factor(
            sc, all_mean=mesh.all_mean)

    iterations = cfg.optim.iterations
    if max_iterations is not None:
        iterations = min(iterations, max_iterations)
    scale = sc.scale
    pmoves = np.zeros(cfg.mcmc.adapt_frequency)
    energy = None
    time_of_last_ckpt = time.time()

    def save_checkpoint(t):
        global_data = mesh.gather_data(data)  # every rank takes part
        if writes:
            checkpoint_lib.save(
                save_path, t, global_data.numpy(), params_to_numpy(params),
                state_to_numpy(opt_state), np.asarray(width))

    with torch.no_grad():
        if pretrains:
            params, data = pretrain_lib.pretrain(
                cfg, sc, net, params, data, gen, source=source,
                all_mean=mesh.all_mean, on_pretrain=on_pretrain)
            global_data = mesh.gather_data(data)  # every rank takes part
            if writes:
                checkpoint_lib.save(save_path, 0, global_data.numpy(),
                                    params_to_numpy(params), None, None)

        if burns_in:
            logging.info("Burning in MCMC chain for %d steps", cfg.mcmc.burn_in)
            for _ in range(cfg.mcmc.burn_in):
                data, _ = mcmc_step(params, data, gen, width)

        # a window of the run's iterations under torch.profiler, opt-in
        tracer = profiling.StepTracer(cfg.log.get("trace_path", ""),
                                      start=cfg.log.get("trace_start", 10),
                                      steps=cfg.log.get("trace_steps", 5))
        with (Writer(name=cfg.log.stats_file_name, schema=schema,
                     directory=save_path, iteration_key="step")
              if writes else contextlib.nullcontext()) as writer, \
                contextlib.closing(tracer):
            for t in range(t_init, iterations):
                tracer.step(t - t_init)
                # the iteration's span; its phases each close before
                # on_iteration, which may start or stop a profiler
                with profiling.annotate("iteration", t):
                    if cfg.debug.check_nan:
                        # every step returns new tensors and writes into
                        # none, so these references are the state before it
                        prev = (params, data, opt_state)
                    seconds = {}
                    t0 = time.perf_counter()
                    with profiling.annotate("mcmc"):
                        data, pmove = mcmc_step(params, data, gen, width)
                        pmove = float(mesh.all_mean(pmove))  # waits for the sampler
                    t1 = time.perf_counter()
                    with profiling.annotate("local_energy"):
                        loss, aux = total_energy(params, data)
                        energy = float(loss) / scale
                        kinetic = float(mesh.all_mean(torch.mean(aux.kinetic.real))) / scale
                        row = {
                            "energy": energy,
                            "variance": float(aux.variance) / scale**2,
                            "pmove": pmove,
                            "imaginary": float(aux.imaginary) / scale,
                            "kinetic": kinetic,
                            "ewald": energy - kinetic,
                            "nonfinite": 1.0 - float(mesh.all_mean(torch.mean(aux.finite))),
                        }
                    t2 = time.perf_counter()
                    seconds.update(mcmc=t1 - t0, local_energy=t2 - t1)
                    extra = {"local_energy": aux.local_energy}
                    if optimizer is not None:
                        with profiling.annotate("gradient"):
                            grads = total_energy.gradient(params, data, loss, aux)
                            grads = adam_lib.tree_map(mesh.all_mean, grads)
                            extra["grad_norm"] = float(adam_lib.global_norm(grads))
                        t3 = time.perf_counter()
                        seconds["gradient"] = t3 - t2
                    if optimizer_name == "adam":
                        updates, opt_state = optimizer.update(grads, opt_state)
                        params = adam_lib.apply_updates(params, updates)
                        _sync(device)
                        seconds["update"] = time.perf_counter() - t3
                    elif optimizer_name == "kfac":
                        # the state's own step counter (not t) schedules the
                        # learning rate, the curvature and inverse refreshes
                        # and the damping adaptation: it continues a
                        # restored state's
                        kfac_step = int(opt_state["step"])
                        mark = [t3]

                        def lap(name):
                            _sync(device)
                            now = time.perf_counter()
                            seconds[name], mark[0] = now - mark[0], now

                        params, opt_state = optimizer.step(
                            params, opt_state, grads, data, loss=loss,
                            loss_fn=total_energy, lap=lap)
                        extra.update(optimizer_step=kfac_step,
                                     damping=float(opt_state["damping"]),
                                     rho=float(opt_state["rho"]))
                        if log_damping:
                            row["damping"] = extra["damping"]
                    seconds["step"] = time.perf_counter() - t0
                    with profiling.annotate("stats"):
                        if cfg.debug.check_nan and not _all_finite(
                                tree_leaves(params) + [loss]):
                            # discard the iteration (no row, no width
                            # update, no checkpoint) and go on from the
                            # state before it; the generator runs on
                            logging.warning("Non-finite update at step %d; retrying", t)
                            params, data, opt_state = prev
                            continue
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
                            if polarization_fn is not None:
                                row["complex_polarization"] = complex(
                                    polarization_fn(data)).real
                            if writer is not None:
                                writer.write(t, **row)
                        # every rank takes part in the means and the gather
                        if structure_factor_fn is not None:
                            sk = structure_factor_fn(data).cpu().numpy()
                            if writes:
                                _append_row(os.path.join(save_path, "structure_factor.csv"),
                                            t, (str(v) for v in sk))
                        if cfg.log.local_energies and t % cfg.log.stats_frequency == 0:
                            # the global batch, Re and Im interleaved
                            el = torch.view_as_complex(mesh.gather_data(
                                torch.view_as_real(aux.local_energy)).contiguous()).numpy()
                            if writes:
                                _append_row(os.path.join(save_path, "local_energies.csv"),
                                            t, (f"{v.real:.10g},{v.imag:.10g}" for v in el))
                        width, pmoves = update_mcmc_width(
                            t, width, pmoves, pmove, cfg.mcmc.adapt_frequency)
                    if on_iteration is not None:
                        on_iteration(t, {**row, **extra}, seconds)

                    # rank 0's clock decides, so every rank joins the gather
                    due = mesh.broadcast_int(int(
                        time.time() - time_of_last_ckpt > cfg.log.save_frequency * 60
                        or t >= iterations - 1
                        or (cfg.log.save_frequency_in_step > 0
                            and t % cfg.log.save_frequency_in_step == 0)))
                    if due:
                        with profiling.annotate("checkpoint"):
                            if optimizer is not None:
                                save_checkpoint(t)
                        time_of_last_ckpt = time.time()
    return params, data, energy
