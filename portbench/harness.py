"""One run of a cell: deepsolid_tpu_torch's production training loop,
`train.process.process`, driven from a starting checkpoint made from the
seed, timed over a window of whole iterations, optionally profiled, and
checked against the plain reference.

The harness touches the program only from outside: it builds the
program's config from the cell's files, hands `process()` an
`on_iteration` callback, and wraps four functions the loop calls
(`make_mcmc_step`, `make_loss` as process.py imports them, the sampler's
accept-or-reject rule `sampling.mcmc._accept`, and `KfacOptimizer.step`)
to name their spans in the profiler's trace and to keep references to
what the reference needs: the sampler's last move (its walkers, their
proposals with the program's log|psi|, and the walkers it returned), the
loss and E_L, the first gradient and the parameters after the followed
steps. The callback raises `StopRun` at an iteration boundary to end the
loop, before the checkpoint that the loop would write after its last
iteration.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import check, spec, trace as trace_lib, window as window_lib
from portbench.reference.follow import follow


# the first training steps that the reference follows; its limits were set
# for two
FOLLOW_STEPS = 2
# the Bohr by which the seed jitters the starting walkers, so that no two
# rows of a batch tiled from a smaller checkpoint are equal
WALKER_JITTER = 0.02


class StopRun(Exception):
    """Raised from on_iteration to end process() at an iteration boundary."""


def process_start() -> float:
    """The process's start on the perf_counter clock (from /proc), or now
    where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


# ---- inputs ---------------------------------------------------------------------

def init_params(conf: dict, rng: np.random.Generator) -> dict:
    """Parameters drawn from the seed at the published scales (weights
    N(0, 1/d_in), biases N(0, 1), envelopes 1), for a configuration that
    names no checkpoint."""
    net = conf["network"]
    natom = len(conf["atoms"])
    n = spec.nelectron(conf)
    spins = [s for s in (n // 2, n - n // 2) if s]
    nch = len(spins)
    f1, f2 = 4 * natom, 4
    params = {"single": [], "double": [], "orbital": [], "envelope": []}

    def layer(d_in, d_out, bias=True):
        p = {"w": rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)}
        if bias:
            p["b"] = rng.standard_normal(d_out)
        return p

    hidden = net["hidden_dims"]
    for i, (h1, h2) in enumerate(hidden):
        params["single"].append(layer((nch + 1) * f1 + nch * f2, h1))
        if i < len(hidden) - 1:
            params["double"].append(layer(f2, h2))
        f1, f2 = h1, h2
    for s in spins:
        nparam = s * net["determinants"]
        params["orbital"].append(layer(f1, 2 * nparam, bias=False))
        params["envelope"].append({"pi": np.ones((natom, nparam)),
                                   "sigma": np.ones((natom, nparam))})
    return params


def _object(tree):
    out = np.empty((), dtype=object)
    out[()] = tree
    return out


def write_start(conf: dict, traffic: dict, seed: int, directory: Path) -> Path:
    """The run's starting checkpoint: the configuration's checkpoint with
    its walkers permuted by the seed, tiled to the batch and jittered by
    the seed (so that no two rows are equal), or, where it names none,
    parameters and walkers drawn from the seed (a handoff at step 0)."""
    rng = np.random.default_rng(seed)
    batch = traffic["batch_size"]
    if conf.get("checkpoint"):
        with np.load(spec.ROOT / conf["checkpoint"], allow_pickle=True) as z:
            t, data = int(z["t"]), z["data"]
            params, opt_state, width = z["params"], z["opt_state"], z["mcmc_width"]
    else:
        t = 0
        params, opt_state, width = (_object(init_params(conf, rng)), _object(None),
                                    _object(None))
        atoms = np.asarray([a["coords_bohr"] for a in conf["atoms"]])
        n = spec.nelectron(conf)
        data = (atoms[np.arange(n) % len(atoms)].reshape(-1)
                + rng.standard_normal((batch, 3 * n))).astype(np.float32)
    order = np.concatenate([rng.permutation(len(data))
                            for _ in range(-(-batch // len(data)))])[:batch]
    walkers = data[order] + WALKER_JITTER * rng.standard_normal(
        (batch, data.shape[1]))
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"qmcjax_ckpt_{t:06d}.npz"
    with open(path, "wb") as f:
        np.savez(f, t=t, data=walkers.astype(data.dtype), params=params,
                 opt_state=opt_state, mcmc_width=width)
    return path


def program_config(conf: dict, traffic: dict, workdir: Path):
    """deepsolid_tpu_torch's config of the cell: the solid built with the
    package's own cell API from the configuration's geometry, the k-list
    stated there, the network's widths, the traffic's optimizer and its
    settings, a restore from the run's starting checkpoint and no
    pretraining."""
    from deepsolid_tpu_torch import config as config_lib
    from deepsolid_tpu_torch.system import Atom, Cell, make_supercell

    cfg = config_lib.default()
    atoms = [Atom(a["symbol"], tuple(a["coords_bohr"]), charge=a["charge"])
             for a in conf["atoms"]]
    prim = Cell.from_atoms(atoms, np.asarray(conf["lattice_bohr"], np.float64))
    cfg.system.cell = make_supercell(prim, np.asarray(conf["supercell"]))
    cfg.system.basis = ""
    cfg.system.klist_policy = "explicit"
    cfg.system.klist = [np.asarray(k, np.float64) for k in conf["klist"]]
    for key, value in conf["network"].items():
        cfg.network.detnet[key] = (tuple(tuple(h) for h in value)
                                   if key == "hidden_dims" else value)
    cfg.precision = traffic["precision"]
    cfg.batch_size = traffic["batch_size"]
    cfg.optim.optimizer = traffic["optimizer"]
    cfg.optim.iterations = 10**9
    cfg.optim.laplacian_mode = traffic["laplacian_mode"]
    cfg.optim.el_chunk = traffic["el_chunk"]
    cfg.optim.psi_chunk = traffic["psi_chunk"]
    cfg.optim.clip_el = traffic["clip_el"]
    cfg.optim.lr.update(traffic.get("lr", {}))
    cfg.optim.kfac.update(traffic.get("kfac", {}))
    cfg.mcmc.steps = traffic["mcmc_steps"]
    cfg.mcmc.burn_in = conf["mcmc_burn_in"]
    cfg.pretrain.iterations = 0
    cfg.debug.deterministic = True
    cfg.log.save_path = str(workdir / "save")
    cfg.log.restore_path = str(workdir / "restore")
    cfg.log.stats_frequency = traffic["stats_frequency"]
    return cfg


# ---- the run --------------------------------------------------------------------

class Recorder:
    """The hooks around process(): spans, the window, what the reference
    needs of the first `follow` iterations."""

    def __init__(self, *, warmup, seconds, trace, trace_iterations, workdir, device):
        self.warmup = warmup
        self.seconds = seconds
        self.trace = trace
        self.trace_iterations = trace_iterations
        self.workdir = workdir
        self.device = device
        self.iterations = []
        self.steps = [{} for _ in range(FOLLOW_STEPS)]
        self.opened = self.closed = None
        self.window_n = None
        self.profile = None
        self.traced = None
        self.move = None
        self.probe = None
        self.in_kfac = False

    def _step(self):
        i = len(self.iterations)
        return self.steps[i] if i < FOLLOW_STEPS else None

    # wrappers of what process() calls
    def wrap_mcmc(self, make_mcmc_step):
        rec = self

        def make(*args, **kwargs):
            inner = make_mcmc_step(*args, **kwargs)

            def mcmc_step(params, data, gen, width):
                with torch.profiler.record_function("portbench.mcmc"):
                    data, pmove = inner(params, data, gen, width)
                if rec.move is None:
                    raise RuntimeError("the sampler made no move through mcmc._accept")
                # the last move: its walkers, proposals, the program's
                # 2 log|psi| there, and the walkers the sampler returned
                rec.probe, rec.move = (*rec.move, data), None
                return data, pmove

            return mcmc_step

        return make

    def wrap_accept(self, accept):
        rec = self

        def step(x1, x2, lp_1, lp_2, ratio, uniform, num_accepts):
            rec.move = (x1, x2, lp_2)
            return accept(x1, x2, lp_1, lp_2, ratio, uniform, num_accepts)

        return step

    def wrap_loss(self, make_loss):
        rec = self

        def make(*args, **kwargs):
            inner = make_loss(*args, **kwargs)

            def total_energy(params, data):
                name = "portbench.adapt" if rec.in_kfac else "portbench.local_energy"
                with torch.profiler.record_function(name):
                    loss, aux = inner(params, data)
                step = rec._step()
                if step is not None and not rec.in_kfac:
                    step.update(walkers=data, loss=loss, e_l=aux.local_energy,
                                probe=rec.probe)
                return loss, aux

            def gradient(params, data, loss, aux):
                with torch.profiler.record_function("portbench.gradient"):
                    return inner.gradient(params, data, loss, aux)

            total_energy.gradient = gradient
            total_energy.value_and_grad = inner.value_and_grad
            return total_energy

        return make

    def wrap_kfac_step(self, kfac_step):
        rec = self

        def step(opt, params, state, grads, data, loss=None, loss_fn=None, lap=None):
            rec.in_kfac = True
            try:
                with torch.profiler.record_function("portbench.kfac"):
                    new_params, new_state = kfac_step(opt, params, state, grads, data,
                                                      loss=loss, loss_fn=loss_fn, lap=lap)
            finally:
                rec.in_kfac = False
            record = rec._step()
            if record is not None:
                record.update(grads=grads, params=new_params)
            return new_params, new_state

        return step

    # the loop's callback
    def on_iteration(self, t, row, seconds):
        now = time.perf_counter()
        self.iterations.append({"t": t, "end": now, "seconds": dict(seconds),
                                "adapted": "adapt" in seconds,
                                "finite": bool(np.isfinite(row["energy"]))})
        i = len(self.iterations)
        if i == self.warmup:
            self.opened = now
        elif i > self.warmup and self.closed is None:
            if window_lib.closes(self.opened, now, self.seconds) and i >= FOLLOW_STEPS:
                self.closed, self.window_n = now, i - self.warmup
                if not self.trace:
                    raise StopRun
                self._start_profile(now)
        elif self.profile is not None and i - self.warmup - self.window_n >= self.trace_iterations:
            self._stop_profile(now)
            raise StopRun

    def _start_profile(self, now):
        from deepsolid_tpu_torch.ops.cuda import det_kernels, jet_kernels

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.shapes0 = (det_kernels.SHAPES.copy(), jet_kernels.SHAPES.copy())
        self.profile = torch.profiler.profile(activities=acts)
        self.profile.start()
        self.profile_start = time.perf_counter()

    def _stop_profile(self, now):
        from deepsolid_tpu_torch.ops.cuda import det_kernels, jet_kernels

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        end = time.perf_counter()
        self.profile.stop()
        path = self.workdir / "trace.json"
        self.profile.export_chrome_trace(str(path))
        self.traced = trace_lib.read(str(path), end - self.profile_start)
        path.unlink()
        self.traced["launches"] = {
            "b1": sorted((det_kernels.SHAPES - self.shapes0[0]).items()),
            "jet": sorted((jet_kernels.SHAPES - self.shapes0[1]).items())}
        self.profile = None


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", started: float = None, control: bool = False,
             faults: bool = False) -> dict:
    """One run; returns the result's fields and the records behind them."""
    from deepsolid_tpu_torch.optim import kfac as kfac_lib
    from deepsolid_tpu_torch.sampling import mcmc as mcmc_mod
    from deepsolid_tpu_torch.train import process as process_mod

    started = process_start() if started is None else started
    device = torch.device(device)
    conf, traffic = cell.config, cell.traffic
    workdir = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        start_ckpt = write_start(conf, traffic, seed, workdir / "restore")
        cfg = program_config(conf, traffic, workdir)
        rec = Recorder(warmup=traffic["warmup_iterations"], seconds=seconds,
                       trace=trace, trace_iterations=traffic["trace_iterations"],
                       workdir=workdir, device=device)
        saved = (process_mod.make_mcmc_step, process_mod.make_loss,
                 kfac_lib.KfacOptimizer.step, mcmc_mod._accept)
        process_mod.make_mcmc_step = rec.wrap_mcmc(saved[0])
        process_mod.make_loss = rec.wrap_loss(saved[1])
        kfac_lib.KfacOptimizer.step = rec.wrap_kfac_step(saved[2])
        mcmc_mod._accept = rec.wrap_accept(saved[3])
        if device.type == "cuda":
            torch.cuda.set_device(device)
            torch.empty(0, device=device)  # the allocator's statistics exist from here
            torch.cuda.reset_peak_memory_stats(device)
        try:
            process_mod.process(cfg, device=device, on_iteration=rec.on_iteration)
        except StopRun:
            pass
        finally:
            (process_mod.make_mcmc_step, process_mod.make_loss,
             kfac_lib.KfacOptimizer.step, mcmc_mod._accept) = saved
        if rec.closed is None:
            raise RuntimeError("the training loop ended before the window closed")
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

        warm = rec.iterations[rec.warmup - 1]["end"]
        in_window = rec.iterations[rec.warmup:rec.warmup + rec.window_n]
        record = {
            "batch": traffic["batch_size"], "precision": traffic["precision"],
            "config": conf, "traffic": traffic,
            "nelectron": spec.nelectron(conf),
            "setup_s": warm - started,
            "window": window_lib.summary(in_window, warm, rec.closed, traffic["batch_size"]),
            "window_iterations": in_window,
            "peak_bytes": peak, "trace": rec.traced,
            "launches": rec.traced["launches"] if rec.traced else None,
            "iterations": rec.iterations,
        }

        # the program's outputs, off the card; then its state is freed
        steps = rec.steps
        moves = [_to_cpu(s["probe"]) for s in steps]
        prog = {"loss": [float(s["loss"]) for s in steps],
                "e_l": [s["e_l"].detach().cpu() for s in steps],
                "logpsi": [lp_2 / 2 for _, _, lp_2, _ in moves],
                "moves": [(x1, x2, out) for x1, x2, _, out in moves]}
        if "grads" in steps[0]:
            prog.update(grads=_to_cpu(steps[0]["grads"]), params=_to_cpu(steps[-1]["params"]))
        walkers = [s["walkers"].detach().cpu() for s in steps]
        probes = [(x1, x2) for x1, x2, _, _ in moves]
        del rec, steps, moves
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

        t0 = time.perf_counter()
        dtype = {"float32": torch.float32, "float64": torch.float64}[traffic["precision"]]
        ref = follow(conf, traffic, start_ckpt, walkers, probes, dtype=dtype, device=device)
        scale, chunk = spec.cells(conf), traffic["el_chunk"]
        values = check.numbers(prog, ref, scale, chunk)
        correct, rows = check.judge(values, cell.limits)
        record.update(correct=correct, checks=rows, reference_s=time.perf_counter() - t0,
                      diagnostics=check.diagnostics(prog, ref, scale, chunk))
        if control:
            # the reference in the nearest precision below the cell's, in the
            # program's place: TF32 products for float32, float32 for float64
            t0 = time.perf_counter()
            ctl = follow(conf, traffic, start_ckpt, walkers, probes, dtype=torch.float32,
                         device=device, tf32=traffic["precision"] == "float32")
            record["control"] = check.numbers(ctl, ref, scale, chunk)
            record["control_s"] = time.perf_counter() - t0
        if faults:
            t0 = time.perf_counter()
            half = follow(conf, traffic, start_ckpt, walkers, probes, dtype=dtype,
                          device=device, half_batch=True)
            record["fault_half_batch"] = check.numbers(half, ref, scale, chunk)
            record["fault_s"] = time.perf_counter() - t0
        return record
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

