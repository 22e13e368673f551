#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:
  1. device   - the card, its power limit, full-f32 matmul policy;
  2. build    - nvcc builds every CUDA kernel from deepsolid_tpu_torch/ops/cuda/csrc;
  3. kernels  - each kernel at the main path's shapes against its plain
                PyTorch version on the card, timed with CUDA events (and a
                library yardstick where one PyTorch call computes the same);
  4. main     - 3 inference iterations of the committed C-diamond 2x2x2
                checkpoint (96 electrons, 1024 walkers, full width) through
                deepsolid_tpu_torch.train.process.process(device='cuda'),
                with every kernel's launch count read around it;
  5. reference - E_L of 8 checkpoint walkers on the card (f32, kernels)
                against the port's plain path on the CPU in float64, and
                the same with TF32 matmuls as a control the check must catch;
  6. profile  - torch.profiler over one 64-walker local-energy chunk:
                kernels by device time and the device's idle share.
The last lines are the card as nvidia-smi reports it, the kernels line
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = "C,C,3.567,2,sto-3g"
BATCH = 1024
EL_CHUNK = 64
ITERATIONS = 3
REFERENCE_ENERGY = -66.0  # Ha/cell, runs/ckpt_diamond/train_stats_r5_latest.csv
ENERGY_WINDOW = 1.5       # Ha/cell, a sanity bound; phase 5 is the exact check
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, FP32 (non-tensor) FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def time_ms(fn, warmup: int = 3, reps: int = 25) -> float:
    """Median milliseconds of `fn` on the card over `reps` timed runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_errs(got, want):
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    return err, err / scale


def kernel_phase(dev, gen):
    """Each kernel at the main path's shapes against its plain version."""
    import torch
    from deepsolid_tpu_torch.ops.cuda import det_kernels as dk
    from deepsolid_tpu_torch.ops.cuda import jet_kernels as jk

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rows = []
    # B1: MCMC log|psi| of 1024 walkers x 8 determinants, one spin channel
    n, nb = 48, BATCH * 8
    a = torch.complex(rnd(nb, n, n), rnd(nb, n, n)) / math.sqrt(2 * n)
    got, want = dk.gj_inverse_slogdet(a), dk.gj_inverse_slogdet_plain(a)
    inv_err = float((got[0] - want[0]).abs().amax(dim=(-1, -2)).div(
        want[0].abs().amax(dim=(-1, -2))).max())
    ld_err = float((got[2] - want[2]).abs().max())
    sg_err = float((got[1] - want[1]).abs().max())
    # Gaussian matrices: the worst-conditioned of 8192 amplifies f32
    # rounding-order differences to ~1e-3 of the inverse's scale
    ok = inv_err <= 5e-3 and ld_err <= 5e-3 and sg_err <= 5e-3
    sing = torch.diag(torch.tensor([1.0, 2.0, 0.0], device=dev)).to(torch.complex64)
    sing_ld = float(dk.gj_inverse_slogdet(sing[None])[2][0])
    ok = ok and sing_ld == -math.inf
    b1_bytes = 2 * a.numel() * 8 + nb * (8 + 4)
    b1_flops = 8.0 * n**3 * nb  # n^3 complex multiply-adds
    bnd, by = bound_ms(b1_bytes, b1_flops)
    rows.append({
        "name": "gj_inverse_slogdet", "route": "cuda",
        "source": "deepsolid_tpu_torch/ops/cuda/csrc/gj_inverse.cu",
        "replaces": "deepsolid_tpu/ops/pallas/det_kernels.py:172",
        "per": "one launch on (8192, 48, 48) complex64",
        "max_abs_err": ld_err, "max_rel_err_inverse": inv_err,
        "max_abs_err_sign": sg_err, "singular_logdet": sing_ld,
        "tolerance": 5e-3, "ok": ok,
        "ms": time_ms(lambda: dk.gj_inverse_slogdet(a)),
        "plain_ms": time_ms(lambda: dk.gj_inverse_slogdet_plain(a)),
        "library_ms": time_ms(lambda: (torch.linalg.inv(a), torch.linalg.slogdet(a))),
        "bound_ms": bnd, "bound_by": by,
    })

    def jet_bytes_flops(t, r, k, c, mix_groups=0):
        nbytes = 4 * ((t + 2) * r * k + k * c + c + (t + 2) * r * c
                      + (t + 2) * mix_groups * c)
        return nbytes, 2.0 * (t + 2) * r * k * c

    # B2: two-electron layers of one 64-walker E_L chunk (pair rows)
    rows_b2, ms = EL_CHUNK * 96 * 96, []
    err = rel = 0.0
    nbytes = flops = plain = mm = 0.0
    for k, c in ((4, 32), (32, 32)):
        args = (rnd(rows_b2, k), rnd(6, rows_b2, k), rnd(rows_b2, k),
                rnd(k, c) / math.sqrt(k), rnd(c))
        e, r_ = max_errs(jk.fused_dense_tanh_jet(*args),
                         jk.fused_dense_tanh_jet_plain(*args))
        err, rel = max(err, e), max(rel, r_)
        ms.append(time_ms(lambda: jk.fused_dense_tanh_jet(*args)))
        plain += time_ms(lambda: jk.fused_dense_tanh_jet_plain(*args))
        mm += time_ms(lambda: torch.matmul(args[1], args[3]))
        b_, f_ = jet_bytes_flops(6, rows_b2, k, c)
        nbytes, flops = nbytes + b_, flops + f_
    bnd, by = bound_ms(nbytes, flops)
    rows.append({
        "name": "fused_dense_tanh_jet", "route": "cuda",
        "source": "deepsolid_tpu_torch/ops/cuda/csrc/dense_tanh_jet.cu",
        "replaces": "deepsolid_tpu/ops/pallas/jet_kernels.py:263",
        "per": "both two-electron layers of one 64-walker chunk (T=6, 589824 rows, 4->32 and 32->32)",
        "max_abs_err": err, "max_rel_err": rel, "tolerance": 1e-5, "ok": rel <= 1e-5,
        "ms": sum(ms), "ms_per_shape": ms, "plain_ms": plain,
        "library_ms": None, "matmul_ms": mm, "bound_ms": bnd, "bound_by": by,
    })

    # B3: one-electron layers of one chunk (layer 0: 16 -> 256, layers 1, 2: 320 -> 256)
    t3, c3 = 3 * 96, 256
    err = rel = 0.0
    total = plain = mm = nbytes = flops = 0.0
    ms = []
    for k, count in ((16, 1), (320, 2)):
        args = (rnd(EL_CHUNK, 96, k), rnd(t3, EL_CHUNK, 96, k), rnd(EL_CHUNK, 96, k),
                rnd(EL_CHUNK, c3), rnd(EL_CHUNK, c3), rnd(t3, EL_CHUNK, c3),
                rnd(k, c3) / math.sqrt(k), rnd(c3))
        e, r_ = max_errs(jk.fused_dense_tanh_jet_mix(*args),
                         jk.fused_dense_tanh_jet_mix_plain(*args))
        err, rel = max(err, e), max(rel, r_)
        t_k = time_ms(lambda: jk.fused_dense_tanh_jet_mix(*args))
        ms.append(t_k)
        total += count * t_k
        plain += count * time_ms(lambda: jk.fused_dense_tanh_jet_mix_plain(*args))
        mm += count * time_ms(lambda: torch.matmul(args[1], args[6]))
        b_, f_ = jet_bytes_flops(t3, EL_CHUNK * 96, k, c3, EL_CHUNK)
        nbytes, flops = nbytes + count * b_, flops + count * f_
        del args
    bnd, by = bound_ms(nbytes, flops)
    rows.append({
        "name": "fused_dense_tanh_jet_mix", "route": "cuda",
        "source": "deepsolid_tpu_torch/ops/cuda/csrc/dense_tanh_jet.cu",
        "replaces": "deepsolid_tpu/ops/pallas/jet_kernels.py:534",
        "per": "the three one-electron layers of one 64-walker chunk (T=288, 6144 rows, 16->256, 2x 320->256)",
        "max_abs_err": err, "max_rel_err": rel, "tolerance": 1e-5, "ok": rel <= 1e-5,
        "ms": total, "ms_per_shape": ms, "plain_ms": plain,
        "library_ms": None, "matmul_ms": mm, "bound_ms": bnd, "bound_by": by,
    })
    torch.cuda.empty_cache()
    return rows


def main_phase(dev):
    """3 inference iterations of the C-diamond checkpoint on the card."""
    import torch
    from deepsolid_tpu_torch.configs import diamond
    from deepsolid_tpu_torch.ops.cuda import det_kernels as dk
    from deepsolid_tpu_torch.ops.cuda import jet_kernels as jk
    from deepsolid_tpu_torch.train.process import process

    cfg = diamond.get_config(CONFIG)
    cfg.batch_size = BATCH
    cfg.precision = "float32"
    cfg.optim.optimizer = "none"
    cfg.optim.laplacian_mode = "forward"
    cfg.optim.el_chunk = EL_CHUNK
    cfg.mcmc.burn_in = 0  # the checkpoint's walkers are equilibrated
    cfg.mcmc.steps = 20
    cfg.debug.deterministic = True
    cfg.log.restore_path = os.path.join(REPO, "runs", "ckpt_diamond")
    cfg.log.save_path = os.path.join(REPO, "build", "chip_smoke_run")
    shutil.rmtree(cfg.log.save_path, ignore_errors=True)

    iters = []

    def on_iteration(t, row, seconds):
        rec = {"phase": "iteration", "step": t, **row,
               "walkers_per_s_local_energy": BATCH / seconds["local_energy"],
               "walkers_per_s_iteration": BATCH / seconds["step"],
               "seconds": seconds}
        iters.append(rec)
        emit(rec)

    for counts in (dk.LAUNCHES, jk.LAUNCHES):
        for key in counts:
            counts[key] = 0
    torch.cuda.reset_peak_memory_stats(dev)
    start = time.perf_counter()
    _, _, energy = process(cfg, ITERATIONS, device="cuda", on_iteration=on_iteration)
    wall = time.perf_counter() - start
    launches = {**dk.LAUNCHES, **jk.LAUNCHES}
    peak = torch.cuda.max_memory_allocated(dev)
    result = {
        "phase": "main", "config": CONFIG, "batch": BATCH, "el_chunk": EL_CHUNK,
        "iterations": ITERATIONS, "mcmc_steps": cfg.mcmc.steps,
        "energy_per_cell": energy, "seconds": wall, "launches": launches,
        "peak_memory_bytes": peak,
        "walkers_per_s_local_energy_median": statistics.median(
            r["walkers_per_s_local_energy"] for r in iters),
        "walkers_per_s_iteration_median": statistics.median(
            r["walkers_per_s_iteration"] for r in iters),
    }
    emit(result)
    return result


def reference_phase(dev):
    """E_L of 8 checkpoint walkers: the card's f32 kernel path against the
    port's plain path on the CPU in float64."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.configs import diamond
    from deepsolid_tpu_torch.device import set_full_precision
    from deepsolid_tpu_torch.hamiltonian import make_local_energy
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.train.process import build_network
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    cfg = diamond.get_config(CONFIG)
    sc = cfg.system.cell
    net = build_network(cfg, sc)
    _, data, params, _, _ = restore(
        find_last_checkpoint(os.path.join(REPO, "runs", "ckpt_diamond")))
    x = np.asarray(data[:8], np.float64)
    el_fn = make_local_energy(net, sc)
    gpu_params = params_from_jax(params, dev, torch.float32)
    gpu_x = torch.as_tensor(x, dtype=torch.float32, device=dev)

    def card_el():
        with torch.no_grad():
            ke, ew = el_fn(gpu_params, gpu_x)
        return (ke + ew).cpu().to(torch.complex128)

    gpu = card_el()
    with torch.no_grad():
        ke, ew = el_fn(params_from_jax(params, "cpu", torch.float64),
                       torch.as_tensor(x, dtype=torch.float64))
        cpu = ke + ew

    def diffs(el):
        d = ((el - cpu).abs() / sc.scale).numpy()
        return float(np.median(d)), float(d.max())

    # f32 against f64 rounding in the kinetic energy's cancelling terms
    # reads ~1e-4 (median) and ~4e-4 (max) Ha/cell; the limits are ~10x
    # that and below the TF32 bias the full-f32 policy exists to prevent
    # (-3.7 mHa/atom, 7.4 mHa per 2-atom cell)
    tol_median, tol_max = 2e-3, 5e-3
    median, worst = diffs(gpu)
    # control: the same evaluation with TF32 matmuls must fail the check
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_median, tf32_worst = diffs(card_el())
    finally:
        set_full_precision()
    result = {
        "phase": "reference", "walkers": 8,
        "el_cpu_f64_per_cell": (cpu.real / sc.scale).tolist(),
        "median_abs_diff_per_cell": median, "max_abs_diff_per_cell": worst,
        "tolerance_median": tol_median, "tolerance_max": tol_max,
        "tf32_control_median_abs_diff_per_cell": tf32_median,
        "tf32_control_max_abs_diff_per_cell": tf32_worst,
        "tf32_control_fails_check": not (tf32_median <= tol_median
                                         and tf32_worst <= tol_max),
    }
    # a check the TF32 control passes could not guard the precision flags
    result["ok"] = (median <= tol_median and worst <= tol_max
                    and result["tf32_control_fails_check"])
    emit(result)
    return result


def profile_phase(dev):
    """Where one 64-walker local-energy chunk spends the card's time:
    kernels by device time from torch.profiler, and the device's busy
    share of the chunk's wall time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from deepsolid_tpu_torch.configs import diamond
    from deepsolid_tpu_torch.hamiltonian import make_local_energy
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.train.process import build_network
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    cfg = diamond.get_config(CONFIG)
    net = build_network(cfg, cfg.system.cell)
    _, data, params, _, _ = restore(
        find_last_checkpoint(os.path.join(REPO, "runs", "ckpt_diamond")))
    params = params_from_jax(params, dev, torch.float32)
    x = torch.as_tensor(np.asarray(data[:EL_CHUNK]), dtype=torch.float32, device=dev)
    el_fn = make_local_energy(net, cfg.system.cell)
    with torch.no_grad():
        el_fn(params, x)  # warm-up
        torch.cuda.synchronize(dev)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            el_fn(params, x)
            torch.cuda.synchronize(dev)
            wall_ms = (time.perf_counter() - start) * 1e3
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            ms = evt.time_range.elapsed_us() / 1e3
            name = evt.name[:90]
            tot, cnt = by_name.get(name, (0.0, 0))
            by_name[name] = (tot + ms, cnt + 1)
    busy = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    result = {"phase": "profile", "what": "one 64-walker local-energy chunk",
              "wall_ms": wall_ms, "device_busy_ms": busy,
              "kernel_launches": sum(c for _, c in by_name.values()),
              "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
              "top_kernels": [{"name": k, "ms": t, "count": c} for k, (t, c) in top]}
    emit(result)
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from deepsolid_tpu_torch.device import set_full_precision
    from deepsolid_tpu_torch.ops.cuda import build

    dev = torch.device("cuda", 0)
    set_full_precision()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    seconds, _ = build.build()
    emit({"phase": "build", "seconds": seconds, "sources": list(build.SOURCES)})

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kernels = kernel_phase(dev, gen)
    for row in kernels:
        emit({"phase": "kernel", **row})
    bad = [r["name"] for r in kernels if not r["ok"]]
    if bad:
        return fail(f"kernels disagree with their plain versions: {bad}")

    main_result = main_phase(dev)
    for row in kernels:
        row["launches"] = main_result["launches"][row["name"]]
    idle = [r["name"] for r in kernels if r["launches"] <= 0]
    if idle:
        return fail(f"the main path launched no {idle}")
    energy = main_result["energy_per_cell"]
    if not (math.isfinite(energy) and abs(energy - REFERENCE_ENERGY) <= ENERGY_WINDOW):
        return fail(f"energy {energy} Ha/cell is not within {ENERGY_WINDOW} "
                    f"of {REFERENCE_ENERGY}")

    if not reference_phase(dev)["ok"]:
        return fail("card E_L disagrees with the CPU float64 reference, or "
                    "the TF32 control passed the check")
    profile_phase(dev)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi, flush=True)
    emit({"kernels": [{k: r[k] for k in keys} for r in kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
