#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:
  1. device   - the card, its power limit, full-f32 matmul policy;
     source   - the C-diamond sto-3g UHF orbital source from the committed
                cache runs/scf_cache (fails before any SCF work when the
                cache file is missing): its build seconds, HF e_tot and the
                occupied k-list every later phase's network takes;
  2. build    - nvcc builds every CUDA kernel from deepsolid_tpu_torch/ops/cuda/csrc
                and a `kernel_resources` line gives each kernel's registers,
                spills and static shared memory as ptxas reports them;
  3. kernels  - each of the five kernels at the main paths' shapes against
                its plain PyTorch version on the card, timed with CUDA
                events (and a library yardstick where one PyTorch call
                computes the same); the Gauss-Jordan kernel at both of its
                launch shapes, on edge-case matrices at n = 48, 14 and 81
                and at both ends of each of its four bodies' ranges (B1
                rows also give graph_ms, the card's time per launch from a
                CUDA graph of launches, beside ms through the wrapper); the
                jet kernels also at ragged shapes (the pair body's too) and
                at a pair shape that falls to the general kernel; the open
                ("partial") jet kernels recombined against the closed one;
  4. main     - 3 inference iterations of the committed C-diamond 2x2x2
                checkpoint (96 electrons, 1024 walkers, full width) through
                deepsolid_tpu_torch.train.process.process(device='cuda'),
                with every kernel's launch count read around it;
  5. sharded  - the same entry point with parallel.deriv_devices = 2: two
                ranks of one gloo process group share the card, each
                holding 144 of the 288 tangent columns (256 walkers, 2
                iterations), against the unsharded port on the same seed;
                the ranks also drive the sharded jet algebra's dense_tanh
                on a pair-shaped jet through the same group;
     bootstrap - the production launch line, `python -m
                torch.distributed.run --standalone --nproc-per-node=1 -m
                deepsolid_tpu_torch --config=...diamond.py:C,C,3.567,2,sto-3g`
                (1 inference iteration at 1024 walkers from a copy of the
                checkpoint): the rank's joined line must read NCCL on
                cuda:0, world 1, and its energy equal the same run in this
                process within 1e-6 Ha/cell; an explicit one-rank NCCL
                bootstrap in this process then reduces a complex64 tensor
                on cuda:0 unchanged;
     data_ranks - two gloo data ranks sharing the card (512 walkers each,
                no MCMC step, one KFAC fisher_exact iteration continuing
                the checkpoint's state) against one process on the same
                1024 walkers: the update within 3e-4 relative, the energy
                within 5e-4 Ha/cell, no host tensor handed to any
                collective, and only rank 0's files;
     nccl_ranks - where the host has two cards, the data_ranks check and
                the sharded phase over two NCCL ranks on a card each; on
                one card a skip line;
  6. training - 2 adam iterations at 1024 walkers from the checkpoint,
                with the checkpoint written and restored;
  7. kfac     - 3 KFAC fisher_exact iterations at 1024 walkers with the
                production run's settings (adaptive damping, here adapting
                every 2 optimizer steps), continuing the checkpoint's KFAC
                state at optimizer step 582: the split of an iteration,
                damping and rho, and the checkpoint written and restored;
  8. pretrain - the production run script's path from its first step:
                process() from scratch at 1024 walkers (orbital source,
                parameters and walkers from the seed, 30 pretraining
                iterations with method 'net', the step-0 checkpoint, burn-in
                and 2 KFAC iterations from a fresh state);
  9. si       - the same path for Si diamond 1x1x1 (28 electrons, sto-3g,
                runs/si_diamond_run.py's settings: el_chunk 128, here
                psi_chunk 64), at full width;
 10. bcc_li   - bcc-Li 3x3x3 (54 atoms, 162 electrons) from its POSCAR
                through the command line's config loader, at full width:
                el_chunk and psi_chunk probed against the card's peak
                memory, then 2 KFAC fisher_exact iterations from the
                committed step-0 checkpoint (restored at t = 1: no
                pretraining, no burn-in) with a fresh optimizer state;
                both new phases report the kernel body each launch shape
                took (as the wrappers count them; B1 must take the warp
                body at Si's n = 14 and the mid body at bcc-Li's 81), and
                B1, B2 and B3 are then held against their plain versions
                and timed at every shape these two paths launched;
 11. h10      - H10 chain (10 electrons, cc-pVDZ) from a cold UHF solved on
                the host into a scratch cache, then runs/h10_imp_run.py's
                path from its first step (batch 2048, Langevin importance
                sampling with 6 sweeps; 30 pretraining iterations, burn-in
                20, 2 KFAC iterations); one mcmc_step of each sampler
                (importance, all-electron with 20 sweeps, one-electron)
                with its seconds, pmove, peak memory and exact B1 launch
                count; a profile of one importance move; the drift and the
                observables of the final walkers against CPU f64; B1 (warp
                body at n = 5), B2 and B3 held and timed at every shape the
                path launched;
     diamond_importance - one C-diamond inference iteration from the
                checkpoint with 6 importance sweeps (B1 at n = 48 with its
                backward rule), and the drift of 8 checkpoint walkers
                against CPU f64;
 12. laplacian - the reference Laplacian engines ('partition' with
                partition_number 3, 'vmap', 'for', 'hessian') on C-diamond
                checkpoint walkers at full width: each engine's E_L (card
                f32) against the port's CPU f64 forward E_L of the same 8
                walkers within the E_L limits, its walkers/s, peak memory
                and B1 launches (each engine's el_chunk the largest of 8, 4,
                2, 1 walkers its 1-walker peak puts under the memory limit;
                no torch.linalg solver may run), 'partition' beside
                'forward' at 64 walkers in one process, and one
                Hessian-vector product of log|det| through B1's
                second-order rule on (64, 48, 48) and (64, 14, 14) matrices
                against the same through B1's plain version on the card
                (one kernel launch each, none in the second derivative);
 13. kfac_modes - 2 KFAC iterations of each Monte Carlo estimation mode
                ('fisher_gradients', 'fisher_curvature_prop') at the kfac
                phase's settings, continuing the checkpoint's KFAC state:
                finite parameters and factors, the checkpoint restores,
                curvature seconds beside fisher_exact's;
 14. full_envelope - Si 1x1x1 from scratch with envelope_type 'full' (the
                si phase's cuts, 2 KFAC iterations with the per-atom
                Kronecker blocks): the KFAC update of 8 walkers continuing
                the run's last KFAC state, card f32 against CPU f64 (its
                sigma leaves within the diamond limit, the whole update
                within 2x the si phase's isotropic state's reading), and
                their E_L within the E_L limits;
 15. orb_scan - DEEPSOLID_TPU_ORB_SCAN=on against off: E_L of 64 C-diamond
                checkpoint walkers within 5e-4 Ha/cell, device ms and peak
                memory of the chunk each way; bcc-Li's peak memory of one
                32-walker chunk each way and the largest el_chunk of 32,
                64, 128 under 60 GB with the scan; the sharded phase's two
                ranks also run one scan-on E_L of 64 walkers, held against
                the unsharded port;
 16. trace    - log.trace_path with trace_start 1, trace_steps 1 in a
                3-iteration inference run: one torch.profiler trace file
                naming B1's kernel and the jet kernels, the traced
                iteration's seconds beside the others;
 17. reference - E_L, the energy gradient, the KFAC update and the
                pretraining loss and its gradient of 8 checkpoint walkers on
                the card (f32, kernels) against the port's plain path on the
                CPU in float64, and E_L with TF32 matmuls as a control the
                check must catch; E_L of 8 Si walkers (after the si phase)
                and 2 bcc-Li checkpoint walkers the same way, each with its
                own TF32 control;
 18. profile  - torch.profiler over one 64-walker C-diamond local-energy
                chunk and one bcc-Li chunk (el_chunk walkers): kernels by
                device time and the device's idle share.
Launch counts are set to 0 just before each driven path and read just
after it. The last lines are the card as nvidia-smi reports it, the
kernels line and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
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
SHARD_BATCH = 256          # walkers of the sharded phase (4 chunks of EL_CHUNK)
SHARD_ITERATIONS = 2
SHARD_EL_TOLERANCE = 5e-4  # Ha/cell, sharded against unsharded E_L per walker
TRAIN_ITERATIONS = 2
TRAIN_LR = 1e-4            # a fine-tuning rate: the checkpoint is a trained state
KFAC_ITERATIONS = 3
KFAC_ADAPT_EVERY = 2       # production adapts every 10 steps; 2 fits 3 iterations
# relative error in the global norm of the card's f32 KFAC update (curvature
# update from the checkpoint's state, then the preconditioned step) against
# the CPU float64 one, same 8 walkers: ~10x the reading on an H100 (PERF.md)
KFAC_UPDATE_TOLERANCE = 3e-4
# relative error in the global norm of the card's f32 energy gradient
# against the CPU float64 one, 8 walkers: ~10x the reading of 2.9e-5 on
# an H100 (PERF.md)
GRADIENT_TOLERANCE = 3e-4
# relative error of the pretraining loss and in the global norm of its
# gradient, card f32 against CPU f64, same 8 walkers: ~10x the first
# readings on an H100, 8.6e-7 and 3.4e-7 (PERF.md)
PRETRAIN_LOSS_TOLERANCE = 1e-5
PRETRAIN_GRADIENT_TOLERANCE = 4e-6
PRETRAIN_ITERATIONS = 30
PRETRAIN_LR = 3e-4         # production's (runs/diamond_run.py)
PRETRAIN_BURN_IN = 20
PRETRAIN_KFAC_ITERATIONS = 2
SCF_CACHE = os.path.join(REPO, "runs", "scf_cache")
# Si diamond 1x1x1 from scratch, runs/si_diamond_run.py's settings
SI_CONFIG = "Si,Si,5.43,1,sto-3g"
SI_EL_CHUNK = 128          # the run script's
SI_PSI_CHUNK = 64
SI_KFAC_ITERATIONS = 2
# bcc-Li 3x3x3 from the committed step-0 checkpoint, runs/bcc_li_run.py's
# settings; el_chunk and psi_chunk are the largest candidates whose peak
# device memory stays under PROBE_LIMIT_BYTES
BCC_LI_CONFIG_FILE = os.path.join(REPO, "deepsolid_tpu_torch", "configs", "read_poscar.py")
BCC_LI_POSCAR = os.path.join(REPO, "deepsolid_tpu_torch", "configs", "poscar", "bcc_li.vasp")
BCC_LI_CKPT = os.path.join(REPO, "runs", "ckpt_bcc_li")
BCC_LI_ITERATIONS = 2
BCC_LI_EL_CHUNKS = (16, 32)
BCC_LI_PSI_CHUNKS = (256, 512)
PROBE_LIMIT_BYTES = 60e9
# H10 chain from a cold UHF, runs/h10_imp_run.py's settings: batch 2048,
# el_chunk and psi_chunk unset, 6 Langevin importance sweeps, adaptive
# damping at the default interval
H10_CONFIG = "H,10,1,1,1.8,0,ccpvdz"
H10_BATCH = 2048
H10_STEPS = 6
H10_KFAC_ITERATIONS = 2
H10_SCF_CACHE = os.path.join(REPO, "build", "chip_smoke_h10_scf")
# one mcmc_step of each kind from the h10 phase's final state: importance
# with the run script's 6 sweeps, all-electron with runs/h10_run.py's 20,
# one-electron with 1 sweep (10 moves)
H10_SAMPLERS = {"importance": dict(steps=H10_STEPS, importance=True),
                "all_electron": dict(steps=20),
                "one_electron": dict(steps=1, one_electron_moves=True)}
DRIFT_WALKERS = 8
# relative error in the global norm of the drift (limit_drift of grad
# log|psi|) of 8 walkers, card f32 against CPU f64: 7.7x and 9.7x the
# first readings on an H100, 3.88e-6 (H10) and 3.10e-6 (C-diamond) (PERF.md)
DRIFT_TOLERANCE = {"h10": 3e-5, "diamond": 3e-5}
OBSERVABLE_TOLERANCE = 1e-5  # polarization and S(k) of the H10 walkers, card against CPU f64
DIAMOND_IMPORTANCE_STEPS = 6
# the Gauss-Jordan body each system's launches must take (by n alone)
B1_BODY = {"si": "warp", "bcc_li": "mid", "h10": "warp"}
BCC_LI_REFERENCE_WALKERS = 2
SI_REFERENCE_WALKERS = 8
# E_L card f32 against CPU f64 per primitive cell: median and max limits
# (reference phase; ~10x the diamond readings, below the TF32 bias)
EL_TOLERANCE_MEDIAN, EL_TOLERANCE_MAX = 2e-3, 5e-3
# the reference Laplacian engines on C-diamond checkpoint walkers
LAPLACIAN_WALKERS = 8
LAPLACIAN_ENGINES = ("partition", "vmap", "for", "hessian")
LAPLACIAN_CHUNKS = (8, 4, 2, 1)  # el_chunk candidates of an engine
LAPLACIAN_RATE_BATCH = 64        # 'partition' beside 'forward', one process
# one Hessian-vector product of sum log|det| through B1's rule on
# 2 I + Gaussian / sqrt(2 n) matrices (condition numbers of a few), kernel
# against plain version on the card: relative error in the global norm,
# ~10x f32 rounding through two products with A^-H
HVP_SHAPES = ((64, 48, 48), (64, 14, 14))
HVP_TOLERANCE = 1e-4
MC_MODES = ("fisher_gradients", "fisher_curvature_prop")
MC_KFAC_ITERATIONS = 2
FULL_ENVELOPE_WALKERS = 8
# The full envelope's KFAC update, card f32 against CPU f64, 8 Si walkers
# continuing the run's state: its sigma leaves (the per-atom Kronecker
# blocks this phase exists for) within KFAC_UPDATE_TOLERANCE; the whole
# update within this factor of the same reading for the isotropic Si state
# of the si phase (same seed and cuts). A 2-iteration-old state sets an
# f32 floor of ~1e-3 for either envelope, from the dense trunk blocks
# (PERF.md): the diamond limit holds for a trained state only.
FULL_ENVELOPE_CONTROL_FACTOR = 2.0
# orbital scan: scan-on against scan-off E_L per walker, both f32 (sums in
# another order), as the sharded phase's limit
ORB_SCAN_TOLERANCE = 5e-4
ORB_SCAN_ENV = "DEEPSOLID_TPU_ORB_SCAN"
BCC_LI_SCAN_CHUNKS = (32, 64, 128)
TRACE_BATCH = 128          # two E_L chunks
TRACE_MCMC_STEPS = 2       # a short run: the trace holds every event of its window
TRACE_ITERATIONS = 3
BOOTSTRAP_TOLERANCE = 1e-6  # Ha/cell: torchrun's rank against this process, same card
DATA_RANKS_ENERGY_TOLERANCE = 5e-4  # Ha/cell, the sharded limit: f32 sums in another order
REFERENCE_ENERGY = -66.0  # Ha/cell, runs/ckpt_diamond/train_stats_r5_latest.csv
ENERGY_WINDOW = 1.5       # Ha/cell, a sanity bound; the reference phase is the exact check
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


def gj_edge_cases(dev, gen, errs):
    """The Gauss-Jordan kernel against its plain version on matrices that
    exercise the pivot rule, at n = 48, 14 and 81 (the registers, warp and
    mid bodies at the three systems' sizes), and on generic matrices at
    both ends of every body's range: `errs(a)` gives (inverse, sign,
    log|det|) errors. One record per case, with the body that took it."""
    import torch
    from deepsolid_tpu_torch.ops.cuda import det_kernels as dk

    def rnd_c(nb, n):
        return torch.complex(torch.randn((nb, n, n), generator=gen, device=dev),
                             torch.randn((nb, n, n), generator=gen, device=dev))

    cases = {}
    for n in (48, 14, 81):
        eye = torch.eye(n, device=dev).to(torch.complex64)
        tie = rnd_c(4, n)
        tie[:, 3, 0], tie[:, 7, 0] = 5.0, 5.0j   # equal |.|^2 in the first pivot column
        if n > 40:
            tie[:, 20, 9], tie[:, 40, 9] = -9.0, 9.0
        sfx = "" if n == 48 else f"_{n}"
        cases.update({
            f"anti_diagonal{sfx}": torch.flip(eye, [1])[None],  # a swap at every step
            f"permutation{sfx}": torch.roll(eye, 5, 0)[None],
            f"tie{sfx}": tie,
        })
    # warp 1-16 (two matrices a warp) and 17-32, shared 33-47, mid 49-96,
    # shared from 97 to the shared-memory limit
    for n in (1, 13, 16, 17, 32, 33, 47, 49, 96, 97, 168):
        cases[f"generic_{n}"] = rnd_c(16, n) / math.sqrt(2 * n)
    out = []
    for name, a in cases.items():
        inv, sg, ld = errs(a)
        out.append({"case": name, "body": dk.variant(dk._lib(), a.shape[-1], dev),
                    "max_rel_err_inverse": inv, "max_abs_err_sign": sg,
                    "max_abs_err_logdet": ld,
                    "ok": inv <= 5e-3 and sg <= 5e-3 and ld <= 5e-3})
    # a zero pivot: log 0 = -inf on both, no fault; a NaN entry: NaN on both
    for n in (48, 14, 81):
        zero = rnd_c(2, n)
        zero[:, :, 7] = 0
        nan = rnd_c(2, n)
        nan[0, 3, 4] = float("nan")
        sfx = "" if n == 48 else f"_{n}"
        for name, a in ((f"zero_pivot{sfx}", zero), (f"nan_entry{sfx}", nan)):
            got, want = dk.gj_inverse_slogdet(a)[2], dk.gj_inverse_slogdet_plain(a)[2]
            same = bool(torch.equal(torch.isfinite(got), torch.isfinite(want))
                        and not torch.isfinite(got[0]))
            if name.startswith("nan_entry"):  # the matrix without the NaN is untouched by it
                same = same and abs(float(got[1] - want[1])) <= 5e-3
            out.append({"case": name, "body": dk.variant(dk._lib(), n, dev),
                        "logdet": got.tolist(), "logdet_plain": want.tolist(),
                        "ok": same})
    torch.cuda.synchronize()
    return out


def gj_errs(a):
    """(inverse, sign, log|det|) errors of the Gauss-Jordan kernel against
    its plain version on the matrices `a`."""
    from deepsolid_tpu_torch.ops.cuda import det_kernels as dk

    got, want = dk.gj_inverse_slogdet(a), dk.gj_inverse_slogdet_plain(a)
    inv = float((got[0] - want[0]).abs().amax(dim=(-1, -2)).div(
        want[0].abs().amax(dim=(-1, -2))).max())
    return inv, float((got[1] - want[1]).abs().max()), float((got[2] - want[2]).abs().max())


def b1_row(dev, gen, nb, n, path="main"):
    """The Gauss-Jordan kernel on `nb` Gaussian n x n complex64 matrices
    against its plain version, timed beside its bound and
    torch.linalg.inv + slogdet. `path` names the driven path whose launch
    count the row reports."""
    import torch
    from deepsolid_tpu_torch.ops.cuda import det_kernels as dk
    from deepsolid_tpu_torch.ops.cuda.time_kernels import graph_ms

    a = torch.complex(torch.randn((nb, n, n), generator=gen, device=dev),
                      torch.randn((nb, n, n), generator=gen, device=dev)) / math.sqrt(2 * n)
    inv_err, sg_err, ld_err = gj_errs(a)
    # Gaussian matrices: the worst-conditioned of 8192 amplifies f32
    # rounding-order differences to ~1e-3 of the inverse's scale
    b1_bytes = 2 * a.numel() * 8 + nb * (8 + 4)
    b1_flops = 8.0 * n**3 * nb  # n^3 complex multiply-adds
    bnd, by = bound_ms(b1_bytes, b1_flops)
    return {
        "name": "gj_inverse_slogdet", "route": "cuda",
        "source": "deepsolid_tpu_torch/ops/cuda/csrc/gj_inverse.cu",
        "replaces": "deepsolid_tpu/ops/pallas/det_kernels.py:172",
        "per": f"one launch on ({nb}, {n}, {n}) complex64", "path": path,
        "shapes": [[nb, n, n]],
        "variant": dk.variant(dk._lib(), n, dev),
        "max_abs_err": ld_err, "max_rel_err_inverse": inv_err,
        "max_abs_err_sign": sg_err, "tolerance": 5e-3,
        "ok": inv_err <= 5e-3 and ld_err <= 5e-3 and sg_err <= 5e-3,
        "ms": time_ms(lambda: dk.gj_inverse_slogdet(a)),
        "graph_ms": graph_ms(lambda: dk.gj_inverse_slogdet(a)),
        "plain_ms": time_ms(lambda: dk.gj_inverse_slogdet_plain(a), reps=5),
        "library_ms": time_ms(lambda: (torch.linalg.inv(a), torch.linalg.slogdet(a))),
        "bound_ms": bnd, "bound_by": by,
    }


def recorded(fn):
    """fn()'s result and the kernel body of the one jet launch it made, as
    the wrapper counted it."""
    from deepsolid_tpu_torch.ops.cuda import jet_kernels as jk

    before = jk.SHAPES.copy()
    out = fn()
    (key,) = (jk.SHAPES - before).keys()
    return out, key[2]


def jet_bytes_flops(t, r, k, c, mix_groups=0):
    nbytes = 4 * ((t + 2) * r * k + k * c + c + (t + 2) * r * c
                  + (t + 2) * mix_groups * c)
    return nbytes, 2.0 * (t + 2) * r * k * c


def b3_row(dev, gen, n, groups, path="main", system="", k0=16):
    """The mix jet kernel on the three one-electron layers of one E_L chunk
    of `groups` walkers of n electrons (T = 3n; layer 0: k0 -> 256, k0 16
    for two atoms per primitive cell, layers 1, 2: 320 -> 256) against its
    plain version, timed beside its bound."""
    import torch
    from deepsolid_tpu_torch.ops.cuda import jet_kernels as jk

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    t3, c3 = 3 * n, 256
    err = rel = 0.0
    total = plain = mm = nbytes = flops = 0.0
    ms, variants = [], []
    for k, count in ((k0, 1), (320, 2)):
        args = (rnd(groups, n, k), rnd(t3, groups, n, k), rnd(groups, n, k),
                rnd(groups, c3), rnd(groups, c3), rnd(t3, groups, c3),
                rnd(k, c3) / math.sqrt(k), rnd(c3))
        got, variant = recorded(lambda: jk.fused_dense_tanh_jet_mix(*args))
        e, r_ = max_errs(got, jk.fused_dense_tanh_jet_mix_plain(*args))
        err, rel = max(err, e), max(rel, r_)
        del got
        t_k = time_ms(lambda: jk.fused_dense_tanh_jet_mix(*args))
        ms.append(t_k)
        variants.append(variant)
        total += count * t_k
        plain += count * time_ms(lambda: jk.fused_dense_tanh_jet_mix_plain(*args))
        mm += count * time_ms(lambda: torch.matmul(args[1], args[6]))
        b_, f_ = jet_bytes_flops(t3, groups * n, k, c3, groups)
        nbytes, flops = nbytes + count * b_, flops + count * f_
        del args
    torch.cuda.empty_cache()
    bnd, by = bound_ms(nbytes, flops)
    return {
        "name": "fused_dense_tanh_jet_mix", "route": "cuda",
        "source": "deepsolid_tpu_torch/ops/cuda/csrc/dense_tanh_jet.cu",
        "replaces": "deepsolid_tpu/ops/pallas/jet_kernels.py:534",
        "per": (f"the three one-electron layers of one {groups}-walker {system}chunk "
                f"(T={t3}, {groups * n} rows, {k0}->256, 2x 320->256)"),
        "path": path, "variant": variants,
        "shapes": [[t3, groups * n, k, c3] for k in (k0, 320)],
        "max_abs_err": err, "max_rel_err": rel,
        "tolerance": 1e-5, "ok": rel <= 1e-5,
        "ms": total, "ms_per_shape": ms, "plain_ms": plain,
        "library_ms": None, "matmul_ms": mm, "bound_ms": bnd, "bound_by": by,
    }


def b2_row(dev, gen, n, groups, path="main", system=""):
    """The plain jet kernel on the two pair layers of one E_L chunk of
    `groups` walkers of n electrons (T = 6, groups * n^2 rows; 4 -> 32 and
    32 -> 32) against its plain version, timed beside its bound."""
    import torch
    from deepsolid_tpu_torch.ops.cuda import jet_kernels as jk

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rows, ms, variants = groups * n * n, [], []
    err = rel = 0.0
    nbytes = flops = plain = mm = 0.0
    for k, c in ((4, 32), (32, 32)):
        args = (rnd(rows, k), rnd(6, rows, k), rnd(rows, k),
                rnd(k, c) / math.sqrt(k), rnd(c))
        got, variant = recorded(lambda: jk.fused_dense_tanh_jet(*args))
        e, r_ = max_errs(got, jk.fused_dense_tanh_jet_plain(*args))
        err, rel = max(err, e), max(rel, r_)
        del got
        ms.append(time_ms(lambda: jk.fused_dense_tanh_jet(*args)))
        variants.append(variant)
        plain += time_ms(lambda: jk.fused_dense_tanh_jet_plain(*args))
        mm += time_ms(lambda: torch.matmul(args[1], args[3]))
        b_, f_ = jet_bytes_flops(6, rows, k, c)
        nbytes, flops = nbytes + b_, flops + f_
        del args
    torch.cuda.empty_cache()
    bnd, by = bound_ms(nbytes, flops)
    return {
        "name": "fused_dense_tanh_jet", "route": "cuda",
        "source": "deepsolid_tpu_torch/ops/cuda/csrc/dense_tanh_jet.cu",
        "replaces": "deepsolid_tpu/ops/pallas/jet_kernels.py:263",
        "per": (f"both two-electron layers of one {groups}-walker {system}chunk "
                f"(T=6, {rows} rows, 4->32 and 32->32)"),
        "path": path, "variant": variants,
        "shapes": [[6, rows, k, 32] for k in (4, 32)],
        "max_abs_err": err, "max_rel_err": rel,
        "tolerance": 1e-5, "ok": rel <= 1e-5,
        "ms": sum(ms), "ms_per_shape": ms, "plain_ms": plain,
        "library_ms": None, "matmul_ms": mm, "bound_ms": bnd, "bound_by": by,
    }


def kernel_phase(dev, gen):
    """Each kernel at the main path's shapes against its plain version."""
    import torch
    from deepsolid_tpu_torch.ops.cuda import det_kernels as dk
    from deepsolid_tpu_torch.ops.cuda import jet_kernels as jk

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rows = []
    # B1: log|psi| of 1024 walkers x 8 determinants, one spin channel, as the
    # sampler launches it, and of one 64-walker chunk (E_L, and every sampler
    # sweep when psi_chunk is set): a launch too small to fill the card
    edge = gj_edge_cases(dev, gen, gj_errs)
    sing = torch.diag(torch.tensor([1.0, 2.0, 0.0], device=dev)).to(torch.complex64)
    sing_ld = float(dk.gj_inverse_slogdet(sing[None])[2][0])
    for nb in (BATCH * 8, EL_CHUNK * 8):
        row = b1_row(dev, gen, nb, 48)
        row.update(singular_logdet=sing_ld, edge_cases=edge,
                   ok=row["ok"] and sing_ld == -math.inf and all(c["ok"] for c in edge))
        rows.append(row)

    # B2: two-electron layers of one 64-walker E_L chunk (pair rows)
    rows_b2 = EL_CHUNK * 96 * 96
    row = b2_row(dev, gen, 96, EL_CHUNK)
    # the pair body at a ragged shape (rows no multiple of its 32-row tile)
    # and a pair-like shape that falls to the general kernel (d_in 8)
    def pair_extra(fn, plain, t):
        out = {}
        for label, r, k in (("ragged", 32 * 1000 + 13, 32), ("ragged_k4", 333, 4),
                            ("fallthrough", 4099, 8)):
            assert jk.pair_body(k, 32, False) == (label != "fallthrough")
            args = (rnd(r, k), rnd(t, r, k), rnd(r, k), rnd(k, 32) / math.sqrt(k),
                    rnd(32))
            out[label + "_max_rel_err"] = max_errs(fn(*args), plain(*args))[1]
        return out

    b2_extra = pair_extra(jk.fused_dense_tanh_jet, jk.fused_dense_tanh_jet_plain, 6)
    row["max_rel_err"] = max(row["max_rel_err"], *b2_extra.values())
    row.update(b2_extra, ok=row["max_rel_err"] <= 1e-5)
    rows.append(row)

    # B3: one-electron layers of one chunk (layer 0: 16 -> 256, layers 1, 2: 320 -> 256)
    t3, c3 = 3 * 96, 256
    row = b3_row(dev, gen, 96, EL_CHUNK)
    # a ragged shape: 385 rows (no multiple of the row tile), 50 tangents
    # (no multiple of the slices), d_in 40 (no multiple of the k-slice)
    ragged = (rnd(5, 77, 40), rnd(50, 5, 77, 40), rnd(5, 77, 40), rnd(5, c3),
              rnd(5, c3), rnd(50, 5, c3), rnd(40, c3) / math.sqrt(40), rnd(c3))
    _, ragged_rel = max_errs(jk.fused_dense_tanh_jet_mix(*ragged),
                             jk.fused_dense_tanh_jet_mix_plain(*ragged))
    row["max_rel_err"] = max(row["max_rel_err"], ragged_rel)
    row.update(ragged_max_rel_err=ragged_rel, ok=row["max_rel_err"] <= 1e-5)
    rows.append(row)
    # B4a/B4b: the open forms. A rank of a 2-way deriv axis holds T_local =
    # 144 of the 288 tangents (3 of the 6 at the pair shape) and gets the
    # tangent square sum back instead of a closed Laplacian.
    def open_extra_bytes(r, c):
        return 4 * r * c  # the fourth output

    t4 = t3 // 2
    err = rel = 0.0
    total = plain = nbytes = flops = 0.0
    ms = []
    # B4a at the one-electron width (256 -> 256) and at B2's pair shape
    cases = [(t4, EL_CHUNK * 96, 256, 256), (3, rows_b2, 4, 32), (3, rows_b2, 32, 32)]
    for t, r, k, c in cases:
        args = (rnd(r, k), rnd(t, r, k), rnd(r, k), rnd(k, c) / math.sqrt(k), rnd(c))
        e, r_ = max_errs(jk.fused_dense_tanh_jet_partial(*args),
                         jk.fused_dense_tanh_jet_partial_plain(*args))
        err, rel = max(err, e), max(rel, r_)
        t_k = time_ms(lambda: jk.fused_dense_tanh_jet_partial(*args))
        ms.append(t_k)
        total += t_k
        plain += time_ms(lambda: jk.fused_dense_tanh_jet_partial_plain(*args))
        b_, f_ = jet_bytes_flops(t, r, k, c)
        nbytes, flops = nbytes + b_ + open_extra_bytes(r, c), flops + f_
        del args
    b4a_extra = pair_extra(jk.fused_dense_tanh_jet_partial,
                           jk.fused_dense_tanh_jet_partial_plain, 3)
    rel = max(rel, *b4a_extra.values())
    bnd, by = bound_ms(nbytes, flops)
    rows.append({
        "name": "fused_dense_tanh_jet_partial", "route": "cuda",
        "source": "deepsolid_tpu_torch/ops/cuda/csrc/dense_tanh_jet.cu",
        "replaces": "deepsolid_tpu/ops/pallas/jet_kernels.py:166",
        "per": "T_local=144, 6144 rows, 256->256, and both pair layers at T_local=3 (589824 rows, 4->32 and 32->32)",
        "max_abs_err": err, "max_rel_err": rel, **b4a_extra,
        "tolerance": 1e-5, "ok": rel <= 1e-5,
        "ms": total, "ms_per_shape": ms, "plain_ms": plain,
        "library_ms": None, "bound_ms": bnd, "bound_by": by,
    })

    err = rel = recombine = 0.0
    total = plain = nbytes = flops = 0.0
    ms = []
    for k, count in ((16, 1), (320, 2)):
        full = (rnd(EL_CHUNK, 96, k), rnd(t3, EL_CHUNK, 96, k), rnd(EL_CHUNK, 96, k),
                rnd(EL_CHUNK, c3), rnd(EL_CHUNK, c3), rnd(t3, EL_CHUNK, c3),
                rnd(k, c3) / math.sqrt(k), rnd(c3))

        def half(i, full=full):
            val, jac, lap, zbc, lbc, jbc, w, b = full
            sl = slice(i * t4, (i + 1) * t4)
            return (val, jac[sl], lap, zbc, lbc, jbc[sl], w, b)

        args = half(0)
        e, r_ = max_errs(jk.fused_dense_tanh_jet_mix_partial(*args),
                         jk.fused_dense_tanh_jet_mix_partial_plain(*args))
        err, rel = max(err, e), max(rel, r_)
        # recombination: the closed kernel on T=288 against two open
        # launches on the halves, s summed, the Laplacian closed
        v, j, l = jk.fused_dense_tanh_jet_mix(*full)
        parts = [jk.fused_dense_tanh_jet_mix_partial(*half(i)) for i in (0, 1)]
        closed = jk.close_laplacian(parts[0][0], parts[0][2], parts[0][3] + parts[1][3])
        _, r_ = max_errs((parts[0][0], torch.cat([p[1] for p in parts]), closed),
                         (v, j, l))
        recombine = max(recombine, r_)
        del v, j, l, parts, closed
        t_k = time_ms(lambda: jk.fused_dense_tanh_jet_mix_partial(*args))
        ms.append(t_k)
        total += count * t_k
        plain += count * time_ms(lambda: jk.fused_dense_tanh_jet_mix_partial_plain(*args))
        b_, f_ = jet_bytes_flops(t4, EL_CHUNK * 96, k, c3, EL_CHUNK)
        nbytes += count * (b_ + open_extra_bytes(EL_CHUNK * 96, c3))
        flops += count * f_
        del args, full
    _, ragged_rel = max_errs(jk.fused_dense_tanh_jet_mix_partial(*ragged),
                             jk.fused_dense_tanh_jet_mix_partial_plain(*ragged))
    rel = max(rel, ragged_rel)
    bnd, by = bound_ms(nbytes, flops)
    rows.append({
        "name": "fused_dense_tanh_jet_mix_partial", "route": "cuda",
        "source": "deepsolid_tpu_torch/ops/cuda/csrc/dense_tanh_jet.cu",
        "replaces": "deepsolid_tpu/ops/pallas/jet_kernels.py:555",
        "per": "the three one-electron layers of one 64-walker chunk on one of two deriv ranks (T_local=144, 6144 rows, 16->256, 2x 320->256)",
        "max_abs_err": err, "max_rel_err": rel, "ragged_max_rel_err": ragged_rel,
        "recombined_max_rel_err": recombine,
        "tolerance": 1e-5, "ok": rel <= 1e-5 and recombine <= 1e-5,
        "ms": total, "ms_per_shape": ms, "plain_ms": plain,
        "library_ms": None, "bound_ms": bnd, "bound_by": by,
    })
    torch.cuda.empty_cache()
    return rows


def production_kernel_rows(dev, gen, bcc_li_el_chunk, bcc_li_psi_chunk):
    """B1, B2 and B3 at every shape the Si and bcc-Li paths give them: B1
    on a sampler launch (psi_chunk x 8 determinants) and an E_L launch
    (el_chunk x 8) of each, n = 14 and 81; B2 and B3 on one E_L chunk of
    each. Each row lists its shapes; the Si sampler row also holds 1024
    walkers x 8 at n = 14, as runs/si_diamond_run.py samples with
    psi_chunk unset, a shape this run does not launch."""
    si_n, bcc_n = 14, 81
    si = b1_row(dev, gen, SI_PSI_CHUNK * 8, si_n, "si")
    si["run_script_shape"] = b1_row(dev, gen, BATCH * 8, si_n, "si")
    rows = [si, b1_row(dev, gen, SI_EL_CHUNK * 8, si_n, "si"),
            b1_row(dev, gen, bcc_li_psi_chunk * 8, bcc_n, "bcc_li"),
            b1_row(dev, gen, bcc_li_el_chunk * 8, bcc_n, "bcc_li"),
            b2_row(dev, gen, 2 * si_n, SI_EL_CHUNK, "si", "Si "),
            b2_row(dev, gen, 2 * bcc_n, bcc_li_el_chunk, "bcc_li", "bcc-Li "),
            b3_row(dev, gen, 2 * si_n, SI_EL_CHUNK, "si", "Si "),
            b3_row(dev, gen, 2 * bcc_n, bcc_li_el_chunk, "bcc_li", "bcc-Li ")]
    si["ok"] = si["ok"] and si["run_script_shape"]["ok"]
    for row in rows[:4]:  # B1: Si's n = 14 on the warp body, bcc-Li's 81 on the mid one
        row["ok"] = row["ok"] and row["variant"] == B1_BODY[row["path"]]
    return rows


def h10_kernel_rows(dev, gen, record):
    """B1 at every shape the h10 path launched it (n = 5: sampler, E_L,
    gradient and capture, each on the whole batch), B2 and B3 on its E_L
    (the whole batch in one chunk: T = 6 pair rows, T = 30)."""
    shapes = record["launch_shapes"]
    n = sum(record["electrons"])
    b1 = sorted({tuple(r["shape"]) for r in shapes if r["kernel"] == "gj_inverse_slogdet"})
    rows = [b1_row(dev, gen, nb, m, "h10") for nb, m, _ in b1]
    for row in rows:
        row["ok"] = row["ok"] and row["variant"] == B1_BODY["h10"]
    k0 = min(r["shape"][2] for r in shapes if r["kernel"] == "fused_dense_tanh_jet_mix")
    return rows + [b2_row(dev, gen, n, H10_BATCH, "h10", "H10 "),
                   b3_row(dev, gen, n, H10_BATCH, "h10", "H10 ", k0=k0)]


def with_path_launches(rows, records):
    """Each row with its path's launch count and the launches at each of
    its shapes, from that path's record; returns the rows that disagree
    with their plain versions or whose path launched none at a shape."""
    for row in rows:
        record = records[row["path"]]
        row["launches"] = record["launches"][row["name"]]
        row["launches_at_shape"] = [
            sum(r["launches"] for r in record["launch_shapes"]
                if r["kernel"] == row["name"] and r["shape"] == shape)
            for shape in row["shapes"]]
        emit({"phase": "kernel", **row})
    return [(r["name"], r["path"], r["shapes"]) for r in rows
            if not r["ok"] or r["launches"] <= 0 or min(r["launches_at_shape"]) <= 0]


def b1_bodies(shapes):
    """{n: the kernel bodies B1's launches at n x n took}, from a launch
    shape record."""
    out = {}
    for r in shapes:
        if r["kernel"] == "gj_inverse_slogdet":
            out.setdefault(r["shape"][-1], set()).add(r["variant"])
    return {n: sorted(v) for n, v in sorted(out.items())}


def reset_launches():
    from deepsolid_tpu_torch.ops.cuda import det_kernels as dk
    from deepsolid_tpu_torch.ops.cuda import jet_kernels as jk

    for counts in (dk.LAUNCHES, jk.LAUNCHES):
        for key in counts:
            counts[key] = 0
    dk.SHAPES.clear()
    jk.SHAPES.clear()


def read_launches():
    from deepsolid_tpu_torch.ops.cuda import det_kernels as dk
    from deepsolid_tpu_torch.ops.cuda import jet_kernels as jk

    return {**dk.LAUNCHES, **jk.LAUNCHES}


@contextlib.contextmanager
def collective_tensors():
    """Count, by "kind/device type", every tensor this process hands to a
    collective of the mesh inside the block (the collective's own check,
    parallel/mesh.py's `_staged`, wrapped): the counter it yields."""
    import collections
    from deepsolid_tpu_torch.parallel import mesh

    counts = collections.Counter()
    staged = mesh._staged

    def counting(t, group, kind):
        counts[f"{kind}/{t.device.type}"] += 1
        return staged(t, group, kind)

    mesh._staged = counting
    try:
        yield counts
    finally:
        mesh._staged = staged


def read_shapes():
    """Launches by kernel, shape and kernel body since reset_launches, as
    the wrappers count them."""
    from deepsolid_tpu_torch.ops.cuda import det_kernels as dk
    from deepsolid_tpu_torch.ops.cuda import jet_kernels as jk

    return [{"kernel": k, "shape": list(shape), "variant": v, "launches": c}
            for (k, shape, v), c in sorted((dk.SHAPES + jk.SHAPES).items(), key=str)]


def diamond_cfg(optimizer, batch, save_name, deriv_devices=1):
    from deepsolid_tpu_torch.configs import diamond

    cfg = diamond.get_config(CONFIG)
    cfg.batch_size = batch
    cfg.precision = "float32"
    cfg.optim.optimizer = optimizer
    cfg.optim.laplacian_mode = "forward"
    cfg.optim.el_chunk = EL_CHUNK
    cfg.parallel.deriv_devices = deriv_devices
    cfg.mcmc.burn_in = 0  # the checkpoint's walkers are equilibrated
    cfg.mcmc.steps = 20
    cfg.pretrain.scf = "hf"  # the UHF orbitals of the cache, as runs/diamond_run.py
    cfg.debug.deterministic = True
    cfg.log.restore_path = os.path.join(REPO, "runs", "ckpt_diamond")
    cfg.log.save_path = os.path.join(REPO, "build", save_name)
    return cfg


def main_phase(dev):
    """3 inference iterations of the C-diamond checkpoint on the card."""
    import torch
    from deepsolid_tpu_torch.train.process import process

    cfg = diamond_cfg("none", BATCH, "chip_smoke_run")
    shutil.rmtree(cfg.log.save_path, ignore_errors=True)

    iters = []

    def on_iteration(t, row, seconds):
        row.pop("local_energy")  # per-walker tensor, not for the log
        rec = {"phase": "iteration", "step": t, **row,
               "walkers_per_s_local_energy": BATCH / seconds["local_energy"],
               "walkers_per_s_iteration": BATCH / seconds["step"],
               "seconds": seconds}
        iters.append(rec)
        emit(rec)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    start = time.perf_counter()
    _, _, energy = process(cfg, ITERATIONS, device="cuda", on_iteration=on_iteration)
    wall = time.perf_counter() - start
    launches = read_launches()
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


def inference_run(cfg, iterations):
    """process() for `iterations` iterations; returns (first iteration's
    per-walker E_L per cell on the host, the iterations' records, energy,
    the launch counts of this run)."""
    from deepsolid_tpu_torch.train.process import process

    first_el, recs = [], []

    def on_iteration(t, row, seconds):
        el = row.pop("local_energy")
        if not first_el:
            first_el.append((el / cfg.system.cell.scale).cpu())
        recs.append({"step": t, **row, "seconds": seconds})

    reset_launches()
    _, _, energy = process(cfg, iterations, device="cuda", on_iteration=on_iteration)
    return first_el[0], recs, energy, read_launches()


def sharded_rank(rank, world_size):
    """One of the two deriv ranks sharing the card: process() with
    parallel.deriv_devices = 2, then the sharded jet algebra's dense_tanh
    on a pair-shaped jet through the same process group."""
    import torch
    from deepsolid_tpu_torch import parallel
    from deepsolid_tpu_torch.device import set_full_precision
    from deepsolid_tpu_torch.ops import fwdlap as fl

    set_full_precision()
    cfg = diamond_cfg("none", SHARD_BATCH, "chip_smoke_sharded",
                      deriv_devices=world_size)
    torch.cuda.reset_peak_memory_stats()
    first_el, recs, energy, launches = inference_run(cfg, SHARD_ITERATIONS)

    # fl.dense_tanh(..., shard=) on the pair stream's shape: every rank
    # makes the same jet from one seed, keeps its 3 of the 6 tangents and
    # must get the closed rule's value, Laplacian and its own jac rows
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(1)
    rows, k, c = EL_CHUNK * 96 * 96, 32, 32

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    jet = fl.Jet(rnd(rows, k), rnd(6, rows, k), rnd(rows, k))
    w, b = rnd(k, c) / math.sqrt(k), rnd(c)
    shard = parallel.make_mesh(world_size).shard
    t_loc = 6 // world_size
    sl = slice(shard.t0(t_loc), shard.t0(t_loc) + t_loc)
    reset_launches()
    got = fl.dense_tanh(fl.Jet(jet.val, jet.jac[sl], jet.lap), w, b, shard=shard)
    algebra_launches = read_launches()
    want = fl.dense_tanh(jet, w, b)
    _, rel = max_errs((got.val, got.jac, got.lap), (want.val, want.jac[sl], want.lap))

    # one E_L chunk of checkpoint walkers with the tangent-chunked orbital
    # head over the same two ranks
    scan_el, scan_launches = scan_el_chunk(cfg, shard)
    torch.cuda.synchronize()
    return {"rank": rank, "first_el": first_el.numpy(), "iterations": recs,
            "energy_per_cell": energy, "launches": launches,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "algebra_launches": algebra_launches, "algebra_max_rel_err": rel,
            "scan_el": scan_el, "scan_launches": scan_launches}


def scan_el_chunk(cfg, shard=None, scan="on"):
    """E_L per cell (numpy) of the checkpoint's first EL_CHUNK walkers on
    the card with DEEPSOLID_TPU_ORB_SCAN=`scan`, over `shard`'s ranks when
    given, and the kernel launches it made."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.hamiltonian import make_local_energy
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.train.process import build_network, orbital_source
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    dev = torch.device("cuda", torch.cuda.current_device())
    sc = cfg.system.cell
    net = build_network(cfg, sc, klist_override=orbital_source(cfg, sc).klist)
    _, data, params, _, _ = restore(find_last_checkpoint(cfg.log.restore_path))
    x = torch.as_tensor(np.asarray(data[:EL_CHUNK]), dtype=torch.float32, device=dev)
    old = os.environ.get(ORB_SCAN_ENV)
    os.environ[ORB_SCAN_ENV] = scan
    try:
        reset_launches()
        with torch.no_grad():
            ke, ew = make_local_energy(net, sc, shard=shard)(
                params_from_jax(params, dev, torch.float32), x)
        torch.cuda.synchronize(dev)
        launches = read_launches()
    finally:
        if old is None:
            os.environ.pop(ORB_SCAN_ENV)
        else:
            os.environ[ORB_SCAN_ENV] = old
    return ((ke + ew) / sc.scale).cpu().numpy(), launches


def sharded_phase(dev, backend="gloo"):
    """deriv_devices = 2 against the unsharded port: two gloo ranks on one
    card, or two NCCL ranks on a card each."""
    import numpy as np
    from deepsolid_tpu_torch import parallel

    cfg = diamond_cfg("none", SHARD_BATCH, "chip_smoke_unsharded")
    shutil.rmtree(cfg.log.save_path, ignore_errors=True)
    want_el, recs, energy, _ = inference_run(cfg, SHARD_ITERATIONS)
    unsharded = statistics.median(SHARD_BATCH / r["seconds"]["local_energy"] for r in recs)

    shutil.rmtree(os.path.join(REPO, "build", "chip_smoke_sharded"), ignore_errors=True)
    start = time.perf_counter()
    ranks = parallel.run_ranks(sharded_rank, 2, backend=backend, timeout=600.0)
    wall = time.perf_counter() - start
    chunks = SHARD_BATCH // EL_CHUNK
    expect_b4b = 3 * chunks * SHARD_ITERATIONS
    diffs = [float(np.abs(r["first_el"] - want_el.numpy()).max()) for r in ranks]
    want_scan, _ = scan_el_chunk(cfg, scan="off")
    scan_diffs = [float(np.abs(r["scan_el"] - want_scan).max()) for r in ranks]
    sharded = statistics.median(
        SHARD_BATCH / it["seconds"]["local_energy"] for it in ranks[0]["iterations"])
    result = {
        "phase": "sharded", "deriv_devices": 2,
        "backend": "gloo (two ranks on one card)" if backend == "gloo"
        else f"{backend} (a card per rank)",
        "batch": SHARD_BATCH, "el_chunk": EL_CHUNK, "iterations": SHARD_ITERATIONS,
        "seconds": wall,
        "launches_per_rank": [r["launches"] for r in ranks],
        "algebra_launches_per_rank": [r["algebra_launches"] for r in ranks],
        "algebra_max_rel_err": max(r["algebra_max_rel_err"] for r in ranks),
        "expected_mix_partial_launches": expect_b4b,
        "max_abs_el_diff_per_cell_by_rank": diffs, "tolerance": SHARD_EL_TOLERANCE,
        "orb_scan_max_abs_el_diff_per_cell_by_rank": scan_diffs,
        "orb_scan_launches_per_rank": [r["scan_launches"] for r in ranks],
        "energy_per_cell": [r["energy_per_cell"] for r in ranks],
        "energy_per_cell_unsharded": energy,
        "peak_memory_bytes_per_rank": [r["peak_memory_bytes"] for r in ranks],
        "walkers_per_s_local_energy_sharded": sharded,
        "walkers_per_s_local_energy_unsharded": unsharded,
    }
    if backend == "gloo":
        result["note"] = ("two ranks time-share one card and reduce through the "
                          "host: the sharded rate is not expected to exceed the "
                          "unsharded one")
    result["ok"] = (
        all(r["launches"]["fused_dense_tanh_jet_mix_partial"] == expect_b4b
            and r["launches"]["fused_dense_tanh_jet_mix"] == 0
            and r["launches"]["fused_dense_tanh_jet"] > 0
            and r["launches"]["gj_inverse_slogdet"] > 0
            and r["algebra_launches"]["fused_dense_tanh_jet_partial"] == 1
            and r["algebra_max_rel_err"] <= 1e-5
            and r["scan_launches"]["fused_dense_tanh_jet_mix_partial"] == 3
            and r["scan_launches"]["gj_inverse_slogdet"] == 2 for r in ranks)
        and max(diffs) <= SHARD_EL_TOLERANCE
        and max(scan_diffs) <= ORB_SCAN_TOLERANCE
        and all(math.isfinite(e) and abs(e - REFERENCE_ENERGY) <= ENERGY_WINDOW
                for e in result["energy_per_cell"]))
    if backend != "gloo":
        return result  # a part of the nccl_ranks line
    emit(result)
    return result


# ---------------------------------------------------------------------------
# ranks: torchrun's bootstrap, the data axis, NCCL with a card per rank
# ---------------------------------------------------------------------------


def bootstrap_argv(restore_path, save_path):
    """The command line of the bootstrap phase's C-diamond inference run."""
    overrides = {
        "optim.optimizer": "none", "optim.iterations": 1, "batch_size": BATCH,
        "optim.el_chunk": EL_CHUNK, "debug.deterministic": True,
        # diamond_cfg's other settings
        "precision": "float32", "optim.laplacian_mode": "forward", "mcmc.burn_in": 0,
        "mcmc.steps": 20, "pretrain.scf": "hf",
        "log.restore_path": restore_path, "log.save_path": save_path,
    }
    config = os.path.join(REPO, "deepsolid_tpu_torch", "configs", "diamond.py")
    argv = [f"--config={config}:{CONFIG}"]
    for key, value in overrides.items():
        argv += [f"--config.{key}", str(value)]
    return argv


def run_session(argv, timeout):
    """subprocess.run(argv) from the repository root in a session of its
    own: on a timeout every process of the session (a launcher's ranks
    too) is killed before TimeoutExpired is raised."""
    import signal

    with subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True, cwd=REPO, start_new_session=True) as proc:
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise
    return subprocess.CompletedProcess(argv, proc.returncode, out, err)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def bootstrap_phase(dev):
    """The production launch line, torchrun with one process, against the
    same run in this process; then an explicit one-rank NCCL bootstrap in
    this process and one reduction of a complex64 tensor through it."""
    import csv
    import re

    import torch
    import torch.distributed as dist
    from deepsolid_tpu_torch import cli, parallel
    from deepsolid_tpu_torch.parallel import distributed
    from deepsolid_tpu_torch.train.process import process

    build = os.path.join(REPO, "build")
    ckpt = os.path.join(build, "chip_smoke_bootstrap_ckpt")
    for name in ("chip_smoke_bootstrap_ckpt", "chip_smoke_bootstrap",
                 "chip_smoke_bootstrap_local"):
        shutil.rmtree(os.path.join(build, name), ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "runs", "ckpt_diamond"), ckpt)
    launched_save = os.path.join(build, "chip_smoke_bootstrap")
    start = time.perf_counter()
    out = run_session(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=1", "-m", "deepsolid_tpu_torch",
         *bootstrap_argv(ckpt, launched_save)], timeout=300)
    launched_seconds = time.perf_counter() - start
    joined = [m.groupdict() for m in re.finditer(distributed.JOINED_PATTERN, out.stderr)]
    stats = os.path.join(launched_save, "train_stats.csv")
    rows = list(csv.DictReader(open(stats))) if os.path.exists(stats) else []
    launched_energy = float(rows[0]["energy"]) if len(rows) == 1 else float("nan")

    cfg, device = cli.parse(bootstrap_argv(ckpt, os.path.join(build, "chip_smoke_bootstrap_local")))
    reset_launches()
    _, _, energy = process(cfg, 1, device=device)
    launches = read_launches()

    distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cuda", timeout=120.0)
    try:
        backend = dist.get_backend()
        gen = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn(4096, dtype=torch.complex64, device=dev, generator=gen)
        y = parallel._reduce_sum(x, dist.group.WORLD)
        torch.cuda.synchronize(dev)
        reduce_ok = backend == "nccl" and y.device == dev and torch.equal(y, x)
    finally:
        dist.destroy_process_group()
    diff = abs(launched_energy - energy)
    result = {
        "phase": "bootstrap", "config": CONFIG, "batch": BATCH, "el_chunk": EL_CHUNK,
        "launch": "python -m torch.distributed.run --standalone --nproc-per-node=1 "
                  "-m deepsolid_tpu_torch",
        "returncode": out.returncode, "seconds_launched": launched_seconds,
        "joined": joined, "energy_per_cell_launched": launched_energy,
        "energy_per_cell_in_process": energy, "abs_energy_diff_per_cell": diff,
        "tolerance": BOOTSTRAP_TOLERANCE, "launches_in_process": launches,
        "explicit_nccl_backend": backend, "nccl_reduce_ok": reduce_ok,
    }
    if out.returncode != 0:
        result["stderr_tail"] = out.stderr[-3000:]
    result["ok"] = (
        out.returncode == 0 and reduce_ok
        and [(j["world"], j["backend"], j["device"]) for j in joined]
        == [("1", "nccl", "cuda:0")]
        and math.isfinite(energy) and diff <= BOOTSTRAP_TOLERANCE)
    emit(result)
    return result


def data_ranks_cfg(save_name):
    """C-diamond at full width, 1024 fixed walkers (no MCMC step), one
    KFAC fisher_exact iteration continuing the checkpoint's state."""
    cfg = production_kfac(diamond_cfg("kfac", BATCH, save_name))
    cfg.optim.psi_chunk = EL_CHUNK
    cfg.optim.kfac.estimation_mode = "fisher_exact"
    cfg.mcmc.steps = 0
    return cfg


def kfac_once(save_name):
    """One KFAC iteration of data_ranks_cfg on this process's card (every
    rank of an initialized world): its record."""
    import torch
    from deepsolid_tpu_torch.device import set_full_precision
    from deepsolid_tpu_torch.optim.adam import tree_leaves
    from deepsolid_tpu_torch.train.process import process
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    set_full_precision()
    cfg = data_ranks_cfg(save_name)
    t_start, _, _, _, _ = restore(find_last_checkpoint(cfg.log.restore_path))
    recs = []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with collective_tensors() as tensors:
        params, data, energy = process(cfg, t_start + 1, device="cuda",
                                       on_iteration=lambda t, row, s: recs.append(s))
    torch.cuda.synchronize()
    return {"params": [p.detach().cpu().numpy() for p in tree_leaves(params)],
            "walkers": data.shape[0], "energy_per_cell": energy, "seconds": recs[0],
            "launches": read_launches(),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "collective_tensors": dict(tensors)}


def data_rank(rank, world_size, save_name):
    return kfac_once(save_name)


def data_ranks_check(phase, backend, one, start_params):
    """Two data ranks (run_ranks with `backend`) against the one-process
    record `one` of the same global batch: the update's relative error,
    the energy, the tensors at collectives and the files rank 0 alone
    writes."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch import parallel

    save_name = f"chip_smoke_{phase}"
    save_path = os.path.join(REPO, "build", save_name)
    shutil.rmtree(save_path, ignore_errors=True)
    # two full-batch KFAC ranks need ~19 GB each on one card: this
    # process's cached blocks go back first
    torch.cuda.empty_cache()
    free_before = torch.cuda.mem_get_info()[0]
    start = time.perf_counter()
    ranks = parallel.run_ranks(data_rank, 2, (save_name,), backend=backend,
                               timeout=600.0)
    wall = time.perf_counter() - start

    def norm(arrays):
        return math.sqrt(sum(float((a.astype(np.float64) ** 2).sum()) for a in arrays))

    update = norm([o - s for o, s in zip(one["params"], start_params)])
    update_errs = [norm([g - o for g, o in zip(r["params"], one["params"])]) / update
                   for r in ranks]
    energy_diffs = [abs(r["energy_per_cell"] - one["energy_per_cell"]) for r in ranks]
    host = [sum(n for k, n in r["collective_tensors"].items() if k.endswith("/cpu"))
            for r in ranks]
    files = sorted(os.listdir(save_path)) if os.path.isdir(save_path) else []
    stats = os.path.join(save_path, "train_stats.csv")
    stats_rows = len(open(stats).read().strip().splitlines()) - 1 if "train_stats.csv" in files else 0
    steps = [r["seconds"]["step"] for r in ranks]
    result = {
        "phase": phase, "backend": backend, "deriv_devices": 1, "batch": BATCH,
        "walkers_per_rank": [r["walkers"] for r in ranks], "mcmc_steps": 0,
        "psi_chunk": EL_CHUNK, "el_chunk": EL_CHUNK, "seconds": wall,
        "update_rel_err_by_rank": update_errs, "update_tolerance": KFAC_UPDATE_TOLERANCE,
        "update_norm": update,
        "energy_per_cell": [r["energy_per_cell"] for r in ranks],
        "energy_per_cell_one_process": one["energy_per_cell"],
        "abs_energy_diff_per_cell_by_rank": energy_diffs,
        "energy_tolerance": DATA_RANKS_ENERGY_TOLERANCE,
        "collective_tensors_by_rank": [r["collective_tensors"] for r in ranks],
        "host_tensors_at_collectives": sum(host),
        "walkers_per_s_iteration_by_rank": [r["walkers"] / t for r, t in zip(ranks, steps)],
        "walkers_per_s_iteration_total": BATCH / max(steps),
        "walkers_per_s_iteration_one_process": BATCH / one["seconds"]["step"],
        "seconds_by_rank": [r["seconds"] for r in ranks],
        "seconds_one_process": one["seconds"],
        "peak_memory_bytes_by_rank": [r["peak_memory_bytes"] for r in ranks],
        "peak_memory_bytes_one_process": one["peak_memory_bytes"],
        "card_free_bytes_before_ranks": free_before,
        "launches_by_rank": [r["launches"] for r in ranks],
        "launches_one_process": one["launches"],
        "files": files, "train_stats_rows": stats_rows,
    }
    result["ok"] = (
        [r["walkers"] for r in ranks] == [BATCH // 2] * 2
        and max(update_errs) <= KFAC_UPDATE_TOLERANCE
        and max(energy_diffs) <= DATA_RANKS_ENERGY_TOLERANCE
        and sum(host) == 0 and all(r["collective_tensors"] for r in ranks)
        and stats_rows == 1 and sum(f.startswith("qmcjax_ckpt_") for f in files) == 1
        and all(r["launches"][k] > 0 for r in ranks for k in (
            "gj_inverse_slogdet", "fused_dense_tanh_jet", "fused_dense_tanh_jet_mix")))
    return result


def data_ranks_phase(dev):
    """Two gloo data ranks sharing the card against one process on the
    same global batch: one KFAC step. Returns the one-process record and
    the start parameters, which the nccl_ranks phase holds its ranks to."""
    import torch
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.optim.adam import tree_leaves
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    shutil.rmtree(os.path.join(REPO, "build", "chip_smoke_data_ranks_one"), ignore_errors=True)
    one = kfac_once("chip_smoke_data_ranks_one")
    _, _, params, _, _ = restore(find_last_checkpoint(os.path.join(REPO, "runs", "ckpt_diamond")))
    start_params = [p.numpy() for p in tree_leaves(params_from_jax(params, "cpu", torch.float32))]
    result = data_ranks_check("data_ranks", "gloo", one, start_params)
    emit(result)
    return result, (one, start_params)


def nccl_ranks_phase(dev, reference):
    """Two NCCL ranks on a card each: the data_ranks check, and
    deriv_devices = 2 against the unsharded port as the sharded phase.
    One card: the skip line."""
    import torch

    count = torch.cuda.device_count()
    if count < 2:
        result = {"phase": "nccl_ranks", "skipped": f"needs 2 cards, found {count}"}
        emit(result)
        return {**result, "ok": True}
    data = data_ranks_check("nccl_ranks", "nccl", *reference)
    sharded = sharded_phase(dev, backend="nccl")
    result = {"phase": "nccl_ranks", "cards": count, "data": data, "sharded": sharded,
              "ok": data["ok"] and sharded["ok"]}
    emit(result)
    return result


def training_phase(dev):
    """Adam iterations at 1024 walkers from the checkpoint."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.models.network import param_shapes, params_from_jax
    from deepsolid_tpu_torch.optim.adam import tree_leaves, tree_map
    from deepsolid_tpu_torch.train.process import build_network, process
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    cfg = diamond_cfg("adam", BATCH, "chip_smoke_train")
    cfg.optim.psi_chunk = EL_CHUNK
    cfg.optim.lr.rate = TRAIN_LR
    shutil.rmtree(cfg.log.save_path, ignore_errors=True)
    t_start, start_data, start_params, _, _ = restore(
        find_last_checkpoint(cfg.log.restore_path))

    iters = []

    def on_iteration(t, row, seconds):
        row.pop("local_energy")
        rec = {"phase": "train_iteration", "step": t, **row, "seconds": seconds,
               "launches_so_far": read_launches()}
        iters.append(rec)
        emit(rec)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    start = time.perf_counter()
    params, _, energy = process(cfg, t_start + TRAIN_ITERATIONS, device="cuda",
                                on_iteration=on_iteration)
    wall = time.perf_counter() - start
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)

    before = params_from_jax(start_params, dev, torch.float32)
    moved = max(float((a - b).abs().max())
                for a, b in zip(tree_leaves(params), tree_leaves(before)))
    ckpt = find_last_checkpoint(cfg.log.save_path)
    restored_ok = False
    if ckpt:
        t_next, data, ck_params, ck_state, _ = restore(ckpt)
        adam_state = ck_state[1]  # the chain: clip, adam, schedule, sign
        restored_ok = (
            t_next == t_start + TRAIN_ITERATIONS and data.shape == (BATCH, 288)
            and param_shapes(ck_params) == param_shapes(start_params)
            and int(adam_state.count) == TRAIN_ITERATIONS
            and all(np.array_equal(a, b.cpu().numpy()) for a, b in
                    zip(tree_leaves(ck_params), tree_leaves(params))))

    # B1 under autograd: launches of one chunk's log psi forward and backward
    net = build_network(cfg, cfg.system.cell)
    x = torch.as_tensor(np.asarray(start_data[:EL_CHUNK], np.float32), device=dev)
    grad_params = tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = tree_leaves(grad_params)
    reset_launches()
    logpsi = net.logdet(grad_params, x)
    b1_forward = read_launches()["gj_inverse_slogdet"]
    logpsi.real.sum().backward()
    b1_backward = read_launches()["gj_inverse_slogdet"] - b1_forward
    grads_finite = all(bool(torch.isfinite(t.grad).all()) for t in leaves)

    def med(key):
        return statistics.median(r["seconds"][key] for r in iters)

    result = {
        "phase": "training", "optimizer": "adam", "batch": BATCH, "el_chunk": EL_CHUNK,
        "psi_chunk": EL_CHUNK, "lr": TRAIN_LR, "iterations": len(iters),
        "seconds": wall, "energy_per_cell": energy,
        "loss_per_cell": [r["energy"] for r in iters],
        "grad_norm": [r["grad_norm"] for r in iters],
        "seconds_per_iteration": {k: med(k) for k in
                                  ("mcmc", "local_energy", "gradient", "update", "step")},
        "walkers_per_s_training_iteration": BATCH / med("step"),
        "peak_memory_bytes": peak, "launches": launches,
        "b1_launches_per_psi_chunk": {"forward": b1_forward, "backward": b1_backward},
        "max_abs_parameter_change": moved, "checkpoint": os.path.basename(ckpt or ""),
        "checkpoint_restores": restored_ok,
    }
    result["ok"] = (
        len(iters) == TRAIN_ITERATIONS
        and all(math.isfinite(r["energy"]) and math.isfinite(r["grad_norm"])
                and r["grad_norm"] > 0 for r in iters)
        and abs(energy - REFERENCE_ENERGY) <= ENERGY_WINDOW
        and moved > 0 and restored_ok and grads_finite
        and b1_forward > 0 and b1_backward == 0)
    emit(result)
    return result


def production_kfac(cfg):
    """The production run's optimizer settings (runs/diamond_run.py) on
    `cfg`, adapting the damping every KFAC_ADAPT_EVERY optimizer steps."""
    cfg.optim.optimizer = "kfac"
    cfg.optim.kfac.adaptive_damping = True
    cfg.optim.kfac.damping_adaptation_interval = KFAC_ADAPT_EVERY
    return cfg


def kfac_phase(dev, mode="fisher_exact", iterations=KFAC_ITERATIONS, phase="kfac"):
    """KFAC iterations of estimation mode `mode` at 1024 walkers,
    continuing the checkpoint's KFAC state."""
    import torch
    from deepsolid_tpu_torch.optim.adam import tree_leaves
    from deepsolid_tpu_torch.train.process import process
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    cfg = production_kfac(diamond_cfg("kfac", BATCH, f"chip_smoke_{phase}_{mode}"))
    cfg.optim.psi_chunk = EL_CHUNK
    cfg.optim.kfac.estimation_mode = mode
    shutil.rmtree(cfg.log.save_path, ignore_errors=True)
    t_start, _, _, start_state, _ = restore(find_last_checkpoint(cfg.log.restore_path))
    start_step = int(start_state["step"])

    iters = []

    def on_iteration(t, row, seconds):
        row.pop("local_energy")
        rec = {"phase": f"{phase}_iteration", "mode": mode, "step": t, **row,
               "seconds": seconds,
               "adapted": "adapt" in seconds, "launches_so_far": read_launches()}
        iters.append(rec)
        emit(rec)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    start = time.perf_counter()
    params, _, energy = process(cfg, t_start + iterations, device="cuda",
                                on_iteration=on_iteration)
    wall = time.perf_counter() - start
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)

    # the state was restored: the optimizer's own counter continues the
    # checkpoint's, and the damping starts from the checkpoint's, not the
    # configuration's
    omega = cfg.optim.kfac.damping_adaptation_decay ** KFAC_ADAPT_EVERY
    first_damping = float(start_state["damping"])
    restored = (
        [r["optimizer_step"] for r in iters]
        == list(range(start_step, start_step + iterations))
        and first_damping != cfg.optim.kfac.damping
        and any(abs(iters[0]["damping"] - d) <= 1e-6 * d for d in
                (first_damping, min(first_damping / omega, cfg.optim.kfac.max_damping),
                 first_damping * omega)))
    params_finite = all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))

    ckpt_ok, factors_finite, ckpt = kfac_checkpoint_ok(
        cfg.log.save_path, t_start + iterations, BATCH, 288, params, iters, dev)

    keys = ("mcmc", "local_energy", "gradient", "curvature", "update", "step")
    plain = [r for r in iters if not r["adapted"]] or iters
    med = med_seconds
    result = {
        "phase": phase, "optimizer": f"kfac {mode}", "batch": BATCH,
        "el_chunk": EL_CHUNK, "psi_chunk": EL_CHUNK, "iterations": len(iters),
        "damping_adaptation_interval": KFAC_ADAPT_EVERY,
        "seconds": wall, "energy_per_cell": energy,
        "loss_per_cell": [r["energy"] for r in iters],
        "optimizer_steps": [r["optimizer_step"] for r in iters],
        "damping": [r["damping"] for r in iters], "rho": [r["rho"] for r in iters],
        "adapted": [r["adapted"] for r in iters],
        "seconds_per_iteration": {k: med(k, iters) for k in keys},
        "seconds_adapt": [r["seconds"].get("adapt") for r in iters],
        "walkers_per_s_local_energy": BATCH / med("local_energy", iters),
        "walkers_per_s_iteration_without_adaptation": BATCH / med("step", plain),
        "walkers_per_s_iteration_all": BATCH / med("step", iters),
        "peak_memory_bytes": peak, "launches": launches,
        "state_restored": restored, "checkpoint": ckpt,
        "checkpoint_restores": ckpt_ok, "parameters_finite": params_finite,
        "factors_finite": factors_finite,
    }
    result["ok"] = (
        len(iters) == iterations and restored and ckpt_ok and params_finite
        and factors_finite and any(r["adapted"] for r in iters)
        and all(math.isfinite(r["energy"]) and math.isfinite(r["grad_norm"])
                and math.isfinite(r["rho"]) and r["damping"] > 0 for r in iters)
        and abs(energy - REFERENCE_ENERGY) <= ENERGY_WINDOW
        and launches["gj_inverse_slogdet"] > 0
        and launches["fused_dense_tanh_jet"] > 0
        and launches["fused_dense_tanh_jet_mix"] > 0)
    emit(result)
    return result


def source_phase():
    """The C-diamond UHF orbital source, served by the committed cache.
    Returns the source, or None when the cache holds no converged solution
    for this system (then nothing has run an SCF)."""
    import numpy as np
    from deepsolid_tpu_torch.configs import diamond
    from deepsolid_tpu_torch.scf import basis as basis_lib
    from deepsolid_tpu_torch.scf import hf as hf_lib
    from deepsolid_tpu_torch.scf.free_electron import free_electron_klist, twisted_kpts

    cfg = diamond.get_config(CONFIG)
    sc, basis, twist = cfg.system.cell, cfg.system.basis, tuple(cfg.network.twist)
    path = hf_lib._uhf_cache_path(sc, basis, twisted_kpts(sc, twist),
                                  basis_lib.build_shells(sc.prim, basis))
    if not os.path.exists(path):
        return None
    with np.load(path) as f:
        e_tot, converged = float(f["e_tot"]), bool(f["converged"])
    if not converged:
        return None
    start = time.perf_counter()
    source = hf_lib.ScfOrbitals.build(sc, basis, twist, level="hf")
    seconds = time.perf_counter() - start
    free = free_electron_klist(sc, twist=twist)
    emit({"phase": "source", "level": "hf", "basis": basis,
          "cache": os.path.relpath(path, REPO), "seconds": seconds, "e_tot": e_tot,
          "ao_images": int(source.evaluator.images.shape[0]), "nao": source.evaluator.nao,
          "klist_equals_free_electron": all(np.array_equal(a, b)
                                            for a, b in zip(source.klist, free)),
          "klist": [np.round(k, 10).tolist() for k in source.klist]})
    return source


def from_scratch(cfg):
    """`cfg` starting as a production run script starts: from the seed,
    with pretraining (method 'net'), the step-0 checkpoint and burn-in."""
    cfg.log.restore_path = ""
    cfg.mcmc.burn_in = PRETRAIN_BURN_IN
    cfg.pretrain.method = "net"
    cfg.pretrain.iterations = PRETRAIN_ITERATIONS
    cfg.pretrain.lr = PRETRAIN_LR
    cfg.pretrain.steps = 1
    return cfg


def med_seconds(key, recs):
    return statistics.median(r["seconds"][key] for r in recs)


def kfac_checkpoint_ok(save_path, t_next_want, batch, n3, params, iters, dev):
    """The last checkpoint of a KFAC run restores: its clock, walkers,
    parameters and a state at the run's optimizer step, damping and rho
    with finite factors. Returns (ok, factors finite, file name)."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.optim import kfac as kfac_lib
    from deepsolid_tpu_torch.optim.adam import tree_leaves
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    ckpt = find_last_checkpoint(save_path)
    if not ckpt:
        return False, False, ""
    t_next, data, ck_params, raw, _ = restore(ckpt)
    state = kfac_lib.state_from_numpy(raw, dev, torch.float32)
    again = kfac_lib.state_to_numpy(state)
    finite = all(bool(torch.isfinite(x).all()) for x in tree_leaves(
        [state["blocks"], state["env_blocks"], state["diag"], state["velocities"]]))
    ok = (t_next == t_next_want and data.shape == (batch, n3)
          and int(state["step"]) == iters[-1]["optimizer_step"] + 1
          and float(state["damping"]) == np.float32(iters[-1]["damping"])
          and float(state["rho"]) == np.float32(iters[-1]["rho"])
          and all(np.array_equal(a, b) for a, b in
                  zip(tree_leaves(again), tree_leaves(raw)))
          and all(np.array_equal(a, b.cpu().numpy()) for a, b in
                  zip(tree_leaves(ck_params), tree_leaves(params))))
    return ok, finite, os.path.basename(ckpt)


def scratch_run(dev, cfg, source, phase, kfac_iterations, emit_iterations=True):
    """process() from scratch: the orbital source, parameters and walkers
    from the seed, pretraining, the step-0 checkpoint, burn-in and
    `kfac_iterations` KFAC iterations from a fresh state. Returns the
    phase's record (not yet emitted) with its checks in "ok"."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.optim.adam import tree_leaves
    from deepsolid_tpu_torch.train.process import process
    from deepsolid_tpu_torch.utils.checkpoint import restore

    shutil.rmtree(cfg.log.save_path, ignore_errors=True)
    batch, n3 = cfg.batch_size, 3 * sum(cfg.system.cell.nelec)
    pre, iters = [], []
    step0 = os.path.join(cfg.log.save_path, "qmcjax_ckpt_000000.npz")
    step0_ok = []

    def check_step0():
        """The pretrained state as saved, read before the first KFAC
        iteration's checkpoint could take its name."""
        ok = False
        if os.path.exists(step0):
            t_next, ck_data, ck_params, ck_state, _ = restore(step0)
            ok = (t_next == 1 and ck_state is None and ck_data.shape == (batch, n3)
                  and bool(np.isfinite(ck_data).all())
                  and all(np.isfinite(a).all() for a in tree_leaves(ck_params)))
        step0_ok.append(ok)

    def on_pretrain(t, loss, pmove, seconds):
        b1 = read_launches()["gj_inverse_slogdet"]
        rec = {"phase": f"{phase}_iteration", "step": t, "loss": loss, "pmove": pmove,
               "seconds": seconds, "b1_launches": b1 - sum(r["b1_launches"] for r in pre),
               "peak_memory_bytes_so_far": torch.cuda.max_memory_allocated(dev)}
        pre.append(rec)
        if emit_iterations:
            emit(rec)

    def on_iteration(t, row, seconds):
        if not step0_ok:
            check_step0()
        row.pop("local_energy")
        rec = {"phase": f"{phase}_kfac_iteration", "step": t, **row, "seconds": seconds,
               "adapted": "adapt" in seconds}
        iters.append(rec)
        emit(rec)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    start = time.perf_counter()
    params, data, energy = process(cfg, kfac_iterations, device="cuda",
                                   on_iteration=on_iteration, on_pretrain=on_pretrain)
    wall = time.perf_counter() - start
    launches, shapes = read_launches(), read_shapes()
    peak = torch.cuda.max_memory_allocated(dev)

    if not step0_ok:
        check_step0()
    step0_ok = step0_ok[0]
    ckpt_ok, factors_finite, ckpt = (kfac_checkpoint_ok(
        cfg.log.save_path, kfac_iterations, batch, n3, params, iters, dev)
        if iters else (False, False, ""))
    losses = [r["loss"] for r in pre]

    # the targets alone: the UHF orbital matrices of one psi_chunk of walkers
    chunk = data[:cfg.optim.psi_chunk or batch].contiguous()
    target_ms = time_ms(lambda: source.orbital_mats(chunk), reps=10)

    steady = pre[1:]  # iterations 2-30: the first pays warm-up
    plain = [r for r in iters if not r["adapted"]] or iters
    result = {
        "phase": phase, "method": cfg.pretrain.method, "scf": cfg.pretrain.scf,
        "basis": cfg.system.basis, "electrons": list(cfg.system.cell.nelec),
        "batch": batch, "psi_chunk": cfg.optim.psi_chunk, "el_chunk": cfg.optim.el_chunk,
        "lr": cfg.pretrain.lr, "iterations": len(pre), "burn_in": cfg.mcmc.burn_in,
        "kfac_iterations": len(iters), "seconds": wall,
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "pmove": [r["pmove"] for r in pre],
        "seconds_per_iteration_median": {k: med_seconds(k, steady) for k in
                                         ("loss_grad", "update", "mcmc", "step")},
        "walkers_per_s_pretraining_median": batch / med_seconds("step", steady),
        "target_orbitals_ms_per_psi_chunk": target_ms,
        "b1_launches_per_iteration": sorted({r["b1_launches"] for r in pre}),
        "peak_memory_bytes_pretraining": pre[-1]["peak_memory_bytes_so_far"] if pre else None,
        "peak_memory_bytes": peak, "launches": launches, "launch_shapes": shapes,
        "step0_checkpoint": os.path.relpath(step0, REPO), "step0_restores": step0_ok,
        "checkpoint": ckpt, "checkpoint_restores": ckpt_ok,
        "factors_finite": factors_finite,
        "kfac_energy_per_cell": [r["energy"] for r in iters],
        "kfac_pmove": [r["pmove"] for r in iters],
        "kfac_seconds_per_iteration": [r["seconds"] for r in iters],
        "kfac_walkers_per_s_local_energy": [batch / r["seconds"]["local_energy"]
                                            for r in iters],
        "kfac_walkers_per_s_iteration_without_adaptation":
            batch / med_seconds("step", plain) if iters else None,
        "energy_per_cell": energy,
    }
    result["ok"] = (
        len(pre) == PRETRAIN_ITERATIONS and len(steady) > 0
        and all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
        and step0_ok and ckpt_ok and factors_finite
        and bool(torch.isfinite(data).all())
        and all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))
        and len(iters) == kfac_iterations
        and all(math.isfinite(r["energy"]) and math.isfinite(r["grad_norm"])
                and math.isfinite(r["rho"]) for r in iters)
        and math.isfinite(energy)
        and all(r["b1_launches"] > 0 for r in pre)
        and launches["gj_inverse_slogdet"] > 0
        and launches["fused_dense_tanh_jet"] > 0
        and launches["fused_dense_tanh_jet_mix"] > 0)
    return result, params, data


def pretrain_phase(dev, source):
    """process() from scratch, as the production run script starts: the
    orbital source, parameters and walkers from the seed, pretraining, the
    step-0 checkpoint, burn-in and KFAC iterations from a fresh state."""
    cfg = from_scratch(production_kfac(diamond_cfg("kfac", BATCH, "chip_smoke_pretrain")))
    cfg.optim.psi_chunk = EL_CHUNK
    cfg.optim.kfac.damping_adaptation_interval = 10  # production's
    result, _, _ = scratch_run(dev, cfg, source, "pretrain", PRETRAIN_KFAC_ITERATIONS)
    emit(result)
    return result


def si_cfg():
    """runs/si_diamond_run.py's settings from its first step, at 1024
    walkers with `psi_chunk` 64 (the run script leaves it unset)."""
    from deepsolid_tpu_torch.configs import diamond

    cfg = production_kfac(diamond.get_config(SI_CONFIG))
    cfg.batch_size = BATCH
    cfg.precision = "float32"
    cfg.optim.laplacian_mode = "forward"
    cfg.optim.el_chunk = SI_EL_CHUNK
    cfg.optim.psi_chunk = SI_PSI_CHUNK
    cfg.optim.kfac.damping_adaptation_interval = 10  # production's
    cfg.mcmc.steps = 20
    cfg.pretrain.scf = "hf"
    cfg.debug.deterministic = True
    cfg.log.save_path = os.path.join(REPO, "build", "chip_smoke_si")
    return from_scratch(cfg)


def si_phase(dev):
    """Si diamond 1x1x1 (28 electrons) from scratch at full width. Returns
    the record and what the reference phase holds: (cfg, k-list, numpy
    parameters, walkers) after the KFAC iterations."""
    from deepsolid_tpu_torch.models.network import params_to_numpy
    from deepsolid_tpu_torch.train.process import orbital_source

    cfg = si_cfg()
    source = orbital_source(cfg, cfg.system.cell)
    result, params, data = scratch_run(dev, cfg, source, "si", SI_KFAC_ITERATIONS,
                                       emit_iterations=False)
    result["config"] = SI_CONFIG
    result["b1_bodies"] = b1_bodies(result["launch_shapes"])
    result["ok"] = result["ok"] and result["b1_bodies"] == {14: [B1_BODY["si"]]}
    emit(result)
    return result, (cfg, source.klist, params_to_numpy(params),
                    data[:SI_REFERENCE_WALKERS].cpu().numpy())


def bcc_li_cfg(el_chunk, psi_chunk):
    """runs/bcc_li_run.py's settings, loaded as the command line loads them
    (deepsolid_tpu_torch.cli): the port's POSCAR copy, 3x3x3, sto-3g."""
    from deepsolid_tpu_torch import cli

    overrides = {
        "batch_size": BATCH, "precision": "float32", "optim.optimizer": "kfac",
        "optim.laplacian_mode": "forward", "optim.el_chunk": el_chunk,
        "optim.psi_chunk": psi_chunk, "mcmc.burn_in": 100, "mcmc.steps": 20,
        "pretrain.method": "net", "pretrain.scf": "hf", "pretrain.iterations": 500,
        "optim.kfac.adaptive_damping": True,
        "optim.kfac.damping_adaptation_interval": 10,
        "log.restore_path": BCC_LI_CKPT,
        "log.save_path": os.path.join(REPO, "build", "chip_smoke_bcc_li"),
        "debug.deterministic": True,
    }
    argv = [f"--config={BCC_LI_CONFIG_FILE}:{BCC_LI_POSCAR},3,sto-3g"]
    for key, value in overrides.items():
        argv += [f"--config.{key}", str(value)]
    cfg, _ = cli.parse(argv)
    return cfg


def bcc_li_probe(dev, cfg, net, params, x):
    """Peak device memory of one E_L chunk of each candidate `el_chunk` and
    of KFAC's curvature capture (the largest psi_chunk-chunked pass: one
    tapped forward, two backward passes) of each candidate `psi_chunk`;
    the largest candidate under PROBE_LIMIT_BYTES that divides the batch
    is taken. A candidate that runs out of memory reads None."""
    import torch
    from deepsolid_tpu_torch.hamiltonian import make_local_energy
    from deepsolid_tpu_torch.optim import kfac as kfac_lib
    from deepsolid_tpu_torch.optim.adam import learning_rate_schedule

    el_fn = make_local_energy(net, cfg.system.cell)

    def peak(fn):
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            fn()
            torch.cuda.synchronize(dev)
        except torch.cuda.OutOfMemoryError:
            return None
        finally:
            torch.cuda.empty_cache()
        return torch.cuda.max_memory_allocated(dev)

    def capture(n):
        cfg.optim.psi_chunk = n
        opt = kfac_lib.KfacOptimizer.from_config(cfg, net, learning_rate_schedule(cfg))
        opt.update_curvature(opt.init(params), params, x[:n])

    with torch.no_grad():
        el = {c: peak(lambda: el_fn(params, x[:c])) for c in BCC_LI_EL_CHUNKS}
    psi = {c: peak(lambda: capture(c)) for c in BCC_LI_PSI_CHUNKS}

    def choose(readings):
        fits = [c for c, b in readings.items()
                if b is not None and b < PROBE_LIMIT_BYTES and BATCH % c == 0]
        return max(fits) if fits else None

    return {"el_chunk_peak_bytes": el, "psi_chunk_peak_bytes": psi,
            "limit_bytes": PROBE_LIMIT_BYTES,
            "el_chunk": choose(el), "psi_chunk": choose(psi)}


def bcc_li_phase(dev):
    """bcc-Li 3x3x3 (54 atoms, 162 electrons) at full width: KFAC
    fisher_exact iterations from the committed step-0 checkpoint with a
    fresh optimizer state, el_chunk and psi_chunk taken from the card's
    own peak memory. Returns the record and what the reference phase
    holds: (cfg, k-list, the checkpoint's parameters and walkers)."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.optim.adam import tree_leaves
    from deepsolid_tpu_torch.train.process import build_network, orbital_source, process
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    cfg = bcc_li_cfg(0, 0)
    sc = cfg.system.cell
    klist = orbital_source(cfg, sc).klist
    net = build_network(cfg, sc, klist_override=klist)
    t_start, start_data, start_params, _, _ = restore(find_last_checkpoint(BCC_LI_CKPT))
    params = params_from_jax(start_params, dev, torch.float32)
    x = torch.as_tensor(np.asarray(start_data), dtype=torch.float32, device=dev)
    probe = bcc_li_probe(dev, cfg, net, params, x)
    emit({"phase": "bcc_li_probe", **probe})
    del params, x
    if probe["el_chunk"] is None or probe["psi_chunk"] is None:
        return {"phase": "bcc_li", "ok": False, "probe": probe}, None

    cfg = bcc_li_cfg(probe["el_chunk"], probe["psi_chunk"])
    shutil.rmtree(cfg.log.save_path, ignore_errors=True)
    iters, pretrained = [], []

    def on_iteration(t, row, seconds):
        row.pop("local_energy")
        rec = {"phase": "bcc_li_iteration", "step": t, **row, "seconds": seconds,
               "adapted": "adapt" in seconds}
        iters.append(rec)
        emit(rec)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    start = time.perf_counter()
    params, _, energy = process(
        cfg, t_start + BCC_LI_ITERATIONS, device="cuda", on_iteration=on_iteration,
        on_pretrain=lambda *args: pretrained.append(args))
    wall = time.perf_counter() - start
    launches, shapes = read_launches(), read_shapes()
    peak = torch.cuda.max_memory_allocated(dev)

    # B1 on the restored run's path only: per iteration the sampler's 20
    # proposals and its first evaluation, E_L, the gradient's and KFAC's
    # capture forward passes, each chunked, two spins each; E_L again on an
    # iteration that adapts the damping. Pretraining or burn-in would add
    # sweeps of their own.
    n_psi, n_el = BATCH // cfg.optim.psi_chunk, BATCH // cfg.optim.el_chunk
    adapted = sum(r["adapted"] for r in iters)
    b1_want = 2 * (len(iters) * ((cfg.mcmc.steps + 1) * n_psi + n_el + 2 * n_psi)
                   + adapted * n_el)
    ckpt_ok, factors_finite, ckpt = (kfac_checkpoint_ok(
        cfg.log.save_path, t_start + BCC_LI_ITERATIONS, BATCH, 3 * sum(sc.nelec),
        params, iters, dev) if iters else (False, False, ""))
    plain = [r for r in iters if not r["adapted"]] or iters
    keys = ("mcmc", "local_energy", "gradient", "curvature", "update", "step")
    result = {
        "phase": "bcc_li", "config": f"read_poscar {os.path.relpath(BCC_LI_POSCAR, REPO)},3,sto-3g",
        "electrons": list(sc.nelec), "atoms": sc.natom, "batch": BATCH,
        "el_chunk": cfg.optim.el_chunk, "psi_chunk": cfg.optim.psi_chunk,
        "restored_step": t_start, "steps": [r["step"] for r in iters],
        "pretraining_iterations": len(pretrained), "seconds": wall,
        "energy_per_cell": energy, "loss_per_cell": [r["energy"] for r in iters],
        "damping": [r["damping"] for r in iters], "rho": [r["rho"] for r in iters],
        "adapted": [r["adapted"] for r in iters],
        "seconds_per_iteration": [r["seconds"] for r in iters],
        "seconds_per_iteration_median": {k: med_seconds(k, iters) for k in keys},
        "walkers_per_s_local_energy": [BATCH / r["seconds"]["local_energy"] for r in iters],
        "walkers_per_s_iteration_without_adaptation": BATCH / med_seconds("step", plain),
        "peak_memory_bytes": peak, "launches": launches,
        "b1_launches_expected": b1_want, "launch_shapes": shapes,
        "b1_bodies": b1_bodies(shapes),
        "checkpoint": ckpt, "checkpoint_restores": ckpt_ok,
        "factors_finite": factors_finite,
    }
    result["ok"] = (
        t_start == 1 and result["steps"] == list(range(1, 1 + BCC_LI_ITERATIONS))
        and not pretrained and launches["gj_inverse_slogdet"] == b1_want
        and result["b1_bodies"] == {81: [B1_BODY["bcc_li"]]}
        and launches["fused_dense_tanh_jet"] > 0 and launches["fused_dense_tanh_jet_mix"] > 0
        and all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))
        and ckpt_ok and factors_finite and math.isfinite(energy)
        and all(math.isfinite(r["energy"]) and math.isfinite(r["grad_norm"])
                and math.isfinite(r["rho"]) for r in iters))
    emit(result)
    return result, (cfg, klist, start_params, start_data[:BCC_LI_REFERENCE_WALKERS])


def h10_cfg():
    """runs/h10_imp_run.py's settings from its first step."""
    from deepsolid_tpu_torch.configs import hydrogen_chain

    cfg = hydrogen_chain.get_config(H10_CONFIG)
    cfg.batch_size = H10_BATCH
    cfg.precision = "float32"
    cfg.optim.optimizer = "kfac"
    cfg.optim.laplacian_mode = "forward"
    cfg.optim.kfac.adaptive_damping = True
    cfg.mcmc.steps = H10_STEPS
    cfg.mcmc.importance_sampling = True
    cfg.pretrain.scf = "hf"
    cfg.debug.deterministic = True
    cfg.log.save_path = os.path.join(REPO, "build", "chip_smoke_h10")
    return from_scratch(cfg)


def drift_rel_err(dev, net, params, x):
    """Relative error in the global norm of the drift, limit_drift of grad
    log|psi|, of the walkers `x` (numpy) under the numpy parameters
    `params`: the card's f32 path against the port's CPU f64 one."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.sampling.mcmc import limit_drift
    from deepsolid_tpu_torch.train.loss import walker_value_and_grad

    val_grad = walker_value_and_grad(net.slogdet)

    def drift(device, dtype):
        _, grad = val_grad(params_from_jax(params, device, dtype),
                           torch.as_tensor(np.asarray(x), dtype=dtype, device=device))
        return limit_drift(grad).cpu().double()

    card, cpu = drift(dev, torch.float32), drift("cpu", torch.float64)
    return float((card - cpu).norm() / cpu.norm()), float(cpu.norm())


def h10_samplers(dev, cfg, net, params, data):
    """One mcmc_step of each kind of H10_SAMPLERS from (params, data) at
    the configured width: seconds, pmove, peak device memory and B1's
    launches, which must be exactly the sweeps' (two spin channels per
    evaluation, two evaluations per Langevin move, one first evaluation)."""
    import torch
    from deepsolid_tpu_torch.sampling.mcmc import make_mcmc_step
    from deepsolid_tpu_torch.train.loss import chunk_batch_fn

    sc, psi_chunk = cfg.system.cell, cfg.optim.psi_chunk
    gen = torch.Generator(device=dev).manual_seed(7)
    out = {}
    for name, spec in H10_SAMPLERS.items():
        step = make_mcmc_step(
            chunk_batch_fn(net.slogdet, psi_chunk), sc.lattice, steps=spec["steps"],
            importance_network=net.slogdet if spec.get("importance") else None,
            one_electron_moves=spec.get("one_electron_moves", False), psi_chunk=psi_chunk)
        moves = spec["steps"] * (sum(sc.nelec) if spec.get("one_electron_moves") else 1)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        start = time.perf_counter()
        with torch.no_grad():
            moved, pmove = step(params, data, gen, cfg.mcmc.move_width)
            pmove = float(pmove)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - start
        b1 = read_launches()["gj_inverse_slogdet"]
        want = 2 * (1 + moves * (2 if spec.get("importance") else 1))
        out[name] = {"steps": spec["steps"], "moves": moves, "seconds": seconds,
                     "ms_per_move": 1e3 * seconds / moves, "pmove": pmove,
                     "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
                     "b1_launches": b1, "b1_launches_expected": want,
                     "finite": bool(torch.isfinite(moved).all()),
                     "ok": 0 < pmove <= 1 and b1 == want
                     and bool(torch.isfinite(moved).all())}
    return out


def h10_phase(dev):
    """H10 (10 electrons, cc-pVDZ) from a cold UHF solved on the host into
    a scratch cache, then runs/h10_imp_run.py's path from its first step
    with the Langevin importance sampler; then one step of each sampler,
    a profile of one importance move, and the drift and the observables
    of the final walkers, card f32 against CPU f64. Returns the record."""
    import torch
    from deepsolid_tpu_torch.models.network import params_to_numpy
    from deepsolid_tpu_torch.observables import (make_complex_polarization,
                                                  make_structure_factor)
    from deepsolid_tpu_torch.sampling.mcmc import make_mcmc_step
    from deepsolid_tpu_torch.train.process import build_network, orbital_source

    cfg = h10_cfg()
    sc = cfg.system.cell
    shutil.rmtree(H10_SCF_CACHE, ignore_errors=True)
    os.makedirs(H10_SCF_CACHE)
    cache = os.environ.get("DEEPSOLID_TPU_SCF_CACHE")
    os.environ["DEEPSOLID_TPU_SCF_CACHE"] = H10_SCF_CACHE
    try:
        start = time.perf_counter()
        source = orbital_source(cfg, sc)  # the cold UHF
        uhf_seconds = time.perf_counter() - start
        emit({"phase": "h10_source", "config": H10_CONFIG, "basis": cfg.system.basis,
              "level": cfg.pretrain.scf, "seconds_cold_uhf": uhf_seconds,
              "cache_files": sorted(os.listdir(H10_SCF_CACHE))})
        result, params, data = scratch_run(dev, cfg, source, "h10", H10_KFAC_ITERATIONS,
                                           emit_iterations=False)
    finally:
        os.environ["DEEPSOLID_TPU_SCF_CACHE"] = cache
        shutil.rmtree(H10_SCF_CACHE, ignore_errors=True)
    net = build_network(cfg, sc, klist_override=source.klist)
    result.update(config=H10_CONFIG, seconds_cold_uhf=uhf_seconds,
                  mcmc_steps=cfg.mcmc.steps, importance_sampling=True,
                  b1_bodies=b1_bodies(result["launch_shapes"]))
    samplers = h10_samplers(dev, cfg, net, params, data)

    move = make_mcmc_step(net.slogdet, sc.lattice, steps=1, importance_network=net.slogdet)
    gen = torch.Generator(device=dev).manual_seed(8)
    profile = profile_fn(dev, lambda: move(params, data, gen, cfg.mcmc.move_width),
                         f"one Langevin importance move of {H10_BATCH} H10 walkers")

    np_params = params_to_numpy(params)
    x8 = data[:DRIFT_WALKERS].cpu().double().numpy()
    drift_err, drift_norm = drift_rel_err(dev, net, np_params, x8)
    obs_err = {}
    for name, make in (("complex_polarization", make_complex_polarization),
                       ("structure_factor", make_structure_factor)):
        fn = make(sc)
        card = fn(data).cpu().to(torch.complex128)
        cpu = fn(data.cpu().double()).to(torch.complex128)
        obs_err[name] = float((card - cpu).abs().max())
    result.update(
        samplers=samplers, profile_importance_move=profile,
        drift_rel_err_global_norm=drift_err, drift_global_norm_cpu_f64=drift_norm,
        drift_tolerance=DRIFT_TOLERANCE["h10"],
        observables_max_abs_err=obs_err, observables_tolerance=OBSERVABLE_TOLERANCE)
    result["ok"] = (
        result["ok"] and result["b1_bodies"] == {5: [B1_BODY["h10"]]}
        and all(0 < p <= 1 for p in result["kfac_pmove"])
        and len(result["kfac_pmove"]) == H10_KFAC_ITERATIONS
        and all(r["ok"] for r in samplers.values())
        and drift_err <= DRIFT_TOLERANCE["h10"]
        and all(e <= OBSERVABLE_TOLERANCE for e in obs_err.values()))
    emit(result)
    return result


def diamond_importance_phase(dev, source):
    """One C-diamond inference iteration from the committed checkpoint
    with the Langevin importance sampler (6 sweeps; B1's registers body
    at n = 48 and its backward rule), the drift of 8 checkpoint walkers,
    card f32 against CPU f64, and the peak memory of one move alone."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.sampling.mcmc import make_mcmc_step
    from deepsolid_tpu_torch.train.process import build_network
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    cfg = diamond_cfg("none", BATCH, "chip_smoke_diamond_importance")
    cfg.mcmc.steps = DIAMOND_IMPORTANCE_STEPS
    cfg.mcmc.importance_sampling = True
    shutil.rmtree(cfg.log.save_path, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats(dev)
    _, recs, energy, launches = inference_run(cfg, 1)
    shapes = read_shapes()
    peak = torch.cuda.max_memory_allocated(dev)
    _, data, params, _, width = restore(find_last_checkpoint(cfg.log.restore_path), BATCH)
    net = build_network(cfg, cfg.system.cell, klist_override=source.klist)
    drift_err, drift_norm = drift_rel_err(dev, net, params, data[:DRIFT_WALKERS])

    # the sampler's own peak: one Langevin move of the batch, unchunked
    move = make_mcmc_step(net.slogdet, cfg.system.cell.lattice, steps=1,
                          importance_network=net.slogdet)
    x = torch.as_tensor(np.asarray(data), dtype=torch.float32, device=dev)
    gpu_params = params_from_jax(params, dev, torch.float32)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        move(gpu_params, x, torch.Generator(device=dev).manual_seed(9), float(width))
    torch.cuda.synchronize(dev)
    sampler_peak = torch.cuda.max_memory_allocated(dev)
    result = {
        "phase": "diamond_importance", "config": CONFIG, "batch": BATCH,
        "mcmc_steps": cfg.mcmc.steps, "energy_per_cell": energy,
        "pmove": recs[0]["pmove"], "seconds": recs[0]["seconds"],
        "peak_memory_bytes": peak, "sampler_move_peak_memory_bytes": sampler_peak,
        "launches": launches, "launch_shapes": shapes,
        "b1_bodies": b1_bodies(shapes),
        "drift_rel_err_global_norm": drift_err, "drift_global_norm_cpu_f64": drift_norm,
        "drift_tolerance": DRIFT_TOLERANCE["diamond"],
    }
    result["ok"] = (
        math.isfinite(energy) and abs(energy - REFERENCE_ENERGY) <= ENERGY_WINDOW
        and 0 < result["pmove"] <= 1 and result["b1_bodies"] == {48: ["registers"]}
        and launches["fused_dense_tanh_jet"] > 0 and launches["fused_dense_tanh_jet_mix"] > 0
        and drift_err <= DRIFT_TOLERANCE["diamond"])
    emit(result)
    return result


@contextlib.contextmanager
def no_linalg_solvers():
    """A context in which a torch.linalg factorization, inverse, solve or
    determinant raises: the engines must take B1 for every one."""
    import torch

    names = ("inv", "inv_ex", "det", "slogdet", "solve", "solve_ex", "lu", "lu_factor",
             "lu_factor_ex", "cholesky", "cholesky_ex", "qr", "eig", "eigh", "svd")

    def refuse(name):
        def call(*args, **kwargs):
            raise RuntimeError(f"torch.linalg.{name} ran on an engine's path")
        return call

    saved = {n: getattr(torch.linalg, n) for n in names}
    for n in names:
        setattr(torch.linalg, n, refuse(n))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch.linalg, n, fn)


def measured(dev, fn):
    """(result, seconds, peak device bytes, B1 launches) of one call of fn,
    or (None,) * 4 when it runs out of device memory."""
    import torch

    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    start = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize(dev)
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return None, None, None, None
    return (out, time.perf_counter() - start, torch.cuda.max_memory_allocated(dev),
            read_launches()["gj_inverse_slogdet"])


def hvp_rows(dev, gen):
    """One Hessian-vector product of sum log|det A| through B1's rule
    (the kernel in the forward, the closed-form rule in both backward
    passes) against the same through B1's plain version on the card."""
    import torch
    from deepsolid_tpu_torch.ops import slogdet as slog
    from deepsolid_tpu_torch.ops.cuda import det_kernels as dk

    rows = []
    for nb, n, _ in HVP_SHAPES:
        def rnd():
            return torch.complex(torch.randn((nb, n, n), generator=gen, device=dev),
                                 torch.randn((nb, n, n), generator=gen, device=dev))

        a0 = 2.0 * torch.eye(n, device=dev) + rnd() / math.sqrt(2 * n)
        v = rnd()

        def hvp():
            a = a0.clone().requires_grad_()
            _, logabs = slog.slogdet_op(a)
            (g,) = torch.autograd.grad(logabs.sum(), a, create_graph=True)
            return torch.autograd.grad((g * torch.conj(v)).real.sum(), a)[0]

        reset_launches()
        got = hvp()
        launches = read_launches()["gj_inverse_slogdet"]
        kernel = slog.gj_inverse_slogdet
        slog.gj_inverse_slogdet = dk.gj_inverse_slogdet_plain
        try:
            want = hvp()
        finally:
            slog.gj_inverse_slogdet = kernel
        rel = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
        rows.append({"shape": [nb, n, n], "b1_launches": launches,
                     "rel_err_global_norm": rel, "tolerance": HVP_TOLERANCE,
                     "ok": launches == 1 and rel <= HVP_TOLERANCE})
    return rows


def laplacian_phase(dev, source, gen):
    """The reference Laplacian engines on C-diamond checkpoint walkers at
    full width, against the port's CPU f64 forward E_L."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.hamiltonian import make_local_energy
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.train.loss import make_batch_local_energy
    from deepsolid_tpu_torch.train.process import build_network
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    cfg = diamond_cfg("none", BATCH, "chip_smoke_laplacian")
    sc = cfg.system.cell
    net = build_network(cfg, sc, klist_override=source.klist)
    _, data, params_np, _, _ = restore(find_last_checkpoint(cfg.log.restore_path))
    x_np = np.asarray(data[:LAPLACIAN_RATE_BATCH], np.float64)
    with torch.no_grad():
        ke, ew = make_local_energy(net, sc)(params_from_jax(params_np, "cpu", torch.float64),
                                            torch.as_tensor(x_np[:LAPLACIAN_WALKERS]))
    want = ((ke + ew) / sc.scale).numpy()
    params = params_from_jax(params_np, dev, torch.float32)
    x = torch.as_tensor(x_np, dtype=torch.float32, device=dev)

    def engine(mode, chunk):
        return make_batch_local_energy(net, sc, el_chunk=chunk, mode=mode, partition_number=3)

    engines, ok, shapes = {}, True, []
    with no_linalg_solvers():
        for mode in LAPLACIAN_ENGINES:
            one_peak = None
            if mode == "for":  # one tangent at a time: a few walkers' rows
                chunk = LAPLACIAN_CHUNKS[0]
            else:  # the 1-walker peak, scaled by the walkers of a chunk
                _, _, one_peak, _ = measured(dev, lambda: engine(mode, 1)(params, x[:1]))
                fits = [c for c in LAPLACIAN_CHUNKS
                        if one_peak is not None and c * one_peak < PROBE_LIMIT_BYTES]
                chunk = max(fits) if fits else None
            rec = {"el_chunk": chunk, "one_walker_peak_memory_bytes": one_peak}
            if chunk is not None:
                out, secs, peak, b1 = measured(
                    dev, lambda: engine(mode, chunk)(params, x[:LAPLACIAN_WALKERS]))
                if mode == "partition":
                    shapes = read_shapes()
                if out is not None:
                    el = ((out[0] + out[1]) / sc.scale).cpu().to(torch.complex128).numpy()
                    d = np.abs(el - want)
                    rec.update(walkers=LAPLACIAN_WALKERS, seconds=secs,
                               walkers_per_s=LAPLACIAN_WALKERS / secs,
                               peak_memory_bytes=peak, b1_launches=b1,
                               median_abs_diff_per_cell=float(np.median(d)),
                               max_abs_diff_per_cell=float(d.max()))
            rec["ok"] = ("max_abs_diff_per_cell" in rec and rec["b1_launches"] > 0
                         and rec["median_abs_diff_per_cell"] <= EL_TOLERANCE_MEDIAN
                         and rec["max_abs_diff_per_cell"] <= EL_TOLERANCE_MAX)
            ok = ok and rec["ok"]
            engines[mode] = rec
            emit({"phase": "laplacian_engine", "mode": mode, **rec})

        # 'partition' beside 'forward' at LAPLACIAN_RATE_BATCH walkers
        rates = {}
        part_chunk = engines["partition"]["el_chunk"] or 1
        for mode, chunk in (("forward", EL_CHUNK), ("partition", part_chunk)):
            fn = engine(mode, chunk)
            with torch.no_grad():
                fn(params, x[:chunk])  # warm-up
            _, secs, peak, b1 = measured(dev, lambda: fn(params, x))
            rates[mode] = {"el_chunk": chunk, "seconds": secs, "peak_memory_bytes": peak,
                           "b1_launches": b1,
                           "walkers_per_s": None if secs is None else len(x) / secs}
    hvp = hvp_rows(dev, gen)
    result = {
        "phase": "laplacian", "config": CONFIG, "partition_number": 3,
        "engines": engines, "rate_batch": LAPLACIAN_RATE_BATCH, "rates": rates,
        "partition_over_forward": (rates["partition"]["walkers_per_s"]
                                   / rates["forward"]["walkers_per_s"]
                                   if rates["partition"]["walkers_per_s"] else None),
        "el_tolerance_median": EL_TOLERANCE_MEDIAN, "el_tolerance_max": EL_TOLERANCE_MAX,
        "hessian_vector_products": hvp,
        # the partition engine's 8-walker run, for its B1 kernel row
        "launches": {"gj_inverse_slogdet": engines["partition"].get("b1_launches", 0)},
        "launch_shapes": shapes,
    }
    result["ok"] = (ok and all(r["ok"] for r in hvp)
                    and all(r["walkers_per_s"] for r in rates.values()))
    emit(result)
    return result


def kfac_modes_phase(dev, exact):
    """2 KFAC iterations of each Monte Carlo estimation mode at the kfac
    phase's settings, beside the fisher_exact phase's curvature seconds."""
    results = [kfac_phase(dev, mode, MC_KFAC_ITERATIONS, "kfac_modes") for mode in MC_MODES]
    exact_curvature = exact["seconds_per_iteration"]["curvature"]
    summary = {
        "phase": "kfac_modes_summary",
        "curvature_seconds": {r["optimizer"]: r["seconds_per_iteration"]["curvature"]
                              for r in [exact] + results},
        "curvature_over_fisher_exact": {
            r["optimizer"]: r["seconds_per_iteration"]["curvature"] / exact_curvature
            for r in results},
        "walkers_per_s_iteration_all": {r["optimizer"]: r["walkers_per_s_iteration_all"]
                                        for r in [exact] + results},
        "ok": all(r["ok"] for r in results)}
    emit(summary)
    return summary


def kfac_update_rel_err(dev, cfg, net, params_np, x_np, state_np):
    """Relative error in the global norm of one KFAC update of the walkers
    `x_np` continuing the numpy KFAC state `state_np` (a curvature update,
    then the step; the update is the step's velocities), card f32 against
    CPU f64."""
    import torch
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.optim import kfac as kfac_lib
    from deepsolid_tpu_torch.optim.adam import learning_rate_schedule, tree_leaves
    from deepsolid_tpu_torch.train.loss import make_loss

    total_energy = make_loss(net, cfg.system.cell, clip_local_energy=cfg.optim.clip_el,
                             clip_type=cfg.optim.clip_type)

    def update(device, dtype):
        p = params_from_jax(params_np, device, dtype)
        x = torch.as_tensor(x_np, dtype=dtype, device=device)
        _, grads = total_energy.value_and_grad(p, x)
        opt = kfac_lib.KfacOptimizer.from_config(cfg, net, learning_rate_schedule(cfg))
        state = opt.update_curvature(kfac_lib.state_from_numpy(state_np, device, dtype),
                                     p, x)
        return opt.step_fn(p, state, grads, state["damping"])[1]["velocities"]

    got, want = update(dev, torch.float32), update("cpu", torch.float64)

    def rel(pairs):
        diff2 = sum(float(((g.cpu().double() - w) ** 2).sum()) for g, w in pairs)
        return math.sqrt(diff2 / sum(float((w ** 2).sum()) for _, w in pairs))

    sigma = [(got["envelope"][i]["sigma"], want["envelope"][i]["sigma"])
             for i in range(len(want["envelope"]))]
    norm = math.sqrt(sum(float((w ** 2).sum()) for w in tree_leaves(want)))
    return rel(list(zip(tree_leaves(got), tree_leaves(want)))), norm, rel(sigma)


def full_envelope_phase(dev, si_reference):
    """Si 1x1x1 from scratch with the full envelope: its KFAC blocks per
    atom in the state, the update and E_L of 8 walkers against CPU f64,
    the update beside the same reading on the si phase's isotropic state
    (`si_reference`: its cfg, k-list, numpy parameters and walkers)."""
    import torch
    from deepsolid_tpu_torch.models.network import params_to_numpy
    from deepsolid_tpu_torch.train.process import build_network, orbital_source
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    cfg = si_cfg()
    cfg.network.detnet.envelope_type = "full"
    cfg.log.save_path = os.path.join(REPO, "build", "chip_smoke_full_envelope")
    source = orbital_source(cfg, cfg.system.cell)
    result, params, data = scratch_run(dev, cfg, source, "full_envelope",
                                       SI_KFAC_ITERATIONS, emit_iterations=False)
    result["phase"] = "full_envelope"
    result["config"] = SI_CONFIG + " envelope_type=full"
    ckpt = find_last_checkpoint(cfg.log.save_path)
    state_np = restore(ckpt)[3] if ckpt else {"env_blocks": {}}
    env = state_np["env_blocks"]
    result["env_blocks"] = {k: list(v["g_raw"].shape) for k, v in env.items()}
    params_np = params_to_numpy(params)
    x_np = data[:FULL_ENVELOPE_WALKERS].cpu().double().numpy()
    net = build_network(cfg, cfg.system.cell, klist_override=source.klist)
    upd_rel, upd_norm, sigma_rel = kfac_update_rel_err(dev, cfg, net, params_np, x_np,
                                                       state_np)
    si_cfg_, si_klist, si_params, si_x = si_reference
    si_state = restore(find_last_checkpoint(si_cfg_.log.save_path))[3]
    si_net = build_network(si_cfg_, si_cfg_.system.cell, klist_override=si_klist)
    control_rel, _, _ = kfac_update_rel_err(dev, si_cfg_, si_net, si_params,
                                            si_x[:FULL_ENVELOPE_WALKERS], si_state)
    el = system_el_reference(dev, cfg, source.klist, params_np, x_np)
    (median, worst) = el["card"]
    result.update(kfac_update_rel_err_global_norm=upd_rel,
                  kfac_update_global_norm_cpu_f64=upd_norm,
                  kfac_update_sigma_rel_err_global_norm=sigma_rel,
                  kfac_update_tolerance=KFAC_UPDATE_TOLERANCE,
                  isotropic_control_kfac_update_rel_err_global_norm=control_rel,
                  control_factor=FULL_ENVELOPE_CONTROL_FACTOR,
                  median_abs_diff_per_cell=median, max_abs_diff_per_cell=worst,
                  cpu_f32_abs_diff_per_cell=el["cpu_f32"],
                  tf32_control_abs_diff_per_cell=el["card_tf32"])
    result["ok"] = (result["ok"] and ckpt is not None and len(env) == 2
                    and all(float(abs(v["a_raw"]).max()) > 0 for v in env.values())
                    and sigma_rel <= KFAC_UPDATE_TOLERANCE
                    and upd_rel <= FULL_ENVELOPE_CONTROL_FACTOR * control_rel
                    and median <= EL_TOLERANCE_MEDIAN and worst <= EL_TOLERANCE_MAX)
    emit(result)
    return result


def orb_scan_phase(dev, source, bcc_li_reference):
    """DEEPSOLID_TPU_ORB_SCAN=on against off: one 64-walker C-diamond E_L
    chunk (values, device ms, peak memory) and bcc-Li's chunk memory."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.hamiltonian import make_local_energy
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.train.process import build_network
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    def setup(cfg, klist, ckpt_dir, params_np=None):
        net = build_network(cfg, cfg.system.cell, klist_override=klist)
        _, data, ck_params, _, _ = restore(find_last_checkpoint(ckpt_dir))
        p = params_from_jax(ck_params if params_np is None else params_np, dev, torch.float32)
        x = torch.as_tensor(np.asarray(data), dtype=torch.float32, device=dev)
        return make_local_energy(net, cfg.system.cell), p, x

    old = os.environ.get(ORB_SCAN_ENV)
    out = {}
    try:
        cfg = diamond_cfg("none", BATCH, "chip_smoke_orb_scan")
        el_fn, params, x = setup(cfg, source.klist, cfg.log.restore_path)
        x = x[:EL_CHUNK]
        for scan in ("off", "on"):
            os.environ[ORB_SCAN_ENV] = scan
            with torch.no_grad():
                ms = time_ms(lambda: el_fn(params, x), warmup=1, reps=5)
                el, _, peak, b1 = measured(dev, lambda: el_fn(params, x))
            out[scan] = {"device_ms_per_chunk": ms, "peak_memory_bytes": peak,
                         "b1_launches": b1,
                         "el": ((el[0] + el[1]) / cfg.system.cell.scale).cpu().numpy()}
        diff = float(np.abs(out["on"].pop("el") - out["off"].pop("el")).max())

        bcc_cfg, bcc_klist, bcc_params, _ = bcc_li_reference
        el_fn, params, x = setup(bcc_cfg, bcc_klist, BCC_LI_CKPT, bcc_params)
        bcc = {}
        for scan, chunks in (("off", BCC_LI_SCAN_CHUNKS[:1]), ("on", BCC_LI_SCAN_CHUNKS)):
            os.environ[ORB_SCAN_ENV] = scan
            for c in chunks:
                with torch.no_grad():
                    _, secs, peak, _ = measured(dev, lambda: el_fn(params, x[:c]))
                bcc[f"{scan}_{c}"] = {"peak_memory_bytes": peak, "seconds": secs}
    finally:
        if old is None:
            os.environ.pop(ORB_SCAN_ENV, None)
        else:
            os.environ[ORB_SCAN_ENV] = old
    fits = [c for c in BCC_LI_SCAN_CHUNKS
            if bcc[f"on_{c}"]["peak_memory_bytes"] is not None
            and bcc[f"on_{c}"]["peak_memory_bytes"] < PROBE_LIMIT_BYTES]
    result = {"phase": "orb_scan", "diamond_el_chunk": EL_CHUNK, "diamond": out,
              "max_abs_el_diff_per_cell": diff, "tolerance": ORB_SCAN_TOLERANCE,
              "bcc_li": bcc, "bcc_li_largest_el_chunk_with_scan": max(fits) if fits else None,
              "limit_bytes": PROBE_LIMIT_BYTES}
    result["ok"] = (diff <= ORB_SCAN_TOLERANCE and bool(fits)
                    and out["on"]["b1_launches"] == out["off"]["b1_launches"] == 2)
    emit(result)
    return result


def trace_phase(dev):
    """A StepTracer window (log.trace_path, trace_start 1, trace_steps 1)
    inside a 3-iteration C-diamond inference run."""
    import json as json_lib

    from deepsolid_tpu_torch.train.process import process

    cfg = diamond_cfg("none", TRACE_BATCH, "chip_smoke_trace")
    cfg.log.trace_path = os.path.join(cfg.log.save_path, "trace")
    cfg.log.trace_start, cfg.log.trace_steps = 1, 1
    cfg.mcmc.steps = TRACE_MCMC_STEPS
    shutil.rmtree(cfg.log.save_path, ignore_errors=True)
    seconds = []
    process(cfg, TRACE_ITERATIONS, device="cuda",
            on_iteration=lambda t, row, s: seconds.append(s["step"]))
    files = sorted(os.listdir(cfg.log.trace_path)) if os.path.isdir(cfg.log.trace_path) else []
    kernels = set()
    size = 0
    for name in files:
        path = os.path.join(cfg.log.trace_path, name)
        size += os.path.getsize(path)
        with open(path) as f:
            events = json_lib.load(f)["traceEvents"]
        kernels |= {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    named = {"gj_inverse_slogdet": sorted(k[:60] for k in kernels if "gj_" in k),
             "dense_tanh_jet": sorted(k[:60] for k in kernels if "dense_tanh_jet" in k)}
    result = {"phase": "trace", "batch": TRACE_BATCH, "iterations": TRACE_ITERATIONS,
              "mcmc_steps": TRACE_MCMC_STEPS,
              "trace_start": 1, "trace_steps": 1, "files": files, "bytes": size,
              "kernel_names": len(kernels), "named": named,
              "seconds_per_iteration": seconds,
              "traced_over_untraced": seconds[1] / max(seconds[0], seconds[2])
              if len(seconds) == 3 else None}
    result["ok"] = (len(files) == 1 and len(seconds) == TRACE_ITERATIONS
                    and all(named.values()))
    emit(result)
    return result


def system_el_reference(dev, cfg, klist, params, x):
    """E_L per primitive cell of the walkers `x` (numpy) under the numpy
    parameter tree `params`: the card's f32 kernel path, and the port's
    plain path on the CPU in float32, each against the plain path on the
    CPU in float64, and the card's path with TF32 matmuls as the control
    the check must catch. Returns {"card": (median, max), "cpu_f32":
    (median, max), "card_tf32": (median, max)} of the absolute differences
    and the float64 values."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.device import set_full_precision
    from deepsolid_tpu_torch.hamiltonian import make_local_energy
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.train.process import build_network

    sc = cfg.system.cell
    el_fn = make_local_energy(build_network(cfg, sc, klist_override=klist), sc)
    x = np.asarray(x, np.float64)

    def el(device, dtype):
        with torch.no_grad():
            ke, ew = el_fn(params_from_jax(params, device, dtype),
                           torch.as_tensor(x, dtype=dtype, device=device))
        return (ke + ew).cpu().to(torch.complex128)

    cpu = el("cpu", torch.float64)

    def diffs(got):
        d = ((got - cpu).abs() / sc.scale).numpy()
        return float(np.median(d)), float(d.max())

    got = {"card": diffs(el(dev, torch.float32)),
           "cpu_f32": diffs(el("cpu", torch.float32)),
           "el_cpu_f64_per_cell": (cpu.real / sc.scale).tolist()}
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        got["card_tf32"] = diffs(el(dev, torch.float32))
    finally:
        set_full_precision()
    return got


def reference_phase(dev, source, systems):
    """E_L, the energy gradient and the KFAC update of 8 checkpoint
    walkers: the card's f32 kernel path against the port's plain path on
    the CPU in float64. `systems` maps a name to (cfg, k-list, numpy
    parameters, walkers) of another system whose E_L is held the same
    way (Si, bcc-Li)."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.configs import diamond
    from deepsolid_tpu_torch.device import set_full_precision
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.optim import kfac as kfac_lib
    from deepsolid_tpu_torch.optim.adam import learning_rate_schedule, tree_leaves
    from deepsolid_tpu_torch.train import pretrain as pretrain_lib
    from deepsolid_tpu_torch.train.loss import make_loss
    from deepsolid_tpu_torch.train.process import build_network
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    cfg = diamond.get_config(CONFIG)
    sc = cfg.system.cell
    net = build_network(cfg, sc, klist_override=source.klist)
    _, data, params, opt_state, _ = restore(
        find_last_checkpoint(os.path.join(REPO, "runs", "ckpt_diamond")))
    x = np.asarray(data[:8], np.float64)
    total_energy = make_loss(net, sc, clip_local_energy=cfg.optim.clip_el,
                             clip_type=cfg.optim.clip_type)
    gpu_params = params_from_jax(params, dev, torch.float32)
    gpu_x = torch.as_tensor(x, dtype=torch.float32, device=dev)

    def card_el():
        _, aux = total_energy(gpu_params, gpu_x)
        return aux.local_energy.cpu().to(torch.complex128)

    (_, gpu_aux), gpu_grad = total_energy.value_and_grad(gpu_params, gpu_x)
    gpu = gpu_aux.local_energy.cpu().to(torch.complex128)
    (_, cpu_aux), cpu_grad = total_energy.value_and_grad(
        params_from_jax(params, "cpu", torch.float64),
        torch.as_tensor(x, dtype=torch.float64))
    cpu = cpu_aux.local_energy
    # the energy gradient of these 8 walkers: relative error in the global norm
    diff2 = sum(float(((g.cpu().double() - c) ** 2).sum())
                for g, c in zip(tree_leaves(gpu_grad), tree_leaves(cpu_grad)))
    norm2 = sum(float((c ** 2).sum()) for c in tree_leaves(cpu_grad))
    grad_rel = math.sqrt(diff2 / norm2)

    # the KFAC update of the same walkers and gradients: the checkpoint's
    # state takes one curvature update, then the preconditioned step; the
    # update is the step's velocities
    def kfac_update(p, walkers, grads, device, dtype):
        opt = kfac_lib.KfacOptimizer.from_config(
            production_kfac(cfg), net, learning_rate_schedule(cfg))
        state = kfac_lib.state_from_numpy(opt_state, device, dtype)
        state = opt.update_curvature(state, p, walkers)
        return opt.step_fn(p, state, grads, state["damping"])[1]["velocities"]

    gpu_upd = kfac_update(gpu_params, gpu_x, gpu_grad, dev, torch.float32)
    cpu_upd = kfac_update(params_from_jax(params, "cpu", torch.float64),
                          torch.as_tensor(x, dtype=torch.float64), cpu_grad,
                          "cpu", torch.float64)
    upd_diff2 = sum(float(((g.cpu().double() - c) ** 2).sum())
                    for g, c in zip(tree_leaves(gpu_upd), tree_leaves(cpu_upd)))
    upd_norm2 = sum(float((c ** 2).sum()) for c in tree_leaves(cpu_upd))
    upd_rel = math.sqrt(upd_diff2 / upd_norm2)

    # the pretraining loss against the cached UHF orbitals and its gradient
    pre_vg = pretrain_lib.make_value_and_grad(
        pretrain_lib.make_loss_per_walker(net, source, cfg.network.detnet.full_det))
    gpu_pre_loss, gpu_pre_grad = pre_vg(gpu_params, gpu_x)
    cpu_pre_loss, cpu_pre_grad = pre_vg(params_from_jax(params, "cpu", torch.float64),
                                        torch.as_tensor(x, dtype=torch.float64))
    pre_loss_rel = abs(float(gpu_pre_loss) - float(cpu_pre_loss)) / abs(float(cpu_pre_loss))
    pre_diff2 = sum(float(((g.cpu().double() - c) ** 2).sum())
                    for g, c in zip(tree_leaves(gpu_pre_grad), tree_leaves(cpu_pre_grad)))
    pre_norm2 = sum(float((c ** 2).sum()) for c in tree_leaves(cpu_pre_grad))
    pre_grad_rel = math.sqrt(pre_diff2 / pre_norm2)

    def diffs(el):
        d = ((el - cpu).abs() / sc.scale).numpy()
        return float(np.median(d)), float(d.max())

    # f32 against f64 rounding in the kinetic energy's cancelling terms
    # reads ~1e-4 (median) and ~4e-4 (max) Ha/cell; the limits are ~10x
    # that and below the TF32 bias the full-f32 policy exists to prevent
    # (-3.7 mHa/atom, 7.4 mHa per 2-atom cell)
    tol_median, tol_max = EL_TOLERANCE_MEDIAN, EL_TOLERANCE_MAX
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
        "gradient_rel_err_global_norm": grad_rel,
        "gradient_global_norm_cpu_f64": math.sqrt(norm2),
        "gradient_tolerance": GRADIENT_TOLERANCE,
        "kfac_update_rel_err_global_norm": upd_rel,
        "kfac_update_global_norm_cpu_f64": math.sqrt(upd_norm2),
        "kfac_update_tolerance": KFAC_UPDATE_TOLERANCE,
        "pretrain_loss_cpu_f64": float(cpu_pre_loss),
        "pretrain_loss_rel_err": pre_loss_rel,
        "pretrain_gradient_rel_err_global_norm": pre_grad_rel,
        "pretrain_gradient_global_norm_cpu_f64": math.sqrt(pre_norm2),
        "pretrain_loss_tolerance": PRETRAIN_LOSS_TOLERANCE,
        "pretrain_gradient_tolerance": PRETRAIN_GRADIENT_TOLERANCE,
    }
    # Si and bcc-Li: the same limits; the port's own f32 path on the CPU
    # beside the card says how much of the error is f32's, not the kernels',
    # and each system's TF32 control must fail them as diamond's does
    for name, (sys_cfg, klist, sys_params, sys_x) in systems.items():
        start = time.perf_counter()
        got = system_el_reference(dev, sys_cfg, klist, sys_params, sys_x)
        (card_median, card_max), (f32_median, f32_max) = got["card"], got["cpu_f32"]
        tf32_median, tf32_max = got["card_tf32"]
        tf32_fails = not (tf32_median <= tol_median and tf32_max <= tol_max)
        result[name] = {
            "walkers": len(sys_x), "el_cpu_f64_per_cell": got["el_cpu_f64_per_cell"],
            "median_abs_diff_per_cell": card_median, "max_abs_diff_per_cell": card_max,
            "cpu_f32_median_abs_diff_per_cell": f32_median,
            "cpu_f32_max_abs_diff_per_cell": f32_max,
            "tf32_control_median_abs_diff_per_cell": tf32_median,
            "tf32_control_max_abs_diff_per_cell": tf32_max,
            "tf32_control_fails_check": tf32_fails,
            "ok": card_median <= tol_median and card_max <= tol_max and tf32_fails,
            "seconds": time.perf_counter() - start}
    # a check the TF32 control passes could not guard the precision flags
    result["ok"] = (all(result[name]["ok"] for name in systems)
                    and median <= tol_median and worst <= tol_max
                    and result["tf32_control_fails_check"]
                    and grad_rel <= GRADIENT_TOLERANCE
                    and math.isfinite(upd_rel) and upd_rel <= KFAC_UPDATE_TOLERANCE
                    and pre_loss_rel <= PRETRAIN_LOSS_TOLERANCE
                    and pre_grad_rel <= PRETRAIN_GRADIENT_TOLERANCE)
    emit(result)
    return result


def profile_phase(dev, cfg, klist, params, x, what):
    """Where one local-energy chunk (walkers `x`, numpy parameters `params`)
    spends the card's time."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.hamiltonian import make_local_energy
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.train.process import build_network

    net = build_network(cfg, cfg.system.cell, klist_override=klist)
    params = params_from_jax(params, dev, torch.float32)
    x = torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
    el_fn = make_local_energy(net, cfg.system.cell)
    return profile_fn(dev, lambda: el_fn(params, x), what)


def profile_fn(dev, fn, what):
    """Where one call of `fn` spends the card's time: kernels by device
    time from torch.profiler, and the device's busy share of the call's
    wall time (after one warm-up call)."""
    import torch
    from torch.autograd import DeviceType

    with torch.no_grad():
        fn()  # warm-up
        torch.cuda.synchronize(dev)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            fn()
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
    result = {"phase": "profile", "what": what,
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

    # every phase takes the UHF orbital source (and its k-list) from the
    # committed cache; a cold UHF would take minutes, so its absence fails
    # here, before any SCF work
    os.environ["DEEPSOLID_TPU_SCF_CACHE"] = SCF_CACHE
    source = source_phase()
    if source is None:
        return fail(f"no converged UHF solution for {CONFIG} in {SCF_CACHE}")

    seconds, log = build.build(ptxas_verbose=True)
    emit({"phase": "build", "seconds": seconds, "sources": list(build.SOURCES)})
    emit({"kernel_resources": build.resources(log)})

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kernels = kernel_phase(dev, gen)
    for row in kernels:
        emit({"phase": "kernel", **row})
    bad = [r["name"] for r in kernels if not r["ok"]]
    if bad:
        return fail(f"kernels disagree with their plain versions: {bad}")

    main_result = main_phase(dev)
    energy = main_result["energy_per_cell"]
    if not (math.isfinite(energy) and abs(energy - REFERENCE_ENERGY) <= ENERGY_WINDOW):
        return fail(f"energy {energy} Ha/cell is not within {ENERGY_WINDOW} "
                    f"of {REFERENCE_ENERGY}")

    sharded = sharded_phase(dev)
    if not sharded["ok"]:
        return fail("the sharded phase failed its checks (launch counts, E_L "
                    "against the unsharded port with and without the orbital "
                    "scan, or the energy window)")

    # each kernel's count on the path that runs it, read just after that
    # path: the unsharded inference path for the closed kernels, rank 0 of
    # the sharded path for the open mix kernel, and rank 0's sharded
    # dense_tanh for the open plain kernel (process() keeps the pair
    # stream rank-local, so no path of process() reaches it)
    path_launches = {
        **main_result["launches"],
        "fused_dense_tanh_jet_mix_partial":
            sharded["launches_per_rank"][0]["fused_dense_tanh_jet_mix_partial"],
        "fused_dense_tanh_jet_partial":
            sharded["algebra_launches_per_rank"][0]["fused_dense_tanh_jet_partial"],
    }
    for row in kernels:
        row["launches"] = path_launches[row["name"]]
    idle = [r["name"] for r in kernels if r["launches"] <= 0]
    if idle:
        return fail(f"the driven paths launched no {idle}")

    if not bootstrap_phase(dev)["ok"]:
        return fail("the bootstrap phase failed its checks (torchrun's rank not "
                    "on NCCL and cuda:0, its energy against this process's, or "
                    "the explicit NCCL bootstrap's reduction)")
    data_ranks, reference = data_ranks_phase(dev)
    if not data_ranks["ok"]:
        return fail("the data_ranks phase failed its checks (the KFAC update or "
                    "the energy against one process, a host tensor at a "
                    "collective, the files of rank 0, or a kernel never launched)")
    if not nccl_ranks_phase(dev, reference)["ok"]:
        return fail("the nccl_ranks phase failed its checks (the data_ranks or "
                    "sharded checks over NCCL ranks on a card each)")

    if not training_phase(dev)["ok"]:
        return fail("the training phase failed its checks")

    kfac = kfac_phase(dev)
    if not kfac["ok"]:
        return fail("the KFAC phase failed its checks (state not restored, a "
                    "non-finite parameter or factor, no damping adaptation, "
                    "the checkpoint, or the energy window)")

    if not pretrain_phase(dev, source)["ok"]:
        return fail("the pretrain phase failed its checks (the loss did not "
                    "fall, a non-finite loss, walker or energy, the step-0 "
                    "checkpoint, or a kernel of the path never launched)")

    si, si_reference = si_phase(dev)
    if not si["ok"]:
        return fail("the si phase failed its checks (the pretraining loss did "
                    "not fall, a non-finite value, a checkpoint that does not "
                    "restore, a kernel of the path never launched, or B1 at "
                    "n = 14 not on the warp body)")

    bcc_li, bcc_li_reference = bcc_li_phase(dev)
    if not bcc_li["ok"]:
        return fail("the bcc_li phase failed its checks (no el_chunk or "
                    "psi_chunk under the memory limit, the restore, B1 "
                    "launches beyond the sampler, E_L and KFAC, B1 at n = 81 "
                    "not on the mid body, a non-finite parameter, factor or "
                    "energy, or the checkpoint)")

    # B1, B2 and B3 at the shapes these two paths gave them, each row with
    # its path's launch count and the launches at each of its shapes
    shaped = production_kernel_rows(dev, gen, bcc_li["el_chunk"], bcc_li["psi_chunk"])
    kernels += shaped
    bad = with_path_launches(shaped, {"si": si, "bcc_li": bcc_li})
    if bad:
        return fail(f"kernels at the Si and bcc-Li shapes disagree with their "
                    f"plain versions or their path launched none at a shape: {bad}")

    h10 = h10_phase(dev)
    if not h10["ok"]:
        return fail("the h10 phase failed its checks (the cold UHF, the "
                    "pretraining loss did not fall, a non-finite value or a "
                    "pmove outside (0, 1], a checkpoint, B1 at n = 5 not on "
                    "the warp body, a sampler's B1 launches, the drift or the "
                    "observables against CPU f64)")
    shaped = h10_kernel_rows(dev, gen, h10)
    kernels += shaped
    bad = with_path_launches(shaped, {"h10": h10})
    if bad:
        return fail(f"kernels at the H10 shapes disagree with their plain "
                    f"versions or the h10 path launched none at a shape: {bad}")
    if not diamond_importance_phase(dev, source)["ok"]:
        return fail("the diamond_importance phase failed its checks (the "
                    "energy window, pmove, B1 at n = 48 not on the registers "
                    "body, a jet kernel never launched, or the drift against "
                    "CPU f64)")

    laplacian = laplacian_phase(dev, source, gen)
    if not laplacian["ok"]:
        return fail("the laplacian phase failed its checks (an engine's E_L "
                    "against CPU f64, no memory for an engine, no B1 launch, "
                    "a torch.linalg solver on an engine's path, or a "
                    "Hessian-vector product against B1's plain version)")
    b1_part = sorted({tuple(r["shape"]) for r in laplacian["launch_shapes"]
                      if r["kernel"] == "gj_inverse_slogdet"})
    shaped = [b1_row(dev, gen, nb, n, "laplacian") for nb, n, _ in b1_part]
    kernels += shaped
    bad = with_path_launches(shaped, {"laplacian": laplacian})
    if bad:
        return fail(f"B1 at the partition engine's shapes disagrees with its "
                    f"plain version or launched none: {bad}")
    if not kfac_modes_phase(dev, kfac)["ok"]:
        return fail("the kfac_modes phase failed its checks (a Monte Carlo "
                    "mode's state not restored, a non-finite parameter or "
                    "factor, or its checkpoint)")
    if not orb_scan_phase(dev, source, bcc_li_reference)["ok"]:
        return fail("the orb_scan phase failed its checks (E_L with the scan "
                    "against without, B1 launches, or no bcc-Li el_chunk under "
                    "the memory limit with the scan)")
    if not trace_phase(dev)["ok"]:
        return fail("the trace phase failed its checks (not one trace file, "
                    "or B1's or the jet kernels' names missing from it)")

    if not full_envelope_phase(dev, si_reference)["ok"]:
        return fail("the full_envelope phase failed its checks (the run, its "
                    "per-atom KFAC blocks, the KFAC update or E_L against CPU f64)")
    if not reference_phase(dev, source, {"si": si_reference,
                                         "bcc_li": bcc_li_reference})["ok"]:
        return fail("card E_L (C-diamond, Si or bcc-Li), its gradient, the "
                    "KFAC update or the pretraining loss or its gradient "
                    "disagrees with the CPU float64 reference, or the TF32 "
                    "control passed the check")
    from deepsolid_tpu_torch.configs import diamond
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    _, data, params, _, _ = restore(
        find_last_checkpoint(os.path.join(REPO, "runs", "ckpt_diamond")))
    profile_phase(dev, diamond.get_config(CONFIG), source.klist, params, data[:EL_CHUNK],
                  "one 64-walker C-diamond local-energy chunk")
    bcc_cfg, bcc_klist, _, _ = bcc_li_reference
    _, data, params, _, _ = restore(find_last_checkpoint(BCC_LI_CKPT))
    profile_phase(dev, bcc_cfg, bcc_klist, params, data[:bcc_li["el_chunk"]],
                  f"one {bcc_li['el_chunk']}-walker bcc-Li local-energy chunk")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi, flush=True)
    emit({"kernels": [{k: r[k] for k in keys} for r in kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
