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
     north_star - C-diamond's KFAC step as production sets it, from the
                same checkpoint state: a probe reads the peak memory of
                KFAC's unchunked capture at 1024 walkers, then 3
                iterations with psi_chunk unset as runs/diamond_run.py
                sets it (or, where the capture does not fit 60 GB, the
                largest of 256 and 512 that does) and the KFAC update of
                8 of its final walkers against CPU f64; then batch 4096
                (BASELINE.json's metric; the checkpoint's walkers grown by
                the elastic restore) at the largest psi_chunk of 512,
                1024, 2048, 4096 under 60 GB, 2 iterations: the second
                one's seconds, split, walkers/s and peak memory beside the
                card's name and power limit, each beside the kfac phase's
                psi_chunk 64 split; B1 held and timed at the 4096 run's
                sampler shape and at the unchunked (32768, 48, 48);
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
                committed step-0 checkpoint, a handoff (restored at
                iteration 0: no pretraining, the run script's 100 burn-in
                sweeps) with a fresh optimizer state;
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
     lih, graphene - LiH rock-salt 2x2x2 (16 atoms, 32 electrons, batch
                2048) and graphene 1x1 (12 electrons in a slab cell with a
                20 Bohr c axis, hexagonal features, batch 1024), each from
                a cold UHF solved on the host into a scratch cache, then
                its run script's path (runs/lih_run.py,
                runs/graphene_run.py: el_chunk 256, psi_chunk unset,
                loaded through the command line's config loader) from its
                first step with the pretrain phase's cuts; E_L and the
                Ewald term of 8 final walkers against CPU f64 with a TF32
                control that must fail the limits, the Ewald's share of a
                256-walker E_L chunk and a profile of one; B1 on the warp
                body (n = 16, n = 6), B1, B2 and B3 held and timed at every
                shape the path launched;
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
                the unsharded det head in one window;
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
 18. float64  - precision='float64' on the card through the kernels'
                float64 bodies (B1's complex128 warp body up to n = 32,
                register body at 48, mid body at 49-96 and shared-memory
                body elsewhere, the one-electron jets' wide
                body on the FP64 tensor cores, the pair jet body in double
                for the two-electron layers): el_chunk and psi_chunk from a
                float64 probe of the card's peak memory; C-diamond 2x2x2 at
                full width from runs/ckpt_diamond cast to float64, one
                inference and 2 KFAC fisher_exact iterations (batch 1024)
                through process(), the inference iteration again through
                `python -m deepsolid_tpu_torch --config.precision float64`
                (its energy within 1e-6 Ha/cell of process()'s): their
                split, walkers/s beside the float32 phases', peak memory,
                B1's exact launch count, every launch on a float64 body
                (every one-electron jet launch on the wide body in double,
                every two-electron one, closed or open, on the pair body in
                double, every (., 48, 48) B1 launch on the complex128
                register body, every det head launch on the complex128
                tensor-core body) and no plain version called; one
                E_L chunk over two deriv ranks on the card (B4a, B4b) against
                one process; the reference phase's walkers card float64
                against CPU float64 (E_L <= 1e-9 Ha/cell, the gradient's and
                KFAC update's norms <= 1e-10 relative; the card's float32
                readings must fail both; the Si walkers' B1 launches on the
                warp body, bcc-Li's on the mid body); float32's bias on the
                1024 checkpoint walkers beside the 1e-4 Ha/atom budget; a
                profile of one float64 E_L chunk; each float64 body against
                its plain version at the production shapes of every system
                and at both ends of the warp and mid bodies' ranges, B1 also
                on the edge matrices at n = 14, 16, 32, 48, 49, 81, 96; the
                pair body in double (B2 and B4a rows, and the float64_systems
                phase's) also against the general body in double on the same
                inputs: bit for bit, within 1e-13 relative, timed in turns;
     float64_systems - bcc-Li 3x3x3 and Si 1x1x1 at full width in float64
                through process(): bcc-Li from its handoff checkpoint cast
                to float64 (el_chunk and psi_chunk from a float64 probe of
                8, 16, 32 and 128, 256, 512 walkers, 2 of the run script's
                100 burn-in sweeps, one KFAC iteration), Si from the si
                phase's last checkpoint (psi_chunk unset, one inference and
                one KFAC iteration): each run's split, walkers/s beside the
                float32 phase's, peak memory, B1's exact launch count with
                every (., 81, 81) launch on the mid complex128 body and
                every (., 14, 14) launch on the warp complex128 body, every
                det head launch on the body its n names (bcc-Li's on the
                tensor cores, Si's on FMA), every launch on a float64 body,
                no plain version called; B1 then held against its plain
                version and timed at every shape the two paths launched,
                and the det head kernel at bcc-Li's E_L chunk.
                `bcc_li_float64(dev)` runs the bcc-Li part alone, on the
                kernels of the checkout it is imported from;
     si_2x2x2 - Si 2x2x2 (224 electrons, 112 a spin) as the benchmark
                cell si-f32-kfac-512 runs it (portbench's configuration,
                traffic and step-0 handoff): one KFAC iteration through
                process() with B1's exact launch count, every (., 112, 112)
                launch on the mid wide body and every det head launch on
                the staged complex64 body at (el_chunk x 8, 112, T 672),
                two an E_L chunk and pass; then B1 at both of its shapes
                and the det head kernel at its shape against their plain
                versions (the det head's 96 tangents at a time);
Launch counts are set to 0 just before each driven path and read just
after it. The last lines are the card as nvidia-smi reports it, the
kernels line and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
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
# LiH rock-salt 2x2x2 and graphene 1x1 from a cold UHF, as runs/lih_run.py
# and runs/graphene_run.py set them (psi_chunk unset), loaded through the
# command line's config loader; the pretrain phase's cuts
COLD_SYSTEMS = {
    "lih": dict(config="rock_salt.py", spec="Li,H,4.02,2,sto-3g", batch=2048,
                el_chunk=256, burn_in=200, pretrain_iterations=1000,
                label="LiH 2x2x2"),
    "graphene": dict(config="graphene.py", spec="C,C,2.46,1,20,sto-3g", batch=1024,
                     el_chunk=256, burn_in=200, pretrain_iterations=500,
                     label="graphene"),
}
COLD_KFAC_ITERATIONS = 2
COLD_REFERENCE_WALKERS = 8
# C-diamond 2x2x2's KFAC step as production sets it, from the checkpoint:
# (a) runs/diamond_run.py's batch with psi_chunk unset where the unchunked
# capture fits (else the largest fallback that does), (b) BASELINE.json's
# batch 4096 at the largest psi_chunk candidate under PROBE_LIMIT_BYTES
NORTH_STAR_ITERATIONS = 3
NORTH_STAR_FALLBACK_PSI_CHUNKS = (256, 512)
NORTH_STAR_BATCH = 4096
NORTH_STAR_BATCH_ITERATIONS = 2
NORTH_STAR_PSI_CHUNKS = (512, 1024, 2048, 4096)
# Si 2x2x2 (16 atoms, 224 electrons, 112 a spin) as the benchmark cell
# runs it: its configuration, traffic and step-0 handoff (portbench/), one
# KFAC iteration from the start the seed draws
SI_2X2X2_CELL = "si-f32-kfac-512"
SI_2X2X2_SEED = 3000000501
SI_2X2X2_ITERATIONS = 1
# tangents a window of the det head row's plain version at Si 2x2x2's
# (256, 112, T 672): all 672 at once do not fit beside the row's jr
DETHEAD_PLAIN_WINDOW = 96
# the Gauss-Jordan body each system's launches must take (by n alone)
B1_BODY = {"si": "warp", "bcc_li": "mid", "h10": "warp", "lih": "warp",
           "graphene": "warp", "north_star_4096": "registers", "si_2x2x2": "mid, wide"}
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
# float64 phase: precision='float64' on the card through the float64 bodies
F64_EL_CHUNKS = (32, 64, 128)        # el_chunk candidates, probed at float64
F64_PSI_CHUNKS = (BATCH,)            # psi_chunk unset where the capture fits,
F64_FALLBACK_PSI_CHUNKS = (256, 512)  # else the largest of these under the limit
F64_KFAC_ITERATIONS = 2
# Ha/cell, max |E_L card f64 - CPU f64| (and sharded), and relative, the
# gradient's and KFAC update's norms: 3000x and 2000x the first readings
# (3.0e-13 diamond, 7.2e-14 bcc-Li; 5.0e-14 both norms), 1e-7 and 1e-8
# before them; float32's 2^-29 coarser rounding reads 1e-5-1e-3 and fails
F64_EL_TOLERANCE = 1e-9
F64_REL_TOLERANCE = 1e-10
F32_BIAS_BUDGET = 2e-4     # Ha per 2-atom primitive cell: 1e-4 Ha/atom
# Ha/cell, |E_L float32 - float64| per walker on the card over the 1024
# checkpoint walkers: the median, the largest, and the most any walker's
# reads above the float32 plain head's (`plain_det_head`) on the same
# walker ("above_composition": the limit was set against the composition
# mul_row + slogdet_jet, which read 3.7e-4 there). Readings of the
# kernel's path (the same on every run: fixed walkers, no atomics):
# 8.1e-5, 7.83e-2 (walker 327, where the plain head reads the same:
# float32's own error near a node; the next 5.8e-3) and 2.3e-4
F32_EL_LIMITS = {"median": 3e-4, "max": 0.1, "above_composition": 1e-3}
F64_SHARD_WALKERS = 32     # one E_L chunk over two deriv ranks on the card
JET_F64_TOLERANCE = 1e-10  # relative, a float64 jet body against its plain version
# relative, the pair body in double against the general body in double:
# both sum in one order, so they are expected to agree bit for bit
PAIR_F64_GENERAL_TOLERANCE = 1e-13
# B1 complex128 rows beside the float64 paths' own shapes: C-diamond's,
# bcc-Li's run-script sampler (psi_chunk 512), LiH's, H10's and graphene's
# sampler and E_L shapes, and both ends of the warp and mid bodies' ranges
B1_F64_SHAPES = ((BATCH * 8, 48), (EL_CHUNK * 8, 48), (4096, 81), (16384, 16),
                 (2048, 16), (16384, 5), (8192, 6), (2048, 6),
                 *((1024, n) for n in (1, 16, 17, 32, 49, 96)))
# float64 bcc-Li and Si through process(): bcc-Li's chunks probed below the
# float32 ones, its handoff's 100 burn-in sweeps cut to 2
F64_BCC_LI_EL_CHUNKS = (8, 16, 32)
F64_BCC_LI_PSI_CHUNKS = (128, 256, 512)
F64_BCC_LI_BURN_IN = 2
F64_SYSTEM_KFAC_ITERATIONS = 1
BOOTSTRAP_TOLERANCE = 1e-6  # Ha/cell: torchrun's rank against this process, same card
DATA_RANKS_ENERGY_TOLERANCE = 5e-4  # Ha/cell, the sharded limit: f32 sums in another order
REFERENCE_ENERGY = -66.0  # Ha/cell, runs/ckpt_diamond/train_stats_r5_latest.csv
ENERGY_WINDOW = 1.5       # Ha/cell, a sanity bound; the reference phase is the exact check
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, FP32 (non-tensor)
# FLOP/s, FP64 on the tensor cores and FP64 FMA outside them
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_FP64_TENSOR = 67e12
PEAK_FP64_FMA = 34e12
_START = time.perf_counter()
# ptxas's registers, spills and shared memory of each kernel, from main's build
KERNEL_RESOURCES = []
# CPU float64 readings shared by the reference and float64 phases
_CPU_F64 = {}


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the script's seconds so
    far (`script_seconds`), which say what each phase costs."""
    if "phase" in obj:
        obj = {**obj, "script_seconds": round(time.perf_counter() - _START, 1)}
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


def bound_ms(nbytes: float, flops: float, peak: float = None):
    """The least time for `nbytes` moved and `flops` done: bytes at the
    memory rate, operations at `peak` (default the FP32 peak)."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / (peak or PEAK_FP32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_errs(got, want):
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    return err, err / scale


def gj_edge_cases(dev, gen, errs, dtype=None, tol=5e-3, ns=(48, 14, 81)):
    """The Gauss-Jordan kernel against its plain version on matrices that
    exercise the pivot rule, at each n of `ns` (by default 48, 14 and 81:
    the registers, warp and mid bodies at the three systems' sizes), and on
    generic matrices at both ends of every body's range: `errs(a)` gives
    (inverse, sign, log|det|) errors, each held to `tol`. One record per
    case, with the body that took it. complex128 (`dtype`) has the same
    four bodies, up to n = 118."""
    import torch
    from deepsolid_tpu_torch.ops.cuda import det_kernels as dk

    dtype = dtype or torch.complex64

    def rnd_c(nb, n):
        return torch.complex(torch.randn((nb, n, n), generator=gen, device=dev),
                             torch.randn((nb, n, n), generator=gen, device=dev)).to(dtype)

    def body(n):
        return dk.launcher(dk._lib(), dtype, n, dev)[0]

    cases = {}
    for n in ns:
        eye = torch.eye(n, device=dev).to(dtype)
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
    # complex64's mid wide 97-128, shared from 97 (complex128) or 129 to the
    # shared-memory limit (complex128's at 118)
    top = 168 if dtype == torch.complex64 else 118
    wide = (112, 128, 129) if dtype == torch.complex64 else ()
    for n in (1, 13, 16, 17, 32, 33, 47, 49, 96, 97, *wide, top):
        cases[f"generic_{n}"] = rnd_c(16, n) / math.sqrt(2 * n)
    out = []
    for name, a in cases.items():
        inv, sg, ld = errs(a)
        out.append({"case": name, "body": body(a.shape[-1]),
                    "max_rel_err_inverse": inv, "max_abs_err_sign": sg,
                    "max_abs_err_logdet": ld,
                    "ok": inv <= tol and sg <= tol and ld <= tol})
    # a zero pivot: log 0 = -inf on both, no fault; a NaN entry: NaN on both
    for n in ns:
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
                same = same and abs(float(got[1] - want[1])) <= tol
            out.append({"case": name, "body": body(n),
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


def b1_row(dev, gen, nb, n, path="main", dtype=None):
    """The Gauss-Jordan kernel on `nb` Gaussian n x n complex64 (or
    `dtype`) matrices against its plain version, timed beside its bound
    and torch.linalg.inv + slogdet. `path` names the driven path whose
    launch count the row reports."""
    import torch
    from deepsolid_tpu_torch.ops.cuda import det_kernels as dk
    from deepsolid_tpu_torch.ops.cuda.time_kernels import graph_ms

    dtype = dtype or torch.complex64
    c128 = dtype == torch.complex128
    a = (torch.complex(torch.randn((nb, n, n), generator=gen, device=dev),
                       torch.randn((nb, n, n), generator=gen, device=dev))
         / math.sqrt(2 * n)).to(dtype)
    inv_err, sg_err, ld_err = gj_errs(a)
    # Gaussian matrices: the worst-conditioned of 8192 amplifies f32
    # rounding-order differences to ~1e-3 of the inverse's scale; the
    # same amplification of f64's 2^-53 stays below 1e-9
    tol = 1e-9 if c128 else 5e-3
    item = a.element_size()  # 8 or 16 bytes a complex entry
    b1_bytes = 2 * a.numel() * item + nb * (item + item // 2)
    b1_flops = 8.0 * n**3 * nb  # n^3 complex multiply-adds
    bnd, by = bound_ms(b1_bytes, b1_flops, PEAK_FP64_TENSOR if c128 else None)
    extra = ({"bound_ms_fp64_fma": bound_ms(b1_bytes, b1_flops, PEAK_FP64_FMA)[0]}
             if c128 else {})
    variant = dk.launcher(dk._lib(), dtype, n, dev)[0]
    return {
        "name": "gj_inverse_slogdet", "route": "cuda",
        "source": "deepsolid_tpu_torch/ops/cuda/csrc/gj_inverse.cu",
        "replaces": "deepsolid_tpu/ops/pallas/det_kernels.py:172",
        "per": f"one launch on ({nb}, {n}, {n}) {str(dtype)[6:]}", "path": path,
        "dtype": str(dtype)[6:], "shapes": [[nb, n, n]],
        "variant": variant,
        "max_abs_err": ld_err, "max_rel_err_inverse": inv_err,
        "max_abs_err_sign": sg_err, "tolerance": tol,
        # complex128 rows also hold the body to the size rule
        "ok": (inv_err <= tol and ld_err <= tol and sg_err <= tol
               and (not c128 or variant == b1_body_c128(n))), **extra,
        "ms": time_ms(lambda: dk.gj_inverse_slogdet(a)),
        "graph_ms": graph_ms(lambda: dk.gj_inverse_slogdet(a)),
        "plain_ms": time_ms(lambda: dk.gj_inverse_slogdet_plain(a), reps=5),
        "library_ms": time_ms(lambda: (torch.linalg.inv(a), torch.linalg.slogdet(a))),
        "bound_ms": bnd, "bound_by": by,
    }


def windowed_plain(args, window=None):
    """dethead_traces_plain on `window` tangents at a time (all at once
    for None): trb concatenated, l2 summed over the windows."""
    import torch
    from deepsolid_tpu_torch.ops.cuda import dethead_kernels as dh

    jr, jbc, ep_val, ep_jac3, orb_val0, a_inv, offset, t0 = args
    window = window or jr.shape[0]
    parts = [dh.dethead_traces_plain(jr[s:s + window], jbc[s:s + window], ep_val, ep_jac3,
                                     orb_val0, a_inv, offset, t0 + s)
             for s in range(0, jr.shape[0], window)]
    return torch.cat([p[0] for p in parts]), sum(p[1] for p in parts)


def dethead_row(dev, gen, walkers, n, t_dim, path="main", dtype=None, window=None):
    """The det head kernel through the main path's call
    (dethead_kernels.dethead_traces) on one spin channel of an E_L chunk:
    `walkers` x 8 determinants of n x n matrices, all t_dim tangents, the
    second channel (offset n) with the row-constant block's tangents, in
    float32 (or `dtype`) products; against its plain version (each output
    within 2e-5 of its largest entry, 1e-12 in float64; `window` tangents
    at a time where all do not fit), two launches bit for bit, timed
    beside its bound. `path` names the driven path whose launch count the
    row reports."""
    import torch
    from deepsolid_tpu_torch.ops import fwdlap as fl
    from deepsolid_tpu_torch.ops.cuda import dethead_kernels as dh

    real = dtype or torch.float32
    f64 = real == torch.float64
    ndet, offset = 8, n
    matrices = walkers * ndet
    torch.cuda.empty_cache()

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(real)

    def crnd(*shape):
        return torch.complex(rnd(*shape), rnd(*shape))

    mat = (walkers, ndet, n, n)
    # orbitals near the identity and a factor near 1: moderate inverses
    val = torch.eye(n, device=dev, dtype=real) + crnd(*mat) / math.sqrt(2 * n)
    b_val = 1.0 + 0.1 * crnd(*mat)
    a_inv = fl.det_factor(val * b_val)[0]
    jr = rnd(t_dim, walkers, n, 2 * ndet * n) / math.sqrt(n)
    jbc = rnd(t_dim, walkers, 2 * ndet * n) / math.sqrt(n)
    args = (jr, jbc, b_val, crnd(3, *mat), val, a_inv, offset, 0)
    before = dh.SHAPES.copy()
    got = dh.dethead_traces(*args)
    again = dh.dethead_traces(*args)
    torch.cuda.synchronize(dev)
    counted = dh.SHAPES - before
    want = windowed_plain(args, window)
    abs_errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    errs = [e / float(w.abs().max()) for e, w in zip(abs_errs, want)]
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    del got, again, want
    tol = 1e-12 if f64 else 2e-5
    item = jr.element_size()
    nbytes = item * (jr.numel() + jbc.numel()) + 2 * item * (
        5 * matrices * n * n + (t_dim + dh.splits(t_dim)) * matrices)
    flops = 8.0 * n**3 * matrices * t_dim  # A^-1 J_t, n^3 complex multiply-adds
    bnd, by = bound_ms(nbytes, flops, PEAK_FP64_TENSOR if f64 else None)
    extra = {"bound_ms_fp64_fma": bound_ms(nbytes, flops, PEAK_FP64_FMA)[0]} if f64 else {}
    body = dh.body(n, real)
    key = (dh.KERNEL, (matrices, n, t_dim), body)
    # the body's kernel as ptxas named it: the template on the scalar and the
    # tile, or the tensor-core body (its two- and five-slot builds)
    kernel = ("dethead_trace_kernel_dmma" if body == dh.BODY_C128 else
              f"dethead_trace_kernelI{'d' if f64 else 'f'}Li{dh._lib().dethead_tile_cols(n, int(f64))}EE")
    row = {
        "name": dh.KERNEL, "route": "cuda",
        "source": "deepsolid_tpu_torch/ops/cuda/csrc/dethead_trace.cu",
        "replaces": None,  # XLA's fl.mul_row + slogdet_jet in the JAX package
        "per": f"one launch on ({matrices}, {n}, T {t_dim}) {body}",
        "path": path, "dtype": str(real)[6:], "shapes": [[matrices, n, t_dim]],
        "variant": body, "splits": dh.splits(t_dim),
        "max_abs_err": max(abs_errs), "max_rel_err_trb": errs[0], "max_rel_err_l2": errs[1],
        "max_rel_err": max(errs),
        "tolerance": tol, "same_bits_two_launches": same, "counted": counted == {key: 2},
        "ok": max(errs) <= tol and same and counted == {key: 2}, **extra,
        "ms": time_ms(lambda: dh.dethead_traces(*args), reps=10),
        "plain_ms": time_ms(lambda: windowed_plain(args, window), warmup=1, reps=3),
        "plain_window": window,
        "library_ms": None, "bound_ms": bnd, "bound_by": by,
        # registers, spills, shared memory a block and blocks an SM
        "resources": [r for r in KERNEL_RESOURCES if r["kernel"].startswith(kernel)],
        **dh.occupancy(n, real),
    }
    del args, jr, jbc, val, b_val, a_inv
    torch.cuda.empty_cache()
    return row


def recorded(fn):
    """fn()'s result and the kernel body of the one jet launch it made, as
    the wrapper counted it."""
    from deepsolid_tpu_torch.ops.cuda import jet_kernels as jk

    before = jk.SHAPES.copy()
    out = fn()
    (key,) = (jk.SHAPES - before).keys()
    return out, key[2]


def jet_bytes_flops(t, r, k, c, mix_groups=0, item=4):
    nbytes = item * ((t + 2) * r * k + k * c + c + (t + 2) * r * c
                     + (t + 2) * mix_groups * c)
    return nbytes, 2.0 * (t + 2) * r * k * c


def jet_bound(nbytes, flops, dtype):
    """(bound ms, bound_by, extra keys) of a jet row: float64 rows are
    bound at the FP64 tensor-core peak, with the FMA-only bound beside."""
    import torch

    if dtype != torch.float64:
        return (*bound_ms(nbytes, flops), {})
    return (*bound_ms(nbytes, flops, PEAK_FP64_TENSOR),
            {"bound_ms_fp64_fma": bound_ms(nbytes, flops, PEAK_FP64_FMA)[0]})


def pair_f64_against_general(args, open_sum):
    """A float64 plain-rule jet at a pair shape on the pair body in double
    against the general body in double on the same inputs: whether the
    outputs agree bit for bit, the largest difference relative to each
    output's scale, and both bodies' launch times in turns (general, pair,
    pair, general; the launchers alone, as time_kernels times them), with
    the pair body's ptxas resources."""
    from deepsolid_tpu_torch.ops.cuda import jet_kernels as jk
    from deepsolid_tpu_torch.ops.cuda import time_kernels as tk

    d_in = args[0].shape[1]
    lib = jk._lib()
    pair = tk.jet_launcher(lib, jk.PAIR, *args, None, open_sum)
    general = tk.jet_launcher(lib, 0, *args, None, open_sum)
    pair()
    general()
    same = tk.same_bits(pair, general)
    diff = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-300)
               for x, y in zip(pair.outputs, general.outputs))
    first = time_ms(general)
    ms = [time_ms(pair), time_ms(pair)]
    kernel = f"dense_tanh_jet_pair_double_kernelILi{d_in}ELb{int(open_sum)}E"
    return {"same_bits": same, "max_rel_diff": diff, "ms": ms,
            "general_ms": [first, time_ms(general)],
            "resources": [r for r in KERNEL_RESOURCES if r["kernel"].startswith(kernel)]}


def general_ok(rows):
    """Whether every shape of a row's pair_f64_against_general readings is
    within PAIR_F64_GENERAL_TOLERANCE of the general body in double."""
    return all(r["max_rel_diff"] <= PAIR_F64_GENERAL_TOLERANCE for r in rows)


def b3_row(dev, gen, n, groups, path="main", system="", k0=16, dtype=None):
    """The mix jet kernel on the three one-electron layers of one E_L chunk
    of `groups` walkers of n electrons (T = 3n; layer 0: k0 -> 256, k0 16
    for two atoms per primitive cell, layers 1, 2: 320 -> 256) against its
    plain version, timed beside its bound; float32 or `dtype`."""
    import torch
    from deepsolid_tpu_torch.ops.cuda import jet_kernels as jk

    dtype = dtype or torch.float32
    tol = JET_F64_TOLERANCE if dtype == torch.float64 else 1e-5

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

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
        b_, f_ = jet_bytes_flops(t3, groups * n, k, c3, groups, args[0].element_size())
        nbytes, flops = nbytes + count * b_, flops + count * f_
        del args
    torch.cuda.empty_cache()
    bnd, by, extra = jet_bound(nbytes, flops, dtype)
    return {
        "name": "fused_dense_tanh_jet_mix", "route": "cuda",
        "source": "deepsolid_tpu_torch/ops/cuda/csrc/dense_tanh_jet.cu",
        "replaces": "deepsolid_tpu/ops/pallas/jet_kernels.py:534",
        "per": (f"the three one-electron layers of one {groups}-walker {system}chunk "
                f"(T={t3}, {groups * n} rows, {k0}->256, 2x 320->256)"),
        "path": path, "variant": variants, "dtype": str(dtype)[6:],
        "shapes": [[t3, groups * n, k, c3] for k in (k0, 320)],
        "max_abs_err": err, "max_rel_err": rel,
        "tolerance": tol, "ok": rel <= tol,
        "ms": total, "ms_per_shape": ms, "plain_ms": plain,
        "library_ms": None, "matmul_ms": mm, "bound_ms": bnd, "bound_by": by, **extra,
    }


def b2_row(dev, gen, n, groups, path="main", system="", dtype=None):
    """The plain jet kernel on the two pair layers of one E_L chunk of
    `groups` walkers of n electrons (T = 6, groups * n^2 rows; 4 -> 32 and
    32 -> 32) against its plain version, timed beside its bound; float32
    or `dtype`."""
    import torch
    from deepsolid_tpu_torch.ops.cuda import jet_kernels as jk

    dtype = dtype or torch.float32
    tol = JET_F64_TOLERANCE if dtype == torch.float64 else 1e-5

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rows, ms, variants, general = groups * n * n, [], [], []
    err = rel = 0.0
    nbytes = flops = plain = mm = 0.0
    for k, c in ((4, 32), (32, 32)):
        args = (rnd(rows, k), rnd(6, rows, k), rnd(rows, k),
                rnd(k, c) / math.sqrt(k), rnd(c))
        got, variant = recorded(lambda: jk.fused_dense_tanh_jet(*args))
        e, r_ = max_errs(got, jk.fused_dense_tanh_jet_plain(*args))
        err, rel = max(err, e), max(rel, r_)
        del got
        if dtype == torch.float64:
            general.append(pair_f64_against_general(args, False))
        ms.append(time_ms(lambda: jk.fused_dense_tanh_jet(*args)))
        variants.append(variant)
        plain += time_ms(lambda: jk.fused_dense_tanh_jet_plain(*args))
        mm += time_ms(lambda: torch.matmul(args[1], args[3]))
        b_, f_ = jet_bytes_flops(6, rows, k, c, item=args[0].element_size())
        nbytes, flops = nbytes + b_, flops + f_
        del args
    torch.cuda.empty_cache()
    bnd, by, extra = jet_bound(nbytes, flops, dtype)
    return {
        "name": "fused_dense_tanh_jet", "route": "cuda",
        "source": "deepsolid_tpu_torch/ops/cuda/csrc/dense_tanh_jet.cu",
        "replaces": "deepsolid_tpu/ops/pallas/jet_kernels.py:263",
        "per": (f"both two-electron layers of one {groups}-walker {system}chunk "
                f"(T=6, {rows} rows, 4->32 and 32->32)"),
        "path": path, "variant": variants, "dtype": str(dtype)[6:],
        "shapes": [[6, rows, k, 32] for k in (4, 32)],
        "max_abs_err": err, "max_rel_err": rel,
        "tolerance": tol, "ok": rel <= tol and general_ok(general),
        "ms": sum(ms), "ms_per_shape": ms, "plain_ms": plain,
        "library_ms": None, "matmul_ms": mm, "bound_ms": bnd, "bound_by": by, **extra,
        **({"against_general_f64": general} if general else {}),
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
    # the det head's tangent stream: one channel of one 64-walker E_L chunk
    rows.append(dethead_row(dev, gen, EL_CHUNK, 48, 3 * 96))

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
    each; the det head kernel on one channel of a bcc-Li E_L chunk. Each row lists its shapes; the Si sampler row also holds 1024
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
            b3_row(dev, gen, 2 * bcc_n, bcc_li_el_chunk, "bcc_li", "bcc-Li "),
            dethead_row(dev, gen, bcc_li_el_chunk, bcc_n, 6 * bcc_n, "bcc_li")]
    si["ok"] = si["ok"] and si["run_script_shape"]["ok"]
    for row in rows[:4]:  # B1: Si's n = 14 on the warp body, bcc-Li's 81 on the mid one
        row["ok"] = row["ok"] and row["variant"] == B1_BODY[row["path"]]
    return rows


def si_2x2x2_kernel_rows(dev, gen, record):
    """B1 on Si 2x2x2's sampler launch (the whole batch x 8 determinants;
    psi_chunk unset) and E_L launch (el_chunk x 8) at n = 112, each on the
    mid wide body, and the det head kernel on one channel of its E_L chunk
    (el_chunk x 8, 112, T 672) on the staged complex64 body."""
    from deepsolid_tpu_torch.ops.cuda import dethead_kernels as dh

    n, batch, chunk = record["electrons"][0], record["batch"], record["el_chunk"]
    rows = [b1_row(dev, gen, batch * 8, n, "si_2x2x2"),
            b1_row(dev, gen, chunk * 8, n, "si_2x2x2"),
            dethead_row(dev, gen, chunk, n, 6 * n, "si_2x2x2", window=DETHEAD_PLAIN_WINDOW)]
    for row in rows[:2]:
        row["ok"] = row["ok"] and row["variant"] == B1_BODY["si_2x2x2"]
    rows[2]["ok"] = rows[2]["ok"] and rows[2]["variant"] == dh.BODY_C64_STAGED
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


def _launch_counters():
    """The SHAPES counters of the three kernel wrappers."""
    from deepsolid_tpu_torch.ops.cuda import det_kernels as dk
    from deepsolid_tpu_torch.ops.cuda import dethead_kernels as dh
    from deepsolid_tpu_torch.ops.cuda import jet_kernels as jk

    return dk.SHAPES, jk.SHAPES, dh.SHAPES


def reset_launches():
    for shapes in _launch_counters():
        shapes.clear()


# every kernel the three wrappers launch, so each reading names all of them
KERNELS = ("gj_inverse_slogdet", "fused_dense_tanh_jet", "fused_dense_tanh_jet_mix",
           "fused_dense_tanh_jet_partial", "fused_dense_tanh_jet_mix_partial",
           "dethead_traces")


def read_launches():
    """Launches by kernel since reset_launches, every kernel of KERNELS
    present (0 for one that has not launched): the wrappers' SHAPES summed
    over shapes and bodies."""
    counts = collections.Counter(dict.fromkeys(KERNELS, 0))
    for shapes in _launch_counters():
        for (kernel, _, _), count in shapes.items():
            counts[kernel] += count
    return counts


@contextlib.contextmanager
def plain_det_head():
    """Inside the block fl.det_head_jet takes the det head's plain version
    (dethead_kernels.dethead_traces_plain) in the scan's windows of
    tangents in place of the kernel (dethead_kernels.serves answers no):
    the path of matrices past the kernel's largest n. Two float32
    algorithms of E_L differ by their rounding, up to ~1e-3 Ha/cell at a
    walker near a node; `float32_bias` holds the kernel's path to the
    card's float64 with this plain head beside."""
    from deepsolid_tpu_torch.ops.cuda import dethead_kernels as dh

    serves = dh.serves
    dh.serves = lambda *args: False
    try:
        yield
    finally:
        dh.serves = serves


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
    dk_shapes, jk_shapes, dh_shapes = _launch_counters()
    return [{"kernel": k, "shape": list(shape), "variant": v, "launches": c}
            for (k, shape, v), c in sorted((dk_shapes + jk_shapes + dh_shapes).items(),
                                           key=str)]


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


def scan_el_chunk(cfg, shard=None, scan="on", dtype=None, walkers=EL_CHUNK):
    """E_L per cell (numpy) of the checkpoint's first `walkers` walkers on
    the card in float32 (or `dtype`) with DEEPSOLID_TPU_ORB_SCAN=`scan`,
    over `shard`'s ranks when given, and the kernel launches it made."""
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
    dtype = dtype or torch.float32
    x = torch.as_tensor(np.asarray(data[:walkers]), dtype=dtype, device=dev)
    old = os.environ.get(ORB_SCAN_ENV)
    os.environ[ORB_SCAN_ENV] = scan
    try:
        reset_launches()
        with torch.no_grad():
            ke, ew = make_local_energy(net, sc, shard=shard)(
                params_from_jax(params, dev, dtype), x)
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


def bootstrap_argv(restore_path, save_path, precision="float32", el_chunk=EL_CHUNK):
    """The command line of the bootstrap phase's C-diamond inference run
    (and of the float64 phase's, in `precision` at `el_chunk`)."""
    overrides = {
        "optim.optimizer": "none", "optim.iterations": 1, "batch_size": BATCH,
        "optim.el_chunk": el_chunk, "debug.deterministic": True,
        # diamond_cfg's other settings
        "precision": precision, "optim.laplacian_mode": "forward", "mcmc.burn_in": 0,
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


@contextlib.contextmanager
def logged_warnings():
    """The messages of the warnings logged inside the block (the list it
    yields)."""
    import logging

    messages = []

    class Keep(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    handler = Keep(logging.WARNING)
    logging.getLogger().addHandler(handler)
    try:
        yield messages
    finally:
        logging.getLogger().removeHandler(handler)


def production_kfac(cfg):
    """The production run's optimizer settings (runs/diamond_run.py) on
    `cfg`, adapting the damping every KFAC_ADAPT_EVERY optimizer steps."""
    cfg.optim.optimizer = "kfac"
    cfg.optim.kfac.adaptive_damping = True
    cfg.optim.kfac.damping_adaptation_interval = KFAC_ADAPT_EVERY
    return cfg


def kfac_phase(dev, mode="fisher_exact", iterations=KFAC_ITERATIONS, phase="kfac",
               batch=BATCH, psi_chunk=EL_CHUNK, precision="float32", el_chunk=EL_CHUNK):
    """KFAC iterations of estimation mode `mode` at `batch` walkers (the
    checkpoint's 1024 tiled by the elastic restore where larger) and
    `psi_chunk` (0: unset), continuing the checkpoint's KFAC state, in
    `precision` at `el_chunk`."""
    import torch
    from deepsolid_tpu_torch.optim.adam import tree_leaves
    from deepsolid_tpu_torch.train.process import process
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    cfg = production_kfac(diamond_cfg("kfac", batch, f"chip_smoke_{phase}_{mode}"))
    cfg.optim.psi_chunk = psi_chunk
    cfg.optim.kfac.estimation_mode = mode
    cfg.precision, cfg.optim.el_chunk = precision, el_chunk
    dtype = torch.float64 if precision == "float64" else torch.float32
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

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    start = time.perf_counter()
    with logged_warnings() as warnings:
        params, _, energy = process(cfg, t_start + iterations, device="cuda",
                                    on_iteration=on_iteration)
    wall = time.perf_counter() - start
    launches, shapes = read_launches(), read_shapes()
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
        cfg.log.save_path, t_start + iterations, batch, 288, params, iters, dev, dtype)

    keys = ("mcmc", "local_energy", "gradient", "curvature", "update", "step")
    plain = [r for r in iters if not r["adapted"]] or iters
    med = med_seconds
    result = {
        "phase": phase, "optimizer": f"kfac {mode}", "batch": batch,
        "precision": precision,
        "el_chunk": el_chunk, "psi_chunk": psi_chunk, "iterations": len(iters),
        "damping_adaptation_interval": KFAC_ADAPT_EVERY,
        "seconds": wall, "energy_per_cell": energy,
        "loss_per_cell": [r["energy"] for r in iters],
        "optimizer_steps": [r["optimizer_step"] for r in iters],
        "damping": [r["damping"] for r in iters], "rho": [r["rho"] for r in iters],
        "adapted": [r["adapted"] for r in iters],
        "seconds_per_iteration": {k: med(k, iters) for k in keys},
        "seconds_per_iteration_all": [r["seconds"] for r in iters],
        "seconds_adapt": [r["seconds"].get("adapt") for r in iters],
        "walkers_per_s_local_energy": batch / med("local_energy", iters),
        "walkers_per_s_iteration_without_adaptation": batch / med("step", plain),
        "walkers_per_s_iteration_all": batch / med("step", iters),
        "peak_memory_bytes": peak, "launches": launches,
        "launch_shapes": shapes, "b1_bodies": b1_bodies(shapes),
        "elastic_restore_logged": any("Elastic restore" in w for w in warnings),
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


def kfac_checkpoint_ok(save_path, t_next_want, batch, n3, params, iters, dev,
                       dtype=None):
    """The last checkpoint of a KFAC run in `dtype` (default float32)
    restores: its clock, walkers, parameters and a state at the run's
    optimizer step, damping and rho with finite factors. Returns (ok,
    factors finite, file name)."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.optim import kfac as kfac_lib
    from deepsolid_tpu_torch.optim.adam import tree_leaves
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    ckpt = find_last_checkpoint(save_path)
    if not ckpt:
        return False, False, ""
    dtype = dtype or torch.float32
    as_np = np.float64 if dtype == torch.float64 else np.float32
    t_next, data, ck_params, raw, _ = restore(ckpt)
    state = kfac_lib.state_from_numpy(raw, dev, dtype)
    again = kfac_lib.state_to_numpy(state)
    finite = all(bool(torch.isfinite(x).all()) for x in tree_leaves(
        [state["blocks"], state["env_blocks"], state["diag"], state["velocities"]]))
    ok = (t_next == t_next_want and data.shape == (batch, n3)
          and int(state["step"]) == iters[-1]["optimizer_step"] + 1
          and float(state["damping"]) == as_np(iters[-1]["damping"])
          and float(state["rho"]) == as_np(iters[-1]["rho"])
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
    return cli_config(f"{BCC_LI_CONFIG_FILE}:{BCC_LI_POSCAR},3,sto-3g", overrides)


def cli_config(config, overrides):
    """The config the command line builds from `--config=config` and one
    `--config.key value` pair per entry of `overrides`."""
    from deepsolid_tpu_torch import cli

    argv = [f"--config={config}"]
    for key, value in overrides.items():
        argv += [f"--config.{key}", str(value)]
    cfg, _ = cli.parse(argv)
    return cfg


def memory_probe(dev, cfg, net, params, x, el_chunks, psi_chunks):
    """Peak device memory of one E_L chunk of each candidate `el_chunk` and
    of KFAC's curvature capture (the largest psi_chunk-chunked pass: one
    tapped forward, two backward passes) of each candidate `psi_chunk`, on
    the first walkers of `x`; the largest candidate under
    PROBE_LIMIT_BYTES that divides the batch (the rows of `x`) is taken.
    A candidate that runs out of memory reads None."""
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
        el = {c: peak(lambda: el_fn(params, x[:c])) for c in el_chunks}
    psi = {c: peak(lambda: capture(c)) for c in psi_chunks}

    def choose(readings):
        fits = [c for c, b in readings.items()
                if b is not None and b < PROBE_LIMIT_BYTES and len(x) % c == 0]
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
    probe = memory_probe(dev, cfg, net, params, x, BCC_LI_EL_CHUNKS, BCC_LI_PSI_CHUNKS)
    emit({"phase": "bcc_li_probe", **probe})
    del params, x
    if probe["el_chunk"] is None or probe["psi_chunk"] is None:
        return {"phase": "bcc_li", "ok": False, "probe": probe}, None

    cfg = bcc_li_cfg(probe["el_chunk"], probe["psi_chunk"])
    shutil.rmtree(cfg.log.save_path, ignore_errors=True)
    iters, pretrained, first = [], [], []

    def on_iteration(t, row, seconds):
        if not first:  # the iteration's start: set-up and burn-in lie before it
            first.append(time.perf_counter() - seconds["step"])
        row.pop("local_energy")
        rec = {"phase": "bcc_li_iteration", "step": t, **row, "seconds": seconds,
               "adapted": "adapt" in seconds}
        iters.append(rec)
        emit(rec)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    start = time.perf_counter()
    params, _, energy = process(
        cfg, BCC_LI_ITERATIONS, device="cuda", on_iteration=on_iteration,
        on_pretrain=lambda *args: pretrained.append(args))
    wall = time.perf_counter() - start
    launches, shapes = read_launches(), read_shapes()
    peak = torch.cuda.max_memory_allocated(dev)

    # B1 on the restored run's path only: the burn-in's sweeps, then per
    # iteration the sampler's 20 proposals and its first evaluation, E_L,
    # the gradient's and KFAC's capture forward passes, each chunked, two
    # spins each; E_L again on an iteration that adapts the damping.
    # Pretraining would add sweeps of its own.
    n_psi, n_el = BATCH // cfg.optim.psi_chunk, BATCH // cfg.optim.el_chunk
    adapted = sum(r["adapted"] for r in iters)
    sweep = (cfg.mcmc.steps + 1) * n_psi
    b1_want = 2 * (cfg.mcmc.burn_in * sweep
                   + len(iters) * (sweep + n_el + 2 * n_psi) + adapted * n_el)
    ckpt_ok, factors_finite, ckpt = (kfac_checkpoint_ok(
        cfg.log.save_path, BCC_LI_ITERATIONS, BATCH, 3 * sum(sc.nelec),
        params, iters, dev) if iters else (False, False, ""))
    plain = [r for r in iters if not r["adapted"]] or iters
    keys = ("mcmc", "local_energy", "gradient", "curvature", "update", "step")
    result = {
        "phase": "bcc_li", "config": f"read_poscar {os.path.relpath(BCC_LI_POSCAR, REPO)},3,sto-3g",
        "electrons": list(sc.nelec), "atoms": sc.natom, "batch": BATCH,
        "el_chunk": cfg.optim.el_chunk, "psi_chunk": cfg.optim.psi_chunk,
        "restored_step": t_start, "steps": [r["step"] for r in iters],
        "pretraining_iterations": len(pretrained), "burn_in": cfg.mcmc.burn_in,
        "seconds_setup_and_burn_in": first[0] - start if first else None,
        "seconds": wall,
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
        t_start == 1 and result["steps"] == list(range(BCC_LI_ITERATIONS))
        and not pretrained and launches["gj_inverse_slogdet"] == b1_want
        and result["b1_bodies"] == {81: [B1_BODY["bcc_li"]]}
        and launches["fused_dense_tanh_jet"] > 0 and launches["fused_dense_tanh_jet_mix"] > 0
        and all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))
        and ckpt_ok and factors_finite and math.isfinite(energy)
        and all(math.isfinite(r["energy"]) and math.isfinite(r["grad_norm"])
                and math.isfinite(r["rho"]) for r in iters))
    emit(result)
    return result, (cfg, klist, start_params, start_data[:BCC_LI_REFERENCE_WALKERS])


def si_2x2x2_phase(dev):
    """Si 2x2x2 on the main path as the benchmark cell SI_2X2X2_CELL runs
    it (portbench's configuration, traffic and start from the step-0
    handoff; no pretraining): SI_2X2X2_ITERATIONS KFAC iterations through
    process(), the launch counters reset just before. Every det head
    launch must take the staged complex64 body on one channel of an E_L
    chunk, two an E_L chunk and pass (the plain version never runs), and
    every B1 launch the mid wide body, at B1's exact count."""
    import tempfile
    from pathlib import Path

    import torch
    from deepsolid_tpu_torch.ops.cuda import dethead_kernels as dh
    from deepsolid_tpu_torch.optim.adam import tree_leaves
    from deepsolid_tpu_torch.train.process import process
    from portbench import harness, spec

    cell = spec.Cell(SI_2X2X2_CELL)
    conf, traffic = cell.config, cell.traffic
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_si_2x2x2-"))
    iters = []

    def on_iteration(t, row, seconds):
        row.pop("local_energy")
        rec = {"phase": "si_2x2x2_iteration", "step": t, **row, "seconds": seconds,
               "adapted": "adapt" in seconds}
        iters.append(rec)
        emit(rec)

    try:
        harness.write_start(conf, traffic, SI_2X2X2_SEED, work / "restore")
        cfg = harness.program_config(conf, traffic, work)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        start = time.perf_counter()
        params, _, energy = process(cfg, SI_2X2X2_ITERATIONS, device="cuda",
                                    on_iteration=on_iteration)
        wall = time.perf_counter() - start
        launches, shapes = read_launches(), read_shapes()
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    sc = cfg.system.cell
    batch, el_chunk = cfg.batch_size, cfg.optim.el_chunk
    n = sc.nelec[0]
    # B1 as bcc_li counts it, the sampler, gradient and capture unchunked
    n_psi = batch // cfg.optim.psi_chunk if cfg.optim.psi_chunk else 1
    n_el = -(-batch // el_chunk)
    adapted = sum(r["adapted"] for r in iters)
    sweep = (cfg.mcmc.steps + 1) * n_psi
    b1_want = 2 * (cfg.mcmc.burn_in * sweep
                   + len(iters) * (sweep + n_el + 2 * n_psi) + adapted * n_el)
    dethead_want = {(dh.KERNEL, (el_chunk * conf["network"]["determinants"], n, 3 * sum(sc.nelec)),
                     dh.BODY_C64_STAGED): 2 * n_el * (len(iters) + adapted)}
    dethead_got = {(r["kernel"], tuple(r["shape"]), r["variant"]): r["launches"]
                   for r in shapes if r["kernel"] == dh.KERNEL}
    result = {
        "phase": "si_2x2x2", "cell": SI_2X2X2_CELL, "seed": SI_2X2X2_SEED,
        "electrons": list(sc.nelec), "atoms": sc.natom, "batch": batch,
        "el_chunk": el_chunk, "psi_chunk": cfg.optim.psi_chunk, "burn_in": cfg.mcmc.burn_in,
        "steps": [r["step"] for r in iters], "adapted": [r["adapted"] for r in iters],
        "seconds": wall, "seconds_per_iteration": [r["seconds"] for r in iters],
        "energy_per_cell": energy, "peak_memory_bytes": peak, "launches": launches,
        "b1_launches_expected": b1_want, "launch_shapes": shapes,
        "b1_bodies": b1_bodies(shapes),
        "dethead_launches_expected": [[list(k), v] for k, v in dethead_want.items()],
    }
    result["ok"] = (
        result["steps"] == list(range(SI_2X2X2_ITERATIONS))
        and launches["gj_inverse_slogdet"] == b1_want
        and result["b1_bodies"] == {n: [B1_BODY["si_2x2x2"]]}
        and dethead_got == dethead_want
        and launches["fused_dense_tanh_jet"] > 0 and launches["fused_dense_tanh_jet_mix"] > 0
        and all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))
        and math.isfinite(energy)
        and all(math.isfinite(r["energy"]) and math.isfinite(r["grad_norm"]) for r in iters))
    emit(result)
    del params
    torch.cuda.empty_cache()
    return result


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
    from deepsolid_tpu_torch.train.process import build_network

    cfg = h10_cfg()
    sc = cfg.system.cell
    with scf_cache(H10_SCF_CACHE) as cache:
        source, uhf = cold_source(cfg, cache)
        emit({"phase": "h10_source", "config": H10_CONFIG, **uhf})
        result, params, data = scratch_run(dev, cfg, source, "h10", H10_KFAC_ITERATIONS,
                                           emit_iterations=False)
    net = build_network(cfg, sc, klist_override=source.klist)
    result.update(config=H10_CONFIG, seconds_cold_uhf=uhf["seconds_cold_uhf"],
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
def scf_cache(path):
    """DEEPSOLID_TPU_SCF_CACHE pointed at an empty directory `path` inside
    the block (a cold UHF solves there); the directory goes afterwards."""
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    cache = os.environ.get("DEEPSOLID_TPU_SCF_CACHE")
    os.environ["DEEPSOLID_TPU_SCF_CACHE"] = path
    try:
        yield path
    finally:
        os.environ["DEEPSOLID_TPU_SCF_CACHE"] = cache
        shutil.rmtree(path, ignore_errors=True)


def cold_source(cfg, cache):
    """The run's orbital source from a cold UHF solved on the host into the
    empty cache directory `cache`: (source, its record: seconds, e_tot,
    converged)."""
    import numpy as np
    from deepsolid_tpu_torch.train.process import orbital_source

    start = time.perf_counter()
    source = orbital_source(cfg, cfg.system.cell)
    seconds = time.perf_counter() - start
    files = sorted(os.listdir(cache))
    e_tot = converged = None
    if len(files) == 1:
        with np.load(os.path.join(cache, files[0])) as f:
            e_tot, converged = float(f["e_tot"]), bool(f["converged"])
    return source, {"basis": cfg.system.basis, "level": cfg.pretrain.scf,
                    "seconds_cold_uhf": seconds, "e_tot": e_tot,
                    "converged": converged, "cache_files": files}


def cold_cfg(system):
    """The run script's settings of COLD_SYSTEMS[system], loaded as the
    command line loads them, from its first step with the pretrain phase's
    cuts (from_scratch: pretraining iterations, burn-in)."""
    spec = COLD_SYSTEMS[system]
    overrides = {
        "batch_size": spec["batch"], "precision": "float32", "optim.optimizer": "kfac",
        "optim.laplacian_mode": "forward", "optim.el_chunk": spec["el_chunk"],
        "mcmc.burn_in": spec["burn_in"], "mcmc.steps": 20, "pretrain.method": "net",
        "pretrain.scf": "hf", "pretrain.iterations": spec["pretrain_iterations"],
        "optim.kfac.adaptive_damping": True,
        "optim.kfac.damping_adaptation_interval": 10,
        "log.save_path": os.path.join(REPO, "build", f"chip_smoke_{system}"),
        "debug.deterministic": True,
    }
    config = os.path.join(REPO, "deepsolid_tpu_torch", "configs", spec["config"])
    return from_scratch(cli_config(f"{config}:{spec['spec']}", overrides))


def ewald_share(dev, cfg, klist, params, x):
    """Device ms of one E_L chunk (walkers `x`, numpy parameters `params`)
    and of its Ewald sum alone, and the Ewald's share of the chunk."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.hamiltonian import make_local_energy
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.ops.ewald import EwaldSum
    from deepsolid_tpu_torch.train.process import build_network

    sc = cfg.system.cell
    el_fn = make_local_energy(build_network(cfg, sc, klist_override=klist), sc)
    ewald = EwaldSum.build(sc)
    p = params_from_jax(params, dev, torch.float32)
    x = torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
    with torch.no_grad():
        el_ms = time_ms(lambda: el_fn(p, x), warmup=1, reps=3)
        ewald_ms = time_ms(lambda: ewald.energy(x), warmup=1, reps=5)
    return {"walkers": len(x), "local_energy_ms": el_ms, "ewald_ms": ewald_ms,
            "ewald_share": ewald_ms / el_ms}


def cold_phase(dev, system):
    """COLD_SYSTEMS[system] at full width from a cold UHF solved on the
    host into a scratch cache, then its run script's path from the first
    step (pretraining, the step-0 checkpoint, burn-in, KFAC iterations
    from a fresh state, psi_chunk unset); E_L and the Ewald term of 8
    final walkers against CPU f64 with a TF32 control, the Ewald's share
    of an E_L chunk and a profile of one. Returns the record."""
    from deepsolid_tpu_torch.models.network import params_to_numpy

    spec = COLD_SYSTEMS[system]
    cfg = cold_cfg(system)
    sc = cfg.system.cell
    with scf_cache(os.path.join(REPO, "build", f"chip_smoke_{system}_scf")) as cache:
        source, uhf = cold_source(cfg, cache)
        emit({"phase": f"{system}_source", "config": spec["spec"], **uhf})
        result, params, data = scratch_run(dev, cfg, source, system,
                                           COLD_KFAC_ITERATIONS, emit_iterations=False)
    np_params = params_to_numpy(params)
    reference = el_reference_record(dev, cfg, source.klist, np_params,
                                    data[:COLD_REFERENCE_WALKERS].cpu().numpy())
    chunk = data[:cfg.optim.el_chunk].cpu().numpy()
    share = ewald_share(dev, cfg, source.klist, np_params, chunk)
    profile = profile_phase(dev, cfg, source.klist, np_params, chunk,
                            f"one {len(chunk)}-walker {spec['label']} local-energy chunk")
    result.update(
        config=spec["spec"], run_script=f"runs/{system}_run.py", atoms=sc.natom,
        mcmc_steps=cfg.mcmc.steps, uhf=uhf,
        b1_bodies=b1_bodies(result["launch_shapes"]),
        kfac_walkers_per_s_iteration=[cfg.batch_size / r["step"]
                                      for r in result["kfac_seconds_per_iteration"]],
        reference=reference, ewald=share,
        profile_device_idle_share=profile["device_idle_share"])
    result["ok"] = (
        result["ok"] and bool(uhf["converged"])
        and result["b1_bodies"] == {sc.nelec[0]: [B1_BODY[system]]}
        and all(math.isfinite(e) for e in result["kfac_energy_per_cell"])
        and reference["ok"])
    emit(result)
    return result


def cold_kernel_rows(dev, gen, system, record):
    """B1, B2 and B3 at the shapes the path of COLD_SYSTEMS[system] gives
    them, from its config: B1 on the whole batch (sampler, gradient and
    capture with psi_chunk unset) and on one E_L chunk, batch or el_chunk
    x determinants matrices of one spin's n; B2 and B3 on one E_L chunk,
    B3's first layer as wide as the path launched it."""
    cfg = cold_cfg(system)
    sc = cfg.system.cell
    n, n_spin = sum(sc.nelec), sc.nelec[0]
    dets, chunk = cfg.network.detnet.determinants, cfg.optim.el_chunk
    rows = [b1_row(dev, gen, cfg.batch_size * dets, n_spin, system),
            b1_row(dev, gen, chunk * dets, n_spin, system)]
    for row in rows:
        row["ok"] = row["ok"] and row["variant"] == B1_BODY[system]
    k0 = min(r["shape"][2] for r in record["launch_shapes"]
             if r["kernel"] == "fused_dense_tanh_jet_mix")
    label = COLD_SYSTEMS[system]["label"] + " "
    return rows + [b2_row(dev, gen, n, chunk, system, label),
                   b3_row(dev, gen, n, chunk, system, label, k0=k0)]


def north_star_phase(dev, source, kfac):
    """C-diamond 2x2x2's KFAC step as production sets it, continuing the
    checkpoint's state at optimizer step 582 with the kfac phase's other
    settings: (a) runs/diamond_run.py's 1024 walkers with psi_chunk unset
    where the probe puts the unchunked capture under the memory limit
    (else the largest fallback under it), and its KFAC update of 8 final
    walkers against CPU f64; (b) BASELINE.json's batch 4096 (the
    checkpoint's walkers tiled by the elastic restore) at the largest
    psi_chunk candidate under the limit. Each beside the kfac phase's
    psi_chunk 64 split. Returns the record and the 4096 run's."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.train.process import build_network
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    cfg = production_kfac(diamond_cfg("kfac", BATCH, "chip_smoke_north_star_probe"))
    net = build_network(cfg, cfg.system.cell, klist_override=source.klist)
    _, data, start_params, _, _ = restore(find_last_checkpoint(cfg.log.restore_path),
                                          NORTH_STAR_BATCH)
    params = params_from_jax(start_params, dev, torch.float32)
    x = torch.as_tensor(np.asarray(data), dtype=torch.float32, device=dev)

    def probe(batch, candidates):
        got = memory_probe(dev, cfg, net, params, x[:batch], (), candidates)
        emit({"phase": "north_star_probe", "batch": batch, **got})
        return got

    probes = [probe(BATCH, (BATCH,))]
    psi_chunk = 0 if probes[0]["psi_chunk"] == BATCH else None
    if psi_chunk is None:  # the unchunked capture does not fit
        probes.append(probe(BATCH, NORTH_STAR_FALLBACK_PSI_CHUNKS))
        psi_chunk = probes[-1]["psi_chunk"]
    probes.append(probe(NORTH_STAR_BATCH, NORTH_STAR_PSI_CHUNKS))
    big_chunk = probes[-1]["psi_chunk"]
    del params, x
    torch.cuda.empty_cache()
    result = {"phase": "north_star", "probes": probes, "psi_chunk": psi_chunk,
              "psi_chunk_batch_4096": big_chunk}
    if psi_chunk is None or big_chunk is None:
        result["ok"] = False
        emit(result)
        return result, None

    unset = kfac_phase(dev, iterations=NORTH_STAR_ITERATIONS, phase="north_star_1024",
                       batch=BATCH, psi_chunk=psi_chunk)
    # the run's own last state and 8 of its walkers, one KFAC update
    # further, card f32 against CPU f64
    cfg.optim.psi_chunk = psi_chunk
    _, walkers, last_params, last_state, _ = restore(find_last_checkpoint(
        os.path.join(REPO, "build", "chip_smoke_north_star_1024_fisher_exact")))
    upd_rel, upd_norm, _ = kfac_update_rel_err(dev, cfg, net, last_params,
                                               np.asarray(walkers[:8], np.float64),
                                               last_state)
    torch.cuda.empty_cache()
    big = kfac_phase(dev, iterations=NORTH_STAR_BATCH_ITERATIONS, phase="north_star_4096",
                     batch=NORTH_STAR_BATCH, psi_chunk=big_chunk)
    last = big["seconds_per_iteration_all"][-1]
    result.update(
        kfac_psi_chunk_64=kfac["seconds_per_iteration_all"],
        batch_1024={k: unset[k] for k in (
            "psi_chunk", "seconds_per_iteration", "seconds_per_iteration_all",
            "walkers_per_s_iteration_without_adaptation", "walkers_per_s_iteration_all",
            "peak_memory_bytes", "energy_per_cell", "ok")},
        kfac_update_rel_err_global_norm=upd_rel, kfac_update_global_norm_cpu_f64=upd_norm,
        kfac_update_tolerance=KFAC_UPDATE_TOLERANCE,
        batch_4096={k: big[k] for k in (
            "psi_chunk", "seconds_per_iteration_all", "energy_per_cell",
            "elastic_restore_logged", "peak_memory_bytes", "b1_bodies", "ok")},
        step_seconds_batch_4096=last["step"], split_batch_4096=last,
        walkers_per_s_batch_4096=NORTH_STAR_BATCH / last["step"],
        card=nvidia_smi())
    result["ok"] = (unset["ok"] and big["ok"] and big["elastic_restore_logged"]
                    and upd_rel <= KFAC_UPDATE_TOLERANCE
                    and big["b1_bodies"] == {cfg.system.cell.nelec[0]:
                                             [B1_BODY["north_star_4096"]]})
    emit(result)
    return result, big


def north_star_kernel_rows(dev, gen, big):
    """B1 at the 4096-walker run's sampler and capture shape (psi_chunk x
    determinants matrices of one spin's n), with the unchunked sampler's
    (4096 x determinants) beside it where the run chunked."""
    cfg = diamond_cfg("kfac", NORTH_STAR_BATCH, "")
    dets, n = cfg.network.detnet.determinants, cfg.system.cell.nelec[0]
    row = b1_row(dev, gen, big["psi_chunk"] * dets, n, "north_star_4096")
    if big["psi_chunk"] != NORTH_STAR_BATCH:
        row["unchunked_sampler_shape"] = b1_row(dev, gen, NORTH_STAR_BATCH * dets, n,
                                                "north_star_4096")
        row["ok"] = row["ok"] and row["unchunked_sampler_shape"]["ok"]
    row["ok"] = row["ok"] and row["variant"] == B1_BODY["north_star_4096"]
    return [row]


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
    chunk (device ms, peak memory; the scan's windows of tangents against
    the det head in one window) and bcc-Li's chunk memory."""
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


def system_el(cfg, klist, params, x, device, dtype, name=None):
    """(E_L, its Ewald term), complex128 on the host, of the walkers `x`
    (numpy) under the numpy parameter tree `params` on `device` in
    `dtype`. The CPU float64 values of a `name`d system are computed once
    and shared by the reference and float64 phases."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.hamiltonian import make_local_energy
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.train.process import build_network

    key = (name, str(device), dtype)
    if name is not None and key in _CPU_F64:
        return _CPU_F64[key]
    sc = cfg.system.cell
    el_fn = make_local_energy(build_network(cfg, sc, klist_override=klist), sc)
    with torch.no_grad():
        ke, ew = el_fn(params_from_jax(params, device, dtype),
                       torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                                       device=device))
    out = (ke + ew).cpu().to(torch.complex128), ew.cpu().to(torch.complex128)
    if name is not None and device == "cpu" and dtype == torch.float64:
        _CPU_F64[key] = out
    return out


def system_el_reference(dev, cfg, klist, params, x, name=None):
    """E_L per primitive cell of the walkers `x` (numpy) under the numpy
    parameter tree `params`: the card's f32 kernel path, and the port's
    plain path on the CPU in float32, each against the plain path on the
    CPU in float64, and the card's path with TF32 matmuls as the control
    the check must catch. Returns {"card": (median, max), "cpu_f32":
    (median, max), "card_tf32": (median, max), "ewald": (median, max) of
    the card's Ewald term} of the absolute differences and the float64
    values."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.device import set_full_precision

    sc = cfg.system.cell

    def el(device, dtype):
        return system_el(cfg, klist, params, x, device, dtype, name)

    cpu, cpu_ewald = el("cpu", torch.float64)

    def diffs(got, want=cpu):
        d = ((got - want).abs() / sc.scale).numpy()
        return float(np.median(d)), float(d.max())

    card, card_ewald = el(dev, torch.float32)
    got = {"card": diffs(card), "ewald": diffs(card_ewald, cpu_ewald),
           "cpu_f32": diffs(el("cpu", torch.float32)[0]),
           "el_cpu_f64_per_cell": (cpu.real / sc.scale).tolist(),
           "ewald_cpu_f64_per_cell": (cpu_ewald.real / sc.scale).tolist()}
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        got["card_tf32"] = diffs(el(dev, torch.float32)[0])
    finally:
        set_full_precision()
    return got


def el_reference_record(dev, cfg, klist, params, x, name=None):
    """E_L per primitive cell of the walkers `x` (numpy) under the numpy
    parameters `params`, card f32 against CPU f64 at the reference limits,
    beside the port's own CPU f32 error and the Ewald term's card error;
    the card's TF32 control must fail the limits. Returns the record with
    its check in "ok"."""
    start = time.perf_counter()
    got = system_el_reference(dev, cfg, klist, params, x, name)
    tol_median, tol_max = EL_TOLERANCE_MEDIAN, EL_TOLERANCE_MAX
    (card_median, card_max), (f32_median, f32_max) = got["card"], got["cpu_f32"]
    tf32_median, tf32_max = got["card_tf32"]
    tf32_fails = not (tf32_median <= tol_median and tf32_max <= tol_max)
    return {
        "walkers": len(x), "el_cpu_f64_per_cell": got["el_cpu_f64_per_cell"],
        "median_abs_diff_per_cell": card_median, "max_abs_diff_per_cell": card_max,
        "tolerance_median": tol_median, "tolerance_max": tol_max,
        "cpu_f32_median_abs_diff_per_cell": f32_median,
        "cpu_f32_max_abs_diff_per_cell": f32_max,
        "tf32_control_median_abs_diff_per_cell": tf32_median,
        "tf32_control_max_abs_diff_per_cell": tf32_max,
        "tf32_control_fails_check": tf32_fails,
        "ewald_cpu_f64_per_cell": got["ewald_cpu_f64_per_cell"],
        "ewald_median_abs_diff_per_cell": got["ewald"][0],
        "ewald_max_abs_diff_per_cell": got["ewald"][1],
        "ok": card_median <= tol_median and card_max <= tol_max and tf32_fails,
        "seconds": time.perf_counter() - start}


def diamond_values(dev, source, device, dtype, el_only=False):
    """E_L (complex128 on the host) of the 8 C-diamond checkpoint walkers
    on `device` in `dtype`, and unless `el_only` the energy gradient's
    leaves, the KFAC update's leaves (the checkpoint's state takes one
    curvature update, then the preconditioned step; the update is the
    step's velocities), the pretraining loss against the cached UHF
    orbitals and its gradient's leaves. The CPU float64 values are
    computed once and shared by the reference and float64 phases."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.configs import diamond
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.optim import kfac as kfac_lib
    from deepsolid_tpu_torch.optim.adam import learning_rate_schedule, tree_leaves
    from deepsolid_tpu_torch.train import pretrain as pretrain_lib
    from deepsolid_tpu_torch.train.loss import make_loss
    from deepsolid_tpu_torch.train.process import build_network
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    key = ("diamond", str(device), dtype, el_only)
    if key in _CPU_F64:
        return _CPU_F64[key]
    cfg = diamond.get_config(CONFIG)
    sc = cfg.system.cell
    net = build_network(cfg, sc, klist_override=source.klist)
    _, data, params_np, opt_state, _ = restore(
        find_last_checkpoint(os.path.join(REPO, "runs", "ckpt_diamond")))
    total_energy = make_loss(net, sc, clip_local_energy=cfg.optim.clip_el,
                             clip_type=cfg.optim.clip_type)
    params = params_from_jax(params_np, device, dtype)
    x = torch.as_tensor(np.asarray(data[:8], np.float64), dtype=dtype, device=device)

    def host(leaves):
        return [t.detach().cpu().double() for t in leaves]

    if el_only:
        _, aux = total_energy(params, x)
        return {"el": aux.local_energy.cpu().to(torch.complex128)}
    (_, aux), grads = total_energy.value_and_grad(params, x)
    opt = kfac_lib.KfacOptimizer.from_config(
        production_kfac(cfg), net, learning_rate_schedule(cfg))
    state = opt.update_curvature(kfac_lib.state_from_numpy(opt_state, device, dtype),
                                 params, x)
    update = opt.step_fn(params, state, grads, state["damping"])[1]["velocities"]
    pre_vg = pretrain_lib.make_value_and_grad(
        pretrain_lib.make_loss_per_walker(net, source, cfg.network.detnet.full_det))
    pre_loss, pre_grad = pre_vg(params, x)
    out = {"el": aux.local_energy.cpu().to(torch.complex128),
           "grad": host(tree_leaves(grads)), "update": host(tree_leaves(update)),
           "pre_loss": float(pre_loss), "pre_grad": host(tree_leaves(pre_grad)),
           "scale": sc.scale}
    if device == "cpu" and dtype == torch.float64:
        _CPU_F64[key] = out
    return out


def rel_global(got, want):
    """Relative error in the global norm of a list of leaves, and the norm."""
    diff2 = sum(float(((g - w) ** 2).sum()) for g, w in zip(got, want))
    norm2 = sum(float((w ** 2).sum()) for w in want)
    return math.sqrt(diff2 / norm2), math.sqrt(norm2)


def reference_phase(dev, source, systems):
    """E_L, the energy gradient and the KFAC update of 8 checkpoint
    walkers: the card's f32 kernel path against the port's plain path on
    the CPU in float64. `systems` maps a name to (cfg, k-list, numpy
    parameters, walkers) of another system whose E_L is held the same
    way (Si, bcc-Li)."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.device import set_full_precision

    cpu = diamond_values(dev, source, "cpu", torch.float64)
    gpu = diamond_values(dev, source, dev, torch.float32)
    grad_rel, grad_norm = rel_global(gpu["grad"], cpu["grad"])
    upd_rel, upd_norm = rel_global(gpu["update"], cpu["update"])
    pre_loss_rel = abs(gpu["pre_loss"] - cpu["pre_loss"]) / abs(cpu["pre_loss"])
    pre_grad_rel, pre_norm = rel_global(gpu["pre_grad"], cpu["pre_grad"])

    def diffs(el):
        d = ((el - cpu["el"]).abs() / cpu["scale"]).numpy()
        return float(np.median(d)), float(d.max())

    # f32 against f64 rounding in the kinetic energy's cancelling terms
    # reads ~1e-4 (median) and ~4e-4 (max) Ha/cell; the limits are ~10x
    # that and below the TF32 bias the full-f32 policy exists to prevent
    # (-3.7 mHa/atom, 7.4 mHa per 2-atom cell)
    tol_median, tol_max = EL_TOLERANCE_MEDIAN, EL_TOLERANCE_MAX
    median, worst = diffs(gpu["el"])
    # control: the same evaluation with TF32 matmuls must fail the check
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_median, tf32_worst = diffs(
            diamond_values(dev, source, dev, torch.float32, el_only=True)["el"])
    finally:
        set_full_precision()
    result = {
        "phase": "reference", "walkers": 8,
        "el_cpu_f64_per_cell": (cpu["el"].real / cpu["scale"]).tolist(),
        "median_abs_diff_per_cell": median, "max_abs_diff_per_cell": worst,
        "tolerance_median": tol_median, "tolerance_max": tol_max,
        "tf32_control_median_abs_diff_per_cell": tf32_median,
        "tf32_control_max_abs_diff_per_cell": tf32_worst,
        "tf32_control_fails_check": not (tf32_median <= tol_median
                                         and tf32_worst <= tol_max),
        "gradient_rel_err_global_norm": grad_rel,
        "gradient_global_norm_cpu_f64": grad_norm,
        "gradient_tolerance": GRADIENT_TOLERANCE,
        "kfac_update_rel_err_global_norm": upd_rel,
        "kfac_update_global_norm_cpu_f64": upd_norm,
        "kfac_update_tolerance": KFAC_UPDATE_TOLERANCE,
        "pretrain_loss_cpu_f64": cpu["pre_loss"],
        "pretrain_loss_rel_err": pre_loss_rel,
        "pretrain_gradient_rel_err_global_norm": pre_grad_rel,
        "pretrain_gradient_global_norm_cpu_f64": pre_norm,
        "pretrain_loss_tolerance": PRETRAIN_LOSS_TOLERANCE,
        "pretrain_gradient_tolerance": PRETRAIN_GRADIENT_TOLERANCE,
    }
    # Si and bcc-Li: the same limits; the port's own f32 path on the CPU
    # beside the card says how much of the error is f32's, not the kernels',
    # and each system's TF32 control must fail them as diamond's does
    for name, (sys_cfg, klist, sys_params, sys_x) in systems.items():
        result[name] = el_reference_record(dev, sys_cfg, klist, sys_params, sys_x,
                                           name)
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


@contextlib.contextmanager
def plain_calls():
    """Count, by name, every call of a kernel's plain version inside the
    block (each module's function wrapped): the counter it yields."""
    import collections
    from deepsolid_tpu_torch.ops.cuda import det_kernels as dk
    from deepsolid_tpu_torch.ops.cuda import dethead_kernels as dh
    from deepsolid_tpu_torch.ops.cuda import jet_kernels as jk

    counts = collections.Counter()
    saved = []
    for module, name in ((dk, "gj_inverse_slogdet_plain"),
                         (dh, "dethead_traces_plain"),
                         (jk, "fused_dense_tanh_jet_plain"),
                         (jk, "fused_dense_tanh_jet_mix_plain"),
                         (jk, "fused_dense_tanh_jet_partial_plain"),
                         (jk, "fused_dense_tanh_jet_mix_partial_plain")):
        fn = getattr(module, name)

        def counting(*args, fn=fn, name=name):
            counts[name] += 1
            return fn(*args)

        saved.append((module, name, fn))
        setattr(module, name, counting)
    try:
        yield counts
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def float64_bodies_only(shapes):
    """The launch-shape records whose body is not a float64 one: B1's
    complex128 bodies, the jets' general and pair bodies in double,
    their wide body in double at any slice count, and the det head's
    complex128 bodies (FMA, tensor cores)."""
    import re

    import torch
    from deepsolid_tpu_torch.ops.cuda import det_kernels as dk
    from deepsolid_tpu_torch.ops.cuda import dethead_kernels as dh
    from deepsolid_tpu_torch.ops.cuda import jet_kernels as jk

    f64 = {*dk.BODIES_C128, jk.variant_label(jk.FLOAT64),
           jk.variant_label(jk.PAIR, torch.float64), dh.BODY_C128_FMA, dh.BODY_C128}
    return [r for r in shapes if r["variant"] not in f64
            and not re.fullmatch(r"wide, float64, \d+ tangent slices", r["variant"])]


def float64_new_bodies(shapes):
    """The launch-shape records of a float64 path that should be on the
    bodies redesigned for it and are not: every one-electron jet launch
    (d_out 256, closed or open mix rule) on the wide body in double, every
    complex128 B1 launch on the body its n names (`b1_body_c128`: the
    warp body up to 32, the register body at 48, the mid body at 49-96),
    every two-electron jet launch (plain rule, closed or open, d_out 32,
    d_in 4 or 32) on the pair body in double, every complex128 det head
    launch on the body its n names (`dethead_kernels.body`: the tensor
    cores at C-diamond's 48 and bcc-Li's 81, FMA at Si 1x1x1's 14)."""
    import torch
    from deepsolid_tpu_torch.ops.cuda import dethead_kernels as dh

    out = []
    for r in shapes:
        if (r["kernel"] in ("fused_dense_tanh_jet_mix", "fused_dense_tanh_jet_mix_partial")
                and r["shape"][3] == 256 and not r["variant"].startswith("wide, float64")):
            out.append(r)
        if (r["kernel"] in ("fused_dense_tanh_jet", "fused_dense_tanh_jet_partial")
                and r["shape"][3] == 32 and r["shape"][2] in (4, 32)
                and r["variant"] != "pair, float64"):
            out.append(r)
        if (r["kernel"] == "gj_inverse_slogdet"
                and r["variant"] != b1_body_c128(r["shape"][-1])):
            out.append(r)
        if r["kernel"] == dh.KERNEL and r["variant"] != dh.body(r["shape"][1], torch.float64):
            out.append(r)
    return out


def open_row(dev, gen, name, cases, dtype):
    """An open ("partial") jet kernel against its plain version on each of
    `cases` ((tangents, groups, rows per group, d_in, d_out, count); groups
    0 for the plain rule), timed beside its bound: the row's shapes are
    (tangents, rows, d_in, d_out)."""
    import torch
    from deepsolid_tpu_torch.ops.cuda import jet_kernels as jk

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    fn, plain = getattr(jk, name), getattr(jk, name + "_plain")
    err = rel = total = plain_ms = mm = nbytes = flops = 0.0
    ms, variants, general = [], [], []
    for t, groups, n, k, c, count in cases:
        if groups:
            args = (rnd(groups, n, k), rnd(t, groups, n, k), rnd(groups, n, k),
                    rnd(groups, c), rnd(groups, c), rnd(t, groups, c),
                    rnd(k, c) / math.sqrt(k), rnd(c))
        else:
            args = (rnd(n, k), rnd(t, n, k), rnd(n, k), rnd(k, c) / math.sqrt(k), rnd(c))
        got, variant = recorded(lambda: fn(*args))
        e, r_ = max_errs(got, plain(*args))
        err, rel = max(err, e), max(rel, r_)
        del got
        if dtype == torch.float64 and not groups:
            general.append(pair_f64_against_general(args, True))
        t_k = time_ms(lambda: fn(*args))
        ms.append(t_k)
        variants.append(variant)
        total += count * t_k
        plain_ms += count * time_ms(lambda: plain(*args))
        mm += count * time_ms(lambda: torch.matmul(args[1], args[-2]))
        rows = max(groups, 1) * n
        b_, f_ = jet_bytes_flops(t, rows, k, c, groups, args[0].element_size())
        nbytes += count * (b_ + args[0].element_size() * rows * c)  # and s_local
        flops += count * f_
        del args
    torch.cuda.empty_cache()
    bnd, by, extra = jet_bound(nbytes, flops, dtype)
    tol = JET_F64_TOLERANCE if dtype == torch.float64 else 1e-5
    return {
        "name": name, "route": "cuda",
        "source": "deepsolid_tpu_torch/ops/cuda/csrc/dense_tanh_jet.cu",
        "replaces": ("deepsolid_tpu/ops/pallas/jet_kernels.py:555" if "mix" in name
                     else "deepsolid_tpu/ops/pallas/jet_kernels.py:166"),
        "per": "; ".join(f"{count}x (T_local={t}, {max(groups, 1) * n} rows, {k}->{c})"
                         for t, groups, n, k, c, count in cases),
        "dtype": str(dtype)[6:], "variant": variants,
        "shapes": [[t, max(groups, 1) * n, k, c] for t, groups, n, k, c, _ in cases],
        "max_abs_err": err, "max_rel_err": rel, "tolerance": tol,
        "ok": rel <= tol and general_ok(general),
        "ms": total, "ms_per_shape": ms, "plain_ms": plain_ms, "library_ms": None,
        "matmul_ms": mm, "bound_ms": bnd, "bound_by": by, **extra,
        **({"against_general_f64": general} if general else {}),
    }


def float64_kernel_rows(dev, gen, el_chunk, b1_path_shapes):
    """Each float64 body against its float64 plain version on the card: B1
    (complex128) at the float64 path's shapes (`b1_path_shapes`), at the
    production shapes of every system and on the edge matrices (on every
    complex128 body: 40 and 100 take the shared-memory one), B2 and B3
    on one C-diamond E_L chunk of `el_chunk` walkers, B4a and B4b at the
    float64 sharded chunk's shapes, the det head kernel (complex128) on
    one channel of that E_L chunk. Each row lists in "path_shapes" the
    shapes the float64 path launches."""
    import torch
    from deepsolid_tpu_torch.ops.cuda import det_kernels as dk

    f64, c128 = torch.float64, torch.complex128
    edge = gj_edge_cases(dev, gen, gj_errs, c128, tol=1e-9,
                         ns=(48, 14, 16, 32, 49, 81, 96, 40, 100))
    try:  # one past the body's largest matrix: refused before any launch
        dk.gj_inverse_slogdet(torch.zeros(1, 119, 119, dtype=c128, device=dev))
        refused = False
    except ValueError:
        refused = True
    b1_shapes = list(dict.fromkeys(list(b1_path_shapes) + list(B1_F64_SHAPES)))
    rows = [b1_row(dev, gen, nb, n, "float64", c128) for nb, n in b1_shapes]
    for row in rows:
        row["path_shapes"] = [s for s in row["shapes"] if tuple(s[:2]) in b1_path_shapes]
    rows[0].update(edge_cases=edge, refuses_n_119=refused,
                   ok=rows[0]["ok"] and refused and all(c["ok"] for c in edge))
    t_loc, w = 3 * 96 // 2, F64_SHARD_WALKERS
    rows += [b2_row(dev, gen, 96, el_chunk, "float64", dtype=f64),
             b3_row(dev, gen, 96, el_chunk, "float64", dtype=f64),
             open_row(dev, gen, "fused_dense_tanh_jet_partial",
                      [(3, 0, w * 96 * 96, 32, 32, 1), (3, 0, w * 96 * 96, 4, 32, 1)], f64),
             open_row(dev, gen, "fused_dense_tanh_jet_mix_partial",
                      [(t_loc, w, 96, 16, 256, 1), (t_loc, w, 96, 320, 256, 2)], f64),
             dethead_row(dev, gen, el_chunk, 48, 3 * 96, dtype=f64)]
    for row in rows:
        row["path"] = "float64"
        row.setdefault("path_shapes", row["shapes"][:1] if row["name"] ==
                       "fused_dense_tanh_jet_partial" else row["shapes"])
    return rows


def b1_body_c128(n):
    """The complex128 body gj_body_c128 gives n x n matrices: warp up to
    32, registers at 48, mid 49-96, shared otherwise."""
    if n <= 32:
        return "warp, complex128"
    if n == 48:
        return "registers, complex128"
    return "mid, complex128" if 49 <= n <= 96 else "shared, complex128"


def float64_sharded_rank(rank, world_size):
    """One of two deriv ranks sharing the card at float64: one E_L chunk of
    checkpoint walkers over the ranks (B4b), and the sharded jet algebra's
    dense_tanh on a pair-shaped float64 jet (B4a)."""
    import torch
    from deepsolid_tpu_torch import parallel
    from deepsolid_tpu_torch.device import set_full_precision
    from deepsolid_tpu_torch.ops import fwdlap as fl

    set_full_precision()
    cfg = diamond_cfg("none", SHARD_BATCH, "chip_smoke_float64_sharded",
                      deriv_devices=world_size)
    cfg.precision = "float64"
    shard = parallel.make_mesh(world_size).shard
    with plain_calls() as plain:
        el, launches = scan_el_chunk(cfg, shard, scan="off", dtype=torch.float64,
                                     walkers=F64_SHARD_WALKERS)
        shapes = read_shapes()
        dev = torch.device("cuda", torch.cuda.current_device())
        gen = torch.Generator(device=dev).manual_seed(1)
        rows, k = F64_SHARD_WALKERS * 96 * 96, 32

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)

        jet = fl.Jet(rnd(rows, k), rnd(6, rows, k), rnd(rows, k))
        w, b = rnd(k, 32) / math.sqrt(k), rnd(32)
        t_loc = 6 // world_size
        sl = slice(shard.t0(t_loc), shard.t0(t_loc) + t_loc)
        reset_launches()
        got = fl.dense_tanh(fl.Jet(jet.val, jet.jac[sl], jet.lap), w, b, shard=shard)
        algebra_launches, algebra_shapes = read_launches(), read_shapes()
        want = fl.dense_tanh(jet, w, b)
        _, rel = max_errs((got.val, got.jac, got.lap), (want.val, want.jac[sl], want.lap))
        torch.cuda.synchronize()
    return {"rank": rank, "el": el, "launches": launches, "launch_shapes": shapes,
            "algebra_launches": algebra_launches, "algebra_shapes": algebra_shapes,
            "algebra_max_rel_err": rel, "plain_calls": dict(plain),
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def float64_against_cpu(dev, source, systems, f32_reference):
    """E_L of the reference phase's walkers (8 C-diamond, 8 Si, 2 bcc-Li),
    the diamond walkers' energy gradient, KFAC update and pretraining loss
    and gradient, card float64 against CPU float64; the card's float32
    readings of the reference phase are the control that must fail."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.ops.cuda import det_kernels as dk

    f64 = torch.float64
    cpu = diamond_values(dev, source, "cpu", f64)
    card = diamond_values(dev, source, dev, f64)
    d = ((card["el"] - cpu["el"]).abs() / cpu["scale"]).numpy()
    el = {"diamond": (float(np.median(d)), float(d.max()))}
    bodies, want_bodies = {}, {}  # B1's complex128 bodies on each system's card E_L
    for name, (sys_cfg, klist, sys_params, sys_x) in systems.items():
        want = system_el(sys_cfg, klist, sys_params, sys_x, "cpu", f64, name)[0]
        before = dk.SHAPES.copy()
        got = system_el(sys_cfg, klist, sys_params, sys_x, dev, f64)[0]
        bodies[name] = sorted({key[2] for key in dk.SHAPES - before})
        want_bodies[name] = sorted({b1_body_c128(m) for m in sys_cfg.system.cell.nelec if m})
        d = ((got - want).abs() / sys_cfg.system.cell.scale).numpy()
        el[name] = (float(np.median(d)), float(d.max()))
    grad_rel, _ = rel_global(card["grad"], cpu["grad"])
    upd_rel, _ = rel_global(card["update"], cpu["update"])
    pre_grad_rel, _ = rel_global(card["pre_grad"], cpu["pre_grad"])
    pre_loss_rel = abs(card["pre_loss"] - cpu["pre_loss"]) / abs(cpu["pre_loss"])
    control = {
        "diamond": f32_reference["max_abs_diff_per_cell"],
        **{name: f32_reference[name]["max_abs_diff_per_cell"] for name in systems},
        "gradient": f32_reference["gradient_rel_err_global_norm"],
        "kfac_update": f32_reference["kfac_update_rel_err_global_norm"]}
    control_fails = (all(control[k] > F64_EL_TOLERANCE for k in el)
                     and control["gradient"] > F64_REL_TOLERANCE
                     and control["kfac_update"] > F64_REL_TOLERANCE)
    out = {
        "el_median_max_abs_diff_per_cell": el, "el_tolerance_max": F64_EL_TOLERANCE,
        "gradient_rel_err_global_norm": grad_rel, "kfac_update_rel_err_global_norm": upd_rel,
        "pretrain_loss_rel_err": pre_loss_rel,
        "pretrain_gradient_rel_err_global_norm": pre_grad_rel,
        "rel_tolerance": F64_REL_TOLERANCE,
        "float32_control": control, "float32_control_fails_checks": control_fails,
        "b1_bodies": bodies}
    out["ok"] = (all(m <= F64_EL_TOLERANCE for _, m in el.values())
                 and bodies == want_bodies
                 and max(grad_rel, upd_rel, pre_grad_rel, pre_loss_rel) <= F64_REL_TOLERANCE
                 and control_fails)
    return out


def float32_bias(dev, source, el_chunk):
    """E_L of the 1024 C-diamond checkpoint walkers in float32 and float64
    on the card: the batch-mean difference per primitive cell, its
    standard error, the per-walker median and max, beside the 1e-4
    Ha/atom budget; and the float64 E_L's walkers/s. The float32 main path
    (the det head's kernel) is held per walker to the float64 E_L
    (F32_EL_LIMITS), with the float32 plain head (`plain_det_head`) read
    beside it on the same walkers."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.configs import diamond
    from deepsolid_tpu_torch.hamiltonian import make_local_energy
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.train.process import build_network
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    cfg = diamond.get_config(CONFIG)
    sc = cfg.system.cell
    el_fn = make_local_energy(build_network(cfg, sc, klist_override=source.klist), sc)
    _, data, params_np, _, _ = restore(
        find_last_checkpoint(os.path.join(REPO, "runs", "ckpt_diamond")))
    data = data[:BATCH]
    out, seconds = {}, {}
    runs = (("float32", torch.float32, contextlib.nullcontext),
            ("plain_head", torch.float32, plain_det_head),
            ("float64", torch.float64, contextlib.nullcontext))
    for key, dtype, det_head in runs:
        params = params_from_jax(params_np, dev, dtype)
        x = torch.as_tensor(np.asarray(data, np.float64), dtype=dtype, device=dev)
        torch.cuda.synchronize(dev)
        start = time.perf_counter()
        with torch.no_grad(), det_head():
            els = [sum(el_fn(params, x[i:i + el_chunk]))
                   for i in range(0, len(x), el_chunk)]
        torch.cuda.synchronize(dev)
        seconds[key] = time.perf_counter() - start
        out[key] = (torch.cat(els).real.double() / sc.scale).cpu().numpy()
        del params, x, els
    d = out["float32"] - out["float64"]
    dc = out["plain_head"] - out["float64"]
    worst = np.argsort(-np.abs(d))[:5]
    median, largest = float(np.median(np.abs(d))), float(np.abs(d).max())
    above = float((np.abs(d) - np.abs(dc)).max())
    return {"walkers": len(d), "el_chunk": el_chunk,
            "el_mean_f64_per_cell": float(out["float64"].mean()),
            "mean_diff_f32_minus_f64_per_cell": float(d.mean()),
            "standard_error_per_cell": float(d.std(ddof=1) / math.sqrt(len(d))),
            "median_abs_diff_per_cell": median, "max_abs_diff_per_cell": largest,
            "plain_head_median_abs_diff_per_cell": float(np.median(np.abs(dc))),
            "plain_head_max_abs_diff_per_cell": float(np.abs(dc).max()),
            "worst_walkers": [{"walker": int(i), "diff": float(d[i]),
                               "plain_head_diff": float(dc[i])} for i in worst],
            "max_abs_diff_above_plain_head_per_cell": above,
            "limits_per_cell": F32_EL_LIMITS,
            "ok": (median <= F32_EL_LIMITS["median"] and largest <= F32_EL_LIMITS["max"]
                   and above <= F32_EL_LIMITS["above_composition"]),
            "budget_per_cell": F32_BIAS_BUDGET,
            "seconds_f32": seconds["float32"], "seconds_f64": seconds["float64"],
            "walkers_per_s_local_energy_f32": len(d) / seconds["float32"],
            "walkers_per_s_local_energy_f64": len(d) / seconds["float64"]}


def float64_phase(dev, source, main, north_star, systems, f32_reference, gen):
    """precision='float64' on the card: C-diamond 2x2x2 at full width from
    its checkpoint (cast to float64) through process(), with el_chunk and
    psi_chunk from a float64 probe, one inference and F64_KFAC_ITERATIONS
    KFAC iterations: every B1 and jet launch on a float64 body, no plain
    version called, B1's exact count; the inference iteration again through
    the command line (its energy equal to process()'s within the bootstrap
    phase's 1e-6 Ha/cell); two deriv ranks on the card (B4a,
    B4b); card against CPU float64; float32's bias on 1024 walkers; and
    each float64 body against its plain version. Returns the record and
    the kernel rows."""
    import csv

    import numpy as np
    import torch
    from deepsolid_tpu_torch import parallel
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.train.process import build_network
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    start = time.perf_counter()
    cfg = production_kfac(diamond_cfg("kfac", BATCH, "chip_smoke_float64_probe"))
    cfg.precision = "float64"
    net = build_network(cfg, cfg.system.cell, klist_override=source.klist)
    _, data, params_np, _, _ = restore(find_last_checkpoint(cfg.log.restore_path))
    params = params_from_jax(params_np, dev, torch.float64)
    x = torch.as_tensor(np.asarray(data), dtype=torch.float64, device=dev)
    probe = memory_probe(dev, cfg, net, params, x, F64_EL_CHUNKS, F64_PSI_CHUNKS)
    if probe["psi_chunk"] is None:
        probe["fallback"] = memory_probe(dev, cfg, net, params, x, (),
                                         F64_FALLBACK_PSI_CHUNKS)
        probe["psi_chunk"] = probe["fallback"]["psi_chunk"]
    emit({"phase": "float64_probe", **probe})
    del params, x
    torch.cuda.empty_cache()
    el_chunk, psi_chunk = probe["el_chunk"], probe["psi_chunk"]
    if el_chunk is None or psi_chunk is None:
        result = {"phase": "float64", "ok": False, "probe": probe}
        emit(result)
        return result, []
    psi_chunk = 0 if psi_chunk == BATCH else psi_chunk
    n_psi, n_el = (BATCH // psi_chunk if psi_chunk else 1), BATCH // el_chunk
    sweep = (cfg.mcmc.steps + 1) * n_psi

    # one inference iteration, then KFAC continuing the checkpoint's state
    inf_cfg = diamond_cfg("none", BATCH, "chip_smoke_float64_run")
    inf_cfg.precision, inf_cfg.optim.el_chunk = "float64", el_chunk
    inf_cfg.optim.psi_chunk = psi_chunk
    shutil.rmtree(inf_cfg.log.save_path, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats(dev)
    with plain_calls() as plain:
        _, inf_recs, inf_energy, inf_launches = inference_run(inf_cfg, 1)
        inf_shapes = read_shapes()
        inf_peak = torch.cuda.max_memory_allocated(dev)
        kfac = kfac_phase(dev, iterations=F64_KFAC_ITERATIONS, phase="float64_kfac",
                          batch=BATCH, psi_chunk=psi_chunk, precision="float64",
                          el_chunk=el_chunk)
    adapted = sum(kfac["adapted"])
    b1_want = {"inference": 2 * (sweep + n_el),
               "kfac": 2 * (kfac["iterations"] * (sweep + n_el + 2 * n_psi)
                            + adapted * n_el)}
    b1_got = {"inference": inf_launches["gj_inverse_slogdet"],
              "kfac": kfac["launches"]["gj_inverse_slogdet"]}
    not_f64 = float64_bodies_only(inf_shapes + kfac["launch_shapes"])
    not_new = float64_new_bodies(inf_shapes + kfac["launch_shapes"])

    # the command line: the same inference iteration through
    # `python -m deepsolid_tpu_torch --config.precision float64`
    cli_save = os.path.join(REPO, "build", "chip_smoke_float64_cli")
    shutil.rmtree(cli_save, ignore_errors=True)
    torch.cuda.empty_cache()
    cli_start = time.perf_counter()
    cli_out = run_session([sys.executable, "-m", "deepsolid_tpu_torch", "--device", "cuda",
                           *bootstrap_argv(inf_cfg.log.restore_path, cli_save, "float64",
                                           el_chunk)], timeout=300)
    cli_seconds = time.perf_counter() - cli_start
    stats = os.path.join(cli_save, "train_stats.csv")
    cli_rows = list(csv.DictReader(open(stats))) if os.path.exists(stats) else []
    cli_energy = float(cli_rows[0]["energy"]) if len(cli_rows) == 1 else float("nan")
    cli_diff = abs(cli_energy - inf_energy)

    # two deriv ranks sharing the card: the open bodies on the path (each
    # rank needs ~11 GB, so this process first returns its cached blocks)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    ranks = parallel.run_ranks(float64_sharded_rank, 2, backend="gloo", timeout=600.0)
    with plain_calls() as plain_unsharded:
        want_el, _ = scan_el_chunk(inf_cfg, scan="off", dtype=torch.float64,
                                   walkers=F64_SHARD_WALKERS)
    shard_diff = max(float(np.abs(r["el"] - want_el).max()) for r in ranks)
    for r in ranks:
        not_f64 += float64_bodies_only(r["launch_shapes"] + r["algebra_shapes"])
        not_new += float64_new_bodies(r["launch_shapes"] + r["algebra_shapes"])
    plain_total = (sum(plain.values()) + sum(plain_unsharded.values())
                   + sum(sum(r["plain_calls"].values()) for r in ranks))

    against_cpu = float64_against_cpu(dev, source, systems, f32_reference)
    bias = float32_bias(dev, source, el_chunk)
    profile = profile_phase(dev, inf_cfg, source.klist, params_np, data[:el_chunk],
                            f"one {el_chunk}-walker C-diamond local-energy chunk "
                            f"in float64", torch.float64)

    k_rec = {k: kfac[k] for k in (
        "seconds_per_iteration", "seconds_per_iteration_all", "walkers_per_s_local_energy",
        "walkers_per_s_iteration_without_adaptation", "walkers_per_s_iteration_all",
        "peak_memory_bytes", "energy_per_cell", "adapted", "ok")}
    f32_el = main["walkers_per_s_local_energy_median"]
    f32_iter = north_star["batch_1024"]["walkers_per_s_iteration_without_adaptation"]
    result = {
        "phase": "float64", "config": CONFIG, "batch": BATCH, "precision": "float64",
        "el_chunk": el_chunk, "psi_chunk": psi_chunk, "probe": probe,
        "inference": {"seconds": inf_recs[0]["seconds"], "energy_per_cell": inf_energy,
                      "walkers_per_s_local_energy":
                          BATCH / inf_recs[0]["seconds"]["local_energy"],
                      "walkers_per_s_iteration": BATCH / inf_recs[0]["seconds"]["step"],
                      "peak_memory_bytes": inf_peak, "launches": inf_launches,
                      "launch_shapes": inf_shapes},
        "command_line": {"returncode": cli_out.returncode, "seconds": cli_seconds,
                         "energy_per_cell": cli_energy,
                         "abs_energy_diff_per_cell_against_process": cli_diff,
                         "tolerance": BOOTSTRAP_TOLERANCE,
                         **({"stderr_tail": cli_out.stderr[-3000:]}
                            if cli_out.returncode else {})},
        "kfac": k_rec, "kfac_launches": kfac["launches"],
        "kfac_launch_shapes": kfac["launch_shapes"],
        "b1_launches": b1_got, "b1_launches_expected": b1_want,
        "launches_not_on_a_float64_body": not_f64, "plain_version_calls": plain_total,
        "launches_off_the_redesigned_float64_bodies": not_new,
        "walkers_per_s_local_energy_f64": k_rec["walkers_per_s_local_energy"],
        "walkers_per_s_local_energy_f32_main": f32_el,
        "local_energy_ratio_f64_over_f32": k_rec["walkers_per_s_local_energy"] / f32_el,
        "walkers_per_s_iteration_f64": k_rec["walkers_per_s_iteration_without_adaptation"],
        "walkers_per_s_iteration_f32_north_star_1024": f32_iter,
        "iteration_ratio_f64_over_f32":
            k_rec["walkers_per_s_iteration_without_adaptation"] / f32_iter,
        "sharded": {"walkers": F64_SHARD_WALKERS,
                    "max_abs_el_diff_per_cell": shard_diff,
                    "tolerance": F64_EL_TOLERANCE,
                    "launches_per_rank": [r["launches"] for r in ranks],
                    "algebra_launches_per_rank": [r["algebra_launches"] for r in ranks],
                    "algebra_max_rel_err": max(r["algebra_max_rel_err"] for r in ranks),
                    "peak_memory_bytes_per_rank": [r["peak_memory_bytes"] for r in ranks]},
        "against_cpu_f64": against_cpu, "float32_bias": bias,
        "profile_device_idle_share": profile["device_idle_share"], "card": nvidia_smi(),
    }
    result["ok"] = (
        kfac["ok"] and b1_got == b1_want and not not_f64 and not not_new
        and plain_total == 0
        and cli_out.returncode == 0 and cli_diff <= BOOTSTRAP_TOLERANCE
        and all(inf_launches[k] > 0 and kfac["launches"][k] > 0
                for k in ("fused_dense_tanh_jet", "fused_dense_tanh_jet_mix"))
        and math.isfinite(inf_energy) and abs(inf_energy - REFERENCE_ENERGY) <= ENERGY_WINDOW
        and all(r["launches"]["fused_dense_tanh_jet_mix_partial"] == 3
                and r["launches"]["gj_inverse_slogdet"] == 2
                and r["algebra_launches"]["fused_dense_tanh_jet_partial"] == 1
                and r["algebra_max_rel_err"] <= JET_F64_TOLERANCE for r in ranks)
        and shard_diff <= F64_EL_TOLERANCE and against_cpu["ok"]
        and math.isfinite(bias["mean_diff_f32_minus_f64_per_cell"]) and bias["ok"])

    # the kernel rows, each with the float64 path's launches at its shapes
    rows = float64_kernel_rows(dev, gen, el_chunk,
                               ((BATCH * 8 // n_psi, 48), (el_chunk * 8, 48)))
    path = {"launches": {k: inf_launches[k] + kfac["launches"][k] for k in KERNELS},
            "launch_shapes": inf_shapes + kfac["launch_shapes"]}
    for r in ranks[:1]:
        for k in ("fused_dense_tanh_jet_partial", "fused_dense_tanh_jet_mix_partial"):
            path["launches"][k] += r["launches"][k] + r["algebra_launches"][k]
        path["launch_shapes"] += r["launch_shapes"] + r["algebra_shapes"]
    def launched(kernel, shape):
        return sum(s["launches"] for s in path["launch_shapes"]
                   if s["kernel"] == kernel and s["shape"] == shape)

    for row in rows:
        row["launches"] = path["launches"][row["name"]]
        row["launches_at_shape"] = [launched(row["name"], s) for s in row["shapes"]]
        emit({"phase": "kernel", **row})
    # every row holds; every kernel launched on the path, at each shape the
    # path gives it (the others are the other systems' production shapes)
    result["kernel_rows_ok"] = all(
        r["ok"] and r["launches"] > 0
        and all(launched(r["name"], s) > 0 for s in r["path_shapes"]) for r in rows)
    result["ok"] = result["ok"] and result["kernel_rows_ok"]
    result["seconds"] = time.perf_counter() - start
    emit(result)
    return result, rows


def float64_system_run(dev, cfg, iterations, phase):
    """process(cfg, iterations) on the card with every plain version
    counted: the run's iteration records and energy, launch counts and
    shapes (B1's bodies, launches off a float64 body or off the body
    redesigned for it), plain calls, peak memory and seconds."""
    import torch
    from deepsolid_tpu_torch.optim.adam import tree_leaves
    from deepsolid_tpu_torch.train.process import process

    iters = []

    def on_iteration(t, row, seconds):
        row.pop("local_energy")
        rec = {"phase": f"{phase}_iteration", "step": t, **row, "seconds": seconds,
               "adapted": "adapt" in seconds}
        iters.append(rec)
        emit(rec)

    shutil.rmtree(cfg.log.save_path, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with plain_calls() as plain:
        reset_launches()
        start = time.perf_counter()
        params, _, energy = process(cfg, iterations, device="cuda",
                                    on_iteration=on_iteration)
        wall = time.perf_counter() - start
        launches, shapes = read_launches(), read_shapes()
    batch = cfg.batch_size
    return {
        "seconds": wall, "steps": [r["step"] for r in iters], "energy_per_cell": energy,
        "loss_per_cell": [r["energy"] for r in iters],
        "seconds_per_iteration": [r["seconds"] for r in iters],
        "mcmc_share": [r["seconds"]["mcmc"] / r["seconds"]["step"] for r in iters],
        "walkers_per_s_local_energy": [batch / r["seconds"]["local_energy"] for r in iters],
        "walkers_per_s_iteration": [batch / r["seconds"]["step"] for r in iters],
        "adapted": [r["adapted"] for r in iters],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
        "launches": launches, "launch_shapes": shapes, "b1_bodies": b1_bodies(shapes),
        "plain_version_calls": sum(plain.values()),
        "launches_not_on_a_float64_body": float64_bodies_only(shapes),
        "launches_off_the_redesigned_float64_bodies": float64_new_bodies(shapes),
        "finite": (math.isfinite(energy)
                   and all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))
                   and all(math.isfinite(r["energy"]) for r in iters)),
    }


def float64_run_ok(run, b1_want, n, iterations):
    """A float64 system run's checks: its iterations, B1's exact count,
    every B1 launch at n on the complex128 body n names, every launch on a
    float64 body and on the one redesigned for it, no plain call, both jet
    kernels launched and finite parameters and energies."""
    return (len(run["steps"]) == iterations
            and run["launches"]["gj_inverse_slogdet"] == b1_want
            and run["b1_bodies"] == {n: [b1_body_c128(n)]}
            and not run["launches_not_on_a_float64_body"]
            and not run["launches_off_the_redesigned_float64_bodies"]
            and run["plain_version_calls"] == 0
            and run["launches"]["fused_dense_tanh_jet"] > 0
            and run["launches"]["fused_dense_tanh_jet_mix"] > 0 and run["finite"])


def bcc_li_float64(dev, f32=None):
    """bcc-Li 3x3x3 (162 electrons, 81 a spin) at full width in float64
    through process(): runs/bcc_li_run.py's settings from the committed
    handoff checkpoint cast to float64, el_chunk and psi_chunk from a
    float64 probe, F64_BCC_LI_BURN_IN burn-in sweeps and one KFAC
    fisher_exact iteration from a fresh state: its split, walkers/s beside
    the float32 bcc_li phase's (`f32`), peak memory and B1's exact count,
    every (., 81, 81) launch on the mid complex128 body."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.train.process import build_network, orbital_source
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    start = time.perf_counter()
    cfg = bcc_li_cfg(0, 0)
    cfg.precision = "float64"
    sc = cfg.system.cell
    net = build_network(cfg, sc, klist_override=orbital_source(cfg, sc).klist)
    _, data, params_np, _, _ = restore(find_last_checkpoint(BCC_LI_CKPT))
    params = params_from_jax(params_np, dev, torch.float64)
    x = torch.as_tensor(np.asarray(data), dtype=torch.float64, device=dev)
    probe = memory_probe(dev, cfg, net, params, x, F64_BCC_LI_EL_CHUNKS,
                         F64_BCC_LI_PSI_CHUNKS)
    emit({"phase": "float64_bcc_li_probe", **probe})
    del params, x, net
    torch.cuda.empty_cache()
    if probe["el_chunk"] is None or probe["psi_chunk"] is None:
        return {"phase": "float64_bcc_li", "ok": False, "probe": probe}

    cfg = bcc_li_cfg(probe["el_chunk"], probe["psi_chunk"])
    cfg.precision = "float64"
    cfg.mcmc.burn_in = F64_BCC_LI_BURN_IN
    cfg.log.save_path = os.path.join(REPO, "build", "chip_smoke_float64_bcc_li")
    run = float64_system_run(dev, cfg, F64_SYSTEM_KFAC_ITERATIONS, "float64_bcc_li")
    # the handoff's burn-in sweeps, then per iteration the sampler, E_L,
    # the gradient's and the capture's forward passes, two spins each
    n_psi, n_el = BATCH // cfg.optim.psi_chunk, BATCH // cfg.optim.el_chunk
    sweep = (cfg.mcmc.steps + 1) * n_psi
    b1_want = 2 * (cfg.mcmc.burn_in * sweep + len(run["steps"]) * (sweep + n_el + 2 * n_psi)
                   + sum(run["adapted"]) * n_el)
    f32_iter = f32["walkers_per_s_iteration_without_adaptation"] if f32 else None
    f32_el = statistics.median(f32["walkers_per_s_local_energy"]) if f32 else None
    result = {
        "phase": "float64_bcc_li", "precision": "float64", "batch": BATCH,
        "electrons": list(sc.nelec), "el_chunk": cfg.optim.el_chunk,
        "psi_chunk": cfg.optim.psi_chunk, "burn_in": cfg.mcmc.burn_in,
        "burn_in_run_script": 100, "probe": probe, **run,
        "b1_launches_expected": b1_want,
        "walkers_per_s_local_energy_f32_bcc_li": f32_el,
        "walkers_per_s_iteration_f32_bcc_li": f32_iter,
        "phase_seconds": time.perf_counter() - start, "card": nvidia_smi(),
    }
    result["ok"] = float64_run_ok(run, b1_want, sc.nelec[0], F64_SYSTEM_KFAC_ITERATIONS)
    return result


def si_float64(dev, f32):
    """Si 1x1x1 (14 electrons a spin) at full width in float64 through
    process(), runs/si_diamond_run.py's settings with psi_chunk unset, from
    the si phase's last checkpoint cast to float64: one inference iteration
    and one KFAC iteration continuing the phase's KFAC state, their split,
    walkers/s beside the float32 si phase's (`f32`, psi_chunk 64) and peak
    memory, B1's exact count, every (., 14, 14) launch on the warp
    complex128 body."""
    from deepsolid_tpu_torch.utils.checkpoint import find_last_checkpoint, restore

    start = time.perf_counter()
    source_path = si_cfg().log.save_path
    t_start = restore(find_last_checkpoint(source_path))[0]

    def cfg_for(optimizer, save_name):
        cfg = si_cfg()
        cfg.precision, cfg.optim.optimizer = "float64", optimizer
        cfg.optim.psi_chunk = 0  # the run script leaves it unset
        cfg.log.restore_path = source_path
        cfg.log.save_path = os.path.join(REPO, "build", save_name)
        return cfg

    inf_cfg = cfg_for("none", "chip_smoke_float64_si_inference")
    inference = float64_system_run(dev, inf_cfg, 1, "float64_si_inference")
    kfac_cfg = cfg_for("kfac", "chip_smoke_float64_si_kfac")
    kfac = float64_system_run(dev, kfac_cfg, t_start + F64_SYSTEM_KFAC_ITERATIONS,
                              "float64_si_kfac")
    n_el = BATCH // kfac_cfg.optim.el_chunk
    sweep = kfac_cfg.mcmc.steps + 1  # psi_chunk unset: one chunk
    want = {"inference": 2 * (sweep + n_el),
            "kfac": 2 * (len(kfac["steps"]) * (sweep + n_el + 2) + sum(kfac["adapted"]) * n_el)}
    n = kfac_cfg.system.cell.nelec[0]
    result = {
        "phase": "float64_si", "precision": "float64", "batch": BATCH,
        "el_chunk": kfac_cfg.optim.el_chunk, "psi_chunk": 0,
        "restored_step": t_start, "inference": inference, "kfac": kfac,
        "b1_launches_expected": want,
        "walkers_per_s_local_energy_f32_si": statistics.median(
            f32["kfac_walkers_per_s_local_energy"]),
        "walkers_per_s_iteration_f32_si_psi_chunk_64":
            f32["kfac_walkers_per_s_iteration_without_adaptation"],
        "phase_seconds": time.perf_counter() - start, "card": nvidia_smi(),
    }
    result["ok"] = (float64_run_ok(inference, want["inference"], n, 1)
                    and float64_run_ok(kfac, want["kfac"], n, F64_SYSTEM_KFAC_ITERATIONS))
    # what the kernel rows read: both runs' launches
    result["launches"] = {k: inference["launches"][k] + kfac["launches"][k]
                          for k in KERNELS}
    result["launch_shapes"] = inference["launch_shapes"] + kfac["launch_shapes"]
    return result


def float64_systems_phase(dev, gen, si, bcc_li):
    """float64 bcc-Li 3x3x3 and Si 1x1x1 on the card (`bcc_li_float64`,
    `si_float64`, beside the float32 phases' records `bcc_li` and `si`),
    then each float64 body against its plain version at every shape the two
    paths launched: B1 in complex128 on a sampler and an E_L launch, B2 and
    B3 in double on one E_L chunk, each row with its path's launches and
    on the body its path took at each shape. Returns the phase's record
    and the kernel rows."""
    import torch

    bcc = bcc_li_float64(dev, bcc_li)
    emit(bcc)
    torch.cuda.empty_cache()
    si64 = si_float64(dev, si)
    emit({k: v for k, v in si64.items() if k not in ("launches", "launch_shapes")})
    records = {"float64_bcc_li": bcc, "float64_si": si64}
    rows, bad = [], []
    if bcc["ok"] and si64["ok"]:
        c128, f64 = torch.complex128, torch.float64
        rows = [b1_row(dev, gen, nb, n, path, c128) for path, nb, n in (
            ("float64_bcc_li", bcc["psi_chunk"] * 8, 81),
            ("float64_bcc_li", bcc["el_chunk"] * 8, 81),
            ("float64_si", BATCH * 8, 14), ("float64_si", si64["el_chunk"] * 8, 14))]
        for path, n, chunk, system in (("float64_bcc_li", 162, bcc["el_chunk"], "bcc-Li "),
                                       ("float64_si", 28, si64["el_chunk"], "Si ")):
            rows += [b2_row(dev, gen, n, chunk, path, system, dtype=f64),
                     b3_row(dev, gen, n, chunk, path, system, dtype=f64)]
        # the det head kernel at bcc-Li's float64 E_L chunk: the tensor-core body
        rows.append(dethead_row(dev, gen, bcc["el_chunk"], 81, 6 * 81, "float64_bcc_li",
                                dtype=f64, window=DETHEAD_PLAIN_WINDOW))
        for row in rows:  # the body the path took at each of the row's shapes
            took = [sorted({r["variant"] for r in records[row["path"]]["launch_shapes"]
                            if r["kernel"] == row["name"] and r["shape"] == shape})
                    for shape in row["shapes"]]
            want = row["variant"] if isinstance(row["variant"], list) else [row["variant"]]
            row["path_variants"] = took
            row["ok"] = row["ok"] and took == [[v] for v in want]
        bad = with_path_launches(rows, records)
    result = {"phase": "float64_systems", "bcc_li_ok": bcc["ok"], "si_ok": si64["ok"],
              "kernel_rows_failing": bad}
    result["ok"] = bcc["ok"] and si64["ok"] and not bad
    emit(result)
    return result, rows


def profile_phase(dev, cfg, klist, params, x, what, dtype=None):
    """Where one local-energy chunk (walkers `x`, numpy parameters `params`)
    spends the card's time, in float32 or `dtype`."""
    import numpy as np
    import torch
    from deepsolid_tpu_torch.hamiltonian import make_local_energy
    from deepsolid_tpu_torch.models.network import params_from_jax
    from deepsolid_tpu_torch.train.process import build_network

    dtype = dtype or torch.float32
    net = build_network(cfg, cfg.system.cell, klist_override=klist)
    params = params_from_jax(params, dev, dtype)
    x = torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
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
    smi = nvidia_smi()
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
    KERNEL_RESOURCES[:] = build.resources(log)
    emit({"kernel_resources": KERNEL_RESOURCES})

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
    # the det head kernel: one launch a spin channel and E_L chunk
    want = 2 * (BATCH // EL_CHUNK) * ITERATIONS
    if path_launches["dethead_traces"] != want:
        return fail(f"the main path launched the det head kernel "
                    f"{path_launches['dethead_traces']} times, not {want}")

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

    north_star, big = north_star_phase(dev, source, kfac)
    if not north_star["ok"]:
        return fail("the north_star phase failed its checks (no psi_chunk under "
                    "the memory limit, the kfac phase's checks at batch 1024 with "
                    "psi_chunk unset or at batch 4096, the elastic restore, the "
                    "KFAC update against CPU f64, or B1 at n = 48 not on the "
                    "registers body)")
    shaped = north_star_kernel_rows(dev, gen, big)
    kernels += shaped
    bad = with_path_launches(shaped, {"north_star_4096": big})
    if bad:
        return fail(f"B1 at the 4096-walker shape disagrees with its plain "
                    f"version or the path launched none: {bad}")

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
    for system in COLD_SYSTEMS:
        record = cold_phase(dev, system)
        if not record["ok"]:
            return fail(f"the {system} phase failed its checks (the cold UHF, the "
                        f"pretraining loss did not fall, a non-finite value, a "
                        f"checkpoint, B1 not on the warp body, a kernel of the "
                        f"path never launched, or E_L against CPU f64 or its "
                        f"TF32 control)")
        shaped = cold_kernel_rows(dev, gen, system, record)
        kernels += shaped
        bad = with_path_launches(shaped, {system: record})
        if bad:
            return fail(f"kernels at the {system} shapes disagree with their plain "
                        f"versions or the path launched none at a shape: {bad}")
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
    systems = {"si": si_reference, "bcc_li": bcc_li_reference}
    reference = reference_phase(dev, source, systems)
    if not reference["ok"]:
        return fail("card E_L (C-diamond, Si or bcc-Li), its gradient, the "
                    "KFAC update or the pretraining loss or its gradient "
                    "disagrees with the CPU float64 reference, or the TF32 "
                    "control passed the check")
    float64, shaped = float64_phase(dev, source, main_result, north_star, systems,
                                    reference, gen)
    kernels += shaped
    if not float64["ok"]:
        return fail("the float64 phase failed its checks (no el_chunk or "
                    "psi_chunk under the memory limit, the KFAC checks, B1's "
                    "exact launch count, a launch on a float32 body, a "
                    "one-electron jet launch off the wide body in double or a "
                    "complex128 B1 launch off the body its n names, a call "
                    "of a plain version, the sharded E_L, card float64 against "
                    "CPU float64 or the float32 control, float32 E_L against "
                    "the card's float64 (F32_EL_LIMITS), or a float64 body "
                    "against its plain version or never launched at a path shape)")
    f64_systems, shaped = float64_systems_phase(dev, gen, si, bcc_li)
    kernels += shaped
    if not f64_systems["ok"]:
        return fail("the float64_systems phase failed its checks (bcc-Li's "
                    "probe found no chunk under the memory limit, an "
                    "iteration, B1's exact launch count, a (., 81, 81) "
                    "launch off the mid complex128 body or a (., 14, 14) "
                    "launch off the warp complex128 body, a launch on a "
                    "float32 body, a call of a plain version, a non-finite "
                    "value, or B1, B2 or B3 against its plain version or off "
                    "the path's body at a path shape)")
    si_2x2x2 = si_2x2x2_phase(dev)
    if not si_2x2x2["ok"]:
        return fail("the si_2x2x2 phase failed its checks (an iteration, B1's "
                    "exact launch count or a (., 112, 112) launch off the mid "
                    "wide body, a det head launch off the staged complex64 "
                    "body, its shape or its count of two an E_L chunk and "
                    "pass, or a non-finite value)")
    shaped = si_2x2x2_kernel_rows(dev, gen, si_2x2x2)
    kernels += shaped
    bad = with_path_launches(shaped, {"si_2x2x2": si_2x2x2})
    if bad:
        return fail(f"kernels at the Si 2x2x2 shapes disagree with their plain "
                    f"versions, take another body, or the path launched none "
                    f"at a shape: {bad}")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi, flush=True)
    emit({"kernels": [{**{k: r[k] for k in keys}, "dtype": r.get(
        "dtype", "complex64" if r["name"] == "gj_inverse_slogdet" else "float32"),
        **({"body": r["variant"]} if "variant" in r else {})} for r in kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
