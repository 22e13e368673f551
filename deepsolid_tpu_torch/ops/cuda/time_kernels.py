"""Times the kernels' launchers alone, beside another design's, on a CUDA machine.

    python -m deepsolid_tpu_torch.ops.cuda.time_kernels
    python -m deepsolid_tpu_torch.ops.cuda.time_kernels \\
        --baseline DIR [--baseline-slices N] [--baseline-pair] [--slices 2,4,8]
    python -m deepsolid_tpu_torch.ops.cuda.time_kernels --dethead-only [--baseline DIR]

A kernel's time moves by up to ~30% between machines and runs, so two
designs are compared inside one process, in turns (baseline, current,
current, baseline). DIR holds gj_inverse.cu and dense_tanh_jet.cu of the
other design with the same C interface (an earlier commit's csrc/, or a
copy of the present one with a constant changed); they are built there
with build.py's flags. The launchers are called directly, on buffers
allocated once: no wrapper, no allocation in the timed region. `ms` is
one launch between two CUDA events, which for a launch shorter than its
host call (~20 us through ctypes) reads the host; the Gauss-Jordan rows
also give `graph_ms`, per launch of a CUDA graph of 20 launches.

The Gauss-Jordan kernel is timed at the launch shapes of the production
systems (GJ_SHAPES, complex64): C-diamond 2x2x2's (8192, 48, 48), (512,
48, 48) and, at batch 4096 unchunked, (32768, 48, 48), bcc-Li 3x3x3's
(4096, 81, 81) sampler and (256, 81, 81) E_L launches, Si's (512, 14, 14)
and (1024, 14, 14) and the run script's (8192, 14, 14), LiH 2x2x2's
(16384, 16, 16) and (2048, 16, 16) and graphene's (8192, 6, 6) and (2048,
6, 6), each with the body it takes and its bound. The jet kernels at the
C-diamond 2x2x2 main path's shapes: the one-electron jet kernels on 6144
rows, d_out 256, T = 288 (closed) or 144 (open), d_in 16, 320 or 256; the
two-electron (pair) jet kernels on 589,824 rows, d_out 32, d_in 4 and 32,
T = 6 (closed) and 3 (open); and at one 256-walker E_L chunk of LiH 2x2x2
(T = 96 on 8192 rows; 262,144 pair rows) and of graphene (T = 36 on 3072
rows; 36,864 pair rows). The float64 bodies at the float64 paths' shapes: B1 in
complex128 at every production system's launch shapes (GJ_SHAPES_C128), and the
float64 jet kernels (JET_SHAPES_F64): the one-electron layers (T = 288
closed and 144 open on 6144 rows, d_in 16 and 320) and the pair layers
(d_in 4 and 32, d_out 32) of one float64 E_L chunk of C-diamond 2x2x2
(589,824 rows), bcc-Li 3x3x3 (419,904) and Si 1x1x1 (100,352) at T = 6,
and of one rank of the float64 sharded chunk (T_local = 3 open, 294,912
rows): B1 beside the other design's complex128 entry, the jets beside
this build's general body in double (slices 0, what every float64 shape
ran before the wide and pair bodies in double).
For the wide jet variant the
current design is timed at each slice count of --slices beside the one
jet_kernels.kernel_variant chooses; --baseline-slices is the slice count
the other design is handed at the wide shapes (6 for the 128 x 64-tile
design); at the pair shapes the other design runs its general kernel
(slices 0) unless --baseline-pair says it has a pair body of its own. One
JSON line per shape, with the bytes bound beside the times, and
`same_bits`: whether the two designs' outputs on the same inputs agree
bit for bit (a design that changes no arithmetic must read true; a
float64 body that sums in another order reads false).

The det head's one-pass kernel (dethead_kernels, csrc/dethead_trace.cu)
is timed at one spin channel of an E_L chunk of C-diamond 2x2x2 (512
matrices of 48, T = 288) in float32 and float64, of bcc-Li 3x3x3 (256
of 81, T = 486, in float32; 128 in float64) and of Si 2x2x2 (128 and 256
of 112, T = 672) in float32 (DETHEAD_SHAPES), with each body's shared
memory a block and blocks an SM: its launcher alone, the
wrapper, its plain version, and the whole stage it serves from the
orbital GEMM's products to (sign, jet of log det) (fl.det_head_jet)
against the composition it stands for (the broadcast add, complexify,
fl.mul_row, fl.slogdet_jet), in turns, with its bound (8 n^3 flops a
matrix and tangent at the precision's peak: FP32 FMA, and for float64 the
FP64 tensor cores, with the FMA-only bound beside), and the launcher with
one block a matrix beside the tangent split it takes (`unsplit_ms`).
Where the plain version or the composition would not fit the card's
free memory (about five copies of the orbital Jacobian: Si's 256
matrices), the plain version is read on the first 8 walkers and the
composition's and the plain version's times are null. `--dethead-only` times
these rows alone; with --baseline, beside DIR's dethead_trace.cu in turns.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
from pathlib import Path

from deepsolid_tpu_torch.ops.cuda import build
from deepsolid_tpu_torch.ops.cuda import det_kernels as dk
from deepsolid_tpu_torch.ops.cuda import jet_kernels as jk

WALKERS = 64
ROWS, D_OUT = WALKERS * 96, 256          # one-electron stream
PAIR_ROWS, PAIR_D_OUT = WALKERS * 96 * 96, 32  # two-electron stream
PEAK_BYTES = 3.35e12  # H100 SXM HBM bytes/s (NVIDIA data sheet, 700 W)
PEAK_FP32 = 67e12     # H100 SXM FP32 FLOP/s outside the tensor cores
PEAK_FP64_TENSOR = 67e12  # H100 SXM FP64 FLOP/s on the tensor cores
PEAK_FP64_FMA = 34e12     # and outside them
# E_L chunks of LiH rock-salt 2x2x2 (32 electrons) and graphene 1x1 (12)
# at their run scripts' el_chunk
COLD_WALKERS, LIH_N, GRAPHENE_N = 256, 32, 12
# (matrices, n) of each Gauss-Jordan launch shape
GJ_SHAPES = ((8192, 48), (512, 48), (4096, 81), (256, 81), (512, 14),
             (1024, 14), (8192, 14), (16384, 16), (2048, 16), (8192, 6),
             (2048, 6), (32768, 48))
# (T, rows, d_in, d_out, mix rule, open form, walkers of the rows)
JET_SHAPES = ((288, ROWS, 16, D_OUT, True, False, WALKERS),
              (288, ROWS, 320, D_OUT, True, False, WALKERS),
              (144, ROWS, 16, D_OUT, True, True, WALKERS),
              (144, ROWS, 320, D_OUT, True, True, WALKERS),
              (144, ROWS, 256, D_OUT, False, True, WALKERS),
              (6, PAIR_ROWS, 4, PAIR_D_OUT, False, False, WALKERS),
              (6, PAIR_ROWS, 32, PAIR_D_OUT, False, False, WALKERS),
              (3, PAIR_ROWS, 4, PAIR_D_OUT, False, True, WALKERS),
              (3, PAIR_ROWS, 32, PAIR_D_OUT, False, True, WALKERS),
              (6, PAIR_ROWS - 13, 32, PAIR_D_OUT, False, False, WALKERS),
              *((3 * n, COLD_WALKERS * n, d_in, D_OUT, True, False, COLD_WALKERS)
                for n in (LIH_N, GRAPHENE_N) for d_in in (16, 320)),
              *((6, COLD_WALKERS * n * n, d_in, PAIR_D_OUT, False, False, COLD_WALKERS)
                for n in (LIH_N, GRAPHENE_N) for d_in in (4, 32)))
# the float64 paths' shapes (precision='float64'): B1 in complex128 at
# C-diamond's sampler and E_L launches (the registers body), bcc-Li's at
# psi_chunk 256 and el_chunk 16 and the run script's 512 (mid), Si's with
# psi_chunk unset and el_chunk 128, LiH's, H10's and graphene's sampler
# shapes (warp); and the C-diamond one-electron jet kernels closed and open
GJ_SHAPES_C128 = ((8192, 48), (512, 48), (4096, 81), (2048, 81), (128, 81),
                  (8192, 14), (1024, 14), (16384, 16), (16384, 5), (8192, 6))
# (walkers, electrons) of the float64 paths' E_L chunks: C-diamond's
# el_chunk 64, bcc-Li's 16, Si's 128; and the sharded chunk's 32 walkers
F64_PAIR_CHUNKS = ((WALKERS, 96), (16, 162), (128, 28))
F64_SHARD_WALKERS = 32
# (walkers, determinants, n, T, precision) of one spin channel of an E_L
# chunk: C-diamond at el_chunk 64 in float32 and float64, bcc-Li at 32 in
# float32 and at 16 in float64, Si 2x2x2 at 16 and 32
DETHEAD_SHAPES = ((WALKERS, 8, 48, 288, "float32"), (WALKERS, 8, 48, 288, "float64"),
                  (32, 8, 81, 486, "float32"), (16, 8, 81, 486, "float64"),
                  (16, 8, 112, 672, "float32"), (32, 8, 112, 672, "float32"))
JET_SHAPES_F64 = ((288, ROWS, 16, D_OUT, True, False, WALKERS),
                  (288, ROWS, 320, D_OUT, True, False, WALKERS),
                  (144, ROWS, 16, D_OUT, True, True, WALKERS),
                  (144, ROWS, 320, D_OUT, True, True, WALKERS),
                  *((6, g * n * n, d_in, PAIR_D_OUT, False, False, g)
                    for g, n in F64_PAIR_CHUNKS for d_in in (4, 32)),
                  *((3, F64_SHARD_WALKERS * 96 * 96, d_in, PAIR_D_OUT, False, True,
                     F64_SHARD_WALKERS) for d_in in (4, 32)))


def baseline_library(directory: Path, name: str, signatures) -> ctypes.CDLL:
    out = directory / f"lib{name}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(directory / f"{name}.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    for fn, (restype, argtypes) in signatures.items():
        if hasattr(lib, fn):  # an older design may export fewer functions
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
    return lib


def time_ms(fn, warmup: int = 3, reps: int = 15) -> float:
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


def graph_ms(fn, launches: int = 20) -> float:
    """Device milliseconds per call of `fn` (one launch on the current
    stream), from a CUDA graph of `launches` calls replayed back to back:
    no host time between the launches, which a launch shorter than its
    host call would otherwise measure."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return time_ms(graph.replay, warmup=2, reps=10) / launches


def gj_launcher(lib, a):
    """The launch entry of `a`'s dtype (complex64 or complex128)."""
    import torch

    c128 = a.dtype == torch.complex128
    ainv = torch.empty_like(a)
    sign = torch.empty(a.shape[0], dtype=a.dtype, device=a.device)
    logdet = torch.empty(a.shape[0], dtype=torch.float64 if c128 else torch.float32,
                         device=a.device)
    entry = lib.gj_inverse_slogdet_launch_c128 if c128 else lib.gj_inverse_slogdet_launch

    def run():
        code = entry(
            a.data_ptr(), ainv.data_ptr(), sign.data_ptr(), logdet.data_ptr(),
            a.shape[0], a.shape[1], torch.cuda.current_stream().cuda_stream)
        build.check(lib, code, "gj_inverse_slogdet")
    run.outputs = (ainv, sign, logdet)
    return run


def jet_launcher(lib, slices, val, jac, lap, w, b, mix, open_sum):
    """The launch entry of val's dtype (float32 or float64)."""
    import torch

    t_dim, rows, d_in = jac.shape
    d_out = w.shape[1]
    f64 = val.dtype == torch.float64
    val_o = torch.empty(rows, d_out, device=val.device, dtype=val.dtype)
    lap_o = torch.empty_like(val_o)
    jac_o = torch.empty(t_dim, rows, d_out, device=val.device, dtype=val.dtype)
    sq_o = torch.empty_like(val_o) if open_sum else None
    scratch = torch.empty(max(slices, 1), rows, d_out, device=val.device, dtype=val.dtype)
    zbc, lbc, jbc = mix if mix else (None,) * 3
    groups = zbc.shape[0] if mix else 1
    stream = torch.cuda.current_stream().cuda_stream

    def ptr(x):
        return None if x is None else x.data_ptr()

    def run():
        entry = lib.dense_tanh_jet_launch_f64 if f64 else lib.dense_tanh_jet_launch
        code = entry(
            ptr(val), ptr(lap), ptr(jac), ptr(w), ptr(b), ptr(zbc), ptr(lbc),
            ptr(jbc), ptr(val_o), ptr(lap_o), ptr(jac_o), ptr(scratch),
            ptr(sq_o), slices, t_dim, rows, d_in, d_out, rows // groups,
            groups, stream)
        build.check(lib, code, "dense_tanh_jet")
    run.outputs = tuple(x for x in (val_o, jac_o, lap_o, sq_o) if x is not None)
    return run


def same_bits(current, base):
    """Whether two launchers' outputs, after their last runs, agree bit for
    bit; None without a baseline."""
    import torch

    if base is None:
        return None
    torch.cuda.synchronize()
    return all(torch.equal(x, y) for x, y in zip(current.outputs, base.outputs))


def main() -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", type=Path, default=None)
    parser.add_argument("--baseline-slices", type=int, default=None)
    parser.add_argument("--baseline-pair", action="store_true")
    parser.add_argument("--slices", default="2,4,8")
    parser.add_argument("--dethead-only", action="store_true")
    args = parser.parse_args()
    sweep = [int(s) for s in args.slices.split(",") if s]

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "baseline": str(args.baseline)}), flush=True)
    if args.dethead_only:
        dethead_rows(dev, gen, args.baseline)
        return

    gj, jet = dk._lib(), jk._lib()
    gj_base = jet_base = None
    if args.baseline:
        gj_base = baseline_library(args.baseline, "gj_inverse", dk._SIGNATURES)
        jet_base = baseline_library(args.baseline, "dense_tanh_jet", jk._SIGNATURES)

    def in_turns(current, base, timer=time_ms):
        """Milliseconds as baseline, current, current, baseline."""
        first = timer(base) if base else None
        ms = [timer(current), timer(current)]
        return ms, ([first, timer(base)] if base else None)

    for nb, n in GJ_SHAPES:
        a = torch.complex(rnd(nb, n, n), rnd(nb, n, n)) / math.sqrt(2 * n)
        current = gj_launcher(gj, a)
        other = gj_launcher(gj_base, a) if gj_base else None
        ms, base = in_turns(current, other)
        dev_ms, dev_base = in_turns(current, other, graph_ms)
        bound = max(2 * a.numel() * 8 / PEAK_BYTES, 8.0 * n**3 * nb / PEAK_FP32)
        print(json.dumps({"kernel": "gj_inverse_slogdet", "shape": [nb, n, n],
                          "body": dk.variant(gj, n, dev), "ms": ms,
                          "same_bits": same_bits(current, other),
                          "baseline_ms": base, "graph_ms": dev_ms,
                          "baseline_graph_ms": dev_base, "bound_ms": bound * 1e3,
                          "wrapper_ms": time_ms(lambda: dk.gj_inverse_slogdet(a))}),
              flush=True)
        del a

    for nb, n in GJ_SHAPES_C128:
        a = (torch.complex(rnd(nb, n, n), rnd(nb, n, n)) / math.sqrt(2 * n)).to(
            torch.complex128)
        current = gj_launcher(gj, a)
        other = gj_launcher(gj_base, a) if gj_base else None
        ms, base = in_turns(current, other)
        dev_ms, dev_base = in_turns(current, other, graph_ms)
        nbytes, flops = 2 * a.numel() * 16, 8.0 * n**3 * nb
        print(json.dumps({"kernel": "gj_inverse_slogdet", "shape": [nb, n, n],
                          "dtype": "complex128", "body": dk.variant_c128(gj, n, dev),
                          "ms": ms, "same_bits": same_bits(current, other),
                          "baseline_ms": base, "graph_ms": dev_ms,
                          "baseline_graph_ms": dev_base,
                          "bound_ms": max(nbytes / PEAK_BYTES, flops / PEAK_FP64_TENSOR) * 1e3,
                          "bound_ms_fp64_fma":
                              max(nbytes / PEAK_BYTES, flops / PEAK_FP64_FMA) * 1e3,
                          "wrapper_ms": time_ms(lambda: dk.gj_inverse_slogdet(a))}),
              flush=True)
        del a

    for t_dim, rows, d_in, d_out, mixed, open_sum, walkers in JET_SHAPES:
        val, jac, lap = rnd(rows, d_in), rnd(t_dim, rows, d_in), rnd(rows, d_in)
        w, b = rnd(d_in, d_out) / math.sqrt(d_in), rnd(d_out)
        mix = ((rnd(walkers, d_out), rnd(walkers, d_out), rnd(t_dim, walkers, d_out))
               if mixed else None)
        chosen = jk.kernel_variant(t_dim, rows, d_in, d_out, mixed, sms)
        wide = chosen > 0

        def launcher(lib, slices):
            return jet_launcher(lib, slices, val, jac, lap, w, b, mix, open_sum)

        base_slices = ((args.baseline_slices or chosen) if wide
                       else chosen if args.baseline_pair else 0)
        current = launcher(jet, chosen)
        other = launcher(jet_base, base_slices) if jet_base else None
        ms, base = in_turns(current, other)
        nbytes = 4 * ((t_dim + 2) * rows * (d_in + d_out) + d_in * d_out + d_out
                      + (rows * d_out if open_sum else 0))
        print(json.dumps({
            "kernel": "dense_tanh_jet", "T": t_dim, "rows": rows, "d_in": d_in,
            "d_out": d_out, "mix": mixed, "open": open_sum, "slices": chosen,
            "ms": ms, "baseline_slices": base_slices if jet_base else None,
            "same_bits": same_bits(current, other),
            "baseline_ms": base,
            "ms_by_slices": {s: time_ms(launcher(jet, s)) for s in sweep} if wide else {},
            "bytes_bound_ms": nbytes / PEAK_BYTES * 1e3,
            "matmul_ms": time_ms(lambda: torch.matmul(jac, w))}), flush=True)
        del val, jac, lap, mix

    def rnd64(*shape):
        return rnd(*shape).double()

    for t_dim, rows, d_in, d_out, mixed, open_sum, walkers in JET_SHAPES_F64:
        val, jac, lap = rnd64(rows, d_in), rnd64(t_dim, rows, d_in), rnd64(rows, d_in)
        w, b = rnd64(d_in, d_out) / math.sqrt(d_in), rnd64(d_out)
        mix = ((rnd64(walkers, d_out), rnd64(walkers, d_out),
                rnd64(t_dim, walkers, d_out)) if mixed else None)
        chosen = jk.kernel_variant(t_dim, rows, d_in, d_out, mixed, sms, torch.float64)
        slices = 0 if chosen == jk.FLOAT64 else chosen  # the general body: 0
        current = jet_launcher(jet, slices, val, jac, lap, w, b, mix, open_sum)
        general = jet_launcher(jet, 0, val, jac, lap, w, b, mix, open_sum)
        ms, general_ms = in_turns(current, general)
        nbytes = 8 * ((t_dim + 2) * rows * (d_in + d_out) + d_in * d_out + d_out
                      + (rows * d_out if open_sum else 0))
        flops = 2.0 * (t_dim + 2) * rows * d_in * d_out
        print(json.dumps({
            "kernel": "dense_tanh_jet", "dtype": "float64", "T": t_dim, "rows": rows,
            "d_in": d_in, "d_out": d_out, "mix": mixed, "open": open_sum,
            "body": jk.variant_label(chosen, torch.float64), "ms": ms,
            "same_bits": same_bits(current, general), "general_ms": general_ms,
            "bound_ms": max(nbytes / PEAK_BYTES, flops / PEAK_FP64_TENSOR) * 1e3,
            "bound_ms_fp64_fma": max(nbytes / PEAK_BYTES, flops / PEAK_FP64_FMA) * 1e3,
            "matmul_ms": time_ms(lambda: torch.matmul(jac, w))}), flush=True)
        del val, jac, lap, mix, current, general
        torch.cuda.empty_cache()
    dethead_rows(dev, gen, args.baseline)


def dethead_launcher(lib, jr, jbc, ep_val, ep_jac3, orb_val0, a_inv, offset, splits):
    """The det head kernel's launch entry of jr's dtype, on outputs
    allocated once."""
    import torch

    from deepsolid_tpu_torch.ops.cuda import dethead_kernels as dh

    t_loc, batch, n, _ = jr.shape
    ndet = ep_val.shape[1]
    trb = torch.empty(t_loc, batch, ndet, dtype=ep_val.dtype, device=jr.device)
    l2 = torch.empty(splits, batch, ndet, dtype=ep_val.dtype, device=jr.device)
    entry = (lib.dethead_trace_launch_c128 if jr.dtype == torch.float64
             else lib.dethead_trace_launch)

    def run():
        code = entry(jr.data_ptr(), jbc.data_ptr(), ep_val.data_ptr(), ep_jac3.data_ptr(),
                     orb_val0.data_ptr(), a_inv.data_ptr(), trb.data_ptr(), l2.data_ptr(),
                     n, ndet, batch, t_loc, splits, offset, 0,
                     torch.cuda.current_stream().cuda_stream)
        build.check(lib, code, dh.KERNEL)
    run.outputs = (trb, l2)
    return run


def dethead_rows(dev, gen, baseline=None) -> None:
    """One JSON line per DETHEAD_SHAPES entry (the second spin channel, the
    row-constant block's tangents present, as on both systems' path); with
    a `baseline` directory, its dethead_trace.cu's launcher in turns
    beside this one's (`baseline_ms`) and its largest gap from this one's
    outputs (`baseline_max_rel_err`)."""
    import torch

    from deepsolid_tpu_torch.ops import fwdlap as fl
    from deepsolid_tpu_torch.ops.cuda import dethead_kernels as dh

    lib = dh._lib()
    base = (baseline_library(baseline, "dethead_trace", dh._SIGNATURES)
            if baseline and (baseline / "dethead_trace.cu").exists() else None)
    for walkers, ndet, n, t_dim, precision in DETHEAD_SHAPES:
        real = getattr(torch, precision)
        cplx = dh._COMPLEX[real]

        def rnd(*shape, dtype=real):
            return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

        two_p, offset = 2 * ndet * n, n
        eye = torch.eye(n, device=dev, dtype=real).repeat(1, ndet)
        val = torch.complex(eye + rnd(walkers, n, ndet * n) / n**0.5,
                            rnd(walkers, n, ndet * n) / n**0.5)
        val = val.unflatten(-1, (ndet, n)).transpose(1, 2)  # (B, D, n, n)
        lap = torch.complex(rnd(walkers, ndet, n, n), rnd(walkers, ndet, n, n))
        jr, jbc = rnd(t_dim, walkers, n, two_p) / n**0.5, rnd(t_dim, walkers, two_p) / n**0.5
        b_val = 1.0 + 0.1 * torch.complex(rnd(walkers, ndet, n, n), rnd(walkers, ndet, n, n))
        b_jac3 = torch.complex(rnd(3, walkers, ndet, n, n), rnd(3, walkers, ndet, n, n))
        b_lap = torch.complex(rnd(walkers, ndet, n, n), rnd(walkers, ndet, n, n))
        assert b_val.dtype == cplx
        a_inv = fl.det_factor(val * b_val)[0]
        matrices = walkers * ndet
        splits = dh.splits(t_dim)
        kernel = dethead_launcher(lib, jr, jbc, b_val, b_jac3, val, a_inv, offset, splits)
        unsplit = dethead_launcher(lib, jr, jbc, b_val, b_jac3, val, a_inv, offset, 1)
        other = (dethead_launcher(base, jr, jbc, b_val, b_jac3, val, a_inv, offset, splits)
                 if base else None)
        kernel_ms, unsplit_ms, base_ms = [], [], []
        for turn in range(2):  # in turns: (the baseline,) the split, one block a matrix
            if other and turn == 0:
                base_ms.append(time_ms(other))
            kernel_ms.append(time_ms(kernel))
            unsplit_ms.append(time_ms(unsplit))
            if other and turn == 1:
                base_ms.append(time_ms(other))
        first = tuple(x.clone() for x in kernel.outputs)
        kernel()
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(first, kernel.outputs))
        base_err = (max(float((x - y).abs().max() / y.abs().max())
                        for x, y in zip((first[0], first[1].sum(0)),
                                        (other.outputs[0], other.outputs[1].sum(0))))
                    if other else None)
        args = (jr, jbc, b_val, b_jac3, val, a_inv, offset, 0)
        got = dh.dethead_traces(*args)
        # the plain version and the composition hold ~5 copies of jr
        whole = 5 * jr.numel() * jr.element_size() < torch.cuda.mem_get_info(dev)[0]
        plain_ms = (time_ms(lambda: dh.dethead_traces_plain(*args), warmup=1, reps=3)
                    if whole else None)
        # the plain version on the walkers the card holds it for
        part = walkers if whole else min(walkers, 8)
        want = dh.dethead_traces_plain(jr[:, :part], jbc[:, :part], b_val[:part],
                                       b_jac3[:, :part], val[:part], a_inv[:part], offset, 0)
        err = max(float((x - y).abs().max() / y.abs().max())
                  for x, y in zip((got[0][:, :part], got[1][:part]), want))
        del want

        def composition():
            jac = jr + jbc[:, :, None, :]
            jc = torch.complex(jac[..., :ndet * n], jac[..., ndet * n:])
            orb = fl.Jet(val, jc.unflatten(-1, (ndet, n)).transpose(2, 3), lap)
            mat = fl.mul_row(orb, b_val, b_jac3, b_lap, n_total=2 * n, offset=offset)
            return fl.slogdet_jet(mat)

        def one_pass():
            return fl.det_head_jet(val, lap, b_val, b_jac3, b_lap, fl.sliced_window(jr, jbc),
                                   t_dim, offset=offset)

        comp_first = time_ms(composition, warmup=1, reps=5) if whole else None
        stage_ms = [time_ms(one_pass, warmup=1, reps=5), time_ms(one_pass, warmup=1, reps=5)]
        comp_ms = [comp_first, time_ms(composition, warmup=1, reps=5) if whole else None]
        f64 = real == torch.float64
        flops = 8.0 * n**3 * matrices * t_dim
        real_bytes = jr.element_size()
        nbytes = real_bytes * (jr.numel() + jbc.numel()) + 2 * real_bytes * (
            5 * matrices * n * n + t_dim * matrices + splits * matrices)
        print(json.dumps({
            "kernel": dh.KERNEL, "precision": precision, "matrices": matrices, "n": n,
            "T": t_dim, "splits": splits, "body": dh.body(n, real),
            "ms": kernel_ms, "unsplit_ms": unsplit_ms, **dh.occupancy(n, real),
            **({"baseline_ms": base_ms, "baseline_max_rel_err": base_err} if other else {}),
            "wrapper_ms": time_ms(lambda: dh.dethead_traces(*args)),
            "bound_ms": max(flops / (PEAK_FP64_TENSOR if f64 else PEAK_FP32),
                            nbytes / PEAK_BYTES) * 1e3,
            **({"bound_ms_fp64_fma": max(flops / PEAK_FP64_FMA, nbytes / PEAK_BYTES) * 1e3}
               if f64 else {}),
            "bytes_bound_ms": nbytes / PEAK_BYTES * 1e3, "plain_ms": plain_ms,
            "max_rel_err_vs_plain": err, "same_bits_two_launches": same,
            "stage_ms": stage_ms, "composition_stage_ms": comp_ms}), flush=True)
        del jr, jbc, val, lap, b_val, b_jac3, b_lap, a_inv, kernel, unsplit, other, got, first
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
