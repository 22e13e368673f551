"""The det head kernel's launches in the profiled iterations, reckoned
from the run record alone, and the operations and bytes of one launch.

The harness snapshots no counter of this kernel, so its launches are
reckoned: each E_L pass runs ceil(batch / el_chunk) chunks (one chunk of
the batch where el_chunk is 0), and each chunk launches the kernel once
per occupied spin channel on (chunk walkers x determinants, n_s, 3 N):
one launch of each channel's matrices of that chunk, over every tangent.
A profiled iteration runs one E_L pass, and one more where it adapted
KFAC's damping. Where the kernel does not serve a shape (the composition
runs instead), the trace holds none of its time and the metric reads
nothing."""

from __future__ import annotations

from collections import Counter

from portbench import spec


def traced_iterations(run):
    """The iterations profiled after the window."""
    first = run["traffic"]["warmup_iterations"] + len(run["window_iterations"])
    return run["iterations"][first:]


def launches(run) -> Counter:
    """{(matrices, n_s, T): launches} over the profiled iterations."""
    conf, traffic = run["config"], run["traffic"]
    n = spec.nelectron(conf)
    ndet = conf["network"]["determinants"]
    batch = traffic["batch_size"]
    chunk = traffic["el_chunk"] or batch
    chunks = [chunk] * (batch // chunk) + ([batch % chunk] if batch % chunk else [])
    passes = sum(1 + bool(it["adapted"]) for it in traced_iterations(run))
    out = Counter()
    for n_s in (n // 2, n - n // 2):
        if n_s:
            for walkers in chunks:
                out[walkers * ndet, n_s, 3 * n] += passes
    return out


def launch(matrices: int, n: int, t: int, real_bytes: int):
    """(bytes, flops) of one launch on `matrices` n x n matrices and t
    tangents: jr (t x matrices x n x 2n reals) and the row-constant block's
    tangents (t x matrices x 2n) read once, A^-1, the envelope-phase value,
    the orbitals' value and the three envelope-phase gradients read once
    (6 complex n x n a matrix), trb (t complex a matrix) and l2 written
    once; M_t = A^-1 J_t is n^3 complex multiply-adds a matrix and
    tangent."""
    item = 2 * real_bytes
    nbytes = (real_bytes * t * matrices * (2 * n * n + 2 * n)
              + item * matrices * (6 * n * n + t + 1))
    return nbytes, 8.0 * n**3 * matrices * t
