"""Profiling hooks on torch.profiler.

Mirrors deepsolid_tpu/utils/profiling.py: `trace()` records the enclosed
span, `annotate()` is the program's named span, and `StepTracer` records
a window of training iterations (`log.trace_path`, `log.trace_start`,
`log.trace_steps` in train/process.py). A trace records the host's
operators and, on a GPU, the card's kernels (CUDA activity), and is
written as a Chrome trace JSON file (chrome://tracing, Perfetto) into the
trace directory.

The program opens `annotate` spans at its layer boundaries, each named
`deepsolid.<layer>.<stage>`: `iteration` and its phases (`mcmc`,
`local_energy`, `gradient`, `stats`, `checkpoint`) in train/process.py,
`kfac.*` in optim/kfac.py, `mcmc.*` in sampling/mcmc.py, `el.chunk`,
`psi.chunk` and `gradient.chunk` in train/loss.py, `el.kinetic` and
`el.ewald` in hamiltonian.py, `el.trunk`, `el.orbitals` and `el.det_head`
in models/fwdlap_forward.py, and `op.<kernel>` around each call of a CUDA
kernel's wrapper in ops/cuda. Spans nest, so a kernel launched under
`el.det_head` lies under `el.chunk` and `local_energy` too.

Usage:
    from deepsolid_tpu_torch.utils import profiling
    with profiling.trace("/tmp/traces"):
        for _ in range(10):
            step(...)
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator

import torch


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _start(logdir: str):
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    prof.__enter__()
    return prof


def _stop(prof, logdir: str) -> str:
    """Ends the profile and writes its trace into logdir; returns the file."""
    prof.__exit__(None, None, None)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logging.info("Profiler trace written to %s", path)
    return path


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Record a host and device trace of the enclosed span into logdir."""
    prof = _start(logdir)
    try:
        yield
    finally:
        _stop(prof, logdir)


SPAN_PREFIX = "deepsolid."
# whether a profiler records: torch's own global check, far cheaper than
# entering and leaving an idle record_function
_recording = torch._C._autograd._profiler_enabled
_IDLE = contextlib.nullcontext()


def annotate(name: str, args=None):
    """The program's span `deepsolid.<name>` (a context manager).

    While a profiler records, a torch.profiler.record_function, which the
    profiler times on its own host clock beside the device events it
    traces; `args` (a step, a chunk's index) is its argument string.
    Otherwise a shared no-op context, so an untraced run pays one check a
    span. A span synchronizes nothing and holds no tensor.
    """
    if not _recording():
        return _IDLE
    return torch.profiler.record_function(
        SPAN_PREFIX + name, None if args is None else str(args))


class StepTracer:
    """A window of iterations traced from inside a training loop.

    Call `step(i)` once per iteration with the loop-relative index: the
    trace starts at iteration `start` (past the warm-up) and stops when
    iteration `start + steps` begins, so it holds iterations [start,
    start + steps). `close()` ends an open window and may always be
    called. Nothing is recorded when `logdir` is empty.
    """

    def __init__(self, logdir: str, start: int = 10, steps: int = 5):
        self.logdir = logdir
        self.start = start
        self.stop = start + steps
        self.path = None  # the last trace file written
        self._prof = None

    def step(self, i: int) -> None:
        if not self.logdir:
            return
        if i == self.start and self._prof is None:
            self._prof = _start(self.logdir)
        elif i >= self.stop and self._prof is not None:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            self.path = _stop(prof, self.logdir)
