"""Ranks, the (data, deriv) mesh and the tangent shard.

Counterpart of deepsolid_tpu/parallel/mesh.py and distributed.py, SPMD by
process as torch.distributed does it: every rank runs the same program on
its own walkers (data axis) or on its own slice of the 3N tangent columns
of the forward-Laplacian jets (deriv axis). The world is laid out as the
JAX package's mesh is, rank = data_index * deriv_devices + deriv_index,
with one process group per data index for the tangent reductions.

`None` stands for "unsharded" wherever a `TangentShard` or a `Mesh` is
accepted, as `deriv_axis=None` does in the JAX package; nothing here is
needed for a single-process run.

The backend is the caller's choice: NCCL where every rank owns a GPU,
gloo on the CPU and where several ranks share one GPU (NCCL refuses two
ranks on one device). With gloo, CUDA tensors are reduced through the
host: only small tensors are ever reduced (the tangent square sums, the
cross terms and per-walker scalars), never the tangent stream.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist


def _reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of `t` over the ranks of `group`, as a new tensor."""
    staged = dist.get_backend(group) == "gloo" and t.device.type != "cpu"
    buf = t.detach().cpu() if staged else t.detach().clone()
    buf = buf.contiguous()
    # complex tensors reduce as their (re, im) pairs
    view = torch.view_as_real(buf) if buf.is_complex() else buf
    dist.all_reduce(view, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device) if staged else buf


@dataclasses.dataclass(frozen=True)
class TangentShard:
    """This rank's place on the deriv axis: it holds tangents
    [t0, t0 + T_local) of every dense jet."""

    index: int
    size: int
    group: Any = None  # torch.distributed group of the axis' ranks

    def t0(self, t_loc: int) -> int:
        return self.index * t_loc

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the deriv ranks (psum over the 'deriv' axis)."""
        if self.size == 1:
            return t
        return _reduce_sum(t, self.group)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (data, deriv) layout of the world and this rank's place in it."""

    rank: int = 0
    world_size: int = 1
    deriv_devices: int = 1
    shard: Optional[TangentShard] = None

    @property
    def num_data(self) -> int:
        return self.world_size // self.deriv_devices

    @property
    def data_index(self) -> int:
        return self.rank // self.deriv_devices

    @property
    def deriv_index(self) -> int:
        return self.rank % self.deriv_devices

    def all_mean(self, t: torch.Tensor) -> torch.Tensor:
        """Mean over the data axis. The deriv ranks of one data index hold
        equal values, so the mean over the whole world is the same."""
        if self.world_size == 1:
            return t
        return _reduce_sum(t, dist.group.WORLD) / self.world_size

    def broadcast_int(self, value: int) -> int:
        """Rank 0's value on every rank."""
        if self.world_size == 1:
            return value
        buf = torch.tensor([value], dtype=torch.int64)
        if dist.get_backend() != "gloo":
            buf = buf.cuda()
        dist.broadcast(buf, src=0)
        return int(buf.item())

    def gather_data(self, data: torch.Tensor) -> torch.Tensor:
        """The global walker batch (data axis concatenated) on the host."""
        if self.num_data == 1:
            return data.detach().cpu()
        staged = dist.get_backend() == "gloo"
        local = data.detach().cpu() if staged else data.detach()
        parts = [torch.empty_like(local) for _ in range(self.world_size)]
        dist.all_gather(parts, local.contiguous())
        return torch.cat(parts[::self.deriv_devices]).cpu()


def make_mesh(deriv_devices: int = 1) -> Mesh:
    """The mesh of the initialized process group (one process when
    torch.distributed is not initialized). Every rank must call this: it
    creates one group per data index, in the same order everywhere."""
    deriv_devices = max(1, int(deriv_devices))
    if not (dist.is_available() and dist.is_initialized()):
        if deriv_devices > 1:
            raise ValueError(
                f"parallel.deriv_devices={deriv_devices} needs "
                "torch.distributed initialized with that many ranks or a "
                "multiple of it (see deepsolid_tpu_torch.parallel.run_ranks)")
        return Mesh()
    rank, world = dist.get_rank(), dist.get_world_size()
    if world % deriv_devices != 0:
        raise ValueError(
            f"parallel.deriv_devices={deriv_devices} must divide the "
            f"number of ranks ({world})")
    shard = None
    if deriv_devices > 1:
        for d in range(world // deriv_devices):
            ranks = list(range(d * deriv_devices, (d + 1) * deriv_devices))
            group = dist.new_group(ranks)
            if rank in ranks:
                shard = TangentShard(rank % deriv_devices, deriv_devices, group)
    return Mesh(rank, world, deriv_devices, shard)


# ---------------------------------------------------------------------------
# starting ranks on one host
# ---------------------------------------------------------------------------


def _rank_main(rank, world_size, backend, store, fn, args, results):
    try:
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world_size)
        try:
            results.put((rank, True, fn(rank, world_size, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world_size: int, args: Sequence = (),
              backend: str = "gloo", timeout: float = 600.0) -> list:
    """Run fn(rank, world_size, *args) in `world_size` spawned processes
    joined in one process group, and return their results by rank.

    `fn` must be importable (a module-level function) and its arguments
    and result picklable. The store is a file in a fresh temporary
    directory, so runs side by side need no free port. A rank that fails
    or outlives `timeout` seconds ends every rank and raises here.
    """
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world_size, backend, store, fn,
                                   tuple(args), results), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out, failure = {}, None
        try:
            deadline = time.monotonic() + timeout
            while len(out) < world_size and failure is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    failure = f"ranks did not finish within {timeout} s"
                    break
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [i for i, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and i not in out]
                    if dead:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode}")
                    continue
                if ok:
                    out[rank] = value
                else:
                    failure = f"rank {rank} failed:\n{value}"
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
        if failure is not None:
            raise RuntimeError(failure)
    return [out[r] for r in range(world_size)]
