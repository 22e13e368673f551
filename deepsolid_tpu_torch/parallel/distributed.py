"""Joining a world of ranks: one host or several.

Counterpart of deepsolid_tpu/parallel/distributed.py. The JAX package
joins its processes with `jax.distributed.initialize()` and then shards
walkers over every device of the job; here each rank is one process on
one card, and `initialize` joins the torch.distributed world that
`process()` then lays its (data, deriv) mesh over (parallel/mesh.py):

    from deepsolid_tpu_torch.parallel import distributed
    distributed.initialize()       # under torchrun; one process: no-op
    process.process(cfg)           # the mesh spans every rank of the job

A world is joined when it is asked for, explicitly (a coordinator
address, the number of processes and this process's id, as JAX's
arguments) or by a launcher's environment (`torchrun` sets RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK, LOCAL_WORLD_SIZE).
Without either it does nothing: one process. A bootstrap that was asked
for and fails raises; it never carries on as one process.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from deepsolid_tpu_torch.device import rank_device, resolve_device

# torchrun's variables that make a launcher's environment
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
DEFAULT_TIMEOUT = 1800.0  # seconds: torch.distributed's own default
# the one line a rank logs when it has joined; scripts parse it
JOINED = "joined: rank=%d world=%d local_rank=%d backend=%s device=%s"
JOINED_PATTERN = (r"joined: rank=(?P<rank>\d+) world=(?P<world>\d+) "
                  r"local_rank=(?P<local_rank>\d+) backend=(?P<backend>\w+) "
                  r"device=(?P<device>\S+)")


def choose_backend(device_type: str, local_world_size: int, device_count: int) -> str:
    """'nccl' where the ranks run on CUDA and every rank of a host owns a
    card of its own; 'gloo' on the CPU and where ranks share a card (NCCL
    refuses two ranks on one device)."""
    if device_type == "cuda" and 0 < local_world_size <= device_count:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_rank: Optional[int] = None,
               local_world_size: Optional[int] = None,
               device="cuda",
               timeout: float = DEFAULT_TIMEOUT) -> None:
    """Join the torch.distributed world this process is asked to join.

    Explicit arguments join `tcp://coordinator_address` (host:port, served
    by process 0) as rank `process_id` of `num_processes`. Without them, a
    launcher's environment (torchrun's) joins through `env://`. Without
    either, or when a world is already joined, nothing happens.

    Ranks fill each host's cards in turn: `local_rank` defaults to
    LOCAL_RANK, else `process_id % device_count`, and `local_world_size`
    (the ranks on this host) to LOCAL_WORLD_SIZE, else the smaller of the
    world and the host's cards. Ranks that share a card (more on a host
    than it has cards) say so with `local_world_size`, and get gloo. The
    rank joins through `join`. A bootstrap that fails within `timeout`
    seconds raises RuntimeError naming the request.
    """
    explicit = coordinator_address is not None or num_processes is not None
    launched = all(key in os.environ for key in LAUNCHER_ENV)
    if dist.is_initialized():
        logging.info("torch.distributed already initialized; skipping")
        return
    if not (explicit or launched):
        return
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("an explicit bootstrap needs coordinator_address, "
                             "num_processes and process_id")
        rank, world = int(process_id), int(num_processes)
        init_method = f"tcp://{coordinator_address}"
        request = (f"coordinator_address={coordinator_address!r}, "
                   f"num_processes={num_processes!r}, process_id={process_id!r}")
    else:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = "env://"
        request = "the launcher's environment (" + ", ".join(
            f"{key}={os.environ[key]}" for key in LAUNCHER_ENV) + ")"
    if local_rank is None:
        local_rank = os.environ.get("LOCAL_RANK")
    if local_world_size is None:
        local_world_size = os.environ.get("LOCAL_WORLD_SIZE")
    join(init_method, rank, world, local_rank, local_world_size, device,
         timeout=timeout, request=request)


def join(init_method: str, rank: int, world: int,
         local_rank: Optional[int] = None,
         local_world_size: Optional[int] = None,
         device="cuda", backend: Optional[str] = None,
         timeout: Optional[float] = DEFAULT_TIMEOUT,
         request: Optional[str] = None) -> None:
    """Join `init_method`'s world as `rank` of `world` on this rank's card.

    On CUDA the rank first makes its card current, `rank_device(local_rank,
    device_count)` (`local_rank` defaults to `rank % device_count`). The
    backend, unless given, is `choose_backend`'s for `local_world_size`
    ranks on this host (default: the smaller of `world` and the host's
    cards). NCCL is bound to the card (`device_id`): without it the
    communicator and `barrier()` guess the card from the global rank,
    which is wrong on a second host. `initialize` and the ranks of
    `parallel.run_ranks` both join here. A join that fails within
    `timeout` seconds (None: no limit) raises RuntimeError naming
    `request` (default: `init_method`).
    """
    device = torch.device(device)
    card = None
    if device.type == "cuda":
        resolve_device(device)  # raises without a GPU
        count = torch.cuda.device_count()
        local_rank = rank % count if local_rank is None else int(local_rank)
        card = rank_device(local_rank, count)
        torch.cuda.set_device(card)
        local_world = min(world, count) if local_world_size is None else int(local_world_size)
        backend = backend or choose_backend("cuda", local_world, count)
    else:
        local_rank = rank if local_rank is None else int(local_rank)
        backend = backend or choose_backend(device.type, world, 0)
    try:
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=None if timeout is None else datetime.timedelta(seconds=timeout),
            device_id=card if backend == "nccl" else None)
    except (RuntimeError, ValueError) as e:  # DistNetworkError, DistStoreError
        raise RuntimeError(
            f"a multi-process bootstrap was requested ({request or init_method}) "
            f"but torch.distributed.init_process_group({backend!r}) failed: {e}") from e
    logging.info(JOINED, rank, world, local_rank, backend,
                 device if card is None else card)
