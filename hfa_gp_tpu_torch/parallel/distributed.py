"""Several processes, one rank each (port of hfa_gp_tpu/parallel/
distributed.py).

    torchrun --nproc_per_node 4 -m hfa_gp_tpu_torch.cli.train_arcface \
        --device cpu --n_model 2 --batch_size 8 --num_classes 64 ...

Precedence, as in the JAX package: the `--coordinator_address`,
`--num_processes` and `--process_id` flags; else the reference's
`WORLD_SIZE`/`RANK`/`MASTER_ADDR`/`MASTER_PORT` (what `torchrun` sets);
else one process and nothing to do.

The device of a rank: `cuda:LOCAL_RANK` where each local rank has a card
of its own, otherwise the card they share (`cuda:LOCAL_RANK % cards`), or
the CPU. The backend follows it: gloo on the CPU and where ranks share a
card (NCCL refuses two ranks of one communicator on one device), nccl
where each rank has a card of its own. The nccl route is written and
unverified: the port has been run on one card only.

`init_process_group` takes `TIMEOUT`, so that the ranks of a group in
which one rank died fail in a collective instead of waiting for ever.
"""

from __future__ import annotations

import argparse
import datetime
import os

import torch
import torch.distributed as dist

# how long a rank waits at the rendezvous and in a collective
TIMEOUT = datetime.timedelta(minutes=10)


def add_distributed_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0 (the reference's "
                        "MASTER_ADDR:MASTER_PORT)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="total process count (the reference's WORLD_SIZE)")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank (the reference's RANK)")


def _config(args) -> tuple[str | None, int | None, int | None]:
    """(coordinator, world size, rank) from the flags, else the
    environment; the coordinator is None for one process."""
    coord = getattr(args, "coordinator_address", None)
    nproc = getattr(args, "num_processes", None)
    pid = getattr(args, "process_id", None)
    if coord is None and "WORLD_SIZE" in os.environ:
        nproc = int(os.environ["WORLD_SIZE"])
        pid = int(os.environ.get("RANK", 0))
        coord = (os.environ.get("MASTER_ADDR", "127.0.0.1") + ":"
                 + os.environ.get("MASTER_PORT", "12345"))
    if coord is None or (nproc is not None and nproc <= 1):
        return None, 1, 0
    if nproc is None or pid is None:
        raise ValueError("--coordinator_address needs --num_processes and "
                         "--process_id")
    return coord, nproc, pid


def _local(args) -> tuple[int, int]:
    """(local rank, local world size): torchrun's LOCAL_RANK and
    LOCAL_WORLD_SIZE, else every rank on this host."""
    _, nproc, pid = _config(args)
    return (int(os.environ.get("LOCAL_RANK", pid)),
            int(os.environ.get("LOCAL_WORLD_SIZE", nproc)))


def own_cards(args) -> bool:
    """Whether every local rank has a CUDA card of its own."""
    return torch.cuda.device_count() >= _local(args)[1]


def rank_device(device: torch.device, args=None) -> torch.device:
    """The device of this rank for a requested `--device`: a CUDA request
    names the rank's card (its own, or the one it shares); the CPU stays
    the CPU."""
    if device.type != "cuda" or device.index is not None:
        return device
    local, _ = _local(args)
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def backend_for(device: torch.device, args=None) -> str:
    """nccl where each local rank has a card of its own (written,
    unverified), gloo otherwise."""
    return "nccl" if device.type == "cuda" and own_cards(args) else "gloo"


def maybe_initialize(args=None, device: torch.device | str = "cpu") -> bool:
    """Join the process group when several processes are configured;
    returns True when running over several processes. `device` is the
    rank's device (`rank_device`), which picks the backend."""
    coord, nproc, pid = _config(args)
    if coord is None:
        return False
    if dist.is_initialized():
        return True
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(device, args),
                            init_method=f"tcp://{coord}", world_size=nproc,
                            rank=pid, timeout=TIMEOUT)
    return True


def world() -> tuple[int, int]:
    """(rank, world size); (0, 1) outside a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    """True on the rank that writes logs, checkpoints and images (the
    reference's `rank == 0` gates)."""
    return world()[0] == 0


def backend() -> str | None:
    return dist.get_backend() if dist.is_initialized() else None
