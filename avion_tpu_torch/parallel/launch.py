"""Process bring-up (``avion_tpu.parallel.launch``): the process group, the
device an entry runs on, SIGTERM / SIGUSR1 preemption signals that set a
flag the train loop checks to checkpoint and stop (with auto-resume, the
submitit-style requeue of the reference), and the host's data seed.

One process drives one card.  :func:`init_distributed` joins the process
group that the launcher describes: torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), SLURM's
(``SLURM_PROCID``, ``SLURM_NTASKS``, ``SLURM_LOCALID`` with
``MASTER_ADDR`` / ``MASTER_PORT``), or an explicit ``AVION_COORDINATOR``
(``host:port``) with ``AVION_NUM_PROCESSES`` and ``AVION_PROCESS_ID``,
whose card is the process id modulo the visible cards.  Without any of them the entry runs as one process, with no group.  The
backend is NCCL on CUDA and gloo on the CPU; a group that cannot be
joined raises (no fallback to one process).

A signal may reach one rank only, so the flag is agreed on at a step
boundary (:func:`agree`, an all-reduce of the maximum): every rank then
checkpoints the same step and none waits alone in a collective.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import signal
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

_PREEMPTED = {"flag": False}


def resolve_device(name: str) -> torch.device:
    """``cuda`` / ``cuda:N`` / ``cpu``; a CUDA device without CUDA raises
    (the port never falls back to the CPU on its own)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda[:N] or cpu, got {name!r}")
    return device


def device_from_argv(argv) -> tuple:
    """(the arguments less ``--device <name>``, the resolved device):
    the entries' ``--device`` flag, CUDA by default."""
    argv, name = list(argv), "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit("usage: --device <cuda[:N]|cpu> (missing value)")
        name = argv[i + 1]
        del argv[i : i + 2]
    return argv, resolve_device(name)


def launcher_env() -> Optional[Tuple[str, int, int, Optional[int]]]:
    """(init address, world size, rank, local rank) from the launcher's
    environment, or None for a process that was launched alone.  The
    explicit coordinator names no local rank (None)."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:  # torchrun
        addr = (f"tcp://{env.get('MASTER_ADDR', 'localhost')}:"
                f"{env.get('MASTER_PORT', '29500')}")
        return (addr, int(env["WORLD_SIZE"]), int(env["RANK"]),
                int(env.get("LOCAL_RANK", 0)))
    if "AVION_COORDINATOR" in env:
        return (f"tcp://{env['AVION_COORDINATOR']}",
                int(env.get("AVION_NUM_PROCESSES", 1)),
                int(env.get("AVION_PROCESS_ID", 0)), None)
    if "SLURM_PROCID" in env and "MASTER_ADDR" in env:
        return (f"tcp://{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}",
                int(env.get("SLURM_NTASKS", 1)), int(env["SLURM_PROCID"]),
                int(env.get("SLURM_LOCALID", 0)))
    return None


def init_distributed(device: torch.device) -> Tuple[int, torch.device]:
    """Join the launcher's process group (NCCL for a CUDA ``device``, gloo
    for the CPU) and return (rank, this rank's device: ``cuda:LOCAL_RANK``
    for CUDA).  Without a launcher: (0, ``device``).  A group already
    joined is kept."""
    spec = launcher_env()
    if spec is None:
        if dist.is_initialized():
            return dist.get_rank(), device
        return 0, device
    addr, world, rank, local_rank = spec
    if device.type == "cuda":
        if local_rank is None:
            local_rank = rank % max(torch.cuda.device_count(), 1)
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local_rank} has no card: "
                               f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo", init_method=addr,
            world_size=world, rank=rank,
            timeout=datetime.timedelta(minutes=30))
    return dist.get_rank(), device


def seed_for_host(base_seed: int) -> int:
    """Per-rank data seed (the reference seeds per rank,
    ``distributed.py:9-12``); model init stays rank-independent."""
    return base_seed + (dist.get_rank() if dist.is_initialized() else 0)


def preempted() -> bool:
    return _PREEMPTED["flag"]


def agree(flag: bool) -> bool:
    """``flag`` on any rank of the world: an all-reduce of the maximum;
    the flag itself without a group."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return bool(flag)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def install_preemption_handler(signals=(signal.SIGTERM, signal.SIGUSR1)):
    def handler(signum, frame):
        print(f"[launch] received signal {signum}; will checkpoint and exit")
        _PREEMPTED["flag"] = True

    for s in signals:
        signal.signal(s, handler)


def setup_host(base_seed: int = 0,
               device: Optional[torch.device] = None) -> Tuple[int,
                                                                torch.device]:
    """Every entry's bring-up (``avion_tpu.parallel.launch.setup_host``):
    join the process group when launched by torchrun, SLURM or an explicit
    coordinator (:func:`init_distributed`), install the preemption handler
    and seed numpy's global generator with the rank's data seed
    (:func:`seed_for_host`).  Returns (rank, this rank's device)."""
    rank, device = init_distributed(device if device is not None
                                    else torch.device("cpu"))
    install_preemption_handler()
    np.random.seed(seed_for_host(base_seed) % (2 ** 31))
    return rank, device


@contextlib.contextmanager
def host(base_seed: int, device: torch.device):
    """:func:`setup_host` for the block, which gets this rank's device; a
    process group joined here is left when the block ends."""
    joined = not dist.is_initialized()
    _, device = setup_host(base_seed, device)
    joined = joined and dist.is_initialized()
    try:
        yield device
    finally:
        if joined:
            dist.destroy_process_group()


def is_main() -> bool:
    """Rank 0, or a process without a group: the one that logs and
    writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
