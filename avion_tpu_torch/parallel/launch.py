"""Process bring-up (``avion_tpu.parallel.launch``): the device an entry
runs on, SIGTERM / SIGUSR1 preemption signals that set a flag the train
loop checks to checkpoint and stop (with auto-resume, the submitit-style
requeue of the reference), and the host's data seed.  One process:
distributed initialization waits for the parallel slice."""

from __future__ import annotations

import signal

import numpy as np
import torch

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


def preempted() -> bool:
    return _PREEMPTED["flag"]


def install_preemption_handler(signals=(signal.SIGTERM, signal.SIGUSR1)):
    def handler(signum, frame):
        print(f"[launch] received signal {signum}; will checkpoint and exit")
        _PREEMPTED["flag"] = True

    for s in signals:
        signal.signal(s, handler)


def setup_host(base_seed: int = 0) -> int:
    """The one-process part of the JAX package's ``setup_host``: install
    the preemption handler and seed numpy's global generator with the
    host's data seed (``base_seed`` + process index 0).  Returns the
    process index, 0."""
    install_preemption_handler()
    np.random.seed(base_seed % (2 ** 31))
    return 0
