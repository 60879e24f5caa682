"""Preemption signals (``avion_tpu.parallel.launch``): SIGTERM / SIGUSR1
set a flag that the train loop checks to checkpoint and stop; with
auto-resume this is the submitit-style requeue of the reference.
Distributed initialization waits for the parallel slice."""

from __future__ import annotations

import signal

_PREEMPTED = {"flag": False}


def preempted() -> bool:
    return _PREEMPTED["flag"]


def install_preemption_handler(signals=(signal.SIGTERM, signal.SIGUSR1)):
    def handler(signum, frame):
        print(f"[launch] received signal {signum}; will checkpoint and exit")
        _PREEMPTED["flag"] = True

    for s in signals:
        signal.signal(s, handler)
