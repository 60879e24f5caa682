"""Run a function on every rank of a small gloo process group, for the
port's parallel tests.

:func:`run_ranks` starts ``world`` processes (``forkserver``: they fork
from a server that imported torch and the bodies' module once, never
JAX), each of which joins a gloo
group on a free localhost port with a collective timeout, calls ``fn(rank,
world, *args)`` and sends back its return value or its traceback.  The
parent waits at most ``timeout`` seconds (60 by default) for all of them
and kills whatever is left, so a deadlocked collective fails one test
instead of the suite; every child must exit 0.  ``fn`` must be a module-level function of a module
that does not import JAX (``tests/torch_parallel_workers.py``).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import socket
import time
import traceback

DEFAULT_TIMEOUT_S = 60


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _child(fn, rank, world, port, results, args, env):
    os.environ.update(env)
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, *args, timeout: float = DEFAULT_TIMEOUT_S,
              env=None) -> list:
    """``[fn(rank, world, *args) for rank in range(world)]``, each in its
    own process of one gloo group; raises if any rank fails or the group
    does not finish within ``timeout`` seconds."""
    ctx = mp.get_context("forkserver")
    # the server imports torch and the bodies once; each rank forks from it
    ctx.set_forkserver_preload(["torch", "torch_parallel_workers"])
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, rank, world, port, results, args,
                               dict(env or {})))
             for rank in range(world)]
    for p in procs:
        p.start()
    outs, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(outs) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(outs)} of {world} ranks "
                                   f"did not finish in {timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and len(outs) + len(errors) < world:
                    # a child died without reporting (killed, segfault)
                    time.sleep(0.5)
                    if results.empty():
                        raise RuntimeError(
                            f"a rank exited with {dead[0].exitcode}")
                continue
            (outs.__setitem__(rank, out) if ok
             else errors.append(f"rank {rank}:\n{out}"))
        if errors:
            raise RuntimeError("\n".join(errors))
        for p in procs:
            p.join(max(0.1, deadline - time.monotonic()))
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise RuntimeError(f"ranks exited with {codes}")
        return [outs[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)

