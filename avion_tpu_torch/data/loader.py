"""Host-to-device batch feeding (``avion_tpu.data.loader``'s
``echo_batches`` and ``device_prefetch``).  The datasets and the
multi-process ``DataLoader`` come with the data slice; any iterable of
dicts of numpy arrays (the ``VideoCaptionDataset`` collate contract:
``video`` uint8 [B, T, H, W, 3], ``text`` int [B, L]) feeds the loop.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterable, Iterator

import numpy as np
import torch


def echo_batches(it: Iterator[Any], factor: int) -> Iterator[Any]:
    """Data echoing (arXiv:1907.05550): yield each upstream batch
    ``factor`` times consecutively.  After :func:`device_prefetch` the
    repeats are the same device tensors: no extra decode, no extra copy."""
    if factor <= 1:
        yield from it
        return
    for b in it:
        for _ in range(factor):
            yield b


def _to_tensors(host: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            if isinstance(v, np.ndarray) else torch.as_tensor(v)
            for k, v in host.items()}


def device_prefetch(loader: Iterable[Dict[str, Any]], device,
                    depth: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Ship host batches to ``device`` ahead of consumption.

    On CUDA a daemon thread pins each batch, copies it with
    ``non_blocking=True`` on a side stream and records an event; the
    consumer's stream waits for that event (on the device, not the host)
    and ``record_stream`` tells the caching allocator the tensors are used
    on it, so their memory is not reused while the step still reads them.
    At most ``depth`` batches are in flight.  On the CPU the batches pass
    through as tensors."""
    device = torch.device(device)
    if device.type != "cuda":
        for host in loader:
            yield _to_tensors(host)
        return

    copy_stream = torch.cuda.Stream(device)
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            with torch.cuda.device(device), torch.cuda.stream(copy_stream):
                for host in loader:
                    batch = {k: v.pin_memory().to(device, non_blocking=True)
                             for k, v in _to_tensors(host).items()}
                    ready = torch.cuda.Event()
                    ready.record(copy_stream)
                    if not put((batch, ready, None)):
                        return
        except BaseException as e:  # re-raised in the consumer
            put((None, None, e))
            return
        put((end, None, None))

    t = threading.Thread(target=produce, daemon=True, name="device_prefetch")
    t.start()
    try:
        while True:
            batch, ready, err = q.get()
            if err is not None:
                raise err
            if batch is end:
                return
            stream = torch.cuda.current_stream(device)
            stream.wait_event(ready)
            for v in batch.values():
                v.record_stream(stream)
            yield batch
    finally:
        stop.set()
        t.join(timeout=10.0)
