"""Parallel data loading and host-to-device feeding
(``avion_tpu.data.loader``).

``DataLoader`` runs the dataset's decoding ``__getitem__`` in a
forkserver worker pool; each worker collates a whole batch and hands it
back through POSIX shared memory (or the pool's pickle pipe).  The
forkserver starts when the first loader with workers is made, and imports
the main module once for every worker (``forkserver_preload``).
``device_prefetch`` ships batches to the card ahead of the step and
``echo_batches`` repeats them (data echoing).  Over a mesh the loader
shards the index order across the ``process_count`` batch groups (the
``data x fsdp`` index, ``parallel.mesh.Mesh.batch_index``; the ``sp`` ranks
of a group read the same clips): every group draws the same permutation,
pads or trims it to a multiple of the groups and takes every
``process_count``-th index from its own (``_host_order`` of the JAX
loader), and ``batch_size`` is the global batch.  ``torch`` is imported by
the functions that make tensors, so the workers, which import this module,
do not load it.
"""

from __future__ import annotations

import collections
import os
import queue
import sys
import threading
from concurrent.futures import ProcessPoolExecutor
from typing import TYPE_CHECKING, Any, Dict, Iterable, Iterator

import numpy as np

if TYPE_CHECKING:
    import torch

from avion_tpu_torch.data.datasets import collate

_WORKER_DATASET = None

# arrays at least this large travel via POSIX shared memory instead of the
# executor's pickle pipe (frame batches are 100s of MB; pickling them
# costs two extra copies, one of them in the main process)
_SHM_MIN_BYTES = 1 << 20
SHM_DIR = "/dev/shm"


def forkserver_preload(dataset=None) -> list:
    """The modules the forkserver imports once, before it forks workers:
    this process's main module by its importable name, and the dataset's
    module.

    CPython's forkserver means to import the parent's ``__main__`` there,
    but it asks ``spawn.get_preparation_data`` for a ``main_path`` key that
    the function names ``init_main_from_path`` (3.12), so it never does;
    every worker then runs the main module afresh, ``import torch`` and all,
    before its first item (seconds a loader, on each of its workers at
    once).  With the module imported in the forkserver, a worker's run of
    it finds its imports done.  A ``python -m pkg.mod`` main is ``pkg.mod``;
    a script is its file's stem, found on the forkserver's ``sys.path``,
    which starts at the script's directory; a ``__main__`` module (``python
    -m pytest``) is not run by the workers and is left out."""
    main = sys.modules.get("__main__")
    spec = getattr(main, "__spec__", None)
    path = getattr(main, "__file__", None)
    if spec is not None:
        names = [] if spec.name.rpartition(".")[2] == "__main__" \
            else [spec.name]
    elif path:
        names = [os.path.splitext(os.path.basename(path))[0]]
    else:
        names = []
    mod = type(dataset).__module__ if dataset is not None else None
    if mod and mod not in ("__main__", "builtins") and mod not in names:
        names.append(mod)
    return names


def start_forkserver(dataset=None) -> None:
    """Start this process's forkserver now, with :func:`forkserver_preload`'s
    modules, so that its imports overlap what the caller does before its
    first batch (a model's build, the card's start).  Once the forkserver
    runs, a later call changes nothing."""
    import multiprocessing as mp
    from multiprocessing import forkserver

    mp.get_context("forkserver").set_forkserver_preload(
        forkserver_preload(dataset))
    forkserver.ensure_running()


def _worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_fetch(indices):
    return collate([_WORKER_DATASET[int(i)] for i in indices])


def shm_free_bytes() -> int:
    """Free bytes of the shared-memory file system (0 when there is
    none)."""
    try:
        st = os.statvfs(SHM_DIR)
    except OSError:
        return 0
    return st.f_bavail * st.f_frsize


def _shm_export(batch):
    """Move large arrays of a collated batch into shared-memory segments;
    returns a descriptor dict safe to pickle.  A field whose segment does
    not fit in the free ``/dev/shm`` stays a plain array (pickled): a
    segment is only truncated to size, so writing past the free space
    would kill the worker with SIGBUS.  The pages are reserved with
    ``posix_fallocate`` before the copy, which also covers workers that
    check the free space at the same time."""
    from multiprocessing import resource_tracker, shared_memory

    out = {}
    for k, v in batch.items():
        if not (isinstance(v, np.ndarray) and v.nbytes >= _SHM_MIN_BYTES) \
                or v.nbytes > shm_free_bytes():
            out[k] = v
            continue
        try:
            shm = shared_memory.SharedMemory(create=True, size=v.nbytes)
        except OSError:
            out[k] = v
            continue
        try:
            os.posix_fallocate(shm._fd, 0, v.nbytes)
        except OSError:
            shm.close()
            shm.unlink()
            out[k] = v
            continue
        np.ndarray(v.shape, v.dtype, buffer=shm.buf)[...] = v
        # the main process owns the segment's lifetime (it unlinks on
        # attach): this worker's resource_tracker must not unlink it
        resource_tracker.unregister(shm._name, "shared_memory")
        out[k] = ("__shm__", shm.name, v.shape, str(v.dtype))
        shm.close()
    return out


def _worker_fetch_shm(indices):
    return _shm_export(_worker_fetch(indices))


def _is_shm(v) -> bool:
    return isinstance(v, tuple) and len(v) == 4 and v[0] == "__shm__"


def _shm_attach(batch):
    """Rebuild arrays from shm descriptors without a copy.  The segment is
    unlinked at once (it lives while mapped, so a crash leaks no
    ``/dev/shm`` entry) and unmapped when the array is collected."""
    import weakref
    from multiprocessing import shared_memory

    out = {}
    for k, v in batch.items():
        if not _is_shm(v):
            out[k] = v
            continue
        shm = shared_memory.SharedMemory(name=v[1])
        arr = np.ndarray(v[2], np.dtype(v[3]), buffer=shm.buf)
        try:
            shm.unlink()
        except FileNotFoundError:
            pass
        weakref.finalize(arr, shm.close)
        out[k] = arr
    return out


class DataLoader:
    """Map-style loader: shuffling sampler, worker pool, prefetch queue.

    ``num_workers=0`` loads synchronously in this process; otherwise a
    forkserver process pool decodes up to ``prefetch_depth`` batches ahead,
    one batch per task.  ``transfers`` counts, over the loader's life, the
    large fields (at least 1 MiB) that came back from a worker through
    shared memory (``shm``) and through the pickle pipe (``pickle``).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 4,
        prefetch_depth: int = 4,
        seed: int = 0,
        epoch: int = 0,
        infinite: bool = False,
        skip_batches: int = 0,
        use_shm: bool = True,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.process_index = process_index
        self.process_count = process_count
        # a training loader shards; an eval loader (no shuffle) does not
        self.shard_across_hosts = shuffle and process_count > 1
        if self.shard_across_hosts and batch_size % process_count:
            raise ValueError(f"batch {batch_size} does not divide by "
                             f"{process_count} batch groups")
        self.dataset = dataset
        self.batch_size = batch_size  # global
        self.local_batch = (batch_size // process_count
                            if self.shard_across_hosts else batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch_depth = max(1, prefetch_depth)
        self.seed = seed
        self.epoch = epoch
        self.infinite = infinite
        # skip the first N batches of the first epoch (mid-epoch resume)
        self.skip_batches = skip_batches
        self.use_shm = use_shm
        self.transfers: collections.Counter = collections.Counter()
        self._pool = None
        if num_workers > 0:
            start_forkserver(dataset)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _order(self, epoch: int) -> np.ndarray:
        """This batch group's index order: the same seeded permutation on
        every group, padded (or with ``drop_last`` trimmed) to a multiple
        of the groups, every ``process_count``-th index from its own."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        if not self.shard_across_hosts:
            return order
        world = self.process_count
        if self.drop_last:
            order = order[:(n // world) * world]
        else:
            total = -(-n // world) * world
            order = np.concatenate([order, order[:total - n]])
        return order[self.process_index::world]

    def __len__(self):
        n = len(self.dataset)
        if self.shard_across_hosts:
            world = self.process_count
            n = n // world if self.drop_last else -(-n // world)
        b = self.local_batch
        return n // b if self.drop_last else -(-n // b)

    def _index_batches(self, epoch: int):
        order = self._order(epoch)
        n = len(order)
        b = self.local_batch
        stop = (n // b) * b if self.drop_last else n
        start = self.skip_batches * b if epoch == self.epoch else 0
        self.skip_batches = 0
        for i in range(start, stop, b):
            yield order[i : i + b]

    def _receive(self, batch):
        for v in batch.values():
            if _is_shm(v):
                self.transfers["shm"] += 1
            elif isinstance(v, np.ndarray) and v.nbytes >= _SHM_MIN_BYTES:
                self.transfers["pickle"] += 1
        return _shm_attach(batch) if self.use_shm else batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch = self.epoch
        while True:
            if self.num_workers <= 0:
                for idx in self._index_batches(epoch):
                    yield collate([self.dataset[int(i)] for i in idx])
            else:
                yield from self._pool_batches(epoch)
            if not self.infinite:
                return
            epoch += 1

    def _pool_batches(self, epoch: int):
        if self._pool is None:
            # forkserver: workers never inherit this process's threads
            # (CUDA, the prefetch thread); the dataset is pickled once
            # into each worker (the forkserver runs: ``__init__``)
            import multiprocessing as mp

            self._pool = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=mp.get_context("forkserver"),
                initializer=_worker_init,
                initargs=(self.dataset,),
            )
        fetch = _worker_fetch_shm if self.use_shm else _worker_fetch
        pending = collections.deque()
        gen = self._index_batches(epoch)
        try:
            for _ in range(self.prefetch_depth):
                idx = next(gen, None)
                if idx is None:
                    break
                pending.append(self._pool.submit(fetch, idx))
            while pending:
                batch = self._receive(pending.popleft().result())
                idx = next(gen, None)
                if idx is not None:
                    pending.append(self._pool.submit(fetch, idx))
                yield batch
        except GeneratorExit:
            # finished futures may hold shm segments that only this
            # process can reclaim (the workers unregistered them):
            # attach and drop them; a plain cancel() would leak /dev/shm
            for f in pending:
                if f.cancel():
                    continue
                try:
                    b = f.result(timeout=120)
                except Exception:  # noqa: BLE001 — dropping the batch anyway
                    continue
                if self.use_shm:
                    _shm_attach(b)
            raise

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None


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
    import torch

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
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        for host in loader:
            yield _to_tensors(host)
        return

    copy_stream = torch.cuda.Stream(device)
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    end = object()
    it = iter(loader)

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
                for host in it:
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
        if not t.is_alive() and hasattr(it, "close"):
            # the source's cleanup (DataLoader's shm reclamation) runs
            # now that no thread is executing it
            it.close()
