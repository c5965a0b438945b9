"""Host-side data loading: sharding sampler + threaded prefetching loader.

Parity targets:
  - ``DistributedSampler`` (pretrain.py:250-254): pad-to-even, rank-strided
    sharding with per-epoch shuffling;
  - ``DataLoader`` batching + collate_fn + worker prefetch
    (pretrain.py:256-264).

TPU-first: the loader overlaps host-side collation with device compute via a
background thread pool and a bounded prefetch queue; batches are fixed-shape
numpy arrays ready for ``jax.device_put``. Per-host sharding composes with
the data-parallel mesh (parallel/mesh.py): each process loads only its slice
of the global batch.
"""

import multiprocessing
import os
import uuid
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from multiprocessing import shared_memory

import numpy as np

# process-worker state (set once per worker via the pool initializer so the
# dataset/collator aren't re-pickled for every batch)
_WORKER_DATASET = None
_WORKER_COLLATE = None
_WORKER_SHM = {}  # slot name -> attached SharedMemory (cached per worker)


def _worker_init(dataset, collate_fn):
    global _WORKER_DATASET, _WORKER_COLLATE
    # collation is numpy-only; if anything in the worker transitively
    # imports jax, keep it OFF the accelerator — spawned workers inherit
    # the parent's JAX_PLATFORMS and would otherwise each try to grab the
    # TPU client (measured: 8 spawned workers hung initialising the
    # remote chip that the training process already owns)
    import os
    os.environ["JAX_PLATFORMS"] = "cpu"
    _WORKER_DATASET = dataset
    _WORKER_COLLATE = collate_fn


def _worker_load(idx_batch):
    return _WORKER_COLLATE([_WORKER_DATASET[i] for i in idx_batch])


def _worker_attach_shm(name):
    shm = _WORKER_SHM.get(name)
    if shm is None:
        # python 3.12's SharedMemory registers ATTACHMENTS with the (shared)
        # resource tracker too; since the creating parent already registered
        # the name, the duplicate entry collapses in the tracker's set and a
        # later unregister would strip the parent's cleanup registration
        # (3.13 adds track=False for exactly this). Suppress the attach-side
        # registration instead — the parent owns segment lifetime end to end.
        from multiprocessing import resource_tracker
        orig_register = resource_tracker.register
        resource_tracker.register = lambda *a, **k: None
        try:
            shm = shared_memory.SharedMemory(name=name, create=False)
        finally:
            resource_tracker.register = orig_register
        _WORKER_SHM[name] = shm
    return shm


def _worker_load_shm(idx_batch, slot_name, slot_bytes):
    """Collate in the worker, ship dense arrays via a shared-memory slot.

    The pickle result pipe carries only per-array metadata (~100 bytes per
    key); the arrays themselves are memcpy'd into the slot the PARENT
    assigned to this task, so nothing large is serialised. Synchronisation
    is free: the parent only reads the slot after this future resolves
    (result-pipe happens-before), and only reassigns it after copying out.
    Batches that don't fit the slot (or aren't dicts) fall back to the
    inline pickled path."""
    batch = _WORKER_COLLATE([_WORKER_DATASET[i] for i in idx_batch])
    if not isinstance(batch, dict):
        return ("inline", batch)
    order, meta, other, total = [], [], {}, 0
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype != object:
            order.append((k, "shm"))
            a = np.ascontiguousarray(v)
            off = (total + 63) & ~63  # 64-byte align each array
            meta.append((k, a.dtype.str, a.shape, off))
            total = off + a.nbytes
        else:
            order.append((k, "other"))
            other[k] = v
    if total > slot_bytes:
        return ("inline", batch)
    shm = _worker_attach_shm(slot_name)
    for k, _, _, off in meta:
        a = np.ascontiguousarray(batch[k])
        dst = np.frombuffer(shm.buf, np.uint8, a.nbytes, off)
        dst[:] = a.reshape(-1).view(np.uint8)
    return ("shm", slot_name, order, meta, other)


class ShardedSampler:
    """Rank-strided sampler with epoch-seeded shuffling (DistributedSampler
    semantics: pad the index list so every rank gets the same count)."""

    def __init__(self, dataset_len, num_replicas=1, rank=0, shuffle=True,
                 seed=0):
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_samples = -(-dataset_len // num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        if self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            indices = g.permutation(self.dataset_len).tolist()
        else:
            indices = list(range(self.dataset_len))
        # pad to make evenly divisible
        indices += indices[: self.total_size - len(indices)]
        return iter(indices[self.rank:self.total_size:self.num_replicas])

    def __len__(self):
        return self.num_samples


class _ShmRing:
    """Fixed pool of shared-memory slots for worker->parent batch transport.

    The parent owns slot lifetime end to end: it creates the segments,
    assigns a free slot to each submitted task, reclaims the slot after
    copying the batch out, and unlinks everything on close. Workers only
    ever write a slot the parent handed them for one specific task, so no
    cross-process locking is needed — the executor's result pipe is the
    happens-before edge. Segments live in /dev/shm (tmpfs, lazily paged),
    so over-provisioned slot_bytes costs virtual space only."""

    def __init__(self, n_slots, slot_bytes):
        self.slot_bytes = slot_bytes
        tag = uuid.uuid4().hex[:8]
        self._shm = {}
        for i in range(n_slots):
            name = f"kmbart_{os.getpid()}_{tag}_{i}"
            self._shm[name] = shared_memory.SharedMemory(
                name=name, create=True, size=slot_bytes)
        self._free = list(self._shm)

    def acquire(self):
        return self._free.pop() if self._free else None

    def release(self, name):
        self._free.append(name)

    def read(self, name, order, meta, other):
        """Rebuild the batch dict (original key order) by copying each
        array out of the slot; the slot is reusable immediately after."""
        shm = self._shm[name]
        arrays = {}
        for k, dtype, shape, off in meta:
            n = int(np.prod(shape, dtype=np.int64))
            arrays[k] = np.frombuffer(
                shm.buf, np.dtype(dtype), n, off).reshape(shape).copy()
        return {k: arrays[k] if src == "shm" else other[k]
                for k, src in order}

    def close(self):
        for shm in self._shm.values():
            try:
                shm.close()
                shm.unlink()
            except Exception:
                pass
        self._shm = {}
        self._free = []


class DataLoader:
    """Minimal DataLoader: batches indices, collates with ``collate_fn``,
    prefetches ``prefetch`` batches with ``num_workers`` threads."""

    def __init__(self, dataset, batch_size, collate_fn, sampler=None,
                 shuffle=False, num_workers=0, drop_last=False, prefetch=2,
                 seed=0, batch_divisor=1, use_processes=False,
                 shm_transport=True, shm_bytes=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.sampler = sampler
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.prefetch = max(prefetch, 1)
        self.seed = seed
        self.batch_divisor = max(1, batch_divisor)
        self.use_processes = use_processes
        # dense batches travel via shared memory by default in process mode:
        # round-3 measured each ~56 MB batch pickled through the result pipe
        # costing 8x the single-thread throughput (BASELINE.md headroom
        # section); with shm only ~100 B/array of metadata crosses the pipe
        self.shm_transport = shm_transport and use_processes
        self.shm_bytes = shm_bytes or (128 << 20)
        self._shm_ring = None
        self._epoch = 0
        self._pool = None

    def set_epoch(self, epoch):
        self._epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def _index_batches(self):
        if self.sampler is not None:
            indices = list(self.sampler)
        elif self.shuffle:
            g = np.random.default_rng(self.seed + self._epoch)
            indices = g.permutation(len(self.dataset)).tolist()
        else:
            indices = list(range(len(self.dataset)))
        for i in range(0, len(indices), self.batch_size):
            chunk = indices[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk

    def _load(self, idx_batch):
        batch = self.collate_fn([self.dataset[i] for i in idx_batch])
        return self._trim_to_divisor(batch)

    def _trim_to_divisor(self, batch):
        """Keep the leading (batch) dim a multiple of ``batch_divisor`` —
        collators may drop None entries (ReasonDataset missing pickles), and
        a sharded pjit step needs divisibility by the data-mesh size.
        Returns None when fewer than one multiple remains (batch skipped)."""
        if self.batch_divisor == 1 or not isinstance(batch, dict):
            return batch
        sizes = [len(v) for v in batch.values()
                 if hasattr(v, "__len__") and not isinstance(v, str)]
        if not sizes:
            return batch
        n = min(sizes)
        m = (n // self.batch_divisor) * self.batch_divisor
        if m == 0:
            return None
        if m == n:
            return batch
        return {k: (v[:m] if hasattr(v, "__len__") and not isinstance(v, str)
                    else v) for k, v in batch.items()}

    def __len__(self):
        if self.sampler is not None:
            n = len(self.sampler)
        else:
            n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        if self.num_workers <= 0:
            for idx_batch in self._index_batches():
                batch = self._load(idx_batch)
                if batch is not None:
                    yield batch
            return

        # bounded look-ahead: at most num_workers + prefetch batches in flight.
        # Threads suffice for pickle/numpy-bound datasets; BPE tokenisation is
        # GIL-bound Python, so ``use_processes=True`` runs collation in worker
        # processes (dataset/collator shipped once via the pool initializer).
        pool = self._get_pool()
        pending = deque()
        cap = self.num_workers + self.prefetch
        if self.shm_transport and self._shm_ring is None:
            self._shm_ring = _ShmRing(cap, self.shm_bytes)

        def submit(b):
            if self.use_processes:
                if self._shm_ring is not None:
                    slot = self._shm_ring.acquire()
                    if slot is not None:  # cap <= n_slots, so always free
                        return (pool.submit(_worker_load_shm, b, slot,
                                            self.shm_bytes), True, slot)
                return (pool.submit(_worker_load, b), True, None)
            return (pool.submit(self._load, b), False, None)

        try:
            for b in self._index_batches():
                # divisor trimming happens host-side after process workers
                pending.append(submit(b))
                if len(pending) >= cap:
                    batch = self._resolve(pending.popleft())
                    if batch is not None:
                        yield batch
            while pending:
                batch = self._resolve(pending.popleft())
                if batch is not None:
                    yield batch
        except BaseException:
            self.close()
            raise

    def _get_pool(self):
        """Worker pool, created once and PERSISTENT across epochs: the
        spawn startup (8 interpreter boots re-importing the training
        module) per __iter__ cost more than a whole short epoch; the
        dataset/collator ship once through the pool initializer."""
        if self._pool is None:
            if self.use_processes:
                # spawn, not fork: the parent holds JAX's multithreaded
                # runtime, and forking a multithreaded process can
                # deadlock the child (os.fork warnings under pytest)
                self._pool = ProcessPoolExecutor(
                    max_workers=self.num_workers, initializer=_worker_init,
                    initargs=(self.dataset, self.collate_fn),
                    mp_context=multiprocessing.get_context("spawn"))
            else:
                self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
        return self._pool

    def close(self):
        """Shut the worker pool down (also called on iteration error)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
        if self._shm_ring is not None:
            self._shm_ring.close()
            self._shm_ring = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _resolve(self, item):
        fut, needs_trim, slot = item
        result = fut.result()
        if slot is not None:
            if result[0] == "shm":
                _, name, order, meta, other = result
                batch = self._shm_ring.read(name, order, meta, other)
            else:  # oversize / non-dict fallback
                batch = result[1]
            self._shm_ring.release(slot)
        else:
            batch = result
        if needs_trim:
            batch = self._trim_to_divisor(batch)
        return batch
