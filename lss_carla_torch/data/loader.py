"""Host batch loader with threaded prefetch, and the copy to the device:
counterpart of ``lss_carla_tpu/data/loader.py``.

The reference's torch DataLoader worker processes
(``data_simbev.py:339-352``) become a thread pool, as in the JAX package:
PIL decode and numpy release the GIL, and threads need no fork or pickling.
``prefetch_to_device`` keeps ``size`` batches in flight: a producer thread
pulls host batches and pins them, and the consumer copies each to the
device with ``non_blocking`` on its own thread, so the copy overlaps the
step before it.

Spans (``utils/trace.py``; recorded only while a profiler records):
``lss.loader.sample`` a sample (read, decode, augment, label, on a pool
thread), ``lss.loader.collate`` a batch, and ``lss.loader.pin`` a batch
(``prefetch_to_device``'s producer).
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

from lss_carla_torch.utils.trace import span


def _collate(items):
    """Stack a list of tuples of arrays into a tuple of batched arrays."""
    return tuple(np.stack([it[i] for it in items]) for i in range(len(items[0])))


class DataLoader:
    """Map-style loader: shuffle, batch, drop_last or pad_last, prefetch.

    Iterating yields tuples of numpy arrays with a leading batch axis. The
    shuffle of epoch e is ``torch.randperm`` from a generator seeded
    ``seed + e`` (``set_epoch`` pins e, for resume). ``pad_last`` pads the
    order to a multiple of ``batch_size`` with wrap-around duplicates and
    appends a (B,) f32 validity mask as an extra batch element: every batch
    has one shape, and masked evaluation counts each sample once.

    ``shard_index``/``num_shards`` shard the input over data ranks, as the
    JAX loader shards it over hosts: every shard iterates the same global
    shuffle and takes an interleaved slice of it, ``batch_size`` rows a
    batch (the per-shard batch). ``drop_last`` and ``pad_last`` work on the
    ``batch_size * num_shards`` multiple, so every shard yields the same
    number of batches an epoch; without either, a dataset that is not
    such a multiple raises (a shard with a surplus batch would wait
    forever in that step's collective)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 4,
                 seed: int = 13, prefetch_batches: int = 2,
                 pad_last: bool = False, shard_index: int = 0,
                 num_shards: int = 1):
        if drop_last and pad_last:
            raise ValueError("drop_last and pad_last are mutually exclusive")
        if (num_shards > 1 and not (drop_last or pad_last)
                and len(dataset) % (batch_size * num_shards) != 0):
            raise ValueError(
                f"len(dataset)={len(dataset)} is not a multiple of "
                f"batch_size*num_shards={batch_size * num_shards}; pass "
                "drop_last or pad_last so every shard yields the same batch "
                "count per epoch")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.num_workers = max(0, num_workers)
        self.prefetch_batches = max(1, prefetch_batches)
        self.shard_index = shard_index
        self.num_shards = max(1, num_shards)
        self._epoch = 0
        self._seed = seed

    def set_epoch(self, epoch: int):
        """Pin the shuffle epoch: a resumed run draws the order it would
        have drawn, not epoch 0's again."""
        self._epoch = int(epoch)

    def __len__(self):
        """Batches an epoch, the same on every shard."""
        n, chunk = len(self.dataset), self.batch_size * self.num_shards
        return n // chunk if self.drop_last else -(-n // chunk)

    def _batch_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            g = torch.Generator().manual_seed(self._seed + self._epoch)
            order = torch.randperm(n, generator=g).numpy()
        valid = np.ones(n, bool)
        b, chunk = self.batch_size, self.batch_size * self.num_shards
        if self.drop_last:
            keep = (n // chunk) * chunk
            order, valid = order[:keep], valid[:keep]
        elif self.pad_last and n % chunk:
            padded = -(-n // chunk) * chunk
            order = np.resize(order, padded)
            valid = np.concatenate([valid, np.zeros(padded - n, bool)])
        order = order[self.shard_index::self.num_shards]
        valid = valid[self.shard_index::self.num_shards]
        return [(order[s:s + b], valid[s:s + b]) for s in range(0, len(order), b)]

    def _sample(self, i: int):
        with span("lss.loader.sample"):
            return self.dataset[i]

    def _assemble(self, samples, valid):
        with span("lss.loader.collate"):
            batch = _collate(samples)
            return batch + (valid.astype(np.float32),) if self.pad_last else batch

    def __iter__(self) -> Iterator:
        batches = self._batch_indices()
        self._epoch += 1
        if self.num_workers == 0:
            for idx, valid in batches:
                yield self._assemble([self._sample(int(i)) for i in idx], valid)
            return
        # one executor; a sliding window of per-sample futures keeps
        # prefetch_batches batches in flight; the finally (exhaustion or
        # generator close) cancels what is left
        executor = ThreadPoolExecutor(self.num_workers)
        try:
            window = collections.deque()
            it = iter(batches)

            def submit(batch):
                idx, valid = batch
                return [executor.submit(self._sample, int(i))
                        for i in idx], valid

            for _ in range(self.prefetch_batches):
                b = next(it, None)
                if b is not None:
                    window.append(submit(b))
            while window:
                futs, valid = window.popleft()
                b = next(it, None)
                if b is not None:
                    window.append(submit(b))
                yield self._assemble([f.result() for f in futs], valid)
        finally:
            executor.shutdown(wait=False, cancel_futures=True)


def stack_microbatches(iterator, accum_steps: int):
    """Group ``accum_steps`` consecutive host batches and stack each entry
    along a new leading axis: (B, ...) -> (accum_steps, B, ...), for the
    gradient-accumulation train step (``make_train_step(...,
    accum_steps=A)``). A ragged tail (fewer than ``accum_steps`` batches
    left in the epoch) is dropped, as the train loader drops a ragged
    batch. ``accum_steps`` 1 passes the batches through."""
    if accum_steps <= 1:
        yield from iterator
        return
    it = iter(iterator)
    while True:
        group = list(itertools.islice(it, accum_steps))
        if len(group) < accum_steps:
            return
        yield tuple(np.stack(parts) for parts in zip(*group))


def prefetch_to_device(iterator, device, size: int = 2):
    """Wrap a host batch iterator with a ``size``-deep queue.

    The producer thread iterates the loader and turns each batch into
    tensors, pinned when ``device`` is a GPU. The consumer (the caller's
    thread) copies them to ``device`` with ``non_blocking`` and yields the
    device tensors; nothing touches the device from the producer."""
    device = torch.device(device)
    pin = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()
    err = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                with span("lss.loader.pin"):
                    host = tuple(torch.from_numpy(np.ascontiguousarray(a))
                                 for a in batch)
                    if pin:
                        host = tuple(t.pin_memory() for t in host)
                if not put(host):
                    return
        except BaseException as e:  # re-raised on the consumer's side
            err.append(e)
        finally:
            put(sentinel)  # the consumer waits for it at the epoch's end

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield tuple(x.to(device, non_blocking=True) for x in item)
    finally:
        # the consumer left early: unblock and join the producer
        stop.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)


def compile_data(version, dataroot, data_aug_conf, grid_conf, bsz: int,
                 nworkers: int, parser_name: str = "segmentationdata",
                 dataset_kwargs: Optional[dict] = None, seed: int = 13,
                 shard_index: int = 0, num_shards: int = 1):
    """Reference-parity loader factory (``data_simbev.py:315-354``).

    Returns (trainloader, valloader); ``version`` is unused. The train
    loader shuffles (from ``seed``) and drops the ragged tail; the val
    loader pads its last batch with a validity mask (``pad_last``), so the
    whole val set is scored once. ``dataset_kwargs`` go to the dataset
    (orientation, extrinsic_noise, label_mode, label_classes,
    device_normalize); the train dataset's generator is seeded ``seed``.

    ``shard_index``/``num_shards``: this data rank's shard of every global
    batch of ``bsz * num_shards`` rows (``bsz`` is the per-shard batch;
    ``DataLoader``). Every shard draws the same shuffle, from ``seed``;
    shard k's train dataset draws its augmentation from ``seed + k``."""
    from lss_carla_torch.data.simbev import SegmentationData, VizData
    parser = {"vizdata": VizData, "segmentationdata": SegmentationData}[parser_name]
    dataset_kwargs = dataset_kwargs or {}
    traindata = parser(dataroot, is_train=True, data_aug_conf=data_aug_conf,
                       grid_conf=grid_conf, seed=seed + shard_index,
                       **dataset_kwargs)
    valdata = parser(dataroot, is_train=False, data_aug_conf=data_aug_conf,
                     grid_conf=grid_conf, **dataset_kwargs)
    shards = dict(shard_index=shard_index, num_shards=num_shards)
    trainloader = DataLoader(traindata, batch_size=bsz, shuffle=True,
                             drop_last=True, num_workers=nworkers, seed=seed,
                             **shards)
    valloader = DataLoader(valdata, batch_size=bsz, shuffle=False,
                           pad_last=True, num_workers=nworkers, **shards)
    return trainloader, valloader
