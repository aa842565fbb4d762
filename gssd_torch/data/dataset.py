"""ml_ready npy dataset and static-shape batching.

Per slice ``{id}_ct.npy`` [4, 3, H, W] float in [0, 1] and
``{id}_bbox.npy`` [n, 5] = (x1, y1, x2, y2, cls) in pixels. Images load
as [4, H, W, 3] scaled to 0..255, boxes normalised to [0, 1]. Batches
are static-shape: images stacked [B, H, W, 12] (phase-major channels)
and the variable-length targets padded to ``max_gt`` with a validity
mask.

Loaders: ``BatchLoader`` (one prefetch thread, one seeded permutation
stream) and ``MPBatchLoader`` (forked workers; batch j is a function of
(seed, j) alone, so ``start_batch`` resumes the stream exactly).
``device_prefetch`` moves either's batches to the card through pinned
buffers on a side stream while the current step runs.
"""

from __future__ import annotations

import collections
import os
import queue as queue_mod
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch


class LesionDataset:
    def __init__(
        self,
        data_path: str,
        ids: Sequence[str],
        transform: Optional[Callable] = None,
        load_to_ram: bool = False,
    ):
        self.data_path = data_path
        self.ids = list(ids)
        self.transform = transform
        self._cache: Optional[List] = None
        if load_to_ram:
            self._cache = [self._load(i) for i in range(len(self.ids))]

    def __len__(self) -> int:
        return len(self.ids)

    def _load(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        base = os.path.join(self.data_path, self.ids[index])
        ct = np.load(base + "_ct.npy")  # [4, 3, H, W] in [0, 1]
        img = np.transpose(ct, (0, 2, 3, 1))  # [4, H, W, 3]
        img = (img * 255.0).astype(np.float32)
        bbox = np.load(base + "_bbox.npy").astype(np.float32)  # [n, 5]
        return img, bbox

    def raw_item(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._cache is not None:
            img, bbox = self._cache[index]
            return img.copy(), bbox.copy()
        return self._load(index)

    def pull_image(self, index: int) -> np.ndarray:
        """Original-resolution image [4, H, W, 3] float 0..255."""
        return self.raw_item(index)[0]

    def pull_anno(self, index: int) -> np.ndarray:
        """[n, 5] boxes in original pixels plus the class."""
        return self.raw_item(index)[1]

    def __getitem__(self, index: int):
        """(image, boxes [n, 4] in [0, 1], labels [n]) after the transform."""
        img, target = self.raw_item(index)
        h, w = img.shape[1], img.shape[2]
        boxes = target[:, :4].copy()
        boxes[:, 0::2] /= w
        boxes[:, 1::2] /= h
        labels = target[:, 4].copy()
        if self.transform is not None:
            img, boxes, labels = self.transform(img, boxes, labels)
        return img, boxes, labels


def pad_targets(
    boxes: np.ndarray, labels: np.ndarray, max_gt: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad a [n, 4] / [n] target pair to static [max_gt] with validity."""
    n = min(len(boxes), max_gt)
    out_b = np.zeros((max_gt, 4), np.float32)
    out_l = np.zeros((max_gt,), np.int32)
    out_v = np.zeros((max_gt,), bool)
    out_b[:n] = boxes[:n]
    out_l[:n] = labels[:n]
    out_v[:n] = True
    return out_b, out_l, out_v


def collate(items: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
            max_gt: int = 16) -> Dict[str, np.ndarray]:
    """Stack ([4, H, W, 3] image, [n, 4] boxes, [n] labels) items into a
    static-shape NHWC batch with 12 phase-major channels."""
    imgs, bs, ls, vs = [], [], [], []
    for img, boxes, labels in items:
        p, h, w, c = img.shape
        imgs.append(np.transpose(img, (1, 2, 0, 3)).reshape(h, w, p * c))
        b, lab, v = pad_targets(boxes, labels, max_gt)
        bs.append(b)
        ls.append(lab)
        vs.append(v)
    return {
        "image": np.stack(imgs).astype(np.float32),
        "boxes": np.stack(bs),
        "labels": np.stack(ls),
        "valid": np.stack(vs),
    }


def collate_pixellink(items: Sequence[Tuple[np.ndarray, np.ndarray, dict]],
                      max_gt: int = 16) -> Dict[str, np.ndarray]:
    """``collate`` for PixelLink items, whose third element is the target
    dict of ``make_pixel_link_targets`` plus "labels": adds the stacked
    maps pixel_mask int32, neg_pixel_mask uint8, pixel_pos_weight f32 and
    link_mask int32 to the batch."""
    maps = ("pixel_mask", "neg_pixel_mask", "pixel_pos_weight", "link_mask")
    batch = collate([(img, boxes, np.asarray(t["labels"])) for img, boxes, t in items], max_gt)
    for key, dt in zip(maps, (np.int32, np.uint8, np.float32, np.int32)):
        batch[key] = np.stack([t[key] for _, _, t in items]).astype(dt)
    return batch


def collate_raw(items: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                max_gt: int = 16) -> Dict[str, Any]:
    """Collate for the device augmentation: the untouched source-size
    images as a uint8 [B, H, W, 12] stack (the source data is 0..255, so
    nothing is lost and the copy is 4x smaller), with each item's
    normalised boxes and labels as lists for the host geometry sampler
    (``data/augment_device.py``). ``max_gt`` is unused: the sampler pads."""
    imgs, bl, ll = [], [], []
    for img, boxes, labels in items:
        p, h, w, c = img.shape
        imgs.append(np.transpose(img, (1, 2, 0, 3)).reshape(h, w, p * c))
        bl.append(np.asarray(boxes, np.float32))
        ll.append(np.asarray(labels))
    return {"raw_image": np.clip(np.stack(imgs), 0, 255).astype(np.uint8),
            "boxes_list": bl, "labels_list": ll}


def take_rows(batches: Iterable[Dict[str, Any]], rows: Optional[slice],
              keep: Sequence[str] = ()) -> Iterator[Dict[str, Any]]:
    """A data-parallel rank's part of a batch stream: each batch with its
    arrays, tensors and lists cut to ``rows`` along the first axis, save
    the keys in ``keep``; the stream itself where ``rows`` is None."""
    for batch in batches:
        yield batch if rows is None else \
            {k: v if k in keep else v[rows] for k, v in batch.items()}


class _EpochPermuter:
    """Pure function (seed, epoch) -> permutation, so that any batch's
    indices can be computed on its own; caches the last few epochs."""

    def __init__(self, seed: int, n: int, shuffle: bool):
        self.seed = seed
        self.n = n
        self.shuffle = shuffle
        self._cache: Dict[int, np.ndarray] = {}

    def indices_for_batch(self, j: int, batch_size: int) -> List[int]:
        out = []
        for t in range(j * batch_size, (j + 1) * batch_size):
            e, pos = divmod(t, self.n)
            perm = self._cache.get(e)
            if perm is None:
                # Python ints: seed << 24 overflows 32 bits
                perm = (np.random.default_rng((self.seed << 24) ^ e).permutation(self.n)
                        if self.shuffle else np.arange(self.n))
                self._cache[e] = perm
                for stale in [k for k in self._cache if k < e - 2]:
                    del self._cache[stale]
            out.append(int(perm[pos]))
        return out


def _shared_copy(a: np.ndarray) -> torch.Tensor:
    t = torch.empty(a.shape, dtype=torch.from_numpy(a).dtype).share_memory_()
    t.numpy()[...] = a
    return t


def _mp_worker(dataset, batch_size, max_gt, seed, shuffle, collate_fn, worker_id,
               num_workers, queue, free, start_batch=0):
    """Builds batches start_batch + worker_id, + num_workers, ... Batch
    j's indices and its transform's draws are functions of (seed, j)
    alone, so the stream is the same whatever the worker count. Each
    batch's arrays go into one of this worker's shared-memory slots (a
    free slot's index arrives on ``free``); a slot's tensors are sent
    once, when first filled, and only its index after that."""
    # a forked child may use neither the parent's CUDA context nor its
    # intra-op thread pool (the host augmentation resizes with torch)
    torch.set_num_threads(1)
    perm = _EpochPermuter(seed, len(dataset), shuffle)
    slots: Dict[int, Dict[str, torch.Tensor]] = {}
    j = start_batch + worker_id
    while True:
        if dataset.transform is not None and hasattr(dataset.transform, "rng"):
            dataset.transform.rng = np.random.default_rng((seed << 20) ^ j)
        batch = collate_fn([dataset[i] for i in perm.indices_for_batch(j, batch_size)],
                           max_gt)
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        k = free.get()
        fresh = k not in slots  # batches are static-shape: a slot is allocated once
        if fresh:
            slots[k] = {key: _shared_copy(v) for key, v in arrays.items()}
        else:
            for key, v in arrays.items():
                slots[k][key].numpy()[...] = v
        queue.put((k, slots[k] if fresh else None,
                   {key: v for key, v in batch.items() if key not in arrays}))
        j += num_workers


class MPBatchLoader:
    """Multi-process batch loader: ``num_workers`` forked processes each
    build whole collated batches, and the parent takes from each
    worker's queue in turn, so the batches arrive in the same order
    whatever the workers' timing. The stream is a function of (seed,
    batch index): ``start_batch`` resumes it exactly.

    The arrays of a batch are tensors in a shared-memory slot that its
    worker fills again later (a fresh shared allocation per batch costs
    more than the augmentation on a host that faults its pages in
    slowly): they stay valid until the next batch is taken. Copy what
    must outlive that; ``device_prefetch`` copies each batch as it takes
    it. Other leaves (lists) are the worker's, pickled.

    A worker that dies makes the iteration raise with its exit code.
    ``close`` stops the workers (the trainers call it in a ``finally``)."""

    def __init__(self, dataset: LesionDataset, batch_size: int, max_gt: int = 16,
                 seed: int = 1111, shuffle: bool = True, prefetch: int = 2,
                 collate_fn: Callable = collate, num_workers: int = 2, start_batch: int = 0):
        import torch.multiprocessing as tmp

        if len(dataset) == 0:
            raise ValueError("MPBatchLoader over an empty dataset")
        ctx = tmp.get_context("fork")
        self.num_workers = max(1, num_workers)
        self._queues, self._free, self._procs = [], [], []
        self._slots: List[Dict[int, Dict[str, torch.Tensor]]] = []
        self._held: Optional[Tuple[int, int]] = None
        for wid in range(self.num_workers):
            q, free = ctx.Queue(), ctx.SimpleQueue()
            for k in range(max(1, prefetch) + 1):
                free.put(k)
            p = ctx.Process(target=_mp_worker, daemon=True,
                            args=(dataset, batch_size, max_gt, seed, shuffle, collate_fn,
                                  wid, self.num_workers, q, free, start_batch))
            p.start()
            self._queues.append(q)
            self._free.append(free)
            self._procs.append(p)
            self._slots.append({})

    def _get(self, wid: int):
        while True:
            try:
                return self._queues[wid].get(timeout=1)
            except queue_mod.Empty:
                if not self._procs[wid].is_alive():
                    raise RuntimeError(
                        f"MPBatchLoader worker {wid} died (exit code "
                        f"{self._procs[wid].exitcode}); check for unreadable npy files "
                        "or transform errors") from None

    def __iter__(self):
        wid = 0
        while True:
            if self._held is not None:
                self._free[self._held[0]].put(self._held[1])
                self._held = None
            k, fresh, rest = self._get(wid)
            if fresh is not None:
                self._slots[wid][k] = fresh
            self._held = (wid, k)
            yield {**self._slots[wid][k], **rest}
            wid = (wid + 1) % self.num_workers

    def close(self):
        for p in self._procs:
            p.terminate()
        for p in self._procs:
            p.join(timeout=5)


def _as_tensor(v):
    return torch.from_numpy(v) if isinstance(v, np.ndarray) else v


def device_prefetch(iterator, device, size: int = 2,
                    cast: Optional[Dict[str, torch.dtype]] = None):
    """Batches of ``iterator`` (dicts of numpy arrays, CPU tensors, device
    tensors and other leaves) with their host arrays on ``device``, the
    next ``size`` batches in flight while the caller runs.

    On a CUDA device each host array is copied into a pinned buffer
    (cast to ``cast[key]`` where given) and from there, on a side
    stream, to the card; the caller's stream waits on the copy's event,
    and each copied tensor is recorded on that stream so that its memory
    is not reused early. There are ``size + 1`` sets of pinned buffers,
    used in turn; a set is not refilled before its last copy has
    completed. Device tensors and other leaves pass through unchanged.
    On any other device nothing is copied: arrays become tensors."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: _as_tensor(v) for k, v in batch.items()}
        return
    cast = cast or {}
    stream = torch.cuda.Stream(device)
    pinned: List[Dict[str, torch.Tensor]] = [{} for _ in range(size + 1)]
    copied: List[Optional[torch.cuda.Event]] = [None] * (size + 1)
    inflight: collections.deque = collections.deque()

    def ready(batch, keys, event):
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for key in keys:
            batch[key].record_stream(current)
        return batch

    for n, batch in enumerate(iterator):
        s = n % (size + 1)
        if copied[s] is not None:
            copied[s].synchronize()
        out, keys = {}, []
        with torch.cuda.stream(stream):
            for key, v in batch.items():
                v = _as_tensor(v)
                if not torch.is_tensor(v) or v.device.type != "cpu":
                    out[key] = v
                    continue
                dtype = cast.get(key, v.dtype)
                buf = pinned[s].get(key)
                if buf is None or buf.shape != v.shape or buf.dtype != dtype:
                    buf = pinned[s][key] = torch.empty(v.shape, dtype=dtype, pin_memory=True)
                buf.copy_(v)
                out[key] = buf.to(device, non_blocking=True)
                keys.append(key)
            copied[s] = torch.cuda.Event()
            copied[s].record(stream)
        inflight.append((out, keys, copied[s]))
        if len(inflight) >= size:
            yield ready(*inflight.popleft())
    while inflight:
        yield ready(*inflight.popleft())


class BatchLoader:
    """Shuffling, endlessly repeating batch iterator with one background
    prefetch thread. The order is a seeded ``default_rng`` permutation
    per epoch; ``collate_fn`` stacks the items. An error while building
    a batch is raised by the iterator (from the thread's exception).
    ``close`` stops the thread."""

    def __init__(self, dataset: LesionDataset, batch_size: int, max_gt: int = 16,
                 seed: int = 1111, shuffle: bool = True, prefetch: int = 2,
                 collate_fn: Callable = collate):
        if len(dataset) == 0:
            raise ValueError("BatchLoader over an empty dataset")
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.shuffle = shuffle
        self.collate_fn = collate_fn
        self.rng = np.random.default_rng(seed)
        self._queue: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._started = False
        self._stop = threading.Event()

    def _index_stream(self) -> Iterator[int]:
        n = len(self.dataset)
        while True:
            order = self.rng.permutation(n) if self.shuffle else np.arange(n)
            yield from order

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue_mod.Full:
                pass

    def _worker(self):
        stream = self._index_stream()
        try:
            while not self._stop.is_set():
                items = [self.dataset[next(stream)] for _ in range(self.batch_size)]
                self._put(self.collate_fn(items, self.max_gt))
        except Exception as e:  # raised again by the iterator
            self._put(e)

    def close(self):
        """Stop the prefetch thread and wait for it (at most one batch)."""
        self._stop.set()
        if self._started:
            self._thread.join()

    def __iter__(self):
        if not self._started:
            self._thread.start()
            self._started = True
        while True:
            item = self._queue.get()
            if isinstance(item, Exception):
                raise RuntimeError("BatchLoader: building a batch failed") from item
            yield item
