"""The loader: a seeded permutation per epoch, worker threads that assemble whole batches, a reorder buffer.

Counterpart of `drone_yolo_tpu/data/build.py` (DataLoader, build_yolo_dataset,
build_dataloader) for one process. Threads, not processes: the image work of a sample
(`ops/image.py`, `ops/letterbox.py`) runs in CPU tensor ops that release the interpreter
lock, while the JPEG decoder's entropy stage holds it (cache the images with
`cache="ram"` for a dataset that fits). Each worker owns whole batches; a reorder buffer
yields them in epoch order and a semaphore bounds the batches in flight to
`workers + prefetch`. The workers never touch the card: the trainer uploads a batch.
"""

from __future__ import annotations

import math
import queue
import threading

import numpy as np

from drone_yolo_tpu_torch.data.dataset import LOGGER, YOLODataset


def build_yolo_dataset(cfg, img_path, batch: int, data: dict, mode: str = "train", stride: int = 32,
                       max_labels=None) -> YOLODataset:
    """A YOLODataset from a train or validate configuration: augmented for "train", letterboxed otherwise. `rect`
    gives rectangular batches for validation (a half-stride pad, at most `rect_max_shapes` shapes); for training it
    is ignored with a warning, as in the JAX package."""
    rect = bool(cfg.rect) and mode != "train"
    if cfg.rect and mode == "train":
        LOGGER.warning("rect=True ignored for training; using the square letterbox")
    return YOLODataset(img_path=img_path, imgsz=cfg.imgsz, cache=cfg.cache in (True, "ram"), augment=mode == "train",
                       hyp=cfg, prefix=f"{mode}: ", batch_size=batch, stride=stride, pad=0.0 if mode == "train" else 0.5,
                       single_cls=cfg.single_cls, classes=cfg.classes,
                       fraction=cfg.fraction if mode == "train" else 1.0, data=data, max_labels=max_labels, rect=rect,
                       rect_max_shapes=int(cfg.rect_max_shapes or 8))


class DataLoader:
    """Epoch-based loader over a dataset with `__getitem__`, `collate` and optionally `set_epoch` and
    `set_sample_window`: shuffled by a permutation seeded with seed + epoch."""

    def __init__(self, dataset, batch_size: int = 16, shuffle: bool = True, workers: int = 2, seed: int = 0,
                 drop_last: bool = True, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.workers = max(1, workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0
        n = len(dataset)
        self.nb = n // batch_size if drop_last else math.ceil(n / batch_size)

    def __len__(self) -> int:
        return self.nb

    def set_epoch(self, epoch: int) -> None:
        """The epoch of the next iteration: its permutation and its augmentation draws."""
        self.epoch = epoch
        se = getattr(self.dataset, "set_epoch", None)
        if callable(se):
            se(epoch, self.seed)

    def _set_window(self, idx: np.ndarray, p: int) -> None:
        """Mosaic companions of epoch position p: the `max_buffer_length` indices of the permutation before it (none
        at p = 0). The same (seed, epoch) gives the same windows whatever the worker count."""
        setw = getattr(self.dataset, "set_sample_window", None)
        w = getattr(self.dataset, "max_buffer_length", 0)
        if callable(setw) and w:
            setw(idx[max(0, p - w):p])

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        return np.random.default_rng(self.seed + self.epoch).permutation(n) if self.shuffle else np.arange(n)

    def _batch(self, idx: np.ndarray, bi: int) -> dict:
        binds = idx[bi * self.batch_size:(bi + 1) * self.batch_size]
        samples = []
        for j, si in enumerate(binds):
            self._set_window(idx, bi * self.batch_size + j)
            samples.append(self.dataset[int(si)])
        return self.dataset.collate(samples)

    def __iter__(self):
        """Collated batches in epoch order, assembled by `workers` threads."""
        idx = self._indices()
        work: queue.Queue = queue.Queue()
        for bi in range(self.nb):
            work.put(bi)
        done: dict = {}
        cond = threading.Condition()
        inflight = threading.Semaphore(self.workers + self.prefetch)
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                inflight.acquire()
                try:
                    bi = work.get_nowait()
                except queue.Empty:
                    inflight.release()
                    return
                try:
                    out = self._batch(idx, bi)
                except Exception as e:  # noqa: BLE001 - handed to the consumer, which raises it
                    out = e
                with cond:
                    done[bi] = out
                    cond.notify_all()
                if isinstance(out, Exception):
                    return

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(min(self.workers, max(self.nb, 1)))]
        for t in threads:
            t.start()
        try:
            for bi in range(self.nb):
                with cond:
                    while bi not in done:
                        err = next((v for v in done.values() if isinstance(v, Exception)), None)
                        if err is not None:
                            raise err
                        cond.wait()
                    batch = done.pop(bi)
                if isinstance(batch, Exception):
                    raise batch
                inflight.release()
                yield batch
        finally:
            stop.set()
            for _ in threads:  # wake workers parked on the semaphore
                inflight.release()
            for t in threads:
                t.join(timeout=60)


def build_dataloader(dataset, batch: int, workers: int, shuffle: bool = True, seed: int = 0,
                     drop_last: bool = True) -> DataLoader:
    return DataLoader(dataset, batch_size=batch, shuffle=shuffle, workers=workers, seed=seed, drop_last=drop_last)
