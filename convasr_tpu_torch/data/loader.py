"""Prefetching: overlap host audio decode and dispatch with device compute
(counterpart of convasr_tpu/data/loader.py). Threads suffice because audio
decode is numpy/scipy-bound (releases the GIL) and arrays are shared without
pickling.
"""
import concurrent.futures
import queue
import threading
import typing


def prefetch_map(fn, iterable, num_workers: int = 4, lookahead: int = 4,
                 timeout=None):
    """Ordered imap with bounded lookahead: yields fn(x) for x in iterable
    while up to `lookahead` future items are computed in threads."""
    if num_workers <= 0:
        for x in iterable:
            yield fn(x)
        return
    import collections
    with concurrent.futures.ThreadPoolExecutor(num_workers) as pool:
        window: collections.deque = collections.deque()
        it = iter(iterable)
        try:
            for _ in range(max(lookahead, 1)):
                window.append(pool.submit(fn, next(it)))
        except StopIteration:
            pass
        while window:
            fut = window.popleft()
            try:
                window.append(pool.submit(fn, next(it)))
            except StopIteration:
                pass
            yield fut.result(timeout=timeout)


class PrefetchLoader:
    """Iterate (collate_fn over dataset items) for each index-batch from
    `batch_iter`, prefetching up to `prefetch` batches with `num_workers`
    decode threads. num_workers=0 degrades to synchronous iteration."""

    def __init__(self, dataset, batch_iter: typing.Iterable, num_workers: int = 4,
                 prefetch: int = 4, timeout: typing.Optional[float] = None):
        self.dataset = dataset
        self.batch_iter = batch_iter
        self.num_workers = num_workers
        self.prefetch = max(prefetch, 1)
        self.timeout = timeout

    def _load(self, indices):
        items = [self.dataset[i] for i in indices]
        return self.dataset.collate_fn(items)

    def __iter__(self):
        if self.num_workers <= 0:
            for indices in self.batch_iter:
                yield self._load(indices)
            return

        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
            # bounded queue = bounded in-flight decode work
            pending: 'queue.Queue' = queue.Queue(maxsize=self.prefetch)
            stop = threading.Event()

            def submitter():
                for indices in self.batch_iter:
                    if stop.is_set():
                        return
                    pending.put(pool.submit(self._load, indices))
                pending.put(None)

            thread = threading.Thread(target=submitter, daemon=True)
            thread.start()
            try:
                while True:
                    fut = pending.get()
                    if fut is None:
                        return
                    yield fut.result(timeout=self.timeout)
            finally:
                stop.set()
                # drain so the submitter can exit
                while True:
                    try:
                        fut = pending.get_nowait()
                    except queue.Empty:
                        break
                    if fut is not None:
                        fut.cancel()
