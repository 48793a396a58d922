"""Prefetching: overlap host audio decode and dispatch with device compute
(counterpart of convasr_tpu/data/loader.py; its PrefetchLoader comes with the
training slice). Threads suffice because audio decode is numpy/scipy-bound
(releases the GIL) and arrays are shared without pickling.
"""
import concurrent.futures


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

