"""The traced window: torch.profiler over CPU and CUDA, reduced to device
operations, the busy union, kernel time by name, and the idle gaps named by
the harness span the host was in.

Spans are `torch.profiler.record_function('perfbench.<name>')` ranges that the
harness opens around its own calls (feed, step, fetch, decode, tick); the
traced window is the `perfbench.window` range, which ends after a
synchronize, so every device operation it caused lies inside it.
"""
import collections
import contextlib

import torch

from . import measure

DEVICE_ACTIVITIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
PREFIX = 'perfbench.'


@contextlib.contextmanager
def profiled():
    """Yields a dict that holds, once the block has ended, the reduced trace
    of the block (see reduce)."""
    from torch.profiler import ProfilerActivity, profile
    holder = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield holder
    holder.update(reduce(events_of(prof)))


def events_of(prof) -> list:
    """(kind, name, start_s, end_s) of every event: kind 'device' for a
    kernel, copy or memset on the card, 'span' for a harness range."""
    out = []
    for e in prof.profiler.kineto_results.events():
        activity = e.activity_type() if hasattr(e, 'activity_type') else ''
        name = e.name()
        start, end = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        if name.startswith(PREFIX):
            # the harness's ranges; their copies on the device's timeline
            # are annotations, not operations
            if not on_device:
                out.append(('span', name[len(PREFIX):], start, end))
        elif activity in DEVICE_ACTIVITIES or (on_device and 'annotation' not in activity):
            out.append(('device', name, start, end))
    return out


def reduce(events: list) -> dict:
    """busy_s and window_s of the `window` span; seconds by device operation
    name; the idle gaps, each named by the innermost harness span open at
    its start ('host' where none is); the device events themselves."""
    windows = [(s, e) for kind, name, s, e in events if kind == 'span' and name == 'window']
    assert windows, 'no perfbench.window span in the trace'
    t0, t1 = windows[0]
    device = [(name, s, e) for kind, name, s, e in events if kind == 'device'
              and e > t0 and s < t1]
    spans = sorted(((s, e, name) for kind, name, s, e in events
                    if kind == 'span' and name != 'window'), key=lambda x: (x[0], -x[1]))
    by_name = collections.defaultdict(float)
    for name, s, e in device:
        by_name[name] += min(e, t1) - max(s, t0)
    intervals = [(s, e) for _, s, e in device]
    gaps = []
    for gs, ge in measure.idle_gaps(intervals, t0, t1):
        inner = [(e - s, name) for s, e, name in spans if s <= gs < e]
        gaps.append((min(inner)[1] if inner else 'host', ge - gs))
    return dict(busy_s=measure.union_seconds(intervals, t0, t1), window_s=t1 - t0,
                by_name=dict(by_name), gaps=gaps, device=device)


def breakdown(reduced: dict, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps,
    [name, seconds] each."""
    ops = sorted(reduced['by_name'].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(reduced['gaps'], key=lambda g: -g[1])[:top]
    return dict(device_ops=[[short(n), s] for n, s in ops], idle_gaps=[[n, s] for n, s in gaps])


def short(name: str, width: int = 160) -> str:
    """A kernel's name without 'void ' and cut to `width` characters."""
    name = name[5:] if name.startswith('void ') else name
    return name if len(name) <= width else name[:width - 3] + '...'


def kernel_seconds(reduced: dict, match) -> float:
    """Device seconds of the operations whose names `match(name)` accepts;
    0 when none ran."""
    return sum(s for n, s in reduced['by_name'].items() if match(n))
