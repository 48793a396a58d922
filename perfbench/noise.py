"""Where a cell's host-clock metric spreads: windows of one cell run back to
back in one process, with Python's garbage collector on or frozen and off,
and the main thread free or pinned to one core, in turns. Each window
reports its end-to-end metric with what the host did meanwhile: the
collector's pauses, the main thread's CPU seconds and involuntary context
switches, and for a train cell the median host ms of a step's dispatch by bucket (a window's
mix of buckets depends on where in the cycle it starts; a bucket's own
step does not).

    python3 perfbench/noise.py --workload char-train --seed 7 --seconds 10 \\
        --rounds 4 [--modes plain nogc pin nogc_pin] [--out FILE]
"""
import argparse
import gc
import json
import os
import resource
import statistics
import sys
import time

if __package__ in (None, ''):
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from perfbench import harness  # noqa: E402


class Pauses:
    """Seconds the collector held the process, from gc.callbacks."""

    def __init__(self):
        self.total, self.count, self.t = 0.0, 0, None
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if phase == 'start':
            self.t = time.perf_counter()
        elif self.t is not None:
            self.total += time.perf_counter() - self.t
            self.count += 1
            self.t = None


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, default=7)
    p.add_argument('--seconds', type=float, default=10.0)
    p.add_argument('--rounds', type=int, default=4)
    p.add_argument('--modes', nargs='+', default=['plain', 'nogc', 'pin', 'nogc_pin'])
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    harness.prepare_environment(harness.ROOT.parent)
    import torch
    assert torch.cuda.is_available(), 'the windows run on the card'
    torch.set_num_threads(4)
    registry = harness.Registry()
    cell = registry.cell(args.workload)
    config = registry.config(cell['config'])
    kind = registry.kind(cell['kind'])
    run = harness.Run(args.workload, cell, config, args.seed, args.seconds, False, 'cuda')
    session = kind.setup(run)
    pauses = Pauses()
    cores = os.sched_getaffinity(0)
    for r in range(args.rounds):
        for mode in args.modes:
            if 'nogc' in mode:
                gc.collect()
                gc.freeze()
                gc.disable()
            if 'pin' in mode:
                os.sched_setaffinity(0, {min(cores)})
            run.values, run.spans = {}, {}
            at = getattr(session, 'at', 0)
            g0, n0 = pauses.total, pauses.count
            u0 = resource.getrusage(resource.RUSAGE_THREAD)
            session.window(run, args.seconds)
            u1 = resource.getrusage(resource.RUSAGE_THREAD)
            gc.enable()
            gc.unfreeze()
            os.sched_setaffinity(0, cores)
            e2e = session.end_to_end(run)
            wall = run.values['window_s']
            dispatch = run.spans.get('dispatch', [])
            by_bucket = {}
            if hasattr(session, 'batches'):
                work = session.batches.work
                for i, t in enumerate(dispatch):
                    by_bucket.setdefault(work[(at + i) % len(work)]['bucket'], []).append(t)
            line = dict(workload=args.workload, round=r, mode=mode, **e2e, window_s=wall,
                        gc_pause_s=pauses.total - g0, gc_runs=pauses.count - n0,
                        thread_cpu_s=(u1.ru_utime + u1.ru_stime) - (u0.ru_utime + u0.ru_stime),
                        involuntary_switches=u1.ru_nivcsw - u0.ru_nivcsw,
                        dispatch_ms_mean=1e3 * sum(dispatch) / len(dispatch) if dispatch else None,
                        dispatch_ms_by_bucket={b: 1e3 * statistics.median(v)
                                               for b, v in sorted(by_bucket.items())})
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, 'a') as f:
                    f.write(json.dumps(line) + '\n')


if __name__ == '__main__':
    main()
