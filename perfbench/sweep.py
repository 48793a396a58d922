"""The knee of the streaming cell: the stream kind at each number of slots in
turn, in one process that builds the program once, reporting the p95 of the
chunk latency, the median tick and whether the backlog grows (the latency
of the window's last third against its first).

    python3 perfbench/sweep.py --workload char-stream --slots 64 128 192 \\
        --seconds 15 --seed 7 [--out FILE]
"""
import argparse
import copy
import json
import os
import sys

if __package__ in (None, ''):
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from perfbench import harness, inference, measure  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--workload', default='char-stream')
    p.add_argument('--slots', type=int, nargs='+', required=True)
    p.add_argument('--seconds', type=float, default=15.0)
    p.add_argument('--seed', type=int, default=7)
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    harness.prepare_environment(harness.ROOT.parent)
    import numpy as np
    import torch
    registry = harness.Registry()
    base = registry.cell(args.workload)
    config = registry.config(base['config'])
    kind = registry.kind(base['kind'])
    run0 = harness.Run(args.workload, base, config, args.seed, args.seconds, False, 'cuda')
    program = inference.setup(run0)
    for n in args.slots:
        cell = copy.deepcopy(base)
        cell['params'].update(slots=n, drain_s=5.0)
        run = harness.Run(args.workload, cell, config, args.seed, args.seconds, False, 'cuda')
        session = kind.Session(run, program)
        session.window(run, args.seconds)
        session.close()
        lat = np.asarray(run.values['latencies'])
        third = max(len(lat) // 3, 1)
        due_order = np.argsort(run.values['due'])
        first, last = lat[due_order[:third]], lat[due_order[-third:]]
        line = dict(slots=n, p95_ms=1e3 * measure.percentile(lat, 95) if len(lat) else None,
                    p50_ms=1e3 * measure.percentile(lat, 50) if len(lat) else None,
                    tick_p50_ms=1e3 * measure.percentile(run.values['tick_s'], 50),
                    ticks=len(run.values['tick_s']), first_third_p50_ms=1e3 * float(np.median(first)),
                    last_third_p50_ms=1e3 * float(np.median(last)),
                    attempted=run.values['attempted'], failed=run.values['failed'],
                    peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(json.dumps(line) + '\n')
        session.engine = session.sessions = None
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
