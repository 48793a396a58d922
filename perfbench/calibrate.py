"""Readings for the limits of a cell's correctness check, on the card at the
cell's own size: the program's numbers on each seed, the control's (the
reference in the program's place, a precision lower) and a planted fault's.
One process serves every seed; each seed's set-up runs as in a benchmark
run, with a window of `--seconds` (0: none, as the train cells need).

    python3 perfbench/calibrate.py --workload char-train --seeds 1 2 3 \\
        [--control fp8] [--fault half_batch] [--seconds 0] [--out FILE]

Prints one JSON line a seed and variant: the numbers `check` compares.
"""
import argparse
import json
import os
import sys
import time

if __package__ in (None, ''):
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from perfbench import harness  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--control', default=None, help='the control precision, e.g. fp8')
    p.add_argument('--fault', default=None, help='a fault to plant in the program')
    p.add_argument('--seconds', type=float, default=0.0)
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    harness.prepare_environment(harness.ROOT.parent)
    import torch
    assert torch.cuda.is_available(), 'the readings are taken on the card'
    registry = harness.Registry()
    cell = registry.cell(args.workload)
    config = registry.config(cell['config'])
    kind = registry.kind(cell['kind'])
    out = open(args.out, 'a') if args.out else None
    for seed in args.seeds:
        t = time.time()
        run = harness.Run(args.workload, cell, config, seed, args.seconds, False, 'cuda',
                          dict(no_warmup=args.seconds == 0, control=args.control,
                               fault=args.fault))
        session = kind.setup(run)
        if args.seconds:
            session.window(run, args.seconds)
        session.check(run)
        line = dict(workload=args.workload, seed=seed, fault=args.fault,
                    readings=run.values['readings'],
                    control=run.values.get('control_readings'),
                    worst=run.values.get('worst'),
                    seconds=time.time() - t)
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + '\n')
            out.flush()
        del session, run
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
