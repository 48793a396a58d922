"""The benchmark's runner: finds a cell, its configuration, its traffic kind
and its per-layer metrics by name, runs the cell once on the card and
prints one JSON line.

Everything that belongs to one configuration, cell, traffic kind or metric
is a file of its own under this folder, found by the name in
BENCHMARK.json:

    configs/<config>.json    the configuration as it is run (and an
                             optional `tiny` block: its CPU-size form)
    cells/<cell>.json        config, traffic, kind, params, chips, why, and
                             which params are assumed and which sourced
    traffic/<kind>.py        setup(run) -> a session with window(), check()
                             (and an optional TINY dict: the CPU-size params)
    metrics/<metric>.py      read(run) -> a number, or None where it has
                             nothing to read

A new configuration, cell, kind or metric is a new file here, with its
entries appended to BENCHMARK.json; the tests (tests/tiny.py) take every
cell of BENCHMARK.json at the CPU-size form its files give.

A session (see traffic/train.py) builds the program and warms up every
shape in `setup`, runs the measured `window`, and with `--trace 1` a traced
window after it; `check` frees the program's state, runs the plain
reference on what the window produced and returns the numbers compared,
each with its limit.
"""
import argparse
import contextlib
import importlib.util
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'convasr_tpu')
TRACE_SECONDS = 3.0


def process_start() -> float:
    """Wall time at which this process started, from /proc (the clock of
    time.time); the import time of this module where /proc has none."""
    try:
        with open('/proc/self/stat') as f:
            fields = f.read().rsplit(')', 1)[1].split()
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + int(fields[19]) / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


class Registry:
    """The files of one benchmark folder, by name."""

    def __init__(self, root=ROOT, bench_file=None):
        self.root = pathlib.Path(root)
        self.bench_file = pathlib.Path(bench_file) if bench_file else \
            self.root.parent / 'BENCHMARK.json'

    def benchmark(self) -> dict:
        return json.loads(self.bench_file.read_text())

    def workload(self, name: str) -> dict:
        for w in self.benchmark()['workloads']:
            if w['name'] == name:
                return w
        raise KeyError(f'no workload {name!r} in {self.bench_file}')

    def cell(self, name: str) -> dict:
        return json.loads((self.root / 'cells' / f'{name}.json').read_text())

    def config(self, name: str) -> dict:
        return json.loads((self.root / 'configs' / f'{name}.json').read_text())

    def kind(self, name: str):
        return self._module('traffic', name)

    def metric(self, name: str):
        return self._module('metrics', name)

    def _module(self, folder: str, name: str):
        path = self.root / folder / f'{name}.py'
        key = f'perfbench_{folder}_' + ''.join(c if c.isalnum() else '_' for c in name)
        if key in sys.modules:
            return sys.modules[key]
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
        return module

    def metrics_for(self, cell: str, section: str) -> list:
        """The metrics of `section` ('end_to_end' or 'per_layer') that `cell`
        reports: those that list it, and those that list no cells."""
        return [m for m in self.benchmark()[section]
                if cell in m.get('workloads', [cell])]


class Run:
    """What one run of a cell knows: its inputs, the host spans and counters
    of the measured window, the values the session hands the metric
    readers, and the reduced trace of a traced run."""

    def __init__(self, name, cell, config, seed, seconds, trace, device, options=None):
        self.name, self.cell, self.config = name, cell, config
        self.params = cell['params']
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = device
        self.options = dict(options or {})   # calibrate.py's control and faults
        self.spans = {}          # name -> [seconds] of the measured window
        self.values = {}         # what the session measured, for the readers
        self.traced = None       # the reduced trace (trace.reduce)
        self.peak_bytes = None

    @contextlib.contextmanager
    def span(self, name: str, record: bool = True):
        """Host seconds of the block, kept under `name` (record=False in the
        traced window, where the profiler's own range stands in)."""
        if not record:
            import torch
            with torch.profiler.record_function('perfbench.' + name):
                yield
            return
        t = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append(time.perf_counter() - t)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (whole names: convasr_tpu_torch is not convasr_tpu)."""
    return sorted({m.split('.')[0] for m in list(sys.modules)} & set(FORBIDDEN))


def prepare_environment(checkout: pathlib.Path):
    """Caches inside the checkout at fixed paths, no JAX through libraries
    that would load it, few host threads."""
    cache = checkout / 'build' / 'perfbench'
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
    os.environ['CUDA_CACHE_PATH'] = str(cache / 'cuda')
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'
    os.environ['USE_TF'] = '0'
    os.environ.setdefault('OMP_NUM_THREADS', '4')


def parse_args(argv):
    p = argparse.ArgumentParser(description='Run one cell of BENCHMARK.json once on the card.')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=[0, 1], default=0)
    return p.parse_args(argv)


def run_cell(registry: Registry, name: str, seed: int, seconds: float, trace: bool,
             device, config=None, cell=None, options=None) -> dict:
    """Runs one cell and returns the result dict (without printing).
    `config`, `cell` and `options` replace the files' and add the
    calibration and fault switches of perfbench/calibrate.py and the tests;
    the command passes none."""
    t_start = process_start()
    cell = cell or registry.cell(name)
    config = config or registry.config(cell['config'])
    run = Run(name, cell, config, seed, seconds, trace, device, options)
    kind = registry.kind(cell['kind'])
    session = kind.setup(run)
    setup_s = time.time() - t_start
    import torch
    cuda = torch.device(device).type == 'cuda'
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    session.window(run, seconds)
    if cuda:
        run.peak_bytes = max(torch.cuda.max_memory_allocated(d)
                             for d in range(torch.cuda.device_count()))
    if trace:
        from . import trace as trace_lib
        with trace_lib.profiled() as reduced:
            session.traced_window(run, min(TRACE_SECONDS, seconds))
        run.traced = reduced
    end_to_end = session.end_to_end(run)
    checks = session.check(run)
    run.values['setup_s'] = setup_s
    result = dict(correct=all(c['ok'] for c in checks), attempted=int(run.values['attempted']),
                  failed=int(run.values['failed']))
    metrics = {}
    if trace:
        for m in registry.metrics_for(name, 'per_layer'):
            value = registry.metric(m['name']).read(run)
            if value is not None:
                metrics[m['name']] = dict(value=float(value), unit=m['unit'])
    else:
        end_to_end['setup_s'] = setup_s
        for m in registry.metrics_for(name, 'end_to_end'):
            if m['name'] in end_to_end:
                metrics[m['name']] = dict(value=float(end_to_end[m['name']]), unit=m['unit'])
    result['metrics'] = metrics
    result['device'] = device_info(run, device)
    if trace:
        from . import trace as trace_lib
        result['breakdown'] = trace_lib.breakdown(run.traced)
    result['checks'] = {c['name']: dict(value=c['value'], limit=c['limit']) for c in checks}
    return result


def device_info(run: Run, device) -> dict:
    import torch
    if torch.device(device).type != 'cuda':       # the CPU tests' runs
        return dict(platform='cpu', kind='cpu', count=0, memory_peak_bytes=0)
    info = dict(platform='gpu', kind=torch.cuda.get_device_name(0),
                count=int(run.cell['chips']), memory_peak_bytes=int(run.peak_bytes))
    if run.traced is not None:
        info['busy_s'] = run.traced['busy_s']
        info['window_s'] = run.traced['window_s']
    return info


def main(argv=None) -> int:
    args = parse_args(argv if argv is not None else sys.argv[1:])
    registry = Registry()
    checkout = ROOT.parent
    prepare_environment(checkout)
    os.chdir(checkout)
    workload = registry.workload(args.workload)
    cell = registry.cell(args.workload)
    for key in ('config', 'traffic', 'chips'):
        if cell[key] != workload[key]:
            raise ValueError(f'cells/{args.workload}.json: {key} differs from BENCHMARK.json')
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell['chips']):
        print(f'perfbench: {args.workload} needs {cell["chips"]} CUDA device(s); '
              f'found {torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    result = run_cell(registry, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device('cuda', 0), cell=cell)
    bad = forbidden_modules()
    if bad:
        print(f'perfbench: forbidden modules loaded: {bad}', file=sys.stderr)
        return 4
    for name, c in result['checks'].items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
